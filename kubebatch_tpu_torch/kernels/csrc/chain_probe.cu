// Floors of the one-block fused allocate design (fused_allocate.cu),
// measured by chip_smoke.py beside the kernel's own time. Not on the
// scheduling path.
//
// The kernel has fused_allocate_kernel's shape: one block of 1024 threads
// running a loop of dependent iterations. Each iteration does only what
// every node-solve iteration of the allocate loop must do:
//  - a pass over n_nodes nodes that reads `words` 32-bit words per node
//    (words = 0: no pass), stored word-major so the loads coalesce;
//  - a block-wide (value, lowest index) argmax of what was read;
//  - `barriers` block barriers in all, the argmax's three included;
//  - thread 0 writes the winner back into the buffer, so the next
//    iteration reads what this one wrote, as the allocate loop does.
// With words = 0 the time is the dependence chain alone (barriers and the
// reduction); with words > 0 it adds one SM streaming the node state from
// L2 every iteration.
//
// A second probe times the grid barrier of the round kernels' cooperative
// grid (one 512-thread block per SM): ``iters`` grid.sync() back to back,
// then as many block barriers, each span read from the global timer by
// block 0's thread 0.
//
// A third times what the cluster kernels (victims.cu, allocate_scan.cu)
// are built from, in one thread-block cluster: ``iters`` cluster barriers
// back to back, ``iters`` dependent DSMEM loads (each address depends on
// the word read before it) and ``iters`` block barriers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int NWARPS = NT / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void amax_combine(float& v, int& i, float v2,
                                             int i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

__global__ void __launch_bounds__(NT, 1) chain_probe_kernel(
        float* buf, int n_nodes, int words, int iters, int barriers,
        int32_t* out) {
    __shared__ float s_f[NWARPS];
    __shared__ int s_i[NWARPS];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    int best = 0;
    for (int it = 0; it < iters; ++it) {
        float v = -INFINITY;
        int idx = INT32_MAX;
        for (int n = tid; n < n_nodes && words > 0; n += NT) {
            float acc = 0.0f;
            for (int w = 0; w < words; ++w)
                acc = acc + buf[(size_t)w * n_nodes + n];
            amax_combine(v, idx, acc, n);
        }
        for (int o = 16; o > 0; o >>= 1)
            amax_combine(v, idx, __shfl_xor_sync(FULL, v, o),
                         __shfl_xor_sync(FULL, idx, o));
        if (lane == 0) {
            s_f[warp] = v;
            s_i[warp] = idx;
        }
        __syncthreads();
        if (warp == 0) {
            v = s_f[lane];
            idx = s_i[lane];
            for (int o = 16; o > 0; o >>= 1)
                amax_combine(v, idx, __shfl_xor_sync(FULL, v, o),
                             __shfl_xor_sync(FULL, idx, o));
            if (lane == 0) s_i[0] = idx;
        }
        __syncthreads();
        best = s_i[0];
        __syncthreads();
        for (int b = 3; b < barriers - 1; ++b) __syncthreads();
        if (tid == 0 && words > 0 && best >= 0 && best < n_nodes)
            buf[best] = buf[best] - 1.0f;
        __syncthreads();
    }
    if (tid == 0) out[0] = best;
}

constexpr int GRID_NT = 512;

__device__ __forceinline__ unsigned long long probe_now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void __launch_bounds__(GRID_NT, 1) grid_probe_kernel(
        int iters, unsigned long long* out) {
    cooperative_groups::grid_group grid = cooperative_groups::this_grid();
    const bool t0 = blockIdx.x == 0 && threadIdx.x == 0;
    grid.sync();
    const unsigned long long a = probe_now();
    for (int i = 0; i < iters; ++i) grid.sync();
    const unsigned long long b = probe_now();
    for (int i = 0; i < iters; ++i) __syncthreads();
    const unsigned long long c = probe_now();
    if (t0) {
        out[0] = b - a;
        out[1] = c - b;
    }
}

__global__ void __launch_bounds__(1024) cluster_probe_kernel(
        int iters, unsigned long long* out) {
    cooperative_groups::cluster_group cl =
        cooperative_groups::this_cluster();
    __shared__ int s_word;
    const int C = (int)cl.num_blocks();
    const bool t0 = cl.block_rank() == 0 && threadIdx.x == 0;
    if (threadIdx.x == 0) s_word = ((int)cl.block_rank() + 1) % C;
    cl.sync();
    const unsigned long long a = probe_now();
    for (int i = 0; i < iters; ++i) cl.sync();
    const unsigned long long b = probe_now();
    int rank = 0;
    if (t0)
        for (int i = 0; i < iters; ++i)
            rank = *(volatile int*)cl.map_shared_rank(&s_word, rank);
    const unsigned long long c = probe_now();
    for (int i = 0; i < iters; ++i) __syncthreads();
    const unsigned long long d = probe_now();
    cl.sync();
    if (t0) {
        out[0] = b - a;
        out[1] = c - b;
        out[2] = d - c;
        out[3] = (unsigned long long)rank;
    }
}

}  // namespace

// The cluster probe: one cluster of ``cluster`` CTAs of info[0] threads;
// out (4 uint64 on the device): ns of ``iters`` cluster barriers, of
// ``iters`` dependent DSMEM loads, of ``iters`` block barriers, and the
// last rank read. Returns the cudaError_t of the launch.
extern "C" int kb_cluster_probe(int cluster, int iters, void* out,
                                int* info, void* stream) {
    if (iters < 1 || cluster < 1 || cluster > 16 || info[0] < 32
        || info[0] > 1024)
        return (int)cudaErrorInvalidValue;
    if (cluster > 8) {
        const cudaError_t e = cudaFuncSetAttribute(
            cluster_probe_kernel,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)cluster);
    cfg.blockDim = dim3((unsigned)info[0]);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, cluster_probe_kernel, iters, (unsigned long long*)out);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The grid-barrier probe: a cooperative launch of one GRID_NT-thread block
// per SM; out (2 uint64 on the device): ns of ``iters`` grid barriers,
// then of ``iters`` block barriers; info (host, 2 ints): grid, threads.
// Returns the cudaError_t of the launch.
extern "C" int kb_grid_probe(int iters, void* out, int* info, void* stream) {
    if (iters < 1) return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    info[0] = sms;
    info[1] = GRID_NT;
    unsigned long long* o = (unsigned long long*)out;
    void* args[] = {&iters, &o};
    err = cudaLaunchCooperativeKernel((const void*)grid_probe_kernel,
                                      dim3(sms), dim3(GRID_NT), args, 0,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// Plain C entry point for ctypes: buf holds words * n_nodes float32 on
// the device, out one int32. Returns cudaGetLastError() after the launch.
extern "C" int kb_chain_probe(void* buf, int n_nodes, int words, int iters,
                              int barriers, void* out, void* stream) {
    if (n_nodes <= 0 || words < 0 || iters < 0 || barriers < 4)
        return (int)cudaErrorInvalidValue;
    chain_probe_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
        (float*)buf, n_nodes, words, iters, barriers, (int32_t*)out);
    return (int)cudaGetLastError();
}
