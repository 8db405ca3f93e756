// Probes of the barriers the kernels are built from, measured by
// chip_smoke.py and cluster_timing.py beside the kernels' own times. Not on
// the scheduling path.
//
// The grid probe times a grid barrier of the round kernels' cooperative
// grid (one 512-thread block per SM): ``iters`` grid.sync() back to back,
// then as many block barriers, each span read from the global timer by
// block 0's thread 0.
//
// The cluster probe times what the cluster kernels (victims.cu,
// allocate_scan.cu, fused_body.cuh) are built from, in one thread-block
// cluster: ``iters`` cluster barriers back to back, ``iters`` dependent
// DSMEM loads (each address depends on the word read before it) and
// ``iters`` block barriers. The fused loop's floor is its node solves x
// (one cluster barrier + the block barriers left).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
