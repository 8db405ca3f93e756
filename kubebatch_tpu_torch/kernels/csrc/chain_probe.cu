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

}  // namespace

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
