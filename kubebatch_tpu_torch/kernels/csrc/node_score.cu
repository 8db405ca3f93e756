// Standalone nodeorder dynamic score over all nodes: out[n] =
// dynamic_node_score(nz_req[n], t_nz, allocatable_cm[n], weights).
//
// Replaces kubebatch_tpu/kernels/solver.py:67 dynamic_node_score. On the
// main path the same device function runs inside the fused allocate
// kernel; this elementwise form lets the score be held against its plain
// version alone.
//
// Bound: bytes. Per node it reads 16 bytes (nz_req + allocatable_cm) and
// writes 4, against ~50 float operations; at N = 8192 that is 160 KB, far
// below what fills the card, so a launch is latency-bound. The design is
// one thread per node, coalesced float2 loads, nothing staged.
#include <cuda_runtime.h>
#include <stdint.h>

#include "node_score.cuh"

__global__ void dynamic_node_score_kernel(const float2* __restrict__ nz_req,
                                          const float* __restrict__ t_nz,
                                          const float2* __restrict__ alloc_cm,
                                          const float* __restrict__ weights,
                                          float* __restrict__ out, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float2 nz = nz_req[i];
    const float2 cap = alloc_cm[i];
    out[i] = kb::dynamic_node_score(nz.x, nz.y, t_nz[0], t_nz[1], cap.x,
                                    cap.y, weights[0], weights[1]);
}

extern "C" int kb_dynamic_node_score(const void* nz_req, const void* t_nz,
                                     const void* alloc_cm,
                                     const void* weights, void* out, int n,
                                     void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    dynamic_node_score_kernel<<<blocks, threads, 0,
                                (cudaStream_t)stream>>>(
        (const float2*)nz_req, (const float*)t_nz, (const float2*)alloc_cm,
        (const float*)weights, (float*)out, n);
    return (int)cudaGetLastError();
}
