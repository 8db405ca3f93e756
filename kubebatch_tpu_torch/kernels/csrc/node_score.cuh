// nodeorder's allocation-dependent node score, shared by the standalone
// score kernel (node_score.cu), the fused and batched allocate kernels
// and the per-visit scan (allocate_scan.cu).
//
// Replaces kubebatch_tpu/kernels/solver.py:67 dynamic_node_score. The
// float32 operations are the plain version's, one for one and in the same
// order (kubebatch_tpu_torch/kernels/solver.py dynamic_node_score_plain).
// The sources are built with -fmad=false: a contracted
// (cap - req) * 10 >= d * cap rounds differently and flips integer
// scores. 10 - diff * 10 is one explicit fused multiply-add, as XLA:CPU's
// compiled kernels evaluate it (its LLVM backend contracts the pair).
#pragma once

#include <math.h>

namespace kb {

// least-requested and balanced-resource for one node, unweighted.
//   nz_cpu, nz_mem : the node's nonzero request sums (cpu milli, mem MiB)
//   t_cpu,  t_mem  : the task's nonzero request
//   cap_cpu, cap_mem : the node's allocatable (cpu milli, mem MiB)
__device__ __forceinline__ void least_balanced(
        float nz_cpu, float nz_mem, float t_cpu, float t_mem,
        float cap_cpu, float cap_mem, float& least, float& balanced) {
    const float ten = 10.0f;
    const float req0 = nz_cpu + t_cpu;
    const float req1 = nz_mem + t_mem;
    // threshold count of d in 1..10 with (cap - req) * 10 >= d * cap: the
    // integer division ((cap - req) * 10) / cap of the Go code, without
    // dividing
    const float lhs0 = (cap_cpu - req0) * ten;
    const float lhs1 = (cap_mem - req1) * ten;
    int cnt0 = 0, cnt1 = 0;
#pragma unroll
    for (int k = 1; k <= 10; ++k) {
        const float d = (float)k;
        cnt0 += (lhs0 >= d * cap_cpu) ? 1 : 0;
        cnt1 += (lhs1 >= d * cap_mem) ? 1 : 0;
    }
    const float dim0 = (cap_cpu > 0.0f && req0 <= cap_cpu) ? (float)cnt0 : 0.0f;
    const float dim1 = (cap_mem > 0.0f && req1 <= cap_mem) ? (float)cnt1 : 0.0f;
    least = floorf((dim0 + dim1) / 2.0f);

    const float frac0 = (cap_cpu > 0.0f) ? req0 / cap_cpu : 1.0f;
    const float frac1 = (cap_mem > 0.0f) ? req1 / cap_mem : 1.0f;
    const float diff = fabsf(frac0 - frac1);
    balanced = (frac0 >= 1.0f || frac1 >= 1.0f)
        ? 0.0f : truncf(__fmaf_rn(-diff, ten, ten));
}

// least-requested + balanced-resource for one node, weighted by
// w_least, w_bal (nodeorder's weights): both products rounded, then the
// sum, as the whole-cycle engines' compiled graphs evaluate it.
__device__ __forceinline__ float dynamic_node_score(
        float nz_cpu, float nz_mem, float t_cpu, float t_mem,
        float cap_cpu, float cap_mem, float w_least, float w_bal) {
    float least, balanced;
    least_balanced(nz_cpu, nz_mem, t_cpu, t_mem, cap_cpu, cap_mem, least,
                   balanced);
    return least * w_least + balanced * w_bal;
}

// The same score as the reference's compiled per-visit scan evaluates
// it: the weighted sum is one fused multiply-add,
// fma(balanced, w_bal, least * w_least) (kubebatch_tpu_torch/kernels/
// solver.py scan_node_score_plain). Equal to dynamic_node_score for
// integer weights.
__device__ __forceinline__ float scan_node_score(
        float nz_cpu, float nz_mem, float t_cpu, float t_mem,
        float cap_cpu, float cap_mem, float w_least, float w_bal) {
    float least, balanced;
    least_balanced(nz_cpu, nz_mem, t_cpu, t_mem, cap_cpu, cap_mem, least,
                   balanced);
    return __fmaf_rn(balanced, w_bal, least * w_least);
}

}  // namespace kb
