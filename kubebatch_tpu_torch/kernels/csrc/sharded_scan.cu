// The explicit-collective allocate scan with the node axis split over a
// mesh: one launch per task step on one rank's node block.
//
// Replaces kubebatch_tpu/kernels/sharded.py:113 build_sharded_allocate
// (its shard_map'ed scan, _sharded_scan_body :58-110). The plain PyTorch
// version is kubebatch_tpu_torch/kernels/sharded.py ScanPlain; the float
// operations are the same, in the same order (built with -fmad=false),
// so the packed rows, the decisions and the carry agree bit for bit.
//
// A step on one rank, between two all-gathers of [N_block, 5] rows
// (the host, kernels/sharded.py ScanCuda, gathers them):
//  1. (t >= 0) the argmax over the gathered [N, 5] rows of step t: the
//     first maximum of the masked scores (node 0 when every row is
//     -inf); the decision from the winner's fit bits; only the rank that
//     owns the winner takes the request off its idle or releasing row
//     and adds one task; the pipelined-inclusive readiness (allocated,
//     done) in a two-word state every rank keeps alike;
//  2. (t + 1 < T) the block's packed row of step t + 1 against the
//     updated carry: [masked score, fit_alloc, fit_idle, fit_pipe,
//     eligible] as float words.
// One block of threads: the step is a reduction over N and a pass over
// N_block, both small; the launch and the all-gather between steps, not
// bytes or operations, bound the scan (T dependent steps).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 1024;
constexpr int W = 5;
enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };

enum { P_IDLE, P_REL, P_BF, P_MAXT, P_NTASKS, P_NODE_OK, P_RESREQ, P_INIT,
       P_VALID, P_SCORES, P_PRED, P_EPS, P_MIN_AV, P_STATE, P_DECISION,
       P_NODE_IDX, N_PTRS };
enum { I_T, I_STEPS, I_NB, I_LO, I_K, N_INTS };

struct Args {
    float* idle; float* rel; const float* bf; const int32_t* maxt;
    int32_t* ntasks; const uint8_t* node_ok; const float* resreq;
    const float* init; const uint8_t* valid; const float* scores;
    const uint8_t* pred; const float* eps; const int32_t* min_av;
    int32_t* state;                        // [allocated, done]
    int32_t* decision; int32_t* node_idx;
    const int32_t* in;                     // gathered [K * nb, W] rows
    int32_t* out;                          // this block's [nb, W] rows
    int t, steps, nb, lo, k;
};

__global__ void __launch_bounds__(NT)
sharded_scan_kernel(const __grid_constant__ Args a) {
    __shared__ float s_v[NT / 32];
    __shared__ int s_i[NT / 32];
    const int tid = threadIdx.x, lane = tid & 31;
    if (a.t >= 0) {
        const int n = a.k * a.nb;
        float bv = -INFINITY;
        int bi = n;                        // none yet
        for (int i = tid; i < n; i += NT) {
            const float v = __int_as_float(a.in[(size_t)i * W]);
            if (bi == n || v > bv) { bv = v; bi = i; }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (oi < n && (bi == n || ov > bv || (ov == bv && oi < bi))) {
                bv = ov;
                bi = oi;
            }
        }
        if (lane == 0) { s_v[tid >> 5] = bv; s_i[tid >> 5] = bi; }
        __syncthreads();
        if (tid == 0) {
            for (int w = 1; w < NT / 32; ++w) {
                const float ov = s_v[w];
                const int oi = s_i[w];
                if (oi < n && (bi == n || ov > bv || (ov == bv && oi < bi))) {
                    bv = ov;
                    bi = oi;
                }
            }
            const int best = bi;
            const int32_t* row = a.in + (size_t)best * W;
            const bool feasible = __int_as_float(row[4]) > 0.0f;
            const bool is_alloc = __int_as_float(row[1]) > 0.0f;
            const bool over_bf = is_alloc && !(__int_as_float(row[2]) > 0.0f);
            const int t = a.t;
            const bool active = a.valid[t] && !a.state[1];
            const bool take = active && feasible;
            const int d = !active ? SKIP
                        : !feasible ? FAIL
                        : !is_alloc ? PIPELINE
                        : over_bf ? ALLOC_OB : ALLOC;
            const int local = best - a.lo;
            if (take && local >= 0 && local < a.nb) {
                const float ma = is_alloc ? 1.0f : 0.0f;
                const float mp = is_alloc ? 0.0f : 1.0f;
                for (int r = 0; r < 3; ++r) {
                    const float q = a.resreq[t * 3 + r];
                    a.idle[local * 3 + r] = a.idle[local * 3 + r] - ma * q;
                    a.rel[local * 3 + r] = a.rel[local * 3 + r] - mp * q;
                }
                a.ntasks[local] += 1;
            }
            const int allocated = a.state[0] + ((take && !over_bf) ? 1 : 0);
            a.state[0] = allocated;
            a.state[1] = a.state[1] || (active && !feasible)
                         || (take && allocated >= a.min_av[0]);
            a.decision[t] = d;
            a.node_idx[t] = best;
        }
        __syncthreads();
    }
    const int u = a.t + 1;
    if (u >= a.steps) return;
    float in3[3];
    for (int r = 0; r < 3; ++r) in3[r] = a.init[u * 3 + r];
    for (int i = tid; i < a.nb; i += NT) {
        bool fa = true, fi = true, fp = true;
        for (int r = 0; r < 3; ++r) {
            const float idle = a.idle[i * 3 + r];
            const float acc = idle + a.bf[i * 3 + r];
            fa = fa && in3[r] <= acc + a.eps[r];
            fi = fi && in3[r] <= idle + a.eps[r];
            fp = fp && in3[r] <= a.rel[i * 3 + r] + a.eps[r];
        }
        const bool room = a.ntasks[i] < a.maxt[i];
        const bool pr = a.node_ok[i] && room
                        && a.pred[(size_t)u * a.nb + i];
        const bool el = pr && (fa || fp);
        int32_t* o = a.out + (size_t)i * W;
        o[0] = __float_as_int(el ? a.scores[(size_t)u * a.nb + i]
                                 : -INFINITY);
        o[1] = __float_as_int(fa ? 1.0f : 0.0f);
        o[2] = __float_as_int(fi ? 1.0f : 0.0f);
        o[3] = __float_as_int(fp ? 1.0f : 0.0f);
        o[4] = __float_as_int(el ? 1.0f : 0.0f);
    }
}

}  // namespace

// Launch one step. ptrs: N_PTRS device addresses in the P_* order (the
// block's carry and static rows, the [T, nb] scores / predicates, the
// task rows, eps, min_available, the state and the outputs); ints:
// N_INTS (the step t to apply, -1 for the first pack; the steps T; the
// block's size and first node; the world size); in: the gathered rows of
// step t (null when t < 0); out: the block's rows of step t + 1.
// Returns the cudaError_t of the launch.
extern "C" int kb_sharded_scan(const unsigned long long* ptrs, int n_ptrs,
                               const int* ints, int n_ints, void* in,
                               void* out, void* reserved, void* stream) {
    (void)reserved;
    if (n_ptrs != N_PTRS || n_ints != N_INTS) return (int)cudaErrorInvalidValue;
    Args a;
    a.idle = (float*)ptrs[P_IDLE];
    a.rel = (float*)ptrs[P_REL];
    a.bf = (const float*)ptrs[P_BF];
    a.maxt = (const int32_t*)ptrs[P_MAXT];
    a.ntasks = (int32_t*)ptrs[P_NTASKS];
    a.node_ok = (const uint8_t*)ptrs[P_NODE_OK];
    a.resreq = (const float*)ptrs[P_RESREQ];
    a.init = (const float*)ptrs[P_INIT];
    a.valid = (const uint8_t*)ptrs[P_VALID];
    a.scores = (const float*)ptrs[P_SCORES];
    a.pred = (const uint8_t*)ptrs[P_PRED];
    a.eps = (const float*)ptrs[P_EPS];
    a.min_av = (const int32_t*)ptrs[P_MIN_AV];
    a.state = (int32_t*)ptrs[P_STATE];
    a.decision = (int32_t*)ptrs[P_DECISION];
    a.node_idx = (int32_t*)ptrs[P_NODE_IDX];
    a.in = (const int32_t*)in;
    a.out = (int32_t*)out;
    a.t = ints[I_T];
    a.steps = ints[I_STEPS];
    a.nb = ints[I_NB];
    a.lo = ints[I_LO];
    a.k = ints[I_K];
    if (a.nb < 1 || a.k < 1 || a.t >= a.steps || (a.t >= 0 && !a.in)
        || (a.t + 1 < a.steps && !a.out))
        return (int)cudaErrorInvalidValue;
    sharded_scan_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
