// One allocate job visit: the task scan of the per-visit engine, one
// launch, one thread block.
//
// Replaces kubebatch_tpu/kernels/solver.py:103 _allocate_scan (the jitted
// lax.scan behind DeviceSession.solve_job). For each of the job's T_pad
// task rows in order it masks the nodes (node_ok, a free task slot, the
// row's predicate, the launch request fitting idle + backfilled or
// releasing within eps), adds the dynamic node score when enabled, takes
// the lowest-index argmax (-inf for masked nodes; every node masked gives
// node 0 and FAIL), decides SKIP / FAIL / PIPELINE / ALLOC_OB / ALLOC, and
// commits the request to the winner's carry. Deciding stops once the job
// fails or crosses readiness, but every row still reports its argmax node,
// as the reference's scan does.
//
// Arithmetic is the plain version's (kernels/solver.py
// allocate_scan_plain), one operation for one, in the reference's compiled
// order: (idle + backfilled) + eps, score + scan_node_score(...) with the
// weighted sum as one FMA (node_score.cuh), idle - take / releasing - take
// on the winner only (x - 0 leaves every other row, -0.0 included), and
// nz_req + 0.0 on every row in the prologue (the reference adds zero to
// every row it does not place on, so a -0.0 sum becomes +0.0).
//
// Output: packed int32 [2 T_pad + 1 + 20]: decisions, node indices, the
// became-ready flag, the telemetry frame (kernels/telemetry.py layout,
// engine 1 "visit", one wave); and the carry (idle, releasing, n_tasks,
// nz_req) in new arrays, the inputs untouched.
//
// Bound: bytes, and far below what one launch costs. A visit reads the
// node state once (61 B a node), the [T_pad, N] score and predicate rows
// (5 B a cell) and writes the carry (36 B a node): at T_pad 8 and N_pad
// 8,192 about 1.1 MB, a third of a microsecond at the memory rate. The
// work is sequential over the task rows and tiny per row, so the kernel is
// latency-bound: one block of 1,024 threads, each thread owning nodes
// tid, tid + 1024, ...; per row a (score, index) reduction through warp
// shuffles and shared memory, thread 0 decides and commits the winner,
// two block barriers a row. The carry lives in the output arrays (L2
// resident at these sizes): eight nodes a thread times nine carry words
// would exceed the 64 registers a thread of a 1,024-thread block has.
#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTelem = 20;
constexpr int kEngineVisit = 1;
enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };

// flags of a reduction candidate
constexpr int kEligible = 1;
constexpr int kFitAlloc = 2;
constexpr int kFitIdle = 4;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ bool fits(const float* req, float a0, float a1,
                                     float a2) {
    return req[0] <= a0 && req[1] <= a1 && req[2] <= a2;
}

__global__ void __launch_bounds__(kThreads, 1) allocate_scan_kernel(
        const float* __restrict__ idle_in, const float* __restrict__ rel_in,
        const float* __restrict__ backfilled,
        const float* __restrict__ alloc_cm, const float* __restrict__ nz_in,
        const int32_t* __restrict__ max_task_num,
        const int32_t* __restrict__ nt_in, const uint8_t* __restrict__ node_ok,
        const float* __restrict__ resreq, const float* __restrict__ init_req,
        const float* __restrict__ task_nz, const uint8_t* __restrict__ valid,
        const float* __restrict__ scores, const uint8_t* __restrict__ pred,
        const float* __restrict__ weights, const float* __restrict__ eps,
        float* idle, float* rel, int32_t* n_tasks, float* nz,
        int32_t* __restrict__ packed, int n, int t_pad, int min_available,
        int init_allocated, int dyn_enabled) {
    __shared__ float s_v[kWarps];
    __shared__ int s_i[kWarps];
    __shared__ int s_f[kWarps];
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int i = tid; i < n; i += kThreads) {
        for (int r = 0; r < 3; ++r) {
            idle[3 * i + r] = idle_in[3 * i + r];
            rel[3 * i + r] = rel_in[3 * i + r];
        }
        n_tasks[i] = nt_in[i];
        nz[2 * i] = __fadd_rn(nz_in[2 * i], 0.0f);
        nz[2 * i + 1] = __fadd_rn(nz_in[2 * i + 1], 0.0f);
    }
    const float e0 = eps[0], e1 = eps[1], e2 = eps[2];
    const float w0 = weights[0], w1 = weights[1];
    // thread 0's scan state
    int allocated = init_allocated;
    bool done = false;
    __syncthreads();

    for (int t = 0; t < t_pad; ++t) {
        const float* req = init_req + 3 * t;
        const float tn0 = task_nz[2 * t], tn1 = task_nz[2 * t + 1];
        const float* srow = scores + (size_t)t * n;
        const uint8_t* prow = pred + (size_t)t * n;
        float bv = -INFINITY;
        int bi = INT_MAX;
        int bf = 0;
        for (int i = tid; i < n; i += kThreads) {
            const float i0 = idle[3 * i], i1 = idle[3 * i + 1],
                        i2 = idle[3 * i + 2];
            const bool fit_alloc = fits(
                req, __fadd_rn(__fadd_rn(i0, backfilled[3 * i]), e0),
                __fadd_rn(__fadd_rn(i1, backfilled[3 * i + 1]), e1),
                __fadd_rn(__fadd_rn(i2, backfilled[3 * i + 2]), e2));
            const bool fit_idle = fits(req, __fadd_rn(i0, e0),
                                       __fadd_rn(i1, e1), __fadd_rn(i2, e2));
            const bool fit_pipe = fits(req, __fadd_rn(rel[3 * i], e0),
                                       __fadd_rn(rel[3 * i + 1], e1),
                                       __fadd_rn(rel[3 * i + 2], e2));
            const bool eligible = node_ok[i] != 0
                && n_tasks[i] < max_task_num[i] && prow[i] != 0
                && (fit_alloc || fit_pipe);
            float score = srow[i];
            if (dyn_enabled) {
                score = __fadd_rn(score, kb::scan_node_score(
                    nz[2 * i], nz[2 * i + 1], tn0, tn1, alloc_cm[2 * i],
                    alloc_cm[2 * i + 1], w0, w1));
            }
            const float m = eligible ? score : -INFINITY;
            if (better(m, i, bv, bi)) {
                bv = m;
                bi = i;
                bf = (eligible ? kEligible : 0) | (fit_alloc ? kFitAlloc : 0)
                    | (fit_idle ? kFitIdle : 0);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, bv, off);
            const int oi = __shfl_down_sync(0xffffffffu, bi, off);
            const int of = __shfl_down_sync(0xffffffffu, bf, off);
            if (better(ov, oi, bv, bi)) {
                bv = ov;
                bi = oi;
                bf = of;
            }
        }
        if (lane == 0) {
            s_v[warp] = bv;
            s_i[warp] = bi;
            s_f[warp] = bf;
        }
        __syncthreads();
        if (warp == 0) {
            bv = s_v[lane];
            bi = s_i[lane];
            bf = s_f[lane];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                const float ov = __shfl_down_sync(0xffffffffu, bv, off);
                const int oi = __shfl_down_sync(0xffffffffu, bi, off);
                const int of = __shfl_down_sync(0xffffffffu, bf, off);
                if (better(ov, oi, bv, bi)) {
                    bv = ov;
                    bi = oi;
                    bf = of;
                }
            }
            if (lane == 0) {
                const int best = bi;
                const bool feasible = (bf & kEligible) != 0;
                const bool is_alloc = (bf & kFitAlloc) != 0;
                const bool over_backfill = is_alloc && !(bf & kFitIdle);
                const bool active = valid[t] != 0 && !done;
                const bool place = active && feasible;
                packed[t] = !active ? SKIP
                    : !feasible ? FAIL
                    : !is_alloc ? PIPELINE
                    : over_backfill ? ALLOC_OB : ALLOC;
                packed[t_pad + t] = best;
                if (place) {
                    float* dst = is_alloc ? idle : rel;
                    for (int r = 0; r < 3; ++r) {
                        dst[3 * best + r] = __fsub_rn(dst[3 * best + r],
                                                      resreq[3 * t + r]);
                    }
                    n_tasks[best] += 1;
                    nz[2 * best] = __fadd_rn(nz[2 * best], tn0);
                    nz[2 * best + 1] = __fadd_rn(nz[2 * best + 1], tn1);
                    if (!over_backfill) ++allocated;
                }
                done = done || (active && !feasible)
                    || (place && allocated >= min_available);
            }
        }
        __syncthreads();
    }

    if (tid == 0) {
        int bound = 0, failed = 0, pending = 0, census = 0;
        for (int t = 0; t < t_pad; ++t) {
            if (!valid[t]) continue;
            const int d = packed[t];
            ++census;
            bound += (d == ALLOC || d == ALLOC_OB || d == PIPELINE) ? 1 : 0;
            failed += (d == FAIL) ? 1 : 0;
            pending += (d == SKIP) ? 1 : 0;
        }
        packed[2 * t_pad] = allocated >= min_available ? 1 : 0;
        int32_t* frame = packed + 2 * t_pad + 1;
        for (int k = 0; k < kTelem; ++k) frame[k] = 0;
        frame[0] = kEngineVisit;
        frame[1] = 1;           // one wave
        frame[2] = bound;
        frame[3] = failed;
        frame[4] = pending;
        frame[5] = census;
        frame[6] = bound;       // every placement lands in wave slot 0
    }
}

}  // namespace

extern "C" int kb_allocate_scan(
        const void* idle, const void* releasing, const void* backfilled,
        const void* alloc_cm, const void* nz_req, const void* max_task_num,
        const void* n_tasks, const void* node_ok, const void* resreq,
        const void* init_resreq, const void* task_nz, const void* task_valid,
        const void* scores, const void* pred_mask, const void* weights,
        const void* eps, void* out_idle, void* out_rel, void* out_n_tasks,
        void* out_nz, void* packed, int n, int t_pad, int min_available,
        int init_allocated, int dyn_enabled, void* stream) {
    if (n <= 0 || t_pad <= 0) return (int)cudaErrorInvalidValue;
    allocate_scan_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)idle, (const float*)releasing,
        (const float*)backfilled, (const float*)alloc_cm,
        (const float*)nz_req, (const int32_t*)max_task_num,
        (const int32_t*)n_tasks, (const uint8_t*)node_ok,
        (const float*)resreq, (const float*)init_resreq,
        (const float*)task_nz, (const uint8_t*)task_valid,
        (const float*)scores, (const uint8_t*)pred_mask,
        (const float*)weights, (const float*)eps, (float*)out_idle,
        (float*)out_rel, (int32_t*)out_n_tasks, (float*)out_nz,
        (int32_t*)packed, n, t_pad, min_available, init_allocated,
        dyn_enabled);
    return (int)cudaGetLastError();
}
