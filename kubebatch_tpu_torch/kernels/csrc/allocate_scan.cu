// One allocate job visit: the task scan of the per-visit engine, one
// launch, one thread-block cluster.
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
// latency-bound: each row is a dependent argmax over every node and a
// commit to the winner.
// Design (redesigned for the H100's thread-block clusters):
//  - one visit per cluster of C CTAs of 1,024 threads (C the power of two
//    that gives each CTA at most 1,024 nodes, at most 8), launched with
//    cudaLaunchKernelEx and a cluster dimension. CTA c owns the nodes
//    [c P, (c+1) P), one thread a node;
//  - CTA c keeps its nodes' carry and state (idle 3, releasing 3,
//    backfilled 3, alloc_cm 2, nz 2, n_tasks, max_task_num, node_ok: 61 B
//    a node) in its shared memory for the whole launch and writes the
//    carry to the output arrays once at the end. A cluster of one CTA
//    (N_pad <= 1,024), or past kSmemMax bytes a CTA (N_pad > ~26,000),
//    keeps the carry in the output arrays instead (L2), the same code on
//    generic pointers: at one CTA the copies in and out cost more than
//    the rows save (cfg3, N_pad 512);
//  - per task row: each CTA's argmax of its nodes (warp shuffles, one
//    block barrier), published to its own shared slot (double-buffered by
//    the row's parity); one cluster barrier; every CTA's warp 0 reads the
//    C slots through DSMEM and reduces them under `better`, a total order
//    that ends in the node index, so every CTA takes the same winner and
//    keeps the same decision state (allocated, done); a block barrier; the
//    thread that owns the winner commits it in its CTA's shared memory;
//  - CTA 0's thread 0 writes the decisions and the telemetry frame, and
//    times the phases (prologue, rows, epilogue) on the global timer.
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// nodes a CTA owns at most before the cluster grows (one a thread)
constexpr int kNodesPerCta = kThreads;
// shared bytes of one node's carry and state
constexpr int kNodeBytes = 61;
// the most shared memory a CTA keeps node state in
constexpr int kSmemMax = 200 * 1024;
constexpr int kTelem = 20;
constexpr int kEngineVisit = 1;
enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };
// phases timed by CTA 0's thread 0 (kernels/solver.py SCAN_PHASES)
enum { PH_PROLOGUE, PH_ROWS, PH_EPILOGUE, N_PHASES };

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

// a CTA's row winner as the other CTAs read it
struct Cand {
    float v;
    int i;
    int f;
};

__device__ __forceinline__ void warp_best(float& bv, int& bi, int& bf) {
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
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
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
        int32_t* __restrict__ packed, unsigned long long* phase_ns, int n,
        int t_pad, int min_available, int init_allocated, int dyn_enabled,
        int smem_state) {
    cg::cluster_group cl = cg::this_cluster();
    extern __shared__ __align__(16) uint8_t s_state[];
    __shared__ float s_v[kWarps];
    __shared__ int s_i[kWarps];
    __shared__ int s_f[kWarps];
    __shared__ Cand s_slot[2];
    __shared__ int s_best, s_place, s_alloc;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int C = (int)cl.num_blocks(), c = (int)cl.block_rank();
    const int P = (n + C - 1) / C;
    const int base = min(c * P, n), cnt = min(P, n - base);
    const bool timer = c == 0 && tid == 0;
    unsigned long long ph[N_PHASES] = {0, 0, 0};
    unsigned long long t_last = timer ? now_ns() : 0;
#define MARK(p)                                     \
    do {                                            \
        if (timer) {                                \
            const unsigned long long t_ = now_ns(); \
            ph[p] += t_ - t_last;                   \
            t_last = t_;                            \
        }                                           \
    } while (0)

    // this CTA's nodes: shared memory, or the output arrays and inputs
    float *s_idle, *s_rel, *s_back, *s_acm, *s_nz;
    int32_t *s_nt, *s_mtn;
    uint8_t* s_ok;
    if (smem_state) {
        s_idle = (float*)s_state;
        s_rel = s_idle + 3 * P;
        s_back = s_rel + 3 * P;
        s_acm = s_back + 3 * P;
        s_nz = s_acm + 2 * P;
        s_nt = (int32_t*)(s_nz + 2 * P);
        s_mtn = s_nt + P;
        s_ok = (uint8_t*)(s_mtn + P);
    } else {
        s_idle = idle + 3 * base;
        s_rel = rel + 3 * base;
        s_back = (float*)backfilled + 3 * base;
        s_acm = (float*)alloc_cm + 2 * base;
        s_nz = nz + 2 * base;
        s_nt = n_tasks + base;
        s_mtn = (int32_t*)max_task_num + base;
        s_ok = (uint8_t*)node_ok + base;
    }
    for (int j = tid; j < cnt; j += kThreads) {
        const int i = base + j;
        for (int r = 0; r < 3; ++r) {
            s_idle[3 * j + r] = idle_in[3 * i + r];
            s_rel[3 * j + r] = rel_in[3 * i + r];
        }
        s_nt[j] = nt_in[i];
        s_nz[2 * j] = __fadd_rn(nz_in[2 * i], 0.0f);
        s_nz[2 * j + 1] = __fadd_rn(nz_in[2 * i + 1], 0.0f);
        if (smem_state) {
            for (int r = 0; r < 3; ++r)
                s_back[3 * j + r] = backfilled[3 * i + r];
            s_acm[2 * j] = alloc_cm[2 * i];
            s_acm[2 * j + 1] = alloc_cm[2 * i + 1];
            s_mtn[j] = max_task_num[i];
            s_ok[j] = node_ok[i];
        }
    }
    const float e0 = eps[0], e1 = eps[1], e2 = eps[2];
    const float w0 = weights[0], w1 = weights[1];
    // warp 0's lane 0 keeps the scan state, alike in every CTA
    int allocated = init_allocated;
    bool done = false;
    int bound = 0, failed = 0, pending = 0, census = 0;
    // row t's inputs, loaded a row ahead (their latency hides behind the
    // row before's barriers): the task's request, launch request, nonzero
    // request and validity, and this thread's first node's score and
    // predicate cell
    float q0 = init_req[0], q1 = init_req[1], q2 = init_req[2];
    float k0 = resreq[0], k1 = resreq[1], k2 = resreq[2];
    float tn0 = task_nz[0], tn1 = task_nz[1];
    int vt = valid[0];
    float sc = 0.0f;
    int pr = 0;
    if (tid < cnt) {
        sc = scores[base + tid];
        pr = pred[base + tid];
    }
    __syncthreads();
    MARK(PH_PROLOGUE);

    for (int t = 0; t < t_pad; ++t) {
        const float req[3] = {q0, q1, q2};
        const float take0 = k0, take1 = k1, take2 = k2;
        const float n0 = tn0, n1 = tn1;
        const int row_valid = vt;
        const float sc_t = sc;
        const int pr_t = pr;
        if (t + 1 < t_pad) {
            const int u = t + 1;
            q0 = init_req[3 * u];
            q1 = init_req[3 * u + 1];
            q2 = init_req[3 * u + 2];
            k0 = resreq[3 * u];
            k1 = resreq[3 * u + 1];
            k2 = resreq[3 * u + 2];
            tn0 = task_nz[2 * u];
            tn1 = task_nz[2 * u + 1];
            vt = valid[u];
            if (tid < cnt) {
                sc = scores[(size_t)u * n + base + tid];
                pr = pred[(size_t)u * n + base + tid];
            }
        }
        const float* srow = scores + (size_t)t * n + base;
        const uint8_t* prow = pred + (size_t)t * n + base;
        float bv = -INFINITY;
        int bi = INT_MAX;
        int bf = 0;
        for (int j = tid; j < cnt; j += kThreads) {
            const float i0 = s_idle[3 * j], i1 = s_idle[3 * j + 1],
                        i2 = s_idle[3 * j + 2];
            const bool fit_alloc = fits(
                req, __fadd_rn(__fadd_rn(i0, s_back[3 * j]), e0),
                __fadd_rn(__fadd_rn(i1, s_back[3 * j + 1]), e1),
                __fadd_rn(__fadd_rn(i2, s_back[3 * j + 2]), e2));
            const bool fit_idle = fits(req, __fadd_rn(i0, e0),
                                       __fadd_rn(i1, e1), __fadd_rn(i2, e2));
            const bool fit_pipe = fits(req, __fadd_rn(s_rel[3 * j], e0),
                                       __fadd_rn(s_rel[3 * j + 1], e1),
                                       __fadd_rn(s_rel[3 * j + 2], e2));
            const bool first = j == tid;
            const bool eligible = s_ok[j] != 0 && s_nt[j] < s_mtn[j]
                && (first ? pr_t : prow[j]) != 0 && (fit_alloc || fit_pipe);
            float score = first ? sc_t : srow[j];
            if (dyn_enabled) {
                score = __fadd_rn(score, kb::scan_node_score(
                    s_nz[2 * j], s_nz[2 * j + 1], n0, n1, s_acm[2 * j],
                    s_acm[2 * j + 1], w0, w1));
            }
            const float m = eligible ? score : -INFINITY;
            const int i = base + j;
            if (better(m, i, bv, bi)) {
                bv = m;
                bi = i;
                bf = (eligible ? kEligible : 0) | (fit_alloc ? kFitAlloc : 0)
                    | (fit_idle ? kFitIdle : 0);
            }
        }
        warp_best(bv, bi, bf);
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
            warp_best(bv, bi, bf);
            if (C > 1 && lane == 0) s_slot[t & 1] = Cand{bv, bi, bf};
        }
        if (C > 1) {
            // every CTA's winner published; slot t & 1 is rewritten at row
            // t + 2, after every CTA has passed this row's reads
            cl.sync();
            if (warp == 0) {
                bv = -INFINITY;
                bi = INT_MAX;
                bf = 0;
                if (lane < C) {
                    const Cand o = *cl.map_shared_rank(&s_slot[t & 1], lane);
                    bv = o.v;
                    bi = o.i;
                    bf = o.f;
                }
                warp_best(bv, bi, bf);
            }
        }
        if (tid == 0) {
            const int best = bi;
            const bool feasible = (bf & kEligible) != 0;
            const bool is_alloc = (bf & kFitAlloc) != 0;
            const bool over_backfill = is_alloc && !(bf & kFitIdle);
            const bool active = row_valid != 0 && !done;
            const bool place = active && feasible;
            const int d = !active ? SKIP
                : !feasible ? FAIL
                : !is_alloc ? PIPELINE
                : over_backfill ? ALLOC_OB : ALLOC;
            if (c == 0) {
                packed[t] = d;
                packed[t_pad + t] = best;
            }
            if (row_valid) {
                ++census;
                bound += (d == ALLOC || d == ALLOC_OB || d == PIPELINE)
                    ? 1 : 0;
                failed += d == FAIL ? 1 : 0;
                pending += d == SKIP ? 1 : 0;
            }
            if (place && !over_backfill) ++allocated;
            done = done || (active && !feasible)
                || (place && allocated >= min_available);
            s_best = best;
            s_place = place ? 1 : 0;
            s_alloc = is_alloc ? 1 : 0;
        }
        __syncthreads();
        if (s_place) {
            const int j = s_best - base;
            if (j >= 0 && j < cnt && j % kThreads == tid) {
                float* dst = s_alloc ? s_idle : s_rel;
                dst[3 * j] = __fsub_rn(dst[3 * j], take0);
                dst[3 * j + 1] = __fsub_rn(dst[3 * j + 1], take1);
                dst[3 * j + 2] = __fsub_rn(dst[3 * j + 2], take2);
                s_nt[j] += 1;
                s_nz[2 * j] = __fadd_rn(s_nz[2 * j], n0);
                s_nz[2 * j + 1] = __fadd_rn(s_nz[2 * j + 1], n1);
            }
        }
    }
    MARK(PH_ROWS);

    if (smem_state) {
        for (int j = tid; j < cnt; j += kThreads) {
            const int i = base + j;
            for (int r = 0; r < 3; ++r) {
                idle[3 * i + r] = s_idle[3 * j + r];
                rel[3 * i + r] = s_rel[3 * j + r];
            }
            n_tasks[i] = s_nt[j];
            nz[2 * i] = s_nz[2 * j];
            nz[2 * i + 1] = s_nz[2 * j + 1];
        }
    }
    if (c == 0 && tid == 0) {
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
    // no CTA leaves while another still reads its slot
    if (C > 1) cl.sync();
    MARK(PH_EPILOGUE);
#undef MARK
    if (timer && phase_ns)
        for (int p = 0; p < N_PHASES; ++p) phase_ns[p] = ph[p];
}

}  // namespace

// One visit: a cluster of C CTAs (C chosen here by the node count); the
// carry in shared memory when it fits. phase_ns: N_PHASES uint64 on the
// device (may be null). A refused launch is returned, never retried
// another way.
extern "C" int kb_allocate_scan(
        const void* idle, const void* releasing, const void* backfilled,
        const void* alloc_cm, const void* nz_req, const void* max_task_num,
        const void* n_tasks, const void* node_ok, const void* resreq,
        const void* init_resreq, const void* task_nz, const void* task_valid,
        const void* scores, const void* pred_mask, const void* weights,
        const void* eps, void* out_idle, void* out_rel, void* out_n_tasks,
        void* out_nz, void* packed, int n, int t_pad, int min_available,
        int init_allocated, int dyn_enabled, void* phase_ns, void* stream) {
    if (n <= 0 || t_pad <= 0) return (int)cudaErrorInvalidValue;
    int C = 1;
    while (C < kMaxCluster && (long long)C * kNodesPerCta < n) C *= 2;
    const int P = (n + C - 1) / C;
    const size_t state_bytes = (size_t)P * kNodeBytes;
    const int smem_state = C > 1 && state_bytes <= (size_t)kSmemMax;
    static bool attr_set = false;
    if (!attr_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            allocate_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            kSmemMax);
        if (e != cudaSuccess) return (int)e;
        attr_set = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem_state ? state_bytes : 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, allocate_scan_kernel, (const float*)idle,
        (const float*)releasing, (const float*)backfilled,
        (const float*)alloc_cm, (const float*)nz_req,
        (const int32_t*)max_task_num, (const int32_t*)n_tasks,
        (const uint8_t*)node_ok, (const float*)resreq,
        (const float*)init_resreq, (const float*)task_nz,
        (const uint8_t*)task_valid, (const float*)scores,
        (const uint8_t*)pred_mask, (const float*)weights, (const float*)eps,
        (float*)out_idle, (float*)out_rel, (int32_t*)out_n_tasks,
        (float*)out_nz, (int32_t*)packed, (unsigned long long*)phase_ns, n,
        t_pad, min_available, init_allocated, dyn_enabled, smem_state);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The cluster shape of a visit over n nodes: writes C, the nodes a CTA
// owns, and whether the carry lives in shared memory into info[3].
extern "C" int kb_allocate_scan_shape(int n, int* info) {
    int C = 1;
    while (C < kMaxCluster && (long long)C * kNodesPerCta < n) C *= 2;
    const int P = (n + C - 1) / C;
    info[0] = C;
    info[1] = P;
    info[2] = C > 1 && (size_t)P * kNodeBytes <= (size_t)kSmemMax;
    return 0;
}
