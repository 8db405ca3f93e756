// The fused allocate loop as a device function run by one thread-block
// cluster per problem, shared by the one-problem kernel (fused_allocate.cu)
// and the one-cluster-per-lane mega kernel (mega_fused.cu). Replaces the
// body of kubebatch_tpu/kernels/fused.py:112 fused_allocate. The plain
// PyTorch version is kubebatch_tpu_torch/kernels/fused.py
// fused_allocate_plain; every float operation here is that version's, in
// the same order, so the host block and the node carries agree bit for bit
// (built with -fmad=false).
//
// What bounds it on an H100: neither bytes nor operations. The inputs are
// ~2 MB at cfg5 and each node solve does ~90 float operations per node, but
// the iterations form a dependence chain: the next placement reads the
// state the previous one wrote. The floor is node solves x (one pass over
// the nodes + the barriers that order it). Design:
//  - one cluster of C CTAs (a power of two: up to 8 when the kernel
//    chooses, from the node count, up to 16 when given) runs one problem.
//    CTA c owns the nodes [c P, (c+1) P) and keeps their carries (idle,
//    releasing, n_tasks, nz) and, where the budget allows, their read-only
//    inputs in its shared memory for the whole launch (1,024 nodes a CTA
//    of 512 threads at cfg5: N_pad 8,192, C 8); its thread n % NT alone
//    reads and writes node n, so the carries need no barrier;
//  - every CTA runs the selection itself on its own replica of the job and
//    queue state (shared memory where it fits beside the nodes, else its
//    own global replica): the queue pick (each warp), the job pick (one
//    block-wide pass over lexicographic key codes), the task pick (a
//    cursor into the job's task records, sorted by (rank, index) in the
//    prologue: a job's pending tasks are always a suffix of that order,
//    so a visit's next record, and its score and predicate cells at each
//    thread's first two nodes, are loaded a solve ahead). The loop's
//    scalars (current job, seq, iteration, live queues, the visit's job
//    and queue allocations) live in every thread's registers and every
//    thread updates them alike, so the selection needs no cluster barrier;
//    the replicas take a visit's changes when it ends (no selection reads
//    them sooner), thread 0 the job's and kQueueUpdater the queue's;
//  - a node solve: each CTA's argmax over its nodes as one 64-bit key
//    (score code, lowest index, fit flags; the warps' integer max
//    reductions, one block barrier), published into a shared slot
//    double-buffered by the solve's parity; one cluster barrier; every
//    warp of every CTA reduces the C slots through DSMEM to the same
//    winner. The node's owner thread updates its carries, CTA 0's kWriter
//    the host block. A cluster of one synchronises as a block (a cluster
//    barrier costs ~0.63 us even at one CTA);
//  - a pop that finds its queue overused or without a job changes only
//    that queue's entries and the iteration count, so the pops that
//    repeat it are consumed in one step: k = min(entries, max_iters - it);
//  - exits and collapses are computed from replicated state, so every CTA
//    runs the same number of cluster barriers; a last one comes before any
//    CTA leaves (its slots may still be read).
#pragma once

#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                  // threads in a CTA
constexpr int NWARPS = NT / 32;
constexpr int kMaxCluster = 16;          // CTAs a problem at most
constexpr int kAutoCluster = 8;          // ... when the kernel chooses
constexpr int kNodesPerCta = 1024;       // nodes a CTA owns before C grows
constexpr int kMaxNodes = 1 << 28;       // node indices fit node_key
constexpr int kSmemMax = 220 * 1024;     // dynamic shared bytes a CTA uses
constexpr float BIG = 3.0e38f;           // _lex_argmin's masked-out key
constexpr int TELEM_WIDTH = 20;
constexpr int WAVE_SLOTS = 4;
constexpr int ENGINE_FUSED = 3;
constexpr unsigned FULL = 0xffffffffu;
// the threads that apply a placement beside each other, each the lane 0
// of its own warp: thread 0 the job's replica, kQueueUpdater the queue's,
// CTA 0's kWriter the host block
constexpr int kWriter = NT > 32 ? 32 : 0;
constexpr int kQueueUpdater = NT > 64 ? 64 : 0;

enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };
// order-key codes (kernels/fused.py JOB_KEY_CODES); K_RANK is the
// creation-rank tie-break every key list ends with
enum { K_PRIORITY = 0, K_GANG_READY = 1, K_DRF_SHARE = 2, K_RANK = 3 };
// phases timed by CTA 0's thread 0 (kernels/fused.py FUSED_PHASES), then
// its counters (FUSED_COUNTS)
enum { PH_PROLOGUE, PH_TOP, PH_JOB, PH_TASK, PH_NODE, PH_EXCHANGE, PH_UPDATE,
       PH_EPILOGUE, N_PHASES };
enum { CT_PASSES, CT_SOLVES, CT_RUNS, CT_RUN_ITERS, N_COUNTS };
// state groups, each in shared memory when it fits (in this order)
enum { G_CARRY, G_NODEIN, G_QUEUE, G_JPICK, G_JUPD, N_GROUPS };
// flags of a node candidate
constexpr int kEligible = 1;
constexpr int kFitAlloc = 2;
constexpr int kFitIdle = 4;

struct Params {
    // node carries (outputs, cloned from the inputs by the wrapper)
    float* idle;
    float* rel;
    int32_t* n_tasks;
    float* nz;
    // node inputs
    const float* backfilled;
    const float* alloc_cm;
    const int32_t* max_task_num;
    const uint8_t* node_ok;
    // tasks
    const float* resreq;
    const float* init_resreq;
    const float* task_nz;
    const int32_t* task_job;
    const int32_t* task_rank;
    const int32_t* task_sig;
    const uint8_t* task_valid;
    const float* sig_scores;
    const uint8_t* sig_pred;
    // jobs
    const int32_t* min_available;
    const int32_t* order_min_available;
    const int32_t* init_allocated;
    const int32_t* job_queue;
    const float* job_priority;
    const int32_t* job_create_rank;
    const uint8_t* job_valid;
    // queues and shares
    const int32_t* q_entries;
    const int32_t* q_create_rank;
    const float* q_deserved;
    const float* q_alloc0;
    const float* j_alloc0;
    const float* cluster_total;
    const float* dyn_weights;
    const float* eps;
    // each CTA's global replicas ([lanes][C] of Layout::ws_cta bytes)
    uint8_t* ws;
    // N_PHASES + N_COUNTS uint64, or null (no timers)
    unsigned long long* phase_ns;
    // output: int32 [3, T + 1 + TELEM_WIDTH]
    int32_t* host_block;
    int n_nodes, n_tasks_total, n_jobs, n_queues;
    int job_keys[3];
    int n_job_keys;
    int use_prop_share;
    int gang_enabled, prop_overused, dyn_enabled, max_iters;
    int narrow, narrow_gate;
};

// a bucketed task as the loop reads it: its index, sig row, launch
// request, nonzero request and request, in one 48-byte record
struct __align__(16) TaskRec {
    int t, sig;
    float q0, q1, q2, n0, n1, r0, r1, r2;
    int pad0, pad1;
};

// the block's reduction scratch, the exchange slots, the frame counts of
// CTA 0's writer thread, the timer thread's phase sums and counters, and a
// mega lane's parameter block, at the start of the dynamic shared memory
struct Ctl {
    uint4 wc[NWARPS];
    Params lane;
    unsigned long long wk[NWARPS];
    unsigned long long slot[2];      // a CTA's node winner (node_key)
    unsigned long long ph[(int)N_PHASES + (int)N_COUNTS];
    int wj[NWARPS];
    int wn[NWARPS];
    int f_bound, f_failed, f_wave[WAVE_SLOTS];
};

__host__ __device__ inline long long pad16(long long b) {
    return (b + 15) & ~15LL;
}

// bytes of a state group: carries idle 3, rel 3, nz 2 (f32), n_tasks; node
// inputs backfilled 3, alloc_cm 2, max_task_num, node_ok (u8); queues
// entries, q_alloc 3, codes 2, q_deserved 3; the job pick's codes 4 and
// queue-or--1; the job updates' j_alloc 3, alloc_cnt, cursor, start
// (J + 1), min_available, order_min_available
__host__ __device__ inline long long group_bytes(int g, long long P,
                                                 long long J, long long Q) {
    switch (g) {
        case G_CARRY: return pad16(36 * P);
        case G_NODEIN: return pad16(25 * P);
        case G_QUEUE: return pad16(36 * Q);
        case G_JPICK: return pad16(20 * J);
        default: return pad16(32 * J + 4);
    }
}

struct Layout {
    int C;                        // CTAs a problem
    int P;                        // nodes a CTA owns
    int res[N_GROUPS];            // group kept in shared memory
    int off[N_GROUPS];            // its byte offset there
    int smem;                     // dynamic shared bytes of a CTA
    long long ws_off[N_GROUPS];   // queue / job groups in the replica
    long long ws_csr;             // the task buckets (2 T words, T recs)
    long long ws_cta;             // bytes of one CTA's replica
};

inline Layout make_layout(int n, int t, int j, int q, int C) {
    Layout L = {};
    L.C = C;
    L.P = (n + C - 1) / C;
    long long used = pad16((long long)sizeof(Ctl));
    for (int g = 0; g < N_GROUPS; ++g) {
        const long long b = group_bytes(g, L.P, j, q);
        if (used + b <= kSmemMax) {
            L.res[g] = 1;
            L.off[g] = (int)used;
            used += b;
        }
    }
    L.smem = (int)used;
    long long w = 0;
    for (int g = G_QUEUE; g < N_GROUPS; ++g) {
        L.ws_off[g] = w;
        w += group_bytes(g, L.P, j, q);
    }
    L.ws_csr = w;
    L.ws_cta = w + pad16(8LL * t) + (long long)sizeof(TaskRec) * t;
    return L;
}

// the smallest cluster that gives a CTA at most kNodesPerCta nodes
inline int auto_cluster(int n) {
    int C = 1;
    while (C < kAutoCluster && (long long)C * kNodesPerCta < n) C *= 2;
    return C;
}

// one CTA's view of its state, in shared or global memory
struct View {
    float *idle, *rel, *nz;
    int32_t* nt;
    const float *back, *acm;
    const int32_t* mtn;
    const uint8_t* ok;
    int32_t* entries;
    float* q_alloc;
    uint32_t* qcode;
    float* q_deserved;
    uint4* jcode;
    int32_t* jq;          // job_queue while the job is valid and queued, -1
    float* j_alloc;
    int32_t *alloc_cnt, *cur, *start, *min_av, *omin;
    int32_t* tmp;
    float* tmpr;          // the rank of tmp's task
    TaskRec* rec;         // the buckets ordered by (rank, index)
};

__device__ __forceinline__ View make_view(const Params& p, const Layout& L,
                                          uint8_t* smem, uint8_t* ws,
                                          int base) {
    const int P = L.P, J = p.n_jobs, Q = p.n_queues, T = p.n_tasks_total;
    View v;
    if (L.res[G_CARRY]) {
        v.idle = (float*)(smem + L.off[G_CARRY]);
        v.rel = v.idle + 3 * P;
        v.nz = v.rel + 3 * P;
        v.nt = (int32_t*)(v.nz + 2 * P);
    } else {
        v.idle = p.idle + 3 * base;
        v.rel = p.rel + 3 * base;
        v.nz = p.nz + 2 * base;
        v.nt = p.n_tasks + base;
    }
    if (L.res[G_NODEIN]) {
        float* b = (float*)(smem + L.off[G_NODEIN]);
        v.back = b;
        v.acm = b + 3 * P;
        int32_t* m = (int32_t*)(b + 5 * P);
        v.mtn = m;
        v.ok = (const uint8_t*)(m + P);
    } else {
        v.back = p.backfilled + 3 * base;
        v.acm = p.alloc_cm + 2 * base;
        v.mtn = p.max_task_num + base;
        v.ok = p.node_ok + base;
    }
    uint8_t* qb = L.res[G_QUEUE] ? smem + L.off[G_QUEUE]
                                 : ws + L.ws_off[G_QUEUE];
    v.entries = (int32_t*)qb;
    v.q_alloc = (float*)(v.entries + Q);
    v.qcode = (uint32_t*)(v.q_alloc + 3 * Q);
    v.q_deserved = (float*)(v.qcode + 2 * Q);
    uint8_t* jb = L.res[G_JPICK] ? smem + L.off[G_JPICK]
                                 : ws + L.ws_off[G_JPICK];
    v.jcode = (uint4*)jb;
    v.jq = (int32_t*)(v.jcode + J);
    uint8_t* ub = L.res[G_JUPD] ? smem + L.off[G_JUPD]
                                : ws + L.ws_off[G_JUPD];
    v.j_alloc = (float*)ub;
    v.alloc_cnt = (int32_t*)(v.j_alloc + 3 * J);
    v.cur = v.alloc_cnt + J;
    v.start = v.cur + J;
    v.min_av = v.start + J + 1;
    v.omin = v.min_av + J;
    v.tmp = (int32_t*)(ws + L.ws_csr);
    v.tmpr = (float*)(v.tmp + T);
    v.rec = (TaskRec*)(ws + L.ws_csr + pad16(8LL * T));
    return v;
}

// jnp.max semantics: NaN propagates
__device__ __forceinline__ float nanmax2(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b > a ? b : a;
}

__device__ __forceinline__ int warp_sum_i(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// block-wide sum, result in every thread; ends with a barrier, so the
// scratch may be reused at once
__device__ int block_sum(int x, Ctl& S) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    x = warp_sum_i(x);
    if (lane == 0) S.wn[warp] = x;
    __syncthreads();
    int r = lane < NWARPS ? S.wn[lane] : 0;
    r = warp_sum_i(r);
    __syncthreads();
    return r;
}

// a[0..n) -> out[0..n] exclusive prefix sums (out[n] the total), a zeroed;
// each thread takes one contiguous chunk of a, so it reads and rewrites
// only its own elements
__device__ void block_scan_zero(int32_t* a, int n, int32_t* out, Ctl& S) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int chunk = (n + NT - 1) / NT;
    const int b = min(tid * chunk, n), e = min(b + chunk, n);
    int sum = 0;
    for (int k = b; k < e; ++k) sum += a[k];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) S.wn[warp] = incl;
    __syncthreads();
    int wpre = 0, total = 0;
    for (int w = 0; w < NWARPS; ++w) {
        const int s = S.wn[w];
        wpre += w < warp ? s : 0;
        total += s;
    }
    int acc = wpre + incl - sum;
    for (int k = b; k < e; ++k) {
        out[k] = acc;
        acc += a[k];
        a[k] = 0;
    }
    if (tid == 0) out[n] = total;
    __syncthreads();
}

// _share: max over the 3 resources of alloc/denom with 0/0 -> 0, x/0 -> 1
// (jnp.maximum and jnp.max propagate NaN)
__device__ __forceinline__ float share1(float a, float d) {
    const float dm = (d != d) ? d : fmaxf(d, 1e-30f);
    return (d == 0.0f) ? (a == 0.0f ? 0.0f : 1.0f) : a / dm;
}

__device__ __forceinline__ float share3(const float* alloc,
                                        const float* denom) {
    return nanmax2(nanmax2(share1(alloc[0], denom[0]),
                           share1(alloc[1], denom[1])),
                   share1(alloc[2], denom[2]));
}

// An order-preserving code of a key for _lex_argmin's passes: codes
// compare as the keys do, -0.0 and +0.0 share one, and NaN is 0, below
// every key: the lexicographic minimum of the codes is poisoned exactly
// when a pass of _lex_argmin meets a NaN among the candidates still tied
// (its jnp.min is then NaN and nothing equals it: no pick).
__device__ __forceinline__ uint32_t key_code(float x) {
    if (x != x) return 0u;
    const uint32_t b = __float_as_uint(x == 0.0f ? 0.0f : x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool code_less(const uint4& a, int ai,
                                          const uint4& b, int bi) {
    if (a.x != b.x) return a.x < b.x;
    if (a.y != b.y) return a.y < b.y;
    if (a.z != b.z) return a.z < b.z;
    if (a.w != b.w) return a.w < b.w;
    return ai < bi;
}

// the warp's lexicographic minimum of (codes, j), level by level with the
// warp's integer min reduction: every lane gets it (j >= 0)
__device__ __forceinline__ void warp_code_min(uint4& c, int& j) {
    const uint32_t m0 = __reduce_min_sync(FULL, c.x);
    bool tie = c.x == m0;
    const uint32_t m1 = __reduce_min_sync(FULL, tie ? c.y : ~0u);
    tie = tie && c.y == m1;
    const uint32_t m2 = __reduce_min_sync(FULL, tie ? c.z : ~0u);
    tie = tie && c.z == m2;
    const uint32_t m3 = __reduce_min_sync(FULL, tie ? c.w : ~0u);
    tie = tie && c.w == m3;
    j = (int)__reduce_min_sync(FULL, tie ? (uint32_t)j : ~0u);
    c = make_uint4(m0, m1, m2, m3);
}

__device__ __forceinline__ uint32_t code_at(const uint4& c, int l) {
    return l == 0 ? c.x : l == 1 ? c.y : l == 2 ? c.z : c.w;
}

__device__ __forceinline__ void set_code(uint4& c, int l, uint32_t x) {
    if (l == 0) c.x = x;
    else if (l == 1) c.y = x;
    else if (l == 2) c.z = x;
    else c.w = x;
}

__device__ __forceinline__ bool codes_tie_below(const uint4& a,
                                                const uint4& b, int l) {
    return (l < 1 || a.x == b.x) && (l < 2 || a.y == b.y)
        && (l < 3 || a.z == b.z);
}

__device__ __forceinline__ float job_key(const Params& p, const View& v,
                                         int code, int j) {
    switch (code) {
        case K_PRIORITY: return -p.job_priority[j];
        case K_GANG_READY: return (v.alloc_cnt[j] >= v.omin[j]) ? 1.0f : 0.0f;
        case K_DRF_SHARE: return share3(v.j_alloc + 3 * j, p.cluster_total);
        default: return (float)p.job_create_rank[j];
    }
}

// job j's key codes: the configured keys, then the creation rank; unused
// levels hold 1, alike for every job
__device__ uint4 job_codes(const Params& p, const View& v, int j) {
    const int nk = p.n_job_keys;
    uint32_t c[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        float key = 0.0f;
        if (k < 3 && k < nk) key = job_key(p, v, p.job_keys[k], j);
        else if (k == nk) key = (float)p.job_create_rank[j];
        c[k] = k <= nk ? key_code(key) : 1u;
    }
    return make_uint4(c[0], c[1], c[2], c[3]);
}

// queue q's key codes: the proportion share when enabled, the creation
// rank; an unused level holds 1
__device__ __forceinline__ void queue_codes(const Params& p, const View& v,
                                            int q) {
    const uint32_t r = key_code((float)p.q_create_rank[q]);
    if (p.use_prop_share) {
        v.qcode[2 * q] = key_code(share3(v.q_alloc + 3 * q,
                                         v.q_deserved + 3 * q));
        v.qcode[2 * q + 1] = r;
    } else {
        v.qcode[2 * q] = r;
        v.qcode[2 * q + 1] = 1u;
    }
}

// _lex_argmin over the queues with entries left, by each warp alone: the
// queue (-1 for none) and its entries, in every lane. A candidate key
// above BIG loses to the BIG that a masked-out queue contributes to the
// pass's minimum, unless every queue is a tied candidate.
struct QPick {
    int q;
    int eq;
};

__device__ QPick queue_pick(const View& v, int Q) {
    const int lane = threadIdx.x & 31;
    uint32_t b0 = ~0u, b1 = ~0u;
    int bq = INT_MAX;
    for (int q = lane; q < Q; q += 32) {
        if (v.entries[q] <= 0) continue;
        const uint32_t c0 = v.qcode[2 * q], c1 = v.qcode[2 * q + 1];
        if (c0 < b0 || (c0 == b0 && (c1 < b1 || (c1 == b1 && q < bq)))) {
            b0 = c0;
            b1 = c1;
            bq = q;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const uint32_t c0 = __shfl_xor_sync(FULL, b0, o);
        const uint32_t c1 = __shfl_xor_sync(FULL, b1, o);
        const int q2 = __shfl_xor_sync(FULL, bq, o);
        if (c0 < b0 || (c0 == b0 && (c1 < b1 || (c1 == b1 && q2 < bq)))) {
            b0 = c0;
            b1 = c1;
            bq = q2;
        }
    }
    const QPick none = {-1, 0};
    if (bq == INT_MAX) return none;
    const uint32_t big = key_code(BIG);
    for (int l = 0; l < 2; ++l) {
        const uint32_t c = l == 0 ? b0 : b1;
        if (c == 0u) return none;
        if (c > big) {
            int n = 0;
            for (int q = lane; q < Q; q += 32)
                n += (v.entries[q] > 0 && (l == 0 || v.qcode[2 * q] == b0))
                    ? 1 : 0;
            if (warp_sum_i(n) < Q) return none;
        }
    }
    const QPick r = {bq, v.entries[bq]};
    return r;
}

// _lex_argmin over the jobs queued in qi, by the whole block in one pass
// over the key codes: the job or -1, in every thread. The block barrier
// inside orders every read of jq and jcode before any later write.
__device__ int job_pick(const View& v, int qi, int J, Ctl& S) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const uint4 none = make_uint4(~0u, ~0u, ~0u, ~0u);
    uint4 bc = none;
    int bj = INT_MAX;
    for (int j = tid; j < J; j += NT) {
        if (v.jq[j] != qi) continue;
        const uint4 c = v.jcode[j];
        if (code_less(c, j, bc, bj)) {
            bc = c;
            bj = j;
        }
    }
    warp_code_min(bc, bj);
    if (lane == 0) {
        S.wc[warp] = bc;
        S.wj[warp] = bj;
    }
    __syncthreads();
    bc = none;
    bj = INT_MAX;
    if (lane < NWARPS) {
        bc = S.wc[lane];
        bj = S.wj[lane];
    }
    warp_code_min(bc, bj);
    if (bj == INT_MAX) return -1;
    const uint32_t big = key_code(BIG);
    for (int l = 0; l < 4; ++l) {
        const uint32_t c = code_at(bc, l);
        if (c == 0u) return -1;
        if (c > big) {
            // the pass's minimum is BIG unless every job is a candidate
            // tied with the winner below level l
            int n = 0;
            for (int j = tid; j < J; j += NT)
                n += (v.jq[j] == qi && codes_tie_below(v.jcode[j], bc, l))
                    ? 1 : 0;
            if (block_sum(n, S) < J) return -1;
        }
    }
    return bj;
}

// A node candidate as one word whose maximum is jnp.argmax's pick: the
// masked score's code above (NaN above every value, -0.0 as +0.0), then
// the lowest index, then the node's fit flags. 0 is below every
// candidate. Node indices stay under 2^28 (launch_shape).
__device__ __forceinline__ unsigned long long node_key(float v, int i,
                                                      int flags) {
    const uint32_t hi = (v != v) ? 0xffffffffu : key_code(v);
    const uint32_t lo = ((uint32_t)(kMaxNodes - 1 - i) << 3)
        | (uint32_t)flags;
    return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ int node_of(unsigned long long key) {
    return kMaxNodes - 1 - (int)((uint32_t)key >> 3);
}

// the warp's maximum key, by halves with the warp's integer max reduction
__device__ __forceinline__ unsigned long long warp_max_u64(
        unsigned long long k) {
    const uint32_t hi = __reduce_max_sync(FULL, (uint32_t)(k >> 32));
    const uint32_t lo = __reduce_max_sync(
        FULL, (uint32_t)(k >> 32) == hi ? (uint32_t)k : 0u);
    return ((unsigned long long)hi << 32) | lo;
}

// A visit ended: the job's and its queue's replicas take what the visit
// changed, each by its own thread (thread 0 the job's allocation, ready
// count, cursor and the key codes that follow them; kQueueUpdater the
// queue's allocation and proportion share). Priority and rank stay.
__device__ __forceinline__ void flush_visit(
        const Params& p, const View& v, int j, int cpos, int cnt, int omin,
        float a0, float a1, float a2, int q, float b0, float b1, float b2,
        float ct0, float ct1, float ct2) {
    if (threadIdx.x == 0) {
        v.cur[j] = cpos;
        v.j_alloc[3 * j] = a0;
        v.j_alloc[3 * j + 1] = a1;
        v.j_alloc[3 * j + 2] = a2;
        v.alloc_cnt[j] = cnt;
        uint4 code = v.jcode[j];
        for (int k = 0; k < 3 && k < p.n_job_keys; ++k) {
            if (p.job_keys[k] == K_GANG_READY)
                set_code(code, k, key_code(cnt >= omin ? 1.0f : 0.0f));
            else if (p.job_keys[k] == K_DRF_SHARE)
                set_code(code, k, key_code(nanmax2(
                    nanmax2(share1(a0, ct0), share1(a1, ct1)),
                    share1(a2, ct2))));
        }
        v.jcode[j] = code;
    }
    if (threadIdx.x == kQueueUpdater) {
        float* qa = v.q_alloc + 3 * q;
        qa[0] = b0;
        qa[1] = b1;
        qa[2] = b2;
        if (p.use_prop_share)
            v.qcode[2 * q] = key_code(share3(qa, v.q_deserved + 3 * q));
    }
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// The fused allocate loop for one problem, run by every thread of its
// cluster. smem: this CTA's dynamic shared memory; ws: its global replica.
__device__ __forceinline__ void fused_body(const Params& p, const Layout& L,
                                           uint8_t* smem, uint8_t* ws,
                                           int c, bool timed) {
    cg::cluster_group cl = cg::this_cluster();
    Ctl& S = *reinterpret_cast<Ctl*>(smem);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int C = L.C;
    const int T = p.n_tasks_total, N = p.n_nodes, J = p.n_jobs,
              Q = p.n_queues;
    const int W = T + 1 + TELEM_WIDTH;
    const int base = min(c * L.P, N), cnt = min(L.P, N - base);
    const View v = make_view(p, L, smem, ws, base);
    // CTA 0's thread 0 sums the phases and counts the passes in Ctl
    const bool timer = timed && c == 0 && tid == 0;
    unsigned long long t_last = 0;
    if (timer) {
        for (int k = 0; k < (int)N_PHASES + (int)N_COUNTS; ++k) S.ph[k] = 0;
        t_last = now_ns();
    }
#define MARK(k)                                     \
    do {                                            \
        if (timer) {                                \
            const unsigned long long t_ = now_ns(); \
            S.ph[k] += t_ - t_last;                 \
            t_last = t_;                            \
        }                                           \
    } while (0)
#define COUNT(k, n)                                 \
    do {                                            \
        if (timer) S.ph[(int)N_PHASES + (k)] += (n);\
    } while (0)

    // ---- prologue: this CTA's nodes, its replicas, the task buckets -----
    if (L.res[G_CARRY]) {
        for (int k = tid; k < cnt; k += NT) {
            const int n = base + k;
            for (int r = 0; r < 3; ++r) {
                v.idle[3 * k + r] = p.idle[3 * n + r];
                v.rel[3 * k + r] = p.rel[3 * n + r];
            }
            v.nz[2 * k] = p.nz[2 * n];
            v.nz[2 * k + 1] = p.nz[2 * n + 1];
            v.nt[k] = p.n_tasks[n];
        }
    }
    if (L.res[G_NODEIN]) {
        float* back = (float*)v.back;
        float* acm = (float*)v.acm;
        int32_t* mtn = (int32_t*)v.mtn;
        uint8_t* ok = (uint8_t*)v.ok;
        for (int k = tid; k < cnt; k += NT) {
            const int n = base + k;
            for (int r = 0; r < 3; ++r) back[3 * k + r] = p.backfilled[3 * n + r];
            acm[2 * k] = p.alloc_cm[2 * n];
            acm[2 * k + 1] = p.alloc_cm[2 * n + 1];
            mtn[k] = p.max_task_num[n];
            ok[k] = p.node_ok[n];
        }
    }
    int lq = 0;
    for (int q = tid; q < Q; q += NT) {
        v.entries[q] = p.q_entries[q];
        for (int r = 0; r < 3; ++r) {
            v.q_alloc[3 * q + r] = p.q_alloc0[3 * q + r];
            v.q_deserved[3 * q + r] = p.q_deserved[3 * q + r];
        }
        queue_codes(p, v, q);
        lq += p.q_entries[q] > 0 ? 1 : 0;
    }
    for (int j = tid; j < J; j += NT) {
        v.jq[j] = p.job_valid[j] ? p.job_queue[j] : -1;
        v.alloc_cnt[j] = p.init_allocated[j];
        v.cur[j] = 0;
        for (int r = 0; r < 3; ++r) v.j_alloc[3 * j + r] = p.j_alloc0[3 * j + r];
        v.min_av[j] = p.min_available[j];
        v.omin[j] = p.order_min_available[j];
        v.jcode[j] = job_codes(p, v, j);
    }
    __syncthreads();
    // the valid tasks bucketed by job: count, scan, place, then each
    // bucket ordered by (rank, index), the task pick's order
    int vcount = 0;
    for (int i = tid; i < T; i += NT) {
        if (!p.task_valid[i]) continue;
        ++vcount;
        const int j = p.task_job[i];
        if (j >= 0 && j < J) atomicAdd(&v.cur[j], 1);
    }
    __syncthreads();
    block_scan_zero(v.cur, J, v.start, S);
    for (int i = tid; i < T; i += NT) {
        const int j = p.task_job[i];
        if (p.task_valid[i] && j >= 0 && j < J) {
            const int s = v.start[j] + atomicAdd(&v.cur[j], 1);
            v.tmp[s] = i;
            v.tmpr[s] = (float)p.task_rank[i];
        }
    }
    __syncthreads();
    const int bucketed = v.start[J];
    for (int s = tid; s < bucketed; s += NT) {
        const int i = v.tmp[s];
        const int j = p.task_job[i];
        const float rf = v.tmpr[s];
        const int b = v.start[j], e = v.start[j + 1];
        int pos = 0;
        for (int k = b; k < e; ++k) {
            const int i2 = v.tmp[k];
            const float r2 = v.tmpr[k];
            pos += (r2 < rf || (r2 == rf && i2 < i)) ? 1 : 0;
        }
        TaskRec r;
        r.t = i;
        r.sig = p.task_sig[i];
        r.q0 = p.init_resreq[3 * i];
        r.q1 = p.init_resreq[3 * i + 1];
        r.q2 = p.init_resreq[3 * i + 2];
        r.n0 = p.task_nz[2 * i];
        r.n1 = p.task_nz[2 * i + 1];
        r.r0 = p.resreq[3 * i];
        r.r1 = p.resreq[3 * i + 1];
        r.r2 = p.resreq[3 * i + 2];
        r.pad0 = r.pad1 = 0;
        v.rec[b + pos] = r;
    }
    for (int j = tid; j < J; j += NT) v.cur[j] = v.start[j];
    if (c == 0) {
        if (tid == kWriter) {
            S.f_bound = 0;
            S.f_failed = 0;
            for (int s = 0; s < WAVE_SLOTS; ++s) S.f_wave[s] = 0;
        }
        for (int i = tid; i < T; i += NT) {
            p.host_block[i] = SKIP;
            p.host_block[W + i] = -1;
            p.host_block[2 * W + i] = INT32_MAX;
        }
    }
    const int census = block_sum(vcount, S);
    int live = block_sum(lq, S);
    if (C > 1) cl.sync();             // every CTA of the cluster has started
    MARK(PH_PROLOGUE);

    // ---- the while loop: one placement (or one run of skips) a pass -----
    int current = -1, seq = 0, it = 0, xc = 0;
    // the visited job's cursor and end in its bucket, its ready count,
    // min_available and order_min_available, its queue, and its and its
    // queue's allocations, alike in every thread: the replicas take them
    // when the visit ends (no selection reads them before the next pop)
    int cpos = 0, cend = 0, ccnt = 0, cmin = 0, comin = 0, cq = 0;
    float ja0 = 0.0f, ja1 = 0.0f, ja2 = 0.0f, qa0 = 0.0f, qa1 = 0.0f,
          qa2 = 0.0f;
    // CTA 0's writer thread writes the decisions and counts the frame
    const bool writer = c == 0 && tid == kWriter;
    const int stride = p.max_iters > 1 ? p.max_iters : 1;
    const float e0 = p.eps[0], e1 = p.eps[1], e2 = p.eps[2];
    const float w0 = p.dyn_weights[0], w1 = p.dyn_weights[1];
    const float ct0 = p.cluster_total[0], ct1 = p.cluster_total[1],
                ct2 = p.cluster_total[2];
    // the visit's next record and its cells at this thread's first two
    // nodes, loaded one solve ahead (used when the next pass resumes it)
    TaskRec nx = {};
    float nx_sc0 = 0.0f, nx_sc1 = 0.0f;
    uint8_t nx_pr0 = 0, nx_pr1 = 0;
    for (;;) {
        if (!(it < p.max_iters && (live > 0 || current >= 0))) break;
        COUNT(CT_PASSES, 1);
        int jstar = current;
        if (current < 0) {
            __syncthreads();          // thread 0's earlier writes are seen
            const QPick qp = queue_pick(v, Q);
            if (qp.q < 0) {
                // no queue to pop: nothing changes until max_iters
                COUNT(CT_RUNS, 1);
                COUNT(CT_RUN_ITERS, p.max_iters - it);
                it = p.max_iters;
                MARK(PH_TOP);
                continue;
            }
            const int qi = qp.q;
            bool overused = false;
            if (p.prop_overused) {
                overused = true;
                for (int r = 0; r < 3; ++r)
                    overused = overused && (v.q_deserved[3 * qi + r]
                                            < v.q_alloc[3 * qi + r] + p.eps[r]);
            }
            MARK(PH_TOP);
            const int j_sel = overused ? -1 : job_pick(v, qi, J, S);
            MARK(PH_JOB);
            if (j_sel < 0) {
                // the popped queue is overused or has no job: this pop
                // and the k - 1 that would repeat it consume k entries
                const int k = min(qp.eq, p.max_iters - it);
                it += k;
                if (qp.eq == k) live -= 1;
                COUNT(CT_RUNS, 1);
                COUNT(CT_RUN_ITERS, k);
                __syncthreads();      // every thread has read entries
                if (tid == 0) v.entries[qi] = qp.eq - k;
                MARK(PH_TOP);
                continue;
            }
            jstar = j_sel;
            cpos = v.cur[jstar];
            cend = v.start[jstar + 1];
            ccnt = v.alloc_cnt[jstar];
            cmin = v.min_av[jstar];
            comin = v.omin[jstar];
            cq = qi;                  // the job's queue: it was queued there
            ja0 = v.j_alloc[3 * jstar];
            ja1 = v.j_alloc[3 * jstar + 1];
            ja2 = v.j_alloc[3 * jstar + 2];
            qa0 = v.q_alloc[3 * cq];
            qa1 = v.q_alloc[3 * cq + 1];
            qa2 = v.q_alloc[3 * cq + 2];
        }

        // task pick: the first pending task of the job's ordered bucket
        const bool resumed = current >= 0;
        TaskRec R = nx;
        if (!resumed && cpos < cend) R = v.rec[cpos];
        const int tstar = cpos < cend ? R.t : -1;
        if (tstar < 0) {
            // no pending task left: the job leaves its queue
            if (tid == 0) v.jq[jstar] = -1;
            if (resumed)
                flush_visit(p, v, jstar, cpos, ccnt, comin, ja0, ja1, ja2,
                            cq, qa0, qa1, qa2, ct0, ct1, ct2);
            current = -1;
            it += 1;
            MARK(PH_TASK);
            continue;
        }
        const float q0 = R.q0, q1 = R.q1, q2 = R.q2;
        const float tn0 = R.n0, tn1 = R.n1;
        const float* srow = p.sig_scores + (size_t)R.sig * N + base;
        const uint8_t* prow = p.sig_pred + (size_t)R.sig * N + base;
        const bool more = cpos + 1 < cend;
        if (more) nx = v.rec[cpos + 1];
        MARK(PH_TASK);

        // node pass over this CTA's nodes: predicate, fit, score
        unsigned long long best_key = 0;
#pragma unroll 2
        for (int u = 0, k = tid; k < cnt; ++u, k += NT) {
            const bool ahead = resumed && u < 2;
            const float sc = ahead ? (u == 0 ? nx_sc0 : nx_sc1) : srow[k];
            const uint8_t pr = ahead ? (u == 0 ? nx_pr0 : nx_pr1) : prow[k];
            const float i0 = v.idle[3 * k], i1 = v.idle[3 * k + 1],
                        i2 = v.idle[3 * k + 2];
            const float a0 = i0 + v.back[3 * k], a1 = i1 + v.back[3 * k + 1],
                        a2 = i2 + v.back[3 * k + 2];
            const bool fit_alloc = q0 <= a0 + e0 && q1 <= a1 + e1
                && q2 <= a2 + e2;
            const bool fit_idle = q0 <= i0 + e0 && q1 <= i1 + e1
                && q2 <= i2 + e2;
            const bool fit_pipe = q0 <= v.rel[3 * k] + e0
                && q1 <= v.rel[3 * k + 1] + e1 && q2 <= v.rel[3 * k + 2] + e2;
            const bool pred = v.ok[k] && v.nt[k] < v.mtn[k] && pr;
            const bool eligible = pred && (fit_alloc || fit_pipe);
            float score = sc;
            if (p.dyn_enabled) {
                score = score + kb::dynamic_node_score(
                    v.nz[2 * k], v.nz[2 * k + 1], tn0, tn1, v.acm[2 * k],
                    v.acm[2 * k + 1], w0, w1);
            }
            const float m = eligible ? score : -INFINITY;
            const unsigned long long key = node_key(
                m, base + k, (eligible ? kEligible : 0)
                    | (fit_alloc ? kFitAlloc : 0) | (fit_idle ? kFitIdle : 0));
            best_key = key > best_key ? key : best_key;
        }
        best_key = warp_max_u64(best_key);
        if (lane == 0) S.wk[warp] = best_key;
        __syncthreads();
        const int par = xc & 1;
        if (warp == 0) {
            best_key = warp_max_u64(lane < NWARPS ? S.wk[lane] : 0ull);
            if (lane == 0) S.slot[par] = best_key;
        }
        MARK(PH_NODE);
        // the one exchange of the solve: slot par is rewritten two solves
        // on, after every CTA has passed the next barrier
        if (C > 1) cl.sync();
        else __syncthreads();
        best_key = 0;
        if (lane < C)
            best_key = C > 1 ? *cl.map_shared_rank(&S.slot[par], lane)
                             : S.slot[par];
        best_key = warp_max_u64(best_key);
        ++xc;
        // the next record has landed: its cells at this thread's first
        // two nodes
        if (more) {
            const float* nrow = p.sig_scores + (size_t)nx.sig * N + base;
            const uint8_t* npred = p.sig_pred + (size_t)nx.sig * N + base;
            if (tid < cnt) {
                nx_sc0 = nrow[tid];
                nx_pr0 = npred[tid];
            }
            if (tid + NT < cnt) {
                nx_sc1 = nrow[tid + NT];
                nx_pr1 = npred[tid + NT];
            }
        }
        COUNT(CT_SOLVES, 1);
        MARK(PH_EXCHANGE);

        // the decision and its updates
        const int best = node_of(best_key);
        const int bf = (int)(best_key & 7);
        const bool eligible = (bf & kEligible) != 0;
        const bool is_alloc = (bf & kFitAlloc) != 0;
        const bool over_backfill = is_alloc && !(bf & kFitIdle);
        bool visit_ends = true;
        if (eligible) {
            if (!over_backfill) ccnt += 1;
            visit_ends = p.gang_enabled ? (ccnt >= cmin) : true;
        }
        cpos += 1;
        const float t_req[3] = {R.r0, R.r1, R.r2};
        if (eligible) {
            ja0 = ja0 + t_req[0];
            ja1 = ja1 + t_req[1];
            ja2 = ja2 + t_req[2];
            qa0 = qa0 + t_req[0];
            qa1 = qa1 + t_req[1];
            qa2 = qa2 + t_req[2];
        } else if (tid == 0) {
            v.jq[jstar] = -1;            // job dropped this cycle
        }
        if (visit_ends)
            flush_visit(p, v, jstar, cpos, ccnt, comin, ja0, ja1, ja2, cq,
                        qa0, qa1, qa2, ct0, ct1, ct2);
        if (writer) {
            int32_t* hb = p.host_block;
            if (eligible) {
                hb[tstar] = !is_alloc ? PIPELINE
                          : (over_backfill ? ALLOC_OB : ALLOC);
                hb[W + tstar] = best;
                hb[2 * W + tstar] = seq;
                S.f_bound += 1;
                int slot = seq / stride;
                slot = slot < 0 ? 0 : (slot > WAVE_SLOTS - 1 ? WAVE_SLOTS - 1
                                                             : slot);
                S.f_wave[slot] += 1;
            } else {
                hb[tstar] = FAIL;
                hb[2 * W + tstar] = seq;
                S.f_failed += 1;
            }
        }
        if (eligible) {
            const int k = best - base;
            if (k >= 0 && k < cnt && k % NT == tid) {
                float* pool = is_alloc ? v.idle : v.rel;
                for (int r = 0; r < 3; ++r)
                    pool[3 * k + r] = pool[3 * k + r] - t_req[r];
                v.nt[k] += 1;
                v.nz[2 * k] = v.nz[2 * k] + tn0;
                v.nz[2 * k + 1] = v.nz[2 * k + 1] + tn1;
            }
        }
        seq += 1;
        it += 1;
        current = visit_ends ? -1 : jstar;
        MARK(PH_UPDATE);
    }

    // ---- epilogue: the carries and decision_frame into the host block ----
    if (C > 1) cl.sync();             // no CTA leaves while its slots are read
    if (L.res[G_CARRY]) {
        for (int k = tid; k < cnt; k += NT) {
            const int n = base + k;
            for (int r = 0; r < 3; ++r) {
                p.idle[3 * n + r] = v.idle[3 * k + r];
                p.rel[3 * n + r] = v.rel[3 * k + r];
            }
            p.nz[2 * n] = v.nz[2 * k];
            p.nz[2 * n + 1] = v.nz[2 * k + 1];
            p.n_tasks[n] = v.nt[k];
        }
    }
    if (writer) {
        for (int row = 0; row < 3; ++row) {
            for (int col = 0; col < 1 + TELEM_WIDTH; ++col) {
                int val = 0;
                if (col == 0) {
                    val = it;                        // iteration count
                } else {
                    const int f = col - 1;           // telemetry field
                    if (f == 0) val = ENGINE_FUSED;
                    else if (f == 1) val = it;
                    else if (f == 2) val = S.f_bound;
                    else if (f == 3) val = S.f_failed;
                    else if (f == 4) val = census - S.f_bound - S.f_failed;
                    else if (f == 5) val = census;
                    else if (f >= 6 && f < 6 + WAVE_SLOTS)
                        val = S.f_wave[f - 6];
                    else if (f == 12) val = p.narrow ? 1 : 0;
                    else if (f == 13) val = p.narrow_gate ? 1 : 0;
                }
                p.host_block[row * W + T + col] = val;
            }
        }
    }
    MARK(PH_EPILOGUE);
#undef MARK
#undef COUNT
    if (timer)
        for (int k = 0; k < (int)N_PHASES + (int)N_COUNTS; ++k)
            p.phase_ns[k] = S.ph[k];
}

// Lane b's Params in a stack of B problems of one shape: every per-problem
// array (inputs, node carries, host block) is laid out [B, ...]
// contiguous, so lane b's view is lane 0's pointer plus b times the
// lane's size; eps is shared. S is the sig rows of one lane. The
// replicas are placed by the caller.
__device__ __forceinline__ Params lane_params(Params p, int b, int S) {
    const size_t N = p.n_nodes, T = p.n_tasks_total, J = p.n_jobs,
                 Q = p.n_queues;
    const size_t B = (size_t)b;
    p.idle += B * 3 * N;
    p.rel += B * 3 * N;
    p.n_tasks += B * N;
    p.nz += B * 2 * N;
    p.backfilled += B * 3 * N;
    p.alloc_cm += B * 2 * N;
    p.max_task_num += B * N;
    p.node_ok += B * N;
    p.resreq += B * 3 * T;
    p.init_resreq += B * 3 * T;
    p.task_nz += B * 2 * T;
    p.task_job += B * T;
    p.task_rank += B * T;
    p.task_sig += B * T;
    p.task_valid += B * T;
    p.sig_scores += B * (size_t)S * N;
    p.sig_pred += B * (size_t)S * N;
    p.min_available += B * J;
    p.order_min_available += B * J;
    p.init_allocated += B * J;
    p.job_queue += B * J;
    p.job_priority += B * J;
    p.job_create_rank += B * J;
    p.job_valid += B * J;
    p.q_entries += B * Q;
    p.q_create_rank += B * Q;
    p.q_deserved += B * 3 * Q;
    p.q_alloc0 += B * 3 * Q;
    p.j_alloc0 += B * 3 * J;
    p.cluster_total += B * 3;
    p.dyn_weights += B * 2;
    p.host_block += B * 3 * (T + 1 + TELEM_WIDTH);
    return p;
}

// Params from the C entry points' arguments.
inline Params make_params(
        void* idle, void* rel, void* n_tasks, void* nz,
        const void* backfilled, const void* alloc_cm,
        const void* max_task_num, const void* node_ok,
        const void* resreq, const void* init_resreq, const void* task_nz,
        const void* task_job, const void* task_rank, const void* task_sig,
        const void* task_valid, const void* sig_scores, const void* sig_pred,
        const void* min_available, const void* order_min_available,
        const void* init_allocated, const void* job_queue,
        const void* job_priority, const void* job_create_rank,
        const void* job_valid, const void* q_entries,
        const void* q_create_rank, const void* q_deserved,
        const void* q_alloc0, const void* j_alloc0,
        const void* cluster_total, const void* dyn_weights,
        const void* eps, void* ws, void* phase_ns, void* host_block,
        int n_nodes, int n_tasks_total, int n_jobs, int n_queues,
        int job_key0, int job_key1, int job_key2, int n_job_keys,
        int use_prop_share, int gang_enabled, int prop_overused,
        int dyn_enabled, int max_iters, int narrow, int narrow_gate) {
    Params p;
    p.idle = (float*)idle;
    p.rel = (float*)rel;
    p.n_tasks = (int32_t*)n_tasks;
    p.nz = (float*)nz;
    p.backfilled = (const float*)backfilled;
    p.alloc_cm = (const float*)alloc_cm;
    p.max_task_num = (const int32_t*)max_task_num;
    p.node_ok = (const uint8_t*)node_ok;
    p.resreq = (const float*)resreq;
    p.init_resreq = (const float*)init_resreq;
    p.task_nz = (const float*)task_nz;
    p.task_job = (const int32_t*)task_job;
    p.task_rank = (const int32_t*)task_rank;
    p.task_sig = (const int32_t*)task_sig;
    p.task_valid = (const uint8_t*)task_valid;
    p.sig_scores = (const float*)sig_scores;
    p.sig_pred = (const uint8_t*)sig_pred;
    p.min_available = (const int32_t*)min_available;
    p.order_min_available = (const int32_t*)order_min_available;
    p.init_allocated = (const int32_t*)init_allocated;
    p.job_queue = (const int32_t*)job_queue;
    p.job_priority = (const float*)job_priority;
    p.job_create_rank = (const int32_t*)job_create_rank;
    p.job_valid = (const uint8_t*)job_valid;
    p.q_entries = (const int32_t*)q_entries;
    p.q_create_rank = (const int32_t*)q_create_rank;
    p.q_deserved = (const float*)q_deserved;
    p.q_alloc0 = (const float*)q_alloc0;
    p.j_alloc0 = (const float*)j_alloc0;
    p.cluster_total = (const float*)cluster_total;
    p.dyn_weights = (const float*)dyn_weights;
    p.eps = (const float*)eps;
    p.ws = (uint8_t*)ws;
    p.phase_ns = (unsigned long long*)phase_ns;
    p.host_block = (int32_t*)host_block;
    p.n_nodes = n_nodes;
    p.n_tasks_total = n_tasks_total;
    p.n_jobs = n_jobs;
    p.n_queues = n_queues;
    p.job_keys[0] = job_key0;
    p.job_keys[1] = job_key1;
    p.job_keys[2] = job_key2;
    p.n_job_keys = n_job_keys;
    p.use_prop_share = use_prop_share;
    p.gang_enabled = gang_enabled;
    p.prop_overused = prop_overused;
    p.dyn_enabled = dyn_enabled;
    p.max_iters = max_iters;
    p.narrow = narrow;
    p.narrow_gate = narrow_gate;
    return p;
}

// The launch shape of `lanes` problems of n nodes, t tasks, j jobs and q
// queues on `kernel`, a cluster of `cluster` CTAs each (0: chosen here),
// written into info[11]: C, nodes a CTA owns, the five groups' residency
// (1 = shared memory), dynamic shared bytes, global replica bytes of one
// problem, clusters the card keeps resident at this shape, and waves
// (both 0 unless `query`). For more than one lane with no cluster given,
// C is the largest power of two up to the single problem's whose `lanes`
// clusters are all resident at once (1 when none is).
template <typename K>
inline cudaError_t launch_shape(K kernel, int n, int t, int j, int q,
                                int lanes, int cluster, bool query,
                                Layout* out, int* info) {
    if (n < 1 || n > kMaxNodes || t < 0 || j < 0 || q < 0 || lanes < 1
        || cluster < 0
        || cluster > kMaxCluster || (cluster & (cluster - 1)) != 0)
        return cudaErrorInvalidValue;
    static bool attr_set = false;
    cudaError_t err;
    if (!attr_set) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (err != cudaSuccess) return err;
        // clusters of 16 CTAs are past the portable size of 8
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (err != cudaSuccess) return err;
        attr_set = true;
    }
    auto resident = [&](const Layout& L, int* num) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)(L.C * lanes));
        cfg.blockDim = dim3(NT);
        cfg.dynamicSmemBytes = (size_t)L.smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = (unsigned)L.C;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        return cudaOccupancyMaxActiveClusters(num, (void*)kernel, &cfg);
    };
    int C = cluster;
    Layout L = {};
    int num = 0;
    if (C == 0 && lanes > 1) {
        for (C = auto_cluster(n); C >= 1; C /= 2) {
            L = make_layout(n, t, j, q, C);
            if ((err = resident(L, &num)) != cudaSuccess) return err;
            if (num >= lanes || C == 1) break;
        }
    } else {
        if (C == 0) C = auto_cluster(n);
        L = make_layout(n, t, j, q, C);
        if (query && (err = resident(L, &num)) != cudaSuccess) return err;
    }
    const long long ws = L.ws_cta * L.C;
    if (ws > INT_MAX || (query && num < 1))
        return cudaErrorInvalidConfiguration;
    *out = L;
    info[0] = L.C;
    info[1] = L.P;
    for (int g = 0; g < N_GROUPS; ++g) info[2 + g] = L.res[g];
    info[7] = L.smem;
    info[8] = (int)ws;
    info[9] = num;
    info[10] = num > 0 ? (lanes + num - 1) / num : 0;
    return cudaSuccess;
}

// Launch `lanes` clusters of L.C CTAs of `kernel` on the stream.
template <typename K>
inline cudaError_t launch_clusters(K kernel, const Params& p, const Layout& L,
                                   int lanes, int n_sigs,
                                   cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(L.C * lanes));
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = (size_t)L.smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)L.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, L, n_sigs);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
