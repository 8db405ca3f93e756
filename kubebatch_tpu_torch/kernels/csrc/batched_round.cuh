// The batched round engine's device code: parameters, workspace layout,
// the round phases, the stranded-gang epilogue and the telemetry frame.
// Shared by the batched allocate kernel (batched_allocate.cu, whose
// header comment gives the design) and the two-level / active-set
// kernel (hier_allocate.cu), which runs the same rounds with the node
// window (``NS``, ``noff`` and offset node pointers in Params) set to
// one node pool, ``elsewhere`` marking the tasks eligible in another
// pool and, for the active set, ``pair_init``: each pair's request row.
#pragma once

#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"
#include "seg_scan.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;                    // threads per block
constexpr int SMEM_KEYS = 16384;           // sort keys held in shared memory
constexpr int IMAX = 2147483647;
constexpr int TELEM_WIDTH = 20;
constexpr int WAVE_SLOTS = 4;
constexpr int ENGINE_BATCHED = 2;
constexpr float WINDOW_SLACK = 0.85f;
constexpr uint64_t NONE = ~0ull;           // sorts after every real key
constexpr unsigned FULL = 0xffffffffu;

enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };
enum { K_PRIORITY = 0, K_GANG_READY = 1, K_DRF_SHARE = 2 };

// ---- arguments -------------------------------------------------------------

// pointer slots, in the order the wrapper passes them
enum {
    P_IDLE, P_REL, P_NTASKS, P_NZ, P_BF, P_CAP, P_MAXT, P_NODE_OK,
    P_RESREQ, P_INIT, P_TNZ, P_TJOB, P_TRANK, P_TSIG, P_TPAIR, P_TVALID,
    P_SIG_SCORES, P_SIG_PRED, P_PAIR_SIG, P_PAIR_NZ, P_OMIN, P_INIT_ALLOC,
    P_JQUEUE, P_JPRIO, P_JCRANK, P_JVALID, P_QDES, P_QCRANK, P_QALLOC0,
    P_JALLOC0, P_CTOTAL, P_DYNW, P_EPS, P_OUT, P_PHASE,
    // affinity (null without the vocabulary; ports / weight null without
    // ports / an interpod score)
    P_NODE_DOM, P_TGRP, P_TREQ_AFF, P_TREQ_ANTI, P_TSELF_OK, P_TCARRY_W,
    P_TPREF_W, P_GCNT0, P_ACNT0, P_PREFW0, P_GTOT0, P_TPORTS, P_PORT_BASE,
    P_IPW, P_GCNT_OUT, P_ACNT_OUT, P_PREFW_OUT, P_GTOT_OUT, P_PCLAIM_OUT,
    P_WS, N_PTRS
};
// int slots
enum {
    I_N, I_T, I_J, I_Q, I_P, I_NJK, I_JK0, I_JK1, I_JK2, I_QSHARE,
    I_PROP_OVERUSED, I_DYN, I_PIPE, I_MAX_ROUNDS, I_BUCKET, I_GANG,
    I_NARROW, I_NARROW_GATE, I_AFF, I_A, I_D, I_PT, I_IP, N_INTS
};

struct Params {
    float* idle; float* rel; int32_t* ntasks; float* nz;
    const float* bf; const float* cap; const int32_t* maxt;
    const uint8_t* node_ok;
    const float* resreq; const float* init; const float* tnz;
    const int32_t* tjob; const int32_t* trank; const int32_t* tsig;
    const int32_t* tpair; const uint8_t* tvalid;
    const float* sig_scores; const uint8_t* sig_pred;
    const int32_t* pair_sig; const float* pair_nz;
    const int32_t* omin; const int32_t* init_alloc; const int32_t* jqueue;
    const float* jprio; const int32_t* jcrank; const uint8_t* jvalid;
    const float* qdes; const int32_t* qcrank; const float* qalloc0;
    const float* jalloc0; const float* ctotal; const float* dynw;
    const float* eps;
    int32_t* out;
    unsigned long long* phase_ns;          // [N_PHASES] device ns per phase
    int N, T, J, Q, P, njk, jk[3], qshare, prop_overused, dyn, pipe,
        max_rounds, bucket, gang, narrow, narrow_gate;
    int MT, MJ, MN;                        // sort sizes (powers of two)
    // the node window: the node pointers above may be offset to a pool
    // of N nodes; NS is the row stride of sig_scores / sig_pred (the
    // full node axis) and noff the pool's first global node, added to
    // the nodes written to the packed result
    int NS, noff;
    const uint8_t* elsewhere;              // [T] eligible in another pool
    const float* pair_init;                // [P,3] pair request rows
    // the dynamic score's weighted sum as one FMA (the two-level graphs,
    // kernels/xla_order.py WEIGHTED_SUM_FMA), else both products rounded
    int dyn_fma;
    // affinity: aff on/off, A pairs, D domain slots, PT ports (0: none),
    // ip (an interpod score)
    int aff, A, D, PT, ip;
    const int32_t* node_dom;               // [A,N]
    const uint8_t* tgrp; const uint8_t* treq; const uint8_t* tanti;
    const uint8_t* tself;                  // [T,A] bool
    const float* tcarry; const float* tpref;   // [T,A]
    const float* gcnt0; const float* acnt0; const float* prefw0;  // [A,D]
    const float* gtot0;                    // [A]
    const uint8_t* tports; const uint8_t* pbase;  // [T,PT], [N,PT]
    const float* ipw;                      // [] pod_aff weight
    float* gcnt_out; float* acnt_out; float* prefw_out; float* gtot_out;
    uint8_t* pclaim_out;                   // [N,PT]
};

// scratch, carved from one workspace (layout() below)
struct Work {
    // job / queue
    float* q_alloc; float* j_alloc; int32_t* alloc_cnt; uint8_t* alive;
    uint8_t* overused; float* q_share; float* jkey; int32_t* jidx;
    int32_t* job_order; int32_t* job_rank; float* job_demand;
    uint8_t* eng_job; float* norm; float* norm_ord; float* cum_j;
    uint8_t* q_ok; uint8_t* admitted; float* qn; int32_t* qperm;
    int32_t* qj; int32_t* fail_rank; uint8_t* stranded; int32_t* j_rows;
    int32_t* j_placed; int32_t* j_ob;
    // node
    float* accp; float* relp; uint8_t* basep; float* col_in; float* col_a;
    float* col_b; int32_t* ord_sh; float* cm_in; float* cum_mass;
    float* cnt_in; float* cum_cnt;
    // pair
    float* sc; int32_t* pair_demand;
    // task (the current task view)
    int32_t* tmap; uint8_t* vvalid; uint8_t* engaged; uint8_t* part;
    uint8_t* any_elig; uint8_t* fail_now; uint8_t* fail_first;
    uint8_t* part2; uint8_t* acc1; uint8_t* ob1; uint8_t* pa1;
    uint8_t* retry; uint8_t* accr; uint8_t* obr; uint8_t* par;
    uint8_t* accept; uint8_t* mask; uint8_t* unresolved;
    int32_t* grank; int32_t* order; int32_t* fb; int32_t* fbr;
    int32_t* prop1; int32_t* perm2; int32_t* nid; int32_t* chunk;
    float* prefix; float* cnt_prefix; float* mass_in; float* mass_cum;
    float* cnt_in_t; float* cnt_cum_t;
    // segmented associative scan: levels of elements, then of results
    float* sv; int32_t* scnt; uint8_t* sflag;
    float* rv; int32_t* rcnt; uint8_t* rflag;
    float* tscr;                           // tiled-cumsum level scratch
    uint64_t* gkeys;                       // sort keys past SMEM_KEYS
    int32_t* iscal; float* fscal;
    // affinity: the int32 carry, packed task / node words, per-round
    // views and flags, the serialization minima, the score's per-row
    // normalisation
    int32_t* gcnt; int32_t* acnt; int32_t* prefw; int32_t* gtot;
    uint64_t* pclaim;                      // [N]
    uint64_t* mgrp; uint64_t* mreq; uint64_t* manti; uint64_t* mself;
    uint64_t* mpref; uint64_t* mcarry;     // [T*2]
    uint64_t* mports;                      // [T]
    uint64_t* pbase;                       // [N]
    uint64_t* present; uint64_t* symv;     // [N*2]
    uint64_t* used;                        // [N]
    float* gview; float* pview;            // [A*N]
    uint64_t* fl;                          // [F_N*2] pair flag words
    int32_t* gpend;                        // [A] pending members
    int32_t* cmin; int32_t* mmin;          // [A*(D+1)]
    int32_t* bmin; int32_t* bdom;          // [A]
    int32_t* pmin;                         // [N+1]
    float* ip_cmin; float* ip_span;        // [T]
    uint8_t* ip_scored;                    // [T]
};

// pair flag words (two 64-bit words each)
enum { F_BOOT, F_SAT, F_CARRIER, F_PREF, F_N };

enum { S_PROGRESS, S_MAJ, S_CNT, S_ANY_STRANDED, S_STRANDED, S_TCUR,
       S_NSCAL };

// phases timed between grid barriers (kernels/batched.py PHASES names
// them in this order): the interval that ends at each barrier is added
// to the phase the barrier closes
enum { PH_SETUP, PH_ORDER, PH_ENGAGE, PH_WINDOW, PH_SCORES, PH_ROWS1,
       PH_FAIL, PH_PART2, PH_WATERFALL, PH_PROPOSE, PH_FIT1, PH_ACCEPT1,
       PH_VIEWS2, PH_ROWS2, PH_RETRY, PH_FIT2, PH_ACCEPT2, PH_COMPACT,
       PH_EPILOGUE, PH_AFF_VIEWS, PH_AFF_SERIALIZE, PH_AFF_COMMIT,
       N_PHASES };

inline size_t align_up(size_t x) {
    return (x + 255) & ~size_t(255);
}

__host__ __device__ inline int pow2_at_least(int n) {
    int m = 1;
    while (m < n) m <<= 1;
    return m;
}

// Carve the workspace (base may be null: returns the size).
inline size_t layout(const Params& p, char* base, Work* w) {
    size_t off = 0;
    auto take = [&](size_t bytes) -> char* {
        char* ptr = base ? base + off : nullptr;
        off = align_up(off + (bytes ? bytes : 1));
        return ptr;
    };
    const size_t N = p.N, T = p.T, J = p.J, Q = p.Q, P = p.P;
    const size_t TJ = std::max(T, J);
    const size_t lv = 2 * TJ + 64;         // associative-scan levels
    Work x;
    x.q_alloc = (float*)take(Q * 3 * 4);
    x.j_alloc = (float*)take(J * 3 * 4);
    x.alloc_cnt = (int32_t*)take(J * 4);
    x.alive = (uint8_t*)take(J);
    x.overused = (uint8_t*)take(Q);
    x.q_share = (float*)take(Q * 4);
    x.jkey = (float*)take(J * 6 * 4);
    x.jidx = (int32_t*)take(p.MJ * 4);
    x.job_order = (int32_t*)take(J * 4);
    x.job_rank = (int32_t*)take(J * 4);
    x.job_demand = (float*)take(J * 3 * 4);
    x.eng_job = (uint8_t*)take(J);
    x.norm = (float*)take(J * 4);
    x.norm_ord = (float*)take(J * 4);
    x.cum_j = (float*)take(J * 4);
    x.q_ok = (uint8_t*)take(J);
    x.admitted = (uint8_t*)take(J);
    x.qn = (float*)take(J * 4);
    x.qperm = (int32_t*)take(J * 4);
    x.qj = (int32_t*)take(J * 4);
    x.fail_rank = (int32_t*)take(J * 4);
    x.stranded = (uint8_t*)take(J);
    x.j_rows = (int32_t*)take(J * 4);
    x.j_placed = (int32_t*)take(J * 4);
    x.j_ob = (int32_t*)take(J * 4);
    x.accp = (float*)take(N * 3 * 4);
    x.relp = (float*)take(N * 3 * 4);
    x.basep = (uint8_t*)take(N);
    x.col_in = (float*)take(N * 3 * 4);
    x.col_a = (float*)take((N / 32 + 2) * 3 * 4);
    x.col_b = (float*)take((N / 32 + 2) * 3 * 4);
    x.ord_sh = (int32_t*)take(N * 4);
    x.cm_in = (float*)take(N * 3 * 4);
    x.cum_mass = (float*)take(N * 3 * 4);
    x.cnt_in = (float*)take(N * 4);
    x.cum_cnt = (float*)take(N * 4);
    x.sc = (float*)take(P * N * 4);
    x.pair_demand = (int32_t*)take(P * 4);
    x.tmap = (int32_t*)take(T * 4);
    uint8_t** flags[] = {&x.vvalid, &x.engaged, &x.part, &x.any_elig,
                         &x.fail_now, &x.fail_first, &x.part2, &x.acc1,
                         &x.ob1, &x.pa1, &x.retry, &x.accr, &x.obr, &x.par,
                         &x.accept, &x.mask, &x.unresolved};
    for (uint8_t** f : flags) *f = (uint8_t*)take(T);
    int32_t** ints[] = {&x.grank, &x.order, &x.fb, &x.fbr, &x.prop1,
                        &x.perm2, &x.nid};
    for (int32_t** f : ints) *f = (int32_t*)take(T * 4);
    x.chunk = (int32_t*)take((NT + 1) * 4);
    x.prefix = (float*)take(T * 3 * 4);
    x.cnt_prefix = (float*)take(T * 4);
    x.mass_in = (float*)take(T * 3 * 4);
    x.mass_cum = (float*)take(T * 3 * 4);
    x.cnt_in_t = (float*)take(T * 4);
    x.cnt_cum_t = (float*)take(T * 4);
    x.sv = (float*)take(lv * 6 * 4);
    x.scnt = (int32_t*)take(lv * 4);
    x.sflag = (uint8_t*)take(lv);
    x.rv = (float*)take(lv * 6 * 4);
    x.rcnt = (int32_t*)take(lv * 4);
    x.rflag = (uint8_t*)take(lv);
    x.tscr = (float*)take((TJ + N) * 3 * 4);
    x.gkeys = (uint64_t*)take((size_t)std::max(p.MT, std::max(p.MJ, p.MN))
                              * 8);
    x.iscal = (int32_t*)take(S_NSCAL * 4);
    x.fscal = (float*)take(8 * 4);
    // affinity (zero-sized without the vocabulary)
    const size_t A = p.aff ? p.A : 0, D = p.aff ? p.D : 0;
    const size_t TA = p.aff ? T : 0, NA = p.aff ? N : 0;
    x.gcnt = (int32_t*)take(A * D * 4);
    x.acnt = (int32_t*)take(A * D * 4);
    x.prefw = (int32_t*)take(A * D * 4);
    x.gtot = (int32_t*)take(A * 4);
    x.pclaim = (uint64_t*)take(NA * 8);
    uint64_t** tw[] = {&x.mgrp, &x.mreq, &x.manti, &x.mself, &x.mpref,
                       &x.mcarry};
    for (uint64_t** f : tw) *f = (uint64_t*)take(TA * 2 * 8);
    x.mports = (uint64_t*)take(TA * 8);
    x.pbase = (uint64_t*)take(NA * 8);
    x.present = (uint64_t*)take(NA * 2 * 8);
    x.symv = (uint64_t*)take(NA * 2 * 8);
    x.used = (uint64_t*)take(NA * 8);
    x.gview = (float*)take((p.aff && p.ip ? A * N : 0) * 4);
    x.pview = (float*)take((p.aff && p.ip ? A * N : 0) * 4);
    x.fl = (uint64_t*)take(F_N * 2 * 8);
    x.gpend = (int32_t*)take(A * 4);
    x.cmin = (int32_t*)take(A * (D + 1) * 4);
    x.mmin = (int32_t*)take(A * (D + 1) * 4);
    x.bmin = (int32_t*)take(A * 4);
    x.bdom = (int32_t*)take(A * 4);
    x.pmin = (int32_t*)take((NA + 1) * 4);
    x.ip_cmin = (float*)take(TA * 4);
    x.ip_span = (float*)take(TA * 4);
    x.ip_scored = (uint8_t*)take(TA);
    if (w) *w = x;
    return off;
}

// ---- small helpers ---------------------------------------------------------

__device__ __forceinline__ int wrap_job(int j, int J) {
    return j < 0 ? j + J : j;              // jnp indexing wraps -1 once
}

// reference _share: max over the resource axis of alloc/denom with
// 0/0 -> 0, x/0 -> 1
__device__ __forceinline__ float share3(const float* alloc,
                                        const float* denom) {
    float m = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float d = denom[r], a = alloc[r];
        const float f = d == 0.0f ? (a == 0.0f ? 0.0f : 1.0f)
                                  : a / fmaxf(d, 1e-30f);
        m = r == 0 ? f : fmaxf(m, f);
    }
    return m;
}

// float -> uint32 whose unsigned order is the float order; -0.0 maps as
// +0.0 (JAX's sort comparator canonicalises it)
__device__ __forceinline__ uint32_t ord_bits(float f) {
    if (f == 0.0f) f = 0.0f;
    const uint32_t u = __float_as_uint(f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// jnp.searchsorted(side="left")'s default method: ceil(log2(n + 1))
// halvings of (low, high) from (0, n)
template <class V>
__device__ __forceinline__ int search_left(const V* a, int stride, int n,
                                           V q) {
    unsigned low = 0, high = (unsigned)n;
    const int levels = 32 - __clz(n);
    for (int l = 0; l < levels; ++l) {
        const unsigned mid = (low + high) >> 1;
        if (q <= a[(size_t)mid * stride]) high = mid; else low = mid;
    }
    return (int)high;
}

__device__ __forceinline__ int lower_bound_u64(const uint64_t* a, int n,
                                               uint64_t q) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < q) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// ---- affinity bit words -----------------------------------------------------

__device__ __forceinline__ bool has_bit(const uint64_t* w, int p) {
    return (w[p >> 6] >> (p & 63)) & 1ull;
}

__device__ __forceinline__ void set_bit(uint64_t* w, int p) {
    w[p >> 6] |= 1ull << (p & 63);
}

// OR of a 64-bit value across the (converged) warp
__device__ __forceinline__ uint64_t warp_or64(uint64_t v) {
    const unsigned lo = __reduce_or_sync(FULL, (unsigned)v);
    const unsigned hi = __reduce_or_sync(FULL, (unsigned)(v >> 32));
    return ((uint64_t)hi << 32) | lo;
}

// Call f(p) for every set bit p of the two words m.
template <class F>
__device__ __forceinline__ void for_bits(const uint64_t* m, F f) {
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
        uint64_t b = m[wi];
        while (b) {
            const int i = __ffsll((long long)b) - 1;
            b &= b - 1;
            f(wi * 64 + i);
        }
    }
}

// one task's affinity words for a round (boot folded into need)
struct AffRow {
    uint64_t grp[2], req[2], anti[2], need[2], pref[2];
    uint64_t ports;
    bool maybe_scored;
};

// ---- block-level building blocks (block 0) ---------------------------------

// Bitonic sort of a[0..m) (m a power of two), ascending by ``less``.
template <class V, class Less>
__device__ void block_sort(V* a, int m, Less less) {
    for (int k = 2; k <= m; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int q = threadIdx.x; q < (m >> 1); q += blockDim.x) {
                const int i = 2 * j * (q / j) + (q % j);
                const int ixj = i + j;
                const V x = a[i], y = a[ixj];
                const bool up = (i & k) == 0;
                if (up ? less(y, x) : less(x, y)) { a[i] = y; a[ixj] = x; }
            }
            __syncthreads();
        }
    }
}

struct U64Less {
    __device__ bool operator()(uint64_t a, uint64_t b) const { return a < b; }
};

// Sort keys[0..m), m = pow2 >= n, entries past n set to NONE first.
// ``fill(i)`` gives the key of entry i < n.
template <class Fill>
__device__ void sort_keys(uint64_t* keys, int n, int m, Fill fill) {
    for (int i = threadIdx.x; i < m; i += blockDim.x)
        keys[i] = i < n ? fill(i) : NONE;
    __syncthreads();
    block_sort(keys, m, U64Less());
}

// Inclusive scan of x[i * ncol + c] (i < n) into y, in jnp.cumsum's
// order: a sequential scan inside each 16-wide tile, the tile totals
// scanned the same way (recursively), each tile's exclusive carry added.
__device__ void block_tiled_cumsum(const float* x, float* y, int n, int ncol,
                                   float* scratch) {
    float* buf[8];
    int ns[8];
    buf[0] = y;
    ns[0] = n;
    int L = 0;
    float* next = scratch;
    // level 0 reads x; later levels scan their buffer in place
    while (true) {
        const int cur = ns[L];
        const float* src = L == 0 ? x : buf[L];
        const int tiles = (cur + 15) / 16;
        const bool top = cur <= 16;
        if (!top) {
            buf[L + 1] = next;
            ns[L + 1] = tiles;
            next += (size_t)tiles * ncol;
        }
        for (int q = threadIdx.x; q < tiles * ncol; q += blockDim.x) {
            const int tile = q / ncol, c = q % ncol;
            const int i0 = tile * 16;
            const int i1 = min(i0 + 16, cur);
            float acc = src[(size_t)i0 * ncol + c];
            buf[L][(size_t)i0 * ncol + c] = acc;
            for (int i = i0 + 1; i < i1; ++i) {
                acc = acc + src[(size_t)i * ncol + c];
                buf[L][(size_t)i * ncol + c] = acc;
            }
            if (!top) {
                // a tile short of 16 pads with zeros: its total is acc
                buf[L + 1][(size_t)tile * ncol + c] = acc;
            }
        }
        __syncthreads();
        if (top) break;
        ++L;
    }
    for (int l = L - 1; l >= 0; --l) {
        for (int q = threadIdx.x; q < ns[l] * ncol; q += blockDim.x) {
            const int i = q / ncol, c = q % ncol;
            const int tile = i / 16;
            const float carry = tile > 0 ? buf[l + 1][(size_t)(tile - 1) * ncol
                                                      + c]
                                         : 0.0f;
            buf[l][q] = buf[l][q] + carry;
        }
        __syncthreads();
    }
}

// Column sums of x[n, ncol] in the order of x.sum(axis=0): windows of 32
// (the pad split evenly before and after) summed sequentially until 32 or
// fewer rows remain, then those in sequence. Result in out[ncol].
__device__ void block_column_sum(const float* x, int n, int ncol, float* a,
                                 float* b, float* out) {
    const float* cur = x;
    float* dst = a;
    while (n > 32) {
        const int m = (n + 31) / 32;
        const int lo = (m * 32 - n) / 2;
        for (int q = threadIdx.x; q < m * ncol; q += blockDim.x) {
            const int w = q / ncol, c = q % ncol;
            float acc = 0.0f;
            for (int j = 0; j < 32; ++j) {
                const int i = w * 32 + j - lo;
                const float v = (i >= 0 && i < n) ? cur[(size_t)i * ncol + c]
                                                  : 0.0f;
                acc = j == 0 ? v : acc + v;
            }
            dst[q] = acc;
        }
        __syncthreads();
        cur = dst;
        dst = dst == a ? b : a;
        n = m;
    }
    for (int c = threadIdx.x; c < ncol; c += blockDim.x) {
        float acc = cur[c];
        for (int i = 1; i < n; ++i) acc = acc + cur[(size_t)i * ncol + c];
        out[c] = acc;
    }
    __syncthreads();
}

using kb::SegScan;

// ---- the cycle -------------------------------------------------------------

struct Cycle {
    const Params& p;
    const Work& w;
    uint64_t* skeys;                       // shared-memory sort keys
    cg::grid_group grid;
    int gtid, gsize, lane, gwarp, nwarps;
    bool b0;
    unsigned long long t_last;             // thread 0's last barrier time

    __device__ Cycle(const Params& p_, const Work& w_, uint64_t* s)
        : p(p_), w(w_), skeys(s), grid(cg::this_grid()) {
        gtid = blockIdx.x * blockDim.x + threadIdx.x;
        gsize = gridDim.x * blockDim.x;
        lane = threadIdx.x & 31;
        gwarp = gtid >> 5;
        nwarps = gsize >> 5;
        b0 = blockIdx.x == 0;
    }

    static __device__ __forceinline__ unsigned long long now_ns() {
        unsigned long long t;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
        return t;
    }

    // grid barrier closing phase ``ph``; thread 0 adds the interval since
    // the previous barrier to that phase's device time
    __device__ void sync(int ph) {
        grid.sync();
        if (gtid == 0) {
            const unsigned long long t = now_ns();
            p.phase_ns[ph] += t - t_last;
            t_last = t;
        }
    }

    __device__ uint64_t* keybuf(int m) const {
        return m <= SMEM_KEYS ? skeys : w.gkeys;
    }

    __device__ int tcur() const { return w.iscal[S_TCUR]; }

    // the predicate row and request row task t is tested with: its own,
    // or with pair_init (the active set's exact pairs) its pair's
    __device__ __forceinline__ int task_row(int t, float* init) const {
        const int q = p.tpair[t];
        const float* src = p.pair_init ? p.pair_init + (size_t)q * 3
                                       : p.init + (size_t)t * 3;
        init[0] = src[0];
        init[1] = src[1];
        init[2] = src[2];
        return p.pair_init ? p.pair_sig[q] : p.tsig[t];
    }

    // predicate + count room + fit of task t at node n against the
    // precomputed accp = (idle + bf) + eps, relp = rel + eps, basep
    __device__ __forceinline__ bool cell(int sig, const float* init,
                                         int n) const {
        if (!(p.sig_pred[(size_t)sig * p.NS + n] && w.basep[n])) return false;
        const float* a = w.accp + (size_t)n * 3;
        bool fit = init[0] <= a[0] && init[1] <= a[1] && init[2] <= a[2];
        if (p.pipe && !fit) {
            const float* r = w.relp + (size_t)n * 3;
            fit = init[0] <= r[0] && init[1] <= r[1] && init[2] <= r[2];
        }
        return fit;
    }

    // grid: accp / relp / basep from the current node carry
    __device__ void node_views() {
        for (int n = gtid; n < p.N; n += gsize) {
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const int i = n * 3 + r;
                w.accp[i] = (p.idle[i] + p.bf[i]) + p.eps[r];
                w.relp[i] = p.rel[i] + p.eps[r];
            }
            w.basep[n] = p.node_ok[n] && p.ntasks[n] < p.maxt[n];
        }
    }

    // grid, one warp per task row with mask[k]: any eligible node and the
    // lowest-index argmax of the row's scores over the eligible nodes
    // (node 0 when none is). With affinity the cell also takes the
    // affinity predicates, and a task that can score adds the interpod
    // term; ``first`` (the round's first pass) normalises that term and
    // keeps (cmin, span, scored) for the retry and the waterfall.
    __device__ void row_pass(const uint8_t* mask, uint8_t* any_out,
                             int32_t* best_out, bool first) {
        const int tc = tcur();
        const float ipw = p.ip ? p.ipw[0] : 0.0f;
        for (int k = gwarp; k < tc; k += nwarps) {
            if (!mask[k]) continue;
            const int t = w.tmap[k];
            float init[3];
            const int sig = task_row(t, init);
            const float* scp = w.sc + (size_t)p.tpair[t] * p.N;
            AffRow ar;
            if (p.aff) ar = aff_row(t);
            const bool scoring = p.aff && ar.maybe_scored;
            float cmin = 0.0f, span = 0.0f;
            if (scoring && first) {
                // min / max of the counts over the real nodes
                float lo = INFINITY, hi = -INFINITY;
                for (int n = lane; n < p.N; n += 32) {
                    if (!p.node_ok[n]) continue;
                    const float c = ip_counts(t, ar, n);
                    lo = fminf(lo, c);
                    hi = fmaxf(hi, c);
                }
                for (int o = 16; o > 0; o >>= 1) {
                    lo = fminf(lo, __shfl_xor_sync(FULL, lo, o));
                    hi = fmaxf(hi, __shfl_xor_sync(FULL, hi, o));
                }
                cmin = lo;
                span = hi - lo;
                if (lane == 0) {
                    w.ip_cmin[k] = cmin;
                    w.ip_span[k] = span;
                }
            } else if (scoring) {
                cmin = w.ip_cmin[k];
                span = w.ip_span[k];
            }
            bool any = false, scored = false;
            float bv = -INFINITY;
            int bi = IMAX;
            for (int n = lane; n < p.N; n += 32) {
                float tm = 0.0f;
                if (scoring) {
                    // reference _ip_score, in its float order
                    const float c = ip_counts(t, ar, n);
                    tm = span > 0.0f ? floorf((10.0f * (c - cmin)) / span)
                                     : 0.0f;
                    tm = tm * ipw;
                    scored = scored || tm != 0.0f;
                }
                if (!cell(sig, init, n)) continue;
                if (p.aff && !aff_cell(ar, n)) continue;
                float v = scp[n];
                if (scoring && p.node_ok[n]) v = v + tm;
                if (!any || v > bv) { bv = v; bi = n; }
                any = true;
            }
            if (first && p.aff)
                scored = __any_sync(FULL, scored);
            for (int o = 16; o > 0; o >>= 1) {
                const float ov = __shfl_xor_sync(FULL, bv, o);
                const int oi = __shfl_xor_sync(FULL, bi, o);
                const int oa = __shfl_xor_sync(FULL, (int)any, o);
                if (oa && (!any || ov > bv || (ov == bv && oi < bi))) {
                    bv = ov;
                    bi = oi;
                }
                any = any || oa;
            }
            if (lane == 0) {
                any_out[k] = any;
                best_out[k] = any ? bi : 0;
                if (first && p.aff) w.ip_scored[k] = scored;
            }
        }
    }

    // ---- affinity (kernels/batched.py _aff_* and _ip_score) ------------

    // grid, once: pack the task and node words, the int32 carry
    __device__ void aff_setup() {
        const int A = p.A, T = p.T, N = p.N;
        for (int t = gtid; t < T; t += gsize) {
            uint64_t g[2] = {0, 0}, r[2] = {0, 0}, a[2] = {0, 0},
                     sf[2] = {0, 0}, pf[2] = {0, 0}, cw[2] = {0, 0};
            for (int q = 0; q < A; ++q) {
                const size_t i = (size_t)t * A + q;
                if (p.tgrp[i]) set_bit(g, q);
                if (p.treq[i]) set_bit(r, q);
                if (p.tanti[i]) set_bit(a, q);
                if (p.tself[i]) set_bit(sf, q);
                if (p.tpref[i] != 0.0f) set_bit(pf, q);
                if (p.tcarry[i] != 0.0f) set_bit(cw, q);
            }
            for (int wi = 0; wi < 2; ++wi) {
                w.mgrp[t * 2 + wi] = g[wi];
                w.mreq[t * 2 + wi] = r[wi];
                w.manti[t * 2 + wi] = a[wi];
                w.mself[t * 2 + wi] = sf[wi];
                w.mpref[t * 2 + wi] = pf[wi];
                w.mcarry[t * 2 + wi] = cw[wi];
            }
            uint64_t pt = 0;
            for (int j = 0; j < p.PT; ++j)
                if (p.tports[(size_t)t * p.PT + j]) pt |= 1ull << j;
            w.mports[t] = pt;
        }
        for (int n = gtid; n < N; n += gsize) {
            uint64_t pb = 0;
            for (int j = 0; j < p.PT; ++j)
                if (p.pbase[(size_t)n * p.PT + j]) pb |= 1ull << j;
            w.pbase[n] = pb;
            w.pclaim[n] = 0;
        }
        const size_t ad = (size_t)A * p.D;
        for (size_t i = gtid; i < ad; i += gsize) {
            w.gcnt[i] = (int32_t)p.gcnt0[i];
            w.acnt[i] = (int32_t)p.acnt0[i];
            w.prefw[i] = (int32_t)p.prefw0[i];
        }
        for (int q = gtid; q < A; q += gsize) w.gtot[q] = (int32_t)p.gtot0[q];
    }

    // block 0, before the views: the bootstrap flags from the totals; the
    // other flags and the pending counts cleared for the views' atomics
    __device__ void aff_flags() {
        if (threadIdx.x == 0) {
            uint64_t b[2] = {0, 0};
            for (int q = 0; q < p.A; ++q)
                if (w.gtot[q] <= 0) set_bit(b, q);
            for (int f = 0; f < F_N; ++f)
                for (int wi = 0; wi < 2; ++wi)
                    w.fl[f * 2 + wi] = f == F_BOOT ? b[wi] : 0;
        }
        for (int q = threadIdx.x; q < p.A; q += blockDim.x) w.gpend[q] = 0;
    }

    // grid: the round-start views of the carry (reference _aff_gather):
    // per-node present / sym / used words (and the score's [A,N] count
    // views), the pair flags, pending members; the serialization minima
    // reset for this round
    __device__ void aff_views() {
        const int A = p.A, N = p.N, D = p.D, tc = tcur();
        uint64_t* fl = w.fl;
        for (int base = gwarp * 32; base < N; base += nwarps * 32) {
            const int n = base + lane;
            uint64_t pr[2] = {0, 0};
            if (n < N) {
                uint64_t sy[2] = {0, 0};
                for (int q = 0; q < A; ++q) {
                    const int d = p.node_dom[(size_t)q * N + n];
                    const bool hd = d >= 0;
                    const int g = hd ? w.gcnt[(size_t)q * D + d] : 0;
                    const int ac = hd ? w.acnt[(size_t)q * D + d] : 0;
                    if (g > 0) set_bit(pr, q);
                    if (ac > 0) set_bit(sy, q);
                    if (p.ip) {
                        w.gview[(size_t)q * N + n] = hd ? (float)g : 0.0f;
                        w.pview[(size_t)q * N + n] =
                            hd ? (float)w.prefw[(size_t)q * D + d] : 0.0f;
                    }
                }
                for (int wi = 0; wi < 2; ++wi) {
                    w.present[n * 2 + wi] = pr[wi];
                    w.symv[n * 2 + wi] = sy[wi];
                }
                w.used[n] = w.pbase[n] | w.pclaim[n];
            }
            for (int wi = 0; wi < 2; ++wi) {
                const uint64_t o = warp_or64(pr[wi]);
                if (lane == 0 && o)
                    atomicOr((unsigned long long*)&fl[F_SAT * 2 + wi], o);
            }
        }
        // pairs with a placed anti carrier, pairs with carried weight
        const size_t ad = (size_t)A * D;
        for (size_t base = (size_t)gwarp * 32; base < ad;
             base += (size_t)nwarps * 32) {
            const size_t i = base + lane;
            uint64_t c[2] = {0, 0}, f[2] = {0, 0};
            if (i < ad) {
                const int q = (int)(i / D);
                if (w.acnt[i] > 0) set_bit(c, q);
                if (w.prefw[i] != 0) set_bit(f, q);
            }
            for (int wi = 0; wi < 2; ++wi) {
                const uint64_t oc = warp_or64(c[wi]), of = warp_or64(f[wi]);
                if (lane == 0 && oc)
                    atomicOr((unsigned long long*)&fl[F_CARRIER * 2 + wi], oc);
                if (lane == 0 && of)
                    atomicOr((unsigned long long*)&fl[F_PREF * 2 + wi], of);
            }
        }
        // the view's tasks: anti carriers (valid) and pending members
        for (int base = gwarp * 32; base < tc; base += nwarps * 32) {
            const int k = base + lane;
            uint64_t an[2] = {0, 0}, pm[2] = {0, 0};
            if (k < tc && w.vvalid[k]) {
                const int t = w.tmap[k];
                an[0] = w.manti[t * 2];
                an[1] = w.manti[t * 2 + 1];
                if (p.out[t] == SKIP) {
                    pm[0] = w.mgrp[t * 2];
                    pm[1] = w.mgrp[t * 2 + 1];
                }
            }
            uint64_t any_pm[2];
            for (int wi = 0; wi < 2; ++wi) {
                const uint64_t o = warp_or64(an[wi]);
                if (lane == 0 && o)
                    atomicOr((unsigned long long*)&fl[F_CARRIER * 2 + wi], o);
                any_pm[wi] = warp_or64(pm[wi]);
            }
            for_bits(any_pm, [&](int q) {
                const int cnt = __popc(__ballot_sync(FULL, has_bit(pm, q)));
                if (lane == 0) atomicAdd(&w.gpend[q], cnt);
            });
        }
        const size_t ad1 = (size_t)A * (D + 1);
        for (size_t i = gtid; i < ad1; i += gsize) {
            w.cmin[i] = IMAX;
            w.mmin[i] = IMAX;
        }
        for (int q = gtid; q < A; q += gsize) {
            w.bmin[q] = IMAX;
            w.bdom[q] = -1;
        }
        for (int n = gtid; n <= N; n += gsize) w.pmin[n] = IMAX;
    }

    __device__ AffRow aff_row(int t) const {
        AffRow r;
        const uint64_t* boot = w.fl + F_BOOT * 2;
        const uint64_t* pref_any = w.fl + F_PREF * 2;
        bool ms = false;
        for (int wi = 0; wi < 2; ++wi) {
            r.grp[wi] = w.mgrp[t * 2 + wi];
            r.req[wi] = w.mreq[t * 2 + wi];
            r.anti[wi] = w.manti[t * 2 + wi];
            r.pref[wi] = w.mpref[t * 2 + wi];
            r.need[wi] = r.req[wi] & ~(boot[wi] & w.mself[t * 2 + wi]);
            ms = ms || r.pref[wi] || (r.grp[wi] & pref_any[wi]);
        }
        r.ports = p.PT ? w.mports[t] : 0;
        r.maybe_scored = p.ip && ms;
        return r;
    }

    // the affinity and host-port predicates of one (task, node) cell
    __device__ __forceinline__ bool aff_cell(const AffRow& r, int n) const {
        const uint64_t* pr = w.present + (size_t)n * 2;
        const uint64_t* sy = w.symv + (size_t)n * 2;
        uint64_t bad = 0;
#pragma unroll
        for (int wi = 0; wi < 2; ++wi)
            bad |= (r.need[wi] & ~pr[wi]) | (r.anti[wi] & pr[wi])
                   | (r.grp[wi] & sy[wi]);
        return !bad && !(r.ports & w.used[n]);
    }

    // own + sym interpod counts of task t at node n (integer-valued
    // floats far below 2**24: exact in any order)
    __device__ __forceinline__ float ip_counts(int t, const AffRow& r,
                                               int n) const {
        float own = 0.0f, sym = 0.0f;
        for_bits(r.pref, [&](int q) {
            own = own + p.tpref[(size_t)t * p.A + q]
                        * w.gview[(size_t)q * p.N + n];
        });
        for_bits(r.grp, [&](int q) {
            sym = sym + w.pview[(size_t)q * p.N + n];
        });
        return own + sym;
    }

    // a positive term unsatisfiable anywhere whose group has other
    // pending members: the task waits (reference could_wait)
    __device__ bool could_wait(int k, int t) const {
        const AffRow r = aff_row(t);
        const uint64_t* sat = w.fl + F_SAT * 2;
        const bool pend = w.vvalid[k] && p.out[t] == SKIP;
        uint64_t m[2] = {r.need[0] & ~sat[0], r.need[1] & ~sat[1]};
        bool wait = false;
        for_bits(m, [&](int q) {
            const float mine = (pend && has_bit(r.grp, q)) ? 1.0f : 0.0f;
            wait = wait || ((float)w.gpend[q] - mine) > 0.5f;
        });
        return wait;
    }

    // tasks kept out of the same-round retry (reference _aff_involved)
    __device__ bool involved(int t) const {
        const uint64_t* car = w.fl + F_CARRIER * 2;
        const uint64_t* boot = w.fl + F_BOOT * 2;
        bool inv = p.PT && w.mports[t];
        for (int wi = 0; wi < 2; ++wi)
            inv = inv || w.manti[t * 2 + wi]
                  || (w.mgrp[t * 2 + wi] & car[wi])
                  || (w.mreq[t * 2 + wi] & boot[wi]);
        return inv;
    }

    // block 0: phase-1 acceptances whose co-placement is sequentially
    // legal (reference _aff_serialize); integer atomics only
    __device__ void aff_serialize() {
        const int tc = tcur(), N = p.N, D = p.D;
        const uint64_t* boot = w.fl + F_BOOT * 2;
        for (int k = threadIdx.x; k < tc; k += blockDim.x) {
            if (!w.acc1[k]) continue;
            const int t = w.tmap[k], node = w.prop1[k], rank = w.grank[k];
            uint64_t m[2];
            for (int wi = 0; wi < 2; ++wi)
                m[wi] = w.mgrp[t * 2 + wi] | w.manti[t * 2 + wi]
                        | w.mreq[t * 2 + wi];
            for_bits(m, [&](int q) {
                const int d = p.node_dom[(size_t)q * N + node];
                const bool car = has_bit(w.manti + t * 2, q);
                if (d >= 0) {
                    const size_t i = (size_t)q * (D + 1) + d;
                    if (car) atomicMin(&w.cmin[i], rank);
                    else if (has_bit(w.mgrp + t * 2, q))
                        atomicMin(&w.mmin[i], rank);
                }
                if (has_bit(w.mreq + t * 2, q)) atomicMin(&w.bmin[q], rank);
            });
            if (p.PT && w.mports[t]) atomicMin(&w.pmin[node], rank);
        }
        __syncthreads();
        for (int k = threadIdx.x; k < tc; k += blockDim.x) {
            if (!w.acc1[k]) continue;
            const int t = w.tmap[k], node = w.prop1[k], rank = w.grank[k];
            for_bits(w.mreq + t * 2, [&](int q) {
                if (rank == w.bmin[q]) {
                    const int d = p.node_dom[(size_t)q * N + node];
                    atomicMax(&w.bdom[q], d >= 0 ? d : D);
                }
            });
        }
        __syncthreads();
        for (int k = threadIdx.x; k < tc; k += blockDim.x) {
            if (!w.acc1[k]) continue;
            const int t = w.tmap[k], node = w.prop1[k], rank = w.grank[k];
            uint64_t m[2];
            for (int wi = 0; wi < 2; ++wi)
                m[wi] = w.mgrp[t * 2 + wi] | w.manti[t * 2 + wi]
                        | w.mreq[t * 2 + wi];
            bool keep = true;
            for_bits(m, [&](int q) {
                const int d = p.node_dom[(size_t)q * N + node];
                const int seg = d >= 0 ? d : D;
                const size_t i = (size_t)q * (D + 1) + seg;
                const int cmin = w.cmin[i], mmin = w.mmin[i];
                if (has_bit(w.manti + t * 2, q))
                    keep = keep && rank == cmin && cmin < mmin;
                else if (has_bit(w.mgrp + t * 2, q))
                    keep = keep && (!(cmin < IMAX) || mmin < cmin);
                if (has_bit(w.mreq + t * 2, q) && has_bit(boot, q)) {
                    const int bd = w.bdom[q];
                    keep = keep && (rank == w.bmin[q]
                                    || (seg == bd && bd < D));
                }
            });
            if (p.PT && w.mports[t]) keep = keep && rank == w.pmin[node];
            w.acc1[k] = keep;
        }
        __syncthreads();
    }

    // block 0: add (sign 1) or subtract (-1) task t's placement at node
    // into the carry (reference _aff_delta; exact integer atomics)
    __device__ void aff_apply(int t, int node, int sign) {
        const int N = p.N, D = p.D, A = p.A;
        uint64_t m[2];
        for (int wi = 0; wi < 2; ++wi)
            m[wi] = w.mgrp[t * 2 + wi] | w.manti[t * 2 + wi]
                    | w.mcarry[t * 2 + wi];
        for_bits(m, [&](int q) {
            const int d = p.node_dom[(size_t)q * N + node];
            const bool g = has_bit(w.mgrp + t * 2, q);
            if (g) atomicAdd(&w.gtot[q], sign);
            if (d < 0) return;
            const size_t i = (size_t)q * D + d;
            if (g) atomicAdd(&w.gcnt[i], sign);
            if (has_bit(w.manti + t * 2, q)) atomicAdd(&w.acnt[i], sign);
            if (has_bit(w.mcarry + t * 2, q))
                atomicAdd(&w.prefw[i],
                          sign * (int32_t)p.tcarry[(size_t)t * A + q]);
        });
        if (p.PT && w.mports[t]) {
            unsigned long long* c = (unsigned long long*)&w.pclaim[node];
            if (sign > 0) atomicOr(c, w.mports[t]);
            else atomicAnd(c, ~w.mports[t]);
        }
    }

    // block 0: the round's accepted placements into the carry
    __device__ void aff_commit() {
        const int tc = tcur();
        for (int k = threadIdx.x; k < tc; k += blockDim.x)
            if (w.accept[k]) aff_apply(w.tmap[k], w.prop1[k], 1);
        __syncthreads();
    }

    // grid, at the end: the float carry and the claim matrix
    __device__ void aff_write_out() {
        const size_t ad = (size_t)p.A * p.D;
        for (size_t i = gtid; i < ad; i += gsize) {
            p.gcnt_out[i] = (float)w.gcnt[i];
            p.acnt_out[i] = (float)w.acnt[i];
            p.prefw_out[i] = (float)w.prefw[i];
        }
        for (int q = gtid; q < p.A; q += gsize)
            p.gtot_out[q] = (float)w.gtot[q];
        const size_t npt = (size_t)p.N * p.PT;
        for (size_t i = gtid; i < npt; i += gsize)
            p.pclaim_out[i] = (w.pclaim[i / p.PT] >> (i % p.PT)) & 1ull;
    }

    // ---- per-segment sums in task-index order (block 0) ---------------

    // Sort (segment << 32 | k) for the tasks ``seg(k) >= 0`` of the view;
    // returns the key array (sorted, NONE past the included ones).
    template <class Seg>
    __device__ uint64_t* segment_keys(Seg seg) {
        const int tc = tcur(), m = p.MT;
        uint64_t* keys = keybuf(m);
        sort_keys(keys, tc, m, [&](int k) -> uint64_t {
            const int s = seg(k);
            return s < 0 ? NONE : ((uint64_t)s << 32) | (uint32_t)k;
        });
        return keys;
    }

    // ---- round phases ---------------------------------------------------

    // block 0: queue overuse / shares, the job order, the demand window
    __device__ void order_jobs() {
        const int J = p.J, Q = p.Q;
        for (int q = threadIdx.x; q < Q; q += blockDim.x) {
            bool over = p.prop_overused;
            for (int r = 0; r < 3 && over; ++r)
                over = p.qdes[q * 3 + r] < w.q_alloc[q * 3 + r] + p.eps[r];
            w.overused[q] = over;
            w.q_share[q] = p.qshare ? share3(w.q_alloc + q * 3, p.qdes + q * 3)
                                    : 0.0f;
        }
        __syncthreads();
        const int nk = 3 + p.njk;
        for (int j = threadIdx.x; j < J; j += blockDim.x) {
            float* k = w.jkey + (size_t)j * 6;
            const int q = p.jqueue[j];
            k[0] = w.q_share[q];
            k[1] = (float)p.qcrank[q];
            for (int i = 0; i < p.njk; ++i) {
                const int code = p.jk[i];
                k[2 + i] = code == K_PRIORITY ? -p.jprio[j]
                         : code == K_GANG_READY
                             ? (w.alloc_cnt[j] >= p.omin[j] ? 1.0f : 0.0f)
                             : share3(w.j_alloc + (size_t)j * 3, p.ctotal);
            }
            k[2 + p.njk] = (float)p.jcrank[j];
        }
        for (int i = threadIdx.x; i < p.MJ; i += blockDim.x) w.jidx[i] = i;
        __syncthreads();
        const float* jkey = w.jkey;
        block_sort(w.jidx, p.MJ, [=](int a, int b) {
            if (a >= J || b >= J) return a < b;
            const float* ka = jkey + (size_t)a * 6;
            const float* kb = jkey + (size_t)b * 6;
            for (int i = 0; i < nk; ++i) {
                if (ka[i] < kb[i]) return true;
                if (ka[i] > kb[i]) return false;
            }
            return a < b;
        });
        for (int k = threadIdx.x; k < J; k += blockDim.x) {
            const int j = w.jidx[k];
            w.job_order[k] = j;
            w.job_rank[j] = k;
            w.fail_rank[j] = IMAX;
        }
        for (int q = threadIdx.x; q < p.P; q += blockDim.x)
            w.pair_demand[q] = 0;
        // avail_pool: column sums over the nodes of the accessible pool
        for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
            const bool base = p.node_ok[n] && p.ntasks[n] < p.maxt[n];
            for (int r = 0; r < 3; ++r) {
                const int i = n * 3 + r;
                w.col_in[i] = base ? fmaxf(p.idle[i] + p.bf[i], 0.0f) : 0.0f;
            }
        }
        __syncthreads();
        block_column_sum(w.col_in, p.N, 3, w.col_a, w.col_b, w.fscal);
        if (p.pipe) {
            for (int i = threadIdx.x; i < p.N * 3; i += blockDim.x)
                w.col_in[i] = fmaxf(p.rel[i], 0.0f);
            __syncthreads();
            block_column_sum(w.col_in, p.N, 3, w.col_a, w.col_b, w.fscal + 3);
            if (threadIdx.x < 3)
                w.fscal[threadIdx.x] = w.fscal[threadIdx.x]
                                       + w.fscal[3 + threadIdx.x];
            __syncthreads();
        }
    }

    // grid: engaged tasks
    __device__ void engage() {
        const int tc = tcur();
        for (int k = gtid; k < tc; k += gsize) {
            const int t = w.tmap[k];
            const int j = wrap_job(p.tjob[t], p.J);
            w.engaged[k] = w.vvalid[k] && p.out[t] == SKIP && w.alive[j]
                           && p.jvalid[j] && !w.overused[p.jqueue[j]];
        }
    }

    // block 0: the demand window and the per-queue budgets -> admitted
    __device__ void window() {
        const int J = p.J;
        // job_demand: per job, engaged requests in task-index order
        uint64_t* keys = segment_keys([&](int k) {
            return w.engaged[k] ? max(p.tjob[w.tmap[k]], 0) : -1;
        });
        for (int j = threadIdx.x; j < J; j += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)j << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(j + 1) << 32);
            float s[3] = {0.0f, 0.0f, 0.0f};
            for (int i = lo; i < hi; ++i) {
                const int t = w.tmap[(int)(keys[i] & 0xffffffffu)];
                for (int r = 0; r < 3; ++r) s[r] = s[r] + p.resreq[t * 3 + r];
            }
            bool eng = false;
            float nm = 0.0f;
            for (int r = 0; r < 3; ++r) {
                w.job_demand[j * 3 + r] = s[r];
                eng = eng || s[r] > 0.0f;
                const float av = w.fscal[r];
                const float f = av > 0.0f ? s[r] / fmaxf(av, 1e-9f) : 0.0f;
                nm = r == 0 ? f : fmaxf(nm, f);
            }
            w.eng_job[j] = eng;
            w.norm[j] = nm;
        }
        __syncthreads();
        for (int k = threadIdx.x; k < J; k += blockDim.x)
            w.norm_ord[k] = w.norm[w.job_order[k]];
        __syncthreads();
        if (p.prop_overused) {
            for (int j = threadIdx.x; j < J; j += blockDim.x) {
                const int q = p.jqueue[j];
                float nm = 0.0f;
                for (int r = 0; r < 3; ++r) {
                    const float rem = fmaxf(p.qdes[q * 3 + r]
                                            - w.q_alloc[q * 3 + r], 0.0f);
                    const float f = rem > 0.0f
                        ? w.job_demand[j * 3 + r] / fmaxf(rem, 1e-9f) : 0.0f;
                    nm = r == 0 ? f : fmaxf(nm, f);
                }
                w.qn[j] = nm;
            }
            // jobs grouped by queue, rank order inside each queue
            uint64_t* jk = keybuf(p.MJ);
            sort_keys(jk, J, p.MJ, [&](int j) {
                return ((uint64_t)(uint32_t)p.jqueue[j] << 32)
                       | (uint32_t)w.job_rank[j];
            });
            for (int k = threadIdx.x; k < J; k += blockDim.x) {
                const int j = w.job_order[(int)(jk[k] & 0xffffffffu)];
                w.qperm[k] = j;
                w.qj[k] = p.jqueue[j];
            }
            __syncthreads();
            for (int k = threadIdx.x; k < J; k += blockDim.x) {
                const int st = search_left(w.qj, 1, J, w.qj[k]);
                const int j = w.qperm[k];
                w.sv[k * 2] = w.qn[j];
                w.sv[k * 2 + 1] = w.eng_job[j] ? 1.0f : 0.0f;
                w.scnt[k] = 0;
                w.sflag[k] = k == st;
            }
            __syncthreads();
            SegScan<2>{w.sv, w.scnt, w.sflag, w.rv, w.rcnt, w.rflag}.run(J);
            for (int k = threadIdx.x; k < J; k += blockDim.x) {
                const float qp = w.rv[k * 2] - w.sv[k * 2];
                const float ec = w.rv[k * 2 + 1] - w.sv[k * 2 + 1];
                const int j = w.qperm[k];
                const bool first = w.eng_job[j] && ec == 0.0f;
                w.q_ok[j] = qp <= 1.0f || first;
            }
            __syncthreads();
            for (int k = threadIdx.x; k < J; k += blockDim.x)
                w.norm_ord[k] = w.norm_ord[k]
                                * (w.q_ok[w.job_order[k]] ? 1.0f : 0.0f);
            __syncthreads();
        } else {
            for (int j = threadIdx.x; j < J; j += blockDim.x) w.q_ok[j] = 1;
        }
        block_tiled_cumsum(w.norm_ord, w.cum_j, J, 1, w.tscr);
        for (int k = threadIdx.x; k < J; k += blockDim.x) {
            const float excl = w.cum_j[k] - w.norm_ord[k];
            const int j = w.job_order[k];
            w.admitted[j] = (excl <= WINDOW_SLACK) && w.q_ok[j];
        }
    }

    // block 0: the global task rank (job order, task rank, index)
    __device__ void rank_tasks() {
        const int tc = tcur(), m = p.MT;
        uint64_t* keys = keybuf(m);
        sort_keys(keys, tc, m, [&](int k) {
            const int t = w.tmap[k];
            const uint64_t jr = w.part[k]
                ? (uint64_t)w.job_rank[wrap_job(p.tjob[t], p.J)] : 0xffffffull;
            return (jr << 40) | ((uint64_t)(uint32_t)p.trank[t] << 20)
                   | (uint64_t)k;
        });
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            const int k = (int)(keys[i] & 0xfffffu);
            w.order[i] = k;
            w.grank[k] = i;
        }
    }

    // grid: [P,N] pair scores against the round-start nz carry
    __device__ void pair_scores() {
        const size_t total = (size_t)p.P * p.N;
        const float w0 = p.dynw[0], w1 = p.dynw[1];
        for (size_t i = gtid; i < total; i += gsize) {
            const int q = (int)(i / p.N), n = (int)(i % p.N);
            float dyn = 0.0f;
            if (p.dyn && p.dyn_fma)
                dyn = kb::scan_node_score(
                    p.nz[n * 2], p.nz[n * 2 + 1], p.pair_nz[q * 2],
                    p.pair_nz[q * 2 + 1], p.cap[n * 2], p.cap[n * 2 + 1],
                    w0, w1);
            else if (p.dyn)
                dyn = kb::dynamic_node_score(
                    p.nz[n * 2], p.nz[n * 2 + 1], p.pair_nz[q * 2],
                    p.pair_nz[q * 2 + 1], p.cap[n * 2], p.cap[n * 2 + 1],
                    w0, w1);
            w.sc[i] = p.sig_scores[(size_t)p.pair_sig[q] * p.NS + n] + dyn;
        }
    }

    // grid: failures, the kill rank, part2, pair demand
    __device__ void fail_and_kill() {
        const int tc = tcur();
        for (int k = gtid; k < tc; k += gsize) {
            bool f = w.part[k] && !w.any_elig[k];
            if (f && p.aff) f = !could_wait(k, w.tmap[k]);
            // a pool-restricted round: eligible in another pool waits
            if (f && p.elsewhere) f = !p.elsewhere[w.tmap[k]];
            w.fail_now[k] = f;
            if (f) atomicMin(&w.fail_rank[max(p.tjob[w.tmap[k]], 0)],
                             w.grank[k]);
        }
    }

    __device__ void settle_part2() {
        const int tc = tcur();
        for (int k = gtid; k < tc; k += gsize) {
            const int t = w.tmap[k];
            const int fr = w.fail_rank[wrap_job(p.tjob[t], p.J)];
            w.fail_first[k] = w.fail_now[k] && w.grank[k] == fr;
            const bool blocked = w.part[k] && w.grank[k] > fr;
            const bool p2 = w.part[k] && !w.fail_now[k] && !blocked
                            && w.any_elig[k];
            w.part2[k] = p2;
            if (p2) atomicAdd(&w.pair_demand[p.tpair[t]], 1);
        }
    }

    // block 0: the shared waterfall's cumulative capacity and task prefixes
    __device__ void waterfall() {
        const int tc = tcur(), N = p.N;
        __shared__ int s_best[NT / 32], s_bidx[NT / 32];
        // maj_pair: argmax of pair_demand, lowest index on ties
        int bv = -1, bi = 0;
        for (int q = threadIdx.x; q < p.P; q += blockDim.x) {
            const int v = w.pair_demand[q];
            if (v > bv) { bv = v; bi = q; }
        }
        for (int o = 16; o > 0; o >>= 1) {
            const int ov = __shfl_xor_sync(FULL, bv, o);
            const int oi = __shfl_xor_sync(FULL, bi, o);
            if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
        }
        if (lane == 0) {
            s_best[threadIdx.x >> 5] = bv;
            s_bidx[threadIdx.x >> 5] = bi;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            int b = s_best[0], bidx = s_bidx[0];
            for (int i = 1; i < NT / 32; ++i)
                if (s_best[i] > b || (s_best[i] == b && s_bidx[i] < bidx)) {
                    b = s_best[i];
                    bidx = s_bidx[i];
                }
            w.iscal[S_MAJ] = bidx;
        }
        __syncthreads();
        const int maj = w.iscal[S_MAJ];
        const float* shared_sc = w.sc + (size_t)maj * N;
        const uint8_t* maj_pred = p.sig_pred + (size_t)p.pair_sig[maj] * p.NS;
        uint64_t* keys = keybuf(p.MN);
        sort_keys(keys, N, p.MN, [&](int n) {
            return ((uint64_t)ord_bits(-shared_sc[n]) << 32) | (uint32_t)n;
        });
        for (int i = threadIdx.x; i < N; i += blockDim.x) {
            const int n = (int)(keys[i] & 0xffffffffu);
            w.ord_sh[i] = n;
            const bool ok = maj_pred[n] && w.basep[n];
            for (int r = 0; r < 3; ++r)
                w.cm_in[i * 3 + r] = ok ? fmaxf(p.idle[n * 3 + r]
                                                + p.bf[n * 3 + r], 0.0f)
                                        : 0.0f;
            w.cnt_in[i] = ok ? (float)max(p.maxt[n] - p.ntasks[n], 0) : 0.0f;
        }
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            const int k = w.order[i];
            const int t = w.tmap[k];
            const float one = w.part2[k] ? 1.0f : 0.0f;
            for (int r = 0; r < 3; ++r)
                w.mass_in[i * 3 + r] = one * p.resreq[t * 3 + r];
            w.cnt_in_t[i] = one;
        }
        __syncthreads();
        block_tiled_cumsum(w.cm_in, w.cum_mass, N, 3, w.tscr);
        block_tiled_cumsum(w.cnt_in, w.cum_cnt, N, 1, w.tscr);
        block_tiled_cumsum(w.mass_in, w.mass_cum, tc, 3, w.tscr);
        block_tiled_cumsum(w.cnt_in_t, w.cnt_cum_t, tc, 1, w.tscr);
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            const int k = w.order[i];
            for (int r = 0; r < 3; ++r)
                w.prefix[k * 3 + r] = w.mass_cum[i * 3 + r]
                                      - w.mass_in[i * 3 + r];
            w.cnt_prefix[k] = w.cnt_cum_t[i] - w.cnt_in_t[i];
        }
    }

    // grid: proposals (waterfall slot, else the argmax) and their fit kind
    __device__ void propose() {
        const int tc = tcur(), N = p.N;
        for (int k = gtid; k < tc; k += gsize) {
            if (!w.part2[k]) continue;
            const int t = w.tmap[k];
            int slot = 0;
            for (int r = 0; r < 3; ++r) {
                const float need = w.prefix[k * 3 + r] + p.resreq[t * 3 + r];
                slot = max(slot, search_left(w.cum_mass + r, 3, N, need));
            }
            slot = max(slot, search_left(w.cum_cnt, 1, N,
                                         w.cnt_prefix[k] + 1.0f));
            const bool slot_ok = slot < N;
            const int pw = w.ord_sh[min(slot, N - 1)];
            float init[3];
            const int sig = task_row(t, init);
            bool water = cell(sig, init, pw) && slot_ok;
            if (p.aff)
                water = water && aff_cell(aff_row(t), pw)
                        && !(p.ip && w.ip_scored[k]);
            w.prop1[k] = water ? pw : w.fb[k];
        }
    }

    // grid: prop_alloc = the launch request fits idle + backfilled at the
    // proposed node (against the carry as it stands)
    __device__ void fit_kind(const uint8_t* mask, const int32_t* prop,
                             uint8_t* pa) {
        const int tc = tcur();
        for (int k = gtid; k < tc; k += gsize) {
            if (!mask[k]) continue;
            const int t = w.tmap[k];
            const int n = prop[k];
            bool fit = true;
            for (int r = 0; r < 3; ++r)
                fit = fit && p.init[t * 3 + r]
                                 <= (p.idle[n * 3 + r] + p.bf[n * 3 + r])
                                    + p.eps[r];
            pa[k] = fit;
        }
    }

    // block 0: per node, proposers in global-rank order while the
    // segmented prefix of accepted requests fits (reference accept_phase)
    __device__ void accept_phase(const int32_t* prop, const uint8_t* mask,
                                 const uint8_t* pa, uint8_t* acc,
                                 uint8_t* ob) {
        const int tc = tcur(), m = p.MT, N = p.N;
        uint64_t* keys = keybuf(m);
        sort_keys(keys, tc, m, [&](int k) {
            const uint32_t node = mask[k] ? (uint32_t)prop[k] : (uint32_t)N;
            return ((uint64_t)node << 32) | (uint32_t)w.grank[k];
        });
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            w.perm2[i] = w.order[(int)(keys[i] & 0xffffffffu)];
            w.nid[i] = (int)(keys[i] >> 32);
        }
        __syncthreads();
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            const int k = w.perm2[i];
            const int t = w.tmap[k];
            const bool part = mask[k], al = pa[k];
            for (int r = 0; r < 3; ++r) {
                const float v = p.resreq[t * 3 + r];
                w.sv[i * 6 + r] = (al && part) ? v : 0.0f;
                w.sv[i * 6 + 3 + r] = (!al && part) ? v : 0.0f;
            }
            w.scnt[i] = part ? 1 : 0;
            w.sflag[i] = i == search_left(w.nid, 1, tc, w.nid[i]);
        }
        __syncthreads();
        SegScan<6>{w.sv, w.scnt, w.sflag, w.rv, w.rcnt, w.rflag}.run(tc);
        for (int i = threadIdx.x; i < tc; i += blockDim.x) {
            const int k = w.perm2[i];
            const int t = w.tmap[k];
            const int nc = min(w.nid[i], N - 1);
            const bool part = mask[k], al = pa[k];
            const int excl_cnt = w.rcnt[i] - w.scnt[i];
            const bool room = (p.maxt[nc] - p.ntasks[nc] - excl_cnt) > 0;
            bool fa = true, fp = true, fi = true;
            for (int r = 0; r < 3; ++r) {
                const float ea = w.rv[i * 6 + r] - w.sv[i * 6 + r];
                const float ep = w.rv[i * 6 + 3 + r] - w.sv[i * 6 + 3 + r];
                const float in = p.init[t * 3 + r];
                const float acc_c = p.idle[nc * 3 + r] + p.bf[nc * 3 + r];
                fa = fa && in <= (acc_c - ea) + p.eps[r];
                fp = fp && in <= (p.rel[nc * 3 + r] - ep) + p.eps[r];
                fi = fi && in <= (p.idle[nc * 3 + r] - ea) + p.eps[r];
            }
            const bool ok_alloc = al && part && room && fa;
            const bool ok_pipe = p.pipe && !al && part && room && fp;
            acc[k] = ok_alloc || ok_pipe;
            ob[k] = ok_alloc && !fi;
        }
        __syncthreads();
    }

    // block 0: capacity commit of accepted proposals, per node in
    // task-index order (idle/rel: sum then subtract; nz: onto the carry
    // with ``fold_nz`` — phase 1, whose ``nz + segment_sum`` XLA folds
    // into the scatter — else summed, then added: the retry's)
    __device__ void commit_node(const uint8_t* acc, const int32_t* prop,
                                const uint8_t* pa, bool fold_nz) {
        uint64_t* keys = segment_keys([&](int k) {
            return acc[k] ? prop[k] : -1;
        });
        for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)n << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(n + 1) << 32);
            if (lo == hi) continue;
            float sa[3] = {0.0f, 0.0f, 0.0f}, sp[3] = {0.0f, 0.0f, 0.0f};
            float z0 = fold_nz ? p.nz[n * 2] : 0.0f;
            float z1 = fold_nz ? p.nz[n * 2 + 1] : 0.0f;
            for (int i = lo; i < hi; ++i) {
                const int k = (int)(keys[i] & 0xffffffffu);
                const int t = w.tmap[k];
                const bool al = pa[k];
                for (int r = 0; r < 3; ++r) {
                    const float v = p.resreq[t * 3 + r];
                    sa[r] = sa[r] + (al ? v : 0.0f);
                    sp[r] = sp[r] + (al ? 0.0f : v);
                }
                z0 = z0 + p.tnz[t * 2];
                z1 = z1 + p.tnz[t * 2 + 1];
            }
            for (int r = 0; r < 3; ++r) {
                p.idle[n * 3 + r] = p.idle[n * 3 + r] - sa[r];
                p.rel[n * 3 + r] = p.rel[n * 3 + r] - sp[r];
            }
            p.ntasks[n] += hi - lo;
            p.nz[n * 2] = fold_nz ? z0 : p.nz[n * 2] + z0;
            p.nz[n * 2 + 1] = fold_nz ? z1 : p.nz[n * 2 + 1] + z1;
        }
        __syncthreads();
    }

    // block 0: merge the phases, job / queue commits, decisions
    __device__ void commit_round(int round_idx) {
        const int tc = tcur();
        for (int k = threadIdx.x; k < tc; k += blockDim.x) {
            const bool ar = w.accr[k];
            w.accept[k] = w.acc1[k] || ar;
            if (ar) {
                w.ob1[k] = w.obr[k];
                w.prop1[k] = w.fbr[k];
                w.pa1[k] = w.par[k];
            }
        }
        __syncthreads();
        // j_allocated / alloc_cnt per job, onto the carry in index order
        uint64_t* keys = segment_keys([&](int k) {
            return w.accept[k] ? p.tjob[w.tmap[k]] : -1;
        });
        for (int j = threadIdx.x; j < p.J; j += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)j << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(j + 1) << 32);
            int cnt = 0;
            for (int i = lo; i < hi; ++i) {
                const int k = (int)(keys[i] & 0xffffffffu);
                const int t = w.tmap[k];
                for (int r = 0; r < 3; ++r)
                    w.j_alloc[j * 3 + r] = w.j_alloc[j * 3 + r]
                                           + p.resreq[t * 3 + r];
                cnt += w.ob1[k] ? 0 : 1;
            }
            w.alloc_cnt[j] += cnt;
            w.alive[j] = w.alive[j] && !(w.fail_rank[j] < IMAX);
        }
        __syncthreads();
        keys = segment_keys([&](int k) {
            return w.accept[k] ? p.jqueue[p.tjob[w.tmap[k]]] : -1;
        });
        for (int q = threadIdx.x; q < p.Q; q += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)q << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(q + 1) << 32);
            float s[3] = {w.q_alloc[q * 3], w.q_alloc[q * 3 + 1],
                          w.q_alloc[q * 3 + 2]};
            for (int i = lo; i < hi; ++i) {
                const int t = w.tmap[(int)(keys[i] & 0xffffffffu)];
                for (int r = 0; r < 3; ++r) s[r] = s[r] + p.resreq[t * 3 + r];
            }
            for (int r = 0; r < 3; ++r) w.q_alloc[q * 3 + r] = s[r];
        }
        __shared__ int s_changed;
        if (threadIdx.x == 0) s_changed = 0;
        __syncthreads();
        int changed = 0;
        for (int k = threadIdx.x; k < tc; k += blockDim.x) {
            const int t = w.tmap[k];
            const bool acc = w.accept[k], ff = w.fail_first[k];
            if (!acc && !ff) continue;
            changed = 1;
            int d;
            if (ff) d = FAIL;
            else if (!w.pa1[k]) d = PIPELINE;
            else d = w.ob1[k] ? ALLOC_OB : ALLOC;
            p.out[t] = d;
            if (acc) p.out[p.T + t] = w.prop1[k] + p.noff;
            p.out[2 * p.T + t] = round_idx * p.T + w.grank[k];
        }
        if (changed) s_changed = 1;
        __syncthreads();
        if (threadIdx.x == 0) w.iscal[S_PROGRESS] = s_changed;
    }

    // one round; returns progress (grid-uniform)
    __device__ bool run_round(int round_idx) {
        if (b0) {
            order_jobs();
            if (p.aff) aff_flags();
        }
        sync(PH_ORDER);
        engage();
        sync(PH_ENGAGE);
        if (b0) window();
        sync(PH_WINDOW);
        {
            const int tc = tcur();
            for (int k = gtid; k < tc; k += gsize) {
                const int j = wrap_job(p.tjob[w.tmap[k]], p.J);
                w.part[k] = w.engaged[k] && w.admitted[j];
            }
        }
        node_views();
        pair_scores();
        sync(PH_SCORES);
        if (p.aff) {
            aff_views();
            sync(PH_AFF_VIEWS);
        }
        if (b0) rank_tasks();
        row_pass(w.part, w.any_elig, w.fb, true);
        sync(PH_ROWS1);
        fail_and_kill();
        sync(PH_FAIL);
        settle_part2();
        sync(PH_PART2);
        if (b0) waterfall();
        sync(PH_WATERFALL);
        propose();
        sync(PH_PROPOSE);
        fit_kind(w.part2, w.prop1, w.pa1);
        sync(PH_FIT1);
        if (b0) {
            accept_phase(w.prop1, w.part2, w.pa1, w.acc1, w.ob1);
            if (!p.aff) commit_node(w.acc1, w.prop1, w.pa1, true);
        }
        sync(PH_ACCEPT1);
        if (p.aff) {
            // remove in-round affinity / port races before the capacity
            // commit
            if (b0) {
                aff_serialize();
                commit_node(w.acc1, w.prop1, w.pa1, true);
            }
            sync(PH_AFF_SERIALIZE);
        }
        // retry: rejected tasks re-propose their argmax against the
        // mid-round carry (the round's scores); affinity-involved tasks
        // sit it out
        node_views();
        {
            const int tc = tcur();
            for (int k = gtid; k < tc; k += gsize)
                w.mask[k] = w.part2[k] && !w.acc1[k]
                            && !(p.aff && involved(w.tmap[k]));
        }
        sync(PH_VIEWS2);
        row_pass(w.mask, w.any_elig, w.fbr, false);
        sync(PH_ROWS2);
        {
            const int tc = tcur();
            for (int k = gtid; k < tc; k += gsize)
                w.retry[k] = w.mask[k] && w.any_elig[k];
        }
        sync(PH_RETRY);
        fit_kind(w.retry, w.fbr, w.par);
        sync(PH_FIT2);
        if (b0) {
            accept_phase(w.fbr, w.retry, w.par, w.accr, w.obr);
            commit_node(w.accr, w.fbr, w.par, false);
            commit_round(round_idx);
        }
        sync(PH_ACCEPT2);
        if (p.aff) {
            if (b0) aff_commit();
            sync(PH_AFF_COMMIT);
        }
        return w.iscal[S_PROGRESS] != 0;
    }

    __device__ int rounds_loop(int start) {
        int r = start;
        bool progress = true;
        while (progress && r < p.max_rounds) {
            progress = run_round(r);
            ++r;
        }
        return r;
    }

    // ---- the task view -------------------------------------------------

    __device__ void full_view() {
        for (int k = gtid; k < p.T; k += gsize) {
            w.tmap[k] = k;
            w.vvalid[k] = p.tvalid[k];
        }
        if (gtid == 0) w.iscal[S_TCUR] = p.T;
    }

    // block 0: after round 0, the tasks that can still resolve; returns
    // their count in iscal[S_CNT] and, when 0 < count <= bucket, the
    // compact view (first ``bucket`` of them in index order, fill slots
    // point at the last task and are invalid)
    __device__ void compact_view() {
        const int T = p.T;
        for (int q = threadIdx.x; q < p.Q; q += blockDim.x) {
            bool over = true;
            for (int r = 0; r < 3 && over; ++r)
                over = p.qdes[q * 3 + r] < w.q_alloc[q * 3 + r] + p.eps[r];
            w.overused[q] = over;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const int j = max(p.tjob[t], 0);
            bool u = p.tvalid[t] && p.out[t] == SKIP && w.alive[j];
            if (p.prop_overused) u = u && !w.overused[p.jqueue[j]];
            w.unresolved[t] = u;
        }
        __syncthreads();
        // positions in index order: per-thread chunk counts, then a scan
        const int per = (T + NT - 1) / NT;
        const int a = threadIdx.x * per, b = min(a + per, T);
        int c = 0;
        for (int t = a; t < b; ++t) c += w.unresolved[t];
        w.chunk[threadIdx.x + 1] = c;
        __syncthreads();
        if (threadIdx.x == 0) {
            w.chunk[0] = 0;
            for (int i = 1; i <= NT; ++i) w.chunk[i] += w.chunk[i - 1];
            w.iscal[S_CNT] = w.chunk[NT];
        }
        __syncthreads();
        const int cnt = w.iscal[S_CNT];
        if (cnt == 0 || cnt > p.bucket) return;
        int pos = w.chunk[threadIdx.x];
        for (int t = a; t < b; ++t) {
            if (!w.unresolved[t]) continue;
            if (pos < p.bucket) {
                w.tmap[pos] = t;
                w.vvalid[pos] = p.tvalid[t];
            }
            ++pos;
        }
        for (int k = cnt + threadIdx.x; k < p.bucket; k += blockDim.x) {
            w.tmap[k] = T - 1;
            w.vvalid[k] = 0;
        }
        if (threadIdx.x == 0) w.iscal[S_TCUR] = p.bucket;
        __syncthreads();
    }

    // ---- stranded-gang epilogue (full width, block 0) -------------------

    __device__ bool placed(int t) const {
        const int s = p.out[t];
        return p.tvalid[t] && (s == ALLOC || s == ALLOC_OB || s == PIPELINE);
    }

    __device__ void stranded_jobs(bool include_killed) {
        for (int j = threadIdx.x; j < p.J; j += blockDim.x) {
            w.j_rows[j] = 0;
            w.j_placed[j] = 0;
            w.j_ob[j] = 0;
        }
        __syncthreads();
        for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
            const int j = max(p.tjob[t], 0);
            atomicOr(&w.j_rows[j], 1);
            if (placed(t)) atomicOr(&w.j_placed[j], 1);
            if (p.tvalid[t] && p.out[t] == ALLOC_OB) atomicAdd(&w.j_ob[j], 1);
        }
        __shared__ int s_any, s_count;
        if (threadIdx.x == 0) { s_any = 0; s_count = 0; }
        __syncthreads();
        int any = 0, count = 0;
        for (int j = threadIdx.x; j < p.J; j += blockDim.x) {
            // segment_max's identity (int32 min) is truthy: a job with no
            // task row reads as placed, as in the reference
            const bool jp = !w.j_rows[j] || w.j_placed[j];
            const bool ready = w.alloc_cnt[j] + w.j_ob[j] >= p.omin[j];
            bool s = p.jvalid[j] && jp && !ready;
            if (!include_killed) s = s && w.alive[j];
            w.stranded[j] = s;
            any |= s;
            count += s;
        }
        if (any) atomicOr(&s_any, 1);
        if (count) atomicAdd(&s_count, count);
        __syncthreads();
        if (threadIdx.x == 0) {
            w.iscal[S_ANY_STRANDED] = s_any;
            w.iscal[S_STRANDED] = s_count;
        }
        __syncthreads();
    }

    __device__ void rollback(bool revive) {
        stranded_jobs(revive);
        const int T = p.T;
        for (int t = threadIdx.x; t < T; t += blockDim.x)
            w.mask[t] = placed(t) && w.stranded[max(p.tjob[t], 0)];
        __syncthreads();
        // node carry: idle / rel onto the carry, nz summed then subtracted
        uint64_t* keys = segment_keys([&](int t) {
            return w.mask[t] ? p.out[T + t] : -1;
        });
        for (int n = threadIdx.x; n < p.N; n += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)n << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(n + 1) << 32);
            if (lo == hi) continue;
            float id[3], rl[3], z[2] = {0.0f, 0.0f};
            for (int r = 0; r < 3; ++r) {
                id[r] = p.idle[n * 3 + r];
                rl[r] = p.rel[n * 3 + r];
            }
            for (int i = lo; i < hi; ++i) {
                const int t = (int)(keys[i] & 0xffffffffu);
                const bool pipe = p.out[t] == PIPELINE;
                for (int r = 0; r < 3; ++r) {
                    const float v = p.resreq[t * 3 + r];
                    id[r] = id[r] + (pipe ? 0.0f : v);
                    rl[r] = rl[r] + (pipe ? v : 0.0f);
                }
                z[0] = z[0] + p.tnz[t * 2];
                z[1] = z[1] + p.tnz[t * 2 + 1];
            }
            for (int r = 0; r < 3; ++r) {
                p.idle[n * 3 + r] = id[r];
                p.rel[n * 3 + r] = rl[r];
            }
            p.ntasks[n] -= hi - lo;
            p.nz[n * 2] = p.nz[n * 2] - z[0];
            p.nz[n * 2 + 1] = p.nz[n * 2 + 1] - z[1];
        }
        __syncthreads();
        // jobs: j_allocated summed then subtracted, alloc_cnt
        keys = segment_keys([&](int t) {
            return w.mask[t] ? p.tjob[t] : -1;
        });
        for (int j = threadIdx.x; j < p.J; j += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)j << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(j + 1) << 32);
            if (lo < hi) {
                float s[3] = {0.0f, 0.0f, 0.0f};
                int cnt = 0;
                for (int i = lo; i < hi; ++i) {
                    const int t = (int)(keys[i] & 0xffffffffu);
                    for (int r = 0; r < 3; ++r) s[r] = s[r]
                                                       + p.resreq[t * 3 + r];
                    cnt += p.out[t] != ALLOC_OB;
                }
                for (int r = 0; r < 3; ++r)
                    w.j_alloc[j * 3 + r] = w.j_alloc[j * 3 + r] - s[r];
                w.alloc_cnt[j] -= cnt;
            }
            w.alive[j] = revive ? (w.alive[j] || w.stranded[j])
                                : (w.alive[j] && !w.stranded[j]);
        }
        __syncthreads();
        keys = segment_keys([&](int t) {
            return w.mask[t] ? p.jqueue[p.tjob[t]] : -1;
        });
        for (int q = threadIdx.x; q < p.Q; q += blockDim.x) {
            const int lo = lower_bound_u64(keys, p.MT, (uint64_t)q << 32);
            const int hi = lower_bound_u64(keys, p.MT,
                                           (uint64_t)(q + 1) << 32);
            if (lo == hi) continue;
            float s[3] = {0.0f, 0.0f, 0.0f};
            for (int i = lo; i < hi; ++i) {
                const int t = (int)(keys[i] & 0xffffffffu);
                for (int r = 0; r < 3; ++r) s[r] = s[r] + p.resreq[t * 3 + r];
            }
            for (int r = 0; r < 3; ++r)
                w.q_alloc[q * 3 + r] = w.q_alloc[q * 3 + r] - s[r];
        }
        __syncthreads();
        if (p.aff) {
            // the carry's exact inverse (reference _aff_rollback)
            for (int t = threadIdx.x; t < T; t += blockDim.x)
                if (w.mask[t]) aff_apply(t, max(p.out[T + t], 0), -1);
            __syncthreads();
        }
        for (int t = threadIdx.x; t < T; t += blockDim.x) {
            const bool strand = w.stranded[max(p.tjob[t], 0)];
            const bool clear = w.mask[t]
                || (revive && p.out[t] == FAIL && strand);
            if (clear) p.out[t] = SKIP;
        }
        __syncthreads();
    }

    // block 0: the telemetry frame after the round count; the two-level
    // solves add their engine id, first-wave pool occupancy and fill,
    // and the active set's four words (act: null for zeros)
    __device__ void frame(int rounds, int retries, int stranded,
                          int engine = ENGINE_BATCHED, int occ = 0,
                          int fill = 0, const int32_t* act = nullptr) {
        __shared__ int s_cnt[4 + WAVE_SLOTS];
        if (threadIdx.x < 4 + WAVE_SLOTS) s_cnt[threadIdx.x] = 0;
        __syncthreads();
        int c[4 + WAVE_SLOTS] = {0};
        for (int t = threadIdx.x; t < p.T; t += blockDim.x) {
            if (!p.tvalid[t]) continue;
            const int s = p.out[t];
            const bool pl = s == ALLOC || s == ALLOC_OB || s == PIPELINE;
            c[0] += pl;
            c[1] += s == FAIL;
            c[2] += s == SKIP;
            c[3] += 1;
            if (pl) {
                const int slot = min(max(p.out[2 * p.T + t] / p.T, 0),
                                     WAVE_SLOTS - 1);
                c[4 + slot] += 1;
            }
        }
        for (int i = 0; i < 4 + WAVE_SLOTS; ++i)
            if (c[i]) atomicAdd(&s_cnt[i], c[i]);
        __syncthreads();
        if (threadIdx.x == 0) {
            int32_t* f = p.out + 3 * p.T;
            f[0] = rounds;
            int32_t* fr = f + 1;
            fr[0] = engine;
            fr[1] = rounds;
            for (int i = 0; i < 4; ++i) fr[2 + i] = s_cnt[i];
            for (int i = 0; i < WAVE_SLOTS; ++i) fr[6 + i] = s_cnt[4 + i];
            fr[10] = occ;
            fr[11] = fill;
            fr[12] = p.narrow;
            fr[13] = p.narrow_gate;
            fr[14] = retries;
            fr[15] = stranded;
            for (int i = 0; i < 4; ++i) fr[16 + i] = act ? act[i] : 0;
        }
        __syncthreads();
    }

    __device__ void run() {
        if (gtid == 0) t_last = now_ns();
        // initial carry
        for (int i = gtid; i < p.Q * 3; i += gsize)
            w.q_alloc[i] = p.qalloc0[i];
        for (int i = gtid; i < p.J * 3; i += gsize)
            w.j_alloc[i] = p.jalloc0[i];
        for (int j = gtid; j < p.J; j += gsize) {
            w.alloc_cnt[j] = p.init_alloc[j];
            w.alive[j] = p.jvalid[j];
        }
        for (int t = gtid; t < p.T; t += gsize) {
            p.out[t] = SKIP;
            p.out[p.T + t] = -1;
            p.out[2 * p.T + t] = IMAX;
        }
        full_view();
        if (p.aff) aff_setup();
        sync(PH_SETUP);
        int rounds;
        if (p.bucket <= 0 || p.bucket >= p.T) {
            rounds = rounds_loop(0);
        } else {
            run_round(0);
            if (b0) compact_view();
            sync(PH_COMPACT);
            const int cnt = w.iscal[S_CNT];
            if (cnt > p.bucket) {
                rounds = rounds_loop(1);
            } else if (cnt == 0) {
                rounds = 1;
            } else {
                rounds = rounds_loop(1);
                full_view();
                sync(PH_COMPACT);
            }
        }
        int retries = 0, stranded = 0;
        if (p.gang) {
            while (true) {
                if (b0) stranded_jobs(true);
                sync(PH_EPILOGUE);
                if (retries >= 3 || !w.iscal[S_ANY_STRANDED]) break;
                if (b0) rollback(true);
                sync(PH_EPILOGUE);
                rounds = rounds_loop(rounds);
                ++retries;
            }
            if (b0) rollback(false);
            sync(PH_EPILOGUE);
            stranded = w.iscal[S_STRANDED];
        }
        if (b0) frame(rounds, retries, stranded);
        if (p.aff) aff_write_out();
    }
};

Params make_params(const uint64_t* ptrs, const int* ints) {
    Params p;
    p.idle = (float*)ptrs[P_IDLE];
    p.rel = (float*)ptrs[P_REL];
    p.ntasks = (int32_t*)ptrs[P_NTASKS];
    p.nz = (float*)ptrs[P_NZ];
    p.bf = (const float*)ptrs[P_BF];
    p.cap = (const float*)ptrs[P_CAP];
    p.maxt = (const int32_t*)ptrs[P_MAXT];
    p.node_ok = (const uint8_t*)ptrs[P_NODE_OK];
    p.resreq = (const float*)ptrs[P_RESREQ];
    p.init = (const float*)ptrs[P_INIT];
    p.tnz = (const float*)ptrs[P_TNZ];
    p.tjob = (const int32_t*)ptrs[P_TJOB];
    p.trank = (const int32_t*)ptrs[P_TRANK];
    p.tsig = (const int32_t*)ptrs[P_TSIG];
    p.tpair = (const int32_t*)ptrs[P_TPAIR];
    p.tvalid = (const uint8_t*)ptrs[P_TVALID];
    p.sig_scores = (const float*)ptrs[P_SIG_SCORES];
    p.sig_pred = (const uint8_t*)ptrs[P_SIG_PRED];
    p.pair_sig = (const int32_t*)ptrs[P_PAIR_SIG];
    p.pair_nz = (const float*)ptrs[P_PAIR_NZ];
    p.omin = (const int32_t*)ptrs[P_OMIN];
    p.init_alloc = (const int32_t*)ptrs[P_INIT_ALLOC];
    p.jqueue = (const int32_t*)ptrs[P_JQUEUE];
    p.jprio = (const float*)ptrs[P_JPRIO];
    p.jcrank = (const int32_t*)ptrs[P_JCRANK];
    p.jvalid = (const uint8_t*)ptrs[P_JVALID];
    p.qdes = (const float*)ptrs[P_QDES];
    p.qcrank = (const int32_t*)ptrs[P_QCRANK];
    p.qalloc0 = (const float*)ptrs[P_QALLOC0];
    p.jalloc0 = (const float*)ptrs[P_JALLOC0];
    p.ctotal = (const float*)ptrs[P_CTOTAL];
    p.dynw = (const float*)ptrs[P_DYNW];
    p.eps = (const float*)ptrs[P_EPS];
    p.out = (int32_t*)ptrs[P_OUT];
    p.phase_ns = (unsigned long long*)ptrs[P_PHASE];
    p.N = ints[I_N]; p.T = ints[I_T]; p.J = ints[I_J]; p.Q = ints[I_Q];
    p.P = ints[I_P]; p.njk = ints[I_NJK];
    p.jk[0] = ints[I_JK0]; p.jk[1] = ints[I_JK1]; p.jk[2] = ints[I_JK2];
    p.qshare = ints[I_QSHARE]; p.prop_overused = ints[I_PROP_OVERUSED];
    p.dyn = ints[I_DYN]; p.pipe = ints[I_PIPE];
    p.max_rounds = ints[I_MAX_ROUNDS]; p.bucket = ints[I_BUCKET];
    p.gang = ints[I_GANG]; p.narrow = ints[I_NARROW];
    p.narrow_gate = ints[I_NARROW_GATE];
    p.MT = pow2_at_least(p.T);
    p.MJ = pow2_at_least(p.J);
    p.MN = pow2_at_least(p.N);
    p.NS = p.N;
    p.noff = 0;
    p.elsewhere = nullptr;
    p.pair_init = nullptr;
    p.dyn_fma = 0;
    p.aff = ints[I_AFF]; p.A = ints[I_A]; p.D = ints[I_D];
    p.PT = ints[I_PT]; p.ip = ints[I_IP];
    p.node_dom = (const int32_t*)ptrs[P_NODE_DOM];
    p.tgrp = (const uint8_t*)ptrs[P_TGRP];
    p.treq = (const uint8_t*)ptrs[P_TREQ_AFF];
    p.tanti = (const uint8_t*)ptrs[P_TREQ_ANTI];
    p.tself = (const uint8_t*)ptrs[P_TSELF_OK];
    p.tcarry = (const float*)ptrs[P_TCARRY_W];
    p.tpref = (const float*)ptrs[P_TPREF_W];
    p.gcnt0 = (const float*)ptrs[P_GCNT0];
    p.acnt0 = (const float*)ptrs[P_ACNT0];
    p.prefw0 = (const float*)ptrs[P_PREFW0];
    p.gtot0 = (const float*)ptrs[P_GTOT0];
    p.tports = (const uint8_t*)ptrs[P_TPORTS];
    p.pbase = (const uint8_t*)ptrs[P_PORT_BASE];
    p.ipw = (const float*)ptrs[P_IPW];
    p.gcnt_out = (float*)ptrs[P_GCNT_OUT];
    p.acnt_out = (float*)ptrs[P_ACNT_OUT];
    p.prefw_out = (float*)ptrs[P_PREFW_OUT];
    p.gtot_out = (float*)ptrs[P_GTOT_OUT];
    p.pclaim_out = (uint8_t*)ptrs[P_PCLAIM_OUT];
    return p;
}

size_t smem_bytes(const Params& p) {
    const int m = std::max(p.MT, std::max(p.MJ, p.MN));
    return (size_t)std::min(m, SMEM_KEYS) * sizeof(uint64_t);
}

}  // namespace
