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
//
// Bound: neither bytes nor operations. A step moves ~0.3 MB (the
// gathered rows, the block's carry and its packed rows) and does a few
// dozen operations a node; what a launch costs is its chain of dependent
// steps: the argmax loads, the reduction, the decision, the pack. The
// design shortens that chain and spreads it over the card:
//  - one thread-block cluster of C CTAs (C the power of two, at most 8,
//    that leaves each CTA at most kRowsPerCta gathered rows; one CTA for
//    small steps), launched with cudaLaunchKernelEx;
//  - the argmax: CTA c reads a contiguous 1/C of the gathered rows,
//    kRowsPerThread a thread, words 0, 1, 2 and 4 loaded at once before
//    anything else. Each row becomes one 64-bit key (its score's
//    order-preserving bits, the complement of its row, its fit bits), so
//    the reference's order (the first maximum; node 0 when every row is
//    -inf) is the largest key and the winner's fit bits ride with it: no
//    load waits on the winner. Two warp reductions a warp; after one
//    cluster barrier every CTA's warp 0 reads all C x kWarps warp keys
//    through distributed shared memory and reduces them, so every CTA
//    knows the winner and the decision without a second barrier;
//  - the decision: CTA 0's thread 0 writes the decision, the node and
//    the state; every CTA read the state before the cluster barrier, so
//    no CTA reads it after that write;
//  - the pack: CTA c packs a contiguous 1/C of the block's nodes, one a
//    thread. Its inputs are loaded at the start of the launch (they do
//    not depend on the step's winner), and the thread that owns the
//    winner takes the request off that node in its registers and writes
//    the carry back; the 5-word rows are staged in shared memory and
//    stored as contiguous words;
//  - no CTA leaves before every CTA has read its result (the second
//    phase of a split cluster barrier, arrived at after the reads).
// CTA 0's thread 0 times the phases on the global timer (argmax up to
// the winner, the decision, the pack up to the end), added to three
// uint64 words a rank (phase_ns, may be null).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;
constexpr int kWarps = NT / 32;
constexpr int W = 5;
constexpr int kMaxCluster = 8;
constexpr int kRowsPerCta = 1024;
constexpr int kRowsPerThread = kRowsPerCta / NT;
constexpr int kNoRow = 0x1fffffff;            // rows are below 2^29
enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };
enum { PH_ARGMAX, PH_DECISION, PH_PACK, N_PHASES };
// the winner's fit bits: fit_alloc (word 1), fit_idle (word 2),
// eligible (word 4), each "> 0" as a float
enum { F_ALLOC = 1, F_IDLE = 2, F_ELIG = 4 };

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
    unsigned long long* phase_ns;          // [N_PHASES] or null
    int t, steps, nb, lo, k, C;
};

__host__ __device__ int cluster_of(long long n) {
    int C = 1;
    while (C < kMaxCluster && (long long)C * kRowsPerCta < n) C *= 2;
    return C;
}

// A gathered row's argmax key: its score's order-preserving bits (-0.0
// as +0.0) above kNoRow - row, its three fit bits below. The largest key
// is the reference's first maximum, and every row's key is above 0.
__device__ __forceinline__ unsigned long long row_key(const int32_t* row,
                                                      int i) {
    const float v = __int_as_float(row[0]);
    const unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
    const unsigned u = b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
    const unsigned f = (__int_as_float(row[1]) > 0.0f ? F_ALLOC : 0)
                       | (__int_as_float(row[2]) > 0.0f ? F_IDLE : 0)
                       | (__int_as_float(row[4]) > 0.0f ? F_ELIG : 0);
    return ((unsigned long long)u << 32) | ((unsigned)(kNoRow - i) << 3) | f;
}

__device__ __forceinline__ unsigned long long kmax(unsigned long long a,
                                                   unsigned long long b) {
    return a > b ? a : b;
}

// the warp's largest key: two reductions (the high words, then the low
// words of the lanes that hold the largest high word)
__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
    const unsigned hi = (unsigned)(k >> 32);
    const unsigned mh = __reduce_max_sync(0xffffffffu, hi);
    const unsigned ml = __reduce_max_sync(0xffffffffu,
                                          hi == mh ? (unsigned)k : 0u);
    return ((unsigned long long)mh << 32) | ml;
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(NT, 1)
sharded_scan_kernel(const __grid_constant__ Args a) {
    __shared__ unsigned long long s_key[kWarps];   // this CTA's warps' keys
    __shared__ unsigned long long s_best;          // the cluster's winner
    __shared__ int32_t s_out[NT * W];      // this pass's packed rows
    cg::cluster_group cl = cg::this_cluster();
    const int C = a.C, rank = (int)blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int t = a.t, u = t + 1;
    const bool pack = u < a.steps;
    const bool timer = rank == 0 && tid == 0 && a.phase_ns != nullptr;
    unsigned long long ph[N_PHASES] = {0, 0, 0}, t_last = 0;
    if (timer) t_last = now_ns();
#define MARK(p)                                  \
    do {                                         \
        if (timer) {                             \
            const unsigned long long t_ = now_ns(); \
            ph[p] += t_ - t_last;                \
            t_last = t_;                         \
        }                                        \
    } while (0)

    // this CTA's gathered rows, kRowsPerThread a thread at once, before
    // the pack's loads
    const int n = a.k * a.nb;
    const int per = (n + C - 1) / C;
    const int r0 = min(n, rank * per), r1 = min(n, r0 + per);
    unsigned long long key = 0ull;
    if (t >= 0)
        for (int base = r0; base < r1; base += NT * kRowsPerThread) {
#pragma unroll
            for (int j = 0; j < kRowsPerThread; ++j) {
                const int i = base + j * NT + tid;
                if (i < r1) key = kmax(key, row_key(a.in + (size_t)i * W, i));
            }
        }
    // this CTA's nodes of the pack; node p0 + tid's inputs load now
    const int share = (a.nb + C - 1) / C;
    const int p0 = min(a.nb, rank * share), p1 = min(a.nb, p0 + share);
    const int i0 = p0 + tid;
    const bool have0 = i0 < p1;
    float idle3[3] = {0.f, 0.f, 0.f}, bf3[3] = {0.f, 0.f, 0.f},
          rel3[3] = {0.f, 0.f, 0.f};
    int nt0 = 0, mt0 = 0;
    bool ok0 = false, pr0 = false;
    float sc0 = 0.f;
    if (have0) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            idle3[r] = a.idle[i0 * 3 + r];
            rel3[r] = a.rel[i0 * 3 + r];
            bf3[r] = a.bf[i0 * 3 + r];
        }
        nt0 = a.ntasks[i0];
        mt0 = a.maxt[i0];
        ok0 = a.node_ok[i0] != 0;
        if (pack) {
            pr0 = a.pred[(size_t)u * a.nb + i0] != 0;
            sc0 = a.scores[(size_t)u * a.nb + i0];
        }
    }
    float in3[3] = {0.f, 0.f, 0.f}, eps3[3] = {0.f, 0.f, 0.f};
    if (pack) {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            in3[r] = a.init[u * 3 + r];
            eps3[r] = a.eps[r];
        }
    }

    bool take = false, is_alloc = false;
    int local = -1;
    float q[3] = {0.f, 0.f, 0.f};
    if (t >= 0) {
        // the step's state, read before the cluster barrier: CTA 0 writes
        // it only after that barrier
        const int st0 = a.state[0], st1 = a.state[1];
        const bool valid_t = a.valid[t] != 0;
        const int min_av = a.min_av[0];
#pragma unroll
        for (int r = 0; r < 3; ++r) q[r] = a.resreq[t * 3 + r];
        key = warp_max(key);
        if (lane == 0) s_key[warp] = key;
        if (C > 1)
            cl.sync();
        else
            __syncthreads();
        if (warp == 0) {
            // every CTA's warps' keys, through distributed shared memory
            unsigned long long k = 0ull;
            for (int x = lane; x < C * kWarps; x += 32)
                k = kmax(k, cl.map_shared_rank(s_key, x / kWarps)[x % kWarps]);
            k = warp_max(k);
            if (lane == 0) s_best = k;
        }
        __syncthreads();
        // this CTA has read every remote key
        if (C > 1) cluster_arrive();
        MARK(PH_ARGMAX);
        const int best = kNoRow - (int)((unsigned)s_best >> 3);
        const int f = (int)(s_best & 7u);
        const bool feasible = (f & F_ELIG) != 0;
        is_alloc = (f & F_ALLOC) != 0;
        const bool over_bf = is_alloc && !(f & F_IDLE);
        const bool active = valid_t && !st1;
        take = active && feasible;
        if (rank == 0 && tid == 0) {
            const int d = !active ? SKIP
                        : !feasible ? FAIL
                        : !is_alloc ? PIPELINE
                        : over_bf ? ALLOC_OB : ALLOC;
            const int allocated = st0 + ((take && !over_bf) ? 1 : 0);
            a.state[0] = allocated;
            a.state[1] = st1 || (active && !feasible)
                         || (take && allocated >= min_av);
            a.decision[t] = d;
            a.node_idx[t] = best;
        }
        local = best - a.lo;
        MARK(PH_DECISION);
    }
    const float ma = is_alloc ? 1.0f : 0.0f;
    const float mp = is_alloc ? 0.0f : 1.0f;
    // the winner's carry, by the one thread that packs it
    if (take && local >= p0 && local < p1 && (local - p0) % NT == tid) {
        if (local == i0) {
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                idle3[r] = idle3[r] - ma * q[r];
                rel3[r] = rel3[r] - mp * q[r];
                a.idle[local * 3 + r] = idle3[r];
                a.rel[local * 3 + r] = rel3[r];
            }
            nt0 += 1;
            a.ntasks[local] = nt0;
        } else {
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                a.idle[local * 3 + r] = a.idle[local * 3 + r] - ma * q[r];
                a.rel[local * 3 + r] = a.rel[local * 3 + r] - mp * q[r];
            }
            a.ntasks[local] += 1;
        }
    }
    if (pack) {
        for (int base = p0; base < p1; base += NT) {
            const int i = base + tid;
            if (i < p1) {
                if (i != i0) {
#pragma unroll
                    for (int r = 0; r < 3; ++r) {
                        idle3[r] = a.idle[i * 3 + r];
                        rel3[r] = a.rel[i * 3 + r];
                        bf3[r] = a.bf[i * 3 + r];
                    }
                    nt0 = a.ntasks[i];
                    mt0 = a.maxt[i];
                    ok0 = a.node_ok[i] != 0;
                    pr0 = a.pred[(size_t)u * a.nb + i] != 0;
                    sc0 = a.scores[(size_t)u * a.nb + i];
                }
                bool fa = true, fi = true, fp = true;
#pragma unroll
                for (int r = 0; r < 3; ++r) {
                    const float acc = idle3[r] + bf3[r];
                    fa = fa && in3[r] <= acc + eps3[r];
                    fi = fi && in3[r] <= idle3[r] + eps3[r];
                    fp = fp && in3[r] <= rel3[r] + eps3[r];
                }
                const bool room = nt0 < mt0;
                const bool pr = ok0 && room && pr0;
                const bool el = pr && (fa || fp);
                int32_t* o = s_out + tid * W;
                o[0] = __float_as_int(el ? sc0 : -INFINITY);
                o[1] = __float_as_int(fa ? 1.0f : 0.0f);
                o[2] = __float_as_int(fi ? 1.0f : 0.0f);
                o[3] = __float_as_int(fp ? 1.0f : 0.0f);
                o[4] = __float_as_int(el ? 1.0f : 0.0f);
            }
            __syncthreads();
            const int words = min(NT, p1 - base) * W;
            int32_t* dst = a.out + (size_t)base * W;
            for (int w = tid; w < words; w += NT) dst[w] = s_out[w];
            __syncthreads();
        }
    }
    // no CTA leaves while another may still read its result
    if (t >= 0 && C > 1) cluster_wait();
    MARK(PH_PACK);
#undef MARK
    if (timer)
        for (int p = 0; p < N_PHASES; ++p) a.phase_ns[p] += ph[p];
}

}  // namespace

// Launch one step. ptrs: N_PTRS device addresses in the P_* order (the
// block's carry and static rows, the [T, nb] scores / predicates, the
// task rows, eps, min_available, the state and the outputs); ints:
// N_INTS (the step t to apply, -1 for the first pack; the steps T; the
// block's size and first node; the world size); in: the gathered rows of
// step t (null when t < 0); out: the block's rows of step t + 1;
// phase_ns: N_PHASES uint64 the launch adds its phase times to (may be
// null). Returns the cudaError_t of the launch; a refused launch is
// returned, never retried another way.
extern "C" int kb_sharded_scan(const unsigned long long* ptrs, int n_ptrs,
                               const int* ints, int n_ints, void* in,
                               void* out, void* phase_ns, void* stream) {
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
    a.phase_ns = (unsigned long long*)phase_ns;
    a.t = ints[I_T];
    a.steps = ints[I_STEPS];
    a.nb = ints[I_NB];
    a.lo = ints[I_LO];
    a.k = ints[I_K];
    if (a.nb < 1 || a.k < 1 || a.t >= a.steps || (a.t >= 0 && !a.in)
        || (a.t + 1 < a.steps && !a.out))
        return (int)cudaErrorInvalidValue;
    a.C = cluster_of((long long)a.k * a.nb);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)a.C);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, sharded_scan_kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The cluster of a step over k ranks of nb nodes: writes C, the gathered
// rows a CTA reduces and the block's nodes a CTA packs into info[3].
extern "C" int kb_sharded_scan_shape(int k, int nb, int* info) {
    if (k < 1 || nb < 1) return (int)cudaErrorInvalidValue;
    const long long n = (long long)k * nb;
    const int C = cluster_of(n);
    info[0] = C;
    info[1] = (int)((n + C - 1) / C);
    info[2] = (nb + C - 1) / C;
    return 0;
}
