// The unschedulability explainer's per-task failure counts, one launch.
//
// Replaces kubebatch_tpu/obs/explain.py:57 _explain_kernel (the jitted
// [T, N] reduction behind failure_counts_device). For every task row t
// it counts, over the candidate nodes (node_ok), the nodes that fail
// each reason, and the nodes that pass all of them:
//   col 0  predicate      sig_pred[task_sig[t], n] is false
//   col 1  resources      some d in 0..2 has !(resreq[t, d] <= idle[n, d])
//                         (the plain float compare: no epsilon, no
//                         arithmetic, so no rounding question)
//   col 2  task-slots     !(n_tasks[n] < max_task_num[n])
//   col 3  port-conflict  a port the task requires is claimed on n
//                         (has_ports only; else the column is 0)
//   col 4  eligible       the node fails none of the four
//   col 5  n_cand         the candidate count, on every row
// Columns 0-4 are 0 on a padded task row (task_valid false). All counts
// are integers, so the result equals the plain version bit for bit.
//
// Bound: operations. The inputs are a few MB at the largest shipped
// shape (T_pad 16,384 x N_pad 8,192: sig_pred is [S_pad, N_pad] bytes
// with a handful of signature rows), while the work is a few compares and
// integer operations per (real task, candidate node) cell: 5e7 cells at
// cfg5. The predicate column depends only on (signature, node) and the
// task-slots column only on the node, so neither is counted cell by
// cell. The design:
//  - a CTA of kThreads threads owns a tile of kTileRows task rows, kRows
//    a thread, and keeps each row's request, signature, port word and
//    counters in registers. A tile with no valid row walks no node: it
//    only counts the candidates (column 5) and writes its rows; a warp
//    with no valid row skips the cells;
//  - the node axis is cut into chunks of K raw nodes (K = kThreads, less
//    when a small N would leave the cluster short of chunks or many
//    signatures need the room), dealt to the C CTAs of a thread-block
//    cluster (C = min(kMaxCluster, chunks)) that share the tile; each CTA
//    walks its own chunks only;
//  - a chunk is staged with cp.async (16-byte units where the rows are
//    aligned) in a ring of two stages: the next chunk's raw rows (idle,
//    n_tasks, max_task_num, node_ok, the port bytes and, when they fit,
//    the signatures' predicate bytes) land in shared memory while this
//    chunk is compacted and counted;
//  - each staged chunk is compacted to its candidate nodes only: every
//    candidate becomes one 16-byte word (its idle triple) and one 64-bit
//    port word; the predicate of every signature and the free-slot bit
//    become words of 32 candidates, one warp ballot each;
//  - a cell is then a broadcast shared-memory load of the node word (and
//    the port word), the three request compares and one bit set in the
//    row's word of 32 results (and the port AND, its zero test and one
//    bit more); per 32 candidates the columns are popcounts: resources of
//    the result word, port-conflict of the conflict word, predicate of
//    the signature's word, eligible of the four ANDed with the slot word;
//    the task-slots column is one count per chunk;
//  - the C CTAs' partial counts are summed exactly through distributed
//    shared memory after one cluster barrier, each CTA writing 1/C of the
//    tile's rows.
// CTA 0's thread 0 times the phases on the global timer (phase_ns: the
// ring's waits, compaction, cells, the cluster sum; may be null).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                       // task rows a thread
constexpr int kTileRows = kThreads * kRows;
constexpr int kMaxChunk = kThreads;            // one raw node a thread
constexpr int kMaxCluster = 16;
constexpr int kMinBlocks = 3;                  // CTAs an SM, registers
constexpr int kSmemBudget = 96 * 1024;         // two CTAs an SM at least
enum { PH_STAGE, PH_COMPACT, PH_CELLS, PH_REDUCE, N_PHASES };

__host__ __device__ inline size_t up16(size_t x) {
    return (x + 15) & ~(size_t)15;
}

// The shared-memory layout of one launch: two raw stages, the compacted
// chunk, the tile's partial counts.
struct Layout {
    int K, staged, ports, S, PT;
    size_t idle, nt, mt, ok, port, pred, raw;   // offsets in a raw stage
    size_t c_node, c_port, c_idx, c_pw, c_slot; // offsets past the stages
    size_t part, total;

    __host__ __device__ Layout(int K_, int staged_, int ports_, int S_,
                               int PT_)
        : K(K_), staged(staged_), ports(ports_), S(S_), PT(PT_) {
        size_t o = 0;
        idle = o; o += up16((size_t)12 * K);
        nt = o; o += up16((size_t)4 * K);
        mt = o; o += up16((size_t)4 * K);
        ok = o; o += up16((size_t)K + 4);
        port = o; o += ports ? up16((size_t)K * PT + 4) : 0;
        pred = o; o += staged ? (size_t)S * pred_stride() : 0;
        raw = o;
        o = 2 * raw;
        c_node = o; o += (size_t)16 * K;
        c_port = o; o += ports ? (size_t)8 * K : 0;
        c_idx = o; o += up16((size_t)4 * K);
        c_pw = o; o += up16((size_t)4 * S * (K / 32));
        c_slot = o; o += up16((size_t)4 * (K / 32));
        part = o; o += (size_t)16 * kTileRows;
        total = o;
    }
    // a staged predicate row: K bytes and the unit before a 4-byte start
    __host__ __device__ size_t pred_stride() const { return (size_t)K + 16; }
};

// The chunk size and whether the predicate bytes are staged: the largest
// chunk (at most kMaxChunk, and no more than leaves kMaxCluster chunks
// when N allows) whose layout fits the budget, staged when that fits too.
__host__ inline Layout plan(int n_pad, int S, int PT, int ports) {
    int K = kMaxChunk;
    while (K > 32 && (long long)(K / 2) * kMaxCluster >= n_pad) K /= 2;
    for (; K >= 32; K /= 2)
        for (int staged = 1; staged >= 0; --staged) {
            Layout L(K, staged, ports, S, PT);
            if (L.total <= (size_t)kSmemBudget) return L;
        }
    for (int staged = 1; staged >= 0; --staged) {
        Layout L(32, staged, ports, S, PT);
        if (L.total <= (size_t)227 * 1024) return L;
    }
    return Layout(32, 0, ports, S, PT);
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* g,
                                          int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(g), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* g,
                                           int src_bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(g), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy bytes [lo, hi) of a global array of ``size`` bytes (4-byte
// aligned) to dst (16-byte aligned): in 16-byte units from lo when that
// address is 16-byte aligned, else in 4-byte units from lo & ~3 (dst[lo &
// 3] is byte lo); a unit past the array's end is zero-filled.
__device__ __forceinline__ void stage(uint8_t* dst, const uint8_t* g,
                                      long long lo, long long hi,
                                      long long size) {
    if ((((uintptr_t)(g + lo)) & 15) == 0) {
        const int units = (int)((hi - lo + 15) >> 4);
        for (int u = threadIdx.x; u < units; u += kThreads) {
            const long long a = lo + 16LL * u;
            cp_async16(dst + 16 * u, g + a, (int)min(16LL, size - a));
        }
        return;
    }
    const long long a0 = lo & ~3LL;
    const int units = (int)((hi - a0 + 3) >> 2);
    for (int u = threadIdx.x; u < units; u += kThreads) {
        const long long a = a0 + 4LL * u;
        cp_async4(dst + 4 * u, g + a, (int)min(4LL, size - a));
    }
}

// The S rows' bytes [s N + lo, s N + hi) of a global [S, N] byte array
// (4-byte aligned) to dst + s * stride (16-byte aligned), every row's
// units dealt over the CTA at once: 16-byte units when every row start is
// 16-byte aligned, else 4-byte units from each row start & ~3 (dst[s *
// stride + ((s N + lo) & 3)] is the row's byte lo).
__device__ __forceinline__ void stage_rows(uint8_t* dst, size_t stride,
                                           const uint8_t* g, int S, int N,
                                           long long lo, long long hi) {
    const long long size = (long long)S * N;
    if ((((uintptr_t)(g + lo)) & 15) == 0 && N % 16 == 0) {
        const int per = (int)((hi - lo + 15) >> 4);
        for (int x = threadIdx.x; x < S * per; x += kThreads) {
            const int s = x / per, u = x - s * per;
            const long long a = (long long)s * N + lo + 16LL * u;
            cp_async16(dst + s * stride + 16 * u, g + a,
                       (int)min(16LL, size - a));
        }
        return;
    }
    const int per = (int)((hi - lo + 6) >> 2);
    for (int x = threadIdx.x; x < S * per; x += kThreads) {
        const int s = x / per, u = x - s * per;
        const long long a0 = ((long long)s * N + lo) & ~3LL;
        const long long a = a0 + 4LL * u;
        if (a < (long long)s * N + hi)
            cp_async4(dst + s * stride + 4 * u, g + a,
                      (int)min(4LL, size - a));
    }
}

struct Args {
    const float* idle; const uint8_t* node_ok; const int32_t* n_tasks;
    const int32_t* max_task_num; const uint8_t* sig_pred;
    const int32_t* task_sig; const uint8_t* task_valid;
    const float* resreq; const uint8_t* task_ports;
    const uint8_t* port_base;
    int32_t* out; unsigned long long* phase_ns;
    int t_pad, n_pad, s_pad, pt, C;
};

// One row's counts over 32 candidates: the bits of the results (ok: every
// request fits; con: a port conflict) against the word's predicate and
// slot bits (vm: the word's candidates).
__device__ __forceinline__ void fold(unsigned ok, unsigned con, unsigned pw,
                                     unsigned slot, unsigned vm, int& pf,
                                     int& rf, int& of, int& el) {
    pf += __popc(~pw & vm);
    rf += __popc(~ok & vm);
    of += __popc(con & vm);
    el += __popc(ok & ~con & pw & slot & vm);
}

template <bool kPorts>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
explain_counts_kernel(const __grid_constant__ Args a, const Layout L) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int s_wcnt[kWarps];             // candidates a warp
    __shared__ int s_tot[2];                   // this CTA's n_cand, slot fails
    __shared__ int s_all[2];                   // the cluster's
    cg::cluster_group cl = cg::this_cluster();
    const int C = a.C, rank = (int)cl.block_rank();
    const int tile = (int)blockIdx.x / C;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int K = L.K, N = a.n_pad, S = a.s_pad, PT = a.pt;
    const int words = K / 32;
    const bool timer = blockIdx.x == 0 && tid == 0 && a.phase_ns != nullptr;
    unsigned long long ph[N_PHASES] = {0, 0, 0, 0}, t_last = 0;
    if (timer) t_last = now_ns();
#define MARK(p)                                     \
    do {                                            \
        if (timer) {                                \
            const unsigned long long t_ = now_ns(); \
            ph[p] += t_ - t_last;                   \
            t_last = t_;                            \
        }                                           \
    } while (0)

    // this thread's task rows
    const int row0 = tile * kTileRows;
    float rq[kRows][3];
    int sig[kRows];
    unsigned tp_lo[kRows], tp_hi[kRows];
    int pf[kRows], rf[kRows], of[kRows], el[kRows];
    bool any = false;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        const int t = row0 + r * kThreads + tid;
        const bool live = t < a.t_pad && a.task_valid[t] != 0;
        any |= live;
        const int tt = live ? t : 0;
        rq[r][0] = a.resreq[tt * 3 + 0];
        rq[r][1] = a.resreq[tt * 3 + 1];
        rq[r][2] = a.resreq[tt * 3 + 2];
        sig[r] = live ? a.task_sig[tt] : 0;
        unsigned lo = 0u, hi = 0u;
        if (kPorts && live) {
            const uint8_t* tp = a.task_ports + (long long)tt * PT;
            for (int k = 0; k < PT; ++k)
                if (tp[k]) {
                    if (k < 32) lo |= 1u << k;
                    else hi |= 1u << (k - 32);
                }
        }
        tp_lo[r] = lo;
        tp_hi[r] = hi;
        pf[r] = rf[r] = of[r] = el[r] = 0;
    }
    if (tid < 2) s_tot[tid] = 0;
    const bool tile_live = __syncthreads_or(any);
    const bool warp_live = __any_sync(0xffffffffu, any);
    const int n_chunks = (N + K - 1) / K;
    const int mine = n_chunks > rank ? (n_chunks - rank + C - 1) / C : 0;

    if (!tile_live) {
        // no valid row: the candidates only (column 5)
        for (int j = 0; j < mine; ++j) {
            const int b = (rank + j * C) * K;
            const int cnt = __syncthreads_count(
                tid < K && b + tid < N && a.node_ok[b + tid] != 0);
            if (tid == 0) s_tot[0] += cnt;
        }
    } else {
        float4* c_node = (float4*)(smem + L.c_node);
        unsigned long long* c_port = (unsigned long long*)(smem + L.c_port);
        int* c_idx = (int*)(smem + L.c_idx);
        unsigned* c_pw = (unsigned*)(smem + L.c_pw);
        unsigned* c_slot = (unsigned*)(smem + L.c_slot);

        auto issue = [&](int j) {
            if (j < mine) {
                uint8_t* st = smem + (size_t)(j & 1) * L.raw;
                const long long b = (long long)(rank + j * C) * K;
                const long long e = min((long long)N, b + K);
                stage(st + L.idle, (const uint8_t*)a.idle, 12 * b, 12 * e,
                      12LL * N);
                stage(st + L.nt, (const uint8_t*)a.n_tasks, 4 * b, 4 * e,
                      4LL * N);
                stage(st + L.mt, (const uint8_t*)a.max_task_num, 4 * b,
                      4 * e, 4LL * N);
                stage(st + L.ok, a.node_ok, b, e, N);
                if (kPorts)
                    stage(st + L.port, a.port_base, b * PT, e * PT,
                          (long long)N * PT);
                if (L.staged)
                    stage_rows(st + L.pred, L.pred_stride(), a.sig_pred, S,
                               N, b, e);
            }
            cp_commit();
        };

        issue(0);
        for (int j = 0; j < mine; ++j) {
            issue(j + 1);
            cp_wait_one();
            __syncthreads();
            MARK(PH_STAGE);
            // ---- compact the chunk to its candidates --------------------
            const uint8_t* st = smem + (size_t)(j & 1) * L.raw;
            const long long b = (long long)(rank + j * C) * K;
            const int width = (int)min((long long)K, N - b);
            const float* r_idle = (const float*)(st + L.idle);
            const int* r_nt = (const int*)(st + L.nt);
            const int* r_mt = (const int*)(st + L.mt);
            const bool cand = tid < width && st[L.ok + tid] != 0;
            const unsigned m = __ballot_sync(0xffffffffu, cand);
            if (lane == 0) s_wcnt[warp] = __popc(m);
            const int slot_fails = __syncthreads_count(
                cand && !(r_nt[tid] < r_mt[tid]));
            int base = 0, total = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) {
                base += w < warp ? s_wcnt[w] : 0;
                total += s_wcnt[w];
            }
            if (cand) {
                const int pos = base + __popc(m & ((1u << lane) - 1u));
                c_node[pos] = make_float4(r_idle[3 * tid],
                                          r_idle[3 * tid + 1],
                                          r_idle[3 * tid + 2], 0.0f);
                c_idx[pos] = tid;
                if (kPorts) {
                    const uint8_t* pb = st + L.port + (size_t)tid * PT;
                    unsigned long long pw = 0ull;
                    for (int k = 0; k < PT; ++k)
                        pw |= (unsigned long long)(pb[k] != 0) << k;
                    c_port[pos] = pw;
                }
            }
            if (tid == 0) {
                s_tot[0] += total;
                s_tot[1] += slot_fails;
            }
            __syncthreads();
            // the slot bit and every signature's predicate bit of 32
            // candidates a word, one ballot each, a warp a word
            const int used = (total + 31) >> 5;
            for (int wd = warp; wd < used; wd += kWarps) {
                const int p = wd * 32 + lane;
                const bool v = p < total;
                const int i = v ? c_idx[p] : 0;
                const unsigned sw = __ballot_sync(
                    0xffffffffu, v && r_nt[i] < r_mt[i]);
                if (lane == 0) c_slot[wd] = sw;
                for (int s = 0; s < S; ++s) {
                    const long long gi = (long long)s * N + b;
                    const bool pr = v && (L.staged
                        ? st[L.pred + s * L.pred_stride() + (gi & 3) + i]
                        : a.sig_pred[gi + i]) != 0;
                    const unsigned pw = __ballot_sync(0xffffffffu, pr);
                    if (lane == 0) c_pw[s * words + wd] = pw;
                }
            }
            __syncthreads();
            MARK(PH_COMPACT);
            // ---- the cells: every row of the thread over the chunk -------
            if (warp_live) {
                for (int wd = 0; wd < used; ++wd) {
                    const int n_in = min(32, total - wd * 32);
                    const unsigned vm =
                        n_in == 32 ? 0xffffffffu : (1u << n_in) - 1u;
                    const float4* nd = c_node + wd * 32;
                    const unsigned long long* pd = c_port + wd * 32;
                    unsigned ok[kRows], con[kRows];
#pragma unroll
                    for (int r = 0; r < kRows; ++r) ok[r] = con[r] = 0u;
                    // a partial word walks its n_in cells only: a sparse
                    // chunk ends in a short word, and running all 32 cells
                    // there (vm masks the stale ones out of the counts)
                    // cost 5p's launch 6.6% on the H100, 3p's 3-5%
                    if (n_in == 32) {
#pragma unroll
                        for (int jj = 0; jj < 32; ++jj) {
                            const float4 x = nd[jj];
                            unsigned long long pw = 0ull;
                            if (kPorts) pw = pd[jj];
#pragma unroll
                            for (int r = 0; r < kRows; ++r) {
                                if ((rq[r][0] <= x.x) & (rq[r][1] <= x.y)
                                    & (rq[r][2] <= x.z))
                                    ok[r] |= 1u << jj;
                                if (kPorts
                                    && ((tp_lo[r] & (unsigned)pw)
                                        | (tp_hi[r] & (unsigned)(pw >> 32))))
                                    con[r] |= 1u << jj;
                            }
                        }
                    } else {
                        for (int jj = 0; jj < n_in; ++jj) {
                            const float4 x = nd[jj];
                            unsigned long long pw = 0ull;
                            if (kPorts) pw = pd[jj];
#pragma unroll
                            for (int r = 0; r < kRows; ++r) {
                                if ((rq[r][0] <= x.x) & (rq[r][1] <= x.y)
                                    & (rq[r][2] <= x.z))
                                    ok[r] |= 1u << jj;
                                if (kPorts
                                    && ((tp_lo[r] & (unsigned)pw)
                                        | (tp_hi[r] & (unsigned)(pw >> 32))))
                                    con[r] |= 1u << jj;
                            }
                        }
                    }
                    const unsigned slot = c_slot[wd];
#pragma unroll
                    for (int r = 0; r < kRows; ++r)
                        fold(ok[r], con[r], c_pw[sig[r] * words + wd], slot,
                             vm, pf[r], rf[r], of[r], el[r]);
                }
            }
            MARK(PH_CELLS);
        }
    }
    // ---- the cluster's sum: CTA rank c writes 1/C of the tile's rows ----
    int4* part = (int4*)(smem + L.part);
#pragma unroll
    for (int r = 0; r < kRows; ++r)
        part[r * kThreads + tid] = make_int4(pf[r], rf[r], of[r], el[r]);
    if (C > 1)
        cl.sync();
    else
        __syncthreads();
    if (warp == 0) {
        // the cluster's candidate and slot-fail counts, a lane a CTA
        int n_cand = 0, slot_fail = 0;
        if (lane < C) {
            const int* tot = cl.map_shared_rank(s_tot, lane);
            n_cand = tot[0];
            slot_fail = tot[1];
        }
        n_cand = __reduce_add_sync(0xffffffffu, n_cand);
        slot_fail = __reduce_add_sync(0xffffffffu, slot_fail);
        if (lane == 0) {
            s_all[0] = n_cand;
            s_all[1] = slot_fail;
        }
    }
    __syncthreads();
    const int n_cand = s_all[0], slot_fail = s_all[1];
    const int share = (kTileRows + C - 1) / C;
    for (int x = tid; x < share; x += kThreads) {
        const int row = rank * share + x;
        const int t = tile * kTileRows + row;
        if (row >= kTileRows || t >= a.t_pad) continue;
        int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
            const int4 v = *cl.map_shared_rank(part + row, c);
            sum.x += v.x;
            sum.y += v.y;
            sum.z += v.z;
            sum.w += v.w;
        }
        const bool ok = a.task_valid[t] != 0;
        int32_t* o = a.out + (long long)t * 6;
        o[0] = ok ? sum.x : 0;
        o[1] = ok ? sum.y : 0;
        o[2] = ok ? slot_fail : 0;
        o[3] = ok ? sum.z : 0;
        o[4] = ok ? sum.w : 0;
        o[5] = n_cand;
    }
    // no CTA leaves while another may still read its partial counts
    if (C > 1) cl.sync();
    MARK(PH_REDUCE);
#undef MARK
    if (timer)
        for (int p = 0; p < N_PHASES; ++p) a.phase_ns[p] = ph[p];
}

int cluster_for(int n_pad, int K) {
    const int chunks = (n_pad + K - 1) / K;
    return chunks < kMaxCluster ? (chunks > 0 ? chunks : 1) : kMaxCluster;
}

template <bool kPorts>
cudaError_t launch(const Args& a, const Layout& L, int tiles,
                   cudaStream_t stream) {
    static size_t attr_bytes = 0;
    static bool non_portable = false;
    if (L.total > 48 * 1024 && L.total > attr_bytes) {
        const cudaError_t e = cudaFuncSetAttribute(
            explain_counts_kernel<kPorts>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
        if (e != cudaSuccess) return e;
        attr_bytes = L.total;
    }
    if (a.C > 8 && !non_portable) {
        const cudaError_t e = cudaFuncSetAttribute(
            explain_counts_kernel<kPorts>,
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
        non_portable = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(tiles * a.C));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = L.total;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)a.C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, explain_counts_kernel<kPorts>, a, L);
}

}  // namespace

// One launch over T_pad task rows and N_pad nodes; s_pad signature rows;
// pt port columns (1 to 64; read only with has_ports). phase_ns: N_PHASES
// uint64 the launch writes (may be null). The device pointers must be
// 4-byte aligned. Returns the cudaError_t of the launch; a refused launch
// is returned, never retried another way.
extern "C" int kb_explain_counts(const void* idle, const void* node_ok,
                                 const void* n_tasks,
                                 const void* max_task_num,
                                 const void* sig_pred, const void* task_sig,
                                 const void* task_valid, const void* resreq,
                                 const void* task_ports,
                                 const void* port_base, int t_pad,
                                 int n_pad, int s_pad, int pt, int has_ports,
                                 void* out, void* phase_ns, void* stream) {
    if (t_pad <= 0) return 0;
    if (n_pad <= 0 || s_pad <= 0 || pt < 1 || pt > 64)
        return (int)cudaErrorInvalidValue;
    const int ports = has_ports ? 1 : 0;
    const Layout L = plan(n_pad, s_pad, pt, ports);
    if (L.total > (size_t)227 * 1024) return (int)cudaErrorInvalidValue;
    Args a;
    a.idle = (const float*)idle;
    a.node_ok = (const uint8_t*)node_ok;
    a.n_tasks = (const int32_t*)n_tasks;
    a.max_task_num = (const int32_t*)max_task_num;
    a.sig_pred = (const uint8_t*)sig_pred;
    a.task_sig = (const int32_t*)task_sig;
    a.task_valid = (const uint8_t*)task_valid;
    a.resreq = (const float*)resreq;
    a.task_ports = (const uint8_t*)task_ports;
    a.port_base = (const uint8_t*)port_base;
    a.out = (int32_t*)out;
    a.phase_ns = (unsigned long long*)phase_ns;
    a.t_pad = t_pad;
    a.n_pad = n_pad;
    a.s_pad = s_pad;
    a.pt = pt;
    a.C = cluster_for(n_pad, L.K);
    const int tiles = (t_pad + kTileRows - 1) / kTileRows;
    const cudaError_t err =
        ports ? launch<true>(a, L, tiles, (cudaStream_t)stream)
              : launch<false>(a, L, tiles, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// The launch shape for these sizes (pt 0 without ports): writes the
// cluster's CTAs, the chunk's raw nodes, whether the predicate bytes are
// staged, the shared bytes a CTA and the tiles of task rows into info[5].
extern "C" int kb_explain_shape(int t_pad, int n_pad, int s_pad, int pt,
                                int* info) {
    if (n_pad <= 0 || s_pad <= 0 || pt < 0 || pt > 64)
        return (int)cudaErrorInvalidValue;
    const Layout L = plan(n_pad, s_pad, pt > 0 ? pt : 1, pt > 0);
    info[0] = cluster_for(n_pad, L.K);
    info[1] = L.K;
    info[2] = L.staged;
    info[3] = (int)L.total;
    info[4] = (t_pad + kTileRows - 1) / kTileRows;
    return 0;
}
