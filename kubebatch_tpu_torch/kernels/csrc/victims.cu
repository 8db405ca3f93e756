// The victim analysis of preempt and reclaim: one node visit per lane.
//
// Replaces kubebatch_tpu/kernels/victims.py:218 _analysis_core, inside
// :401 _wave_kernel (the analysis for L preemptor lanes, packed
// uint8[L, 2N + V] = pick | guard | victims) and :324 _visit_core (one
// lane, then the first pickable node in lexsort((host_rank, -score))
// order, packed int32[4 + V]), with kubebatch_tpu/kernels/solver.py:67
// dynamic_node_score for the visit's score (node_score.cuh). The plain
// PyTorch versions are kubebatch_tpu_torch/kernels/victims.py wave_plain
// and visit_plain; the outputs are bool and int32 and every float
// operation is the plain version's, in its order (built with -fmad=false
// and IEEE division), so they agree bit for bit:
//  - the per-(node, job) and per-(node, queue) segmented sums run
//    jax.lax.associative_scan's odd/even tree (cluster_scan.cuh), and the
//    reference's "exclusive" sum is that inclusive result minus the
//    values, then (drf) plus the values again;
//  - the per-node victim totals add in row order from 0.0, as XLA's
//    segment_sum scatter does: the host hands over the rows live at the
//    start of the action stably sorted by node (node_rows, node_off; a
//    row dead then stays dead), and one thread walks a node's rows.
//
// What bounds it on an H100: per lane, ~40 B of row state per victim row
// and ~30 B per node are read, and L * (2N + V) bytes written (at cfg5's
// churn state, V = 16,384 and N = 8,192: ~0.9 MB of state and 32 KB out
// per lane, ~0.3 us at 3.35 TB/s), against ~60 float operations per row.
// Neither rate binds: each lane is a chain of dependent block-wide steps
// (the two segmented scans, ~2 log2(V) levels each), so its time is the
// latency of that chain, and one SM running it leaves the card idle.
// Design (redesigned for the H100's thread-block clusters):
//  - one lane per cluster of C CTAs of 512 threads (C = 8, launched with
//    cudaLaunchKernelEx and a cluster dimension; any power of two up to 8
//    runs, C = 1 as one CTA a lane); a wave takes as many clusters as the
//    card holds at once (kb_victims_resident) and its lanes past them
//    loop;
//  - each segmented scan runs cluster_scan.cuh: CTA c owns the aligned
//    tile [c S, (c+1) S) of the scan order (S the power of two >= V / C),
//    runs the tile's levels in its shared memory (its global workspace
//    when 26 S bytes exceed SMEM_LEVELS_MAX), and only the tiles' tops
//    cross CTAs, through DSMEM, at one cluster barrier a scan;
//  - the row masks (candidate, gang, conformance, drf, proportion, guard,
//    victim) are one byte per row in the cluster's global workspace (L2),
//    written by one thread per row and phase, read across CTAs after a
//    cluster barrier (release / acquire at cluster scope);
//  - CTA c takes the rows [c R, (c+1) R) of the filter and the output,
//    and the nodes [c P, (c+1) P) of the per-node pass: the tier choice,
//    victim totals and validation run one thread per node over its rows,
//    in row order from 0.0; no float atomics anywhere;
//  - the visit: each CTA reduces its nodes to two candidates under the key
//    (-score, host_rank, node) (the best pickable node, the best of all)
//    and whether any is pickable; after one cluster barrier every CTA
//    reads the C candidates through DSMEM and takes the same node, which
//    is the first node of the reference's lexsort; the node's owner CTA
//    counts its victim rows;
//  - CTA 0's thread 0 times the phases (filter, drf scan, proportion
//    scan, node pass, visit) between barriers on the global timer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_scan.cuh"
#include "node_score.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_NT = 1024;
constexpr int MAX_WARPS = MAX_NT / 32;
// the portable cluster size: the most CTAs a lane takes
constexpr int MAX_CLUSTER = 8;
// a tile's scan levels stay in shared memory up to this many bytes a CTA
// (two one-CTA lanes still fit on one SM); larger tiles keep them in the
// cluster's global workspace
constexpr int SMEM_LEVELS_MAX = 108 * 1024;
// most tiers a launch takes (a bit of a mask each)
constexpr int MAX_TIERS = 32;
// a node's first rows kept in registers between its two sweeps
constexpr int ROWS_CACHED = 4;

// tier plugin bits (kernels/victims.py TIER_BITS)
enum { T_GANG = 1, T_CONF = 2, T_DRF = 4, T_PROP = 8 };
// row mask bits
enum {
    F_CAND = 1, F_GANG = 2, F_CONF = 4, F_DRF = 8, F_PROP = 16, F_GUARD = 32,
    F_VICTIM = 64
};
enum { K_INTER_QUEUE = 0, K_INTRA_JOB = 1, K_OTHER_QUEUE = 2 };

// pointer slots, in the order the wrapper passes them
enum {
    P_RES, P_RESREQ, P_NZ, P_SIG, P_JOB, P_QUEUE, P_SIG_SCORES, P_SIG_PRED,
    P_NODE_OK, P_MAXT, P_CAP, P_HOST_RANK, P_VNODE, P_VJOB, P_VRES, P_VCRIT,
    P_PERM_NJ, P_NJ_HEAD, P_PERM_NQ, P_NQ_HEAD, P_MIN_AV, P_JQUEUE, P_QDES,
    P_QPROP_OK, P_CTOTAL, P_DYNW, P_NTASKS, P_NZREQ, P_VLIVE, P_READY,
    P_JALLOC, P_QALLOC, P_NODE_ROWS, P_NODE_OFF, P_VISITED, P_TIERS, P_EPS,
    P_WS, P_OUT, P_PHASE, N_PTRS
};
// int slots (I_BLOCKS: lane slots, a cluster each)
enum {
    I_L, I_N, I_V, I_NTIERS, I_HAS_DRF, I_HAS_PROP, I_VETO, I_FILTER, I_DYN,
    I_SCORE, I_ROOM, I_VISIT, I_BLOCKS, I_NT, I_WS_BYTES, I_CLUSTER, N_INTS
};
// phases timed by CTA 0's thread 0 (kernels/victims.py PHASES)
enum { PH_FILTER, PH_DRF, PH_PROP, PH_NODES, PH_VISIT, N_PHASES };

struct Args {
    const float* p_res; const float* p_resreq; const float* p_nz;
    const int32_t* p_sig; const int32_t* p_job; const int32_t* p_queue;
    const float* sig_scores; const uint8_t* sig_pred;
    const uint8_t* node_ok; const int32_t* maxt; const float* cap;
    const int32_t* host_rank;
    const int32_t* v_node; const int32_t* v_job; const float* v_res;
    const uint8_t* v_crit;
    const int32_t* perm_nj; const uint8_t* nj_head;
    const int32_t* perm_nq; const uint8_t* nq_head;
    const int32_t* min_av; const int32_t* job_queue; const float* q_des;
    const uint8_t* q_prop_ok; const float* ctotal; const float* dynw;
    const int32_t* n_tasks; const float* nz_req; const uint8_t* v_live;
    const int32_t* ready; const float* j_alloc; const float* q_alloc;
    const int32_t* node_rows; const int32_t* node_off;
    const uint8_t* visited; const int32_t* tiers; const float* eps;
    uint8_t* ws; void* out; unsigned long long* phase_ns;
    int L, N, V, n_tiers, has_drf, has_prop, veto, filter, dyn, score, room,
        visit, ws_bytes, tile_log2, smem_levels;
};

// the cluster's workspace (base may be null: returns the size)
struct Work {
    uint8_t* flags; uint8_t* pick; uint8_t* guard;
    uint8_t* levels;   // C tiles' scan levels, when not in shared memory
};

struct Carver {
    uint8_t* base;
    size_t off;
    __host__ __device__ uint8_t* take(size_t bytes) {
        uint8_t* p = base ? base + off : nullptr;
        off = (off + (bytes ? bytes : 1) + 255) & ~size_t(255);
        return p;
    }
};

// bytes of one tile's scan levels: 2S elements of 3 floats and a flag
__host__ __device__ inline size_t tile_bytes(int k) {
    const size_t e = kb::ClusterSegScan3::elems(k);
    return ((e * 13) + 255) & ~size_t(255);
}

// the tile of a cluster of c CTAs over v rows: log2 of the least power of
// two S with c S >= v
__host__ __device__ inline int tile_log2(int v, int c) {
    int k = 0;
    while ((size_t)c << k < (size_t)v) ++k;
    return k;
}

__host__ __device__ inline size_t layout(int V, int N, int C, bool smem,
                                         uint8_t* base, Work* w) {
    Carver c{base, 0};
    Work x;
    x.flags = c.take((size_t)V);
    x.pick = c.take((size_t)N);
    x.guard = c.take((size_t)N);
    x.levels = c.take(smem ? 0 : (size_t)C * tile_bytes(tile_log2(V, C)));
    if (w) *w = x;
    return c.off;
}

// share() per dimension, max over dims: x/0 -> 1, 0/0 -> 0
__device__ __forceinline__ float share3(const float* v, const float* tot) {
    float m = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float s = tot[r] == 0.0f ? (v[r] == 0.0f ? 0.0f : 1.0f)
                                       : v[r] / tot[r];
        m = r == 0 ? s : fmaxf(m, s);
    }
    return m;
}

__device__ __forceinline__ bool le_eps(float a, float b, float eps) {
    return (a < b) || (fabsf(b - a) < eps);
}

// the flag bits a row needs to be in tier t's intersection
__device__ __forceinline__ uint8_t tier_need(int m) {
    return (uint8_t)(F_CAND | ((m & T_GANG) ? F_GANG : 0)
                     | ((m & T_CONF) ? F_CONF : 0)
                     | ((m & T_DRF) ? F_DRF : 0)
                     | ((m & T_PROP) ? F_PROP : 0));
}

// lexicographic (neg score, host rank, node) order of the visit's choice;
// -0.0 compares equal to +0.0, as the reference's sort does
__device__ __forceinline__ bool key_less(float ka, int ra, int ia, float kb,
                                         int rb, int ib) {
    if (ka < kb) return true;
    if (kb < ka) return false;
    if (ra != rb) return ra < rb;
    return ia < ib;
}

struct Key {
    float k;
    int r, i;
    __device__ void take(const Key& o) {
        if (key_less(o.k, o.r, o.i, k, r, i)) *this = o;
    }
    __device__ Key shfl_down(int off) const {
        return Key{__shfl_down_sync(0xffffffffu, k, off),
                   __shfl_down_sync(0xffffffffu, r, off),
                   __shfl_down_sync(0xffffffffu, i, off)};
    }
};

// a CTA's visit candidates as the other CTAs read them
struct VisitCand {
    Key pick, all;
    int any;
};

// a cluster barrier; a cluster of one CTA synchronises as a block
__device__ __forceinline__ void csync(cg::cluster_group& cl) {
    if (cl.num_blocks() > 1)
        cl.sync();
    else
        __syncthreads();
}

__device__ __forceinline__ unsigned long long now_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

__global__ void __launch_bounds__(MAX_NT)
victims_kernel(const Args a) {
    cg::cluster_group cl = cg::this_cluster();
    const int tid = threadIdx.x, nt = blockDim.x;
    const int lane_id = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
    const int C = (int)cl.num_blocks(), c = (int)cl.block_rank();
    const int cluster_id = blockIdx.x / C, n_clusters = gridDim.x / C;
    extern __shared__ __align__(16) uint8_t s_levels[];
    __shared__ kb::ScanTop s_top[2];
    __shared__ Key s_wpick[MAX_WARPS], s_wall[MAX_WARPS];
    __shared__ int s_wany[MAX_WARPS];
    __shared__ VisitCand s_cand;
    __shared__ int s_node, s_found, s_count;
    __shared__ uint8_t s_need[MAX_TIERS];
    const int N = a.N, V = a.V;
    Work w;
    layout(V, N, C, a.smem_levels, a.ws + (size_t)cluster_id * a.ws_bytes,
           &w);
    // this CTA's tile of the scan order, rows and nodes
    const int k = a.tile_log2;
    const int S = 1 << k;
    const int t_beg = min((long long)c << k, (long long)V);
    kb::ClusterSegScan3 scan;
    scan.k = k;
    scan.tile = c;
    scan.cnt0 = min(S, V - t_beg);
    scan.full = V >> k;
    uint8_t* lv = a.smem_levels ? s_levels : w.levels + c * tile_bytes(k);
    scan.v = (float*)lv;
    scan.f = lv + 12 * kb::ClusterSegScan3::elems(k);
    const int R = (V + C - 1) / C, P = (N + C - 1) / C;
    const int r_beg = min(c * R, V), r_end = min(r_beg + R, V);
    const int n_beg = min(c * P, N), n_end = min(n_beg + P, N);
    const float* eps = a.eps;

    // the flag bits a row needs to be in each tier's intersection (read
    // after the lane's first barrier)
    for (int t = tid; t < a.n_tiers; t += nt)
        s_need[t] = tier_need(__ldg(&a.tiers[t]));
    const bool timer = blockIdx.x == 0 && tid == 0 && a.phase_ns != nullptr;
    unsigned long long ph[N_PHASES] = {0, 0, 0, 0, 0};
    unsigned long long t_last = timer ? now_ns() : 0;
#define MARK(p)                                   \
    do {                                          \
        if (timer) {                              \
            const unsigned long long t_ = now_ns(); \
            ph[p] += t_ - t_last;                 \
            t_last = t_;                          \
        }                                         \
    } while (0)

    for (int lane = cluster_id; lane < a.L; lane += n_clusters) {
        const int pj = a.p_job[lane], pq = a.p_queue[lane];
        const int sig = a.p_sig[lane];
        float p_res[3], ls = 0.0f;
#pragma unroll
        for (int r = 0; r < 3; ++r) p_res[r] = a.p_res[lane * 3 + r];
        if (a.has_drf) {
            const int pjc = pj < 0 ? 0 : pj;
            float v[3];
#pragma unroll
            for (int r = 0; r < 3; ++r)
                v[r] = __ldg(&a.j_alloc[pjc * 3 + r])
                       + a.p_resreq[lane * 3 + r];
            ls = share3(v, a.ctotal);
        }
        uint8_t* out_row = a.visit ? nullptr
            : (uint8_t*)a.out + (size_t)lane * (2 * (size_t)N + V);

        // ---- candidate filter + gang / conformance verdicts -----------
#pragma unroll 4
        for (int r = r_beg + tid; r < r_end; r += nt) {
            const int vjr = __ldg(&a.v_job[r]);
            const bool known = vjr >= 0;
            const int vj = known ? vjr : 0;
            const int jq = __ldg(&a.job_queue[vj]);
            const bool live = __ldg(&a.v_live[r]) != 0;
            bool cand;
            if (a.filter == K_INTER_QUEUE)
                cand = live && known && jq == pq && vjr != pj;
            else if (a.filter == K_INTRA_JOB)
                cand = live && known && vjr == pj;
            else
                cand = live && known && jq != pq;
            const int mav = __ldg(&a.min_av[vj]);
            const bool gang = ((__ldg(&a.ready[vj]) - 1 >= mav) || mav == 1)
                              && known;
            w.flags[r] = (uint8_t)((cand ? F_CAND : 0) | (gang ? F_GANG : 0)
                                   | (__ldg(&a.v_crit[r]) ? 0 : F_CONF));
            // rows outside every node's live list are never victims
            if (out_row) out_row[2 * (size_t)N + r] = 0;
        }
        csync(cl);
        MARK(PH_FILTER);

        // ---- drf: cumulative per (node, job) in candidate order -------
        if (a.has_drf) {
#pragma unroll 4
            for (int j = tid; j < scan.cnt0; j += nt) {
                const int i = t_beg + j;
                const int r = __ldg(&a.perm_nj[i]);
                const bool cnd = w.flags[r] & F_CAND;
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    scan.v[3 * j + d] =
                        cnd ? __ldg(&a.v_res[r * 3 + d]) : 0.0f;
                scan.f[j] = __ldg(&a.nj_head[i]);
            }
            scan.run(cl, &s_top[0]);
#pragma unroll 4
            for (int j = tid; j < scan.cnt0; j += nt) {
                const int i = t_beg + j;
                const int r = __ldg(&a.perm_nj[i]);
                const bool cnd = w.flags[r] & F_CAND;
                const int vjr = __ldg(&a.v_job[r]);
                const int vj = vjr < 0 ? 0 : vjr;
                float x[3];
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const float vals = cnd ? __ldg(&a.v_res[r * 3 + d]) : 0.0f;
                    const float excl = scan.v[3 * j + d] - vals;
                    const float cum = excl + vals;
                    x[d] = __ldg(&a.j_alloc[vj * 3 + d]) - cum;
                }
                const float rs = share3(x, a.ctotal);
                const bool ok = ((ls < rs) || (fabsf(ls - rs) <= 1e-6f))
                                && vjr >= 0;
                if (ok) w.flags[r] |= F_DRF;
            }
            __syncthreads();
            MARK(PH_DRF);
        }

        // ---- proportion: cumulative per (node, queue) ------------------
        // (its verdicts follow its scan's cluster barrier, which every
        // drf verdict precedes: no two CTAs update one row's flags at once)
        if (a.has_prop) {
#pragma unroll 4
            for (int j = tid; j < scan.cnt0; j += nt) {
                const int i = t_beg + j;
                const int r = __ldg(&a.perm_nq[i]);
                const int vjr = __ldg(&a.v_job[r]);
                const int vq = __ldg(&a.job_queue[vjr < 0 ? 0 : vjr]);
                const bool elig = (w.flags[r] & F_CAND) && vq >= 0
                                  && __ldg(&a.q_prop_ok[vq < 0 ? 0 : vq]);
#pragma unroll
                for (int d = 0; d < 3; ++d)
                    scan.v[3 * j + d] =
                        elig ? __ldg(&a.v_res[r * 3 + d]) : 0.0f;
                scan.f[j] = __ldg(&a.nq_head[i]);
            }
            scan.run(cl, &s_top[1]);
#pragma unroll 4
            for (int j = tid; j < scan.cnt0; j += nt) {
                const int i = t_beg + j;
                const int r = __ldg(&a.perm_nq[i]);
                const int vjr = __ldg(&a.v_job[r]);
                const int vq = __ldg(&a.job_queue[vjr < 0 ? 0 : vjr]);
                const int vqc = vq < 0 ? 0 : vq;
                const bool elig = (w.flags[r] & F_CAND) && vq >= 0
                                  && __ldg(&a.q_prop_ok[vqc]);
                bool ok = elig, guard = elig;
#pragma unroll
                for (int d = 0; d < 3; ++d) {
                    const float vr = __ldg(&a.v_res[r * 3 + d]);
                    const float vals = elig ? vr : 0.0f;
                    const float excl = scan.v[3 * j + d] - vals;
                    const float before = __ldg(&a.q_alloc[vqc * 3 + d]) - excl;
                    const float after = before - vr;
                    ok = ok && le_eps(__ldg(&a.q_des[vqc * 3 + d]), after,
                                      eps[d]);
                    guard = guard && (before < vr);
                }
                w.flags[r] |= (uint8_t)((ok ? F_PROP : 0)
                                        | (guard ? F_GUARD : 0));
            }
        }
        csync(cl);
        MARK(PH_PROP);

        // ---- per node: first non-empty tier, validation, pickability --
        // (one sweep of a node's rows finds every tier's hit; the first
        // rows and their flags stay in registers for the victim sweep)
        for (int n = n_beg + tid; n < n_end; n += nt) {
            const int beg = __ldg(&a.node_off[n]);
            const int end = __ldg(&a.node_off[n + 1]);
            int rr[ROWS_CACHED];
            uint8_t ff[ROWS_CACHED];
#pragma unroll
            for (int i = 0; i < ROWS_CACHED; ++i)
                if (beg + i < end) rr[i] = __ldg(&a.node_rows[beg + i]);
            unsigned hit = 0;
            auto tiers_hit = [&](uint8_t f) {
                for (int t = 0; t < a.n_tiers; ++t)
                    hit |= (unsigned)((f & s_need[t]) == s_need[t]) << t;
            };
#pragma unroll
            for (int i = 0; i < ROWS_CACHED; ++i) {
                if (beg + i < end) {
                    ff[i] = w.flags[rr[i]];
                    tiers_hit(ff[i]);
                }
            }
            for (int q = beg + ROWS_CACHED; q < end; ++q)
                tiers_hit(w.flags[__ldg(&a.node_rows[q])]);
            const uint8_t need = hit ? s_need[__ffs(hit) - 1] : 0;
            float tot[3] = {0.0f, 0.0f, 0.0f};
            bool any_v = false, guard = false;
            auto victim_row = [&](int r, uint8_t f) {
                guard = guard || (f & F_GUARD);
                const bool vic = need && (f & need) == need
                                 && (!a.veto || (f & F_CONF));
                if (vic) {
                    any_v = true;
#pragma unroll
                    for (int d = 0; d < 3; ++d)
                        tot[d] = tot[d] + __ldg(&a.v_res[r * 3 + d]);
                    w.flags[r] = f | F_VICTIM;
                }
                if (out_row) out_row[2 * (size_t)N + r] = vic ? 1 : 0;
            };
#pragma unroll
            for (int i = 0; i < ROWS_CACHED; ++i)
                if (beg + i < end) victim_row(rr[i], ff[i]);
            for (int q = beg + ROWS_CACHED; q < end; ++q) {
                const int r = __ldg(&a.node_rows[q]);
                victim_row(r, w.flags[r]);
            }
            const bool valid = any_v && !(tot[0] < p_res[0]
                                          && tot[1] < p_res[1]
                                          && tot[2] < p_res[2]);
            bool base = __ldg(&a.node_ok[n])
                        && __ldg(&a.sig_pred[(size_t)sig * N + n]);
            if (a.room)
                base = base && __ldg(&a.n_tasks[n]) < __ldg(&a.maxt[n]);
            const bool pick = base && (valid || guard);
            if (out_row) {
                out_row[n] = pick ? 1 : 0;
                out_row[N + n] = guard ? 1 : 0;
            } else {
                w.pick[n] = (pick && !__ldg(&a.visited[n])) ? 1 : 0;
                w.guard[n] = guard ? 1 : 0;
            }
        }
        csync(cl);
        MARK(PH_NODES);
        if (!a.visit) continue;

        // ---- the visit: first pickable node in (-score, rank) order ---
        const Key none{INFINITY, 0x7fffffff, 0x7fffffff};
        Key best_pick = none, best_all = none;
        int any = 0;
        for (int n = n_beg + tid; n < n_end; n += nt) {
            float key = 0.0f;
            if (a.score) {
                float score = __ldg(&a.sig_scores[(size_t)sig * N + n]);
                if (a.dyn)
                    score = score + kb::dynamic_node_score(
                        a.nz_req[2 * n], a.nz_req[2 * n + 1], a.p_nz[0],
                        a.p_nz[1], a.cap[2 * n], a.cap[2 * n + 1],
                        a.dynw[0], a.dynw[1]);
                key = -score;
            }
            const Key kn{key, __ldg(&a.host_rank[n]), n};
            best_all.take(kn);
            if (w.pick[n]) {
                any = 1;
                best_pick.take(kn);
            }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            best_pick.take(best_pick.shfl_down(off));
            best_all.take(best_all.shfl_down(off));
            any |= __shfl_down_sync(0xffffffffu, any, off);
        }
        if (lane_id == 0) {
            s_wpick[warp] = best_pick;
            s_wall[warp] = best_all;
            s_wany[warp] = any;
        }
        if (tid == 0) s_count = 0;
        __syncthreads();
        if (tid == 0) {
            VisitCand v{s_wpick[0], s_wall[0], s_wany[0]};
            for (int q = 1; q < n_warps; ++q) {
                v.pick.take(s_wpick[q]);
                v.all.take(s_wall[q]);
                v.any |= s_wany[q];
            }
            s_cand = v;
        }
        csync(cl);
        if (tid == 0) {
            VisitCand g = *cl.map_shared_rank(&s_cand, 0);
            for (int q = 1; q < C; ++q) {
                const VisitCand o = *cl.map_shared_rank(&s_cand, q);
                g.pick.take(o.pick);
                g.all.take(o.all);
                g.any |= o.any;
            }
            s_found = g.any;
            s_node = g.any ? g.pick.i : g.all.i;
        }
        __syncthreads();
        const int node = s_node;
        int32_t* out = (int32_t*)a.out;
        for (int r = r_beg + tid; r < r_end; r += nt)
            out[4 + r] =
                ((w.flags[r] & F_VICTIM) && __ldg(&a.v_node[r]) == node)
                ? 1 : 0;
        if (node >= n_beg && node < n_end) {
            int cnt = 0;
            const int q_end = __ldg(&a.node_off[node + 1]);
            for (int q = __ldg(&a.node_off[node]) + tid; q < q_end; q += nt)
                cnt += (w.flags[__ldg(&a.node_rows[q])] & F_VICTIM) ? 1 : 0;
            if (cnt) atomicAdd(&s_count, cnt);
            __syncthreads();
            if (tid == 0) {
                out[0] = s_found ? 1 : 0;
                out[1] = node;
                out[2] = s_count;
                out[3] = w.guard[node];
            }
        }
        // no CTA leaves while another still reads its candidate
        csync(cl);
        MARK(PH_VISIT);
    }
#undef MARK
    if (timer)
        for (int p = 0; p < N_PHASES; ++p) a.phase_ns[p] = ph[p];
}

}  // namespace

namespace {

cudaError_t set_attrs() {
    static bool done = false;
    if (done) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        victims_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_LEVELS_MAX);
    if (e == cudaSuccess) done = true;
    return e;
}

cudaLaunchConfig_t launch_config(int clusters, int C, int threads,
                                 size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(clusters * C));
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

size_t smem_bytes(int V, int C) {
    const size_t tb = tile_bytes(tile_log2(V, C));
    return tb <= (size_t)SMEM_LEVELS_MAX ? tb : 0;
}

}  // namespace

// Clusters of ``cluster`` CTAs of ``threads`` threads the card holds at
// once for V rows (the tile's shared memory decides); a negative
// cudaError_t when the query fails.
extern "C" int kb_victims_resident(int V, int cluster, int threads) {
    cudaError_t e = set_attrs();
    if (e != cudaSuccess) return -(int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(
        1, cluster, threads, smem_bytes(V, cluster), nullptr, attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, victims_kernel, &cfg);
    return e == cudaSuccess ? n : -(int)e;
}

// Workspace bytes of one lane slot (a cluster of ``cluster`` CTAs).
extern "C" int kb_victims_workspace(int V, int N, int cluster) {
    const int k = tile_log2(V, cluster);
    const bool smem = tile_bytes(k) <= (size_t)SMEM_LEVELS_MAX;
    return (int)layout(V, N, cluster, smem, nullptr, nullptr);
}

// ptrs: N_PTRS device pointers (host array); ints: N_INTS (host array).
// Launches ints[I_BLOCKS] clusters of ints[I_CLUSTER] CTAs; a refused
// launch (cudaErrorClusterOutOfResources, too much shared memory) is
// returned, never retried another way.
extern "C" int kb_victims(const void* const* ptrs, const int* ints,
                          void* stream) {
    Args a;
    a.p_res = (const float*)ptrs[P_RES];
    a.p_resreq = (const float*)ptrs[P_RESREQ];
    a.p_nz = (const float*)ptrs[P_NZ];
    a.p_sig = (const int32_t*)ptrs[P_SIG];
    a.p_job = (const int32_t*)ptrs[P_JOB];
    a.p_queue = (const int32_t*)ptrs[P_QUEUE];
    a.sig_scores = (const float*)ptrs[P_SIG_SCORES];
    a.sig_pred = (const uint8_t*)ptrs[P_SIG_PRED];
    a.node_ok = (const uint8_t*)ptrs[P_NODE_OK];
    a.maxt = (const int32_t*)ptrs[P_MAXT];
    a.cap = (const float*)ptrs[P_CAP];
    a.host_rank = (const int32_t*)ptrs[P_HOST_RANK];
    a.v_node = (const int32_t*)ptrs[P_VNODE];
    a.v_job = (const int32_t*)ptrs[P_VJOB];
    a.v_res = (const float*)ptrs[P_VRES];
    a.v_crit = (const uint8_t*)ptrs[P_VCRIT];
    a.perm_nj = (const int32_t*)ptrs[P_PERM_NJ];
    a.nj_head = (const uint8_t*)ptrs[P_NJ_HEAD];
    a.perm_nq = (const int32_t*)ptrs[P_PERM_NQ];
    a.nq_head = (const uint8_t*)ptrs[P_NQ_HEAD];
    a.min_av = (const int32_t*)ptrs[P_MIN_AV];
    a.job_queue = (const int32_t*)ptrs[P_JQUEUE];
    a.q_des = (const float*)ptrs[P_QDES];
    a.q_prop_ok = (const uint8_t*)ptrs[P_QPROP_OK];
    a.ctotal = (const float*)ptrs[P_CTOTAL];
    a.dynw = (const float*)ptrs[P_DYNW];
    a.n_tasks = (const int32_t*)ptrs[P_NTASKS];
    a.nz_req = (const float*)ptrs[P_NZREQ];
    a.v_live = (const uint8_t*)ptrs[P_VLIVE];
    a.ready = (const int32_t*)ptrs[P_READY];
    a.j_alloc = (const float*)ptrs[P_JALLOC];
    a.q_alloc = (const float*)ptrs[P_QALLOC];
    a.node_rows = (const int32_t*)ptrs[P_NODE_ROWS];
    a.node_off = (const int32_t*)ptrs[P_NODE_OFF];
    a.visited = (const uint8_t*)ptrs[P_VISITED];
    a.tiers = (const int32_t*)ptrs[P_TIERS];
    a.eps = (const float*)ptrs[P_EPS];
    a.ws = (uint8_t*)ptrs[P_WS];
    a.out = (void*)ptrs[P_OUT];
    a.phase_ns = (unsigned long long*)ptrs[P_PHASE];
    a.L = ints[I_L];
    a.N = ints[I_N];
    a.V = ints[I_V];
    a.n_tiers = ints[I_NTIERS];
    a.has_drf = ints[I_HAS_DRF];
    a.has_prop = ints[I_HAS_PROP];
    a.veto = ints[I_VETO];
    a.filter = ints[I_FILTER];
    a.dyn = ints[I_DYN];
    a.score = ints[I_SCORE];
    a.room = ints[I_ROOM];
    a.visit = ints[I_VISIT];
    a.ws_bytes = ints[I_WS_BYTES];
    const int clusters = ints[I_BLOCKS], threads = ints[I_NT];
    const int C = ints[I_CLUSTER];
    if (a.L <= 0 || clusters <= 0) return 0;
    if (threads <= 0 || threads > MAX_NT || (threads & 31)
        || C < 1 || C > MAX_CLUSTER || (C & (C - 1)) || a.n_tiers < 0
        || a.n_tiers > MAX_TIERS)
        return (int)cudaErrorInvalidValue;
    a.tile_log2 = tile_log2(a.V, C);
    const size_t tb = tile_bytes(a.tile_log2);
    a.smem_levels = tb <= (size_t)SMEM_LEVELS_MAX;
    if ((size_t)a.ws_bytes < layout(a.V, a.N, C, a.smem_levels, nullptr,
                                    nullptr))
        return (int)cudaErrorInvalidValue;
    const cudaError_t e = set_attrs();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(
        clusters, C, threads, a.smem_levels ? tb : 0, (cudaStream_t)stream,
        attr);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, victims_kernel, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
