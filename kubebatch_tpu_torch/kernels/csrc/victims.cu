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
//    jax.lax.associative_scan's odd/even tree (seg_scan.cuh), and the
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
// Neither rate binds: each lane is a chain of ~4 log2(V) block-wide
// dependent steps (the two segmented scans, ~28 levels each way at
// V = 16,384), each a __syncthreads over data in L2.
// Design:
//  - one CTA per lane, 512 threads; the lanes past the resident grid
//    (at most 264 blocks) loop, each block reusing its own workspace
//    (~68 B per row: the scan levels in global memory, L2-resident);
//  - the row masks (candidate, gang, conformance, drf, proportion,
//    guard, victim) are one byte per row in the workspace;
//  - the per-node tier choice, victim totals and validation run one
//    thread per node over its rows; no float atomics anywhere;
//  - the visit's node choice is a block-wide argmin over the key
//    (-score, host_rank, node) among the pickable nodes (all nodes when
//    none is), which is the first node of the reference's lexsort.
// Batching lanes into one CTA's scans, and a shared-memory scan for small
// V, are later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"
#include "seg_scan.cuh"

namespace {

constexpr int MAX_NT = 1024;

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
    P_WS, P_OUT, N_PTRS
};
// int slots
enum {
    I_L, I_N, I_V, I_NTIERS, I_HAS_DRF, I_HAS_PROP, I_VETO, I_FILTER, I_DYN,
    I_SCORE, I_ROOM, I_VISIT, I_BLOCKS, I_NT, I_WS_BYTES, N_INTS
};

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
    uint8_t* ws; void* out;
    int L, N, V, n_tiers, has_drf, has_prop, veto, filter, dyn, score, room,
        visit, ws_bytes;
};

// one block's workspace (base may be null: returns the size)
struct Work {
    float* sv; int32_t* sc; uint8_t* sf;
    float* rv; int32_t* rc; uint8_t* rf;
    uint8_t* flags; uint8_t* pick; uint8_t* guard;
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

__host__ __device__ inline size_t layout(int V, int N, uint8_t* base,
                                         Work* w) {
    Carver c{base, 0};
    const size_t lv = 2 * (size_t)V + 64;      // associative-scan levels
    Work x;
    x.sv = (float*)c.take(lv * 3 * 4);
    x.sc = (int32_t*)c.take(lv * 4);
    x.sf = c.take(lv);
    x.rv = (float*)c.take(lv * 3 * 4);
    x.rc = (int32_t*)c.take(lv * 4);
    x.rf = c.take(lv);
    x.flags = c.take((size_t)V);
    x.pick = c.take((size_t)N);
    x.guard = c.take((size_t)N);
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

__global__ void __launch_bounds__(MAX_NT)
victims_kernel(const Args a) {
    const int tid = threadIdx.x, nt = blockDim.x;
    Work w;
    layout(a.V, a.N, a.ws + (size_t)blockIdx.x * a.ws_bytes, &w);
    __shared__ float s_key[MAX_NT];
    __shared__ int s_rank[MAX_NT];
    __shared__ int s_idx[MAX_NT];
    __shared__ int s_any;
    __shared__ int s_count;
    const float* eps = a.eps;
    const int N = a.N, V = a.V;

    for (int lane = blockIdx.x; lane < a.L; lane += gridDim.x) {
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
                v[r] = a.j_alloc[pjc * 3 + r] + a.p_resreq[lane * 3 + r];
            ls = share3(v, a.ctotal);
        }

        // ---- candidate filter + gang / conformance verdicts -----------
        for (int r = tid; r < V; r += nt) {
            const int vjr = a.v_job[r];
            const bool known = vjr >= 0;
            const int vj = known ? vjr : 0;
            const int jq = a.job_queue[vj];
            const bool live = a.v_live[r] != 0;
            bool cand;
            if (a.filter == K_INTER_QUEUE)
                cand = live && known && jq == pq && vjr != pj;
            else if (a.filter == K_INTRA_JOB)
                cand = live && known && vjr == pj;
            else
                cand = live && known && jq != pq;
            const int mav = a.min_av[vj];
            const bool gang = ((a.ready[vj] - 1 >= mav) || mav == 1) && known;
            w.flags[r] = (uint8_t)((cand ? F_CAND : 0) | (gang ? F_GANG : 0)
                                   | (a.v_crit[r] ? 0 : F_CONF));
            // rows outside every node's live list are never victims
            if (!a.visit)
                ((uint8_t*)a.out)[(size_t)lane * (2 * (size_t)N + V)
                                  + 2 * (size_t)N + r] = 0;
        }
        __syncthreads();

        // ---- drf: cumulative per (node, job) in candidate order -------
        if (a.has_drf) {
            for (int i = tid; i < V; i += nt) {
                const int r = a.perm_nj[i];
                const bool c = w.flags[r] & F_CAND;
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    w.sv[i * 3 + k] = c ? a.v_res[r * 3 + k] : 0.0f;
                w.sc[i] = 0;
                w.sf[i] = a.nj_head[i];
            }
            __syncthreads();
            kb::SegScan<3>{w.sv, w.sc, w.sf, w.rv, w.rc, w.rf}.run(V);
            for (int i = tid; i < V; i += nt) {
                const int r = a.perm_nj[i];
                const int vjr = a.v_job[r];
                const int vj = vjr < 0 ? 0 : vjr;
                float x[3];
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const float vals = w.sv[i * 3 + k];
                    const float excl = w.rv[i * 3 + k] - vals;
                    const float cum = excl + vals;
                    x[k] = a.j_alloc[vj * 3 + k] - cum;
                }
                const float rs = share3(x, a.ctotal);
                const bool ok = ((ls < rs) || (fabsf(ls - rs) <= 1e-6f))
                                && vjr >= 0;
                if (ok) w.flags[r] |= F_DRF;
            }
            __syncthreads();
        }

        // ---- proportion: cumulative per (node, queue) ------------------
        if (a.has_prop) {
            for (int i = tid; i < V; i += nt) {
                const int r = a.perm_nq[i];
                const int vjr = a.v_job[r];
                const int vq = a.job_queue[vjr < 0 ? 0 : vjr];
                const bool elig = (w.flags[r] & F_CAND) && vq >= 0
                                  && a.q_prop_ok[vq < 0 ? 0 : vq];
#pragma unroll
                for (int k = 0; k < 3; ++k)
                    w.sv[i * 3 + k] = elig ? a.v_res[r * 3 + k] : 0.0f;
                w.sc[i] = 0;
                w.sf[i] = a.nq_head[i];
            }
            __syncthreads();
            kb::SegScan<3>{w.sv, w.sc, w.sf, w.rv, w.rc, w.rf}.run(V);
            for (int i = tid; i < V; i += nt) {
                const int r = a.perm_nq[i];
                const int vjr = a.v_job[r];
                const int vq = a.job_queue[vjr < 0 ? 0 : vjr];
                const int vqc = vq < 0 ? 0 : vq;
                const bool elig = (w.flags[r] & F_CAND) && vq >= 0
                                  && a.q_prop_ok[vqc];
                bool ok = elig, guard = elig;
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    const float excl = w.rv[i * 3 + k] - w.sv[i * 3 + k];
                    const float before = a.q_alloc[vqc * 3 + k] - excl;
                    const float vr = a.v_res[r * 3 + k];
                    const float after = before - vr;
                    ok = ok && le_eps(a.q_des[vqc * 3 + k], after, eps[k]);
                    guard = guard && (before < vr);
                }
                w.flags[r] |= (uint8_t)((ok ? F_PROP : 0)
                                        | (guard ? F_GUARD : 0));
            }
            __syncthreads();
        }

        // ---- per node: first non-empty tier, validation, pickability --
        uint8_t* out_row = a.visit ? nullptr
            : (uint8_t*)a.out + (size_t)lane * (2 * (size_t)N + V);
        for (int n = tid; n < N; n += nt) {
            const int beg = a.node_off[n], end = a.node_off[n + 1];
            uint8_t need = 0;
            for (int t = 0; t < a.n_tiers && !need; ++t) {
                const uint8_t m = tier_need(a.tiers[t]);
                for (int q = beg; q < end; ++q)
                    if ((w.flags[a.node_rows[q]] & m) == m) { need = m; break; }
            }
            float tot[3] = {0.0f, 0.0f, 0.0f};
            bool any_v = false, guard = false;
            for (int q = beg; q < end; ++q) {
                const int r = a.node_rows[q];
                uint8_t f = w.flags[r];
                guard = guard || (f & F_GUARD);
                const bool vic = need && (f & need) == need
                                 && (!a.veto || (f & F_CONF));
                if (vic) {
                    any_v = true;
#pragma unroll
                    for (int k = 0; k < 3; ++k) tot[k] = tot[k] + a.v_res[r * 3 + k];
                    w.flags[r] = f | F_VICTIM;
                }
                if (out_row) out_row[2 * (size_t)N + r] = vic ? 1 : 0;
            }
            const bool valid = any_v && !(tot[0] < p_res[0]
                                          && tot[1] < p_res[1]
                                          && tot[2] < p_res[2]);
            bool base = a.node_ok[n] && a.sig_pred[(size_t)sig * N + n];
            if (a.room) base = base && a.n_tasks[n] < a.maxt[n];
            const bool pick = base && (valid || guard);
            if (out_row) {
                out_row[n] = pick ? 1 : 0;
                out_row[N + n] = guard ? 1 : 0;
            } else {
                w.pick[n] = (pick && !a.visited[n]) ? 1 : 0;
                w.guard[n] = guard ? 1 : 0;
            }
        }
        __syncthreads();
        if (!a.visit) continue;

        // ---- the visit: first pickable node in (-score, rank) order ---
        if (tid == 0) { s_any = 0; s_count = 0; }
        __syncthreads();
        for (int n = tid; n < N; n += nt)
            if (w.pick[n]) s_any = 1;
        __syncthreads();
        const bool found = s_any != 0;
        float bk = INFINITY;
        int br = 0x7fffffff, bi = 0x7fffffff;
        for (int n = tid; n < N; n += nt) {
            if (found && !w.pick[n]) continue;
            float key = 0.0f;
            if (a.score) {
                float score = a.sig_scores[(size_t)sig * N + n];
                if (a.dyn)
                    score = score + kb::dynamic_node_score(
                        a.nz_req[2 * n], a.nz_req[2 * n + 1], a.p_nz[0],
                        a.p_nz[1], a.cap[2 * n], a.cap[2 * n + 1],
                        a.dynw[0], a.dynw[1]);
                key = -score;
            }
            const int rank = a.host_rank[n];
            if (key_less(key, rank, n, bk, br, bi)) {
                bk = key; br = rank; bi = n;
            }
        }
        s_key[tid] = bk;
        s_rank[tid] = br;
        s_idx[tid] = bi;
        __syncthreads();
        for (int s = nt / 2; s > 0; s >>= 1) {
            if (tid < s && key_less(s_key[tid + s], s_rank[tid + s],
                                    s_idx[tid + s], s_key[tid], s_rank[tid],
                                    s_idx[tid])) {
                s_key[tid] = s_key[tid + s];
                s_rank[tid] = s_rank[tid + s];
                s_idx[tid] = s_idx[tid + s];
            }
            __syncthreads();
        }
        const int node = s_idx[0];
        int32_t* out = (int32_t*)a.out;
        int cnt = 0;
        for (int r = tid; r < V; r += nt) {
            const bool m = (w.flags[r] & F_VICTIM) && a.v_node[r] == node;
            out[4 + r] = m ? 1 : 0;
            cnt += m ? 1 : 0;
        }
        if (cnt) atomicAdd(&s_count, cnt);
        __syncthreads();
        if (tid == 0) {
            out[0] = found ? 1 : 0;
            out[1] = node;
            out[2] = s_count;
            out[3] = w.guard[node];
        }
    }
}

}  // namespace

extern "C" int kb_victims_workspace(int V, int N) {
    return (int)layout(V, N, nullptr, nullptr);
}

// ptrs: N_PTRS device pointers (host array); ints: N_INTS (host array)
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
    const int blocks = ints[I_BLOCKS], threads = ints[I_NT];
    if (a.L <= 0 || blocks <= 0) return 0;
    if (threads <= 0 || threads > MAX_NT || (threads & (threads - 1)))
        return (int)cudaErrorInvalidValue;
    victims_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
