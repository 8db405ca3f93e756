// The whole allocate action as one persistent thread block.
//
// Replaces kubebatch_tpu/kernels/fused.py:112 fused_allocate (a
// lax.while_loop placing one task per iteration), with
// kubebatch_tpu/kernels/solver.py:67 dynamic_node_score inside it
// (node_score.cuh) and kubebatch_tpu/kernels/telemetry.py:95
// decision_frame as the epilogue. The plain PyTorch version is
// kubebatch_tpu_torch/kernels/fused.py fused_allocate_plain; every float
// operation here is that version's, in the same order, so the host block
// and the node carries agree bit for bit (built with -fmad=false).
//
// What bounds it on an H100: neither bytes nor operations. The inputs are
// ~2 MB at cfg5 (0.6 us at 3.35 TB/s) and each iteration does ~80 float
// operations per node, but the iterations form a dependence chain: the
// next placement reads the node state the previous one wrote. The floor
// is iterations x (one pass over the N nodes + ~10 block-wide barriers
// and reductions). Design:
//  - one block of 1024 threads runs the loop, so every placement stays on
//    the SM (no host round trip, no launch per placement); the queue and
//    job scalars live in shared memory, the state arrays in global memory
//    that stays in L1/L2;
//  - a prologue buckets the task indices by job (a CSR built with atomics),
//    so the task pick scans the visited job's tasks with one warp instead
//    of all T tasks; the pick is still the lexicographic minimum over the
//    job's tasks by (rank, index), so the order inside a bucket is free;
//  - the node pass evaluates predicate, fit and score for 8 nodes per
//    thread and reduces (score, lowest index) across the block; thread 0
//    then re-evaluates the winning node with the same code and applies the
//    updates;
//  - the epilogue writes the telemetry frame into the same int32 host
//    block as the decisions, so the host reads one buffer per cycle.
// Using more than one SM (a cluster sharing the node pass) is later work.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "node_score.cuh"

namespace {

constexpr int NT = 1024;                 // threads in the block
constexpr int NWARPS = NT / 32;
constexpr float BIG = 3.0e38f;           // _lex_argmin's masked-out key
constexpr int TELEM_WIDTH = 20;
constexpr int WAVE_SLOTS = 4;
constexpr int ENGINE_FUSED = 3;
constexpr unsigned FULL = 0xffffffffu;

enum { SKIP = 0, ALLOC = 1, ALLOC_OB = 2, PIPELINE = 3, FAIL = 4 };
// order-key codes (kernels/fused.py JOB_KEY_CODES); K_RANK is the
// creation-rank tie-break every key list ends with
enum { K_PRIORITY = 0, K_GANG_READY = 1, K_DRF_SHARE = 2, K_RANK = 3 };

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
    // workspace
    int32_t* entries;      // [Q]
    int32_t* alloc_cnt;    // [J]
    int32_t* job_in_pq;    // [J]
    int32_t* job_start;    // [J + 1]
    int32_t* job_fill;     // [J]
    int32_t* job_tasks;    // [T]
    float* q_alloc;        // [Q, 3]
    float* j_alloc;        // [J, 3]
    // output: int32 [3, T + 1 + TELEM_WIDTH]
    int32_t* host_block;
    int n_nodes, n_tasks_total, n_jobs, n_queues;
    int job_keys[3];
    int n_job_keys;
    int use_prop_share;
    int gang_enabled, prop_overused, dyn_enabled, max_iters;
    int narrow, narrow_gate;
};

// jnp.min semantics: NaN propagates
__device__ __forceinline__ float nanmin2(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b < a ? b : a;
}

// jnp.max semantics: NaN propagates
__device__ __forceinline__ float nanmax2(float a, float b) {
    if (a != a) return a;
    if (b != b) return b;
    return b > a ? b : a;
}

__device__ __forceinline__ float warp_min_f(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = nanmin2(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_min_i(int v) {
    for (int o = 16; o > 0; o >>= 1)
        v = min(v, __shfl_xor_sync(FULL, v, o));
    return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
    for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// block-wide minimum, result in every thread
__device__ float block_min_f(float v, float* s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_min_f(v);
    if (lane == 0) s[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = warp_min_f(s[lane]);
        if (lane == 0) s[0] = v;
    }
    __syncthreads();
    const float r = s[0];
    __syncthreads();
    return r;
}

__device__ int block_min_i(int v, int* s) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    v = warp_min_i(v);
    if (lane == 0) s[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = warp_min_i(s[lane]);
        if (lane == 0) s[0] = v;
    }
    __syncthreads();
    const int r = s[0];
    __syncthreads();
    return r;
}

// (value, index) maximum with the lowest index winning ties: jnp.argmax
__device__ __forceinline__ void amax_combine(float& v, int& i, float v2,
                                             int i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

__device__ int block_argmax(float v, int i, float* sf, int* si) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(FULL, v, o);
        const int i2 = __shfl_xor_sync(FULL, i, o);
        amax_combine(v, i, v2, i2);
    }
    if (lane == 0) {
        sf[warp] = v;
        si[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
        v = sf[lane];
        i = si[lane];
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_xor_sync(FULL, v, o);
            const int i2 = __shfl_xor_sync(FULL, i, o);
            amax_combine(v, i, v2, i2);
        }
        if (lane == 0) si[0] = i;
    }
    __syncthreads();
    const int r = si[0];
    __syncthreads();
    return r;
}

// _share: max over the 3 resources of alloc/denom with 0/0 -> 0, x/0 -> 1
__device__ __forceinline__ float share3(const float* alloc,
                                        const float* denom) {
    float m = 0.0f;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float a = alloc[r], d = denom[r];
        const float f = (d == 0.0f) ? (a == 0.0f ? 0.0f : 1.0f)
                                    : a / fmaxf(d, 1e-30f);
        m = (r == 0) ? f : nanmax2(m, f);
    }
    return m;
}

__device__ __forceinline__ float job_key(const Params& p, int code, int j) {
    switch (code) {
        case K_PRIORITY: return -p.job_priority[j];
        case K_GANG_READY:
            return (p.alloc_cnt[j] >= p.order_min_available[j]) ? 1.0f : 0.0f;
        case K_DRF_SHARE: return share3(p.j_alloc + 3 * j, p.cluster_total);
        default: return (float)p.job_create_rank[j];
    }
}

__device__ __forceinline__ float queue_key(const Params& p, int code,
                                           int q) {
    // code 0: proportion share (when enabled), otherwise creation rank
    return code == 0 ? share3(p.q_alloc + 3 * q, p.q_deserved + 3 * q)
                     : (float)p.q_create_rank[q];
}

// _lex_argmin over the jobs of queue qi, every thread gets the result
__device__ int job_lex_argmin(const Params& p, int qi, float* sf, int* si) {
    int codes[4];
    const int nk = p.n_job_keys + 1;
    for (int k = 0; k < p.n_job_keys; ++k) codes[k] = p.job_keys[k];
    codes[nk - 1] = K_RANK;
    float kmin[4];
    for (int pass = 0; pass < nk; ++pass) {
        float v = BIG;
        for (int j = threadIdx.x; j < p.n_jobs; j += NT) {
            if (!(p.job_valid[j] && p.job_in_pq[j] && p.job_queue[j] == qi))
                continue;
            bool m = true;
            for (int k = 0; k < pass; ++k)
                m = m && (job_key(p, codes[k], j) == kmin[k]);
            if (m) v = nanmin2(v, job_key(p, codes[pass], j));
        }
        kmin[pass] = block_min_f(v, sf);
    }
    int best = INT32_MAX;
    for (int j = threadIdx.x; j < p.n_jobs; j += NT) {
        if (!(p.job_valid[j] && p.job_in_pq[j] && p.job_queue[j] == qi))
            continue;
        bool m = true;
        for (int k = 0; k < nk; ++k)
            m = m && (job_key(p, codes[k], j) == kmin[k]);
        if (m) {
            best = j;
            break;
        }
    }
    best = block_min_i(best, si);
    return best == INT32_MAX ? -1 : best;
}

struct NodeEval {
    float masked;
    bool eligible;
    bool fit_alloc;
    bool fit_idle;
};

// predicate + fit + score for task (t_init, t_nz, sig) on node n
__device__ __forceinline__ NodeEval eval_node(const Params& p, int n,
                                              const float* t_init,
                                              const float* t_nz,
                                              const float* srow,
                                              const uint8_t* prow) {
    const float* idle = p.idle + 3 * n;
    const float* back = p.backfilled + 3 * n;
    const float* rel = p.rel + 3 * n;
    bool fit_alloc = true, fit_idle = true, fit_pipe = true;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        const float e = p.eps[r];
        const float accessible = idle[r] + back[r];
        fit_alloc = fit_alloc && (t_init[r] <= accessible + e);
        fit_idle = fit_idle && (t_init[r] <= idle[r] + e);
        fit_pipe = fit_pipe && (t_init[r] <= rel[r] + e);
    }
    const bool room = p.n_tasks[n] < p.max_task_num[n];
    const bool pred = p.node_ok[n] && room && prow[n];
    NodeEval out;
    out.eligible = pred && (fit_alloc || fit_pipe);
    out.fit_alloc = fit_alloc;
    out.fit_idle = fit_idle;
    float score = srow[n];
    if (p.dyn_enabled) {
        score = score + kb::dynamic_node_score(
            p.nz[2 * n], p.nz[2 * n + 1], t_nz[0], t_nz[1],
            p.alloc_cm[2 * n], p.alloc_cm[2 * n + 1], p.dyn_weights[0],
            p.dyn_weights[1]);
    }
    out.masked = out.eligible ? score : -INFINITY;
    return out;
}

__global__ void __launch_bounds__(NT, 1) fused_allocate_kernel(const Params p) {
    __shared__ float s_f[NWARPS];
    __shared__ int s_i[NWARPS];
    __shared__ int s_cont, s_current, s_seq, s_it, s_jstar, s_tstar;
    __shared__ int s_qi, s_have_q, s_overused;
    __shared__ int s_cnt[4 + WAVE_SLOTS];

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int T = p.n_tasks_total, N = p.n_nodes, J = p.n_jobs,
              Q = p.n_queues;
    const int W = T + 1 + TELEM_WIDTH;
    int32_t* t_state = p.host_block;
    int32_t* t_node = p.host_block + W;
    int32_t* t_seq = p.host_block + 2 * W;

    // ---- prologue: the while loop's initial state ------------------------
    for (int i = tid; i < T; i += NT) {
        t_state[i] = SKIP;
        t_node[i] = -1;
        t_seq[i] = INT32_MAX;
    }
    for (int j = tid; j < J; j += NT) {
        p.alloc_cnt[j] = p.init_allocated[j];
        p.job_in_pq[j] = p.job_valid[j] ? 1 : 0;
        p.job_fill[j] = 0;
        for (int r = 0; r < 3; ++r) p.j_alloc[3 * j + r] = p.j_alloc0[3 * j + r];
    }
    for (int q = tid; q < Q; q += NT) {
        p.entries[q] = p.q_entries[q];
        for (int r = 0; r < 3; ++r) p.q_alloc[3 * q + r] = p.q_alloc0[3 * q + r];
    }
    __syncthreads();
    // task indices bucketed by job: count, scan, place
    for (int i = tid; i < T; i += NT) {
        const int j = p.task_job[i];
        if (j >= 0 && j < J) atomicAdd(&p.job_fill[j], 1);
    }
    __syncthreads();
    if (tid == 0) {
        int acc = 0;
        for (int j = 0; j < J; ++j) {
            p.job_start[j] = acc;
            acc += p.job_fill[j];
            p.job_fill[j] = 0;
        }
        p.job_start[J] = acc;
        s_current = -1;
        s_seq = 0;
        s_it = 0;
    }
    __syncthreads();
    for (int i = tid; i < T; i += NT) {
        const int j = p.task_job[i];
        if (j >= 0 && j < J)
            p.job_tasks[p.job_start[j] + atomicAdd(&p.job_fill[j], 1)] = i;
    }
    __syncthreads();

    // ---- the while loop: one placement (or one skip) per iteration -------
    for (;;) {
        if (tid == 0) {
            bool any = false;
            for (int q = 0; q < Q; ++q) any = any || (p.entries[q] > 0);
            s_cont = (s_it < p.max_iters) && (any || s_current >= 0);
        }
        __syncthreads();
        if (!s_cont) break;
        const int current = s_current;

        if (current < 0) {
            // queue pick: _lex_argmin over queues with entries left
            if (tid == 0) {
                int codes[2];
                int nk = 0;
                if (p.use_prop_share) codes[nk++] = 0;
                codes[nk++] = 1;
                float kmin[2];
                for (int pass = 0; pass < nk; ++pass) {
                    float v = BIG;
                    for (int q = 0; q < Q; ++q) {
                        if (p.entries[q] <= 0) continue;
                        bool m = true;
                        for (int k = 0; k < pass; ++k)
                            m = m && (queue_key(p, codes[k], q) == kmin[k]);
                        if (m) v = nanmin2(v, queue_key(p, codes[pass], q));
                    }
                    kmin[pass] = v;
                }
                int qs = -1;
                for (int q = 0; q < Q && qs < 0; ++q) {
                    if (p.entries[q] <= 0) continue;
                    bool m = true;
                    for (int k = 0; k < nk; ++k)
                        m = m && (queue_key(p, codes[k], q) == kmin[k]);
                    if (m) qs = q;
                }
                const int qi = qs < 0 ? 0 : qs;
                bool overused = false;
                if (p.prop_overused) {
                    overused = true;
                    for (int r = 0; r < 3; ++r)
                        overused = overused &&
                            (p.q_deserved[3 * qi + r] <
                             p.q_alloc[3 * qi + r] + p.eps[r]);
                }
                s_qi = qi;
                s_have_q = qs >= 0;
                s_overused = overused;
            }
            __syncthreads();
            const int qi = s_qi;
            const bool have_q = s_have_q, overused = s_overused;
            int j_sel = -1;
            if (have_q && !overused) j_sel = job_lex_argmin(p, qi, s_f, s_i);
            if (tid == 0) {
                // the popped queue is overused or has no job: its entry
                // is consumed
                if (have_q && (overused || j_sel < 0)) p.entries[qi] -= 1;
                s_jstar = j_sel;
            }
        } else if (tid == 0) {
            s_jstar = current;       // resume the visit
        }
        __syncthreads();
        const int jstar = s_jstar;

        // task pick: lowest (rank, index) among the job's pending tasks
        if (tid < 32) {
            int ts = -1;
            if (jstar >= 0) {
                const int b = p.job_start[jstar], e = p.job_start[jstar + 1];
                float v = BIG;
                for (int k = b + lane; k < e; k += 32) {
                    const int i = p.job_tasks[k];
                    if (p.task_valid[i] && t_state[i] == SKIP)
                        v = nanmin2(v, (float)p.task_rank[i]);
                }
                v = warp_min_f(v);
                int best = INT32_MAX;
                for (int k = b + lane; k < e; k += 32) {
                    const int i = p.job_tasks[k];
                    if (p.task_valid[i] && t_state[i] == SKIP
                            && (float)p.task_rank[i] == v)
                        best = min(best, i);
                }
                best = warp_min_i(best);
                ts = best == INT32_MAX ? -1 : best;
            }
            if (lane == 0) s_tstar = ts;
        }
        __syncthreads();
        const int tstar = s_tstar;

        if (tstar >= 0) {
            // node solve: argmax of the masked score over all nodes
            const int sig = p.task_sig[tstar];
            const float* t_init = p.init_resreq + 3 * tstar;
            const float* t_nz = p.task_nz + 2 * tstar;
            const float* srow = p.sig_scores + (size_t)sig * N;
            const uint8_t* prow = p.sig_pred + (size_t)sig * N;
            float bv = -INFINITY;
            int bi = INT32_MAX;
            for (int n = tid; n < N; n += NT) {
                const NodeEval ev = eval_node(p, n, t_init, t_nz, srow, prow);
                if (bi == INT32_MAX || ev.masked > bv) {
                    bv = ev.masked;
                    bi = n;
                }
            }
            const int best = block_argmax(bv, bi, s_f, s_i);
            if (tid == 0) {
                const NodeEval ev = eval_node(p, best, t_init, t_nz, srow,
                                              prow);
                const int ji = jstar;
                bool visit_ends;
                if (ev.eligible) {
                    const bool is_alloc = ev.fit_alloc;
                    const bool over_backfill = is_alloc && !ev.fit_idle;
                    t_state[tstar] = !is_alloc ? PIPELINE
                                   : (over_backfill ? ALLOC_OB : ALLOC);
                    t_node[tstar] = best;
                    t_seq[tstar] = s_seq;
                    const float* t_req = p.resreq + 3 * tstar;
                    float* pool = is_alloc ? p.idle : p.rel;
                    const int jqi = p.job_queue[ji];
                    for (int r = 0; r < 3; ++r) {
                        pool[3 * best + r] = pool[3 * best + r] - t_req[r];
                        p.q_alloc[3 * jqi + r] = p.q_alloc[3 * jqi + r] + t_req[r];
                        p.j_alloc[3 * ji + r] = p.j_alloc[3 * ji + r] + t_req[r];
                    }
                    p.n_tasks[best] += 1;
                    p.nz[2 * best] = p.nz[2 * best] + t_nz[0];
                    p.nz[2 * best + 1] = p.nz[2 * best + 1] + t_nz[1];
                    if (!over_backfill) p.alloc_cnt[ji] += 1;
                    visit_ends = p.gang_enabled
                        ? (p.alloc_cnt[ji] >= p.min_available[ji]) : true;
                } else {
                    t_state[tstar] = FAIL;
                    t_seq[tstar] = s_seq;
                    p.job_in_pq[ji] = 0;       // job dropped this cycle
                    visit_ends = true;
                }
                s_seq += 1;
                s_current = visit_ends ? -1 : ji;
                s_it += 1;
            }
        } else if (tid == 0) {
            // no pending task left: the job leaves its queue
            if (jstar >= 0) p.job_in_pq[jstar] = 0;
            s_current = -1;
            s_it += 1;
        }
        __syncthreads();
    }

    // ---- epilogue: decision_frame into the host block --------------------
    if (tid < 4 + WAVE_SLOTS) s_cnt[tid] = 0;
    __syncthreads();
    const int stride = p.max_iters > 1 ? p.max_iters : 1;
    int c_bound = 0, c_failed = 0, c_pending = 0, c_census = 0;
    int c_wave[WAVE_SLOTS] = {0, 0, 0, 0};
    for (int i = tid; i < T; i += NT) {
        if (!p.task_valid[i]) continue;
        const int s = t_state[i];
        const bool placed = s == ALLOC || s == ALLOC_OB || s == PIPELINE;
        c_census += 1;
        c_bound += placed ? 1 : 0;
        c_failed += s == FAIL ? 1 : 0;
        c_pending += s == SKIP ? 1 : 0;
        if (placed) {
            int slot = t_seq[i] / stride;
            slot = slot < 0 ? 0 : (slot > WAVE_SLOTS - 1 ? WAVE_SLOTS - 1 : slot);
            c_wave[slot] += 1;
        }
    }
    int vals[4 + WAVE_SLOTS] = {c_bound, c_failed, c_pending, c_census,
                                c_wave[0], c_wave[1], c_wave[2], c_wave[3]};
    for (int k = 0; k < 4 + WAVE_SLOTS; ++k) {
        const int v = warp_sum_i(vals[k]);
        if (lane == 0 && v) atomicAdd(&s_cnt[k], v);
    }
    __syncthreads();
    if (tid < 3 * (1 + TELEM_WIDTH)) {
        const int row = tid / (1 + TELEM_WIDTH);
        const int col = tid % (1 + TELEM_WIDTH);
        int v = 0;
        if (col == 0) {
            v = s_it;                        // iteration count column
        } else {
            const int f = col - 1;           // telemetry field index
            if (f == 0) v = ENGINE_FUSED;
            else if (f == 1) v = s_it;
            else if (f >= 2 && f < 6) v = s_cnt[f - 2];
            else if (f >= 6 && f < 6 + WAVE_SLOTS) v = s_cnt[4 + (f - 6)];
            else if (f == 12) v = p.narrow ? 1 : 0;
            else if (f == 13) v = p.narrow_gate ? 1 : 0;
        }
        p.host_block[row * W + T + col] = v;
    }
}

}  // namespace

// Plain C entry point for ctypes. Pointer arguments are device pointers;
// ws_i32 holds Q + 4J + 1 + T int32 and ws_f32 3Q + 3J float32 of
// scratch. Returns cudaGetLastError() after the launch.
extern "C" int kb_fused_allocate(
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
        const void* eps, void* ws_i32, void* ws_f32, void* host_block,
        int n_nodes, int n_tasks_total, int n_jobs, int n_queues,
        int job_key0, int job_key1, int job_key2, int n_job_keys,
        int use_prop_share, int gang_enabled, int prop_overused,
        int dyn_enabled, int max_iters, int narrow, int narrow_gate,
        void* stream) {
    if (n_job_keys < 0 || n_job_keys > 3) return (int)cudaErrorInvalidValue;
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
    int32_t* wi = (int32_t*)ws_i32;
    p.entries = wi;
    wi += n_queues;
    p.alloc_cnt = wi;
    wi += n_jobs;
    p.job_in_pq = wi;
    wi += n_jobs;
    p.job_start = wi;
    wi += n_jobs + 1;
    p.job_fill = wi;
    wi += n_jobs;
    p.job_tasks = wi;
    float* wf = (float*)ws_f32;
    p.q_alloc = wf;
    p.j_alloc = wf + 3 * n_queues;
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
    fused_allocate_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(p);
    return (int)cudaGetLastError();
}
