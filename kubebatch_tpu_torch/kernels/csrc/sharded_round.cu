// The node-sharded batched round: one rank's steps between the
// collectives, each a cooperative launch on the rank's node block.
//
// Replaces kubebatch_tpu/kernels/batched_sharded.py:130 _sharded_entry
// (the batched round loop of kubebatch_tpu/kernels/batched.py under
// GSPMD with the node axis split over a mesh, compaction off) without its
// affinity branch, with kubebatch_tpu/kernels/telemetry.py:95
// decision_frame as the last step (ENGINE_SHARDED). The plain PyTorch
// version is kubebatch_tpu_torch/kernels/batched_sharded.py PlainRank;
// every float operation here is that version's (and the one-card
// batched kernel's), in the same order, so each step's payload and the
// node carry agree bit for bit (built with -fmad=false, IEEE division,
// no float atomics; see batched_allocate.cu).
//
// The host (kernels/batched_sharded.py CudaRank) runs a round as five
// launches joined by all-gathers of int32 words:
//  rows1   the replicated job chain (batched_round.cuh job_order, engage,
//          window, rank_tasks) with the demand window's column sums over
//          the gathered accessible pool; the block's [P, N_block] pair
//          scores and the row pass over the block (one warp per task
//          row, eligibility, fit and the (score, lowest index) argmax in
//          registers), writing per task (any, score bits, global index,
//          the carry row at the block's best);
//  cols    the first maximum over the ranks' partials, fail / kill /
//          part2 and the majority pair (replicated); the block's
//          waterfall columns;
//  owner   the waterfall's [N] sort and tiled cumsums on the gathered
//          columns (replicated); each part2 task's slot, and for slots in
//          the block the owner's answer: the slot's eligibility and row;
//  retry   proposals and phase-1 acceptance from the gathered rows
//          (replicated), the commit's segment sums on the block, the
//          retry row pass over the block on the mid-round carry;
//  finish  the retry's acceptance and commit, the job / queue
//          aggregates, the decisions (batched_round.cuh commit_round),
//          progress into flags[0], the next accessible pool.
// Plus start (the initial carry, the first pool), stranded / rollback
// (the stranded-gang epilogue: the node part on the block, the job part
// replicated) and frame. The workspace (batched_round.cuh's Work, sized
// for the whole node bucket, plus this file's SWork) lives across the
// launches; nothing of size [T, N] is stored.
//
// What bounds it on an H100: as for batched_allocate.cu, the [T, N_block]
// row passes (~4-7 float operations a cell) and the [P, N_block] pair
// scores are the operations; between them each launch runs a chain of
// dependent block-0 steps over T (the sorts, scans and segment sums),
// replicated on every rank, whose latency bounds it; k ranks sharing one
// card also share its SMs (time-sliced contexts). Fewer launches a round
// and a shorter chain are later work.
#include "batched_round.cuh"

namespace {

constexpr int ENGINE_SHARDED = 5;
constexpr int W_AVAIL = 6, W_ROW = 10, W_PART = 13, W_COLS = 5, W_OWN = 11;

// the steps, in kernels/batched_sharded.py SEGMENTS order
enum { SEG_START, SEG_ROWS1, SEG_COLS, SEG_OWNER, SEG_RETRY, SEG_FINISH,
       SEG_STRANDED, SEG_ROLLBACK, SEG_FRAME, N_SEGS };
// int slots past the batched kernel's: the block's first node and size
enum { I_LO = N_INTS, I_NB, N_SINTS };
// pointer slots past the batched kernel's: this file's workspace, flags
enum { P_SWS = N_PTRS, P_FLAGS, N_SPTRS };

struct SWork {
    int32_t* rows_fb;                      // [T, W_ROW] row at the argmax
    int32_t* rows1;                        // [T, W_ROW] row at proposal 1
    int32_t* rows_r;                       // [T, W_ROW] row at the retry's
    int32_t* pw;                           // [T] waterfall slot node
    uint8_t* slot_ok;                      // [T]
};

struct SArgs {
    int seg, a0, a1, a2, lo, nb;
    const int32_t* in;                     // the gathered payload
    int32_t* out;                          // this rank's payload
    int32_t* flags;                        // progress, stranded, count
};

inline size_t shard_layout(const Params& p, char* base, SWork* sw) {
    size_t off = 0;
    auto take = [&](size_t bytes) -> char* {
        char* ptr = base ? base + off : nullptr;
        off = align_up(off + (bytes ? bytes : 1));
        return ptr;
    };
    const size_t T = p.T;
    SWork x;
    x.rows_fb = (int32_t*)take(T * W_ROW * 4);
    x.rows1 = (int32_t*)take(T * W_ROW * 4);
    x.rows_r = (int32_t*)take(T * W_ROW * 4);
    x.pw = (int32_t*)take(T * 4);
    x.slot_ok = (uint8_t*)take(T);
    if (sw) *sw = x;
    return off;
}

__device__ __forceinline__ int32_t fbits(float f) { return __float_as_int(f); }
__device__ __forceinline__ float fval(int32_t i) { return __int_as_float(i); }

struct Shard : Cycle {
    const SWork& sw;
    const SArgs& a;
    int lo, nb;

    __device__ Shard(const Params& p_, const Work& w_, uint64_t* s,
                     const SWork& sw_, const SArgs& a_)
        : Cycle(p_, w_, s), sw(sw_), a(a_), lo(a_.lo), nb(a_.nb) {}

    // ---- the block -------------------------------------------------------

    // grid: accp / relp / basep of the block's nodes from its carry
    __device__ void node_views_block() {
        for (int n = gtid; n < nb; n += gsize) {
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const int i = n * 3 + r;
                w.accp[i] = (p.idle[i] + p.bf[i]) + p.eps[r];
                w.relp[i] = p.rel[i] + p.eps[r];
            }
            w.basep[n] = p.node_ok[n] && p.ntasks[n] < p.maxt[n];
        }
    }

    // grid: the block's [P, nb] pair scores (w.sc, row stride nb)
    __device__ void pair_scores_block() {
        const size_t total = (size_t)p.P * nb;
        const float w0 = p.dynw[0], w1 = p.dynw[1];
        for (size_t i = gtid; i < total; i += gsize) {
            const int q = (int)(i / nb), n = (int)(i % nb);
            float dyn = 0.0f;
            if (p.dyn)
                dyn = kb::dynamic_node_score(
                    p.nz[n * 2], p.nz[n * 2 + 1], p.pair_nz[q * 2],
                    p.pair_nz[q * 2 + 1], p.cap[n * 2], p.cap[n * 2 + 1],
                    w0, w1);
            w.sc[i] = p.sig_scores[(size_t)p.pair_sig[q] * p.NS + n] + dyn;
        }
    }

    // the carry row of local node n: idle + bf, idle, rel, maxt - n_tasks
    __device__ void write_row(int32_t* d, int n) const {
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            d[r] = fbits(p.idle[n * 3 + r] + p.bf[n * 3 + r]);
            d[3 + r] = fbits(p.idle[n * 3 + r]);
            d[6 + r] = fbits(p.rel[n * 3 + r]);
        }
        d[9] = p.maxt[n] - p.ntasks[n];
    }

    // grid: the block's accessible pool rows [nb, W_AVAIL]
    __device__ void avail_out(int32_t* out) {
        for (int n = gtid; n < nb; n += gsize) {
            const bool base = p.node_ok[n] && p.ntasks[n] < p.maxt[n];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const int i = n * 3 + r;
                out[n * W_AVAIL + r] = fbits(
                    base ? fmaxf(p.idle[i] + p.bf[i], 0.0f) : 0.0f);
                out[n * W_AVAIL + 3 + r] = fbits(fmaxf(p.rel[i], 0.0f));
            }
        }
    }

    // grid, one warp per task row with mask[k]: the row pass over the
    // block (batched_round.cuh row_pass without affinity), the partial
    // [W_PART] per task (zeros outside the mask)
    __device__ void row_pass_block(const uint8_t* mask, int32_t* out) {
        const int T = p.T;
        for (int k = gwarp; k < T; k += nwarps) {
            int32_t* o = out + (size_t)k * W_PART;
            if (!mask[k]) {
                if (lane < W_PART) o[lane] = 0;
                continue;
            }
            const int t = w.tmap[k];
            float init[3];
            const int sig = task_row(t, init);
            const float* scp = w.sc + (size_t)p.tpair[t] * nb;
            bool any = false;
            float bv = -INFINITY;
            int bi = IMAX;
            for (int n = lane; n < nb; n += 32) {
                if (!cell(sig, init, n)) continue;
                const float v = scp[n];
                if (!any || v > bv) { bv = v; bi = n; }
                any = true;
            }
            for (int o2 = 16; o2 > 0; o2 >>= 1) {
                const float ov = __shfl_xor_sync(FULL, bv, o2);
                const int oi = __shfl_xor_sync(FULL, bi, o2);
                const int oa = __shfl_xor_sync(FULL, (int)any, o2);
                if (oa && (!any || ov > bv || (ov == bv && oi < bi))) {
                    bv = ov;
                    bi = oi;
                }
                any = any || oa;
            }
            if (lane == 0) {
                const int b = any ? bi : 0;
                o[0] = any ? 1 : 0;
                o[1] = fbits(any ? bv : -INFINITY);
                o[2] = b + lo;
                write_row(o + 3, b);
            }
        }
    }

    // grid: the gathered partials [k, T, W_PART] -> any, the first
    // maximum over the ranks in global node order (node 0 when none),
    // its carry row
    __device__ void combine(const int32_t* g, uint8_t* any_out,
                            int32_t* best_out, int32_t* rows_out) {
        const int T = p.T, K = p.N / nb;
        for (int k = gtid; k < T; k += gsize) {
            bool any = false;
            float bv = 0.0f;
            int br = 0;
            for (int r = 0; r < K; ++r) {
                const int32_t* e = g + ((size_t)r * T + k) * W_PART;
                if (!e[0]) continue;
                const float v = fval(e[1]);
                if (!any || v > bv) { any = true; bv = v; br = r; }
            }
            const int32_t* e = g + ((size_t)br * T + k) * W_PART;
            any_out[k] = any;
            best_out[k] = any ? e[2] : 0;
            for (int i = 0; i < W_ROW; ++i)
                rows_out[(size_t)k * W_ROW + i] = e[3 + i];
        }
    }

    // grid: the launch request fits idle + backfilled at the proposal
    // (batched_round.cuh fit_kind) from the proposal's carry row
    __device__ void fit_rows(const uint8_t* mask, const int32_t* rows,
                             uint8_t* pa) {
        for (int k = gtid; k < p.T; k += gsize) {
            if (!mask[k]) { pa[k] = 0; continue; }
            const int t = w.tmap[k];
            const int32_t* rw = rows + (size_t)k * W_ROW;
            bool fit = true;
            for (int r = 0; r < 3; ++r)
                fit = fit && p.init[t * 3 + r] <= fval(rw[r]) + p.eps[r];
            pa[k] = fit;
        }
    }

    // ---- the replicated chain (block 0) ------------------------------------

    // the demand window's pool: column sums of the gathered pool rows
    // (batched_round.cuh order_jobs' tail) into fscal[0..3)
    __device__ void avail_sum(const int32_t* g) {
        const int N = p.N;
        for (int i = threadIdx.x; i < N * 3; i += blockDim.x)
            w.col_in[i] = fval(g[(i / 3) * W_AVAIL + i % 3]);
        __syncthreads();
        block_column_sum(w.col_in, N, 3, w.col_a, w.col_b, w.fscal);
        if (p.pipe) {
            for (int i = threadIdx.x; i < N * 3; i += blockDim.x)
                w.col_in[i] = fval(g[(i / 3) * W_AVAIL + 3 + i % 3]);
            __syncthreads();
            block_column_sum(w.col_in, N, 3, w.col_a, w.col_b, w.fscal + 3);
            if (threadIdx.x < 3)
                w.fscal[threadIdx.x] = w.fscal[threadIdx.x]
                                       + w.fscal[3 + threadIdx.x];
            __syncthreads();
        }
    }

    // the shared waterfall on the gathered columns [N, W_COLS]
    __device__ void waterfall_gathered(const int32_t* g) {
        const int N = p.N;
        uint64_t* keys = keybuf(p.MN);
        sort_keys(keys, N, p.MN, [&](int n) {
            return ((uint64_t)ord_bits(-fval(g[(size_t)n * W_COLS])) << 32)
                   | (uint32_t)n;
        });
        for (int i = threadIdx.x; i < N; i += blockDim.x) {
            const int n = (int)(keys[i] & 0xffffffffu);
            w.ord_sh[i] = n;
            for (int r = 0; r < 3; ++r)
                w.cm_in[i * 3 + r] = fval(g[(size_t)n * W_COLS + 1 + r]);
            w.cnt_in[i] = fval(g[(size_t)n * W_COLS + 4]);
        }
        waterfall_prefixes(N);
    }

    // batched_round.cuh accept_phase with each proposer's carry row read
    // from rows[k] (the owner's answer) instead of the node arrays
    __device__ void accept_rows(const int32_t* prop, const uint8_t* mask,
                                const uint8_t* pa, const int32_t* rows,
                                uint8_t* acc, uint8_t* ob) {
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
            const int32_t* rw = rows + (size_t)k * W_ROW;
            const bool part = mask[k], al = pa[k];
            const int excl_cnt = w.rcnt[i] - w.scnt[i];
            const bool room = (rw[9] - excl_cnt) > 0;
            bool fa = true, fp = true, fi = true;
            for (int r = 0; r < 3; ++r) {
                const float ea = w.rv[i * 6 + r] - w.sv[i * 6 + r];
                const float ep = w.rv[i * 6 + 3 + r] - w.sv[i * 6 + 3 + r];
                const float in = p.init[t * 3 + r];
                fa = fa && in <= (fval(rw[r]) - ea) + p.eps[r];
                fp = fp && in <= (fval(rw[6 + r]) - ep) + p.eps[r];
                fi = fi && in <= (fval(rw[3 + r]) - ea) + p.eps[r];
            }
            const bool ok_alloc = al && part && room && fa;
            const bool ok_pipe = p.pipe && !al && part && room && fp;
            acc[k] = ok_alloc || ok_pipe;
            ob[k] = ok_alloc && !fi;
        }
        __syncthreads();
    }

    // batched_round.cuh commit_node on the owner's block: the accepted
    // proposals to nodes lo .. lo + nb, per node in task-index order
    __device__ void commit_block(const uint8_t* acc, const int32_t* prop,
                                 const uint8_t* pa, bool fold_nz) {
        uint64_t* keys = segment_keys([&](int k) {
            return acc[k] ? prop[k] : -1;
        });
        for (int m = threadIdx.x; m < nb; m += blockDim.x) {
            const int n = lo + m;
            const int lo_i = lower_bound_u64(keys, p.MT, (uint64_t)n << 32);
            const int hi_i = lower_bound_u64(keys, p.MT,
                                             (uint64_t)(n + 1) << 32);
            if (lo_i == hi_i) continue;
            float sa[3] = {0.0f, 0.0f, 0.0f}, sp[3] = {0.0f, 0.0f, 0.0f};
            float z0 = fold_nz ? p.nz[m * 2] : 0.0f;
            float z1 = fold_nz ? p.nz[m * 2 + 1] : 0.0f;
            for (int i = lo_i; i < hi_i; ++i) {
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
                p.idle[m * 3 + r] = p.idle[m * 3 + r] - sa[r];
                p.rel[m * 3 + r] = p.rel[m * 3 + r] - sp[r];
            }
            p.ntasks[m] += hi_i - lo_i;
            p.nz[m * 2] = fold_nz ? z0 : p.nz[m * 2] + z0;
            p.nz[m * 2 + 1] = fold_nz ? z1 : p.nz[m * 2 + 1] + z1;
        }
        __syncthreads();
    }

    // ---- the steps ---------------------------------------------------------

    __device__ void start() {
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
        sync(PH_SETUP);
        avail_out(a.out);
    }

    __device__ void rows1() {
        if (b0) {
            job_order();
            __syncthreads();
            avail_sum(a.in);
        }
        sync(PH_ORDER);
        engage();
        sync(PH_ENGAGE);
        if (b0) window();
        sync(PH_WINDOW);
        for (int k = gtid; k < p.T; k += gsize) {
            const int j = wrap_job(p.tjob[w.tmap[k]], p.J);
            w.part[k] = w.engaged[k] && w.admitted[j];
        }
        node_views_block();
        pair_scores_block();
        sync(PH_SCORES);
        if (b0) rank_tasks();
        row_pass_block(w.part, a.out);
        sync(PH_ROWS1);
    }

    __device__ void cols() {
        combine(a.in, w.any_elig, w.fb, sw.rows_fb);
        sync(PH_ROWS1);
        fail_and_kill();
        sync(PH_FAIL);
        settle_part2();
        sync(PH_PART2);
        if (b0) maj_pair();
        sync(PH_WATERFALL);
        const int maj = w.iscal[S_MAJ];
        const float* shared_sc = w.sc + (size_t)maj * nb;
        const uint8_t* maj_pred = p.sig_pred + (size_t)p.pair_sig[maj] * p.NS;
        for (int n = gtid; n < nb; n += gsize) {
            int32_t* o = a.out + (size_t)n * W_COLS;
            const bool ok = maj_pred[n] && w.basep[n];
            o[0] = fbits(shared_sc[n]);
            for (int r = 0; r < 3; ++r)
                o[1 + r] = fbits(ok ? fmaxf(p.idle[n * 3 + r]
                                            + p.bf[n * 3 + r], 0.0f)
                                    : 0.0f);
            o[4] = fbits(ok ? (float)max(p.maxt[n] - p.ntasks[n], 0) : 0.0f);
        }
    }

    __device__ void owner() {
        if (b0) waterfall_gathered(a.in);
        sync(PH_WATERFALL);
        const int N = p.N;
        for (int k = gtid; k < p.T; k += gsize) {
            int32_t* o = a.out + (size_t)k * W_OWN;
            if (!w.part2[k]) {
                for (int i = 0; i < W_OWN; ++i) o[i] = 0;
                continue;
            }
            const int t = w.tmap[k];
            int slot = 0;
            for (int r = 0; r < 3; ++r) {
                const float need = w.prefix[k * 3 + r] + p.resreq[t * 3 + r];
                slot = max(slot, search_left(w.cum_mass + r, 3, N, need));
            }
            slot = max(slot, search_left(w.cum_cnt, 1, N,
                                         w.cnt_prefix[k] + 1.0f));
            const int pw = w.ord_sh[min(slot, N - 1)];
            sw.pw[k] = pw;
            sw.slot_ok[k] = slot < N;
            if (pw < lo || pw >= lo + nb) {
                for (int i = 0; i < W_OWN; ++i) o[i] = 0;
                continue;
            }
            float init[3];
            const int sig = task_row(t, init);
            o[0] = cell(sig, init, pw - lo) ? 1 : 0;
            write_row(o + 1, pw - lo);
        }
        sync(PH_PROPOSE);
    }

    __device__ void retry() {
        const int T = p.T;
        for (int k = gtid; k < T; k += gsize) {
            if (!w.part2[k]) continue;
            const int pw = sw.pw[k];
            const int32_t* e = a.in + ((size_t)(pw / nb) * T + k) * W_OWN;
            const bool water = e[0] && sw.slot_ok[k];
            w.prop1[k] = water ? pw : w.fb[k];
            const int32_t* src = water ? e + 1 : sw.rows_fb + (size_t)k * W_ROW;
            for (int i = 0; i < W_ROW; ++i)
                sw.rows1[(size_t)k * W_ROW + i] = src[i];
        }
        sync(PH_PROPOSE);
        fit_rows(w.part2, sw.rows1, w.pa1);
        sync(PH_FIT1);
        if (b0) {
            accept_rows(w.prop1, w.part2, w.pa1, sw.rows1, w.acc1, w.ob1);
            commit_block(w.acc1, w.prop1, w.pa1, true);
        }
        sync(PH_ACCEPT1);
        node_views_block();
        for (int k = gtid; k < T; k += gsize)
            w.mask[k] = w.part2[k] && !w.acc1[k];
        sync(PH_VIEWS2);
        row_pass_block(w.mask, a.out);
        sync(PH_ROWS2);
    }

    __device__ void finish() {
        combine(a.in, w.any_elig, w.fbr, sw.rows_r);
        sync(PH_ROWS2);
        for (int k = gtid; k < p.T; k += gsize)
            w.retry[k] = w.mask[k] && w.any_elig[k];
        sync(PH_RETRY);
        fit_rows(w.retry, sw.rows_r, w.par);
        sync(PH_FIT2);
        if (b0) {
            accept_rows(w.fbr, w.retry, w.par, sw.rows_r, w.accr, w.obr);
            commit_block(w.accr, w.fbr, w.par, false);
            commit_round(a.a0);
            if (threadIdx.x == 0) a.flags[0] = w.iscal[S_PROGRESS];
        }
        sync(PH_ACCEPT2);
        avail_out(a.out);
    }

    __device__ void stranded() {
        if (b0) {
            stranded_jobs(true);
            if (threadIdx.x == 0) a.flags[1] = w.iscal[S_ANY_STRANDED];
        }
        sync(PH_EPILOGUE);
    }

    __device__ void rollback_step() {
        if (b0) {
            rollback_mask(a.a0 != 0);
            rollback_nodes(lo, nb);
            rollback_jobs(a.a0 != 0);
            if (threadIdx.x == 0) a.flags[2] = w.iscal[S_STRANDED];
        }
        sync(PH_EPILOGUE);
        avail_out(a.out);
    }

    __device__ void run() {
        if (gtid == 0) t_last = now_ns();
        switch (a.seg) {
            case SEG_START: start(); break;
            case SEG_ROWS1: rows1(); break;
            case SEG_COLS: cols(); break;
            case SEG_OWNER: owner(); break;
            case SEG_RETRY: retry(); break;
            case SEG_FINISH: finish(); break;
            case SEG_STRANDED: stranded(); break;
            case SEG_ROLLBACK: rollback_step(); break;
            case SEG_FRAME:
                if (b0) frame(a.a0, a.a1, a.a2, ENGINE_SHARDED);
                break;
        }
    }
};

__global__ void __launch_bounds__(NT, 1)
sharded_round_kernel(const __grid_constant__ Params p,
                     const __grid_constant__ Work w,
                     const __grid_constant__ SWork sw,
                     const __grid_constant__ SArgs a) {
    extern __shared__ uint64_t skeys[];
    Shard s(p, w, skeys, sw, a);
    s.run();
}

Params shard_params(const uint64_t* ptrs, const int* ints) {
    Params p = make_params(ptrs, ints);
    p.NS = ints[I_NB];                     // the [S, N_block] rows' stride
    return p;
}

}  // namespace

// Workspace bytes (the round's Work over the whole node bucket, and
// SWork) for these sizes. Returns a cudaError_t (0).
extern "C" int kb_sharded_workspace(const int* ints, int n_ints,
                                    long long* ws_bytes,
                                    long long* sws_bytes) {
    if (n_ints != N_SINTS) return (int)cudaErrorInvalidValue;
    uint64_t ptrs[N_SPTRS] = {0};
    const Params p = shard_params(ptrs, ints);
    *ws_bytes = (long long)layout(p, nullptr, nullptr);
    *sws_bytes = (long long)shard_layout(p, nullptr, nullptr);
    return 0;
}

// Launch step ``seg`` (SEG_*) with its arguments a0..a2 (the round, the
// revive flag, or the frame's rounds / retries / stranded). ptrs:
// N_SPTRS device addresses in the P_* order (the affinity slots null,
// then the two workspaces and the flags); ints: N_SINTS (the batched
// kernel's, the node bucket in I_N, then the block's first node and
// size); in / out: the gathered payload and this rank's (either may be
// null for a step without one); info (host, 3 ints): grid, threads and
// dynamic shared bytes. Returns the cudaError_t of the setup and launch.
extern "C" int kb_sharded_round(const unsigned long long* ptrs, int n_ptrs,
                                const int* ints, int n_ints, int seg, int a0,
                                int a1, int a2, void* in, void* out,
                                int* info, void* stream) {
    if (n_ptrs != N_SPTRS || n_ints != N_SINTS || seg < 0 || seg >= N_SEGS)
        return (int)cudaErrorInvalidValue;
    const Params p = shard_params((const uint64_t*)ptrs, ints);
    const int lo = ints[I_LO], nb = ints[I_NB];
    if (p.T >= (1 << 20) || p.J >= (1 << 24) || p.njk > 3 || p.aff
        || nb < 1 || p.N % nb || lo % nb || lo + nb > p.N)
        return (int)cudaErrorInvalidValue;
    Work w;
    layout(p, (char*)ptrs[P_WS], &w);
    SWork sw;
    shard_layout(p, (char*)ptrs[P_SWS], &sw);
    SArgs a;
    a.seg = seg;
    a.a0 = a0;
    a.a1 = a1;
    a.a2 = a2;
    a.lo = lo;
    a.nb = nb;
    a.in = (const int32_t*)in;
    a.out = (int32_t*)out;
    a.flags = (int32_t*)ptrs[P_FLAGS];
    const size_t smem = smem_bytes(p);
    cudaError_t err = cudaFuncSetAttribute(
        sharded_round_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return (int)err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
        return (int)err;
    if (!coop) return (int)cudaErrorNotSupported;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sharded_round_kernel, NT, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int grid = sms * per_sm;
    info[0] = grid;
    info[1] = NT;
    info[2] = (int)smem;
    Params pc = p;
    Work wc = w;
    SWork swc = sw;
    SArgs ac = a;
    void* args[] = {&pc, &wc, &swc, &ac};
    err = cudaLaunchCooperativeKernel((const void*)sharded_round_kernel,
                                      dim3(grid), dim3(NT), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
