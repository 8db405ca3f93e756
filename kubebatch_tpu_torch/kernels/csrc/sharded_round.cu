// The node-sharded batched round and the two-level solve over the node
// mesh: one rank's steps between the collectives, each a cooperative
// launch on the rank's node block.
//
// Replaces kubebatch_tpu/kernels/batched_sharded.py:130 _sharded_entry
// (the batched round loop of kubebatch_tpu/kernels/batched.py under
// GSPMD with the node axis split over a mesh, compaction off, with its
// affinity branch: _specs_for(affinity=True) :74) and
// kubebatch_tpu/kernels/hier.py:504 _hier_sharded_entry (the two-level
// wave loop under the same placement), with
// kubebatch_tpu/kernels/telemetry.py:95 decision_frame as the last step
// (ENGINE_SHARDED, ENGINE_HIER_SHARDED). The plain PyTorch versions are
// kubebatch_tpu_torch/kernels/batched_sharded.py PlainRank and
// HierPlainRank; every float operation here is theirs (and the one-card
// kernels'), in the same order, so each step's payload and the node carry
// agree bit for bit (built with -fmad=false, IEEE division, no float
// atomics; see batched_allocate.cu).
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
// Inter-pod affinity and host ports reuse batched_round.cuh's affinity
// code with the port words of the block (Params plo / pnb) and node_dom
// over the whole bucket: the views and flags are taken at the end of the
// step that commits (finish, start, rollback), where each rank also
// sends, with the next pool, the min and max of each scoring row's
// interpod counts over its block's real nodes; rows1 combines them, the
// row passes add the predicates and the score (and a "scored" word), the
// slot owner adds the predicates at the slot, retry serializes phase 1
// (aff_serialize, replicated: every rank has every proposal's domains)
// and keeps involved tasks out of the retry, finish commits the carry.
//
// The two-level solve runs the same round in a node window (one pool;
// each rank's part of it, possibly empty; the ints' window slots move
// the node pointers, the window's size replaces N and placements are
// written in global nodes), and adds coarse (hier_coarse.cuh's pass over
// the block: pool bits of the pending tasks, each pool's best majority
// score over the nodes here), wave (the gathered passes combined by OR
// and max, the quarantine, the candidates, the winner and the waiting
// rule, replicated; has-work and winner into flags[3..4]), avail (the
// winning pool's first pool payload) and hframe.
//
// What bounds it on an H100: as for batched_allocate.cu, the [T, N_block]
// row passes (~4-7 float operations a cell, the affinity words' integer
// logic and the interpod sums beside them) and the [P, N_block] pair
// scores are the operations; between them each launch runs a chain of
// dependent steps over T (the sorts, scans and segment sums), replicated
// on every rank, whose latency bounds it. Every step of that chain is
// written once against batched_round.cuh's teams, and past
// GRID_CHAIN_MIN tasks (nodes, for the waterfall's order) it runs on the
// whole cooperative grid, at or below it in block 0, as in the one-card
// round: the window, rank_tasks, commit_round and the affinity
// serialization and commit; this file's acceptances (accept_phase with
// each proposer's carry row from the owner's answer), the commits on the
// rank's part (commit_node on the part's nodes), the gathered waterfall
// (waterfall_chain<true> over the gathered columns, read once into a
// node-major buffer; the [N] order by counting passes and the tiled
// cumsums on the grid past GRID_CHAIN_MIN nodes), the stranded-gang
// rollback (past rollback_min tasks) and the gathers of the payloads.
// The stranded-job scan publishes its words once, after its last
// barrier (batched_round.cuh stranded_jobs). The demand
// window's pool sums take their first level across the grid past
// GRID_CHAIN_MIN nodes, the rest of the tree in block 0 (the same tree).
// The stranded-job scan runs there too (with the rollback). Block 0
// alone keeps the majority pair (a P-long argmax: ~3 us a launch), the
// job order at or below GRID_JOBS_MIN jobs, the wave's one-thread winner
// and the frames. Every barrier is counted (ShardBar). On one card the k
// ranks of a gloo mesh time-slice its SMs; the lock-step driver
// (kernels/batched_sharded.py solve_lockstep) runs each launch alone.
// Fewer launches a round are later work.
#include "hier_coarse.cuh"

namespace {

constexpr int ENGINE_SHARDED = 5, ENGINE_HIER_SHARDED = 6;
constexpr int W_AVAIL = 6, W_ROW = 10, W_PART = 13, W_COLS = WF_COLS,
              W_OWN = 11;
constexpr int W_IP = 2;
constexpr int MAX_RANKS = 16;

// the steps, in kernels/batched_sharded.py SEGMENTS order
enum { SEG_START, SEG_ROWS1, SEG_COLS, SEG_OWNER, SEG_RETRY, SEG_FINISH,
       SEG_STRANDED, SEG_ROLLBACK, SEG_FRAME, SEG_COARSE, SEG_WAVE,
       SEG_AVAIL, SEG_HFRAME, N_SEGS };
// int slots past the batched kernel's: the block's first node and size,
// the ranks, the dynamic score's FMA, the pool width and count (0 in the
// flat solve), then the node window of this launch: its first node and
// width, and whether the tasks the last wave found eligible in another
// pool wait
enum { I_LO = N_INTS, I_NB, I_K, I_FMA, I_POOL, I_B, I_OFF, I_WN, I_ELSE,
       N_SINTS };
// pointer slots past the batched kernel's: this file's workspace, flags
enum { P_SWS = N_PTRS, P_FLAGS, N_SPTRS };
// the wave step's modes (kernels/batched_sharded.py WAVE_*)
enum { WAVE_RESET = 1, WAVE_RECORD = 2, WAVE_TERMINAL = 4 };
// the two-level scalars: has work, winner, pools with candidates and the
// winner's candidates (hier_coarse.cuh coarse_winner), then the first
// wave's occupancy and fill (the frame's)
enum { HS_WORK, HS_WIN, HS_OCC, HS_FILL, HS_OCC0, HS_FILL0, HS_N };
// the two-level phases timed after the round's (kernels/hier.py)
enum { PH_COARSE = N_PHASES, PH_WAVES };

// the cooperative grid's barrier, each one counted in the phase_ns word
// after the two-level phases (the barriers passed)
struct ShardBar : GridBar {
    static constexpr int count_slot = PH_WAVES + 1;
};

struct SWork {
    int32_t* rows_fb;                      // [T, W_ROW] row at the argmax
    int32_t* rows1;                        // [T, W_ROW] row at proposal 1
    int32_t* rows_r;                       // [T, W_ROW] row at the retry's
    int32_t* pw;                           // [T] waterfall slot node
    uint8_t* slot_ok;                      // [T]
    int32_t* cols;                         // [N, W_COLS] gathered columns
    float* pool;                           // [N, 6] gathered pool rows
    float* lev_a;                          // [N / 32 + 2, 6] column sums'
    float* lev_b;                          // tree levels
    // the two-level solve (empty in the flat one)
    uint32_t* tbits;                       // [T, BW] gathered pool bits
    uint8_t* pending;                      // [T]
    uint8_t* elsewhere;                    // [T]
    int32_t* cand;                         // [B]
    float* best;                           // [B]
    uint8_t* blocked;                      // [B]
    int32_t* pdem;                         // [P]
    int32_t* hs;                           // [HS_N]
};

struct SArgs {
    int seg, a0, a1, a2;
    int lo, nb;                            // this rank's part of the window
    int blo, bnb;                          // this rank's block
    int K, off, wn, B, pool;
    const int32_t* in;                     // the gathered payload
    int32_t* out;                          // this rank's payload
    int32_t* flags;                        // progress, stranded, count,
                                           // has work, winner
};

inline size_t shard_layout(const Params& p, int B, char* base, SWork* sw) {
    size_t off = 0;
    auto take = [&](size_t bytes) -> char* {
        char* ptr = base ? base + off : nullptr;
        off = align_up(off + (bytes ? bytes : 1));
        return ptr;
    };
    const size_t T = p.T, BW = (B + 31) / 32, TB = B ? T : 0;
    SWork x;
    x.rows_fb = (int32_t*)take(T * W_ROW * 4);
    x.rows1 = (int32_t*)take(T * W_ROW * 4);
    x.rows_r = (int32_t*)take(T * W_ROW * 4);
    x.pw = (int32_t*)take(T * 4);
    x.slot_ok = (uint8_t*)take(T);
    const size_t N = p.N;
    x.cols = (int32_t*)take(N * W_COLS * 4);
    x.pool = (float*)take(N * 6 * 4);
    x.lev_a = (float*)take((N / 32 + 2) * 6 * 4);
    x.lev_b = (float*)take((N / 32 + 2) * 6 * 4);
    x.tbits = (uint32_t*)take(TB * BW * 4);
    x.pending = (uint8_t*)take(TB);
    x.elsewhere = (uint8_t*)take(TB);
    x.cand = (int32_t*)take((size_t)B * 4);
    x.best = (float*)take((size_t)B * 4);
    x.blocked = (uint8_t*)take(B);
    x.pdem = (int32_t*)take(B ? (size_t)p.P * 4 : 0);
    x.hs = (int32_t*)take(HS_N * 4);
    if (sw) *sw = x;
    return off;
}

__device__ __forceinline__ int32_t fbits(float f) { return __float_as_int(f); }
__device__ __forceinline__ float fval(int32_t i) { return __int_as_float(i); }

struct Shard : CycleT<ShardBar> {
    const SWork& sw;
    const SArgs& a;
    int lo, nb, g0;                        // part: window start, size; its
                                           // first global node
    int K, nbmax, av_stride, col_stride, wp;
    int plo_[MAX_RANKS], pnb_[MAX_RANKS];  // every rank's part

    __device__ Shard(const Params& p_, const Work& w_, uint64_t* s,
                     const SWork& sw_, const SArgs& a_)
        : CycleT<ShardBar>(p_, w_, s), sw(sw_), a(a_), lo(a_.lo), nb(a_.nb),
          g0(a_.off + a_.lo), K(a_.K) {
        nbmax = 0;
        for (int r = 0; r < K; ++r) {
            const int l = min(max(r * a.bnb, a.off), a.off + a.wn) - a.off;
            const int h = min(max((r + 1) * a.bnb, a.off), a.off + a.wn)
                          - a.off;
            plo_[r] = l;
            pnb_[r] = h - l;
            nbmax = max(nbmax, h - l);
        }
        av_stride = nbmax * W_AVAIL + (p.ip ? p.T * W_IP : 0);
        col_stride = nbmax * W_COLS;
        wp = W_PART + (p.ip ? 1 : 0);
    }

    // the rank whose part holds window node n
    __device__ int owner_of(int n) const {
        for (int r = 0; r < K; ++r)
            if (n >= plo_[r] && n < plo_[r] + pnb_[r]) return r;
        return K - 1;
    }

    // ---- the block -------------------------------------------------------

    // grid: accp / relp / basep of the part's nodes from its carry
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

    // grid: the part's [P, nb] pair scores (w.sc, row stride nb; the
    // weighted sum as the graph evaluates it, batched_round.cuh
    // pair_scores)
    __device__ void pair_scores_block() {
        const size_t total = (size_t)p.P * nb;
        const float w0 = p.dynw[0], w1 = p.dynw[1];
        for (size_t i = gtid; i < total; i += gsize) {
            const int q = (int)(i / nb), n = (int)(i % nb);
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

    // grid: the pool payload: the part's accessible pool rows [nbmax,
    // W_AVAIL] (zero rows past the part), then with an interpod score
    // each task row's count range over the part's real nodes
    __device__ void avail_out(int32_t* out) {
        for (int n = gtid; n < nbmax; n += gsize) {
            const bool in = n < nb;
            const bool base = in && p.node_ok[n] && p.ntasks[n] < p.maxt[n];
#pragma unroll
            for (int r = 0; r < 3; ++r) {
                const int i = n * 3 + r;
                out[n * W_AVAIL + r] = fbits(
                    base ? fmaxf(p.idle[i] + p.bf[i], 0.0f) : 0.0f);
                out[n * W_AVAIL + 3 + r] =
                    in ? fbits(fmaxf(p.rel[i], 0.0f)) : 0;
            }
        }
        if (p.aff && p.ip) ip_range(out + nbmax * W_AVAIL);
    }

    // grid, one warp per task row: for a pending valid row that can carry
    // an interpod term at the next round's start, the min and max of its
    // counts over the part's real nodes (+0.0 for -0.0; +inf / -inf with
    // none); zeros for the other rows (kernels/batched_sharded.py
    // PlainRank._ip_words)
    __device__ void ip_range(int32_t* out) {
        for (int t = gwarp; t < p.T; t += nwarps) {
            bool take = false;
            float lo_c = INFINITY, hi_c = -INFINITY;
            if (p.tvalid[t] && p.out[t] == SKIP) {
                const AffRow ar = aff_row(t);
                take = ar.maybe_scored;
                if (take) {
                    for (int n = lane; n < nb; n += 32) {
                        if (!p.node_ok[n]) continue;
                        const float c = ip_counts(t, ar, g0 + n);
                        lo_c = fminf(lo_c, c);
                        hi_c = fmaxf(hi_c, c);
                    }
                    for (int o = 16; o > 0; o >>= 1) {
                        lo_c = fminf(lo_c, __shfl_xor_sync(FULL, lo_c, o));
                        hi_c = fmaxf(hi_c, __shfl_xor_sync(FULL, hi_c, o));
                    }
                }
            }
            if (lane == 0) {
                out[t * W_IP] = take ? fbits(lo_c + 0.0f) : 0;
                out[t * W_IP + 1] = take ? fbits(hi_c + 0.0f) : 0;
            }
        }
    }

    // grid: each row's count range over the whole axis from the gathered
    // pool payloads, rank by rank (w.ip_cmin, w.ip_span)
    __device__ void ip_combine(const int32_t* g) {
        const int base = nbmax * W_AVAIL;
        for (int t = gtid; t < p.T; t += gsize) {
            float lo_c = fval(g[base + t * W_IP]);
            float hi_c = fval(g[base + t * W_IP + 1]);
            for (int r = 1; r < K; ++r) {
                const int32_t* e = g + (size_t)r * av_stride + base
                                   + t * W_IP;
                const float l = fval(e[0]), h = fval(e[1]);
                if (l < lo_c) lo_c = l;
                if (h > hi_c) hi_c = h;
            }
            w.ip_cmin[t] = lo_c;
            w.ip_span[t] = hi_c - lo_c;
        }
    }

    // the affinity views of the committed carry (batched_round.cuh
    // aff_flags, aff_views), then the pool payload
    __device__ void views_and_avail() {
        if (p.aff) {
            if (b0) aff_flags();
            sync(PH_AFF_VIEWS);
            aff_views();
            sync(PH_AFF_VIEWS);
        }
        avail_out(a.out);
    }

    // grid, one warp per task row with mask[k]: the row pass over the part
    // (batched_round.cuh row_pass, the interpod range from ip_combine),
    // the partial [wp] per task (zeros outside the mask, and all zeros
    // for an empty part; the score word +0.0 for -0.0)
    __device__ void row_pass_block(const uint8_t* mask, int32_t* out) {
        const int T = p.T;
        const float ipw = p.ip ? p.ipw[0] : 0.0f;
        for (int k = gwarp; k < T; k += nwarps) {
            int32_t* o = out + (size_t)k * wp;
            if (!mask[k] || nb == 0) {
                if (lane < wp) o[lane] = 0;
                continue;
            }
            const int t = w.tmap[k];
            float init[3];
            const int sig = task_row(t, init);
            const float* scp = w.sc + (size_t)p.tpair[t] * nb;
            AffRow ar;
            if (p.aff) ar = aff_row(t);
            const bool scoring = p.aff && ar.maybe_scored;
            float cmin = 0.0f, span = 0.0f;
            if (scoring) {
                cmin = w.ip_cmin[k];
                span = w.ip_span[k];
            }
            bool any = false, scored = false;
            float bv = -INFINITY;
            int bi = IMAX;
            for (int n = lane; n < nb; n += 32) {
                float tm = 0.0f;
                if (scoring) {
                    // reference _ip_score, in its float order
                    const float c = ip_counts(t, ar, g0 + n);
                    tm = span > 0.0f ? floorf((10.0f * (c - cmin)) / span)
                                     : 0.0f;
                    tm = tm * ipw;
                    scored = scored || tm != 0.0f;
                }
                if (!cell(sig, init, n)) continue;
                if (p.aff && !aff_cell(ar, g0 + n)) continue;
                float v = scp[n];
                if (scoring && p.node_ok[n]) v = v + tm;
                if (!any || v > bv) { bv = v; bi = n; }
                any = true;
            }
            if (p.aff) scored = __any_sync(FULL, scored);
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
                o[1] = fbits((any ? bv : -INFINITY) + 0.0f);
                o[2] = b + lo;
                write_row(o + 3, b);
                if (p.ip) o[W_PART] = scored ? 1 : 0;
            }
        }
    }

    // grid: the gathered partials [k, T, wp] -> any, the first maximum
    // over the ranks in global node order (node 0 when none), its carry
    // row; with an interpod score the rows' "scored" words ORed
    __device__ void combine(const int32_t* g, uint8_t* any_out,
                            int32_t* best_out, int32_t* rows_out) {
        const int T = p.T;
        for (int k = gtid; k < T; k += gsize) {
            bool any = false, scored = false;
            float bv = 0.0f;
            int br = 0;
            for (int r = 0; r < K; ++r) {
                const int32_t* e = g + ((size_t)r * T + k) * wp;
                if (p.ip && e[W_PART]) scored = true;
                if (!e[0]) continue;
                const float v = fval(e[1]);
                if (!any || v > bv) { any = true; bv = v; br = r; }
            }
            const int32_t* e = g + ((size_t)br * T + k) * wp;
            any_out[k] = any;
            best_out[k] = any ? e[2] : 0;
            for (int i = 0; i < W_ROW; ++i)
                rows_out[(size_t)k * W_ROW + i] = e[3 + i];
            if (p.ip) w.ip_scored[k] = scored;
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

    // ---- the replicated steps ---------------------------------------------

    // grid: the gathered pool rows in window order, node-major (sw.pool
    // [N, 3], or [N, 6] with the releasing rows beside them)
    __device__ void pool_rows(const int32_t* g) {
        const int pc = p.pipe ? 6 : 3;
        for (int n = gtid; n < p.N; n += gsize) {
            const int r = owner_of(n);
            const int32_t* e = g + (size_t)r * av_stride
                               + (size_t)(n - plo_[r]) * W_AVAIL;
            for (int c = 0; c < pc; ++c)
                sw.pool[(size_t)n * pc + c] = fval(e[c]);
        }
    }

    // grid: the gathered waterfall columns in window order, node-major
    // (sw.cols [N, W_COLS])
    __device__ void gather_cols(const int32_t* g) {
        for (int n = gtid; n < p.N; n += gsize) {
            const int r = owner_of(n);
            const int32_t* e = g + (size_t)r * col_stride
                               + (size_t)(n - plo_[r]) * W_COLS;
            for (int c = 0; c < W_COLS; ++c)
                sw.cols[(size_t)n * W_COLS + c] = e[c];
        }
    }

    // team: the owner's carry row (accept_phase's carry) of proposer k
    // from rows[k]
    static __device__ __forceinline__ int row_carry(const int32_t* rows,
                                                    int k, float* ac,
                                                    float* id, float* rl) {
        const int32_t* rw = rows + (size_t)k * W_ROW;
        for (int r = 0; r < 3; ++r) {
            ac[r] = fval(rw[r]);
            id[r] = fval(rw[3 + r]);
            rl[r] = fval(rw[6 + r]);
        }
        return rw[9];
    }

    // ---- the round's steps -------------------------------------------------

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
        if (p.aff) aff_setup();
        sync(PH_SETUP);
        views_and_avail();
    }

    // the job order (batched_round.cuh order_jobs), and the demand
    // window's pool: column sums of the gathered pool rows in window order
    // into fscal[0..3) (with pipelining the releasing rows' added), the
    // first level of their tree across the launch past GRID_CHAIN_MIN
    // nodes, the rest in block 0
    __device__ void rows1() {
        const int N = p.N, pc = p.pipe ? 6 : 3;
        const bool grid_jobs = p.J > GRID_JOBS_MIN;
        const bool wide = N > GRID_CHAIN_MIN;
        if (grid_jobs) job_order_grid();
        pool_rows(a.in);
        sync(PH_ORDER);
        if (wide) {
            column_windows(sw.pool, N, pc, sw.lev_a, gtid, gsize);
            sync(PH_ORDER);
        }
        if (b0) {
            if (!grid_jobs) job_order();
            __syncthreads();
            if (wide)
                block_column_sum(sw.lev_a, (N + 31) / 32, pc, sw.lev_b,
                                 sw.lev_a, w.fscal);
            else
                block_column_sum(sw.pool, N, pc, sw.lev_a, sw.lev_b,
                                 w.fscal);
            if (p.pipe && threadIdx.x < 3)
                w.fscal[threadIdx.x] = w.fscal[threadIdx.x]
                                       + w.fscal[3 + threadIdx.x];
        }
        sync(PH_ORDER);
        engage();
        sync(PH_ENGAGE);
        chain(PH_WINDOW, [&](auto tm) { window(tm); });
        sync(PH_WINDOW);
        for (int k = gtid; k < p.T; k += gsize) {
            const int j = wrap_job(p.tjob[w.tmap[k]], p.J);
            w.part[k] = w.engaged[k] && w.admitted[j];
        }
        node_views_block();
        pair_scores_block();
        if (p.aff && p.ip) ip_combine(a.in);
        sync(PH_SCORES);
        chain(PH_ROWS1, [&](auto tm) { rank_tasks(tm); });
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
        for (int n = gtid; n < nbmax; n += gsize) {
            int32_t* o = a.out + (size_t)n * W_COLS;
            if (n >= nb) {
                for (int i = 0; i < W_COLS; ++i) o[i] = 0;
                continue;
            }
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
        gather_cols(a.in);
        sync(PH_WATERFALL);
        waterfall_chain<true>(sw.cols);
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
            bool ok = cell(sig, init, pw - lo);
            if (p.aff) ok = ok && aff_cell(aff_row(t), g0 + pw - lo);
            o[0] = ok ? 1 : 0;
            write_row(o + 1, pw - lo);
        }
        sync(PH_PROPOSE);
    }

    __device__ void retry() {
        const int T = p.T;
        for (int k = gtid; k < T; k += gsize) {
            if (!w.part2[k]) continue;
            const int pw = sw.pw[k];
            const int32_t* e = a.in + ((size_t)owner_of(pw) * T + k) * W_OWN;
            bool water = e[0] && sw.slot_ok[k];
            // interpod-scored tasks leave the shared waterfall
            if (p.ip) water = water && !w.ip_scored[k];
            w.prop1[k] = water ? pw : w.fb[k];
            const int32_t* src = water ? e + 1
                                       : sw.rows_fb + (size_t)k * W_ROW;
            for (int i = 0; i < W_ROW; ++i)
                sw.rows1[(size_t)k * W_ROW + i] = src[i];
        }
        sync(PH_PROPOSE);
        fit_rows(w.part2, sw.rows1, w.pa1);
        sync(PH_FIT1);
        const int32_t* own = sw.rows1;
        chain(PH_ACCEPT1, [&](auto tm) {
            accept_phase(tm, w.prop1, w.part2, w.pa1, w.acc1, w.ob1,
                         [&](int k, int, float* ac, float* id, float* rl) {
                             return row_carry(own, k, ac, id, rl);
                         });
            // remove in-round affinity / port races before the commit
            if (p.aff) aff_serialize(tm);
            commit_node(tm, w.acc1, w.prop1, w.pa1, true, lo, nb);
        });
        sync(PH_ACCEPT1);
        node_views_block();
        for (int k = gtid; k < T; k += gsize)
            w.mask[k] = w.part2[k] && !w.acc1[k]
                        && !(p.aff && involved(w.tmap[k]));
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
        const int32_t* best = sw.rows_r;
        chain(PH_ACCEPT2, [&](auto tm) {
            accept_phase(tm, w.fbr, w.retry, w.par, w.accr, w.obr,
                         [&](int k, int, float* ac, float* id, float* rl) {
                             return row_carry(best, k, ac, id, rl);
                         });
            commit_node(tm, w.accr, w.fbr, w.par, false, lo, nb);
            commit_round(tm, a.a0);
            if (p.aff) aff_commit(tm);
        });
        sync(PH_ACCEPT2);
        if (gtid == 0) a.flags[0] = w.iscal[S_PROGRESS];
        views_and_avail();
    }

    // the stranded jobs (on the whole launch past rollback_min tasks)
    __device__ void stranded() {
        chain_n(p.T, PH_EPILOGUE, [&](auto tm) { stranded_jobs(tm, true); },
                BarT::rollback_min);
        if (gtid == 0) a.flags[1] = w.iscal[S_ANY_STRANDED];
        sync(PH_EPILOGUE);
    }

    // the stranded gangs' placements reverted (batched_round.cuh rollback)
    // on the part's nodes and the replicated jobs, found and reverted on
    // the whole launch past rollback_min tasks
    __device__ void rollback_step() {
        chain_n(p.T, PH_EPILOGUE, [&](auto tm) {
            rollback_mask(tm, a.a0 != 0);
            rollback_nodes(tm, g0, nb);
            rollback_jobs(tm, a.a0 != 0);
        }, BarT::rollback_min);
        if (gtid == 0) a.flags[2] = w.iscal[S_STRANDED];
        sync(PH_EPILOGUE);
        views_and_avail();
    }

    // ---- the two-level steps -----------------------------------------------

    // the coarse pass over the block (hier_coarse.cuh): the pending tasks'
    // pool bits [T, BW] then each pool's best majority score [B] (+0.0
    // for -0.0; -inf for a pool with no node here)
    __device__ void coarse() {
        const int T = p.T, P = p.P, B = a.B, BW = (B + 31) / 32;
        for (int t = gtid; t < T; t += gsize) {
            const int j = max(p.tjob[t], 0);
            sw.pending[t] = p.tvalid[t] && p.out[t] == SKIP && w.alive[j]
                            && p.jvalid[j];
        }
        for (int i = gtid; i < T * BW; i += gsize) a.out[i] = 0;
        for (int q = gtid; q < P; q += gsize) sw.pdem[q] = 0;
        node_views_block();
        sync(PH_COARSE);
        unsigned long long tested = 0, cells = 0;
        coarse_bits(*this, T, B, BW, a.pool, g0, nb, (uint32_t*)a.out,
                    [&](int r, int* sig, float* init) {
                        if (!sw.pending[r]) return false;
                        *sig = p.tsig[r];
                        for (int k = 0; k < 3; ++k)
                            init[k] = p.init[r * 3 + k];
                        return true;
                    }, &tested, &cells);
        for (int t = gtid; t < T; t += gsize)
            if (sw.pending[t]) atomicAdd(&sw.pdem[p.tpair[t]], 1);
        sync(PH_COARSE);
        coarse_best(*this, p, w, coarse_majority(*this, sw.pdem, P), B,
                    a.pool, g0, nb, sw.best);
        sync(PH_COARSE);
        for (int b = gtid; b < B; b += gsize)
            a.out[T * BW + b] = fbits(sw.best[b] + 0.0f);
    }

    // the gathered coarse passes [K, T * BW + B] combined (bits by OR,
    // pool scores by max, rank by rank), the quarantine updated for the
    // last wave (a1: it progressed), the candidates, the winner (block
    // 0; flags[3..4]) and the waiting rule (sw.elsewhere)
    __device__ void wave() {
        const int T = p.T, B = a.B, BW = (B + 31) / 32;
        const int mode = a.a0, stride = T * BW + B;
        for (int i = gtid; i < T * BW; i += gsize) {
            uint32_t v = 0;
            for (int r = 0; r < K; ++r)
                v |= (uint32_t)a.in[(size_t)r * stride + i];
            sw.tbits[i] = v;
        }
        for (int b = gtid; b < B; b += gsize) {
            float m = fval(a.in[T * BW + b]);
            for (int r = 1; r < K; ++r) {
                const float v = fval(a.in[(size_t)r * stride + T * BW + b]);
                if (v > m) m = v;
            }
            sw.best[b] = m;
            sw.cand[b] = 0;
            if ((mode & WAVE_RESET) || a.a1) sw.blocked[b] = 0;
            else if (b == sw.hs[HS_WIN]) sw.blocked[b] = 1;
        }
        sync(PH_WAVES);
        coarse_candidates(*this, T, sw.pending, BW,
                          [&](int t) { return sw.tbits + (size_t)t * BW; },
                          sw.cand);
        sync(PH_WAVES);
        if (b0 && threadIdx.x == 0) {
            if (mode & WAVE_TERMINAL) {
                sw.hs[HS_WORK] = 0;
                sw.hs[HS_WIN] = 0;
            } else {
                coarse_winner(sw.cand, sw.blocked, sw.best, B, sw.hs);
                if (mode & WAVE_RECORD) {
                    sw.hs[HS_OCC0] = sw.hs[HS_OCC];
                    sw.hs[HS_FILL0] = sw.hs[HS_FILL];
                }
            }
            a.flags[3] = sw.hs[HS_WORK];
            a.flags[4] = sw.hs[HS_WIN];
        }
        sync(PH_WAVES);
        const int win = sw.hs[HS_WIN];
        for (int t = gtid; t < T; t += gsize) {
            bool e = false;
            if (sw.pending[t]) {
                for (int wi = 0; wi < BW; ++wi) {
                    uint32_t m = sw.tbits[(size_t)t * BW + wi];
                    if (!(mode & WAVE_TERMINAL) && wi == (win >> 5))
                        m &= ~(1u << (win & 31));
                    e = e || m;
                }
            }
            sw.elsewhere[t] = e;
        }
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
                if (p.aff) aff_write_out();
                break;
            case SEG_COARSE: coarse(); break;
            case SEG_WAVE: wave(); break;
            case SEG_AVAIL: avail_out(a.out); break;
            case SEG_HFRAME:
                if (b0)
                    frame(a.a0, a.a1, a.a2, ENGINE_HIER_SHARDED,
                          sw.hs[HS_OCC0], sw.hs[HS_FILL0]);
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

// the parameters over the whole bucket (the workspaces' sizes): the node
// pointers at the rank's block, its port words, the dynamic score's FMA
Params shard_params(const uint64_t* ptrs, const int* ints) {
    Params p = make_params(ptrs, ints);
    p.NS = ints[I_NB];                     // the [S, N_block] rows' stride
    p.plo = ints[I_LO];
    p.pnb = ints[I_NB];
    p.dyn_fma = ints[I_FMA];
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
    *sws_bytes = (long long)shard_layout(p, ints[I_B], nullptr, nullptr);
    return 0;
}

// Launch step ``seg`` (SEG_*) with its arguments a0..a2 (the round, the
// revive flag, a wave's mode and progress, or the frame's rounds /
// retries / stranded). ptrs: N_SPTRS device addresses in the P_* order
// (the affinity slots null without the vocabulary: node_dom over the
// whole bucket, port_base and the claims out over the rank's block; then
// the two workspaces and the flags); ints: N_SINTS (the batched
// kernel's, the node bucket in I_N, then the block, the ranks, the FMA
// flag, the pools and the launch's node window); in / out: the gathered
// payload and this rank's (either may be null for a step without one);
// info (host, 3 ints): grid, threads and dynamic shared bytes. Returns
// the cudaError_t of the setup and launch.
extern "C" int kb_sharded_round(const unsigned long long* ptrs, int n_ptrs,
                                const int* ints, int n_ints, int seg, int a0,
                                int a1, int a2, void* in, void* out,
                                int* info, void* stream) {
    if (n_ptrs != N_SPTRS || n_ints != N_SINTS || seg < 0 || seg >= N_SEGS)
        return (int)cudaErrorInvalidValue;
    Params p = shard_params((const uint64_t*)ptrs, ints);
    const int blo = ints[I_LO], bnb = ints[I_NB], K = ints[I_K];
    const int off = ints[I_OFF], wn = ints[I_WN], B = ints[I_B];
    const int pool = ints[I_POOL];
    const bool two_level = seg >= SEG_COARSE;
    if (p.T >= (1 << 20) || p.J >= (1 << 24) || p.njk > 3 || bnb < 1
        || K < 1 || K > MAX_RANKS || bnb * K != p.N || blo % bnb
        || blo + bnb > p.N || off < 0 || wn < 1 || off + wn > p.N
        || (p.aff && (off != 0 || wn != p.N || B))
        || (two_level && (B < 1 || pool * B != p.N))
        || (ints[I_ELSE] && !B))
        return (int)cudaErrorInvalidValue;
    Work w;
    layout(p, (char*)ptrs[P_WS], &w);
    SWork sw;
    shard_layout(p, B, (char*)ptrs[P_SWS], &sw);
    // the window: this rank's part of [off, off + wn), its node pointers
    // moved to the part's first node (sig rows keep the block's stride)
    const int a_g = std::min(std::max(blo, off), off + wn);
    const int b_g = std::min(std::max(blo + bnb, off), off + wn);
    const int s0 = a_g - blo;
    p.idle += (size_t)s0 * 3;
    p.rel += (size_t)s0 * 3;
    p.ntasks += s0;
    p.nz += (size_t)s0 * 2;
    p.bf += (size_t)s0 * 3;
    p.cap += (size_t)s0 * 2;
    p.maxt += s0;
    p.node_ok += s0;
    p.sig_scores += s0;
    p.sig_pred += s0;
    p.N = wn;
    p.MN = pow2_at_least(wn);
    p.noff = off;
    p.elsewhere = ints[I_ELSE] ? sw.elsewhere : nullptr;
    SArgs a;
    a.seg = seg;
    a.a0 = a0;
    a.a1 = a1;
    a.a2 = a2;
    a.lo = a_g - off;
    a.nb = b_g - a_g;
    a.blo = blo;
    a.bnb = bnb;
    a.K = K;
    a.off = off;
    a.wn = wn;
    a.B = B;
    a.pool = pool;
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
    if (grid > MAX_GRID) return (int)cudaErrorInvalidConfiguration;
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
