// The two-level allocate cycle and the active-set cycle — every wave,
// coarse pass, round and epilogue pass — as one launch: one cooperative
// grid over the card (the grid route), or, for task views of at most
// CLUSTER_VIEW_MAX tasks, one thread-block cluster (the cluster route).
//
// Replaces kubebatch_tpu/kernels/hier.py:368 _hier_packed (with :160
// _coarse_pass, :208 hier_allocate, :109 _block_state, :120
// _block_arrays and :134 _merge_block inside it) and, in its other two
// modes, kubebatch_tpu/kernels/activeset.py:453 _activeset_packed (:180
// _pair_coarse, :239 activeset_allocate) and :503 _activeset_audit_packed
// (:481 _divergence). The plain PyTorch versions are
// kubebatch_tpu_torch/kernels/hier.py hier_allocate_plain and
// kubebatch_tpu_torch/kernels/activeset.py activeset_allocate_plain /
// activeset_audit_plain; the packed result, the frame and the node carry
// agree with them bit for bit (built with -fmad=false, IEEE division).
//
// Modes:
//  - MODE_HIER: the two-level solve of the task set;
//  - MODE_ACT: the same wave loop at the active set's grain width with
//    the pair fold (eligibility per exact pair, from pair_init);
//  - MODE_AUDIT: the active-set solve on a scratch copy of the node carry,
//    then the two-level solve of the full task set on the carry, and the
//    decision comparison of the two into the frame's act_demoted word.
//
// What bounds it on an H100: per wave, the coarse pass tests every
// pending task row (every pair row in the active set) against the N
// nodes (~10 operations a cell; a row stops at the first eligible node of
// each pool, so a pool with room costs a warp-width of cells); each round
// of a wave is the batched round on a 4,096-node pool ([T_part, 4,096]
// cells twice). At cfg6 cold that is ~1e9-1e10 operations and the node
// state, [S,N] predicates and scores (~tens of MB): well under a
// millisecond of the card's rates. As in the batched kernel the rounds'
// chains (sorts of T keys, scans, segment sums: each step needs the last)
// bound it, times the rounds of every wave: their grid barriers and L2
// round trips, now that the chain runs across the grid.
// On the active set's views (256 to 4,096 tasks, a 4,096-node pool) the
// work is small (the bound is ~2 us): a launch is block 0's chain steps,
// one-warp passes and the barriers between them (136 grid barriers at
// 1.1 us are 0.15 of 2.4 ms at grain 256, chain_timing.py on the H100).
// Design:
//  - one launch runs every wave, so no wave and no round returns to the
//    host; the host reads the packed result once. The route comes from
//    the sizes alone (launch_grid, launch_cluster): views of at most
//    CLUSTER_VIEW_MAX tasks take one cluster of CLUSTER_CTAS CTAs, larger
//    ones (the two-level solves of cfg6 / cfg7) the cooperative grid. A
//    cluster the card refuses raises in the wrapper; nothing falls back.
//    Both routes run the same code (batched_round.cuh CycleT, templated
//    on the barrier: HierGridBar, HierClusterBar), so they give the same
//    bits. The cluster route's own settings (each chosen by measurement,
//    PERF.md row 9): its barrier is the cluster barrier (0.7 us); the
//    stranded-gang rollback, whose passes walk the full node and job
//    axes, runs across the cluster at every view size; scans of more
//    than 512 elements take their first level across it; a lane of the
//    row pass tests two nodes a step; the other chain steps of views of
//    up to 1,024 tasks, and sorts of up to 1,024 keys, stay in CTA 0;
//  - the rounds are the batched kernel's (batched_round.cuh), their
//    ordering steps on the launch's team past its chain size (views past
//    1,024 tasks, the pool's node order) and in block 0 below it: each
//    block keeps its own copy of the parameters in shared memory, and
//    between barriers thread 0 of every block points the node arrays at
//    the winning pool (the node window) and back at the full axis, so
//    the team's steps read the window from the block's copy;
//  - the coarse pass (hier_coarse.cuh, shared with the node-sharded
//    kernel): one warp per pending task row (per pair row in the active
//    set; on the cluster route one per (row, pool), OR-ing its bit by an
//    integer atomic) walks each pool's nodes 32 at a time and stops at
//    the first eligible one, recording one bit per pool (ceil(B/32)
//    words a row); pools' candidate counts by integer atomics;
//    the majority pair (argmax of pending tasks per pair, lowest index on
//    ties) is reduced in every block, its masked score maximum per pool
//    by several warps a pool, folded in block 0 (max is exact in any
//    order); the winner, the quarantine and the wave counters in block
//    0, in integer and comparison arithmetic, lowest index on ties;
//  - loop state (has_work, winner, occupancy, fill) sits in a small
//    global scalar array every thread reads after a barrier;
//  - the reference's two-level graphs contract nodeorder's weighted sum
//    into fma(balanced, w1, least * w0) in the coarse pass and in the
//    rounds (kernels/xla_order.py WEIGHTED_SUM_FMA): kb::scan_node_score
//    in both, where the batched kernel rounds both products.
#include <initializer_list>

#include "hier_coarse.cuh"

namespace {

enum { MODE_HIER = 0, MODE_ACT = 1, MODE_AUDIT = 2 };
enum { ENGINE_HIER = 4, ENGINE_ACTIVESET = 9 };
// the hier phases timed after the round's (kernels/hier.py HIER_PHASES):
// the coarse pass's set-up and winner, the waves' own steps, the coarse
// pass's row walks and its pool scores
enum { PH_COARSE = N_PHASES, PH_WAVES, PH_COARSE_ROWS, PH_COARSE_BEST,
       N_HIER_PHASES };
// loop scalars
enum { H_HAS_WORK, H_WINNER, H_OCC, H_FILL, H_N };
// counters (int64): coarse passes, rows they tested, round rows, waves,
// the coarse cells the rows needed (per row and pool: up to and including
// the first eligible node, or the whole pool)
enum { C_PASSES, C_COARSE_ROWS, C_ROUND_ROWS, C_WAVES, C_COARSE_CELLS, C_N };
// hints: mode, pool width, wave cap, route, cluster CTAs
enum { HINT_MODE, HINT_POOL, HINT_WAVES, HINT_ROUTE, HINT_CLUSTER, N_HINTS };
enum { ROUTE_AUTO = 0, ROUTE_GRID = 1, ROUTE_CLUSTER = 2 };

// Launches whose largest task view (both halves of an audit) is at most
// this take the cluster route; larger ones the grid. Set on the H100 by
// chain_timing.py (PERF.md §6, row 9): the cluster won at every grain of
// the active set, 4,096 included (4.70 ms against the grid's 5.52).
constexpr int CLUSTER_VIEW_MAX = 4096;
// the cluster route's CTAs by default: 16, past the portable cluster size
// of 8 (ahead of 8 at every grain; a launch may ask for fewer, and the
// runtime refuses more)
constexpr int CLUSTER_CTAS = 16;

// The grid route: today's cooperative grid over every SM, the barriers
// counted into phase_ns[N_HIER_PHASES]. coarse_split: whether the coarse
// pass walks each (row, pool) with a warp of its own (else a warp walks a
// row's pools in turn). The grid keeps a warp a row: its cold passes have
// 8-17x more pending rows than warps, and the split's per-pool row reads
// and bit atomics cost more than they spread (cfg6 / cfg7 cold row walks
// 1.29 / 13.62 ms with a warp a row, 1.86 / 15.43 split; chain_timing.py
// on the H100, PERF.md row 8); the cluster's passes have 4-45 rows for
// 256 warps, and there the split wins (PERF.md row 9).
struct HierGridBar : GridBar {
    static constexpr int count_slot = N_HIER_PHASES;
    static constexpr bool coarse_split = false;
};

// The cluster route's settings, each chosen on the H100 against the
// values chain_timing.py's VARIANTS give them: scan levels longer than
// CLUSTER_SCAN_MAX and the rollbacks of views past CLUSTER_ROLLBACK_MIN
// tasks run across the cluster's CTAs, the rest in CTA 0 while the others
// wait at the cluster barrier (the other ordering steps keep the grid
// route's sizes, batched_round.cuh GRID_CHAIN_MIN and GRID_JOBS_MIN).
constexpr int CLUSTER_SCAN_MAX = 512;
constexpr int CLUSTER_ROLLBACK_MIN = 0;
// the row pass's nodes a lane tests a step (their loads made together:
// batched_round.cuh cell_all)
constexpr int CLUSTER_ROW_UNROLL = 2;

// The cluster route: one thread-block cluster is the whole launch, every
// barrier the cluster barrier.
struct HierClusterBar {
    static constexpr bool cluster = true;
    static constexpr int count_slot = N_HIER_PHASES;
    static constexpr bool coarse_split = true;
    static constexpr int row_unroll = CLUSTER_ROW_UNROLL;
    static constexpr int rollback_min = CLUSTER_ROLLBACK_MIN;
    static constexpr int scan_block_max = CLUSTER_SCAN_MAX;
};

struct Hier {
    int mode, pool, B, BW, max_waves, route, ctas;
    const float* pair_init;                // the active-set half's [P,3]
    uint32_t* tbits;                       // [T*BW] task pool bits
    uint32_t* pbits;                       // [P*BW] pair pool bits
    uint8_t* pending;                      // [T]
    uint8_t* elsewhere;                    // [T]
    int32_t* cand;                         // [B] pending candidates
    float* best;                           // [B] majority pool score
    float* part;                           // [B * pool / 32] its segments'
    uint8_t* blocked;                      // [B] quarantine
    int32_t* pdem;                         // [P] pending tasks per pair
    int32_t* hs;                           // [H_N]
    unsigned long long* counters;          // [C_N]
};

inline size_t hier_layout(size_t off, int T, int P, int B, int BW,
                          char* base, Hier* h) {
    auto take = [&](size_t bytes) -> char* {
        char* ptr = base ? base + off : nullptr;
        off = align_up(off + (bytes ? bytes : 1));
        return ptr;
    };
    Hier x = *h;
    x.tbits = (uint32_t*)take((size_t)T * BW * 4);
    x.pbits = (uint32_t*)take((size_t)P * BW * 4);
    x.pending = (uint8_t*)take(T);
    x.elsewhere = (uint8_t*)take(T);
    x.cand = (int32_t*)take((size_t)B * 4);
    x.best = (float*)take((size_t)B * 4);
    x.part = (float*)take((size_t)B * (x.pool / 32 + 1) * 4);
    x.blocked = (uint8_t*)take(B);
    x.pdem = (int32_t*)take((size_t)P * 4);
    x.hs = (int32_t*)take(H_N * 4);
    *h = x;
    return off;
}

template <class Cy>
struct HierCycle {
    Params& sp;                            // this block's parameters
    const Params& pf;                      // the primary (committed) half
    const Params& pa;                      // the audit's active-set half
    const Work& w;
    const Hier& h;
    Cy& c;

    __device__ HierCycle(Params& sp_, const Params& pf_, const Params& pa_,
                         const Work& w_, const Hier& h_, Cy& c_)
        : sp(sp_), pf(pf_), pa(pa_), w(w_), h(h_), c(c_) {}

    // point this block's parameters at ``base`` with the node window
    // [off, off + width) (width 0: the full axis) and, for the active
    // set, the pair rows
    __device__ void set_params(const Params& base, bool act, int off,
                               int width) {
        __syncthreads();
        if (threadIdx.x == 0) {
            sp = base;
            sp.pair_init = act ? h.pair_init : nullptr;
            sp.dyn_fma = 1;
            if (width) {
                sp.idle = base.idle + (size_t)off * 3;
                sp.rel = base.rel + (size_t)off * 3;
                sp.ntasks = base.ntasks + off;
                sp.nz = base.nz + (size_t)off * 2;
                sp.bf = base.bf + (size_t)off * 3;
                sp.cap = base.cap + (size_t)off * 2;
                sp.maxt = base.maxt + off;
                sp.node_ok = base.node_ok + off;
                sp.sig_scores = base.sig_scores + off;
                sp.sig_pred = base.sig_pred + off;
                sp.N = width;
                sp.MN = pow2_at_least(width);
                sp.noff = off;
                sp.elsewhere = h.elsewhere;
            }
        }
        __syncthreads();
    }

    __device__ const uint32_t* bits(int t, bool act) const {
        return act ? h.pbits + (size_t)max(sp.tpair[t], 0) * h.BW
                   : h.tbits + (size_t)t * h.BW;
    }

    // the coarse pass at full width (hier_coarse.cuh): pending tasks, per
    // (row, pool) any-eligibility bits, candidate counts, the majority
    // pair's pool scores; then (block 0) the winner. Leaves H_HAS_WORK /
    // H_WINNER (and H_OCC / H_FILL) in h.hs. The row walks take a warp a
    // row, or with Bar::coarse_split a warp a (row, pool); a pool's scores
    // take S warps, each over a segment of the pool (S from the launch's
    // warps). The bits, scores and counters are the same either way.
    __device__ void coarse(bool act) {
        constexpr bool split = Cy::BarT::coarse_split;
        const Params& p = sp;
        const int T = p.T, P = p.P, B = h.B, BW = h.BW, pool = h.pool;
        const int rows = act ? P : T;
        uint32_t* rbits = act ? h.pbits : h.tbits;
        const int S = max(1, min(pool / 32, c.nwarps / B));
        c.node_views();
        for (int t = c.gtid; t < T; t += c.gsize) {
            const int j = max(p.tjob[t], 0);
            h.pending[t] = p.tvalid[t] && p.out[t] == SKIP && w.alive[j]
                           && p.jvalid[j];
        }
        for (int q = c.gtid; q < P; q += c.gsize) h.pdem[q] = 0;
        for (int b = c.gtid; b < B; b += c.gsize) h.cand[b] = 0;
        if (split)
            for (int i = c.gtid; i < rows * BW; i += c.gsize) rbits[i] = 0;
        c.sync(PH_COARSE);
        // per row (a pending task, or every pair in the active set): one
        // bit per pool
        unsigned long long tested = 0, cells = 0;
        auto row = [&](int r, int* sig, float* init) {
            if (act) {
                *sig = p.pair_sig[r];
                for (int k = 0; k < 3; ++k) init[k] = h.pair_init[r * 3 + k];
                return true;
            }
            if (!h.pending[r]) return false;
            *sig = p.tsig[r];
            for (int k = 0; k < 3; ++k) init[k] = p.init[r * 3 + k];
            return true;
        };
        if (split)
            coarse_bits_split(c, rows, B, BW, pool, 0, p.N, rbits, row,
                              &tested, &cells);
        else
            coarse_bits(c, rows, B, BW, pool, 0, p.N, rbits, row, &tested,
                        &cells);
        if (c.lane == 0 && (tested || cells)) {
            atomicAdd(&h.counters[C_COARSE_ROWS], tested);
            atomicAdd(&h.counters[C_COARSE_CELLS], cells);
        }
        for (int t = c.gtid; t < T; t += c.gsize)
            if (h.pending[t]) atomicAdd(&h.pdem[p.tpair[t]], 1);
        c.sync(PH_COARSE_ROWS);
        coarse_candidates(c, T, h.pending, BW,
                          [&](int t) { return bits(t, act); }, h.cand);
        const int maj = coarse_majority(c, h.pdem, P);
        coarse_best_split(c, p, w, maj, B, pool, 0, p.N, S, h.part);
        c.sync(PH_COARSE_BEST);
        if (c.b0) {
            coarse_best_fold(h.part, B, S, h.best);
            if (threadIdx.x == 0) {
                coarse_winner(h.cand, h.blocked, h.best, B, h.hs);
                h.counters[C_PASSES] += 1;
            }
        }
        c.sync(PH_COARSE);
    }

    // the rounds on pool ``pool_idx`` (elsewhere already set) from round
    // ``rounds``; returns whether any round changed a task
    __device__ bool pool_rounds(const Params& base, bool act, int pool_idx,
                                int& rounds) {
        set_params(base, act, pool_idx * h.pool, h.pool);
        bool progress = true, any = false;
        while (progress && rounds < sp.max_rounds) {
            progress = c.run_round(rounds);
            any = any || progress;
            ++rounds;
            // the round's task rows (participating, then the retry's)
            unsigned long long n = 0;
            for (int k = c.gtid; k < c.tcur(); k += c.gsize)
                n += (unsigned long long)w.part[k] + w.mask[k];
            for (int o = 16; o > 0; o >>= 1)
                n += __shfl_xor_sync(FULL, n, o);
            if (c.lane == 0 && n) atomicAdd(&h.counters[C_ROUND_ROWS], n);
        }
        set_params(base, act, 0, 0);
        return any;
    }

    // reference waves_loop: waves until no pool has eligible pending
    // work, then the terminal FAIL sweep on pool 0
    __device__ void waves(const Params& base, bool act, int& rounds,
                          int& blocks, int& occ, int& fill) {
        const int B = h.B;
        const int max_waves = h.max_waves > 0 ? h.max_waves
                                              : (sp.T + 8) * (B + 1);
        for (int b = c.gtid; b < B; b += c.gsize) h.blocked[b] = 0;
        c.sync(PH_WAVES);
        for (int wave = 0; wave < max_waves; ++wave) {
            coarse(act);
            if (wave == 0) {
                occ = h.hs[H_OCC];
                fill = h.hs[H_FILL];
            }
            if (c.gtid == 0) h.counters[C_WAVES] += 1;
            if (!h.hs[H_HAS_WORK]) break;
            const int win = h.hs[H_WINNER];
            for (int t = c.gtid; t < sp.T; t += c.gsize) {
                bool e = false;
                if (h.pending[t]) {
                    const uint32_t* tb = bits(t, act);
                    for (int wi = 0; wi < h.BW; ++wi) {
                        uint32_t m = tb[wi];
                        if (wi == (win >> 5)) m &= ~(1u << (win & 31));
                        e = e || m;
                    }
                }
                h.elsewhere[t] = e;
            }
            c.sync(PH_WAVES);
            const bool progressed = pool_rounds(base, act, win, rounds);
            // a dead wave quarantines its pool until a productive one
            // re-opens every pool
            for (int b = c.gtid; b < B; b += c.gsize)
                if (progressed) h.blocked[b] = 0;
                else if (b == win) h.blocked[b] = 1;
            ++blocks;
            c.sync(PH_WAVES);
        }
        // the terminal FAIL sweep: tasks eligible nowhere fail
        coarse(act);
        for (int t = c.gtid; t < sp.T; t += c.gsize) {
            bool e = false;
            if (h.pending[t]) {
                const uint32_t* tb = bits(t, act);
                for (int wi = 0; wi < h.BW; ++wi) e = e || tb[wi];
            }
            h.elsewhere[t] = e;
        }
        c.sync(PH_WAVES);
        pool_rounds(base, act, 0, rounds);
        ++blocks;
    }

    // one whole solve of ``base``'s task set on its node carry
    __device__ void solve(const Params& base, bool act, int& rounds,
                          int& retries, int& stranded, int& occ, int& fill,
                          int& blocks) {
        set_params(base, act, 0, 0);
        const Params& p = sp;
        for (int i = c.gtid; i < p.Q * 3; i += c.gsize)
            w.q_alloc[i] = p.qalloc0[i];
        for (int i = c.gtid; i < p.J * 3; i += c.gsize)
            w.j_alloc[i] = p.jalloc0[i];
        for (int j = c.gtid; j < p.J; j += c.gsize) {
            w.alloc_cnt[j] = p.init_alloc[j];
            w.alive[j] = p.jvalid[j];
        }
        for (int t = c.gtid; t < p.T; t += c.gsize) {
            p.out[t] = SKIP;
            p.out[p.T + t] = -1;
            p.out[2 * p.T + t] = IMAX;
        }
        c.full_view();
        c.sync(PH_SETUP);
        rounds = 0;
        blocks = 0;
        waves(base, act, rounds, blocks, occ, fill);
        retries = 0;
        stranded = 0;
        if (p.gang) {
            while (true) {
                if (c.b0) c.stranded_jobs(typename Cy::BlockTeam(), true);
                c.sync(PH_EPILOGUE);
                if (retries >= 3 || !w.iscal[S_ANY_STRANDED]) break;
                c.rollback(true, PH_EPILOGUE);
                c.sync(PH_EPILOGUE);
                int o2, f2;
                waves(base, act, rounds, blocks, o2, f2);
                ++retries;
            }
            c.rollback(false, PH_EPILOGUE);
            c.sync(PH_EPILOGUE);
            stranded = w.iscal[S_STRANDED];
        }
    }

    // block 0: valid tasks of ``p`` (the act_tasks word)
    __device__ int valid_count(const Params& p) {
        __shared__ int s_n;
        if (threadIdx.x == 0) s_n = 0;
        __syncthreads();
        int n = 0;
        for (int t = threadIdx.x; t < p.T; t += blockDim.x) n += p.tvalid[t];
        if (n) atomicAdd(&s_n, n);
        __syncthreads();
        return s_n;
    }

    // block 0: reference _divergence of the audit's two halves
    __device__ int divergence() {
        __shared__ int s_d;
        if (threadIdx.x == 0) s_d = 0;
        __syncthreads();
        const int G = pa.T, Tf = pf.T, m = min(G, Tf);
        int d = 0;
        for (int i = threadIdx.x; i < m; i += blockDim.x) {
            if (!pa.tvalid[i]) continue;
            const int sa = pa.out[i], sf = pf.out[i];
            const int na = pa.out[G + i], nf = pf.out[Tf + i];
            const int qa = pa.out[2 * G + i], qf = pf.out[2 * Tf + i];
            bool div = sa != sf;
            const bool both = (sf == ALLOC || sf == ALLOC_OB
                               || sf == PIPELINE) && sa == sf;
            div = div || (both && (na != nf || qa / G != qf / Tf
                                   || qa % G != qf % Tf));
            d += div;
        }
        if (d) atomicAdd(&s_d, d);
        __syncthreads();
        return s_d;
    }

    __device__ void run() {
        if (c.gtid == 0) c.t_last = Cy::now_ns();
        int rounds, retries, stranded, occ, fill, blocks;
        int32_t act_words[4] = {0, 0, 0, 0};
        if (h.mode == MODE_AUDIT) {
            // the active-set half from a scratch copy of the carry
            for (int i = c.gtid; i < pf.N * 3; i += c.gsize) {
                pa.idle[i] = pf.idle[i];
                pa.rel[i] = pf.rel[i];
            }
            for (int n = c.gtid; n < pf.N; n += c.gsize) {
                pa.ntasks[n] = pf.ntasks[n];
                pa.nz[n * 2] = pf.nz[n * 2];
                pa.nz[n * 2 + 1] = pf.nz[n * 2 + 1];
            }
            c.sync(PH_SETUP);
            solve(pa, true, rounds, retries, stranded, occ, fill, blocks);
            if (c.b0) {
                act_words[0] = valid_count(pa);
                act_words[1] = occ * h.pool;
                act_words[2] = blocks * h.pool;
            }
            solve(pf, false, rounds, retries, stranded, occ, fill, blocks);
            if (c.b0) {
                act_words[3] = divergence();
                c.frame(rounds, retries, stranded, ENGINE_ACTIVESET, occ,
                        fill, act_words);
            }
            return;
        }
        const bool act = h.mode == MODE_ACT;
        solve(pf, act, rounds, retries, stranded, occ, fill, blocks);
        if (c.b0) {
            if (act) {
                act_words[0] = valid_count(pf);
                act_words[1] = occ * h.pool;
                act_words[2] = blocks * h.pool;
            }
            c.frame(rounds, retries, stranded,
                    act ? ENGINE_ACTIVESET : ENGINE_HIER, occ, fill,
                    act_words);
        }
    }
};

// One launch runs every phase under one barrier kind (batched_round.cuh
// CycleT): the grid route's cooperative grid (GridBar's sizes), or the
// cluster route's one thread-block cluster.
template <class Bar>
__global__ void __launch_bounds__(NT, 1)
hier_allocate_kernel(const __grid_constant__ Params pf,
                     const __grid_constant__ Params pa,
                     const __grid_constant__ Work w,
                     const __grid_constant__ Hier h) {
    extern __shared__ uint64_t skeys[];
    __shared__ Params sp;
    if (threadIdx.x == 0) sp = pf;
    __syncthreads();
    CycleT<Bar> c(sp, w, skeys);
    HierCycle<CycleT<Bar>> hc(sp, pf, pa, w, h, c);
    hc.run();
}

// the parameters of both halves and the hier options; false on sizes
// the kernel does not take
bool setup(const unsigned long long* ptrs_f, const unsigned long long* ptrs_a,
           const int* ints_f, const int* ints_a, const int* hints,
           Params* pf, Params* pa, Params* pmax, Hier* h) {
    *pf = make_params((const uint64_t*)ptrs_f, ints_f);
    *pa = make_params((const uint64_t*)ptrs_a, ints_a);
    h->mode = hints[HINT_MODE];
    h->pool = hints[HINT_POOL];
    h->max_waves = hints[HINT_WAVES];
    h->route = hints[HINT_ROUTE];
    h->ctas = hints[HINT_CLUSTER] > 0 ? hints[HINT_CLUSTER] : CLUSTER_CTAS;
    if (h->mode < MODE_HIER || h->mode > MODE_AUDIT || h->pool < 1
        || pf->N % h->pool != 0 || h->route < ROUTE_AUTO
        || h->route > ROUTE_CLUSTER || hints[HINT_CLUSTER] < 0)
        return false;
    h->B = pf->N / h->pool;
    h->BW = (h->B + 31) / 32;
    if (pa->N != pf->N || pa->P != pf->P || pa->J != pf->J
        || pa->Q != pf->Q)
        return false;
    for (const Params* q : {pf, pa})
        if (q->T >= (1 << 20) || q->J >= (1 << 24) || q->njk > 3 || q->aff)
            return false;
    *pmax = *pf;
    pmax->T = std::max(pf->T, pa->T);
    pmax->MT = pow2_at_least(pmax->T);
    if (h->route == ROUTE_AUTO)
        h->route = pmax->T <= CLUSTER_VIEW_MAX ? ROUTE_CLUSTER : ROUTE_GRID;
    return true;
}

// the grid route: every SM's worth of CTAs, one cooperative launch
cudaError_t launch_grid(const Params& pf, const Params& pa, const Work& w,
                        const Hier& h, size_t smem, int* info,
                        cudaStream_t stream) {
    auto kernel = hier_allocate_kernel<HierGridBar>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0, coop = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
        return err;
    if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch,
                                      dev)) != cudaSuccess)
        return err;
    if (!coop) return cudaErrorNotSupported;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, NT, smem)) != cudaSuccess)
        return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    const int grid = sms * per_sm;
    if (grid > MAX_GRID) return cudaErrorInvalidConfiguration;
    info[0] = grid;
    Params pfc = pf, pac = pa;
    Work wc = w;
    Hier hc = h;
    void* args[] = {&pfc, &pac, &wc, &hc};
    return cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid),
                                       dim3(NT), args, smem, stream);
}

// the cluster route: one cluster of h.ctas CTAs is the whole launch. A
// cluster the card cannot place (too many CTAs, too much shared memory)
// is refused with the runtime's error: no other route is taken.
cudaError_t launch_cluster(const Params& pf, const Params& pa, const Work& w,
                           const Hier& h, size_t smem, int* info,
                           cudaStream_t stream) {
    auto kernel = hier_allocate_kernel<HierClusterBar>;
    if (h.ctas < 1) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if ((err = cudaFuncSetAttribute(
             kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1))
        != cudaSuccess)
        return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)h.ctas);
    cfg.blockDim = dim3(NT);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)h.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int resident = 0;
    if ((err = cudaOccupancyMaxActiveClusters(&resident, (void*)kernel,
                                              &cfg)) != cudaSuccess)
        return err;
    if (resident < 1) return cudaErrorLaunchOutOfResources;
    info[0] = h.ctas;
    return cudaLaunchKernelEx(&cfg, kernel, pf, pa, w, h);
}

}  // namespace

// The auto route's limits into out[0..2): the largest task view that
// takes the cluster route (CLUSTER_VIEW_MAX) and the cluster route's CTAs
// when the launch asks for none (CLUSTER_CTAS). Returns 0.
extern "C" int kb_hier_route_limits(int* out) {
    out[0] = CLUSTER_VIEW_MAX;
    out[1] = CLUSTER_CTAS;
    return 0;
}

// Workspace bytes for these sizes (the arrays as kb_hier_allocate takes
// them). Returns a cudaError_t (0).
extern "C" int kb_hier_workspace(const int* ints_f, const int* ints_a,
                                 const int* hints, long long* bytes) {
    const unsigned long long zeros[N_PTRS] = {0};
    Params pf, pa, pmax;
    Hier h{};
    if (!setup(zeros, zeros, ints_f, ints_a, hints, &pf, &pa, &pmax, &h))
        return (int)cudaErrorInvalidValue;
    const size_t off = layout(pmax, nullptr, nullptr);
    *bytes = (long long)hier_layout(off, pmax.T, pmax.P, h.B, h.BW, nullptr,
                                    &h);
    return 0;
}

// Launch the cycle. ptrs_f / ints_f: the primary half in the batched
// kernel's P_* / I_* order (its carry and packed result are committed;
// P_WS the workspace, P_PHASE N_HIER_PHASES + 1 zeroed uint64: the phase
// times, then the barriers passed); ptrs_a / ints_a: the audit's
// active-set half (its carry and result scratch), else the same arrays as
// the primary; hints (N_HINTS): mode, pool width, wave cap (0: the
// reference's), route (ROUTE_AUTO: from the sizes; ROUTE_GRID,
// ROUTE_CLUSTER), cluster CTAs (0: CLUSTER_CTAS); hptrs: the active-set
// half's pair rows (null in MODE_HIER), then C_N zeroed uint64 counters
// (coarse passes, the rows they tested, the rounds' task rows, waves);
// info (host, 5 ints): CTAs, threads, dynamic shared bytes, the route
// taken, the cluster's CTAs (0 on the grid route).
// Returns the cudaError_t of the setup and the launch.
extern "C" int kb_hier_allocate(const unsigned long long* ptrs_f,
                                const unsigned long long* ptrs_a,
                                const int* ints_f, const int* ints_a,
                                const int* hints,
                                const unsigned long long* hptrs, int* info,
                                void* stream) {
    Params pf, pa, pmax;
    Hier h{};
    if (!setup(ptrs_f, ptrs_a, ints_f, ints_a, hints, &pf, &pa, &pmax, &h))
        return (int)cudaErrorInvalidValue;
    h.pair_init = (const float*)hptrs[0];
    h.counters = (unsigned long long*)hptrs[1];
    if ((h.mode == MODE_HIER) != (h.pair_init == nullptr) || !h.counters)
        return (int)cudaErrorInvalidValue;
    char* ws = (char*)ptrs_f[P_WS];
    Work w;
    const size_t off = layout(pmax, ws, &w);
    hier_layout(off, pmax.T, pmax.P, h.B, h.BW, ws, &h);
    const size_t smem = smem_bytes(pmax);
    info[1] = NT;
    info[2] = (int)smem;
    info[3] = h.route;
    info[4] = h.route == ROUTE_CLUSTER ? h.ctas : 0;
    const cudaError_t err =
        h.route == ROUTE_CLUSTER
            ? launch_cluster(pf, pa, w, h, smem, info, (cudaStream_t)stream)
            : launch_grid(pf, pa, w, h, smem, info, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
