// The two-level allocate cycle and the active-set cycle — every wave,
// coarse pass, round and epilogue pass — as one cooperative grid.
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
// Design:
//  - one cooperative launch runs every wave, so no wave and no round
//    returns to the host; the host reads the packed result once;
//  - the rounds are the batched kernel's (batched_round.cuh), their
//    ordering steps on the grid chain past GRID_CHAIN_MIN tasks (the
//    two-level solves of cfg6 / cfg7, the active set's grain of 4,096;
//    its grains of 256 and 1,024 in block 0, the pool's node order on the
//    grid): each block keeps its own copy of the parameters in shared
//    memory, and between grid barriers thread 0 of every block points the
//    node arrays at the winning pool (the node window) and back at the
//    full axis, so the grid-wide steps read the window from the block's
//    copy;
//  - the coarse pass (hier_coarse.cuh, shared with the node-sharded
//    kernel): one warp per pending task row (per pair row in the
//    active set) walks each pool's nodes 32 at a time and stops at the
//    first eligible one, recording one bit per pool (ceil(B/32) words a
//    row); pools' candidate counts by integer atomics; the majority pair
//    (argmax of pending tasks per pair, lowest index on ties) is reduced
//    in every block, its masked score maximum per pool by one warp a
//    pool (max is exact in any order); the winner, the quarantine and
//    the wave counters in block 0, in integer and comparison arithmetic,
//    lowest index on ties;
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
// the hier phases timed after the round's (kernels/hier.py HIER_PHASES)
enum { PH_COARSE = N_PHASES, PH_WAVES, N_HIER_PHASES };
// loop scalars
enum { H_HAS_WORK, H_WINNER, H_OCC, H_FILL, H_N };
// counters (int64): coarse passes, rows they tested, round rows, waves,
// the coarse cells the rows needed (per row and pool: up to and including
// the first eligible node, or the whole pool)
enum { C_PASSES, C_COARSE_ROWS, C_ROUND_ROWS, C_WAVES, C_COARSE_CELLS, C_N };

struct Hier {
    int mode, pool, B, BW, max_waves;
    const float* pair_init;                // the active-set half's [P,3]
    uint32_t* tbits;                       // [T*BW] task pool bits
    uint32_t* pbits;                       // [P*BW] pair pool bits
    uint8_t* pending;                      // [T]
    uint8_t* elsewhere;                    // [T]
    int32_t* cand;                         // [B] pending candidates
    float* best;                           // [B] majority pool score
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
    x.blocked = (uint8_t*)take(B);
    x.pdem = (int32_t*)take((size_t)P * 4);
    x.hs = (int32_t*)take(H_N * 4);
    *h = x;
    return off;
}

struct HierCycle {
    Params& sp;                            // this block's parameters
    const Params& pf;                      // the primary (committed) half
    const Params& pa;                      // the audit's active-set half
    const Work& w;
    const Hier& h;
    Cycle& c;

    __device__ HierCycle(Params& sp_, const Params& pf_, const Params& pa_,
                         const Work& w_, const Hier& h_, Cycle& c_)
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
    // H_WINNER (and H_OCC / H_FILL) in h.hs.
    __device__ void coarse(bool act) {
        const Params& p = sp;
        const int T = p.T, P = p.P, B = h.B, BW = h.BW, pool = h.pool;
        c.node_views();
        for (int t = c.gtid; t < T; t += c.gsize) {
            const int j = max(p.tjob[t], 0);
            h.pending[t] = p.tvalid[t] && p.out[t] == SKIP && w.alive[j]
                           && p.jvalid[j];
        }
        for (int q = c.gtid; q < P; q += c.gsize) h.pdem[q] = 0;
        for (int b = c.gtid; b < B; b += c.gsize) h.cand[b] = 0;
        c.sync(PH_COARSE);
        // per row (a pending task, or every pair in the active set): one
        // bit per pool
        unsigned long long tested = 0, cells = 0;
        coarse_bits(c, act ? P : T, B, BW, pool, 0, p.N,
                    act ? h.pbits : h.tbits,
                    [&](int r, int* sig, float* init) {
                        if (act) {
                            *sig = p.pair_sig[r];
                            for (int k = 0; k < 3; ++k)
                                init[k] = h.pair_init[r * 3 + k];
                            return true;
                        }
                        if (!h.pending[r]) return false;
                        *sig = p.tsig[r];
                        for (int k = 0; k < 3; ++k)
                            init[k] = p.init[r * 3 + k];
                        return true;
                    }, &tested, &cells);
        if (c.lane == 0 && tested) {
            atomicAdd(&h.counters[C_COARSE_ROWS], tested);
            atomicAdd(&h.counters[C_COARSE_CELLS], cells);
        }
        for (int t = c.gtid; t < T; t += c.gsize)
            if (h.pending[t]) atomicAdd(&h.pdem[p.tpair[t]], 1);
        c.sync(PH_COARSE);
        coarse_candidates(c, T, h.pending, BW,
                          [&](int t) { return bits(t, act); }, h.cand);
        coarse_best(c, p, w, coarse_majority(c, h.pdem, P), B, pool, 0,
                    p.N, h.best);
        c.sync(PH_COARSE);
        if (c.b0 && threadIdx.x == 0) {
            coarse_winner(h.cand, h.blocked, h.best, B, h.hs);
            h.counters[C_PASSES] += 1;
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
                if (c.b0) c.stranded_jobs(true);
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
        if (c.gtid == 0) c.t_last = Cycle::now_ns();
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

__global__ void __launch_bounds__(NT, 1)
hier_allocate_kernel(const __grid_constant__ Params pf,
                     const __grid_constant__ Params pa,
                     const __grid_constant__ Work w,
                     const __grid_constant__ Hier h) {
    extern __shared__ uint64_t skeys[];
    __shared__ Params sp;
    if (threadIdx.x == 0) sp = pf;
    __syncthreads();
    Cycle c(sp, w, skeys);
    HierCycle hc(sp, pf, pa, w, h, c);
    hc.run();
}

// the parameters of both halves and the hier options; false on sizes
// the kernel does not take
bool setup(const unsigned long long* ptrs_f, const unsigned long long* ptrs_a,
           const int* ints_f, const int* ints_a, const int* hints,
           Params* pf, Params* pa, Params* pmax, Hier* h) {
    *pf = make_params((const uint64_t*)ptrs_f, ints_f);
    *pa = make_params((const uint64_t*)ptrs_a, ints_a);
    h->mode = hints[0];
    h->pool = hints[1];
    h->max_waves = hints[2];
    if (h->mode < MODE_HIER || h->mode > MODE_AUDIT || h->pool < 1
        || pf->N % h->pool != 0)
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
    return true;
}

}  // namespace

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
// P_WS the workspace, P_PHASE N_HIER_PHASES zeroed uint64); ptrs_a /
// ints_a: the audit's active-set half (its carry and result scratch),
// else the same arrays as the primary; hints: mode, pool width, wave cap
// (0: the reference's); hptrs: the active-set half's pair rows (null in
// MODE_HIER), then C_N zeroed uint64 counters (coarse passes, the rows
// they tested, the rounds' task rows, waves); info (host, 3 ints): grid,
// threads, dynamic shared bytes.
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
    cudaError_t err = cudaFuncSetAttribute(hier_allocate_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
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
             &per_sm, hier_allocate_kernel, NT, smem)) != cudaSuccess)
        return (int)err;
    if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
    const int grid = sms * per_sm;
    if (grid > MAX_GRID) return (int)cudaErrorInvalidConfiguration;
    info[0] = grid;
    info[1] = NT;
    info[2] = (int)smem;
    void* args[] = {&pf, &pa, &w, &h};
    err = cudaLaunchCooperativeKernel((const void*)hier_allocate_kernel,
                                      dim3(grid), dim3(NT), args, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
