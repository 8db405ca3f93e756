"""Two-level allocate — node pools, then the round engine inside the
winning pool (reference package, kubebatch_tpu/kernels/hier.py).

At 16,384 nodes or more the reference schedules in WAVES over B
contiguous node POOLS of ``pool_size`` nodes:

1. **Coarse pass**: per (task, pool) any-eligibility — the round's own
   eligibility definition folded pool by pool — and a pool score: the
   best eligible node score of the demand-majority pair in each pool.
2. **Winning pool**: the best-scoring pool that still has eligible
   pending work and is not quarantined; ties go to the lowest pool.
3. **Rounds in the pool**: the batched round (kernels/batched.py
   ``_round``) on the pool's nodes only; a task with no eligible node in
   the pool but one elsewhere waits (``elig_elsewhere``) instead of
   failing. The rounds of every wave share one global round cap and one
   round counter (``task_seq`` = round * T + rank).
4. Waves repeat until no pool has eligible pending work. A wave that
   changes nothing quarantines its pool until the next productive wave.
   Then one round on pool 0 fails the tasks eligible nowhere, and the
   stranded-gang epilogue (up to three revive passes, each re-entering
   the waves, then the final rollback) runs at full task width.

The port does not need the split for memory (its kernels never store a
[T,N] matrix), but the split decides: under cross-pool contention the
two-level task -> node map differs from the flat solve's, and the port
decides as the reference does.

Two implementations of one function, chosen by the tensors' device:

- :func:`hier_allocate_plain` — plain PyTorch on CPU tensors, in the
  reference's order of float operations (the round's orders,
  kernels/xla_order.py). The CPU path, and the yardstick for the kernel.
- the CUDA kernel ``csrc/hier_allocate.cu`` — one cooperative grid runs
  every wave, round and epilogue pass; its rounds are the batched
  kernel's round code (``csrc/batched_round.cuh``) with the node window
  set to the winning pool.

:func:`hier_packed` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
Both return ``(packed, idle, releasing, n_tasks, nz_req)`` as
kernels/batched.py does. The active-set engine (kernels/activeset.py)
runs the same wave loop at a churn-sized task width.

Inter-pod affinity and host ports are not expressible here (their
domain carries are cluster-global): the action layer demotes such a
cycle to the batched engine, counted.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import _build
from .batched import (CYCLE_ARGS, NODE_ARGS, PHASES, CycleArrays, RoundState,
                      _IMAX, _PACK_BOOL, _PACK_F32, _PACK_I32,
                      _distinct_rows, _eligibility, _f32,
                      _rollback_stranded, _round, _segsum, _stranded_jobs,
                      arg_dtype, unpack_result)
from .fused import (ALLOC, ALLOC_OB, JOB_KEY_CODES, K_DRF_SHARE,
                    K_GANG_READY, K_PRIORITY, K_PROP_SHARE, PIPELINE, SKIP)
from .solver import scan_node_score_plain
from .xla_order import WEIGHTED_SUM_FMA
from .telemetry import ENGINE_HIER, TELEM_WIDTH, decision_frame
from .tensorize import VEC_EPS

#: the masked pool score of a node the majority pair cannot use
_BIG_NEG = -3.0e38

#: the kernel's modes (csrc/hier_allocate.cu MODE_*)
MODE_HIER, MODE_ACT, MODE_AUDIT = 0, 1, 2


def hier_pool_size(n_pad: int, pool_size: int = 0) -> int:
    """The pool width for a padded node axis; it divides ``n_pad``.
    ``pool_size`` > 0 asks for that width, clamped down to a divisor (the
    reference's KUBEBATCH_HIER_POOL is this argument here). Otherwise:
    the 4,096 grain on re-bucketed axes
    (multiples of 4,096 past it), an eighth on smaller axes of 64 or
    more, else the whole axis."""
    def divisor_at_most(p: int) -> int:
        p = max(1, min(p, n_pad))
        while n_pad % p:
            p -= 1
        return p

    if pool_size > 0:
        return divisor_at_most(int(pool_size))
    if n_pad % 4096 == 0 and n_pad > 4096:
        return 4096
    return divisor_at_most(n_pad // 8) if n_pad >= 64 else n_pad


# ---- the node window ------------------------------------------------------

def _block_state(state: RoundState, off: int, pool: int) -> RoundState:
    """RoundState with the node-axis carry sliced to one pool."""
    w = slice(off, off + pool)
    return state._replace(idle=state.idle[w], releasing=state.releasing[w],
                          n_tasks=state.n_tasks[w], nz_req=state.nz_req[w])


def _block_arrays(a: CycleArrays, off: int, pool: int) -> CycleArrays:
    """CycleArrays with every node-axis array sliced to one pool."""
    w = slice(off, off + pool)
    return a._replace(backfilled=a.backfilled[w],
                      allocatable_cm=a.allocatable_cm[w],
                      max_task_num=a.max_task_num[w], node_ok=a.node_ok[w],
                      sig_scores=a.sig_scores[:, w], sig_pred=a.sig_pred[:, w])


def _merge_block(state: RoundState, bfinal: RoundState, off: int,
                 pool: int) -> RoundState:
    """Fold a finished wave's pool state back into the full-width state:
    the node carry into its window, task / job / queue state whole, and
    the pool-local nodes of this wave's new placements remapped to
    global rows."""
    w = slice(off, off + pool)
    carry = {}
    for f in ("idle", "releasing", "n_tasks", "nz_req"):
        full = getattr(state, f).clone()
        full[w] = getattr(bfinal, f)
        carry[f] = full
    st = bfinal.task_state
    newly = st != state.task_state
    placed = (st == ALLOC) | (st == ALLOC_OB) | (st == PIPELINE)
    task_node = torch.where(newly & placed, bfinal.task_node + off,
                            state.task_node)
    return bfinal._replace(task_node=task_node, **carry)


def _coarse_pass(state: RoundState, a: CycleArrays, pool: int,
                 pipe_enabled: bool, dyn_enabled: bool, pair_init=None,
                 stats=None):
    """The pool-level pass: per (task, pool) any-eligibility — the
    round's own eligibility definition — and the demand-majority pair's
    best eligible score per pool. With ``pair_init`` (the active-set
    engine's ``_pair_coarse``) eligibility is evaluated per pair and
    gathered through ``task_pair``; otherwise each distinct task row
    (batched ``_distinct_rows``) is evaluated once.

    ``stats`` counts what the kernel tests: the rows (every pair, or
    every pending task) and the cells they need — per row and pool, the
    nodes up to and including the first eligible one, or the whole pool.

    Returns (task_pool_elig [T,B] bool, pool_best [B] float32)."""
    eps = torch.from_numpy(VEC_EPS)
    n_pad = a.node_ok.shape[0]
    n_pools = n_pad // pool
    t_pad = a.task_valid.shape[0]
    if pair_init is not None:
        init, sig = pair_init, a.pair_sig
        gather = a.task_pair.clamp(min=0).long()
    else:
        gather, init, sig, _ = _distinct_rows(a, torch.arange(t_pad))
    rows_elig = torch.zeros((init.shape[0], n_pools), dtype=torch.bool)
    rows_cells = torch.zeros(init.shape[0], dtype=torch.int64)
    for c in range(0, init.shape[0], 256):
        sl = slice(c, c + 256)
        elig = _eligibility(state.idle, state.releasing, state.n_tasks, a,
                            pipe_enabled, eps, init[sl], sig[sl])
        elig = elig.view(-1, n_pools, pool)
        rows_elig[sl] = elig.any(dim=2)
        first = elig.to(torch.uint8).argmax(dim=2) + 1
        rows_cells[sl] = torch.where(rows_elig[sl], first, pool).sum(dim=1)
    task_pool_elig = rows_elig[gather]

    tj0 = a.task_job.clamp(min=0).long()
    engaged = (a.task_valid & (state.task_state == SKIP)
               & state.job_alive[tj0] & a.job_valid[tj0])
    if stats is not None:
        tested = rows_cells if pair_init is not None else \
            rows_cells[gather][engaged]
        stats["coarse_passes"] = stats.get("coarse_passes", 0) + 1
        stats["coarse_rows"] = stats.get("coarse_rows", 0) + tested.numel()
        stats["coarse_cells"] = (stats.get("coarse_cells", 0)
                                 + int(tested.sum()))
    pair_demand = _segsum(engaged.to(torch.int32), a.task_pair.long(),
                          a.pair_sig.shape[0])
    maj = int(pair_demand.argmax())
    msig = int(a.pair_sig[maj])
    sc_maj = a.sig_scores[msig]
    if dyn_enabled:
        # the reference's two-level and active-set graphs contract the
        # weighted sum into one FMA (xla_order.WEIGHTED_SUM_FMA)
        sc_maj = sc_maj + scan_node_score_plain(
            state.nz_req, a.pair_nz[maj], a.allocatable_cm, a.dyn_weights)
    base = a.node_ok & (state.n_tasks < a.max_task_num)
    pool_best = torch.where(a.sig_pred[msig] & base, sc_maj,
                            _f32(_BIG_NEG)).view(n_pools, pool).amax(dim=1)
    return task_pool_elig, pool_best


# ---- the wave loop ----------------------------------------------------------

def hier_allocate(state: RoundState, a: CycleArrays, opts, max_rounds: int,
                  pool: int, max_waves: int = 0, gang_enabled: bool = True,
                  pair_init=None, stats=None):
    """The whole two-level cycle (reference ``hier_allocate``; with
    ``pair_init`` the active-set engine's ``activeset_allocate``).
    ``opts`` = (job_keys, queue_keys, prop_overused, dyn_enabled,
    pipe_enabled). Returns (final state, rounds, epilogue retries,
    stranded gangs, first-wave pool occupancy, first-wave winning-pool
    fill, blocks) — ``blocks`` counts the pool solves folded back into
    the node carry, the terminal sweeps included."""
    t_pad = a.task_valid.shape[0]
    n_pad = a.node_ok.shape[0]
    if n_pad % pool:
        raise ValueError(f"pool {pool} does not divide the node axis {n_pad}")
    n_pools = n_pad // pool
    if max_waves <= 0:
        # every productive wave changes a task state, and at most n_pools
        # dead waves run between two productive ones: a safety net
        max_waves = (t_pad + 8) * (n_pools + 1)
    pipe_enabled, dyn_enabled = opts[4], opts[3]
    tj0 = a.task_job.clamp(min=0).long()

    def coarse(st):
        return _coarse_pass(st, a, pool, pipe_enabled, dyn_enabled,
                            pair_init, stats)

    def block_rounds(st, off, rounds, elsewhere):
        bs = _block_state(st, off, pool)
        ba = _block_arrays(a, off, pool)
        progress = True
        while progress and rounds < max_rounds:
            bs, progress = _round(bs, ba, rounds, *opts, seq_stride=t_pad,
                                  stats=stats, elig_elsewhere=elsewhere,
                                  pair_init=pair_init,
                                  weighted_fma=WEIGHTED_SUM_FMA["hier"])
            rounds += 1
        return _merge_block(st, bs, off, pool), rounds

    def waves_loop(st, rounds, blocks):
        wave, occ, fill = 0, 0, 0
        blocked = torch.zeros(n_pools, dtype=torch.bool)
        has_work = True
        while has_work and wave < max_waves:
            task_pool_elig, pool_best = coarse(st)
            pending = (a.task_valid & (st.task_state == SKIP)
                       & st.job_alive[tj0] & a.job_valid[tj0])
            cand_cnt = (task_pool_elig & pending[:, None]).sum(dim=0)
            key = torch.where((cand_cnt > 0) & ~blocked, pool_best,
                              _f32(-torch.inf))
            has_work = bool((key > -torch.inf).any())
            winner = int(key.argmax())
            if wave == 0:
                occ = int((cand_cnt > 0).sum())
                fill = int(cand_cnt[winner])
            if has_work:
                others = torch.arange(n_pools) != winner
                elsewhere = (task_pool_elig & others[None, :]).any(dim=1)
                merged, rounds = block_rounds(st, winner * pool, rounds,
                                              elsewhere)
                if bool((merged.task_state != st.task_state).any()):
                    blocked = torch.zeros_like(blocked)
                else:
                    blocked = blocked.clone()
                    blocked[winner] = True
                st = merged
                blocks += 1
            if stats is not None:
                stats["waves"] = stats.get("waves", 0) + 1
            wave += 1
        # the terminal FAIL sweep: one round on pool 0 in which only the
        # tasks eligible nowhere fail
        task_pool_elig, _ = coarse(st)
        st, rounds = block_rounds(st, 0, rounds, task_pool_elig.any(dim=1))
        return st, rounds, occ, fill, blocks + 1

    final, rounds, occ, fill, blocks = waves_loop(state, 0, 0)
    retries = stranded = 0
    if gang_enabled:
        while retries < 3 and bool(_stranded_jobs(final, a).any()):
            final, _ = _rollback_stranded(final, a, revive=True)
            final, rounds, _, _, blocks = waves_loop(final, rounds, blocks)
            retries += 1
        final, mask = _rollback_stranded(final, a, revive=False)
        stranded = int(mask.sum())
    return final, rounds, retries, stranded, occ, fill, blocks


# ---- the whole entry, plain ----------------------------------------------

def state_arrays(args: Dict[str, torch.Tensor]):
    """The initial RoundState and the CycleArrays of one solve from its
    arguments (NODE_ARGS + CYCLE_ARGS names); the node carry is cloned."""
    t_pad = args["task_valid"].shape[0]
    i32 = torch.int32
    state = RoundState(
        idle=args["idle"].clone(), releasing=args["releasing"].clone(),
        n_tasks=args["n_tasks"].clone(), nz_req=args["nz_req"].clone(),
        q_allocated=args["q_alloc0"].clone(),
        j_allocated=args["j_alloc0"].clone(),
        alloc_cnt=args["init_allocated"].clone(),
        job_alive=args["job_valid"].clone(),
        task_state=torch.full((t_pad,), SKIP, dtype=i32),
        task_node=torch.full((t_pad,), -1, dtype=i32),
        task_seq=torch.full((t_pad,), _IMAX, dtype=i32))
    a = CycleArrays(**{f: args[f] for f in CycleArrays._fields
                       if f in args})
    return state, a


def check_plain_args(what: str, args: Dict[str, torch.Tensor]) -> None:
    for name, t in args.items():
        if t.device.type != "cpu":
            raise ValueError(f"{what} runs on CPU tensors (its segment sums "
                             f"are index_add_'s sequential order on the "
                             f"CPU); {name} is on {t.device}")


def solve_opts(job_keys, queue_keys, prop_overused, dyn_enabled,
               pipe_enabled) -> tuple:
    return (tuple(job_keys), tuple(queue_keys), bool(prop_overused),
            bool(dyn_enabled), bool(pipe_enabled))


def pack_result(final: RoundState, rounds: int, frame) -> torch.Tensor:
    return torch.cat([final.task_state, final.task_node, final.task_seq,
                      torch.tensor([rounds], dtype=torch.int32), frame])


def hier_allocate_plain(
        idle, releasing, n_tasks, nz_req, backfilled, allocatable_cm,
        max_task_num, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_pair, task_valid, sig_scores, sig_pred, pair_sig, pair_nz,
        order_min_available, init_allocated, job_queue, job_priority,
        job_create_rank, job_valid, q_deserved, q_create_rank, q_alloc0,
        j_alloc0, cluster_total, dyn_weights, *,
        job_keys=(K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
        queue_keys=(K_PROP_SHARE,), prop_overused: bool = True,
        dyn_enabled: bool = False, pipe_enabled: bool = True,
        max_rounds: int = 64, pool_size: int = 0, max_waves: int = 0,
        gang_enabled: bool = True, narrow: bool = False,
        narrow_gate: bool = False, stats=None):
    """The two-level cycle in plain PyTorch on CPU tensors (the
    reference's ``_hier_packed``). ``narrow`` and ``narrow_gate`` set
    only the telemetry words. ``stats`` (a dict), when given, receives
    the rounds, waves and coarse passes run and the task rows they
    evaluated (the work a bound counts)."""
    args = {k: v for k, v in locals().items()
            if k in NODE_ARGS + CYCLE_ARGS}
    check_plain_args("hier_allocate_plain", args)
    state, a = state_arrays(args)
    pool = hier_pool_size(idle.shape[0], pool_size)
    final, rounds, retries, stranded, occ, fill, _ = hier_allocate(
        state, a, solve_opts(job_keys, queue_keys, prop_overused,
                             dyn_enabled, pipe_enabled),
        int(max_rounds), pool, int(max_waves), bool(gang_enabled),
        stats=stats)
    t_pad = task_valid.shape[0]
    frame = decision_frame(ENGINE_HIER, final.task_state, final.task_seq,
                           task_valid, waves=rounds, stride=t_pad,
                           narrow=narrow, narrow_gate=narrow_gate,
                           retries=retries, stranded=stranded,
                           pool_occ=occ, bucket_fill=fill)
    return (pack_result(final, rounds, frame), final.idle, final.releasing,
            final.n_tasks, final.nz_req)


def bind_args(what: str, args, kwargs, names):
    """(named arrays, statics) of a dispatcher call; checks the device."""
    statics = {k: kwargs.pop(k) for k in list(kwargs) if k not in names}
    bound = dict(zip(names, args))
    bound.update(kwargs)
    missing = [n for n in names if n not in bound]
    if missing:
        raise TypeError(f"{what}: missing arguments {missing}")
    return bound, statics


def device_of(what: str, *groups) -> str:
    devs = {t.device.type for g in groups for t in g.values()}
    if devs not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"{what}: inputs on devices {devs}")
    return devs.pop()


def hier_packed(*args, **kwargs):
    """The two-level cycle on the inputs' device: the CUDA kernel for
    CUDA tensors, :func:`hier_allocate_plain` for CPU tensors. Same
    arguments and results as :func:`hier_allocate_plain`."""
    names = NODE_ARGS + CYCLE_ARGS
    bound, statics = bind_args("hier_packed", args, kwargs, names)
    if device_of("hier_packed", bound) == "cpu":
        return hier_allocate_plain(**bound, **statics)
    statics.pop("stats", None)
    node = {k: bound[k] for k in NODE_ARGS}
    cycle = {k: bound[k] for k in CYCLE_ARGS}
    return launch(MODE_HIER, node, cycle, None, None, **statics)


# ---- the kernel launch ----------------------------------------------------

#: grid, threads, dynamic shared bytes and workspace bytes of the last
#: launch of csrc/hier_allocate.cu, its per-phase device ns (``phase_ns``:
#: an int64 tensor on the card, kernels/batched.py PHASES order, then
#: HIER_PHASES) and its work counters (``counters``: int64 on the card,
#: COUNTERS order)
last_launch: dict = {}

#: the kernel's work counters: coarse passes, the task (or pair) rows
#: they tested, the rounds' task rows (participating and retrying),
#: waves, and the coarse cells the rows needed (_coarse_pass)
COUNTERS = ("coarse_passes", "coarse_rows", "rows", "waves", "coarse_cells")

#: the phases the kernel times beyond the round's (batched.PHASES)
HIER_PHASES = ("coarse", "waves")

def _shapes(n, t, j, q, s, p) -> dict:
    return {
        "idle": (n, 3), "releasing": (n, 3), "n_tasks": (n,),
        "nz_req": (n, 2), "backfilled": (n, 3), "allocatable_cm": (n, 2),
        "max_task_num": (n,), "node_ok": (n,), "resreq": (t, 3),
        "init_resreq": (t, 3), "task_nz": (t, 2), "task_job": (t,),
        "task_rank": (t,), "task_sig": (t,), "task_pair": (t,),
        "task_valid": (t,), "sig_scores": (s, n), "sig_pred": (s, n),
        "pair_sig": (p,), "pair_nz": (p, 2), "order_min_available": (j,),
        "init_allocated": (j,), "job_queue": (j,), "job_priority": (j,),
        "job_create_rank": (j,), "job_valid": (j,), "q_deserved": (q, 3),
        "q_create_rank": (q,), "q_alloc0": (q, 3), "j_alloc0": (j, 3),
        "cluster_total": (3,), "dyn_weights": (2,)}


def _check_cuda(what: str, arrays: dict, n: int, t: int, j: int, q: int,
                s: int, p: int) -> None:
    shapes = _shapes(n, t, j, q, s, p)
    for name, arr in arrays.items():
        if arr.dtype != arg_dtype(name):
            raise ValueError(f"{what}: {name} must be {arg_dtype(name)}, "
                             f"got {arr.dtype}")
        if name in shapes and tuple(arr.shape) != shapes[name]:
            raise ValueError(f"{what}: {name} must have shape "
                             f"{shapes[name]}, got {tuple(arr.shape)}")


def _ints(n, t, j, q, p, job_keys, queue_keys, prop_overused, dyn_enabled,
          pipe_enabled, max_rounds, gang_enabled, narrow, narrow_gate):
    """The batched kernel's N_INTS option array (no compaction, no
    affinity)."""
    codes = [JOB_KEY_CODES[k] for k in job_keys] + [0] * (3 - len(job_keys))
    return np.asarray([
        n, t, j, q, p, len(job_keys), *codes,
        int(K_PROP_SHARE in queue_keys), int(bool(prop_overused)),
        int(bool(dyn_enabled)), int(bool(pipe_enabled)), int(max_rounds), 0,
        int(bool(gang_enabled)), int(bool(narrow)), int(bool(narrow_gate)),
        0, 0, 0, 0, 0], dtype=np.int32)


def _ptrs(node_out: dict, node: dict, cycle: dict, eps, out, phase_ns, ws):
    """The batched kernel's N_PTRS pointer array (affinity slots null)."""
    return np.asarray([
        node_out["idle"].data_ptr(), node_out["releasing"].data_ptr(),
        node_out["n_tasks"].data_ptr(), node_out["nz_req"].data_ptr(),
        *(node[k].data_ptr() for k in NODE_ARGS[4:]),
        *(cycle[k].data_ptr() for k in (
            "resreq", "init_resreq", "task_nz", "task_job", "task_rank",
            "task_sig", "task_pair", "task_valid", "sig_scores", "sig_pred",
            "pair_sig", "pair_nz", "order_min_available", "init_allocated",
            "job_queue", "job_priority", "job_create_rank", "job_valid",
            "q_deserved", "q_create_rank", "q_alloc0", "j_alloc0",
            "cluster_total", "dyn_weights")),
        eps.data_ptr(), out.data_ptr(),
        phase_ns.data_ptr() if phase_ns is not None else 0,
        *([0] * 19), ws.data_ptr() if ws is not None else 0],
        dtype=np.uint64)


def launch(mode: int, node: dict, cycle: dict, act: Optional[dict],
           pair_init: Optional[torch.Tensor], *,
           job_keys=(K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
           queue_keys=(K_PROP_SHARE,), prop_overused=True,
           dyn_enabled=False, pipe_enabled=True, max_rounds=64,
           amax_rounds=0, pool_size=0, max_waves=0, gang_enabled=True,
           narrow=False, narrow_gate=False):
    """One launch of csrc/hier_allocate.cu. ``mode``: MODE_HIER (the
    two-level solve of ``cycle``), MODE_ACT (the active-set solve of
    ``cycle``, at grain width, with ``pair_init``) or MODE_AUDIT (the
    active-set solve of ``act`` with ``pair_init`` on a scratch copy of
    the carry, then the two-level solve of ``cycle`` on the carry, and
    their divergence in the frame). Returns (packed of ``cycle``, idle,
    releasing, n_tasks, nz_req): the packed result and node carry the
    kernel committed."""
    import ctypes

    if len(job_keys) > 3 or any(k not in JOB_KEY_CODES for k in job_keys):
        raise ValueError(f"hier_allocate: unsupported job keys {job_keys}")
    if any(k != K_PROP_SHARE for k in queue_keys):
        raise ValueError(f"hier_allocate: unsupported queue keys "
                         f"{queue_keys}")
    dev = node["idle"].device
    n = node["idle"].shape[0]
    t = cycle["task_valid"].shape[0]
    j = cycle["job_valid"].shape[0]
    q = cycle["q_deserved"].shape[0]
    s = cycle["sig_scores"].shape[0]
    p = cycle["pair_sig"].shape[0]
    what = "hier_allocate" if mode == MODE_HIER else "activeset_allocate"
    _check_cuda(what, node, n, t, j, q, s, p)
    _check_cuda(what, cycle, n, t, j, q, s, p)
    if (mode == MODE_AUDIT) != (act is not None):
        raise ValueError(f"{what}: the audit takes the active-set arrays, "
                         f"the other modes do not")
    ta = act["task_valid"].shape[0] if act is not None else 0
    if act is not None:
        _check_cuda(what, act, n, ta, j, q, s, p)
    if (mode == MODE_HIER) != (pair_init is None):
        raise ValueError(f"{what}: pair_init is the active-set solve's")
    if pair_init is not None and (pair_init.dtype != torch.float32
                                  or tuple(pair_init.shape) != (p, 3)):
        raise ValueError(f"{what}: pair_init must be float32 ({p}, 3)")
    pool = hier_pool_size(n, pool_size)
    node = {k: v.contiguous() for k, v in node.items()}
    cycle = {k: v.contiguous() for k, v in cycle.items()}
    # the node carry lives in the outputs
    carry = {k: node[k].clone() for k in NODE_ARGS[:4]}
    packed = torch.empty(3 * t + 1 + TELEM_WIDTH, dtype=torch.int32,
                         device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    opts = dict(job_keys=job_keys, queue_keys=queue_keys,
                prop_overused=prop_overused, dyn_enabled=dyn_enabled,
                pipe_enabled=pipe_enabled, gang_enabled=gang_enabled,
                narrow=narrow, narrow_gate=narrow_gate)
    ints_f = _ints(n, t, j, q, p, max_rounds=max_rounds, **opts)
    lib = _build.library("hier_allocate.cu")
    hints = np.asarray([mode, pool, int(max_waves)], dtype=np.int32)
    ints_a = ints_f
    act_out = act_carry = None
    if act is not None:
        act = {k: v.contiguous() for k, v in act.items()}
        ints_a = _ints(n, ta, j, q, p, max_rounds=amax_rounds, **opts)
        act_out = torch.empty(3 * ta + 1 + TELEM_WIDTH, dtype=torch.int32,
                              device=dev)
        act_carry = {k: torch.empty_like(node[k]) for k in NODE_ARGS[:4]}
    ws_bytes = ctypes.c_longlong(0)
    _build.check_launch(what, lib.kb_hier_workspace(
        ints_f.ctypes.data, ints_a.ctypes.data, hints.ctypes.data,
        ctypes.addressof(ws_bytes)))
    ws = torch.empty(ws_bytes.value, dtype=torch.uint8, device=dev)
    phase_ns = torch.zeros(len(PHASES) + len(HIER_PHASES),
                           dtype=torch.int64, device=dev)
    ptrs_f = _ptrs(carry, node, cycle, eps, packed, phase_ns, ws)
    ptrs_a = ptrs_f
    if act is not None:
        ptrs_a = _ptrs(act_carry, node, act, eps, act_out, phase_ns, ws)
    counters = torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev)
    hptrs = np.asarray([pair_init.data_ptr() if pair_init is not None
                        else 0, counters.data_ptr()], dtype=np.uint64)
    info = np.zeros(3, dtype=np.int32)
    err = lib.kb_hier_allocate(
        ptrs_f.ctypes.data, ptrs_a.ctypes.data, ints_f.ctypes.data,
        ints_a.ctypes.data, hints.ctypes.data, hptrs.ctypes.data,
        info.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(what, err)
    _build.count_launch(what)
    last_launch.clear()
    last_launch.update(grid=int(info[0]), threads=int(info[1]),
                       smem_bytes=int(info[2]), workspace_bytes=ws.numel(),
                       phase_ns=phase_ns, counters=counters, mode=mode)
    return (packed, carry["idle"], carry["releasing"], carry["n_tasks"],
            carry["nz_req"])


# ---- the host side -----------------------------------------------------------

def prepare_hier(inputs, pool_size: int = 0):
    """The (args, statics) of the two-level solve for these CycleInputs
    (actions/cycle_inputs.py): args maps every hier_packed argument to a
    tensor on the DeviceSession's device (the per-cycle arrays uploaded
    as three packed buffers), statics holds the keyword options, sized
    as the reference's prepare_hier sizes them. Affinity cycles are not
    expressible here (the action layer demotes them first)."""
    from .narrow import narrow_enabled
    from .pack import pack_inputs, unpack

    if inputs.affinity is not None:
        raise ValueError("hier requires an affinity-free cycle")
    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    n_pad = int(device.node_ok.shape[0])
    task_pair, pair_sig, pair_nz, _ = inputs.pair_terms()
    extra = {"task_pair": task_pair, "pair_sig": pair_sig,
             "pair_nz": pair_nz}
    bufs = pack_inputs(lambda nm: extra[nm] if nm in extra
                       else getattr(inputs, nm),
                       _PACK_F32, _PACK_I32, _PACK_BOOL)
    args = {k: getattr(device, k) for k in NODE_ARGS}
    for buf, lay in zip(bufs[0::2], bufs[1::2]):
        args.update(unpack(torch.from_numpy(buf).to(device.device), lay))
    # narrow by the full [T, N] problem, as the reference does
    narrow = narrow_enabled(
        n_pad, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None))
    statics = dict(
        job_keys=inputs.job_keys, queue_keys=inputs.queue_keys,
        prop_overused=inputs.prop_overused,
        dyn_enabled=inputs.dyn_enabled, pipe_enabled=inputs.pipe_enabled,
        max_rounds=min(int(t_pad) + 8, 4096),
        pool_size=hier_pool_size(n_pad, pool_size),
        gang_enabled=inputs.gang_enabled, narrow=narrow,
        narrow_gate=(not narrow and narrow_enabled(n_pad, t_pad)))
    return args, statics


def run_solve(device, t_pad: int, solve, phases=None,
              name: str = "hier_allocate"):
    """Launch ``solve()`` (returning packed + the node carry), make its
    ONE counted device->host copy and commit the carry to the
    DeviceSession. Returns (task_state, task_node, task_seq, rounds,
    telemetry) as numpy; the frame is recorded on the ``name`` kernel
    span (obs/telemetry.py). ``phases`` (a dict), when given, receives
    the host milliseconds of the launch and the sync, and ``kernel``:
    the device milliseconds from CUDA events (NaN on the CPU)."""
    import time

    from .. import obs
    from ..device import to_host

    on_card = device.device.type == "cuda"
    t1 = time.perf_counter()
    with obs.span(name, cat="kernel") as sp:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        packed, idle, releasing, n_tasks, nz = solve()
        if on_card:
            end.record()
        t2 = time.perf_counter()
        with obs.span("readback", cat="readback"):
            host = to_host(packed)    # the solve's ONE device->host copy
        t3 = time.perf_counter()
        obs.telemetry.record(host[3 * t_pad + 1:], span=sp)
    device.idle, device.releasing, device.n_tasks = idle, releasing, n_tasks
    device.nz_req = nz
    if phases is not None:
        phases.update(solve=(t2 - t1) * 1e3, sync=(t3 - t2) * 1e3,
                      kernel=(start.elapsed_time(end) if on_card
                              else float("nan")))
    state, node, seq, rounds, telem = unpack_result(host, t_pad)
    return state, node, seq, int(rounds), telem


def solve_hier(inputs, phases=None):
    """Run the two-level solve for these CycleInputs with ONE counted
    device->host copy; commits the final node carry to the
    DeviceSession. Returns (task_state, task_node, task_seq, rounds,
    telemetry) as numpy; ``phases`` as :func:`run_solve`, plus
    ``upload``."""
    import time

    t0 = time.perf_counter()
    args, statics = prepare_hier(inputs)
    if phases is not None:
        phases["upload"] = (time.perf_counter() - t0) * 1e3
    return run_solve(inputs.device, inputs.task_valid.shape[0],
                     lambda: hier_packed(**args, **statics), phases)
