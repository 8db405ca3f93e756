"""Batched allocate — the round engine: many placements per round.

The fused solve (kernels/fused.py) places one task per loop iteration; a
10,000-task cold cycle is 10,000+ dependent steps. This engine places as
many tasks per **round** as capacity allows, in parallel, and only the
capacity conflicts spill to the next round; a cold cycle resolves in a
handful of rounds. Round structure (reference package,
kubebatch_tpu/kernels/batched.py, whose docstring states the
faithfulness contract):

1. order — queue shares, DRF job shares and gang readiness from the
   committed state, composed into the configured lexicographic job order
   and flattened into a global task rank; a demand window and per-queue
   budgets admit the best-ranked jobs only;
2. eligibility — per (task, node) predicate + count room + fit against
   round-start capacity; a participating task with no eligible node
   fails and kills its job's later-ranked tasks;
3. proposals — one shared waterfall over nodes in the majority cohort's
   score order; a task whose waterfall slot is not eligible for it takes
   its masked argmax;
4. acceptance — per node, proposers in global-rank order while the
   cumulative requests fit; then one retry phase against the mid-round
   carry;
5. commit — capacity, shares and gang counters.

After the rounds a stranded-gang epilogue rolls back partial gangs,
revives them for up to three more passes, then retires what is left.

Two implementations of one function, chosen by the tensors' device:

- :func:`batched_allocate_plain` — plain PyTorch on CPU tensors, in the
  reference's order of float operations (kernels/xla_order.py; segment
  sums are ``index_add_``, sequential in update order on the CPU). The
  rounds loop in Python. The CPU path, and the yardstick for the kernel.
- the CUDA kernel ``csrc/batched_allocate.cu`` — one cooperative grid
  runs every round, the compact branch and the epilogue on the card.

:func:`batched_allocate` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
Both return ``(packed, idle, releasing, n_tasks, nz_req)``: packed is the
reference's int32 ``[3*T + 1 + TELEM_WIDTH]`` (task_state, task_node,
task_seq, the round count, the telemetry frame) and the rest is the final
node carry. Inter-pod affinity and host ports (the reference's ``_aff_*``
branch) are not ported.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from . import _build
from .fused import (ALLOC, ALLOC_OB, FAIL, JOB_KEY_CODES, K_DRF_SHARE,
                    K_GANG_READY, K_PRIORITY, K_PROP_SHARE, PIPELINE, SKIP,
                    _share)
from .solver import dynamic_node_score_plain
from .telemetry import ENGINE_BATCHED, TELEM_WIDTH, decision_frame
from .tensorize import VEC_EPS
from .xla_order import associative_scan, column_sum, search_left, \
    tiled_cumsum

_IMAX = int(np.iinfo(np.int32).max)
_IMIN = int(np.iinfo(np.int32).min)

#: demand-window fraction (reference: batched.py _WINDOW_SLACK)
_WINDOW_SLACK = 0.85

#: task rows per chunk of the plain row pass, and pairs per chunk of the
#: plain pair scores (bound their [rows, N] memory)
_ROW_CHUNK = 1024
_PAIR_CHUNK = 64

#: node-axis arrays (DeviceSession names), then the cycle arrays, in the
#: order batched_allocate takes them
NODE_ARGS = ("idle", "releasing", "n_tasks", "nz_req", "backfilled",
             "allocatable_cm", "max_task_num", "node_ok")
CYCLE_ARGS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
              "task_sig", "task_pair", "task_valid", "sig_scores",
              "sig_pred", "pair_sig", "pair_nz", "order_min_available",
              "init_allocated", "job_queue", "job_priority",
              "job_create_rank", "job_valid", "q_deserved", "q_create_rank",
              "q_alloc0", "j_alloc0", "cluster_total", "dyn_weights")

_BOOL_ARGS = {"node_ok", "task_valid", "sig_pred", "job_valid"}
_I32_ARGS = {"n_tasks", "max_task_num", "task_job", "task_rank", "task_sig",
             "task_pair", "pair_sig", "order_min_available", "init_allocated",
             "job_queue", "job_create_rank", "q_create_rank"}


def arg_dtype(name: str) -> torch.dtype:
    """The dtype batched_allocate takes for argument ``name``."""
    return (torch.bool if name in _BOOL_ARGS
            else torch.int32 if name in _I32_ARGS else torch.float32)


class RoundState(NamedTuple):
    """Carry across rounds."""
    idle: torch.Tensor         # [N,R]
    releasing: torch.Tensor    # [N,R]
    n_tasks: torch.Tensor      # [N]
    nz_req: torch.Tensor       # [N,2]
    q_allocated: torch.Tensor  # [Q,R]
    j_allocated: torch.Tensor  # [J,R]
    alloc_cnt: torch.Tensor    # [J] allocated-family count (readiness)
    job_alive: torch.Tensor    # [J] bool — not yet dropped on failure
    task_state: torch.Tensor   # [T] SKIP while pending
    task_node: torch.Tensor    # [T]
    task_seq: torch.Tensor     # [T] round * T_pad + in-round rank


class CycleArrays(NamedTuple):
    """Arrays static across rounds."""
    backfilled: torch.Tensor       # [N,R]
    allocatable_cm: torch.Tensor   # [N,2]
    max_task_num: torch.Tensor     # [N]
    node_ok: torch.Tensor          # [N]
    resreq: torch.Tensor           # [T,R]
    init_resreq: torch.Tensor      # [T,R]
    task_nz: torch.Tensor          # [T,2]
    task_job: torch.Tensor         # [T]
    task_rank: torch.Tensor        # [T]
    task_sig: torch.Tensor         # [T] (predicate rows)
    task_pair: torch.Tensor        # [T] (scoring / waterfall cohorts)
    task_valid: torch.Tensor       # [T]
    sig_scores: torch.Tensor       # [S,N]
    sig_pred: torch.Tensor         # [S,N]
    pair_sig: torch.Tensor         # [P]
    pair_nz: torch.Tensor          # [P,2]
    order_min_available: torch.Tensor  # [J]
    job_queue: torch.Tensor        # [J]
    job_priority: torch.Tensor     # [J]
    job_create_rank: torch.Tensor  # [J]
    job_valid: torch.Tensor        # [J]
    q_deserved: torch.Tensor       # [Q,R]
    q_create_rank: torch.Tensor    # [Q]
    cluster_total: torch.Tensor    # [R]
    dyn_weights: torch.Tensor      # [2]


#: task-axis fields of CycleArrays (gathered for the compact continuation)
_TASK_FIELDS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
                "task_sig", "task_pair", "task_valid")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _segsum(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: sequential in update order (CPU)."""
    out = vals.new_zeros((num,) + tuple(vals.shape[1:]))
    return out.index_add_(0, seg.to(torch.int64), vals)


def _add_segsum(base: torch.Tensor, vals: torch.Tensor,
                seg: torch.Tensor) -> torch.Tensor:
    """``base + jax.ops.segment_sum(vals, seg)``. XLA folds the addition
    into the scatter, so each update adds onto ``base`` in turn (whereas
    ``base - segment_sum`` sums first, then subtracts)."""
    return base.clone().index_add_(0, seg.to(torch.int64), vals)


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: stable sorts from the first (least significant)
    key to the last (primary). Float keys are canonicalised (-0.0 sorts
    equal to +0.0, ``+ 0.0`` folds it) as JAX's sort comparator does."""
    order = None
    for k in keys:
        if k.dtype.is_floating_point:
            k = k + 0.0
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm, dtype=torch.int32)
    inv[perm] = torch.arange(perm.shape[0], dtype=torch.int32)
    return inv


def _segmented_prefix(values: torch.Tensor, starts: torch.Tensor
                      ) -> torch.Tensor:
    """Exclusive prefix sums within segments of a sorted array (reference
    ``_segmented_prefix``: an associative scan that restarts at each
    segment head)."""
    flag = torch.arange(values.shape[0]) == starts
    if values.dim() == 2:
        flag = flag[:, None].expand_as(values)

    def comb(a, b):
        sa, fa = a
        sb, fb = b
        return [torch.where(fb, sb, sa + sb), fa | fb]

    sums, _ = associative_scan(comb, [values, flag])
    return sums - values


def resource_eligibility(idle, releasing, n_tasks, a: CycleArrays,
                         pipe_enabled: bool, eps, rows) -> torch.Tensor:
    """[len(rows), N] predicate + capacity eligibility of task ``rows``
    (reference ``resource_eligibility``, without affinity terms)."""
    accessible = idle + a.backfilled
    base = a.node_ok & (n_tasks < a.max_task_num)
    init = a.init_resreq[rows]
    fit = (init[:, None, :] <= (accessible + eps)[None]).all(dim=-1)
    if pipe_enabled:
        fit = fit | (init[:, None, :] <= (releasing + eps)[None]).all(dim=-1)
    return a.sig_pred[a.task_sig[rows].long()] & base[None, :] & fit


def _row_pass(idle, releasing, n_tasks, a, pipe_enabled, eps, sc, mask):
    """For every task with ``mask``: any eligible node, and the masked
    argmax of its pair's scores over the eligible nodes (lowest index on
    ties; node 0 when none is eligible). In chunks of task rows; the
    kernel does one task row per warp."""
    t_pad = mask.shape[0]
    any_elig = torch.zeros(t_pad, dtype=torch.bool)
    best = torch.zeros(t_pad, dtype=torch.int32)
    rows_all = torch.nonzero(mask).flatten()
    for c in range(0, rows_all.shape[0], _ROW_CHUNK):
        rows = rows_all[c:c + _ROW_CHUNK]
        elig = resource_eligibility(idle, releasing, n_tasks, a,
                                    pipe_enabled, eps, rows)
        any_elig[rows] = elig.any(dim=1)
        masked = torch.where(elig, sc[a.task_pair[rows].long()], -torch.inf)
        best[rows] = masked.argmax(dim=1).to(torch.int32)
    return any_elig, best


def _cell_elig(idle, releasing, n_tasks, a, pipe_enabled, eps, node):
    """Eligibility of each task at one node each ([T] gathers)."""
    n = node.long()
    acc = (idle + a.backfilled)[n]
    base = a.node_ok[n] & (n_tasks[n] < a.max_task_num[n])
    fit = (a.init_resreq <= acc + eps).all(dim=-1)
    if pipe_enabled:
        fit = fit | (a.init_resreq <= releasing[n] + eps).all(dim=-1)
    return a.sig_pred[a.task_sig.long(), n] & base & fit


def _pair_scores(state, a, dyn_enabled):
    """[P,N] float32 pair scores: static sig score + the dynamic
    nodeorder term evaluated with the pair's own request."""
    sc = a.sig_scores[a.pair_sig.long()]
    dyn = torch.zeros_like(sc)
    if dyn_enabled:
        for p in range(0, sc.shape[0], _PAIR_CHUNK):
            dyn[p:p + _PAIR_CHUNK] = dynamic_node_score_plain(
                state.nz_req, a.pair_nz[p:p + _PAIR_CHUNK],
                a.allocatable_cm, a.dyn_weights)
    return sc + dyn


def _round(state: RoundState, a: CycleArrays, round_idx: int,
           job_keys, queue_keys, prop_overused: bool, dyn_enabled: bool,
           pipe_enabled: bool, seq_stride: int, stats=None):
    """One allocation round (reference ``_round``). Returns (new_state,
    progress). ``stats`` (a dict), when given, counts the round and the
    task rows of its two row passes."""
    f32, i32 = torch.float32, torch.int32
    eps = torch.from_numpy(VEC_EPS)
    t_pad = a.task_valid.shape[0]
    n_pad = a.node_ok.shape[0]
    j_pad = a.job_valid.shape[0]
    q_pad = a.q_deserved.shape[0]
    tj = a.task_job.long()                   # -1 wraps to J-1, as in jnp
    tj0 = a.task_job.clamp(min=0).long()
    jq = a.job_queue.long()

    # ---- 1. ordering ------------------------------------------------------
    overused = torch.zeros(q_pad, dtype=torch.bool)
    if prop_overused:
        overused = (a.q_deserved < state.q_allocated + eps).all(dim=-1)
    q_share = torch.zeros(q_pad, dtype=f32)
    for k in queue_keys:
        if k == K_PROP_SHARE:
            q_share = _share(state.q_allocated, a.q_deserved)
    jkeys = []
    for k in job_keys:
        if k == K_PRIORITY:
            jkeys.append(-a.job_priority)
        elif k == K_GANG_READY:
            jkeys.append((state.alloc_cnt >= a.order_min_available).to(f32))
        elif k == K_DRF_SHARE:
            jkeys.append(_share(state.j_allocated, a.cluster_total[None, :]))
    keys = ([a.job_create_rank.to(f32)] + list(reversed(jkeys))
            + [a.q_create_rank[jq].to(f32), q_share[jq]])
    job_order = _lexsort(keys)
    job_sort_rank = _inverse(job_order)

    engaged = (a.task_valid & (state.task_state == SKIP)
               & state.job_alive[tj] & a.job_valid[tj] & ~overused[jq[tj]])

    # ---- demand window ----------------------------------------------------
    base = a.node_ok & (state.n_tasks < a.max_task_num)
    avail_pool = column_sum(torch.where(
        base[:, None], torch.maximum(state.idle + a.backfilled, _f32(0.0)),
        _f32(0.0)))
    if pipe_enabled:
        avail_pool = avail_pool + column_sum(
            torch.maximum(state.releasing, _f32(0.0)))
    job_demand = _segsum(torch.where(engaged[:, None], a.resreq, _f32(0.0)),
                         tj0, j_pad)
    eng_job = (job_demand > 0).any(dim=-1)
    norm = torch.where(avail_pool[None, :] > 0,
                       job_demand / torch.maximum(avail_pool[None, :],
                                                  _f32(1e-9)),
                       _f32(0.0)).amax(dim=-1)
    norm_ord = norm[job_order]
    slack = _f32(_WINDOW_SLACK)
    cum_excl = tiled_cumsum(norm_ord) - norm_ord
    in_window = cum_excl <= slack

    if prop_overused:
        q_remaining = torch.maximum(a.q_deserved - state.q_allocated,
                                    _f32(0.0))
        qr_job = q_remaining[jq]
        qn = torch.where(qr_job > 0,
                         job_demand / torch.maximum(qr_job, _f32(1e-9)),
                         _f32(0.0)).amax(dim=-1)
        qperm = _lexsort([job_sort_rank, a.job_queue])
        qj = a.job_queue[qperm]
        seg_start = search_left(qj, qj)
        q_prefix = _segmented_prefix(qn[qperm], seg_start)
        eng_cnt = _segmented_prefix(eng_job[qperm].to(f32), seg_start)
        first_engaged = eng_job[qperm] & (eng_cnt == 0.0)
        q_ok_perm = (q_prefix <= 1.0) | first_engaged
        q_ok = torch.zeros(j_pad, dtype=torch.bool)
        q_ok[qperm] = q_ok_perm
        norm_ord = norm_ord * q_ok[job_order].to(f32)
        cum_excl = tiled_cumsum(norm_ord) - norm_ord
        in_window = cum_excl <= slack
    else:
        q_ok = torch.ones(j_pad, dtype=torch.bool)

    admitted = torch.zeros(j_pad, dtype=torch.bool)
    admitted[job_order] = in_window
    admitted = admitted & q_ok
    participating = engaged & admitted[tj]

    # global task rank: (job order, task order); non-participants last
    jr = torch.where(participating, job_sort_rank[tj],
                     torch.tensor(_IMAX, dtype=i32))
    order = _lexsort([a.task_rank, jr])
    global_rank = _inverse(order)

    # ---- 2. exact eligibility + 3. the masked argmax (one row pass) -------
    sc = _pair_scores(state, a, dyn_enabled)                  # [P,N]
    any_elig, fb = _row_pass(state.idle, state.releasing, state.n_tasks, a,
                             pipe_enabled, eps, sc, participating)
    fail_now = participating & ~any_elig
    fail_rank = torch.full((j_pad,), _IMAX, dtype=i32).scatter_reduce_(
        0, tj0, torch.where(fail_now, global_rank,
                            torch.tensor(_IMAX, dtype=i32)), "amin")
    job_killed = fail_rank < _IMAX
    fail_first = fail_now & (global_rank == fail_rank[tj])
    blocked = participating & (global_rank > fail_rank[tj])
    part2 = participating & ~fail_now & ~blocked & any_elig

    # ---- 3. proposals: the shared waterfall --------------------------------
    p_pad = a.pair_sig.shape[0]
    pair_demand = _segsum(part2.to(i32), a.task_pair.long(), p_pad)
    maj_pair = int(pair_demand.argmax())
    shared_sc = sc[maj_pair]
    ord_sh = _lexsort([-shared_sc])
    maj_ok = a.sig_pred[int(a.pair_sig[maj_pair])] & base
    cap_mass = torch.where(maj_ok[:, None],
                           torch.maximum(state.idle + a.backfilled,
                                         _f32(0.0)), _f32(0.0))
    room_cnt = torch.clamp(a.max_task_num - state.n_tasks, min=0).to(f32)
    cum_mass = tiled_cumsum(cap_mass[ord_sh])
    cum_cnt = tiled_cumsum(torch.where(maj_ok, room_cnt, _f32(0.0))[ord_sh])

    one_zero = torch.where(part2, _f32(1.0), _f32(0.0))
    mass_sorted = one_zero[order, None] * a.resreq[order]
    prefix_sorted = tiled_cumsum(mass_sorted) - mass_sorted
    cnt_sorted = one_zero[order]
    cnt_prefix_sorted = tiled_cumsum(cnt_sorted) - cnt_sorted
    prefix = torch.empty_like(mass_sorted)
    prefix[order] = prefix_sorted
    cnt_prefix = torch.empty_like(cnt_sorted)
    cnt_prefix[order] = cnt_prefix_sorted

    need = prefix + a.resreq
    slot = search_left(cum_mass[:, 0].contiguous(), need[:, 0].contiguous())
    for d in range(1, need.shape[1]):
        slot = torch.maximum(slot, search_left(cum_mass[:, d].contiguous(),
                                               need[:, d].contiguous()))
    slot = torch.maximum(slot, search_left(cum_cnt, cnt_prefix + 1.0))
    slot_ok = slot < n_pad
    p_water = ord_sh[slot.clamp(max=n_pad - 1)].to(i32)
    water_elig = _cell_elig(state.idle, state.releasing, state.n_tasks, a,
                            pipe_enabled, eps, p_water) & slot_ok
    proposal1 = torch.where(water_elig, p_water, fb)

    # ---- 4. acceptance (two phases) ---------------------------------------
    def accept_phase(proposal, mask, idle_c, rel_c, ntasks_c):
        acc_c = idle_c + a.backfilled
        pl = proposal.long()
        prop_alloc = (a.init_resreq <= acc_c[pl] + eps).all(dim=-1)
        node_key = torch.where(mask, proposal,
                               torch.tensor(n_pad, dtype=i32))
        perm2 = _lexsort([global_rank, node_key])
        nid = node_key[perm2]
        seg_start = search_left(nid, nid)
        nid_c = nid.clamp(max=n_pad - 1).long()
        s_req = a.resreq[perm2]
        s_init = a.init_resreq[perm2]
        s_alloc = prop_alloc[perm2]
        s_part = mask[perm2]
        alloc_vals = torch.where((s_alloc & s_part)[:, None], s_req,
                                 _f32(0.0))
        pipe_vals = torch.where((~s_alloc & s_part)[:, None], s_req,
                                _f32(0.0))
        excl_alloc = _segmented_prefix(alloc_vals, seg_start)
        excl_pipe = _segmented_prefix(pipe_vals, seg_start)
        excl_cnt = _segmented_prefix(s_part.to(i32), seg_start)
        pool_acc = acc_c[nid_c]
        pool_idle = idle_c[nid_c]
        pool_rel = rel_c[nid_c]
        room_left = (a.max_task_num[nid_c] - ntasks_c[nid_c]
                     - excl_cnt) > 0
        ok_alloc = (s_alloc & s_part & room_left
                    & (s_init <= pool_acc - excl_alloc + eps).all(dim=-1))
        if pipe_enabled:
            ok_pipe = (~s_alloc & s_part & room_left
                       & (s_init <= pool_rel - excl_pipe + eps).all(dim=-1))
        else:
            ok_pipe = torch.zeros_like(ok_alloc)
        accept_s = ok_alloc | ok_pipe
        ob_s = ok_alloc & ~(s_init <= pool_idle - excl_alloc
                            + eps).all(dim=-1)
        accept = torch.empty_like(accept_s)
        accept[perm2] = accept_s
        ob = torch.empty_like(ob_s)
        ob[perm2] = ob_s
        return accept, ob, prop_alloc

    def commit_node(accept, is_alloc, is_pipe, proposal, idle_c, rel_c,
                    ntasks_c, nz_c):
        node_seg = torch.where(accept, proposal, torch.tensor(0, dtype=i32))
        zero = _f32(0.0)
        idle_n = idle_c - _segsum(
            torch.where(is_alloc[:, None], a.resreq, zero), node_seg, n_pad)
        rel_n = rel_c - _segsum(
            torch.where(is_pipe[:, None], a.resreq, zero), node_seg, n_pad)
        ntasks_n = ntasks_c + _segsum(accept.to(i32), node_seg, n_pad)
        nz_n = _add_segsum(nz_c, torch.where(accept[:, None], a.task_nz,
                                             zero), node_seg)
        return idle_n, rel_n, ntasks_n, nz_n

    accept1, ob1, prop_alloc1 = accept_phase(
        proposal1, part2, state.idle, state.releasing, state.n_tasks)
    idle_c, rel_c, ntasks_c, nz_c = commit_node(
        accept1, prop_alloc1 & accept1, ~prop_alloc1 & accept1, proposal1,
        state.idle, state.releasing, state.n_tasks, state.nz_req)

    # retry phase: rejected tasks re-propose their argmax against the
    # mid-round carry (the scores stay the round's)
    retry = part2 & ~accept1
    any_r, fb_r = _row_pass(idle_c, rel_c, ntasks_c, a, pipe_enabled, eps,
                            sc, retry)
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + 1
        stats["rows"] = (stats.get("rows", 0) + int(participating.sum())
                         + int(retry.sum()))
    retry = retry & any_r
    accept_r, ob_r, prop_alloc_r = accept_phase(fb_r, retry, idle_c, rel_c,
                                                ntasks_c)
    idle_c, rel_c, ntasks_c, nz_c = commit_node(
        accept_r, prop_alloc_r & accept_r, ~prop_alloc_r & accept_r, fb_r,
        idle_c, rel_c, ntasks_c, nz_c)
    accept = accept1 | accept_r
    ob = torch.where(accept_r, ob_r, ob1)
    proposal = torch.where(accept_r, fb_r, proposal1)
    prop_alloc = torch.where(accept_r, prop_alloc_r, prop_alloc1)
    is_alloc = prop_alloc & accept
    is_pipe = ~prop_alloc & accept

    # ---- 5. commit (job / queue aggregates) -------------------------------
    zero_i = torch.tensor(0, dtype=i32)
    job_seg = torch.where(accept, a.task_job, zero_i)
    take_any = torch.where(accept[:, None], a.resreq, _f32(0.0))
    new_j_alloc = _add_segsum(state.j_allocated, take_any, job_seg)
    queue_seg = torch.where(accept, a.job_queue[tj0], zero_i)
    new_q_alloc = _add_segsum(state.q_allocated, take_any, queue_seg)
    counted = accept & ~ob
    new_alloc_cnt = state.alloc_cnt + _segsum(counted.to(i32), job_seg,
                                              j_pad)

    decision = torch.where(
        fail_first, FAIL,
        torch.where(is_pipe, PIPELINE,
                    torch.where(is_alloc & ob, ALLOC_OB,
                                torch.where(is_alloc, ALLOC, SKIP))))
    changed = accept | fail_first
    new_state = RoundState(
        idle=idle_c, releasing=rel_c, n_tasks=ntasks_c, nz_req=nz_c,
        q_allocated=new_q_alloc, j_allocated=new_j_alloc,
        alloc_cnt=new_alloc_cnt, job_alive=state.job_alive & ~job_killed,
        task_state=torch.where(changed, decision.to(i32), state.task_state),
        task_node=torch.where(accept, proposal, state.task_node),
        task_seq=torch.where(changed, round_idx * seq_stride + global_rank,
                             state.task_seq))
    return new_state, bool(changed.any())


def _placed(state: RoundState, a: CycleArrays) -> torch.Tensor:
    st = state.task_state
    return ((st == ALLOC) | (st == ALLOC_OB) | (st == PIPELINE)) \
        & a.task_valid


def _stranded_jobs(state: RoundState, a: CycleArrays,
                   include_killed: bool = True) -> torch.Tensor:
    """Jobs holding this-cycle placements but below quorum (reference
    ``_stranded_jobs``). As there, a job with no task row at all reads
    ``segment_max``'s identity (int32 min), which is truthy."""
    j_pad = a.job_valid.shape[0]
    tj0 = a.task_job.clamp(min=0).long()
    job_placed = torch.full((j_pad,), _IMIN, dtype=torch.int32
                            ).scatter_reduce_(
        0, tj0, _placed(state, a).to(torch.int32), "amax") != 0
    ob_cnt = _segsum(((state.task_state == ALLOC_OB) & a.task_valid)
                     .to(torch.int32), tj0, j_pad)
    ready = state.alloc_cnt + ob_cnt >= a.order_min_available
    stranded = a.job_valid & job_placed & ~ready
    if not include_killed:
        stranded = stranded & state.job_alive
    return stranded


def _rollback_stranded(state: RoundState, a: CycleArrays,
                       revive: bool = False):
    """Revert every this-cycle placement of stranded jobs (reference
    ``_rollback_stranded``); task_node and task_seq keep their values."""
    i32, zero = torch.int32, _f32(0.0)
    stranded = _stranded_jobs(state, a, include_killed=revive)
    tj0 = a.task_job.clamp(min=0).long()
    revert = _placed(state, a) & stranded[tj0]
    is_pipe = revert & (state.task_state == PIPELINE)
    n_pad = state.idle.shape[0]
    j_pad = a.job_valid.shape[0]
    zero_i = torch.tensor(0, dtype=i32)
    node_seg = torch.where(revert, state.task_node, zero_i)
    idle = _add_segsum(state.idle, torch.where(
        (revert & ~is_pipe)[:, None], a.resreq, zero), node_seg)
    rel = _add_segsum(state.releasing, torch.where(
        is_pipe[:, None], a.resreq, zero), node_seg)
    ntasks = state.n_tasks - _segsum(revert.to(i32), node_seg, n_pad)
    nz = state.nz_req - _segsum(torch.where(revert[:, None], a.task_nz,
                                            zero), node_seg, n_pad)
    job_seg = torch.where(revert, a.task_job, zero_i)
    take = torch.where(revert[:, None], a.resreq, zero)
    j_alloc = state.j_allocated - _segsum(take, job_seg, j_pad)
    queue_seg = torch.where(revert, a.job_queue[tj0], zero_i)
    q_alloc = state.q_allocated - _segsum(take, queue_seg,
                                          a.q_deserved.shape[0])
    counted = revert & (state.task_state != ALLOC_OB)
    alloc_cnt = state.alloc_cnt - _segsum(counted.to(i32), job_seg, j_pad)
    if revive:
        alive = state.job_alive | stranded
        clear = revert | ((state.task_state == FAIL) & stranded[tj0])
    else:
        alive = state.job_alive & ~stranded
        clear = revert
    return state._replace(
        idle=idle, releasing=rel, n_tasks=ntasks, nz_req=nz,
        q_allocated=q_alloc, j_allocated=j_alloc, alloc_cnt=alloc_cnt,
        job_alive=alive,
        task_state=torch.where(clear, torch.tensor(SKIP, dtype=i32),
                               state.task_state)), stranded


def _rounds_loop(state, a, start_round, max_rounds, seq_stride, opts,
                 stats):
    round_idx, progress = start_round, True
    while progress and round_idx < max_rounds:
        state, progress = _round(state, a, round_idx, *opts,
                                 seq_stride=seq_stride, stats=stats)
        round_idx += 1
    return state, round_idx


def _run_rounds(state: RoundState, a: CycleArrays, opts, max_rounds: int,
                compact_bucket: int, gang_enabled: bool, stats=None):
    """Reference ``batched_allocate``: the rounds, the compact
    continuation after round 0, then the stranded-gang epilogue. Returns
    (final state, rounds, epilogue retries, stranded gangs)."""
    t_pad = a.task_valid.shape[0]
    prop_overused = opts[2]
    if compact_bucket <= 0 or compact_bucket >= t_pad:
        state, rounds = _rounds_loop(state, a, 0, max_rounds, t_pad, opts,
                                     stats)
    else:
        state, _ = _round(state, a, 0, *opts, seq_stride=t_pad,
                          stats=stats)
        tj0 = a.task_job.clamp(min=0).long()
        unresolved = (a.task_valid & (state.task_state == SKIP)
                      & state.job_alive[tj0])
        if prop_overused:
            eps = torch.from_numpy(VEC_EPS)
            overused0 = (a.q_deserved < state.q_allocated + eps).all(dim=-1)
            unresolved = unresolved & ~overused0[a.job_queue[tj0].long()]
        cnt = int(unresolved.sum())
        if cnt > compact_bucket:
            state, rounds = _rounds_loop(state, a, 1, max_rounds, t_pad,
                                         opts, stats)
        elif cnt == 0:
            rounds = 1
        else:
            # the first compact_bucket unresolved tasks in index order,
            # fill slots (index t_pad) invalid, their rows clipped
            idx = torch.full((compact_bucket,), t_pad, dtype=torch.int64)
            nz_idx = torch.nonzero(unresolved).flatten()[:compact_bucket]
            idx[:nz_idx.shape[0]] = nz_idx
            valid_k = idx < t_pad
            idx_c = idx.clamp(max=t_pad - 1)
            ca = a._replace(**{f: getattr(a, f)[idx_c]
                               for f in _TASK_FIELDS})
            ca = ca._replace(task_valid=ca.task_valid & valid_k)
            cs = state._replace(task_state=state.task_state[idx_c],
                                task_node=state.task_node[idx_c],
                                task_seq=state.task_seq[idx_c])
            fs, rounds = _rounds_loop(cs, ca, 1, max_rounds, t_pad, opts,
                                      stats)
            put = {}
            for f in ("task_state", "task_node", "task_seq"):
                full = getattr(state, f).clone()
                full[idx[valid_k]] = getattr(fs, f)[valid_k]
                put[f] = full
            state = fs._replace(**put)
    if not gang_enabled:
        return state, rounds, 0, 0
    retries = 0
    while retries < 3 and bool(_stranded_jobs(state, a).any()):
        state, _ = _rollback_stranded(state, a, revive=True)
        state, rounds = _rounds_loop(state, a, rounds, max_rounds, t_pad,
                                     opts, stats)
        retries += 1
    state, stranded = _rollback_stranded(state, a, revive=False)
    return state, rounds, retries, int(stranded.sum())


def batched_allocate_plain(
        idle, releasing, n_tasks, nz_req, backfilled, allocatable_cm,
        max_task_num, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_pair, task_valid, sig_scores, sig_pred, pair_sig, pair_nz,
        order_min_available, init_allocated, job_queue, job_priority,
        job_create_rank, job_valid, q_deserved, q_create_rank, q_alloc0,
        j_alloc0, cluster_total, dyn_weights, *,
        job_keys: Tuple[str, ...] = (K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
        queue_keys: Tuple[str, ...] = (K_PROP_SHARE,),
        prop_overused: bool = True, dyn_enabled: bool = False,
        pipe_enabled: bool = True, max_rounds: int = 64,
        compact_bucket: int = 0, gang_enabled: bool = True,
        narrow: bool = False, narrow_gate: bool = False, stats=None):
    """The batched allocate cycle in plain PyTorch on CPU tensors (the
    reference's ``_batched_packed``). ``narrow`` and ``narrow_gate`` set
    only the telemetry words; scores are read at float32. ``stats`` (a
    dict), when given, receives the rounds run and the task rows of their
    row passes (the work a bound counts)."""
    args = locals()
    for name in NODE_ARGS + CYCLE_ARGS:
        if args[name].device.type != "cpu":
            raise ValueError("batched_allocate_plain runs on CPU tensors "
                             "(its segment sums are index_add_'s "
                             "sequential order on the CPU); copy the "
                             "inputs to the CPU")
    t_pad = task_valid.shape[0]
    i32 = torch.int32
    state = RoundState(
        idle=idle.clone(), releasing=releasing.clone(),
        n_tasks=n_tasks.clone(), nz_req=nz_req.clone(),
        q_allocated=q_alloc0.clone(), j_allocated=j_alloc0.clone(),
        alloc_cnt=init_allocated.clone(), job_alive=job_valid.clone(),
        task_state=torch.full((t_pad,), SKIP, dtype=i32),
        task_node=torch.full((t_pad,), -1, dtype=i32),
        task_seq=torch.full((t_pad,), _IMAX, dtype=i32))
    a = CycleArrays(**{f: args[f] for f in CycleArrays._fields})
    opts = (tuple(job_keys), tuple(queue_keys), bool(prop_overused),
            bool(dyn_enabled), bool(pipe_enabled))
    final, rounds, retries, stranded = _run_rounds(
        state, a, opts, int(max_rounds), int(compact_bucket),
        bool(gang_enabled), stats)
    frame = decision_frame(ENGINE_BATCHED, final.task_state, final.task_seq,
                           task_valid, waves=rounds, stride=t_pad,
                           narrow=narrow, narrow_gate=narrow_gate,
                           retries=retries, stranded=stranded)
    packed = torch.cat([final.task_state, final.task_node, final.task_seq,
                        torch.tensor([rounds], dtype=i32), frame])
    return packed, final.idle, final.releasing, final.n_tasks, final.nz_req


def unpack_result(packed, t_pad: int):
    """(task_state, task_node, task_seq, rounds, telemetry) of a packed
    result (numpy arrays or tensors)."""
    return (packed[:t_pad], packed[t_pad:2 * t_pad],
            packed[2 * t_pad:3 * t_pad], packed[3 * t_pad],
            packed[3 * t_pad + 1:])


def batched_allocate(*args, **kwargs):
    """The batched allocate cycle on the inputs' device: the CUDA kernel
    for CUDA tensors, :func:`batched_allocate_plain` for CPU tensors.
    Same arguments and results as :func:`batched_allocate_plain`."""
    names = NODE_ARGS + CYCLE_ARGS
    statics = {k: kwargs.pop(k) for k in list(kwargs) if k not in names}
    bound = dict(zip(names, args))
    bound.update(kwargs)
    missing = [n for n in names if n not in bound]
    if missing:
        raise TypeError(f"batched_allocate: missing arguments {missing}")
    devs = {bound[n].device.type for n in names}
    if devs == {"cpu"}:
        return batched_allocate_plain(*(bound[n] for n in names), **statics)
    if devs != {"cuda"}:
        raise ValueError(f"batched_allocate: inputs on mixed devices {devs}")
    return _batched_allocate_cuda(bound, **statics)


#: phases of a round the kernel times between its grid barriers, in the
#: order of csrc/batched_allocate.cu's PH_* (device ns summed per phase)
PHASES = ("setup", "order_jobs", "engage", "window", "pair_scores",
          "rank_and_rows", "fail", "part2", "waterfall", "propose",
          "fit", "accept_commit", "retry_views", "retry_rows",
          "retry_mask", "retry_fit", "retry_accept_commit", "compact",
          "epilogue")

#: grid, threads, dynamic shared bytes and workspace bytes of the last
#: kernel launch, and its per-phase device ns (``phase_ns``: an int64
#: tensor on the card, PHASES order; reading it is a copy of its own)
last_launch: dict = {}


def _batched_allocate_cuda(a, *, job_keys=(K_PRIORITY, K_GANG_READY,
                                           K_DRF_SHARE),
                           queue_keys=(K_PROP_SHARE,), prop_overused=True,
                           dyn_enabled=False, pipe_enabled=True,
                           max_rounds=64, compact_bucket=0,
                           gang_enabled=True, narrow=False,
                           narrow_gate=False):
    import ctypes

    for name, t in a.items():
        want = arg_dtype(name)
        if t.dtype != want:
            raise ValueError(f"batched_allocate: {name} must be {want}, got "
                             f"{t.dtype}")
    if len(job_keys) > 3 or any(k not in JOB_KEY_CODES for k in job_keys):
        raise ValueError(f"batched_allocate: unsupported job keys {job_keys}")
    if any(k != K_PROP_SHARE for k in queue_keys):
        raise ValueError(f"batched_allocate: unsupported queue keys "
                         f"{queue_keys}")
    dev = a["idle"].device
    n = a["idle"].shape[0]
    t = a["task_valid"].shape[0]
    j = a["job_valid"].shape[0]
    q = a["q_deserved"].shape[0]
    s = a["sig_scores"].shape[0]
    p = a["pair_sig"].shape[0]
    shapes = {"idle": (n, 3), "releasing": (n, 3), "n_tasks": (n,),
              "nz_req": (n, 2), "backfilled": (n, 3),
              "allocatable_cm": (n, 2), "max_task_num": (n,),
              "node_ok": (n,), "resreq": (t, 3), "init_resreq": (t, 3),
              "task_nz": (t, 2), "task_job": (t,), "task_rank": (t,),
              "task_sig": (t,), "task_pair": (t,), "sig_scores": (s, n),
              "sig_pred": (s, n), "pair_sig": (p,), "pair_nz": (p, 2),
              "order_min_available": (j,), "init_allocated": (j,),
              "job_queue": (j,), "job_priority": (j,),
              "job_create_rank": (j,), "q_deserved": (q, 3),
              "q_create_rank": (q,), "q_alloc0": (q, 3), "j_alloc0": (j, 3),
              "cluster_total": (3,), "dyn_weights": (2,)}
    for name, shape in shapes.items():
        if tuple(a[name].shape) != shape:
            raise ValueError(f"batched_allocate: {name} must have shape "
                             f"{shape}, got {tuple(a[name].shape)}")
    c = {k: v.contiguous() for k, v in a.items()}
    # node carries live in the outputs (the JAX kernel returns new arrays)
    idle = c["idle"].clone()
    releasing = c["releasing"].clone()
    n_tasks = c["n_tasks"].clone()
    nz = c["nz_req"].clone()
    packed = torch.empty(3 * t + 1 + TELEM_WIDTH, dtype=torch.int32,
                         device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    codes = [JOB_KEY_CODES[k] for k in job_keys] + [0] * (3 - len(job_keys))
    ints = np.asarray([
        n, t, j, q, p, len(job_keys), *codes,
        int(K_PROP_SHARE in queue_keys), int(bool(prop_overused)),
        int(bool(dyn_enabled)), int(bool(pipe_enabled)), int(max_rounds),
        int(compact_bucket), int(bool(gang_enabled)), int(bool(narrow)),
        int(bool(narrow_gate))], dtype=np.int32)
    lib = _build.library("batched_allocate.cu")
    ws_bytes = ctypes.c_longlong(0)
    _build.check_launch("batched_allocate", lib.kb_batched_workspace(
        ints.ctypes.data, ints.shape[0], ctypes.addressof(ws_bytes)))
    ws = torch.empty(ws_bytes.value, dtype=torch.uint8, device=dev)
    phase_ns = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
    ptrs = np.asarray([
        idle.data_ptr(), releasing.data_ptr(), n_tasks.data_ptr(),
        nz.data_ptr(),
        *(c[k].data_ptr() for k in (
            "backfilled", "allocatable_cm", "max_task_num", "node_ok",
            "resreq", "init_resreq", "task_nz", "task_job", "task_rank",
            "task_sig", "task_pair", "task_valid", "sig_scores", "sig_pred",
            "pair_sig", "pair_nz", "order_min_available", "init_allocated",
            "job_queue", "job_priority", "job_create_rank", "job_valid",
            "q_deserved", "q_create_rank", "q_alloc0", "j_alloc0",
            "cluster_total", "dyn_weights")),
        eps.data_ptr(), packed.data_ptr(), phase_ns.data_ptr(),
        ws.data_ptr()], dtype=np.uint64)
    info = np.zeros(3, dtype=np.int32)
    err = lib.kb_batched_allocate(
        ptrs.ctypes.data, ptrs.shape[0], ints.ctypes.data, ints.shape[0],
        info.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("batched_allocate", err)
    _build.count_launch("batched_allocate")
    last_launch.update(grid=int(info[0]), threads=int(info[1]),
                       smem_bytes=int(info[2]), workspace_bytes=ws.numel(),
                       phase_ns=phase_ns)
    return packed, idle, releasing, n_tasks, nz


#: per-cycle arrays shipped as packed buffers (kernels/pack.py), in the
#: reference's layout; node-axis arrays live on the DeviceSession
_PACK_F32 = ("resreq", "init_resreq", "task_nz", "sig_scores",
             "job_priority", "q_deserved", "cluster_total", "dyn_weights",
             "pair_nz", "q_alloc0", "j_alloc0")
_PACK_I32 = ("task_job", "task_rank", "task_sig", "task_pair",
             "order_min_available", "job_queue", "job_create_rank",
             "q_create_rank", "init_allocated", "pair_sig")
_PACK_BOOL = ("task_valid", "job_valid", "sig_pred")


def prepare_batched(inputs, max_rounds: int = 0, compact_bucket=None):
    """The (args, statics) of the batched solve for these CycleInputs
    (actions/cycle_inputs.py): args maps every batched_allocate argument
    to a tensor on the DeviceSession's device (the per-cycle arrays
    uploaded as three packed buffers), statics holds the keyword options,
    sized as the reference's prepare_batched sizes them.
    ``compact_bucket``: None sizes the post-round-0 compaction
    automatically; 0 forces the full-width loop."""
    from .narrow import narrow_enabled
    from .pack import pack_inputs, unpack

    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    if max_rounds <= 0:
        # every productive round places >= 1 task or fails >= 1 job; the
        # bound is a safety net, not the expected round count
        max_rounds = int(t_pad) + 8
    task_pair, pair_sig, pair_nz, _ = inputs.pair_terms()
    extra = {"task_pair": task_pair, "pair_sig": pair_sig,
             "pair_nz": pair_nz}
    bufs = pack_inputs(lambda nm: extra[nm] if nm in extra
                       else getattr(inputs, nm),
                       _PACK_F32, _PACK_I32, _PACK_BOOL)
    dev = device.device
    args = {k: getattr(device, k) for k in NODE_ARGS}
    for buf, lay in zip(bufs[0::2], bufs[1::2]):
        args.update(unpack(torch.from_numpy(buf).to(dev), lay))
    if compact_bucket is None:
        # compaction pays off once the [T,N] passes dwarf the stragglers
        compact = max(256, t_pad // 8) if t_pad >= 2048 else 0
    else:
        compact = int(compact_bucket)
    n_pad = int(device.node_ok.shape[0])
    narrow = narrow_enabled(
        n_pad, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None))
    statics = dict(
        job_keys=inputs.job_keys, queue_keys=inputs.queue_keys,
        prop_overused=inputs.prop_overused,
        dyn_enabled=inputs.dyn_enabled, pipe_enabled=inputs.pipe_enabled,
        max_rounds=min(max_rounds, 4096), compact_bucket=compact,
        gang_enabled=inputs.gang_enabled, narrow=narrow,
        # telemetry: the shape thresholds alone wanted the narrow store
        # but the score/weight scale refused it
        narrow_gate=(not narrow and narrow_enabled(n_pad, t_pad)))
    return args, statics


def solve_batched(inputs, max_rounds: int = 0, compact_bucket=None,
                  phases=None):
    """Run the batched solve for these CycleInputs and make its ONE
    counted device->host copy; commits the final node carry to the
    DeviceSession. Returns (task_state, task_node, task_seq, rounds,
    telemetry) as numpy. ``phases`` (a dict), when given, receives the
    host milliseconds of upload, solve (launch) and sync, and ``kernel``:
    the solve's device milliseconds from CUDA events (NaN on the CPU)."""
    import time

    from ..device import to_host

    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    t0 = time.perf_counter()
    args, statics = prepare_batched(inputs, max_rounds, compact_bucket)
    t1 = time.perf_counter()
    on_card = device.device.type == "cuda"
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
    packed, idle, releasing, n_tasks, nz = batched_allocate(**args,
                                                            **statics)
    if on_card:
        end.record()
    t2 = time.perf_counter()
    host = to_host(packed)            # the solve's ONE device->host copy
    t3 = time.perf_counter()
    device.idle, device.releasing, device.n_tasks = idle, releasing, n_tasks
    device.nz_req = nz
    if phases is not None:
        phases.update(upload=(t1 - t0) * 1e3, solve=(t2 - t1) * 1e3,
                      sync=(t3 - t2) * 1e3,
                      kernel=(start.elapsed_time(end) if on_card
                              else float("nan")))
    state, node, seq, rounds, telem = unpack_result(host, t_pad)
    return state, node, seq, int(rounds), telem
