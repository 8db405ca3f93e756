"""Victim selection for preempt and reclaim — node visits as tensor ops.

The reference's preempt hot loop evaluates, per preemptor task, a
predicate+score pass over ALL nodes and then a per-node victim scan
calling every evictability plugin per (victim) pair
(ref: actions/preempt/preempt.go:266-334, reclaim/reclaim.go:128-173).
This module evaluates ONE ENTIRE NODE VISIT — all nodes' predicate mask,
the tiered-intersection victim masks, resource-sufficiency validation
and the node choice — as one kernel launch over dense [V] (cluster-wide
running tasks) and [N] (nodes) arrays.

Semantics preserved exactly (vs framework/session.py + plugins):
- tier dispatch: per tier, victims = INTERSECTION of enabled plugin
  verdicts; the first tier with a non-empty set per node wins
  (session.py:_evictable); the conformance veto then re-applies.
- gang: victim's job stays >= MinAvailable after losing ONE task, or the
  MinAvailable==1 fork quirk (plugins/gang.py preemptable_fn), read from
  the job's CURRENT ready count.
- drf: preemptor's post-share vs victim-job's post-eviction share within
  1e-6, with the reference's CUMULATIVE per-job allocation decrements in
  candidate-list order within one call (plugins/drf.py).
- proportion (reclaim): victim's queue stays >= deserved after the
  cumulative eviction; the allocated.less(resreq) skip guard is
  sequential, so the analysis flags every node where it trips and the
  action evaluates that node with the exact host block.
- validation: victims' total NOT strictly-less than the request in every
  dimension (preempt.go:355-370).
- eviction order and the cumulative early stop replay ON THE HOST in
  float64 through the real Statement/session mutators.

Two kernels, each with its plain PyTorch version beside it:
:func:`victim_wave` (the analysis for a batch of preemptor lanes, no node
choice: ``bool[L, 2N + V]`` = pick | guard | victims) and
:func:`victim_visit` (one lane, then the first pickable node in
``lexsort((host_rank, -score))`` order: ``int32[4 + V]``). For CUDA
tensors they launch ``csrc/victims.cu``; for CPU tensors they run the
plain versions, which equal the reference's ``_wave_kernel`` /
``_visit_kernel`` bit for bit (tests/test_torch_victims.py).

Dispatch policy: the reference's accelerator branch on every device —
waves from the first visit, lanes sized to cover the pending set (64 to
512). The host chooses nodes per visit from cached wave lanes in fresh
score order (numpy float32, :func:`solver.dynamic_node_score_np`), and a
visit whose best candidate node was touched by a replayed eviction or
pipeline pays a single-lane refresh. Every dispatch makes exactly one
counted device->host copy (``device.to_host``).

The victim rows live in the reference's ``SegmentStore`` layout: an
incremental cache keeps the store across cycles (only nodes and jobs the
event fold or the session dirtied are rebuilt; slots relocate and the
spaces compact as in the reference), a snapshot-primary cache builds a
fresh store per action. The kernels take any such layout: they order
rows by (node, job) themselves.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import TaskInfo, TaskStatus, ready_statuses
from ..api.resource import RESOURCE_DIM, VEC_EPS, VEC_SCALE
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device, to_host
from . import _build
from .solver import dynamic_node_score_np, dynamic_node_score_plain
from .telemetry import (ENGINE_VICTIM_VISIT, ENGINE_VICTIM_WAVE, host_frame,
                        victim_frames)
from .tensorize import accumulate_nz, nz_request_vec, pad_to_bucket
from .xla_order import associative_scan

_READY = None

#: the four tier plugins the analysis expresses, as the kernel's bits
TIER_BITS = {"gang": 1, "conformance": 2, "drf": 4, "proportion": 8}
FILTER_KINDS = ("inter_queue", "intra_job", "other_queue")

#: argument names, in groups: the immutable state of one action, its
#: mutable mirrors, the [S, N] static terms, the per-row node order the
#: kernels read (plain versions ignore it), and the preemptor lanes
STATIC_ARGS = ("node_ok", "max_task_num", "allocatable_cm", "host_rank",
               "v_node", "v_job", "v_res", "v_critical", "perm_nj",
               "nj_head", "perm_nq", "nq_head", "min_av", "job_queue",
               "q_deserved", "q_prop_ok", "cluster_total", "dyn_weights")
MUTABLE_ARGS = ("n_tasks", "nz_req", "v_live", "ready_cnt", "j_alloc",
                "q_alloc")
SIG_ARGS = ("sig_scores", "sig_pred")
ORDER_ARGS = ("node_rows", "node_off")
LANE_ARGS = ("p_res", "p_resreq", "p_nz", "p_sig", "p_job", "p_queue")

_F32 = ("allocatable_cm", "v_res", "q_deserved", "cluster_total",
        "dyn_weights", "nz_req", "j_alloc", "q_alloc", "sig_scores",
        "p_res", "p_resreq", "p_nz")
_BOOL = ("node_ok", "v_critical", "nj_head", "nq_head", "q_prop_ok",
         "v_live", "sig_pred", "visited")


_NP_DTYPES = {torch.float32: np.float32, torch.bool: np.bool_,
              torch.int32: np.int32}


def arg_dtype(name: str) -> torch.dtype:
    if name in _F32:
        return torch.float32
    if name in _BOOL:
        return torch.bool
    return torch.int32


def _pod_critical(pod) -> bool:
    """conformance's never-evict rule, memoized on the pod (spec fields
    are immutable for the pod's lifetime; runs per victim row per
    action)."""
    crit = getattr(pod, "_kb_crit", None)
    if crit is None:
        from ..plugins.conformance import (NAMESPACE_SYSTEM,
                                           SYSTEM_CLUSTER_CRITICAL,
                                           SYSTEM_NODE_CRITICAL)
        crit = (pod.priority_class_name in (SYSTEM_CLUSTER_CRITICAL,
                                            SYSTEM_NODE_CRITICAL)
                or pod.namespace == NAMESPACE_SYSTEM)
        pod._kb_crit = crit
    return crit


def _ready_statuses():
    global _READY
    if _READY is None:
        _READY = tuple(ready_statuses())
    return _READY


# ---------------------------------------------------------------------
# plain versions of the analysis (the reference's in-kernel helpers)
# ---------------------------------------------------------------------

def _le_eps(a, b, eps):
    """Resource.less_equal elementwise: (a < b) | (|b - a| < eps)."""
    return (a < b) | ((b - a).abs() < eps)


def _share3(vec, total):
    """share() per dimension: x/0 -> 1, 0/0 -> 0; returns max over dims."""
    zero = torch.zeros((), dtype=vec.dtype, device=vec.device)
    one = torch.ones((), dtype=vec.dtype, device=vec.device)
    s = torch.where(total == 0.0, torch.where(vec == 0.0, zero, one),
                    vec / torch.where(total == 0.0, one, total))
    return s.amax(dim=-1)


def _seg_comb(a, b):
    sa, fa = a
    sb, fb = b
    return [torch.where(fb, sb, sa + sb), fa | fb]


def _seg_excl_cumsum(values, head):
    """The reference's "exclusive" segmented sum along dim 0: the
    inclusive ``associative_scan`` (its odd/even tree) minus the values,
    which is not the exclusive sum in float32. ``head[i]`` flags the
    first row of row i's segment; rows of one segment are contiguous."""
    flag = head.reshape(head.shape + (1,) * (values.dim() - 1))
    sums, _ = associative_scan(_seg_comb, [values, flag])
    return sums - values


def _seg_any(mask, seg, num):
    """Per-segment any over the last axis of ``mask`` [..., V] (the
    reference's ``segment_max(int32) > 0``: an empty segment is false)."""
    shape = mask.shape[:-1] + (num,)
    cnt = torch.zeros(shape, dtype=torch.int32, device=mask.device)
    return cnt.index_add_(mask.dim() - 1, seg, mask.to(torch.int32)) > 0


def analysis_plain(p_res, p_resreq, p_pred, p_job, p_queue, node_ok,
                   n_tasks, max_task_num, v_node, v_job, v_res, v_critical,
                   v_live, perm_nj, nj_head, perm_nq, nq_head, ready_cnt,
                   min_av, j_alloc, job_queue, q_alloc, q_deserved,
                   q_prop_ok, cluster_total, *, tiers, veto_critical: bool,
                   filter_kind: str, room_check: bool):
    """``_analysis_core`` (reference kernels/victims.py:218) over a batch
    of L lanes: (pick0 [L,N], guard_n [L,N], victims [L,V]) — pick0 flags
    nodes where the tiered victim set validates (or the proportion guard
    tripped), before the caller's visited mask; victims holds the chosen
    victim rows for EVERY node at once."""
    dev = v_res.device
    f32 = torch.float32
    eps = torch.as_tensor(VEC_EPS, dtype=f32, device=dev)
    n_pad = node_ok.shape[0]
    v_pad = v_node.shape[0]
    n_lanes = p_job.shape[0]
    seg = v_node.long()
    known = v_job >= 0
    vj = v_job.clamp(min=0).long()
    jq = job_queue[vj]
    pj = p_job[:, None]
    pq = p_queue[:, None]

    # ---- candidate filter (host task_filter semantics) ----------------
    if filter_kind == "inter_queue":       # preempt phase 1
        cand = v_live & known & (jq[None] == pq) & (v_job[None] != pj)
    elif filter_kind == "intra_job":       # preempt phase 2
        cand = v_live & known & (v_job[None] == pj)
    elif filter_kind == "other_queue":     # reclaim: other queues only
        cand = v_live & known & (jq[None] != pq)
    else:
        raise ValueError(f"filter_kind {filter_kind!r} is not one of "
                         f"{FILTER_KINDS}")

    # ---- plugin verdict masks -----------------------------------------
    gang_ok = (((ready_cnt[vj] - 1 >= min_av[vj]) | (min_av[vj] == 1))
               & known)[None]
    conf_ok = (~v_critical)[None]
    zeros_lv = torch.zeros((n_lanes, v_pad), dtype=torch.bool, device=dev)
    vres_c = torch.where(cand[..., None], v_res[None],
                         torch.zeros((), dtype=f32, device=dev))

    drf_ok = zeros_lv
    if any("drf" in t for t in tiers):
        # cumulative per (node, job) in candidate order: drf decrements its
        # working allocation for EVERY candidate of the job, accepted or not
        pnj = perm_nj.long()
        vals = vres_c[:, pnj].transpose(0, 1)           # [V, L, 3]
        excl = _seg_excl_cumsum(vals, nj_head)
        cum_incl = torch.empty_like(vals)
        cum_incl[pnj] = excl + vals
        rs = _share3(j_alloc[vj][:, None] - cum_incl,
                     cluster_total).transpose(0, 1)     # [L, V]
        ls = _share3(j_alloc[p_job.clamp(min=0).long()] + p_resreq,
                     cluster_total)                     # [L]
        drf_ok = (((ls[:, None] < rs)
                   | ((ls[:, None] - rs).abs()
                      <= torch.tensor(1e-6, dtype=f32)))
                  & known[None])

    prop_ok = zeros_lv
    guard_v = zeros_lv
    if any("proportion" in t for t in tiers):
        vq = job_queue[vj]
        vqc = vq.clamp(min=0).long()
        p_elig = cand & (q_prop_ok[vqc] & (vq >= 0))[None]
        pnq = perm_nq.long()
        vals = torch.where(p_elig[..., None], v_res[None],
                           torch.zeros((), dtype=f32, device=dev))
        vals = vals[:, pnq].transpose(0, 1)             # [V, L, 3]
        excl_s = _seg_excl_cumsum(vals, nq_head)
        excl = torch.empty_like(excl_s)
        excl[pnq] = excl_s
        before = q_alloc[vqc][:, None] - excl           # [V, L, 3]
        after = before - v_res[:, None]
        prop_ok = p_elig & _le_eps(q_deserved[vqc][:, None], after,
                                   eps).all(dim=-1).transpose(0, 1)
        # the reference SKIPS (without decrementing) a candidate whose
        # queue allocation is strictly below its request in every dim —
        # sequential semantics the scan can't express; flag per node
        guard_v = p_elig & (before < v_res[:, None]).all(
            dim=-1).transpose(0, 1)

    masks = {"gang": gang_ok, "conformance": conf_ok, "drf": drf_ok,
             "proportion": prop_ok}

    # ---- tier selection: first tier with a non-empty set per node -----
    chosen = zeros_lv
    taken_n = torch.zeros((n_lanes, n_pad), dtype=torch.bool, device=dev)
    for tier in tiers:
        tier_mask = cand
        for name in tier:
            tier_mask = tier_mask & masks[name]
        any_n = _seg_any(tier_mask, seg, n_pad)
        use_n = any_n & ~taken_n
        chosen = chosen | (tier_mask & use_n[:, seg])
        taken_n = taken_n | any_n
    victims = chosen & conf_ok if veto_critical else chosen

    # ---- validation: total not strictly-less in every dim -------------
    # segment sums add in row order per node from 0.0 (XLA's scatter),
    # which is index_add_'s order on the CPU
    vic_res = torch.where(victims[..., None], v_res[None],
                          torch.zeros((), dtype=f32, device=dev))
    tot_n = torch.zeros((n_pad, n_lanes, RESOURCE_DIM), dtype=f32,
                        device=dev).index_add_(0, seg,
                                               vic_res.transpose(0, 1))
    any_v_n = _seg_any(victims, seg, n_pad)
    valid_n = any_v_n & ~(tot_n.transpose(0, 1)
                          < p_res[:, None, :]).all(dim=-1)

    # ---- node pickability ---------------------------------------------
    base0 = node_ok[None] & p_pred
    if room_check:
        base0 = base0 & (n_tasks < max_task_num)[None]
    guard_n = _seg_any(guard_v, seg, n_pad)
    pick0 = base0 & (valid_n | guard_n)
    return pick0, guard_n, victims


def _analysis_args(kw, p_pred):
    return dict(
        p_res=kw["p_res"], p_resreq=kw["p_resreq"], p_pred=p_pred,
        p_job=kw["p_job"], p_queue=kw["p_queue"],
        **{n: kw[n] for n in ("node_ok", "n_tasks", "max_task_num",
                              "v_node", "v_job", "v_res", "v_critical",
                              "v_live", "perm_nj", "nj_head", "perm_nq",
                              "nq_head", "ready_cnt", "min_av", "j_alloc",
                              "job_queue", "q_alloc", "q_deserved",
                              "q_prop_ok", "cluster_total")})


def wave_plain(*, tiers, veto_critical: bool, filter_kind: str,
               dyn_enabled: bool, score_nodes: bool, room_check: bool,
               **kw) -> torch.Tensor:
    """``_wave_kernel`` (reference kernels/victims.py:401): the analysis
    for every lane, packed as ``bool[L, 2N + V]`` (pick | guard |
    victims). The node-order arrays (ORDER_ARGS) are not read."""
    p_pred = kw["sig_pred"][kw["p_sig"].long()]
    pick, guard, victims = analysis_plain(
        **_analysis_args(kw, p_pred), tiers=tiers,
        veto_critical=veto_critical, filter_kind=filter_kind,
        room_check=room_check)
    return torch.cat([pick, guard, victims], dim=1)


def _first_in_order(key, rank, cand):
    """The first node of ``lexsort((rank, key))`` among ``cand`` (-0.0
    equal to +0.0, ties to the lowest index)."""
    kmin = torch.where(cand, key, torch.full_like(key, math.inf)).min()
    sel = cand & (key == kmin)
    imax = torch.iinfo(torch.int32).max
    rmin = torch.where(sel, rank, torch.full_like(rank, imax)).min()
    sel = sel & (rank == rmin)
    return int(torch.nonzero(sel)[0, 0])


def visit_plain(*, tiers, veto_critical: bool, filter_kind: str,
                dyn_enabled: bool, score_nodes: bool, room_check: bool,
                visited: torch.Tensor, **kw) -> torch.Tensor:
    """``_visit_core`` (reference kernels/victims.py:324) for the single
    lane of the lane arrays: the analysis, then the first pickable node
    in ``lexsort((host_rank, -score))`` order, packed as ``int32[4 + V]``
    = [found, node, victims on it, guard on it, mask[V]...]. When nothing
    is pickable, node is the first node of that order over ALL nodes and
    the words are that node's."""
    sig = kw["p_sig"].long()
    p_score = kw["sig_scores"][sig[0]].to(torch.float32)
    p_pred = kw["sig_pred"][sig]
    pick0, guard_n, victims = analysis_plain(
        **_analysis_args(kw, p_pred), tiers=tiers,
        veto_critical=veto_critical, filter_kind=filter_kind,
        room_check=room_check)
    pick0, guard_n, victims = pick0[0], guard_n[0], victims[0]
    pick_n = pick0 & ~visited
    if score_nodes:
        score = p_score
        if dyn_enabled:
            score = score + dynamic_node_score_plain(
                kw["nz_req"], kw["p_nz"][0], kw["allocatable_cm"],
                kw["dyn_weights"])
        key = -score
    else:
        key = torch.zeros_like(p_score)
    found = bool(pick_n.any())
    rank = kw["host_rank"]
    node = _first_in_order(key, rank, pick_n if found else
                           torch.ones_like(pick_n))
    mask = victims & (kw["v_node"] == node)
    head = torch.tensor([int(found), node, int(mask.sum()),
                         int(guard_n[node])], dtype=torch.int32,
                        device=mask.device)
    return torch.cat([head, mask.to(torch.int32)])


# ---------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------

#: scalar description of the latest kernel launch (lanes, rows, nodes,
#: grid, cluster, workspace bytes) and its per-phase device ns
#: (``phase_ns``: an int64 tensor on the card, PHASES order, taken by CTA 0's
#: thread 0 over the lanes its cluster ran)
last_launch: Dict[str, object] = {}

#: phases of csrc/victims.cu timed between its barriers
PHASES = ("filter", "drf_scan", "prop_scan", "node_pass", "visit")

#: threads per CTA, and the most CTAs a wave's grid holds: a wave takes
#: as many clusters as the card holds at once, at most MAX_BLOCKS CTAs (the
#: lanes past its clusters loop; each cluster owns one lane's workspace)
NT = 512
MAX_BLOCKS = 264
#: CTAs of the thread-block cluster that runs each lane (the portable
#: size). Clusters win at every wave size the solver dispatches: on an
#: H100 80GB HBM3 at 700 W, 256-lane waves take 0.305-0.313 ms over
#: clusters against 0.461 at one CTA a lane, the 512-lane cfg4 wave 0.763
#: against 1.125 (cluster_timing.py, PERF.md row 7)
CLUSTER = 8


#: (v_pad, cluster) -> clusters the card holds at once (the library's
#: occupancy query, asked once a shape)
_resident: Dict[Tuple[int, int], int] = {}


def _slots(lib, lanes: int, v_pad: int, cluster: int) -> int:
    key = (v_pad, cluster)
    if key not in _resident:
        n = lib.kb_victims_resident(v_pad, cluster, NT)
        if n <= 0:
            raise RuntimeError(f"victims.cu: no cluster of {cluster} CTAs "
                               f"fits the card at V_pad {v_pad} (CUDA error "
                               f"{-n})")
        _resident[key] = n
    return min(lanes, _resident[key], MAX_BLOCKS // cluster)


def _config_ints(tiers, veto_critical, filter_kind, dyn_enabled,
                 score_nodes, room_check):
    if filter_kind not in FILTER_KINDS:
        raise ValueError(f"filter_kind {filter_kind!r} is not one of "
                         f"{FILTER_KINDS}")
    masks = []
    for tier in tiers:
        m = 0
        for name in tier:
            if name not in TIER_BITS:
                raise ValueError(f"tier plugin {name!r} is outside the "
                                 f"victim analysis ({tuple(TIER_BITS)})")
            m |= TIER_BITS[name]
        masks.append(m)
    return masks, [int(bool(veto_critical)), FILTER_KINDS.index(filter_kind),
                   int(bool(dyn_enabled)), int(bool(score_nodes)),
                   int(bool(room_check))]


def _check_args(kw, what: str, visit: bool):
    names = STATIC_ARGS + MUTABLE_ARGS + SIG_ARGS + ORDER_ARGS + LANE_ARGS \
        + (("visited",) if visit else ())
    missing = [n for n in names if n not in kw]
    if missing:
        raise ValueError(f"{what}: missing arguments {missing}")
    devs = {kw[n].device.type for n in names}
    if len(devs) != 1:
        raise ValueError(f"{what}: mixed devices {devs}")
    for n in names:
        if kw[n].dtype != arg_dtype(n):
            raise ValueError(f"{what}: {n} must be {arg_dtype(n)}, got "
                             f"{kw[n].dtype}")
    lanes = kw["p_job"].shape[0]
    n_pad = kw["node_ok"].shape[0]
    v_pad = kw["v_node"].shape[0]
    n_jobs = kw["job_queue"].shape[0]
    n_queues = kw["q_prop_ok"].shape[0]
    shapes = {
        "p_res": (lanes, 3), "p_resreq": (lanes, 3), "p_nz": (lanes, 2),
        "p_sig": (lanes,), "p_queue": (lanes,),
        "sig_scores": (kw["sig_scores"].shape[0], n_pad),
        "sig_pred": tuple(kw["sig_scores"].shape[:1]) + (n_pad,),
        "max_task_num": (n_pad,), "allocatable_cm": (n_pad, 2),
        "host_rank": (n_pad,), "n_tasks": (n_pad,), "nz_req": (n_pad, 2),
        "v_job": (v_pad,), "v_res": (v_pad, 3), "v_critical": (v_pad,),
        "v_live": (v_pad,), "perm_nj": (v_pad,), "nj_head": (v_pad,),
        "perm_nq": (v_pad,), "nq_head": (v_pad,), "min_av": (n_jobs,),
        "ready_cnt": (n_jobs,), "j_alloc": (n_jobs, 3),
        "q_deserved": (n_queues, 3), "q_alloc": (n_queues, 3),
        "cluster_total": (3,), "dyn_weights": (2,),
        "node_off": (n_pad + 1,)}
    if visit:
        shapes["visited"] = (n_pad,)
    for n, shape in shapes.items():
        if tuple(kw[n].shape) != shape:
            raise ValueError(f"{what}: {n} must have shape {shape}, got "
                             f"{tuple(kw[n].shape)}")
    if kw["node_rows"].shape[0] > v_pad:
        raise ValueError(f"{what}: node_rows longer than the rows")
    return devs.pop()


def _launch(kw, config, visit: bool):
    n_pad = kw["node_ok"].shape[0]
    v_pad = kw["v_node"].shape[0]
    lanes = kw["p_job"].shape[0]
    tier_masks, flags = _config_ints(**config)
    dev = kw["v_node"].device
    has = 0
    for m in tier_masks:
        has |= m
    t = {n: kw[n].contiguous() for n in kw}
    for n in ("node_ok", "v_critical", "nj_head", "nq_head", "q_prop_ok",
              "v_live", "sig_pred") + (("visited",) if visit else ()):
        t[n] = t[n].view(torch.uint8)
    cluster = CLUSTER
    lib = _build.library("victims.cu")
    slots = _slots(lib, lanes, v_pad, cluster)
    ws_bytes = lib.kb_victims_workspace(v_pad, n_pad, cluster)
    ws = torch.empty(max(1, ws_bytes * slots), dtype=torch.uint8,
                     device=dev)
    phase_ns = torch.empty(len(PHASES), dtype=torch.int64, device=dev)
    tiers_t = torch.tensor(tier_masks or [0], dtype=torch.int32, device=dev)
    eps = torch.as_tensor(VEC_EPS, dtype=torch.float32, device=dev)
    if visit:
        out = torch.empty(4 + v_pad, dtype=torch.int32, device=dev)
    else:
        out = torch.empty((lanes, 2 * n_pad + v_pad), dtype=torch.bool,
                          device=dev)
    ptrs = [t[n].data_ptr() for n in (
        "p_res", "p_resreq", "p_nz", "p_sig", "p_job", "p_queue",
        "sig_scores", "sig_pred", "node_ok", "max_task_num",
        "allocatable_cm", "host_rank", "v_node", "v_job", "v_res",
        "v_critical", "perm_nj", "nj_head", "perm_nq", "nq_head", "min_av",
        "job_queue", "q_deserved", "q_prop_ok", "cluster_total",
        "dyn_weights", "n_tasks", "nz_req", "v_live", "ready_cnt",
        "j_alloc", "q_alloc", "node_rows", "node_off")]
    ptrs += [t["visited"].data_ptr() if visit else 0, tiers_t.data_ptr(),
             eps.data_ptr(), ws.data_ptr(), out.data_ptr(),
             phase_ns.data_ptr()]
    ints = [lanes, n_pad, v_pad, len(tier_masks),
            int(bool(has & TIER_BITS["drf"])),
            int(bool(has & TIER_BITS["proportion"])), *flags, int(visit),
            slots, NT, ws_bytes, cluster]
    name = "victim_visit" if visit else "victim_wave"
    err = lib.kb_victims((ctypes.c_void_p * len(ptrs))(*ptrs),
                         (ctypes.c_int * len(ints))(*ints),
                         torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch(name, err)
    _build.count_launch(name)
    last_launch.clear()
    last_launch.update(kernel=name, lanes=lanes, v_pad=v_pad, n_pad=n_pad,
                       grid=slots * cluster, cluster=cluster, threads=NT,
                       workspace_bytes=ws_bytes * slots, phase_ns=phase_ns)
    return out


def victim_wave(*, tiers, veto_critical: bool, filter_kind: str,
                dyn_enabled: bool, score_nodes: bool, room_check: bool,
                **kw) -> torch.Tensor:
    """The wave analysis on the tensors' device: ``csrc/victims.cu`` for
    CUDA tensors, :func:`wave_plain` for CPU tensors. ``bool[L, 2N+V]``."""
    config = dict(tiers=tiers, veto_critical=veto_critical,
                  filter_kind=filter_kind, dyn_enabled=dyn_enabled,
                  score_nodes=score_nodes, room_check=room_check)
    dev = _check_args(kw, "victim_wave", visit=False)
    if dev == "cpu":
        return wave_plain(**config, **kw)
    if dev != "cuda":
        raise ValueError(f"victim_wave: unsupported device {dev!r}")
    return _launch(kw, config, visit=False)


def victim_visit(*, tiers, veto_critical: bool, filter_kind: str,
                 dyn_enabled: bool, score_nodes: bool, room_check: bool,
                 **kw) -> torch.Tensor:
    """One visit on the tensors' device: ``csrc/victims.cu`` for CUDA
    tensors, :func:`visit_plain` for CPU tensors. ``int32[4 + V]``; the
    lane arrays hold one lane."""
    config = dict(tiers=tiers, veto_critical=veto_critical,
                  filter_kind=filter_kind, dyn_enabled=dyn_enabled,
                  score_nodes=score_nodes, room_check=room_check)
    dev = _check_args(kw, "victim_visit", visit=True)
    if kw["p_job"].shape[0] != 1:
        raise ValueError("victim_visit: the lane arrays must hold one lane")
    if dev == "cpu":
        return visit_plain(**config, **kw)
    if dev != "cuda":
        raise ValueError(f"victim_visit: unsupported device {dev!r}")
    return _launch(kw, config, visit=True)


def node_row_order(v_node: np.ndarray, v_live: np.ndarray, n_pad: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """(node_rows, node_off): the rows live at the start of an action,
    stably sorted by node, and each node's [off, off_next) range in them
    — every node's rows in row order, which is the reference's
    segment-sum order per node. Rows dead at the start stay dead for the
    whole action (evictions only kill rows; a rollback revives only rows
    it killed), so they can never be candidates, victims or guards and
    the kernels skip them."""
    if v_node.size and (v_node.min() < 0 or v_node.max() >= n_pad):
        raise ValueError(f"v_node outside [0, {n_pad})")
    live = np.flatnonzero(v_live)
    node_rows = live[np.argsort(v_node[live], kind="stable")].astype(
        np.int32)
    counts = np.bincount(v_node[live], minlength=n_pad)[:n_pad]
    node_off = np.zeros(n_pad + 1, np.int32)
    np.cumsum(counts, out=node_off[1:])
    return node_rows, node_off


# ---------------------------------------------------------------------
# host-side state
# ---------------------------------------------------------------------

@dataclass
class _Victim:
    task: TaskInfo          # the node's copy (clone at evict time)
    node_idx: int
    job_idx: int


class _NodeSegment:
    """One node's victim-row material: the RUNNING task subset (insertion
    order) with its packed resources/criticality, plus the whole-node
    nonzero-request sum and task count."""
    __slots__ = ("run_tasks", "run_res", "run_crit", "nz", "n_tasks")


def _build_segments(pairs) -> Dict[str, _NodeSegment]:
    """_NodeSegment for every given (name, node): ONE nonzero
    accumulation over every task of the given nodes, sliced back into
    per-node segments (the reference builds nodes one by one below 65 of
    them; the arrays are the same either way)."""
    running = TaskStatus.RUNNING
    flat: List[TaskInfo] = []
    rows: List[int] = []
    per_node: List[int] = []
    for j, (_, node) in enumerate(pairs):
        ts = list(node.tasks.values())
        per_node.append(len(ts))
        flat.extend(ts)
        rows.extend([j] * len(ts))
    nz = accumulate_nz(flat, rows, max(1, len(pairs)))
    n_flat = len(flat)
    res_flat = np.empty((n_flat, RESOURCE_DIM), np.float64)
    for i, t in enumerate(flat):
        rr = t.resreq
        res_flat[i] = (rr.milli_cpu, rr.memory, rr.milli_gpu)
    res32 = (res_flat * VEC_SCALE).astype(np.float32)
    run_mask = np.fromiter((t.status == running for t in flat), bool,
                           count=n_flat)
    run_pos = np.flatnonzero(run_mask)
    run_tasks_flat = [flat[x] for x in run_pos]
    # backfill tenants are lent capacity: never criticality-shielded from
    # eviction (backfill-over-reserved reclaim depends on it)
    crit_flat = np.fromiter(
        (_pod_critical(t.pod) and not t.is_backfill
         for t in run_tasks_flat), bool, count=len(run_tasks_flat))
    res_run = res32[run_pos]
    run_counts = np.bincount(np.asarray(rows, np.int64)[run_pos],
                             minlength=len(pairs))
    bounds = np.cumsum(run_counts)[:-1]
    res_split = np.split(res_run, bounds)
    crit_split = np.split(crit_flat, bounds)
    segs: Dict[str, _NodeSegment] = {}
    base = 0
    for j, (name, _) in enumerate(pairs):
        seg = _NodeSegment()
        k = int(run_counts[j])
        seg.run_tasks = run_tasks_flat[base:base + k]
        seg.run_res = res_split[j]
        seg.run_crit = crit_split[j]
        seg.nz = nz[j]
        seg.n_tasks = per_node[j]
        segs[name] = seg
        base += k
    return segs


class SegmentStore:
    """Cache-owned cross-cycle store of victim-row material, keyed by
    node name; the cache migrates dirty marks into _vic_refresh /
    _vicjob_refresh at snapshot time and folds session-touched entities
    in at adoption, exactly like the DeviceSession discipline (cache.py).
    A snapshot-primary cache gets a throwaway store per build, which is
    the fresh layout.

    Beyond the per-node ``_NodeSegment``s (``nz_mat``/``cnt`` mirror
    their whole-node aggregates in node-column order), the store
    persists the ASSEMBLED index spaces so a steady-state VictimState
    build is O(churn) instead of O(cluster):

    - **row space**: parallel victim arrays (v_node/v_job/v_res/v_crit/
      v_live + the aligned ``row_tasks`` list) where each node owns a
      fixed slot ``[off, off+cap)``, ``cap = k + max(1, k >> 3)``,
      holding its RUNNING tasks in insertion order (dead tail rows have
      live=False, so within-node eviction order matches a fresh build).
      Refreshing a node rewrites only its slot; a slot that outgrows its
      capacity relocates to the tail, and the space compacts when dead
      capacity dominates. Row position across nodes is NOT semantic:
      the kernels order by (node, job) and consume masks per node.
    - **job space**: a grow-only uid -> row assignment with parallel
      ready_cnt/min_av/j_alloc/job_queue arrays refreshed only for dirty
      jobs. Rows of jobs absent from the current session keep their
      assignment (presence is the ``j_present`` mask, folded into the
      session's effective v_live) so validate-dropped jobs can return;
      the space compacts — rows densely reassigned and v_job remapped —
      when the assignment outgrows the live set. Dirty marks for absent
      jobs are carried in ``job_marks_pending`` until the job is seen
      again.

    ref: kubebatch_tpu/kernels/victims.py SegmentStore; every array here
    equals the reference store's word for word on the same events.
    """
    __slots__ = ("segs", "col_names", "nz_mat", "cnt",
                 "slot_of", "row_tasks", "v_node", "v_job", "v_res",
                 "v_crit", "v_live", "rows_used", "dead_cap",
                 "job_rows", "j_present", "ready_cnt",
                 "min_av", "j_alloc", "job_queue", "q_ids",
                 "present_uids", "job_marks_pending", "orphan_uids",
                 "host_rank", "host_rank_epoch")

    def __init__(self):
        self.segs: Dict[str, _NodeSegment] = {}
        self.col_names: Optional[List[str]] = None
        self.nz_mat: Optional[np.ndarray] = None
        self.cnt: Optional[np.ndarray] = None
        # row space
        self.slot_of: Dict[str, tuple] = {}
        self.row_tasks: List[Optional[TaskInfo]] = []
        self.v_node = np.zeros(0, np.int32)
        self.v_job = np.zeros(0, np.int32)
        self.v_res = np.zeros((0, RESOURCE_DIM), np.float32)
        self.v_crit = np.zeros(0, bool)
        self.v_live = np.zeros(0, bool)
        self.rows_used = 0
        self.dead_cap = 0
        # job space
        self.job_rows: Dict[str, int] = {}
        self.host_rank: Optional[np.ndarray] = None
        self.host_rank_epoch = None
        self.j_present: Optional[np.ndarray] = None
        self.ready_cnt: Optional[np.ndarray] = None
        self.min_av: Optional[np.ndarray] = None
        self.j_alloc: Optional[np.ndarray] = None
        self.job_queue: Optional[np.ndarray] = None
        self.q_ids: Optional[List[str]] = None
        self.present_uids: set = set()
        self.job_marks_pending: set = set()
        #: job uids some stored row references as v_job=-1 (no assignment
        #: existed at slot-write time). When such a uid finally gets a
        #: row, its tasks' nodes are forced into the refresh set so the
        #: stale -1 references repair — a job's return to the session
        #: dirties no node by itself.
        self.orphan_uids: set = set()

    def _ensure_row_cap(self, need: int) -> None:
        cap = len(self.v_node)
        if need <= cap:
            return
        new = pad_to_bucket(max(need, cap + (cap >> 1)), 64)
        grow = new - cap
        self.v_node = np.concatenate([self.v_node,
                                      np.zeros(grow, np.int32)])
        self.v_job = np.concatenate([self.v_job,
                                     np.full(grow, -1, np.int32)])
        self.v_res = np.concatenate(
            [self.v_res, np.zeros((grow, RESOURCE_DIM), np.float32)])
        self.v_crit = np.concatenate([self.v_crit, np.zeros(grow, bool)])
        self.v_live = np.concatenate([self.v_live, np.zeros(grow, bool)])
        self.row_tasks.extend([None] * grow)

    def _clear_rows(self) -> None:
        self.slot_of = {}
        self.rows_used = 0
        self.dead_cap = 0
        self.v_live[:] = False
        tasks = self.row_tasks
        for i in range(len(tasks)):
            tasks[i] = None

    def _ensure_job_cap(self, need: int) -> None:
        if self.ready_cnt is None:
            cap = pad_to_bucket(max(1, need), 4)
            self.ready_cnt = np.zeros(cap, np.int32)
            self.min_av = np.zeros(cap, np.int32)
            self.j_alloc = np.zeros((cap, RESOURCE_DIM), np.float32)
            self.job_queue = np.full(cap, -1, np.int32)
            self.j_present = np.zeros(cap, bool)
            return
        cap = len(self.ready_cnt)
        if need <= cap:
            return
        new = pad_to_bucket(max(need, cap * 2), 4)
        grow = new - cap
        self.ready_cnt = np.concatenate([self.ready_cnt,
                                         np.zeros(grow, np.int32)])
        self.min_av = np.concatenate([self.min_av,
                                      np.zeros(grow, np.int32)])
        self.j_alloc = np.concatenate(
            [self.j_alloc, np.zeros((grow, RESOURCE_DIM), np.float32)])
        self.job_queue = np.concatenate([self.job_queue,
                                         np.full(grow, -1, np.int32)])
        self.j_present = np.concatenate([self.j_present,
                                         np.zeros(grow, bool)])


def _segment_store(ssn):
    """(SegmentStore, node-refresh, job-refresh) for this build.
    Incremental caches persist the store with the same consume-at-
    handout / re-adopt-under-epoch-check discipline as the
    DeviceSession: the first build of a session takes the store OFF the
    cache (a mid-session cluster-wide invalidation or a refused adoption
    must not leave a stale store behind), later builds in the same
    session reuse it via the session (refresh = the grown touched sets),
    and cache.adopt_snapshot puts it back if the session's epoch still
    matches. A snapshot-primary cache gets a throwaway store, i.e. a
    plain fresh build."""
    store = ssn._victim_store
    if store is not None:
        return store, set(ssn.touched_nodes), set(ssn.touched_jobs)
    cache = ssn.cache
    if not cache._incremental:
        return SegmentStore(), set(), set()
    with cache._lock:
        store = cache.victim_segments
        cache.victim_segments = None      # consumed; re-adopted at close
        refresh = set(cache._vic_refresh)
        cache._vic_refresh.clear()
        job_refresh = set(cache._vicjob_refresh)
        cache._vicjob_refresh.clear()
    if store is None:
        store = SegmentStore()
    ssn._victim_store = store
    return (store, refresh | ssn.touched_nodes,
            job_refresh | ssn.touched_jobs)


class _VictimRows:
    """Lazy row view over the VictimState's parallel victim arrays —
    indexing materializes a _Victim for just that row. ``tasks`` is the
    slot-aligned list (dead slots hold None); ``live`` is the live-row
    count, which drives truthiness (the SKIP_ACTION check)."""
    __slots__ = ("_state", "tasks", "live")

    def __init__(self, state, tasks, live: int):
        self._state = state
        self.tasks = tasks
        self.live = live

    def __len__(self):
        return self.live

    def __bool__(self):
        return self.live > 0

    def __getitem__(self, row: int) -> _Victim:
        st = self._state
        if not 0 <= row < len(st.v_node):
            raise IndexError(row)
        task = self.tasks[row]
        if task is None:
            raise IndexError(row)
        return _Victim(task, int(st.v_node[row]), int(st.v_job[row]))


class VictimState:
    """Host mirror of the mutable state the visit kernel reads, plus the
    static victim/job/queue index spaces for one preempt/reclaim action.

    The action applies every session mutation (stmt.evict / stmt.pipeline
    / direct ssn.evict+pipeline) through apply_* so the mirrors track the
    host truth; Statement.discard is mirrored by the inverse methods.
    """

    #: bumped by every apply_*; VictimSolver re-uploads the mutable arrays
    #: only when it changed
    version = 0

    def __init__(self, ssn, node_index: Dict[str, int], n_pad: int,
                 node_ok: np.ndarray, max_task_num: np.ndarray,
                 allocatable_cm: np.ndarray):
        self.node_index = node_index
        self.n_pad = n_pad
        # mutable node mirrors + victim-row material, assembled from the
        # cache's persistent SegmentStore: only nodes/jobs the cache
        # dirtied or the session touched recompute from HOST truth, and
        # the assembled row/job index spaces persist too
        store, refresh, job_refresh = _segment_store(ssn)
        segs = store.segs
        nodes_map = ssn.nodes
        if (store.col_names is not None
                and len(store.col_names) == len(nodes_map)
                and all(n in nodes_map for n in store.col_names)):
            # node set unchanged: the store's column order IS the index
            # order
            names = store.col_names
        else:
            ordered = sorted(nodes_map.items(),
                             key=lambda kv: node_index.get(kv[0], 0))
            names = [name for name, _ in ordered if name in node_index]
        rows_reset = False
        if (store.col_names != names or store.nz_mat is None
                or store.nz_mat.shape[0] != n_pad
                or len(segs) < len(names)):
            # node set / order / padding changed: aggregates restart
            store.col_names = names
            store.nz_mat = np.zeros((n_pad, 2), np.float32)
            store.cnt = np.zeros(n_pad, np.int32)
            refresh = set(names)
            rows_reset = True
            # the fast path above relies on column order == node_index
            # order; catch a divergence at reset time
            if any(node_index.get(nm) != i
                   for i, nm in enumerate(names)):
                raise RuntimeError(
                    "segment column order diverged from the node index")
        nz_mat, cnt = store.nz_mat, store.cnt

        # ---- job index space (persistent, grow-only) ------------------
        self.queue_ids = sorted(ssn.queues)
        self.q_index = {q: i for i, q in enumerate(self.queue_ids)}
        jobs_map = ssn.jobs
        job_refresh |= store.job_marks_pending
        update_all = False
        if (store.ready_cnt is None or store.q_ids != self.queue_ids
                or len(store.job_rows) > 2 * len(jobs_map) + 64):
            # fresh store / queue-set change / assignment outgrew the
            # live set: rebuild the job space densely and remap the row
            # arrays' job references (job-row NUMBERS are not semantic —
            # kernels only group by them)
            old_rows = store.job_rows
            old_cap = (len(store.ready_cnt)
                       if store.ready_cnt is not None else 0)
            store.job_rows = {uid: i for i, uid in enumerate(jobs_map)}
            store.ready_cnt = None
            store._ensure_job_cap(len(jobs_map))
            store.q_ids = list(self.queue_ids)
            store.present_uids = set()
            store.job_marks_pending = set()
            if old_cap and len(store.v_job):
                remap = np.full(old_cap + 1, -1, np.int32)
                for uid, r in old_rows.items():
                    nr = store.job_rows.get(uid)
                    if nr is not None:
                        remap[r] = nr
                vj = store.v_job
                safe = np.where((vj >= 0) & (vj < old_cap), vj, old_cap)
                store.v_job = remap[safe]
            # exact orphan recompute: live rows whose job reference is
            # now unknown (dropped assignments) need repair if the job
            # ever returns — this also prunes uids that never will
            vj = store.v_job
            orphan_rows = np.flatnonzero(store.v_live[:len(vj)]
                                         & (vj < 0))
            store.orphan_uids = {
                store.row_tasks[i].job for i in orphan_rows
                if store.row_tasks[i] is not None}
            update_all = True
        job_rows = store.job_rows
        ready = _ready_statuses()
        drf = ssn.plugins.get("drf")
        q_get = self.q_index.get

        repair_nodes: set = set()

        def _update_job(uid, job):
            r = job_rows[uid]
            store.ready_cnt[r] = job.count(*ready)
            store.min_av[r] = job.min_available
            store.job_queue[r] = q_get(job.queue, -1)
            attr = drf.job_opts.get(uid) if drf is not None else None
            if attr is not None:
                store.j_alloc[r] = attr.allocated.to_vec()
            else:
                store.j_alloc[r] = 0.0
            if uid in store.orphan_uids:
                # stored rows reference this job as v_job=-1; refresh its
                # tasks' nodes so the slots repair with the new row
                store.orphan_uids.discard(uid)
                for t in job.tasks.values():
                    if t.node_name:
                        repair_nodes.add(t.node_name)

        cur = set(jobs_map)
        if update_all:
            for uid, job in jobs_map.items():
                store.j_present[job_rows[uid]] = True
                _update_job(uid, job)
            n_jobs_refreshed = len(jobs_map)
        else:
            for uid in store.present_uids - cur:
                store.j_present[job_rows[uid]] = False
            updated = set()
            for uid in cur - store.present_uids:
                # new or returning job; values of a returning row are
                # still valid unless a dirty mark is pending (handled
                # by the job_refresh pass below)
                r = job_rows.get(uid)
                if r is None:
                    r = len(job_rows)
                    store._ensure_job_cap(r + 1)
                    job_rows[uid] = r
                    _update_job(uid, jobs_map[uid])
                    updated.add(uid)
                store.j_present[r] = True
            for uid in job_refresh:
                job = jobs_map.get(uid)
                if job is not None and uid not in updated:
                    if uid not in job_rows:
                        r = len(job_rows)
                        store._ensure_job_cap(r + 1)
                        job_rows[uid] = r
                        store.j_present[r] = True
                    _update_job(uid, job)
                    updated.add(uid)
            # carry marks of stored-but-absent jobs until they return
            store.job_marks_pending = {
                u for u in job_refresh - updated if u in job_rows}
            n_jobs_refreshed = len(updated)
        store.present_uids = cur
        self.j_index = job_rows
        self.cluster_total = (drf.total_resource.to_vec() if drf is not None
                              else np.ones(RESOURCE_DIM, np.float32))

        # ---- segment refresh ------------------------------------------
        refresh |= repair_nodes
        if rows_reset:
            stale_names = names           # already in node-index order
        else:
            stale_names = sorted(
                (n for n in refresh if n in node_index and n in nodes_map),
                key=node_index.get)
        segs.update(_build_segments([(n, nodes_map[n])
                                     for n in stale_names]))
        for name in stale_names:
            seg = segs[name]
            ni = node_index[name]
            nz_mat[ni] = seg.nz
            cnt[ni] = seg.n_tasks
        if len(segs) > len(names):
            live_names = set(names)
            for name in list(segs):
                if name not in live_names:
                    del segs[name]
        #: (nodes, jobs) this build recomputed from host truth
        self.refreshed = (len(stale_names), n_jobs_refreshed)

        # ---- row space: per-node slots, refreshed slots rewritten -----
        if rows_reset or store.dead_cap > max(64, store.rows_used // 3):
            store._clear_rows()
            row_stale = names
        else:
            row_stale = stale_names
        jr_get = job_rows.get
        tasks_l = store.row_tasks
        for name in row_stale:
            seg = segs[name]
            run = seg.run_tasks
            k = len(run)
            slot = store.slot_of.get(name)
            if slot is None or k > slot[1]:
                if slot is not None:
                    off0, cap0 = slot
                    store.v_live[off0:off0 + cap0] = False
                    for i in range(off0, off0 + cap0):
                        tasks_l[i] = None
                    store.dead_cap += cap0
                # +12.5% slack (min 1); a node outgrowing it re-slots
                cap = k + max(1, k >> 3)
                off = store.rows_used
                store._ensure_row_cap(off + cap)
                tasks_l = store.row_tasks
                store.rows_used = off + cap
                store.slot_of[name] = (off, cap)
            else:
                off, cap = slot
            ni = node_index[name]
            store.v_node[off:off + cap] = ni
            store.v_live[off:off + cap] = False
            if k:
                store.v_res[off:off + k] = seg.run_res
                store.v_crit[off:off + k] = seg.run_crit
                vjs = []
                for t in run:
                    jr = jr_get(t.job, -1)
                    if jr < 0:
                        store.orphan_uids.add(t.job)
                    vjs.append(jr)
                store.v_job[off:off + k] = vjs
                store.v_live[off:off + k] = True
                for i, t in enumerate(run):
                    tasks_l[off + i] = t
            for i in range(off + k, off + cap):
                tasks_l[i] = None

        # ---- node mirrors ---------------------------------------------
        self.nz_req = nz_mat.copy()
        self.n_tasks = cnt.copy()
        self.node_ok = node_ok
        self.max_task_num = max_task_num
        self.allocatable_cm = allocatable_cm
        # host visit order (ssn.nodes dict order) — stable while the node
        # set is; persisted on the store, keyed on the node-order epoch
        order_epoch = ssn.node_order_epoch
        if rows_reset or store.host_rank is None \
                or len(store.host_rank) != n_pad \
                or order_epoch is None \
                or store.host_rank_epoch != order_epoch:
            host_rank = np.full(n_pad, np.iinfo(np.int32).max, np.int32)
            for pos, name in enumerate(nodes_map):
                idx = node_index.get(name)
                if idx is not None:
                    host_rank[idx] = pos
            store.host_rank = host_rank
            store.host_rank_epoch = order_epoch
        self.host_rank = store.host_rank

        # ---- queue arrays (small; rebuilt per build) ------------------
        q_pad = pad_to_bucket(max(1, len(self.queue_ids)), 4)
        self.q_alloc = np.zeros((q_pad, RESOURCE_DIM), np.float32)
        self.q_deserved = np.zeros((q_pad, RESOURCE_DIM), np.float32)
        self.q_prop_ok = np.zeros(q_pad, bool)
        prop = ssn.plugins.get("proportion")
        if prop is not None:
            for q, attr in prop.queue_opts.items():
                qi = self.q_index.get(q)
                if qi is not None:
                    self.q_alloc[qi] = attr.allocated.to_vec()
                    self.q_deserved[qi] = attr.deserved.to_vec()
                    self.q_prop_ok[qi] = True

        # ---- session views over the persistent spaces -----------------
        # Rows: read-only aliases of the store's arrays (apply_* mutates
        # only the per-session copies below); within-node insertion order
        # is preserved by the slot discipline, so eviction order matches
        # a fresh build. Effective liveness folds job presence: rows of
        # session-absent jobs are dead this cycle.
        used = store.rows_used
        # pow2 padding doubles the row axis right past each boundary;
        # above 4096 pad to the next 4096 multiple instead
        if used <= 4096:
            v_pad = pad_to_bucket(max(1, used), 8)
        else:
            v_pad = -(-used // 4096) * 4096
        store._ensure_row_cap(v_pad)
        self.rows_used = used
        self.v_node = store.v_node[:v_pad]
        self.v_job = store.v_job[:v_pad]
        self.v_res = store.v_res[:v_pad]
        self.v_critical = store.v_crit[:v_pad]
        vj = self.v_job
        live = store.v_live[:v_pad] & (vj >= 0)
        np.logical_and(live, store.j_present[np.maximum(vj, 0)], out=live)
        self.v_live = live
        #: the rows live at the build: only these can ever be victims in
        #: this action (the kernels' per-node row lists)
        self.v_live0 = live.copy()
        self.victims = _VictimRows(self, store.row_tasks[:v_pad],
                                   int(live.sum()))
        # per-session copies of the arrays apply_* mutates
        self.ready_cnt = store.ready_cnt.copy()
        self.min_av = store.min_av
        self.j_alloc = store.j_alloc.copy()
        self.job_queue = store.job_queue

        # orderings + segment heads (dead rows keep stale keys — they
        # contribute nothing: every kernel term masks on v_live/cand).
        # One combined int64 key + stable argsort per ordering: the same
        # order as a (node, job, row) lexsort
        nj_key = (self.v_node.astype(np.int64) << 32) \
            + self.v_job.astype(np.int64) + (1 << 31)
        self.perm_nj = np.argsort(nj_key, kind="stable").astype(np.int32)
        njs = nj_key[self.perm_nj]
        self.nj_head = np.ones(v_pad, bool)
        self.nj_head[1:] = njs[1:] != njs[:-1]
        vq = np.where(self.v_job >= 0,
                      self.job_queue[np.maximum(self.v_job, 0)], -1)
        nq_key = (self.v_node.astype(np.int64) << 32) \
            + vq.astype(np.int64) + (1 << 31)
        self.perm_nq = np.argsort(nq_key, kind="stable").astype(np.int32)
        nqs = nq_key[self.perm_nq]
        self.nq_head = np.ones(v_pad, bool)
        self.nq_head[1:] = nqs[1:] != nqs[:-1]

        self._row_of: Optional[Dict[str, int]] = None
        #: mutation event log for the wave cache's fine-grained
        #: invalidation (VictimSolver.visit): ("evict", row, node, job),
        #: ("pipeline", node, job, queue), ("rollback",)
        self.events: List[tuple] = []
        self._job_nodes_memo: Dict[int, frozenset] = {}
        self._queue_nodes_memo: Dict[int, frozenset] = {}

    @property
    def row_of(self) -> Dict[str, int]:
        """task.uid -> victim row (host replay bookkeeping), built on
        first use."""
        if self._row_of is None:
            self._row_of = {t.uid: i
                            for i, t in enumerate(self.victims.tasks)
                            if t is not None}
        return self._row_of

    def job_nodes(self, ji: int) -> frozenset:
        """Node columns hosting running tasks of job row ji (victim rows
        are static for the action, so memoized)."""
        got = self._job_nodes_memo.get(ji)
        if got is None:
            got = self._job_nodes_memo[ji] = frozenset(
                int(n) for n in self.v_node[self.v_job == ji])
        return got

    def queue_nodes(self, qi: int) -> frozenset:
        got = self._queue_nodes_memo.get(qi)
        if got is None:
            jq = self.job_queue[np.maximum(self.v_job, 0)]
            sel = (self.v_job >= 0) & (jq == qi)
            got = self._queue_nodes_memo[qi] = frozenset(
                int(n) for n in self.v_node[sel])
        return got

    # ---- mutation mirrors (called alongside session mutations) --------
    def _job_row(self, job_uid: str) -> Optional[int]:
        return self.j_index.get(job_uid)

    def apply_evict(self, row: int) -> None:
        self.version += 1
        self.v_live[row] = False
        res = self.v_res[row]
        ji = int(self.v_job[row])
        if ji >= 0:
            self.ready_cnt[ji] -= 1
            self.j_alloc[ji] -= res
            qi = int(self.job_queue[ji])
            if qi >= 0:
                self.q_alloc[qi] -= res
        # releasing grows; nz/n_tasks unchanged (the task stays on-node)
        self.events.append(("evict", row, int(self.v_node[row]), ji))

    def apply_unevict(self, row: int) -> None:
        self.version += 1
        self.v_live[row] = True
        res = self.v_res[row]
        ji = int(self.v_job[row])
        if ji >= 0:
            self.ready_cnt[ji] += 1
            self.j_alloc[ji] += res
            qi = int(self.job_queue[ji])
            if qi >= 0:
                self.q_alloc[qi] += res
        # rollback resurrects a row — every cached wave lane is suspect
        self.events.append(("rollback",))

    def apply_pipeline(self, task: TaskInfo, node_idx: int) -> None:
        self.version += 1
        res = task.resreq.to_vec()
        nz = nz_request_vec(task.resreq.to_vec())
        self.n_tasks[node_idx] += 1
        self.nz_req[node_idx] += nz
        ji = self._job_row(task.job)
        qi = -1
        if ji is not None:
            self.ready_cnt[ji] += 1
            self.j_alloc[ji] += res
            qi = int(self.job_queue[ji])
            if qi >= 0:
                self.q_alloc[qi] += res
        self.events.append(("pipeline", node_idx,
                            ji if ji is not None else -1, qi))

    def apply_unpipeline(self, task: TaskInfo, node_idx: int) -> None:
        self.version += 1
        res = task.resreq.to_vec()
        nz = nz_request_vec(task.resreq.to_vec())
        self.n_tasks[node_idx] -= 1
        self.nz_req[node_idx] -= nz
        ji = self._job_row(task.job)
        if ji is not None:
            self.ready_cnt[ji] -= 1
            self.j_alloc[ji] -= res
            qi = int(self.job_queue[ji])
            if qi >= 0:
                self.q_alloc[qi] -= res
        self.events.append(("rollback",))


@dataclass
class VisitResult:
    found: bool
    node_idx: int
    node_name: str
    victim_rows: List[int]          # victim rows in candidate order
    victims_count: int
    prop_guard: bool                # proportion skip-guard tripped on node


class VictimSolver:
    """Drives the victim kernels for a sequence of preemptor/reclaimer
    visits. Built per action execution from the session + the sig-term
    encoder (kernels/terms.solver_terms over the action's pending tasks).

    Two dispatch strategies:
    - wave (``wave=True``, the default): ONE :func:`victim_wave` launch
      analyses a whole chunk of pending preemptors; the host consumes
      lanes in the actions' rank order, invalidating cached lanes whose
      inputs later replays touched (see _advance_entry/_choose — the
      rules are conservative, so wave results equal per-visit results
      exactly). Dispatches scale with the number of replay conflicts,
      not with the preemptor count.
    - per-visit (``wave=False``): one :func:`victim_visit` launch per
      node visit.

    ``dispatch_kinds`` counts the launches by kind: ``wave`` (a block of
    pending lanes), ``prefetch`` (an explicit chunk), ``refresh`` (a
    single stale lane) and ``visit``.
    """

    def __init__(self, state: VictimState, terms, names: List[str],
                 tiers: Tuple[Tuple[str, ...], ...], veto_critical: bool,
                 score_nodes: bool, room_check: bool,
                 pending: Sequence[TaskInfo] = (),
                 device: DeviceLike = DEFAULT_DEVICE, wave: bool = True):
        self.state = state
        self.terms = terms
        self.names = names              # node column -> name
        self.tiers = tiers
        self.veto_critical = veto_critical
        self.score_nodes = score_nodes
        self.room_check = room_check
        self.dyn = terms.dynamic if terms is not None else None
        self.device = resolve_device(device)
        self._static_dev: Optional[Dict[str, torch.Tensor]] = None
        self._mut_dev: Optional[Dict[str, torch.Tensor]] = None
        self._mut_version = -1
        self.pending = list(pending)
        self._pos = {t.uid: i for i, t in enumerate(self.pending)}
        self._wave_on = wave
        # one policy on every device (the reference's accelerator
        # branch): waves cover the pending set (bucketed) up to a lane
        # budget, from the first visit
        self._wave_size = min(512, max(
            64, pad_to_bucket(max(1, len(self.pending)), 64)))
        self._wave_cache: Dict[tuple, dict] = {}
        self._prop = any("proportion" in t for t in tiers)
        #: dispatch counter (tests assert the wave property)
        self.dispatches = 0
        self.dispatch_kinds = {"wave": 0, "prefetch": 0, "refresh": 0,
                               "visit": 0}
        #: affinity / host-port node masks and interpod scores
        #: (kernels/affinity.SessionAffinityMasks) over the DeviceSession
        #: ``_aff_device``'s columns, set by build_victim_solver when the session
        #: carries the features; None otherwise
        self.aff_masks = None
        self._aff_device = None

    @property
    def dyn_enabled(self) -> bool:
        return bool(self.dyn is not None and self.dyn.enabled)

    def config(self, filter_kind: str) -> dict:
        """The kernels' static configuration for ``filter_kind``."""
        return dict(tiers=self.tiers, veto_critical=self.veto_critical,
                    filter_kind=filter_kind, dyn_enabled=self.dyn_enabled,
                    score_nodes=self.score_nodes,
                    room_check=self.room_check)

    def host_static_arrays(self):
        """The 18 immutable state arrays in STATIC_ARGS order (the
        reference's ``host_static_arrays``)."""
        st = self.state
        dyn_w = np.asarray(
            [self.dyn.least_requested, self.dyn.balanced_resource]
            if self.dyn_enabled else [0.0, 0.0], np.float32)
        return (st.node_ok, st.max_task_num, st.allocatable_cm,
                st.host_rank, st.v_node, st.v_job, st.v_res, st.v_critical,
                st.perm_nj, st.nj_head, st.perm_nq, st.nq_head, st.min_av,
                st.job_queue, st.q_deserved, st.q_prop_ok,
                st.cluster_total, dyn_w)

    def host_sig_arrays(self):
        """The bucket-padded [S, N] static-term matrices (score, pred),
        the score at float32."""
        score = self.terms.static.score
        pred = self.terms.static.pred
        s_pad = pad_to_bucket(score.shape[0], 4)
        if s_pad != score.shape[0]:
            pad = s_pad - score.shape[0]
            score = np.pad(score, ((0, pad), (0, 0)))
            pred = np.pad(pred, ((0, pad), (0, 0)))
        return score, pred

    def host_mutable_arrays(self):
        """The 6 mutable mirrors in MUTABLE_ARGS order (numpy views)."""
        st = self.state
        return (st.n_tasks, st.nz_req, st.v_live, st.ready_cnt,
                st.j_alloc, st.q_alloc)

    def _tensor(self, name: str, arr) -> torch.Tensor:
        """A copy of ``arr`` on the solver's device (never a view of the
        host mirrors, which the actions go on mutating)."""
        return torch.tensor(np.asarray(arr, dtype=_NP_DTYPES[arg_dtype(name)]),
                            device=self.device)

    def _upload(self) -> Dict[str, torch.Tensor]:
        """Device copies of the state arrays: the immutable set and the
        [S, N] matrices once per action, the mutable mirrors only when a
        mutation bumped the state version."""
        st = self.state
        if self._static_dev is None:
            arrays = dict(zip(STATIC_ARGS, self.host_static_arrays()))
            arrays.update(zip(SIG_ARGS, self.host_sig_arrays()))
            arrays.update(zip(ORDER_ARGS, node_row_order(
                st.v_node, st.v_live0, st.n_pad)))
            self._static_dev = {n: self._tensor(n, a)
                                for n, a in arrays.items()}
        if self._mut_version != st.version:
            self._mut_dev = {n: self._tensor(n, a) for n, a in zip(
                MUTABLE_ARGS, self.host_mutable_arrays())}
            self._mut_version = st.version
        return {**self._static_dev, **self._mut_dev}

    def kernel_args(self, tasks: Sequence[TaskInfo], p_pad: int,
                    visited: Optional[np.ndarray] = None
                    ) -> Dict[str, torch.Tensor]:
        """Every tensor argument of :func:`victim_wave` for ``tasks`` as
        lanes padded to ``p_pad`` (with ``visited``: of
        :func:`victim_visit`, one task), on the solver's device."""
        kw = self._upload()
        kw.update({n: self._tensor(n, a)
                   for n, a in self._lanes(tasks, p_pad).items()})
        if visited is not None:
            kw["visited"] = self._tensor("visited", visited)
        return kw

    def _lanes(self, chunk: Sequence[TaskInfo], p_pad: int):
        st = self.state
        p_res = np.zeros((p_pad, RESOURCE_DIM), np.float32)
        p_resreq = np.zeros((p_pad, RESOURCE_DIM), np.float32)
        p_nz = np.zeros((p_pad, 2), np.float32)
        p_sig = np.zeros(p_pad, np.int32)
        p_job = np.full(p_pad, -1, np.int32)
        p_queue = np.full(p_pad, -1, np.int32)
        sig_of = self.terms.static.sig_of
        for i, t in enumerate(chunk):
            p_res[i] = t.init_resreq.to_vec()
            p_resreq[i] = t.resreq.to_vec()
            p_nz[i] = nz_request_vec(t.resreq.to_vec())
            p_sig[i] = sig_of.get(t.uid, 0)
            ji = st.j_index.get(t.job, -1)
            p_job[i] = ji
            p_queue[i] = int(st.job_queue[ji]) if ji >= 0 else -1
        return dict(zip(LANE_ARGS, (p_res, p_resreq, p_nz, p_sig, p_job,
                                    p_queue)))

    # ------------------------------------------------------------------
    # wave dispatch: analyses for a chunk of preemptors in ONE kernel
    # call; node choice + staleness handling happen host-side per visit
    # ------------------------------------------------------------------
    def visit(self, task: TaskInfo, filter_kind: str,
              visited: np.ndarray) -> VisitResult:
        if self.aff_masks is not None:
            # fold the exact affinity / port node mask into the visited
            # set: the analysis stays affinity-blind, the CHOICE skips the
            # nodes the host predicate would reject (reference
            # victims.py:1409-1416)
            mask = self.aff_masks.node_mask(task, self._aff_device)
            if mask is not None:
                visited = visited | ~mask
        key = (filter_kind, task.uid)
        if self._wave_on and key in self._wave_cache:
            return self._choose(key, task, filter_kind, visited)
        if not self._wave_on or task.uid not in self._pos:
            self.dispatches += 1
            return self._visit_single(task, filter_kind, visited)
        self._dispatch_wave(filter_kind, task)
        return self._choose(key, task, filter_kind, visited)

    def prefetch(self, tasks: Sequence[TaskInfo], filter_kind: str) -> None:
        """One wave over an explicitly KNOWN upcoming visit set (the
        actions' first-iteration queue/job tops): a steady cycle's
        handful of visits then resolves from ONE kernel dispatch. Lanes
        land in the same event-folded cache the block waves use."""
        if not self._wave_on:
            return
        chunk = [t for t in tasks
                 if t.uid in self._pos
                 and (filter_kind, t.uid) not in self._wave_cache]
        if chunk:
            self._dispatch_wave(filter_kind, chunk[0], chunk=chunk)

    def _dyn_scores(self, p_nz: np.ndarray) -> np.ndarray:
        """Fresh dynamic scores over ALL node columns against the CURRENT
        mirrors — the kernels' float32 arithmetic in numpy, so the host
        chooser orders nodes exactly as the in-kernel choice would."""
        st = self.state
        w = self.dyn
        weights = np.asarray([w.least_requested, w.balanced_resource],
                             np.float32)
        return dynamic_node_score_np(
            st.nz_req.astype(np.float32), p_nz.astype(np.float32),
            st.allocatable_cm.astype(np.float32), weights)

    def _advance_entry(self, entry: dict) -> bool:
        """Fold the mutation events since the entry's wave into its
        per-node dirty sets. False = the entry as a whole is stale (its
        preemptor's own job was touched, or a rollback happened) and must
        be refreshed. Every rule is conservative: evictions/pipelines
        only SHRINK a node's analysis unless the touched job/queue has
        running tasks there (the grow sets)."""
        st = self.state
        events = st.events
        pos = entry["log_pos"]
        if pos == len(events):
            return True
        p_job = entry["p_job"]
        shrink: set = entry["shrink"]
        grow: set = entry["grow"]
        for e in events[pos:]:
            kind = e[0]
            if kind == "rollback":
                return False
            if kind == "evict":
                _, row, enode, ejob = e
                if ejob == p_job:
                    return False     # preemptor's own drf share moved
                shrink.add(enode)
                if ejob >= 0:
                    shrink |= st.job_nodes(ejob)
                    if self._prop:
                        # lowering q_alloc can newly TRIP the proportion
                        # skip-guard (before < v_res), which makes a node
                        # pickable — a GROW effect, not just shrink
                        q = int(st.job_queue[ejob])
                        if q >= 0:
                            grow |= st.queue_nodes(q)
            else:  # pipeline
                _, pnode, pjob, pqueue = e
                if pjob == p_job:
                    return False
                shrink.add(pnode)    # load/room changed (scores re-done
                                     # fresh by the chooser anyway)
                if pjob >= 0:
                    grow |= st.job_nodes(pjob)
                if self._prop and pqueue >= 0:
                    grow |= st.queue_nodes(pqueue)
        entry["log_pos"] = len(events)
        return True

    def _choose(self, key: tuple, task: TaskInfo, filter_kind: str,
                visited: np.ndarray) -> VisitResult:
        """Pick the entry's best usable node in FRESH score order: clean
        pickable nodes are consumed straight from the cached analysis;
        hitting a grow-dirty (possibly newly pickable) or a dirty
        pickable node first forces a single-lane refresh."""
        st = self.state
        for _ in range(2):
            entry = self._wave_cache[key]
            ok = self._advance_entry(entry)
            if ok:
                if self.score_nodes:
                    score = entry["static_score"].astype(np.float32)
                    if self.dyn_enabled:
                        score = score + self._dyn_scores(entry["p_nz"])
                    if self.aff_masks is not None \
                            and self.aff_masks.with_scores:
                        # nodeorder's interpod term from the current
                        # assignments (reference victims.py:1518-1525)
                        ip = self.aff_masks.score_norm(task,
                                                       self._aff_device)
                        if ip is not None:
                            score = score + ip
                    order_rank = np.lexsort((st.host_rank, -score))
                else:
                    order_rank = np.lexsort((st.host_rank,))
                rank = np.empty(st.n_pad, np.int64)
                rank[order_rank] = np.arange(st.n_pad)
                live = ~visited
                pick = entry["pick"] & live
                shrink = entry["shrink"]
                grow = entry["grow"]
                inf = st.n_pad + 1

                def first(mask):
                    sel = rank[mask]
                    return int(sel.min()) if sel.size else inf

                dirty_mask = np.zeros(st.n_pad, bool)
                if shrink:
                    dirty_mask[list(shrink)] = True
                grow_mask = np.zeros(st.n_pad, bool)
                if grow:
                    grow_mask[list(grow)] = True
                f_clean = first(pick & ~dirty_mask & ~grow_mask)
                f_suspect = min(first(pick & dirty_mask),
                                first(grow_mask & live))
                if f_clean <= f_suspect:
                    if f_clean >= inf:
                        return VisitResult(False, 0, "", [], 0, False)
                    col = int(order_rank[f_clean])
                    vic = entry["victims"] & (st.v_node == col)
                    rows = np.nonzero(vic)[0].tolist()
                    return VisitResult(
                        found=True, node_idx=col,
                        node_name=self.names[col], victim_rows=rows,
                        victims_count=len(rows),
                        prop_guard=bool(entry["guard"][col]))
            # stale where it matters: refresh this lane alone
            self._dispatch_wave(filter_kind, task, single=True)
        raise AssertionError(
            "victim wave refresh did not converge")  # pragma: no cover

    def _dispatch_wave(self, filter_kind: str, anchor: TaskInfo,
                       single: bool = False, chunk=None) -> None:
        st = self.state
        if single:
            chunk = [anchor]
            p_bucket = 1
            kind = "refresh"
        elif chunk is None:
            # BLOCK-aligned chunks: consumption order (the actions'
            # fairness heaps) jumps around the pending list, so pos-based
            # slices would re-wave on nearly every visit; fixed blocks
            # keep any consumption order within ceil(len/W) waves
            block = self._pos[anchor.uid] // self._wave_size
            start = block * self._wave_size
            chunk = self.pending[start:start + self._wave_size]
            p_bucket = 8
            kind = "wave"
        else:
            # explicit prefetch chunk: pad to the next pow2 of the REAL
            # lane count (1/2/4/...)
            p_bucket = 1
            kind = "prefetch"
        p = len(chunk)
        p_pad = pad_to_bucket(p, p_bucket)
        lanes = self._lanes(chunk, p_pad)
        kw = self._upload()
        kw.update({n: self._tensor(n, a) for n, a in lanes.items()})
        self.dispatches += 1
        self.dispatch_kinds[kind] += 1
        from .. import obs
        with obs.span("victim_wave", cat="kernel") as sp:
            out = victim_wave(**kw, **self.config(filter_kind))
            with obs.span("readback", cat="readback"):
                packed = to_host(out)
            n_pad = st.n_pad
            pick = packed[:, :n_pad]
            guard = packed[:, n_pad:2 * n_pad]
            victims = packed[:, 2 * n_pad:]
            frame = host_frame(
                ENGINE_VICTIM_WAVE, waves=1, pending=p,
                census=int(pick[:p].any(axis=1).sum()),
                bound=int(victims[:p].any(axis=1).sum()))
            victim_frames.append(frame)
            obs.telemetry.record(frame, span=sp)
        log_pos = len(st.events)
        for i, t in enumerate(chunk):
            self._wave_cache[(filter_kind, t.uid)] = {
                "pick": pick[i], "guard": guard[i], "victims": victims[i],
                "log_pos": log_pos,
                "p_job": int(lanes["p_job"][i]),
                "p_queue": int(lanes["p_queue"][i]),
                "p_nz": lanes["p_nz"][i],
                "static_score": self.terms.static.score[
                    lanes["p_sig"][i]],
                "shrink": set(), "grow": set()}

    def _visit_single(self, task: TaskInfo, filter_kind: str,
                      visited: np.ndarray) -> VisitResult:
        kw = self.kernel_args([task], 1, visited=visited)
        self.dispatch_kinds["visit"] += 1
        from .. import obs
        with obs.span("victim_visit", cat="kernel") as sp:
            out = victim_visit(**kw, **self.config(filter_kind))
            with obs.span("readback", cat="readback"):
                packed = to_host(out)
            frame = host_frame(
                ENGINE_VICTIM_VISIT, waves=1, pending=1,
                bound=int(bool(packed[0])), census=int(packed[2]))
            victim_frames.append(frame)
            obs.telemetry.record(frame, span=sp)
        found, node, vcount, guard = (bool(packed[0]), int(packed[1]),
                                      int(packed[2]), bool(packed[3]))
        rows = np.nonzero(packed[4:])[0].tolist() if found else []
        return VisitResult(
            found=found, node_idx=node,
            node_name=self.names[node] if found else "",
            victim_rows=rows, victims_count=vcount, prop_guard=guard)


#: build_action_solver sentinel: the action can observably do nothing
#: (no RUNNING task exists anywhere) — skip its loops entirely
SKIP_ACTION = object()

#: tier plugins the analysis expresses
KNOWN_TIER_PLUGINS = frozenset(TIER_BITS)


def build_action_solver(ssn, fns_attr: str, disabled_attr: str,
                        score_nodes: bool, pending=None):
    """The entry the preempt/reclaim actions share: collects the
    session's pending tasks and builds the kernel solver on the cache's
    device. Returns SKIP_ACTION when no victim can exist (no RUNNING task
    in any job, or none materialized as a victim row), None when nothing
    is pending (the host loops then have nothing to do), or the solver.

    Inter-pod affinity and host ports ride the analysis through exact
    host-side node masks (kernels/affinity.SessionAffinityMasks). A
    snapshot outside the analysis's vocabulary (an unknown tier plugin, a
    volume binder, an affinity vocabulary past the masks' raw window —
    counted in metrics.affinity_host_fallback_total, as the reference
    counts it — or no device terms) returns None on any cache, and the
    action runs its host loops: the reference has no device route there
    either (its build_action_solver returns None), and counts no engine
    demotion."""
    if not any(TaskStatus.RUNNING in j.task_status_index
               for j in ssn.jobs.values()):
        return SKIP_ACTION
    if pending is None:
        pending = [t for job in ssn.jobs.values()
                   for t in job.task_status_index.get(TaskStatus.PENDING,
                                                      {}).values()]
    if not pending:
        return None
    solver, _ = _build_victim_solver(ssn, pending, fns_attr, disabled_attr,
                                     score_nodes)
    if solver is None:
        return None
    if not solver.state.victims:
        # running tasks exist but none materialized as victim rows
        return SKIP_ACTION
    return solver


def build_victim_solver(ssn, pending: Sequence[TaskInfo], fns_attr: str,
                        disabled_attr: str, score_nodes: bool
                        ) -> Optional[VictimSolver]:
    """The VictimSolver for an action on the cache's device, or None when
    the snapshot/plugin configuration falls outside the kernel
    vocabulary. ``fns_attr``: "preemptable_fns" or "reclaimable_fns";
    ``disabled_attr`` the matching per-plugin disable flag name."""
    return _build_victim_solver(ssn, pending, fns_attr, disabled_attr,
                                score_nodes)[0]


def _build_victim_solver(ssn, pending, fns_attr, disabled_attr,
                         score_nodes):
    """(solver, None), or (None, why the snapshot is outside the
    vocabulary)."""
    from .affinity import SessionAffinityMasks
    from .encode import dynamic_features
    from .solver import ensure_device_snapshot
    from .terms import _active, device_supported, solver_terms

    fns = getattr(ssn, fns_attr)
    tiers: List[Tuple[str, ...]] = []
    for tier in ssn.tiers:
        members = tuple(
            opt.name for opt in tier.plugins
            if not getattr(opt, disabled_attr) and opt.name in fns)
        if members:
            unknown = [m for m in members if m not in KNOWN_TIER_PLUGINS]
            if unknown:
                return None, f"tier plugins {unknown}"
            tiers.append(members)
    unknown = [n for n in ssn.victim_veto_fns if n not in KNOWN_TIER_PLUGINS]
    if unknown:
        return None, f"victim veto plugins {unknown}"
    # affinity / host ports gate only the PREEMPTOR's node choice (no
    # tier fn reads them): the analysis stays valid with an exact
    # host-side node mask and interpod score at choice time (reference
    # victims.py:1770-1830)
    if not device_supported(ssn, pending, allow_affinity=True):
        return None, ("a volume binder or predicate/node-order plugins "
                      "outside the device terms")
    pred_active = bool(_active(ssn, ssn.predicate_fns, "predicate_disabled"))
    order_active = bool(_active(ssn, ssn.node_order_fns,
                                "node_order_disabled"))
    aff_masks = None
    aff_scored = False
    if (pred_active or order_active) \
            and dynamic_features(ssn, pending) is not None:
        # the actions build wave solvers, whose host-side chooser
        # reproduces the interpod score exactly
        aff_scored = bool(score_nodes and order_active)
        if pred_active or aff_scored:
            # with_predicates gates the mask half: a disabled predicates
            # plugin must not have affinity / ports enforced
            aff_masks = SessionAffinityMasks(
                ssn, pending, with_scores=aff_scored,
                with_predicates=pred_active)
            if not aff_masks.supported:
                return None, ("an affinity / host-port vocabulary past "
                              "the victim masks' raw window")
    device = ensure_device_snapshot(ssn)
    terms = solver_terms(ssn, device, pending, assume_supported=True)
    if terms is None:
        return None, "no device terms for the session's plugins"
    ns = device.state
    state = VictimState(
        ssn, node_index=ns.index, n_pad=ns.n_padded,
        node_ok=ns.schedulable & ns.valid,
        max_task_num=ns.max_task_num,
        allocatable_cm=ns.allocatable[:, :2])
    solver = VictimSolver(
        state, terms, names=ns.names, tiers=tuple(tiers),
        veto_critical="conformance" in ssn.victim_veto_fns,
        score_nodes=score_nodes, room_check=pred_active, pending=pending,
        device=getattr(ssn.cache, "device", DEFAULT_DEVICE))
    if aff_masks is not None:
        solver.aff_masks = aff_masks
        solver._aff_device = device
        if aff_scored:
            # every node choice flows through the wave chooser, where the
            # interpod term is reproduced
            solver._wave_on = True
    return solver, None
