"""The solver's solve half: a decoded SnapshotRequest in, decisions out
(ref: kubebatch_tpu/rpc/server.py).

The engine is chosen by snapshot size exactly as the in-process auto mode
chooses it (actions/allocate.py): a snapshot at or above
AUTO_BATCHED_MIN pending tasks, or one carrying an affinity payload,
runs the round engine (kernels/batched.py, ``csrc/batched_allocate.cu``
on the card); a smaller one the bind-for-bind fused engine
(kernels/fused.py, ``csrc/fused_allocate.cu``).

The decode is split out (:func:`decode_snapshot`) so the single solve
path and the tenant service's mega dispatcher (tenantsvc/megasolve.py)
consume the same arrays, and the fused branch exposes its exact (args,
statics) through :func:`fused_lane_args`: the coalescing key derives
from it, so it cannot drift from a live dispatch.

Every solve runs on ``device`` (the card unless the caller passes
``"cpu"``) and makes one counted device->host copy (``device.to_host``).
The reference's single fused path copies its host block back without
counting it; the port counts every solve's copy, as its device rule asks.

Not here yet: the grpc server (``make_server``, the Solve and victim
handlers with their ``kb-*`` metadata, ``serve``) — the transport,
ROADMAP A8. grpc is absent on the machine with the card.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device, to_host
from ..kernels.fused import (ALLOC, ALLOC_OB, K_DRF_SHARE, K_GANG_READY,
                             K_PRIORITY, K_PROP_SHARE, PIPELINE, SKIP,
                             fused_allocate, unpack_host_block)
from ..kernels.tensorize import pad_to_bucket
from .wire import Decision, DecisionsResponse, SnapshotRequest, from_tensor

__all__ = ["WireSolve", "decode_snapshot", "fused_lane_args",
           "fused_response", "solve_snapshot"]


def _mat(values, n, r=3) -> np.ndarray:
    out = np.zeros((n, r), np.float32)
    flat = np.asarray(values, np.float32)
    out.flat[:flat.size] = flat
    return out


@dataclass
class WireSolve:
    """One decoded SnapshotRequest: every padded array the engines read,
    plus the derived static flags. Built once per request (the tenant
    dispatcher decodes before grouping; the solve paths reuse it)."""

    n: int
    t: int
    j: int
    q: int
    n_pad: int
    t_pad: int
    j_pad: int
    q_pad: int
    idle: np.ndarray
    releasing: np.ndarray
    backfilled: np.ndarray
    mtn: np.ndarray
    ntasks: np.ndarray
    node_ok: np.ndarray
    resreq: np.ndarray
    init_resreq: np.ndarray
    task_job: np.ndarray
    task_rank: np.ndarray
    task_valid: np.ndarray
    min_av: np.ndarray
    order_min_av: np.ndarray
    init_ready: np.ndarray
    job_queue: np.ndarray
    job_priority: np.ndarray
    job_create_rank: np.ndarray
    job_valid: np.ndarray
    q_weight: np.ndarray
    q_entries: np.ndarray
    q_create_rank: np.ndarray
    q_deserved: np.ndarray
    q_alloc0: np.ndarray
    cluster_total: np.ndarray
    sig_scores: np.ndarray
    sig_pred: np.ndarray
    task_sig: np.ndarray
    dyn_weights: np.ndarray
    dyn_enabled: bool
    task_nz: np.ndarray
    allocatable_cm: np.ndarray
    nz_req0: np.ndarray
    j_alloc0: np.ndarray
    job_keys: tuple
    queue_keys: tuple
    affinity: object = None
    use_batched: bool = False
    max_iters: int = 0
    pipe_enabled: bool = False
    _extra: dict = field(default_factory=dict)


def decode_snapshot(req: SnapshotRequest) -> WireSolve:
    """Pad the request's arrays to the engines' buckets (numpy)."""
    nodes, tasks, jobs, queues = req.nodes, req.tasks, req.jobs, req.queues
    n = len(nodes.names)
    t = len(tasks.uids)
    j = len(jobs.uids)
    q = max(1, len(queues.names))
    n_pad = pad_to_bucket(n)
    t_pad = pad_to_bucket(t)
    j_pad = pad_to_bucket(j, 4)
    q_pad = pad_to_bucket(q, 4)

    idle = np.zeros((n_pad, 3), np.float32)
    idle[:n] = _mat(nodes.idle, n)
    releasing = np.zeros((n_pad, 3), np.float32)
    releasing[:n] = _mat(nodes.releasing, n)
    backfilled = np.zeros((n_pad, 3), np.float32)
    backfilled[:n] = _mat(nodes.backfilled, n)
    mtn = np.zeros(n_pad, np.int32)
    mtn[:n] = nodes.max_task_num
    ntasks = np.zeros(n_pad, np.int32)
    ntasks[:n] = nodes.n_tasks
    node_ok = np.zeros(n_pad, bool)
    node_ok[:n] = nodes.schedulable

    resreq = np.zeros((t_pad, 3), np.float32)
    resreq[:t] = _mat(tasks.resreq, t)
    init_resreq = np.zeros((t_pad, 3), np.float32)
    init_resreq[:t] = _mat(tasks.init_resreq, t)
    task_job = np.full(t_pad, -1, np.int32)
    task_job[:t] = tasks.job_index
    task_rank = np.zeros(t_pad, np.int32)
    task_rank[:t] = tasks.rank
    task_valid = np.zeros(t_pad, bool)
    task_valid[:t] = True

    min_av = np.zeros(j_pad, np.int32)
    min_av[:j] = jobs.min_available if req.gang_enabled else 0
    order_min_av = np.zeros(j_pad, np.int32)
    order_min_av[:j] = jobs.min_available
    init_ready = np.zeros(j_pad, np.int32)
    init_ready[:j] = jobs.init_ready
    job_queue = np.zeros(j_pad, np.int32)
    job_queue[:j] = jobs.queue_index
    job_priority = np.zeros(j_pad, np.float32)
    job_priority[:j] = jobs.priority
    job_create_rank = np.zeros(j_pad, np.int32)
    job_create_rank[:j] = jobs.create_rank
    job_valid = np.zeros(j_pad, bool)
    job_valid[:j] = True

    q_weight = np.zeros(q_pad, np.float32)
    q_weight[:len(queues.weight)] = queues.weight
    q_entries = np.zeros(q_pad, np.int32)
    np.add.at(q_entries, np.asarray(jobs.queue_index[:j], np.int64), 1)
    q_create_rank = np.arange(q_pad, dtype=np.int32)
    q_deserved = np.zeros((q_pad, 3), np.float32)
    if len(queues.deserved):
        q_deserved[:len(queues.names)] = _mat(queues.deserved,
                                              len(queues.names))
    q_alloc0 = np.zeros((q_pad, 3), np.float32)
    if len(queues.allocated):
        q_alloc0[:len(queues.names)] = _mat(queues.allocated,
                                            len(queues.names))

    cluster_total = np.ones(3, np.float32)
    if len(req.cluster_total):
        cluster_total = np.asarray(req.cluster_total, np.float32)

    if req.job_order_keys:
        job_keys = [k for k in req.job_order_keys
                    if k in (K_PRIORITY, K_GANG_READY, K_DRF_SHARE)]
    else:
        job_keys = []
        if req.priority_enabled:
            job_keys.append(K_PRIORITY)
        if req.gang_enabled:
            job_keys.append(K_GANG_READY)
        if req.drf_enabled:
            job_keys.append(K_DRF_SHARE)
    queue_keys = (K_PROP_SHARE,) if req.proportion_enabled else ()

    # policy terms: sig-indexed predicate/score matrices + the dynamic
    # nodeorder config; absent fields give the trivial space (all nodes
    # allowed, zero scores, dynamics off)
    terms = req.terms
    n_sigs = max(1, terms.n_sigs)
    s_pad = pad_to_bucket(n_sigs, 4)
    sig_scores = np.zeros((s_pad, n_pad), np.float32)
    sig_pred = np.zeros((s_pad, n_pad), bool)
    if terms.n_sigs and len(terms.sig_pred):
        sig_pred[:n_sigs, :n] = np.asarray(
            terms.sig_pred, bool).reshape(n_sigs, n)
        sig_scores[:n_sigs, :n] = np.asarray(
            terms.sig_scores, np.float32).reshape(n_sigs, n)
    else:
        sig_pred[:1, :n] = True
    task_sig = np.zeros(t_pad, np.int32)
    if len(terms.task_sig):
        task_sig[:t] = terms.task_sig

    dyn_weights = np.asarray([terms.least_requested_weight,
                              terms.balanced_resource_weight], np.float32)
    dyn_enabled = bool(dyn_weights.any())
    # task_nz travels regardless of the dynamic flags: the batched
    # engine's waterfall cohorts are (sig, nonzero-request) pairs
    task_nz = np.zeros((t_pad, 2), np.float32)
    allocatable_cm = np.zeros((n_pad, 2), np.float32)
    nz_req0 = np.zeros((n_pad, 2), np.float32)
    if len(terms.task_nz):
        task_nz[:t] = np.asarray(terms.task_nz, np.float32).reshape(t, 2)
    if len(terms.node_nz):
        nz_req0[:n] = np.asarray(terms.node_nz, np.float32).reshape(n, 2)
    if len(terms.allocatable_cm):
        allocatable_cm[:n] = np.asarray(
            terms.allocatable_cm, np.float32).reshape(n, 2)

    j_alloc0 = np.zeros((j_pad, 3), np.float32)
    if len(jobs.allocated):
        j_alloc0[:j] = _mat(jobs.allocated, j)

    affinity = None
    if len(req.affinity):
        affinity = _affinity_from_wire(req, n_pad, t_pad)

    # engine selection by snapshot size (the in-process auto rule);
    # affinity snapshots always take the round engine, which alone
    # carries the vocabulary
    from ..actions.allocate import AUTO_BATCHED_MIN
    use_batched = t >= AUTO_BATCHED_MIN or affinity is not None
    # strictly positive, as cycle_inputs derives it: negative releasing
    # rows (pipelined reuse) do not enable the pipeline path
    pipe_enabled = bool((releasing[:n] > 0).any())

    return WireSolve(
        n=n, t=t, j=j, q=q, n_pad=n_pad, t_pad=t_pad, j_pad=j_pad,
        q_pad=q_pad, idle=idle, releasing=releasing, backfilled=backfilled,
        mtn=mtn, ntasks=ntasks, node_ok=node_ok, resreq=resreq,
        init_resreq=init_resreq, task_job=task_job, task_rank=task_rank,
        task_valid=task_valid, min_av=min_av, order_min_av=order_min_av,
        init_ready=init_ready, job_queue=job_queue,
        job_priority=job_priority, job_create_rank=job_create_rank,
        job_valid=job_valid, q_weight=q_weight, q_entries=q_entries,
        q_create_rank=q_create_rank, q_deserved=q_deserved,
        q_alloc0=q_alloc0, cluster_total=cluster_total,
        sig_scores=sig_scores, sig_pred=sig_pred, task_sig=task_sig,
        dyn_weights=dyn_weights, dyn_enabled=dyn_enabled, task_nz=task_nz,
        allocatable_cm=allocatable_cm, nz_req0=nz_req0, j_alloc0=j_alloc0,
        job_keys=tuple(job_keys), queue_keys=queue_keys,
        affinity=affinity, use_batched=use_batched,
        max_iters=int(t_pad + 3 * j_pad + q_pad + 8),
        pipe_enabled=pipe_enabled)


def fused_lane_args(req: SnapshotRequest, w: Optional[WireSolve] = None):
    """The fused branch's exact (positional args, statics) in
    kernels/fused.fused_allocate order, as numpy — or None when the
    snapshot takes the batched engine (mega never coalesces those)."""
    if w is None:
        w = decode_snapshot(req)
    if w.use_batched:
        return None
    args = (w.idle, w.releasing, w.backfilled, w.allocatable_cm,
            w.nz_req0, w.mtn, w.ntasks, w.node_ok,
            w.resreq, w.init_resreq, w.task_nz, w.task_job, w.task_rank,
            w.task_sig, w.task_valid, w.sig_scores, w.sig_pred,
            w.min_av, w.order_min_av, w.init_ready, w.job_queue,
            w.job_priority, w.job_create_rank, w.job_valid,
            w.q_weight, w.q_entries, w.q_create_rank, w.q_deserved,
            w.q_alloc0, w.j_alloc0, w.cluster_total, w.dyn_weights)
    statics = dict(job_keys=w.job_keys, queue_keys=w.queue_keys,
                   gang_enabled=bool(req.gang_enabled),
                   prop_overused=bool(req.proportion_enabled),
                   dyn_enabled=w.dyn_enabled, max_iters=w.max_iters)
    return args, statics


def fused_response(req, w: WireSolve, host_block: np.ndarray,
                   solve_ms: float, tenant: Optional[str] = None
                   ) -> DecisionsResponse:
    """Decode one fused/mega host block into the wire response; its
    telemetry frame goes to the open span and the tenant's store."""
    task_state, task_node, task_seq, iters, telem = \
        unpack_host_block(host_block)
    obs.telemetry.record(telem, tenant=tenant)
    return _decisions(req, w, task_state, task_node, task_seq,
                      int(iters), solve_ms)


def _decisions(req, w: WireSolve, task_state, task_node, task_seq,
               iterations: int, solve_ms: float) -> DecisionsResponse:
    resp = DecisionsResponse(solve_ms=solve_ms, iterations=iterations)
    names, uids = req.nodes.names, req.tasks.uids
    for i in range(w.t):
        kind = int(task_state[i])
        resp.decisions.append(Decision(
            task_uid=uids[i], kind=kind,
            node_name=(names[int(task_node[i])]
                       if kind in (ALLOC, ALLOC_OB, PIPELINE) else ""),
            order=int(task_seq[i]) if kind != SKIP else -1))
    return resp


def solve_snapshot(req: SnapshotRequest, w: Optional[WireSolve] = None,
                   tenant: Optional[str] = None,
                   device: DeviceLike = DEFAULT_DEVICE) -> DecisionsResponse:
    """One request's solve on ``device``: the fused engine, or the round
    engine for a batched-sized or affinity snapshot."""
    dev = resolve_device(device)
    if w is None:
        w = decode_snapshot(req)
    if w.use_batched:
        return _solve_batched_wire(req, w, dev)
    args, statics = fused_lane_args(req, w)
    # the decode builds each array with the dtype fused_allocate takes
    tensors = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in args)
    # cat="host": the solve wall the wire reports as solve_ms
    with obs.span("solve_fused", cat="host", engine="fused") as sp:
        host_block = fused_allocate(*tensors, **statics)[0]
    solve_ms = sp.dur * 1e3
    with obs.span("readback", cat="readback"):
        host_block = to_host(host_block)      # the one counted copy
    return fused_response(req, w, host_block, solve_ms, tenant=tenant)


def _affinity_from_wire(req, n_pad: int, t_pad: int):
    """Rebuild kernels/affinity.AffinityInputs from the wire tensors,
    padding the node/task axes to the decode's buckets. Field order is
    kernels/affinity.WIRE_FIELDS, the encoder's."""
    from ..kernels.affinity import WIRE_FIELDS, AffinityInputs

    if len(req.affinity) != len(WIRE_FIELDS):
        raise ValueError(
            f"affinity payload carries {len(req.affinity)} tensors, "
            f"expected {len(WIRE_FIELDS)}")
    by_name = dict(zip(WIRE_FIELDS, (from_tensor(x)
                                     for x in req.affinity)))

    def pad_rows(a, rows, fill=0):
        if a.shape[0] == rows:
            return a
        out = np.full((rows,) + a.shape[1:], fill, a.dtype)
        out[:a.shape[0]] = a
        return out

    def pad_cols(a, cols, fill=0):
        if a.shape[1] == cols:
            return a
        out = np.full((a.shape[0], cols), fill, a.dtype)
        out[:, :a.shape[1]] = a
        return out

    b = by_name
    # the domain-count axis D matches the padded node axis (the encoder
    # sets D = n_pad)
    return AffinityInputs(
        node_dom=pad_cols(b["node_dom"], n_pad, fill=-1),
        task_grp=pad_rows(b["task_grp"], t_pad),
        task_req_aff=pad_rows(b["task_req_aff"], t_pad),
        task_req_anti=pad_rows(b["task_req_anti"], t_pad),
        task_self_ok=pad_rows(b["task_self_ok"], t_pad),
        task_carry_w=pad_rows(b["task_carry_w"], t_pad),
        task_pref_w=pad_rows(b["task_pref_w"], t_pad),
        task_ports=pad_rows(b["task_ports"], t_pad),
        port_base=pad_rows(b["port_base"], n_pad),
        grp_cnt0=pad_cols(b["grp_cnt0"], n_pad),
        anti_cnt0=pad_cols(b["anti_cnt0"], n_pad),
        pref_w0=pad_cols(b["pref_w0"], n_pad),
        grp_total0=b["grp_total0"].astype(np.float32),
        ip_weight=float(req.affinity_ip_weight),
        ip_enabled=bool(req.affinity_ip_enabled))


class _WireDevice:
    """DeviceSession stand-in for a wire solve: the node arrays
    solve_batched reads and commits, on ``device`` (no cross-request
    reuse: every request carries its own snapshot)."""

    def __init__(self, device: torch.device, idle, releasing, backfilled,
                 allocatable_cm, nz_req, n_tasks, max_task_num, node_ok):
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        self.device = device
        self.idle = up(idle)
        self.releasing = up(releasing)
        self.backfilled = up(backfilled)
        self.allocatable_cm = up(allocatable_cm)
        self.nz_req = up(nz_req)
        self.n_tasks = up(n_tasks)
        self.max_task_num = up(max_task_num)
        self.node_ok = up(node_ok)


def _solve_batched_wire(req, w: WireSolve,
                        device: torch.device) -> DecisionsResponse:
    """Round-engine path: rebuild CycleInputs from the wire arrays and
    run the solve_batched the in-process batched mode runs."""
    from ..actions.cycle_inputs import CycleInputs
    from ..kernels.batched import solve_batched

    dev = _WireDevice(device, w.idle, w.releasing, w.backfilled,
                      w.allocatable_cm, w.nz_req0, w.ntasks, w.mtn,
                      w.node_ok)
    inputs = CycleInputs(
        queue_ids=list(req.queues.names), jobs=[], tasks=[None] * w.t,
        device=dev,
        resreq=w.resreq, init_resreq=w.init_resreq, resreq_raw=None,
        task_nz=w.task_nz, task_job=w.task_job, task_rank=w.task_rank,
        task_sig=w.task_sig, task_valid=w.task_valid,
        sig_scores=w.sig_scores, sig_pred=w.sig_pred,
        min_available=w.min_av, order_min_available=w.order_min_av,
        init_allocated=w.init_ready, job_queue=w.job_queue,
        job_priority=w.job_priority, job_create_rank=w.job_create_rank,
        job_valid=w.job_valid,
        q_weight=w.q_weight, q_entries=w.q_entries,
        q_create_rank=w.q_create_rank, q_deserved=w.q_deserved,
        q_alloc0=w.q_alloc0, j_alloc0=w.j_alloc0,
        cluster_total=w.cluster_total,
        dyn_weights=w.dyn_weights, dyn_enabled=w.dyn_enabled,
        job_keys=w.job_keys, queue_keys=w.queue_keys,
        gang_enabled=req.gang_enabled,
        prop_overused=req.proportion_enabled,
        affinity=w.affinity,
        pipe_enabled=w.pipe_enabled)
    # cat="host": solve_batched's own kernel span (inside) carries the
    # kernel view; this wrapper is the wire solve_ms extent
    with obs.span("solve_batched", cat="host", engine="batched") as sp:
        task_state, task_node, task_seq, rounds, _ = solve_batched(inputs)
    return _decisions(req, w, task_state, task_node, task_seq,
                      int(rounds), sp.dur * 1e3)
