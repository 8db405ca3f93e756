"""The solver client's encode and replay half (ref:
kubebatch_tpu/rpc/client.py): a Session becomes a SnapshotRequest, and
the returned decisions replay through the Session.

The wire carries the whole policy-term payload the in-process engines
consume: sig-indexed predicate/score matrices, the dynamic nodeorder
weights with their per-task and per-node nonzero-request inputs, the
drf/proportion fairness seeds, and the affinity vocabulary as
``Tensor``s. :func:`build_snapshot` writes the bytes the reference's
encoder writes for the same session (rpc/wire.py).

A tenant id and its weighted-fair weight pin per thread
(:func:`set_tenant`); an unset thread is the "default" tenant. (The
reference falls back to its KUBEBATCH_TENANT / KUBEBATCH_TENANT_WEIGHT
settings; this package reads no process-wide settings.)

Not here yet: the grpc channel (``SolverClient``, its ``solve`` with the
``kb-*`` metadata and the span graft), ``DISPATCH_STATS``, the client
pools and the fleet routing — the transport, ROADMAP A8.
"""
from __future__ import annotations

import functools
import threading
from typing import Dict, List, Optional

import numpy as np

from ..actions.cycle_inputs import (cycle_supported, gang_enabled,
                                    job_order_spec)
from ..api import TaskStatus, ready_statuses
from ..framework import Session
from ..kernels.fused import ALLOC, ALLOC_OB, K_DRF_SHARE, K_PRIORITY, PIPELINE
from ..kernels.tensorize import NodeState, nz_request_vec
from ..kernels.terms import solver_terms
from .wire import SnapshotRequest, to_tensor

__all__ = ["AdmissionRejected", "StaleDecisions", "build_snapshot",
           "apply_decisions", "set_tenant", "current_tenant",
           "current_weight"]


class _StateShim:
    """solver_terms and the affinity encoder read only ``.state`` off
    their device argument, so the client encodes from a host-side
    NodeState without a device upload."""

    def __init__(self, state: NodeState):
        self.state = state


class AdmissionRejected(RuntimeError):
    """The tenant service refused the request (queue full, shed mode,
    quarantined tenant): an overload signal — run the cycle in-process."""


class StaleDecisions(AdmissionRejected):
    """The service answered from the tenant's stale decision mirror
    (the serve-stale shed mode). Stale decisions reference a previous
    snapshot's tasks, so a scheduler must not replay them."""

    def __init__(self, msg: str, resp=None):
        super().__init__(msg)
        self.resp = resp


# -- per-thread tenant identity ---------------------------------------
_TENANT_TLS = threading.local()


def set_tenant(tenant: Optional[str],
               weight: Optional[float] = None) -> None:
    """Pin this thread's tenant id (None clears it back to "default") and
    its weighted-fair weight (None: the service keeps its last value)."""
    _TENANT_TLS.value = tenant
    _TENANT_TLS.weight = weight


def current_tenant() -> str:
    """This thread's tenant, else "default"."""
    return getattr(_TENANT_TLS, "value", None) or "default"


def current_weight() -> Optional[float]:
    """This thread's weighted-fair weight, else None."""
    wt = getattr(_TENANT_TLS, "weight", None)
    return float(wt) if wt is not None else None


def build_snapshot(ssn: Session):
    """(SnapshotRequest, {task_uid: TaskInfo}) from a Session. Raises
    ValueError for configurations the solver cannot express (custom order
    fns, predicate/node-order plugins outside the device terms, affinity
    below the batched threshold or past the caps): silent divergence
    from the in-process path is worse than an error."""
    if not cycle_supported(ssn):
        raise ValueError(
            "session plugins exceed the sidecar solver's vocabulary; "
            "run allocate in-process for this configuration")
    req = SnapshotRequest()
    node_names = sorted(ssn.nodes)
    if node_names:
        nis = [ssn.nodes[name] for name in node_names]
        nt = req.nodes
        nt.names = node_names
        nt.idle = np.concatenate([ni.idle.to_vec() for ni in nis])
        nt.releasing = np.concatenate([ni.releasing.to_vec() for ni in nis])
        nt.backfilled = np.concatenate([ni.backfilled.to_vec()
                                        for ni in nis])
        nt.max_task_num = [ni.allocatable.max_task_num for ni in nis]
        nt.n_tasks = [len(ni.tasks) for ni in nis]
        nt.schedulable = [ni.node is not None and not ni.node.unschedulable
                          for ni in nis]

    queue_names = sorted(ssn.queues)
    q_index = {q: i for i, q in enumerate(queue_names)}
    prop = ssn.plugins.get("proportion")
    if queue_names:
        deserved, allocated = [], []
        for qn in queue_names:
            attr = getattr(prop, "queue_opts", {}).get(qn) if prop else None
            if attr is not None:
                deserved.append(attr.deserved.to_vec())
                allocated.append(attr.allocated.to_vec())
            else:
                deserved.append(np.zeros(3, np.float32))
                allocated.append(np.zeros(3, np.float32))
        qt = req.queues
        qt.names = queue_names
        qt.weight = [ssn.queues[qn].weight for qn in queue_names]
        qt.deserved = np.concatenate(deserved)
        qt.allocated = np.concatenate(allocated)

    jobs = [jb for jb in ssn.jobs.values() if jb.queue in q_index]
    rank = {jb.uid: r for r, jb in enumerate(
        sorted(jobs, key=lambda x: (x.creation_timestamp, x.uid)))}
    tasks_by_uid: Dict[str, object] = {}
    t_resreq, t_init, t_job, t_rank = [], [], [], []
    for ji, jb in enumerate(jobs):
        pend = [t for t in jb.task_status_index.get(TaskStatus.PENDING,
                                                    {}).values()
                if not t.resreq.is_empty()]
        pend.sort(key=functools.cmp_to_key(
            lambda a, b: -1 if ssn.task_order_fn(a, b) else 1))
        for r, t in enumerate(pend):
            t_resreq.append(t.resreq.to_vec())
            t_init.append(t.init_resreq.to_vec())
            t_job.append(ji)
            t_rank.append(r)
            tasks_by_uid[t.uid] = t
    if jobs:
        jt = req.jobs
        jt.uids = [jb.uid for jb in jobs]
        jt.min_available = [jb.min_available for jb in jobs]
        jt.init_ready = [jb.count(*ready_statuses()) for jb in jobs]
        jt.queue_index = [q_index[jb.queue] for jb in jobs]
        jt.priority = [jb.priority for jb in jobs]
        jt.create_rank = [rank[jb.uid] for jb in jobs]
    if tasks_by_uid:
        tt = req.tasks
        tt.uids = list(tasks_by_uid)
        tt.resreq = np.concatenate(t_resreq)
        tt.init_resreq = np.concatenate(t_init)
        tt.job_index = t_job
        tt.rank = t_rank

    # flags derived as the in-process fused path derives them, so
    # per-tier disable flags are honored identically
    job_keys, _ = job_order_spec(ssn)
    req.gang_enabled = gang_enabled(ssn)
    req.proportion_enabled = (
        "proportion" in ssn.overused_fns
        and any(opt.name == "proportion" for tier in ssn.tiers
                for opt in tier.plugins))
    req.drf_enabled = K_DRF_SHARE in job_keys
    req.priority_enabled = K_PRIORITY in job_keys
    req.job_order_keys = list(job_keys)      # exact tier-dispatch order
    drf = ssn.plugins.get("drf")
    if drf is not None:
        req.cluster_total = drf.total_resource.to_vec()
        if jobs:
            vecs = []
            for jb in jobs:
                attr = drf.job_opts.get(jb.uid)
                vecs.append(attr.allocated.to_vec() if attr is not None
                            else np.zeros(3, np.float32))
            req.jobs.allocated = np.concatenate(vecs)

    _attach_terms(ssn, req, node_names, tasks_by_uid)
    return req, tasks_by_uid


def _attach_terms(ssn: Session, req, node_names: List[str],
                  tasks_by_uid: Dict[str, object]) -> None:
    """Encode the predicate/score terms (kernels/terms) and the affinity
    vocabulary into the wire payload. Raises ValueError for snapshots
    whose callbacks the kernels cannot express."""
    from ..kernels.affinity import (WIRE_FIELDS, affinity_features_present,
                                    affinity_within_vocabulary,
                                    build_affinity_inputs)
    from ..kernels.terms import device_supported

    pending = list(tasks_by_uid.values())
    state = NodeState.from_nodes(ssn.nodes)
    if not device_supported(ssn, pending, allow_affinity=True):
        raise ValueError(
            "session predicates/score callbacks exceed the sidecar "
            "solver's vocabulary; run allocate in-process")
    if affinity_features_present(ssn, pending):
        # only the batched engine carries the affinity vocabulary; below
        # the batched threshold the in-process path keeps the cycle
        from ..actions.allocate import AUTO_BATCHED_MIN
        if len(pending) < AUTO_BATCHED_MIN:
            raise ValueError(
                "affinity snapshot below the batched threshold; "
                "run allocate in-process")
        if not affinity_within_vocabulary(ssn, pending):
            raise ValueError(
                "affinity vocabulary exceeds the caps; run allocate "
                "in-process")
        aff = build_affinity_inputs(ssn, pending, _StateShim(state),
                                    t_pad=len(pending))
        if aff is None:
            raise ValueError(
                "affinity vocabulary exceeds the caps after "
                "compaction; run allocate in-process")
        req.affinity.extend(to_tensor(getattr(aff, name))
                            for name in WIRE_FIELDS)
        req.affinity_ip_weight = aff.ip_weight
        req.affinity_ip_enabled = aff.ip_enabled
    terms = solver_terms(ssn, _StateShim(state), pending,
                         assume_supported=True)
    if terms is None:   # pragma: no cover — gated above
        raise ValueError(
            "session predicates/score callbacks exceed the sidecar "
            "solver's vocabulary; run allocate in-process")
    n = len(node_names)
    t = req.terms
    static = terms.static
    t.n_sigs = static.n_sigs
    t.sig_pred = np.asarray(static.pred[:, :n], bool)
    t.sig_scores = np.asarray(static.score[:, :n], np.float32)
    t.task_sig = [static.sig_of[uid] for uid in tasks_by_uid]
    # task_nz always travels: the batched engine's waterfall cohorts are
    # (sig, nonzero-request) pairs even with dynamic scoring off
    t.task_nz = (np.concatenate([nz_request_vec(task.resreq.to_vec())
                                 for task in pending])
                 if pending else [])
    if terms.dynamic.enabled:
        t.least_requested_weight = terms.dynamic.least_requested
        t.balanced_resource_weight = terms.dynamic.balanced_resource
        t.node_nz = state.nz_requested[:n]
        t.allocatable_cm = state.allocatable[:n, :2]


def apply_decisions(ssn: Session, resp, tasks_by_uid) -> None:
    """Replay the decisions through the Session in their application
    order. A pre-mutation volume-allocation failure skips that task (it
    stays Pending and reschedules next cycle); any other error
    propagates."""
    from ..framework import VolumeAllocationError

    decisions = [d for d in resp.decisions if d.order >= 0]
    decisions.sort(key=lambda d: d.order)
    for d in decisions:
        task = tasks_by_uid.get(d.task_uid)
        if task is None:
            continue
        try:
            if d.kind in (ALLOC, ALLOC_OB):
                ssn.allocate(task, d.node_name, d.kind == ALLOC_OB)
            elif d.kind == PIPELINE:
                ssn.pipeline(task, d.node_name)
        except VolumeAllocationError:
            continue
