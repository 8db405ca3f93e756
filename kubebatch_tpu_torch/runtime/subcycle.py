"""Schedule-on-arrival sub-cycle (ref: kubebatch_tpu/runtime/subcycle.py):
latency-lane pods don't wait for the period.

- the cache's arrival hook fires (outside the cache lock) for every
  PENDING pod, and the scheduler queues those whose lane annotation says
  ``latency``;
- the scheduler drains queued arrivals under its cycle lock (a
  sub-cycle never overlaps a full cycle; bursts coalesce);
- the sub-cycle opens a session off the (folded) snapshot, refreshes the
  dirty device rows, and runs ONE per-visit allocate scan for each
  arrived job — one kernel launch and one counted copy back each;
- decisions apply through the Session mutators and CloseSession
  write-back: the bind lands in cache truth as BINDING, so the next full
  cycle sees a non-pending task and re-places nothing.

Each sub-cycle runs under its own span root ("subcycle"); arrival ->
decision latencies go to ``metrics.observe_arrival_latency``, which
keeps the exact count and sends the latency to the decision ledger's
histogram (obs/ledger.py ``observe_subcycle_arrival``).
"""
from __future__ import annotations

import logging
import time
from typing import List, Tuple

from .. import obs
from ..api import TaskStatus
from ..api.job import get_job_id
from ..metrics import count_subcycle, observe_arrival_latency
from ..objects import Pod
from ..obs.ledger import DEFAULT_LANE, LANE_ANNOTATION, LATENCY_LANE

__all__ = ["DEFAULT_LANE", "LANE_ANNOTATION", "LATENCY_LANE",
           "is_latency_pod", "pod_lane", "run_subcycle"]

log = logging.getLogger("kubebatch.subcycle")


def pod_lane(pod: Pod) -> str:
    return pod.annotations.get(LANE_ANNOTATION, DEFAULT_LANE)


def is_latency_pod(pod: Pod) -> bool:
    """True for pods the sub-cycle serves: arrivals on the latency
    lane."""
    return pod_lane(pod) == LATENCY_LANE


def _job_uid(pod: Pod) -> str:
    """The cache's job uid for this pod (grouped pods: 'ns/group';
    ungrouped pods the shadow group's, cache/cache.py
    create_shadow_pod_group)."""
    return get_job_id(pod) or str(pod.owner_uid or pod.uid)


def run_subcycle(scheduler, arrivals: List[Tuple[Pod, float]]) -> int:
    """One narrow allocate for ``arrivals`` ((pod, perf_counter arrival)
    pairs). Returns how many arrived pods got a decision. The caller
    (Scheduler._drain_arrivals) holds the cycle lock and guards
    exceptions."""
    from ..framework import CloseSession, OpenSession

    cache = scheduler.cache
    scheduler._subcycle_seq += 1
    root = obs.begin_cycle(scheduler._subcycle_seq, name="subcycle",
                           arrivals=len(arrivals))
    decided = 0
    try:
        with obs.span("subcycle", cat="phase"):
            ssn = OpenSession(cache, scheduler.tiers,
                              scheduler.enable_preemption)
            try:
                decided = _solve_arrivals(ssn, arrivals)
            finally:
                CloseSession(ssn)
    finally:
        obs.end_cycle(root)
    count_subcycle()
    return decided


def _solve_arrivals(ssn, arrivals: List[Tuple[Pod, float]]) -> int:
    """One per-visit solve per arrived job against the live device
    arrays, or the host loop when the session carries features outside
    the device terms (the period loop's per-visit gate)."""
    from ..actions.allocate import AllocateAction
    from ..kernels.solver import ensure_device_snapshot
    from ..kernels.terms import device_supported, solver_terms
    from ..util import PriorityQueue

    #: job uid -> [(pod, t_arrival)]: a burst of one gang's arrivals
    #: solves in one visit
    by_job = {}
    for pod, t0 in arrivals:
        by_job.setdefault(_job_uid(pod), []).append((pod, t0))

    act = AllocateAction(mode="jax")
    device = None
    terms = None
    pending = [t for uid in by_job
               for j in (ssn.jobs.get(uid),) if j is not None
               for t in j.task_status_index.get(TaskStatus.PENDING,
                                                {}).values()
               if not t.resreq.is_empty()]
    if pending and device_supported(ssn, pending):
        device = ensure_device_snapshot(ssn)
        terms = solver_terms(ssn, device, pending, assume_supported=True)

    decided = 0
    for uid, pods in by_job.items():
        job = ssn.jobs.get(uid)
        if job is None:
            continue
        tasks = PriorityQueue(ssn.task_order_fn)
        for task in job.task_status_index.get(TaskStatus.PENDING,
                                              {}).values():
            if not task.resreq.is_empty():
                tasks.push(task)
        if tasks.empty():
            continue
        jobs_pq = PriorityQueue(ssn.job_order_fn)   # one visit
        if device is not None:
            act._visit_job_device(ssn, device, job, tasks, jobs_pq, terms)
        else:
            act._visit_job_host(ssn, job, tasks, jobs_pq)
        if not ssn.job_ready(job):
            # gang barrier: a lone member of a min_member > 1 gang waits
            # for the rest of its gang (then the period loop)
            continue
        now = time.perf_counter()
        for pod, t0 in pods:
            task = job.tasks.get(pod.uid)
            if task is not None and task.status != TaskStatus.PENDING:
                observe_arrival_latency(max(0.0, now - t0))
                decided += 1
    return decided
