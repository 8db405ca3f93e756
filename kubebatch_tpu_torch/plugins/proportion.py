"""proportion — weighted proportional fairness across queues.

ref: pkg/scheduler/plugins/proportion/proportion.go. The iterative
weighted water-filling of per-queue ``deserved`` is reproduced exactly,
including the reference's cumulative ``remaining`` bookkeeping (remaining
is decremented by each round's TOTAL deserved sum, going negative on the
final round — the negative value only feeds the is_empty termination
check, proportion.go:100-142).
"""
from __future__ import annotations

from typing import Dict, List

from ..api import (QueueInfo, Resource, TaskInfo, dominant_share,
                   res_min)
from ..api.types import TaskStatus
from ..framework import EventHandler, Plugin, Session

NAME = "proportion"


class QueueAttr:
    __slots__ = ("queue_id", "name", "weight", "share", "deserved",
                 "allocated", "request")

    def __init__(self, queue: QueueInfo):
        self.queue_id = queue.uid
        self.name = queue.name
        self.weight = queue.weight
        self.share = 0.0
        self.deserved = Resource.empty()
        self.allocated = Resource.empty()
        self.request = Resource.empty()


class ProportionPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.queue_opts: Dict[str, QueueAttr] = {}

    @property
    def name(self) -> str:
        return NAME

    def _update_share(self, attr: QueueAttr) -> None:
        """share = max over resources of allocated/deserved
        (ref: proportion.go:229-241)."""
        attr.share = dominant_share(attr.allocated, attr.deserved)

    def could_allow_any_victim(self) -> bool:
        """Over-approximation of "reclaimable_fn could return a non-empty
        victim list for SOME (reclaimer, reclaimees) call this session" —
        consumed by reclaim's provably-idle gate
        (actions/reclaim.py:_no_possible_reclaim_victim).

        Coupled to reclaimable_fn below: that fn admits a victim only when
        its queue's allocated stays >= deserved after subtracting the
        victim's resreq. Since resreq >= 0, a queue whose allocated is
        already strictly below deserved can never pass; so victims are
        possible only if some queue has deserved <= allocated. If
        reclaimable_fn's floor ever changes (e.g. adopting a newer
        reference's releasing-aware skip), THIS method must be revisited
        in the same change — the 5-seed fuzz in
        tests/test_preempt_reclaim.py is the backstop, not the contract."""
        return any(attr.deserved.less_equal(attr.allocated)
                   for attr in self.queue_opts.values())

    def _job_contribution(self, job):
        """(allocated, request) the job adds to its queue's rollup —
        allocated-family sum = the maintained JobInfo.allocated aggregate
        (ref proportion.go:66-98 recomputes per task); only the PENDING
        bucket needs a walk."""
        alloc = job.allocated.clone()
        req = job.allocated.clone()
        for t in job.task_status_index.get(TaskStatus.PENDING, {}).values():
            req.add(t.resreq)
        return alloc, req

    def on_session_open(self, ssn: Session) -> None:
        self.total_resource.add(ssn.total_allocatable())

        # queue attributes only for queues that have jobs; snapshot()
        # already drops jobs whose queue is missing (ref:
        # proportion.go:66-98)
        for job in ssn.jobs.values():
            attr = self.queue_opts.get(job.queue)
            if attr is None:
                queue = ssn.queues.get(job.queue)
                if queue is None:
                    continue
                attr = self.queue_opts[job.queue] = QueueAttr(queue)
            alloc, req = self._job_contribution(job)
            attr.allocated.add(alloc)
            attr.request.add(req)

        # weighted water-filling (ref: proportion.go:100-142, quirks intact)
        remaining = self.total_resource.clone()
        met = set()
        while True:
            total_weight = sum(a.weight for a in self.queue_opts.values()
                               if a.queue_id not in met)
            if total_weight == 0:
                break
            deserved_sum = Resource.empty()
            for attr in self.queue_opts.values():
                if attr.queue_id in met:
                    continue
                attr.deserved.add(
                    remaining.clone().multi(attr.weight / total_weight))
                if not attr.deserved.less_equal(attr.request):
                    attr.deserved = res_min(attr.deserved, attr.request)
                    met.add(attr.queue_id)
                self._update_share(attr)
                deserved_sum.add(attr.deserved)
            remaining.sub(deserved_sum)
            if remaining.is_empty():
                break

        def queue_order_fn(l: QueueInfo, r: QueueInfo) -> int:
            ls = self.queue_opts[l.uid].share
            rs = self.queue_opts[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_queue_order_fn(NAME, queue_order_fn)

        def reclaimable_fn(reclaimer: TaskInfo,
                           reclaimees: List[TaskInfo]) -> List[TaskInfo]:
            """Victim allowed iff its queue stays at/above deserved after
            losing it (ref: proportion.go:159-184).

            NB: could_allow_any_victim() above encodes this fn's floor for
            reclaim's provably-idle gate — change them together."""
            victims = []
            allocations: Dict[str, Resource] = {}
            for reclaimee in reclaimees:
                job = ssn.jobs.get(reclaimee.job)
                if job is None or job.queue not in self.queue_opts:
                    continue
                attr = self.queue_opts[job.queue]
                if job.queue not in allocations:
                    allocations[job.queue] = attr.allocated.clone()
                allocated = allocations[job.queue]
                if allocated.less(reclaimee.resreq):
                    continue
                allocated.sub(reclaimee.resreq)
                if attr.deserved.less_equal(allocated):
                    victims.append(reclaimee)
            return victims

        ssn.add_reclaimable_fn(NAME, reclaimable_fn)

        def overused_fn(queue: QueueInfo) -> bool:
            attr = self.queue_opts.get(queue.uid)
            if attr is None:
                return False
            return attr.deserved.less_equal(attr.allocated)

        ssn.add_overused_fn(NAME, overused_fn)

        def on_allocate(event):
            job = ssn.jobs.get(event.task.job)
            if job is None or job.queue not in self.queue_opts:
                return
            attr = self.queue_opts[job.queue]
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            job = ssn.jobs.get(event.task.job)
            if job is None or job.queue not in self.queue_opts:
                return
            attr = self.queue_opts[job.queue]
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           owner=NAME))

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = Resource.empty()
        self.queue_opts = {}


def new(arguments=None) -> ProportionPlugin:
    return ProportionPlugin(arguments)
