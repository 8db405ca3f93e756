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


class _QueueBase:
    """Cross-cycle per-queue rollup: sums of the member jobs'
    contributions (allocated / allocated+pending request) plus a member
    count — the inputs the water-filling needs, maintained by deltas."""
    __slots__ = ("alloc", "req", "njobs")

    def __init__(self):
        self.alloc = Resource.empty()
        self.req = Resource.empty()
        self.njobs = 0


#: full-rebuild period for the delta-maintained rollups: reversing a
#: contribution with float sub can leave ulp-scale residue; a periodic
#: re-sum bounds it far below the 10m/10Mi decision epsilons
_RESUM_PERIOD = 256


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

        # Cross-cycle queue rollups by per-job contribution deltas
        # (contract at cache.plugin_scratch): only refreshed/new/gone jobs
        # touch the sums — O(churn), not O(jobs).
        scratch = ssn.cache.plugin_scratch
        state = scratch.get(NAME)
        refreshed = ssn.refreshed_jobs
        if (state is None or refreshed is None
                or state["total"] != self.total_resource
                or state["opens"] % _RESUM_PERIOD == 0):
            contrib: Dict[str, tuple] = {}
            bases: Dict[str, _QueueBase] = {}
            gone = ()
            rebuild = list(ssn.jobs.values())
            opens = 1 if state is None else state["opens"] + 1
        else:
            contrib, bases = state["contrib"], state["bases"]
            gone = [uid for uid in contrib if uid not in ssn.jobs]
            rebuild = [job for uid, job in ssn.jobs.items()
                       if uid in refreshed or uid not in contrib]
            opens = state["opens"] + 1
        for uid in gone:
            qkey, alloc, req = contrib.pop(uid)
            base = bases[qkey]
            base.alloc.sub(alloc)
            base.req.sub(req)
            base.njobs -= 1
        for job in rebuild:
            old = contrib.pop(job.uid, None)
            if old is not None:
                base = bases[old[0]]
                base.alloc.sub(old[1])
                base.req.sub(old[2])
                base.njobs -= 1
            # snapshot() already drops jobs whose queue is missing, so
            # every session job contributes (ref: proportion.go:66-98
            # "queue attributes only for queues that have jobs")
            alloc, req = self._job_contribution(job)
            base = bases.get(job.queue)
            if base is None:
                base = bases[job.queue] = _QueueBase()
            base.alloc.add(alloc)
            base.req.add(req)
            base.njobs += 1
            contrib[job.uid] = (job.queue, alloc, req)
        scratch[NAME] = {"contrib": contrib, "bases": bases,
                         "total": self.total_resource.clone(),
                         "opens": opens}

        # session-local working attrs over the rollups (the water-fill
        # and the in-session event handlers mutate these, never the bases)
        for qkey, base in bases.items():
            if base.njobs <= 0:
                continue
            queue = ssn.queues.get(qkey)
            if queue is None:
                continue
            attr = QueueAttr(queue)
            attr.allocated = base.alloc.clone()
            attr.request = base.req.clone()
            self.queue_opts[qkey] = attr

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
