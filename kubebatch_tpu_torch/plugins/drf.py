"""drf — dominant resource fairness across jobs.

ref: pkg/scheduler/plugins/drf/drf.go. Dominant share per job = max over
resources of allocated/cluster-total, updated incrementally on allocate/
evict events; jobs with lower share schedule first; a victim is
preemptable iff the preemptor's post-preemption share stays at or below
the victim job's post-eviction share (within 1e-6).
"""
from __future__ import annotations

from typing import Dict, List

from ..api import JobInfo, Resource, TaskInfo, dominant_share
from ..framework import EventHandler, Plugin, Session

NAME = "drf"
SHARE_DELTA = 1e-6


class DrfAttr:
    __slots__ = ("share", "allocated")

    def __init__(self):
        self.share = 0.0
        self.allocated = Resource.empty()


class DrfPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}
        self.total_resource = Resource.empty()
        self.job_opts: Dict[str, DrfAttr] = {}

    @property
    def name(self) -> str:
        return NAME

    def _calculate_share(self, allocated: Resource) -> float:
        return dominant_share(allocated, self.total_resource)

    def _update_share(self, attr: DrfAttr) -> None:
        attr.share = self._calculate_share(attr.allocated)

    def on_session_open(self, ssn: Session) -> None:
        self.total_resource.add(ssn.total_allocatable())

        # Cross-cycle attr reuse (contract at cache.plugin_scratch): an
        # attr stays valid while its job's clone is reused by the folded
        # snapshot — shares depend only on job.allocated (the maintained
        # aggregate; the reference recomputes per open, drf.go:59-82) and
        # on the cluster total, which only changes with node shape.
        scratch = ssn.cache.plugin_scratch
        state = scratch.get(NAME)
        refreshed = ssn.refreshed_jobs
        attrs: Dict[str, DrfAttr]
        if (state is None or refreshed is None
                or state["total"] != self.total_resource):
            attrs = {}
            rebuild = ssn.jobs.values()
        else:
            attrs = state["attrs"]
            for uid in list(attrs):
                if uid not in ssn.jobs:
                    del attrs[uid]
            rebuild = [job for uid, job in ssn.jobs.items()
                       if uid in refreshed or uid not in attrs]
        for job in rebuild:
            attr = DrfAttr()
            attr.allocated = job.allocated.clone()
            self._update_share(attr)
            attrs[job.uid] = attr
        self.job_opts = attrs
        scratch[NAME] = {"attrs": attrs, "total": self.total_resource.clone()}

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """ref: drf.go:84-109."""
            latt = self.job_opts.get(preemptor.job)
            if latt is None:
                return []
            lalloc = latt.allocated.clone().add(preemptor.resreq)
            ls = self._calculate_share(lalloc)
            victims = []
            allocations: Dict[str, Resource] = {}
            for preemptee in preemptees:
                ratt = self.job_opts.get(preemptee.job)
                if ratt is None:
                    continue
                if preemptee.job not in allocations:
                    allocations[preemptee.job] = ratt.allocated.clone()
                ralloc = allocations[preemptee.job].sub(preemptee.resreq)
                rs = self._calculate_share(ralloc)
                if ls < rs or abs(ls - rs) <= SHARE_DELTA:
                    victims.append(preemptee)
            return victims

        ssn.add_preemptable_fn(NAME, preemptable_fn)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            ls = self.job_opts[l.uid].share
            rs = self.job_opts[r.uid].share
            if ls == rs:
                return 0
            return -1 if ls < rs else 1

        ssn.add_job_order_fn(NAME, job_order_fn)

        def on_allocate(event):
            attr = self.job_opts.get(event.task.job)
            if attr is None:
                return
            attr.allocated.add(event.task.resreq)
            self._update_share(attr)

        def on_deallocate(event):
            attr = self.job_opts.get(event.task.job)
            if attr is None:
                return
            attr.allocated.sub(event.task.resreq)
            self._update_share(attr)

        ssn.add_event_handler(EventHandler(allocate_func=on_allocate,
                                           deallocate_func=on_deallocate,
                                           owner=NAME))

    def on_session_close(self, ssn: Session) -> None:
        self.total_resource = Resource.empty()
        self.job_opts = {}


def new(arguments=None) -> DrfPlugin:
    return DrfPlugin(arguments)
