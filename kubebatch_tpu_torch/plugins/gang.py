"""gang — all-or-nothing gang scheduling over PodGroups.

ref: pkg/scheduler/plugins/gang/gang.go.
"""
from __future__ import annotations

from typing import List, Optional

from ..api import (JobInfo, JobReadiness, TaskInfo, TaskStatus,
                   ValidateResult, allocated_status)
from ..framework import Plugin, Session
from ..metrics import (register_job_retries, update_unschedule_job_count,
                       update_unschedule_task_count)
from ..objects import (BACKFILLED_CONDITION, NOT_ENOUGH_PODS_REASON,
                       NOT_ENOUGH_RESOURCES_REASON, PodGroupCondition,
                       UNSCHEDULABLE_CONDITION)

NAME = "gang"


def valid_task_num(job: JobInfo) -> int:
    """Tasks countable toward the gang quorum (ref: gang.go:47-60)."""
    occupied = 0
    for status, tasks in job.task_status_index.items():
        if (allocated_status(status)
                or status == TaskStatus.ALLOCATED_OVER_BACKFILL
                or status == TaskStatus.SUCCEEDED
                or status == TaskStatus.PIPELINED
                or status == TaskStatus.PENDING):
            occupied += len(tasks)
    return occupied


_READY_STATUSES = None


def ready_task_num(job: JobInfo) -> int:
    """ref: gang.go:212-222 (NB: excludes AllocatedOverBackfill). Runs once
    per allocation event — the status tuple is resolved once, not per call
    (the lazy init avoids an import cycle at module load)."""
    global _READY_STATUSES
    if _READY_STATUSES is None:
        from ..api import ready_statuses
        _READY_STATUSES = tuple(ready_statuses())
    return job.count(*_READY_STATUSES)


def can_lose_one(job: JobInfo) -> bool:
    """gang's per-victim evictability rule (ref: gang.go:108-129): the job
    stays at/above MinAvailable after losing one task, or MinAvailable==1
    (the fork quirk kept verbatim). Shared by preemptable_fn and reclaim's
    provably-idle gate so the two can never desync."""
    return (job.min_available <= ready_task_num(job) - 1
            or job.min_available == 1)


def backfill_eligible(job: JobInfo) -> bool:
    """A job whose tasks are ALL pending may be backfilled
    (ref: gang.go:68-80)."""
    return all(t.status == TaskStatus.PENDING for t in job.tasks.values())


class GangPlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn: Session) -> None:
        def valid_job_fn(job: JobInfo) -> Optional[ValidateResult]:
            vtn = valid_task_num(job)
            if vtn < job.min_available:
                return ValidateResult(
                    False, NOT_ENOUGH_PODS_REASON,
                    f"Not enough valid tasks for gang-scheduling, "
                    f"valid: {vtn}, min: {job.min_available}")
            return None

        ssn.add_job_valid_fn(NAME, valid_job_fn)

        def preemptable_fn(preemptor: TaskInfo,
                           preemptees: List[TaskInfo]) -> List[TaskInfo]:
            """A victim is evictable iff its job stays at/above MinAvailable
            after losing one task — or MinAvailable == 1, a fork quirk kept
            verbatim (ref: gang.go:108-129, flagged 'TODO Terry: Bug?')."""
            victims = []
            for preemptee in preemptees:
                job = ssn.jobs.get(preemptee.job)
                if job is None:
                    continue
                if can_lose_one(job):
                    victims.append(preemptee)
            return victims

        ssn.add_reclaimable_fn(NAME, preemptable_fn)
        ssn.add_preemptable_fn(NAME, preemptable_fn)
        ssn.add_backfill_eligible_fn(NAME, backfill_eligible)

        def job_order_fn(l: JobInfo, r: JobInfo) -> int:
            """Not-ready jobs before ready jobs (ref: gang.go:136-160),
            using the corrected pipelined-inclusive readiness."""
            l_ready = ready_task_num(l) >= l.min_available
            r_ready = ready_task_num(r) >= r.min_available
            if l_ready and r_ready:
                return 0
            if l_ready:
                return 1
            if r_ready:
                return -1
            return 0

        ssn.add_job_order_fn(NAME, job_order_fn)

        def job_ready_fn(job: JobInfo) -> JobReadiness:
            """Gang readiness counting Pipelined + Succeeded like upstream
            v0.4.1's readyTaskNum (and this fork's own OnSessionClose,
            gang.go:171-174). The fork wired JobReadyFn to GetReadiness()
            (gang.go:163), which excludes Pipelined — that makes every
            preemption Statement discard (preempt.go:134-144 can never see
            Ready), a regression we do not reproduce. AlmostReady keeps the
            fork's AllocatedOverBackfill semantics on top."""
            ready = ready_task_num(job)
            if ready >= job.min_available:
                return JobReadiness.READY
            over_backfill = job.count(TaskStatus.ALLOCATED_OVER_BACKFILL)
            if ready + over_backfill >= job.min_available:
                return JobReadiness.ALMOST_READY
            return JobReadiness.NOT_READY

        ssn.add_job_ready_fn(NAME, job_ready_fn)

    def on_session_close(self, ssn: Session) -> None:
        """Stamp Unschedulable/Backfilled conditions for unready jobs
        (ref: gang.go:166-210)."""
        unschedulable_jobs = 0
        for job in ssn.jobs.values():
            # fast screen for the dominant steady shape — every task
            # Running: ready_task_num == len(tasks), no status-bucket
            # walk needed (exact, Running is a ready status)
            idx = job.task_status_index
            if len(idx) == 1 and TaskStatus.RUNNING in idx \
                    and len(job.tasks) >= job.min_available:
                continue
            ready = ready_task_num(job)
            if ready >= job.min_available:
                continue
            unready = job.min_available - ready
            msg = (f"{unready}/{len(job.tasks)} tasks in gang unschedulable: "
                   f"{job.fit_error()}")
            unschedulable_jobs += 1
            update_unschedule_task_count(job.name, unready)
            register_job_retries(job.name)
            cond = PodGroupCondition(
                type=UNSCHEDULABLE_CONDITION, status="True",
                transition_id=ssn.uid,
                reason=NOT_ENOUGH_RESOURCES_REASON, message=msg)
            if any(t.is_backfill for t in job.tasks.values()):
                cond = PodGroupCondition(
                    type=BACKFILLED_CONDITION, status="True",
                    transition_id=ssn.uid)
            try:
                ssn.update_job_condition(job, cond)
            except KeyError:
                pass
        update_unschedule_job_count(unschedulable_jobs)


def new(arguments=None) -> GangPlugin:
    return GangPlugin(arguments)
