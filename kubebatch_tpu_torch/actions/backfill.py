"""backfill — fit small/BestEffort work into holes, lend reserved-but-
idle capacity, and reclaim it when the owed gang completes its quorum.

ref: pkg/scheduler/actions/backfill/backfill.go. Three layers:

1. Active reference behavior (backfill.go:45-70): every Pending task with
   an EMPTY launch request (BestEffort) is allocated to the first
   predicate-passing node.
2. The fork's "backfill over reserved resources" (backfill.go:72-147,
   commented out upstream with live helpers): jobs whose tasks are ALL
   pending (BackFillEligible via gang) are backfilled onto idle
   resources with IsBackfill=true, after unready "top dog" jobs release
   their session-reserved Allocated/AllocatedOverBackfill resources.
3. The completion of the fork's half-built state machine:

   - **over-reserve**: a gang that cannot reach its quorum on idle
     capacity places its remaining min-quorum tasks over
     ``node.accessible()`` (idle + lent ``backfilled``) as
     ``ALLOCATED_OVER_BACKFILL`` — the gang becomes AlmostReady, and
     the reservation is session-only (released at action end, never
     written back).
   - **reclaim**: per AlmostReady gang, a Statement transaction evicts
     the backfill tenants on the hosting nodes, promotes the
     over-backfill placements to Allocated, and commits + dispatches
     iff the gang reaches Ready — tenants are evicted atomically with
     the gang's promotion, or not at all (discard restores them).
     Reclaim evictions are counted in their own ledger
     (backfill_tenants_evicted_total), NOT as preemptions.

   Guard counters (normally zero): ``backfill_double_binds_total`` — a task
   reached dispatch in a state other than Allocated, or a promotion
   target was no longer over-backfill; ``lost_reservations_total`` — an
   over-backfill placement survived the end-of-action release sweep.

Enabled with BackfillAction(reserved=True); off by default, matching
the shipped binary.
"""
from __future__ import annotations


from ..api import JobInfo, TaskStatus
from ..framework import (Action, Session, VolumeAllocationError,
                         register_action)
from ..objects import BACKFILL_ANNOTATION
from ..metrics import (count_backfill_double_bind, count_backfill_reclaim,
                       count_lost_reservation)

#: tenant states a reclaim may evict: cache-real placements (bound or in
#: flight to the API). Session-only Allocated backfill tenants never
#: reach a reclaim — their jobs either dispatched (Binding) or released
#: their placements in backfill_job above.
_EVICTABLE = (TaskStatus.RUNNING, TaskStatus.BOUND, TaskStatus.BINDING)


def release_reserved_resources(ssn: Session, job: JobInfo) -> None:
    """Return a job's session-only reservations to the cluster
    (ref: backfill.go:98-118)."""
    for task in list(job.tasks.values()):
        if task.status in (TaskStatus.ALLOCATED,
                           TaskStatus.ALLOCATED_OVER_BACKFILL):
            ssn.touched_jobs.add(job.uid)
            ssn.touched_nodes.add(task.node_name)
            job.update_task_status(task, TaskStatus.PENDING)
            node = ssn.nodes.get(task.node_name)
            if node is not None:
                node.remove_task(task)
            task.node_name = ""


def backfill_job(ssn: Session, job: JobInfo) -> None:
    """Backfill an all-pending job onto idle resources, marking tasks
    IsBackfill (ref: backfill.go:120-147)."""
    for task in list(job.task_status_index.get(TaskStatus.PENDING,
                                               {}).values()):
        # CoW: is_backfill is written in place — resolve to the job's
        # canonical task first (JobInfo.own_task)
        task = job.own_task(task)
        for node in ssn.nodes.values():
            try:
                ssn.predicate_fn(task, node)
            except Exception:
                continue
            if task.resreq.less_equal(node.idle):
                task.is_backfill = True
                # the mark must survive the session: stamp the SHARED
                # pod's annotation so cache.bind / resync rebuilds carry
                # it into NodeInfo.backfilled (objects.is_backfill_pod)
                task.pod.annotations[BACKFILL_ANNOTATION] = "true"
                try:
                    ssn.allocate(task, node.name, False)
                except Exception:
                    continue
                break
    if not ssn.job_ready(job):
        release_reserved_resources(ssn, job)


def over_reserve_job(ssn: Session, job: JobInfo) -> int:
    """Reserve the rest of an unready gang's quorum OVER lent capacity:
    pending tasks that do not fit any node's idle go onto the first
    predicate-passing node whose ``accessible()`` (idle + backfilled)
    holds them, as ALLOCATED_OVER_BACKFILL — until the gang reports
    AlmostReady. Returns the number of over-placements made."""
    placed = 0
    for task in list(job.task_status_index.get(TaskStatus.PENDING,
                                               {}).values()):
        if ssn.job_ready(job) or ssn.job_almost_ready(job):
            break
        task = job.own_task(task)
        if task.init_resreq.is_empty() or task.is_backfill:
            continue
        for node in ssn.nodes.values():
            try:
                ssn.predicate_fn(task, node)
            except Exception:
                continue
            if task.resreq.less_equal(node.idle):
                # plain capacity — the allocate action's business, and
                # ssn.allocate(..., False) next cycle will take it
                continue
            if not task.resreq.less_equal(node.accessible()):
                continue
            try:
                # counted in Session.allocate with every other
                # over-placement entry path
                ssn.allocate(task, node.name, True)
            except Exception:
                continue
            placed += 1
            break
    return placed


def reclaim_over_backfill(ssn: Session, job: JobInfo) -> bool:
    """Promote an AlmostReady gang to Ready by atomically evicting the
    backfill tenants under its over-backfill placements.

    One Statement transaction: evict every evictable backfill tenant on
    the hosting nodes, promote each ALLOCATED_OVER_BACKFILL task to
    ALLOCATED, and — iff the gang now reports Ready — commit the
    evictions and dispatch the gang. Anything short of Ready discards:
    tenants come back, promotions flip back, the reservation stands for
    a later cycle. Statement has no "promote" op, so the status flips
    are reversed manually on the failure path."""
    over = list(job.task_status_index.get(
        TaskStatus.ALLOCATED_OVER_BACKFILL, {}).values())
    if not over:
        return False
    stmt = ssn.statement()
    evicted = 0
    promoted = []
    ok = True
    for task in over:
        node = ssn.nodes.get(task.node_name)
        if node is None:
            ok = False
            break
        # deterministic tenant order; the list() snapshot matters —
        # stmt.evict replaces entries in node.tasks via update_task
        for tenant in sorted(node.tasks.values(), key=lambda t: t.uid):
            if not tenant.is_backfill or tenant.job == job.uid:
                continue
            if tenant.status not in _EVICTABLE:
                continue
            stmt.evict(tenant, "reclaimed: lent capacity owed to gang "
                               f"<{job.namespace}/{job.name}>")
            evicted += 1
    if ok:
        for task in over:
            task = job.own_task(task)
            if task.status != TaskStatus.ALLOCATED_OVER_BACKFILL:
                # the placement changed under us within one session —
                # promoting would dispatch against capacity we no longer
                # hold
                count_backfill_double_bind()
                ok = False
                break
            job.update_task_status(task, TaskStatus.ALLOCATED)
            promoted.append(task)
    if ok and ssn.job_ready(job):
        stmt.commit()
        count_backfill_reclaim(evicted)
        for task in list(job.task_status_index.get(TaskStatus.ALLOCATED,
                                                   {}).values()):
            if task.status != TaskStatus.ALLOCATED:
                count_backfill_double_bind()
                continue
            ssn.dispatch(task)
        return True
    for task in promoted:
        job.update_task_status(task, TaskStatus.ALLOCATED_OVER_BACKFILL)
    stmt.discard()
    return False


class BackfillAction(Action):
    def __init__(self, reserved: bool = False):
        self.reserved = reserved

    @property
    def name(self) -> str:
        return "backfill"

    def execute(self, ssn: Session) -> None:
        # active path: BestEffort tasks onto any predicate-passing node
        for job in ssn.jobs.values():
            for task in list(job.task_status_index.get(TaskStatus.PENDING,
                                                       {}).values()):
                if not task.init_resreq.is_empty():
                    continue
                for node in ssn.nodes.values():
                    try:
                        ssn.predicate_fn(task, node)
                    except Exception:
                        continue
                    try:
                        ssn.allocate(task, node.name, False)
                    except VolumeAllocationError:
                        # pre-mutation failure only; post-mutation errors
                        # propagate (see actions/allocate.py host path)
                        continue
                    break

        if not self.reserved:
            return

        # fork path: collect eligible (all-pending) jobs, release unready
        # top dogs' reservations, then backfill (backfill.go:74-94)
        candidates = [job for job in ssn.jobs.values()
                      if ssn.backfill_eligible(job)]
        for job in ssn.jobs.values():
            if not ssn.job_almost_ready(job) and not ssn.job_ready(job):
                release_reserved_resources(ssn, job)
        for job in candidates:
            backfill_job(ssn, job)

        # over-reserve: gangs still short of quorum on idle reach over
        # the lent capacity; reclaim: AlmostReady gangs try to complete
        # their quorum by evicting their tenants atomically
        for job in ssn.jobs.values():
            if job.min_available <= 0 or ssn.job_ready(job):
                continue
            if not ssn.job_almost_ready(job):
                over_reserve_job(ssn, job)
            if ssn.job_almost_ready(job):
                reclaim_over_backfill(ssn, job)

        # the reservation is session-only: whatever was not promoted is
        # handed back before session close so the cache never sees an
        # over-backfill placement. A placement the sweep cannot clear is
        # a LOST reservation — the guard counter trips the bench pins.
        for job in ssn.jobs.values():
            idx = job.task_status_index.get(
                TaskStatus.ALLOCATED_OVER_BACKFILL, {})
            if not idx:
                continue
            release_reserved_resources(ssn, job)
            leftover = len(job.task_status_index.get(
                TaskStatus.ALLOCATED_OVER_BACKFILL, {}))
            if leftover:
                count_lost_reservation(leftover)


def new() -> BackfillAction:
    return BackfillAction()


register_action(BackfillAction())
