"""Session — the per-cycle scheduling transaction.

ref: pkg/scheduler/framework/session.go + session_plugins.go. A Session
owns an immutable snapshot of the cluster, lets plugins install policy
callbacks, and lets actions mutate session state while deferring all real
cluster effects (bind/evict) to the cache seams. Tier-dispatch semantics
are preserved exactly: per-tier victim-list INTERSECTION for
preemptable/reclaimable, AND for predicates, SUM for node scores,
first-non-zero for order fns, any-true for overused/backfill-eligible.

Device note: the session also carries a lazily-built ``DeviceSession``
(kernels/solver.py) so actions can hand the whole pods x nodes problem
to the device solver instead of looping these per-pair callbacks. The
callbacks stay as ground truth for tests and for host-side odds and ends.
"""
from __future__ import annotations

import time as _time
import uuid as _uuid
from typing import Callable, Dict, List, Optional

from ..api import (ClusterInfo, JobInfo, JobReadiness, NodeInfo, QueueInfo,
                   TaskInfo, TaskStatus, ValidateResult)
from ..conf import Tier
from ..metrics import (count_backfill_over_placement,
                       update_pod_schedule_status,
                       update_task_schedule_duration)
from ..objects import (PodGroupCondition, PodGroupPhase, PodGroupStatus,
                       UNSCHEDULABLE_CONDITION)
from .event import Event, EventHandler

# Callback signatures (ref: api/types.go:118-147)
CompareFn = Callable[[object, object], int]
PredicateFn = Callable[[TaskInfo, NodeInfo], None]   # raises to reject
NodeOrderFn = Callable[[TaskInfo, NodeInfo], float]
EvictableFn = Callable[[TaskInfo, List[TaskInfo]], Optional[List[TaskInfo]]]


class PredicateError(Exception):
    """A predicate rejection with a user-facing reason."""


class VolumeAllocationError(Exception):
    """allocate_volumes failed BEFORE any session mutation — the one
    ssn.allocate failure callers may safely answer with try-the-next-node
    (ref: allocate.go:157-161). Later failures (dispatch/bind) leave
    mutated session state behind and must propagate."""


class Session:
    def __init__(self, cache, snapshot: ClusterInfo,
                 enable_preemption: bool = False):
        self.uid: str = str(_uuid.uuid4())
        self.cache = cache
        self.jobs: Dict[str, JobInfo] = snapshot.jobs
        self.nodes: Dict[str, NodeInfo] = snapshot.nodes
        self.queues: Dict[str, QueueInfo] = snapshot.queues
        #: job uids freshly re-cloned from cache truth (None = all)
        self.refreshed_jobs = getattr(snapshot, "refreshed_jobs", None)
        #: cache-maintained cluster allocatable sum (None on hand-built
        #: snapshots; total_allocatable then falls back to a node walk)
        self._snapshot_allocatable_total = getattr(
            snapshot, "allocatable_total", None)
        #: jobs cache truth holds that this snapshot dropped (no
        #: PodGroup/PDB, or missing queue) — their pods can still occupy
        #: nodes; None on hand-built snapshots (unknown)
        self.jobs_excluded = getattr(snapshot, "jobs_excluded", None)
        #: node-iteration-order version (cache._node_order_epoch); None on
        #: hand-built snapshots — order-derived caches then rebuild
        self.node_order_epoch = getattr(snapshot, "node_order_epoch", None)
        self.backlog: List[JobInfo] = []
        self.tiers: List[Tier] = []
        self.enable_preemption = enable_preemption

        self.plugins: Dict[str, object] = {}
        self.event_handlers: List[EventHandler] = []
        self.job_order_fns: Dict[str, CompareFn] = {}
        self.queue_order_fns: Dict[str, CompareFn] = {}
        self.task_order_fns: Dict[str, CompareFn] = {}
        self.predicate_fns: Dict[str, PredicateFn] = {}
        self.node_order_fns: Dict[str, NodeOrderFn] = {}
        self.preemptable_fns: Dict[str, EvictableFn] = {}
        self.reclaimable_fns: Dict[str, EvictableFn] = {}
        self.overused_fns: Dict[str, Callable[[QueueInfo], bool]] = {}
        self.job_ready_fns: Dict[str, Callable[[JobInfo], JobReadiness]] = {}
        self.job_valid_fns: Dict[str, Callable[[JobInfo],
                                               Optional[ValidateResult]]] = {}
        self.backfill_eligible_fns: Dict[str, Callable[[JobInfo], bool]] = {}
        #: final AND-filters over victim lists, applied AFTER tier dispatch.
        #: Divergence from the reference: its per-tier intersection lets an
        #: EMPTY tier-1 intersection fall through to tier 2, where drf can
        #: select victims conformance vetoed — critical pods become
        #: evictable through the gap (session_plugins.go:99-102 nil
        #: fall-through). Safety vetoes registered here always hold.
        self.victim_veto_fns: Dict[str, EvictableFn] = {}

        #: device-side snapshot, built on first use by kernels.tensorize
        self.device_snapshot = None

        #: statements opened via statement() and not yet committed or
        #: discarded — CloseSession discards leftovers, so a mid-action
        #: fault can never leak half-applied evictions into write-back
        self.open_statements: List = []

        #: entities this session mutated in ways a fresh cache clone would
        #: not reproduce — folded into the cache's dirty sets when the
        #: snapshot is adopted as the next cycle's base (cache.py
        #: adopt_snapshot); touched nodes are also the device rows
        #: kernels/solver.ensure_device_snapshot refreshes. Every session
        #: mutator records here; missing a site breaks the
        #: incremental == full snapshot invariant.
        self.touched_jobs: set = set()
        self.touched_nodes: set = set()
        #: the victim SegmentStore this session took off an incremental
        #: cache (kernels/victims.py _segment_store); later victim builds
        #: of the session reuse it, adopt_snapshot hands it back
        self._victim_store = None

    # ------------------------------------------------------------------
    # plugin registration (ref: session_plugins.go:23-65)
    # ------------------------------------------------------------------
    def add_job_order_fn(self, name: str, fn: CompareFn) -> None:
        self.job_order_fns[name] = fn

    def add_queue_order_fn(self, name: str, fn: CompareFn) -> None:
        self.queue_order_fns[name] = fn

    def add_task_order_fn(self, name: str, fn: CompareFn) -> None:
        self.task_order_fns[name] = fn

    def add_predicate_fn(self, name: str, fn: PredicateFn) -> None:
        self.predicate_fns[name] = fn

    def add_node_order_fn(self, name: str, fn: NodeOrderFn) -> None:
        self.node_order_fns[name] = fn

    def add_preemptable_fn(self, name: str, fn: EvictableFn) -> None:
        self.preemptable_fns[name] = fn

    def add_reclaimable_fn(self, name: str, fn: EvictableFn) -> None:
        self.reclaimable_fns[name] = fn

    def add_overused_fn(self, name: str, fn) -> None:
        self.overused_fns[name] = fn

    def add_job_ready_fn(self, name: str, fn) -> None:
        self.job_ready_fns[name] = fn

    def add_job_valid_fn(self, name: str, fn) -> None:
        self.job_valid_fns[name] = fn

    def add_backfill_eligible_fn(self, name: str, fn) -> None:
        self.backfill_eligible_fns[name] = fn

    def add_victim_veto_fn(self, name: str, fn: EvictableFn) -> None:
        self.victim_veto_fns[name] = fn

    def add_event_handler(self, eh: EventHandler) -> None:
        self.event_handlers.append(eh)

    # ------------------------------------------------------------------
    # tiered dispatch (ref: session_plugins.go:67-370)
    # ------------------------------------------------------------------
    def _evictable(self, fns: Dict[str, EvictableFn], disabled_attr: str,
                   evictor: TaskInfo,
                   evictees: List[TaskInfo]) -> List[TaskInfo]:
        """Per-tier intersection of plugin victim lists; the first tier with
        a NON-EMPTY intersection decides (session_plugins.go:67-148 — in Go
        an empty intersection is a nil slice, so it falls through to the
        next tier exactly like no plugin answering)."""
        for tier in self.tiers:
            victims: Optional[List[TaskInfo]] = None
            for plugin in tier.plugins:
                if getattr(plugin, disabled_attr):
                    continue
                fn = fns.get(plugin.name)
                if fn is None:
                    continue
                candidates = fn(evictor, evictees) or []
                if victims is None:
                    victims = list(candidates)
                else:
                    cand_ids = {c.uid for c in candidates}
                    victims = [v for v in victims if v.uid in cand_ids]
            if victims:
                return self._apply_vetoes(evictor, victims)
        return []

    def _apply_vetoes(self, evictor: TaskInfo,
                      victims: List[TaskInfo]) -> List[TaskInfo]:
        for fn in self.victim_veto_fns.values():
            allowed = {t.uid for t in (fn(evictor, victims) or [])}
            victims = [v for v in victims if v.uid in allowed]
        return victims

    def reclaimable(self, reclaimer: TaskInfo,
                    reclaimees: List[TaskInfo]) -> List[TaskInfo]:
        return self._evictable(self.reclaimable_fns, "reclaimable_disabled",
                               reclaimer, reclaimees)

    def preemptable(self, preemptor: TaskInfo,
                    preemptees: List[TaskInfo]) -> List[TaskInfo]:
        return self._evictable(self.preemptable_fns, "preemptable_disabled",
                               preemptor, preemptees)

    def overused(self, queue: QueueInfo) -> bool:
        """Any plugin true (session_plugins.go:150-164; no disable flag)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.overused_fns.get(plugin.name)
                if fn is not None and fn(queue):
                    return True
        return False

    def _job_readiness(self, job) -> JobReadiness:
        """First registered job-ready fn wins (session_plugins.go:167-207).
        The tier walk is memoized — job_ready runs once per allocation, and
        plugins only register fns during OnSessionOpen."""
        fn = getattr(self, "_ready_fn_memo", False)
        if fn is False:
            fn = None
            for tier in self.tiers:
                for plugin in tier.plugins:
                    if plugin.job_ready_disabled:
                        continue
                    f = self.job_ready_fns.get(plugin.name)
                    if f is not None:
                        fn = f
                        break
                if fn is not None:
                    break
            self._ready_fn_memo = fn
        if fn is not None:
            return fn(job)
        return JobReadiness.READY

    def job_ready(self, job) -> bool:
        return self._job_readiness(job) == JobReadiness.READY

    def job_almost_ready(self, job) -> bool:
        # NB: reference defaults to AlmostReady when no fn is registered
        # (session_plugins.go:189) — with no fn, both job_ready and
        # job_almost_ready report True-ish defaults; we mirror that.
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.job_ready_disabled:
                    continue
                fn = self.job_ready_fns.get(plugin.name)
                if fn is not None:
                    return fn(job) == JobReadiness.ALMOST_READY
        return True

    def backfill_eligible(self, job) -> bool:
        """Any plugin true (session_plugins.go:209-224)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.backfill_eligible_fns.get(plugin.name)
                if fn is not None and fn(job):
                    return True
        return False

    def job_valid(self, job) -> Optional[ValidateResult]:
        """First failure wins (session_plugins.go:226-242)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                fn = self.job_valid_fns.get(plugin.name)
                if fn is None:
                    continue
                vr = fn(job)
                if vr is not None and not vr.passed:
                    return vr
        return None

    def job_order_fn(self, l: JobInfo, r: JobInfo) -> bool:
        """True iff l should come before r (session_plugins.go:244-268)."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.job_order_disabled:
                    continue
                fn = self.job_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        if l.creation_timestamp == r.creation_timestamp:
            return l.uid < r.uid
        return l.creation_timestamp < r.creation_timestamp

    def queue_order_fn(self, l: QueueInfo, r: QueueInfo) -> bool:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.queue_order_disabled:
                    continue
                fn = self.queue_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j < 0
        return l.uid < r.uid

    def task_compare_fns(self, l: TaskInfo, r: TaskInfo) -> int:
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.task_order_disabled:
                    continue
                fn = self.task_order_fns.get(plugin.name)
                if fn is None:
                    continue
                j = fn(l, r)
                if j != 0:
                    return j
        return 0

    def task_order_fn(self, l: TaskInfo, r: TaskInfo) -> bool:
        res = self.task_compare_fns(l, r)
        if res != 0:
            return res < 0
        if l.pod.creation_timestamp == r.pod.creation_timestamp:
            return l.uid < r.uid
        return l.pod.creation_timestamp < r.pod.creation_timestamp

    def predicate_fn(self, task: TaskInfo, node: NodeInfo) -> None:
        """AND of all enabled plugins; first error propagates
        (session_plugins.go:331-348). Raises PredicateError to reject."""
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.predicate_disabled:
                    continue
                fn = self.predicate_fns.get(plugin.name)
                if fn is not None:
                    fn(task, node)

    def node_order_fn(self, task: TaskInfo, node: NodeInfo) -> float:
        """Sum of all enabled plugins' scores (session_plugins.go:350-370)."""
        score = 0.0
        for tier in self.tiers:
            for plugin in tier.plugins:
                if plugin.node_order_disabled:
                    continue
                fn = self.node_order_fns.get(plugin.name)
                if fn is not None:
                    score += fn(task, node)
        return score

    def total_allocatable(self):
        """Sum of node allocatable over the snapshot, computed once per
        session — drf and proportion each summed all nodes at open
        (drf.go:59-60, proportion.go:52-53); the value is identical, so
        they share one walk."""
        total = getattr(self, "_total_allocatable", None)
        if total is None:
            total = self._snapshot_allocatable_total
            if total is None:       # snapshot predates the maintained sum
                from ..api import Resource
                total = Resource.empty()
                for node in self.nodes.values():
                    total.add(node.allocatable)
            self._total_allocatable = total
        # clone: Resource's chaining API mutates in place — handing out
        # the cached object would let one caller corrupt every later one
        return total.clone()

    # ------------------------------------------------------------------
    # session mutators (ref: session.go:193-357)
    # ------------------------------------------------------------------
    def statement(self):
        from .statement import Statement
        st = Statement(self)
        self.open_statements.append(st)
        return st

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """Session-only assignment onto releasing resources
        (ref: session.go:199-235)."""
        self.touched_jobs.add(task.job)
        self.touched_nodes.add(hostname)
        job = self.jobs.get(task.job)
        if job is not None:
            # CoW: the caller's reference may still point at the shared
            # clone twin — resolve to this job's canonical object before
            # the first attribute write (JobInfo.own_task)
            task = job.own_task(task)
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self._fire_allocate(task)

    def allocate(self, task: TaskInfo, hostname: str,
                 using_backfill_task_res: bool = False) -> None:
        """Assign task to host within the session; dispatch the whole job
        once it reaches Ready — the gang barrier (ref: session.go:237-297)."""
        # CoW resolution BEFORE any write — allocate_volumes already
        # mutates the task (volume_ready), so the job lookup moves ahead
        # of it (owning a map is not a semantic mutation; a pre-mutation
        # volume failure still leaves the session untouched)
        job = self.jobs.get(task.job)
        if job is None:
            raise KeyError(f"failed to find job {task.job}")
        task = job.own_task(task)
        try:
            self.cache.allocate_volumes(task, hostname)
        except Exception as e:
            raise VolumeAllocationError(str(e)) from e
        self.touched_jobs.add(task.job)
        self.touched_nodes.add(hostname)
        new_status = (TaskStatus.ALLOCATED_OVER_BACKFILL
                      if using_backfill_task_res else TaskStatus.ALLOCATED)
        if using_backfill_task_res:
            # session-only reservation over lent capacity; counted here
            # so every entry path (allocate visit, device kernels,
            # backfill over-reserve) lands in the same ledger
            count_backfill_over_placement()
        job.update_task_status(task, new_status)
        task.node_name = hostname
        node = self.nodes.get(hostname)
        if node is None:
            raise KeyError(f"failed to find node {hostname}")
        node.add_task(task)
        self._fire_allocate(task)
        if self.job_ready(job):
            for t in list(job.task_status_index.get(TaskStatus.ALLOCATED,
                                                    {}).values()):
                self.dispatch(t)

    def dispatch(self, task: TaskInfo) -> None:
        """Bind an allocated task for real (ref: session.go:299-321)."""
        self.touched_jobs.add(task.job)
        job = self.jobs.get(task.job)
        if job is not None:
            task = job.own_task(task)   # CoW (see pipeline)
        self.cache.bind_volumes(task)
        self.cache.bind(task, task.node_name)
        if job is not None:
            job.update_task_status(task, TaskStatus.BINDING)
        # creation -> bind latency (ref: session.go:319)
        update_task_schedule_duration(
            max(0.0, _time.time() - task.pod.creation_timestamp))

    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """Real eviction through the cache plus session bookkeeping
        (ref: session.go:323-357)."""
        self.touched_jobs.add(reclaimee.job)
        self.touched_nodes.add(reclaimee.node_name)
        job = self.jobs.get(reclaimee.job)
        if job is not None:
            reclaimee = job.own_task(reclaimee)   # CoW (see pipeline)
        self.cache.evict(reclaimee, reason)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self._fire_deallocate(reclaimee)

    def update_job_condition(self, job_info: JobInfo,
                             cond: PodGroupCondition) -> None:
        """ref: session.go:360-382."""
        # a condition stamp IS a status mutation: the close-session
        # write-skip must not bypass this job's PUT/events, and the next
        # snapshot re-clones it
        self.touched_jobs.add(job_info.uid)
        job = self.jobs.get(job_info.uid)
        if job is None:
            raise KeyError(f"failed to find job "
                           f"<{job_info.namespace}/{job_info.name}>")
        conds = job.pod_group.status.conditions
        for i, c in enumerate(conds):
            if c.type == cond.type:
                conds[i] = cond
                return
        conds.append(cond)

    def _fire_allocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.allocate_func is not None:
                eh.allocate_func(Event(task))

    def _fire_deallocate(self, task: TaskInfo) -> None:
        for eh in self.event_handlers:
            if eh.deallocate_func is not None:
                eh.deallocate_func(Event(task))


def open_session(cache, enable_preemption: bool = False,
                 snapshot: Optional[ClusterInfo] = None) -> Session:
    """Snapshot the cache and drop gang-invalid jobs
    (ref: session.go:66-122). ``snapshot`` lets tests supply a snapshot
    taken moments earlier (e.g. to compare incremental vs full cloning)."""
    ssn = Session(cache, snapshot if snapshot is not None
                  else cache.snapshot(), enable_preemption)
    return ssn


def validate_jobs(ssn: Session) -> None:
    """Apply JobValid and drop failing jobs after stamping an Unschedulable
    condition on their (session-local) PodGroup (ref: session.go:92-111).
    Called after plugins install their job_valid fns.

    Verdicts are memoized across cycles over ``cache.plugin_scratch``:
    validity reads only job truth, so a verdict holds while the job's
    clone is reused by the folded snapshot. Failing jobs re-stamp their
    condition each cycle (the stamp marks them touched, so they are
    refreshed, and re-validated, next cycle)."""
    scratch = ssn.cache.plugin_scratch
    fingerprint = tuple(opt.name for tier in ssn.tiers
                        for opt in tier.plugins)
    state = scratch.get("job_valid")
    refreshed = ssn.refreshed_jobs
    if (state is None or refreshed is None
            or state["fingerprint"] != fingerprint):
        memo: Dict[str, Optional[ValidateResult]] = {}
        recheck = list(ssn.jobs)
    else:
        memo = state["memo"]
        for uid in list(memo):
            if uid not in ssn.jobs:
                del memo[uid]
        recheck = [uid for uid in ssn.jobs
                   if uid in refreshed or uid not in memo]
    for uid in recheck:
        memo[uid] = ssn.job_valid(ssn.jobs[uid])
    scratch["job_valid"] = {"memo": memo, "fingerprint": fingerprint}
    for uid, vr in memo.items():
        if vr is None or vr.passed:
            continue
        job = ssn.jobs.get(uid)
        if job is None:
            continue
        # a dropped job leaves ssn.jobs, and adoption stores ssn.jobs as
        # the next snapshot base — mark it touched so the next cycle
        # re-clones it from truth
        ssn.touched_jobs.add(uid)
        if job.pod_group is not None:
            cond = PodGroupCondition(
                type=UNSCHEDULABLE_CONDITION, status="True",
                transition_id=ssn.uid, reason=vr.reason,
                message=vr.message)
            try:
                ssn.update_job_condition(job, cond)
            except KeyError:
                pass
        del ssn.jobs[uid]


def job_status(ssn: Session, job: JobInfo) -> PodGroupStatus:
    """Recompute PodGroup status at session close (ref: session.go:158-191)."""
    status = job.pod_group.status
    unschedulable = any(
        c.type == UNSCHEDULABLE_CONDITION and c.status == "True"
        and c.transition_id == ssn.uid
        for c in status.conditions)
    if job.count(TaskStatus.RUNNING) != 0 and unschedulable:
        status.phase = PodGroupPhase.UNKNOWN
    elif job.get_readiness() == JobReadiness.READY:
        status.phase = PodGroupPhase.RUNNING
    else:
        status.phase = PodGroupPhase.PENDING
    status.running = job.count(TaskStatus.RUNNING)
    status.failed = job.count(TaskStatus.FAILED)
    status.succeeded = job.count(TaskStatus.SUCCEEDED)
    return status


def close_session(ssn: Session) -> None:
    """Write job status back through the cache (ref: session.go:124-156).

    Jobs the session never mutated AND whose clone was reused from the
    previous cycle (truth unchanged) AND that hold no pending/allocated
    work recompute to an identical status with no events to emit — the
    write is skipped. Full snapshots (refreshed = None) write every job,
    matching the reference cycle for cycle."""
    scheduled = 0
    unschedulable = 0
    refreshed = ssn.refreshed_jobs
    touched = ssn.touched_jobs
    for uid, job in ssn.jobs.items():
        pending = job.count(TaskStatus.PENDING)
        scheduled += job.count(TaskStatus.BINDING)
        unschedulable += pending
        if job.pod_group is None:
            ssn.cache.record_job_status_event(job)
            continue
        if (refreshed is not None and uid not in refreshed
                and uid not in touched and pending == 0
                and TaskStatus.ALLOCATED not in job.task_status_index
                and TaskStatus.ALLOCATED_OVER_BACKFILL
                not in job.task_status_index):
            continue
        job.pod_group.status = job_status(ssn, job)
        ssn.cache.update_job_status(job)
    # per-cycle attempt results (ref: metrics.go schedule_attempts_total;
    # results follow the upstream scheduler's vocabulary)
    update_pod_schedule_status("scheduled", scheduled)
    update_pod_schedule_status("unschedulable", unschedulable)
    # hand the session's clones back as the next snapshot's base (the
    # incremental-snapshot protocol)
    ssn.cache.adopt_snapshot(ssn)
    ssn.jobs = {}
    ssn.nodes = {}
    ssn.queues = {}
    ssn.backlog = []
    ssn.plugins = {}
    ssn.event_handlers = []
    ssn.device_snapshot = None
    ssn.open_statements = []
