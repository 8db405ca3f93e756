"""TaskInfo / JobInfo — per-pod and per-PodGroup aggregates.

ref: pkg/scheduler/api/job_info.go, pod_info.go.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from ..objects import (Pod, PodDisruptionBudget, PodGroup, PodPhase,
                       is_backfill_pod)
from .resource import Resource
from .types import (JobReadiness, TaskStatus, allocated_status,
                    allocated_statuses, validate_status_update)


def pod_key(pod: Pod) -> str:
    """'namespace/name' task key (ref: api/helpers.go:27-33)."""
    return f"{pod.namespace}/{pod.name}"


def get_task_status(pod: Pod) -> TaskStatus:
    """Pod phase -> TaskStatus (ref: api/helpers.go:35-61)."""
    if pod.phase == PodPhase.RUNNING:
        return (TaskStatus.RELEASING if pod.deletion_timestamp is not None
                else TaskStatus.RUNNING)
    if pod.phase == PodPhase.PENDING:
        if pod.deletion_timestamp is not None:
            return TaskStatus.RELEASING
        return TaskStatus.PENDING if not pod.node_name else TaskStatus.BOUND
    if pod.phase == PodPhase.SUCCEEDED:
        return TaskStatus.SUCCEEDED
    if pod.phase == PodPhase.FAILED:
        return TaskStatus.FAILED
    return TaskStatus.UNKNOWN


def get_pod_resource_without_init_containers(pod: Pod) -> Resource:
    """Sum of app-container requests (ref: api/pod_info.go:71-80)."""
    result = Resource.empty()
    for c in pod.containers:
        result.add(Resource.from_resource_list(c.requests))
    return result


def get_pod_resource_request(pod: Pod) -> Resource:
    """max(sum of containers, each init container) per dimension — init
    containers run sequentially (ref: api/pod_info.go:33-69)."""
    result = get_pod_resource_without_init_containers(pod)
    for c in pod.init_containers:
        result.set_max(Resource.from_resource_list(c.requests))
    return result


def get_job_id(pod: Pod) -> str:
    """'namespace/group-name' from the group annotation, else ''
    (ref: job_info.go:60-70)."""
    gn = pod.group_name
    return f"{pod.namespace}/{gn}" if gn else ""


class TaskInfo:
    """Scheduling view of one pod (ref: job_info.go:36-131)."""

    __slots__ = ("uid", "job", "name", "namespace", "resreq", "init_resreq",
                 "node_name", "status", "priority", "volume_ready", "pod",
                 "is_backfill", "key")

    def __init__(self, pod: Pod):
        self.uid: str = pod.uid
        self.job: str = get_job_id(pod)
        self.name: str = pod.name
        self.namespace: str = pod.namespace
        #: 'namespace/name' node-map key, precomputed — node add/remove and
        #: the bulk replay build it per placement otherwise
        self.key: str = pod_key(pod)
        #: steady-state request (app containers only)
        self.resreq: Resource = get_pod_resource_without_init_containers(pod)
        #: launch-time request (max with init containers) — what predicates use
        self.init_resreq: Resource = get_pod_resource_request(pod)
        self.node_name: str = pod.node_name
        self.status: TaskStatus = get_task_status(pod)
        self.priority: int = pod.priority if pod.priority is not None else 1
        self.volume_ready: bool = False
        self.pod: Pod = pod
        self.is_backfill: bool = is_backfill_pod(pod)

    def clone(self) -> "TaskInfo":
        t = object.__new__(TaskInfo)
        t.uid = self.uid
        t.job = self.job
        t.name = self.name
        t.namespace = self.namespace
        # request vectors are immutable after construction (all arithmetic
        # happens on node/job aggregates, never on a task's own vectors), so
        # clones SHARE them — a task clone runs O(tasks) per snapshot and
        # again per node placement, and the two Resource copies dominated it
        t.resreq = self.resreq
        t.init_resreq = self.init_resreq
        t.node_name = self.node_name
        t.status = self.status
        t.priority = self.priority
        t.volume_ready = self.volume_ready
        t.pod = self.pod
        t.is_backfill = self.is_backfill
        t.key = self.key
        return t

    def __repr__(self) -> str:
        return (f"Task({self.namespace}/{self.name}: job={self.job}, "
                f"status={self.status}, pri={self.priority}, "
                f"resreq={self.resreq}, backfill={self.is_backfill})")


#: sentinel: the clone-priority memo needs recomputing (see JobInfo)
_PRIO_UNSET = object()


class JobInfo:
    """PodGroup-level aggregate (ref: job_info.go:140-388)."""

    def __init__(self, uid: str, *tasks: TaskInfo):
        self.uid: str = uid
        self.name: str = ""
        self.namespace: str = ""
        self.queue: str = ""
        self.priority: int = 0
        self.node_selector: Dict[str, str] = {}
        self.min_available: int = 0
        #: elastic desired membership (>= min_available when set; 0 means
        #: fixed-size — desired == min_available)
        self.max_available: int = 0
        #: node -> fit-delta Resource for unschedulable diagnostics
        self.nodes_fit_delta: Dict[str, Resource] = {}
        self.tasks: Dict[str, TaskInfo] = {}
        self.task_status_index: Dict[TaskStatus, Dict[str, TaskInfo]] = {}
        #: True while tasks/task_status_index (dicts AND TaskInfo
        #: objects) are shared with a clone twin — see clone()/_own_tasks
        self._tasks_shared: bool = False
        self.allocated: Resource = Resource.empty()
        self.total_request: Resource = Resource.empty()
        #: count of tasks whose pod carries inter-pod (anti-)affinity —
        #: lets dynamic-feature detection skip the per-task walk
        self.affinity_tasks: int = 0
        self.creation_timestamp: float = 0.0
        self.pod_group: Optional[PodGroup] = None
        self.pdb: Optional[PodDisruptionBudget] = None
        #: memo of clone()'s explicit-priority restamp walk: the
        #: priority of the LAST task (in dict order) whose pod carries
        #: an explicit priority, None when no task does, _PRIO_UNSET
        #: when it must be recomputed. Maintained by the task mutators
        #: so the steady-regime clone is O(1) instead of O(tasks) — the
        #: per-task walk was the open-phase dominator at 10k pods.
        self._prio_memo: object = None
        for t in tasks:
            self.add_task_info(t)

    # --- PodGroup binding -------------------------------------------------
    def set_pod_group(self, pg: PodGroup) -> None:
        self.name = pg.name
        self.namespace = pg.namespace
        self.min_available = pg.min_member
        self.max_available = getattr(pg, "max_member", 0) or 0
        self.queue = pg.queue
        self.creation_timestamp = pg.creation_timestamp
        self.pod_group = pg

    def unset_pod_group(self) -> None:
        self.pod_group = None

    def set_pdb(self, pdb: PodDisruptionBudget) -> None:
        """Legacy grouping path (ref: job_info.go:204-211)."""
        self.name = pdb.name
        self.namespace = pdb.namespace
        self.min_available = pdb.min_available
        self.creation_timestamp = pdb.creation_timestamp
        self.pdb = pdb

    def unset_pdb(self) -> None:
        self.pdb = None

    # --- task map copy-on-write ------------------------------------------
    def _own_tasks(self) -> None:
        """Materialize a private task map + status index before the first
        mutation: clone every TaskInfo (one batched pass,
        kernels/tensorize.batch_clone_tasks) and rebuild both dicts around the clones. Until
        this runs, the dicts AND task objects are shared with the clone
        twin (see clone()) — job-held tasks are mutated IN PLACE by the
        session/cache mutators (status flips, node_name, volume_ready),
        so unlike NodeInfo's dict-level CoW the task objects themselves
        must be privatized. Every JobInfo mutator owns first; code that
        writes task attributes directly (session/statement mutators,
        the bulk replays, cache bind/evict) resolves its reference
        through own_task() before the first write — a direct write to a
        pre-ownership reference corrupts the other side's snapshot."""
        if not self._tasks_shared:
            return
        self._tasks_shared = False
        old = self.tasks
        if not old:
            self.tasks = {}
            self.task_status_index = {}
            return
        from ..kernels.tensorize import batch_clone_tasks
        values = list(old.values())
        clones = batch_clone_tasks(values, [t.status for t in values],
                                   [t.node_name for t in values])
        tasks = dict(zip(old.keys(), clones))
        self.tasks = tasks
        self.task_status_index = {
            status: {uid: tasks[uid] for uid in bucket}
            for status, bucket in self.task_status_index.items()}

    def own_task(self, task: TaskInfo) -> TaskInfo:
        """CoW resolution: own the map and return THIS job's canonical
        object for ``task`` (a caller's reference may predate ownership
        and still point at the shared twin). Mutators must write through
        the returned object."""
        self._own_tasks()
        return self.tasks.get(task.uid, task)

    # --- task index maintenance (ref: job_info.go:231-292) ---------------
    def _add_task_index(self, ti: TaskInfo) -> None:
        self.task_status_index.setdefault(ti.status, {})[ti.uid] = ti

    def add_task_info(self, ti: TaskInfo) -> None:
        self._own_tasks()
        if ti.uid in self.tasks:
            # replacing an existing key keeps its dict position, so the
            # last-explicit-priority walk result can shift — recompute
            self._prio_memo = _PRIO_UNSET
        elif ti.pod.priority is not None:
            # appended last in dict order: it IS the new walk result
            self._prio_memo = ti.priority
        self.tasks[ti.uid] = ti
        self._add_task_index(ti)
        # Only an explicit pod priority overrides the job's priority; the
        # reference overwrites unconditionally (job_info.go:242) because in
        # real k8s admission always stamps pod.Spec.Priority — here a None
        # must not clobber the priority-class value stamped by snapshot().
        if ti.pod.priority is not None:
            self.priority = ti.priority
        self.total_request.add(ti.resreq)
        if allocated_status(ti.status):
            self.allocated.add(ti.resreq)
        if ti.pod.has_pod_affinity():
            self.affinity_tasks += 1

    def delete_task_info(self, ti: TaskInfo) -> None:
        self._own_tasks()
        task = self.tasks.get(ti.uid)
        if task is None:
            raise KeyError(
                f"failed to find task <{ti.namespace}/{ti.name}> in job "
                f"<{self.namespace}/{self.name}>")
        self.total_request.sub(task.resreq)
        if allocated_status(task.status):
            self.allocated.sub(task.resreq)
        if task.pod.has_pod_affinity():
            self.affinity_tasks -= 1
        if task.pod.priority is not None:
            # the removed task may have been the walk's last explicit
            # entry; removing a non-explicit task can't change it
            self._prio_memo = _PRIO_UNSET
        del self.tasks[task.uid]
        index = self.task_status_index.get(task.status)
        if index is not None:
            index.pop(task.uid, None)
            if not index:
                del self.task_status_index[task.status]

    def update_task_status(self, task: TaskInfo, status: TaskStatus) -> None:
        """Semantically delete_task_info + add_task_info (ref:
        job_info.go:251-259), flattened: the status flip is the hottest
        operation of the decision replay (10k+ per cycle at the stress
        config), so the net-zero total_request sub/add and the task-dict
        delete/re-insert are skipped when the stored task IS the incoming
        one (also avoiding float round-trip drift the naive pair has).

        CoW note: a ``task`` reference that predates an ownership
        (whether THIS call or an earlier one materialized the private
        map) points at the shared twin of the stored clone — the
        mutation is redirected to the canonical stored object so the
        twin's (or another snapshot's) map is neither mutated nor
        re-aliased. Twins are recognized by sharing the stored clone's
        ``resreq`` OBJECT (every clone path shares request vectors); a
        genuinely different TaskInfo for the same uid keeps the legacy
        replace-the-entry semantics. Callers that keep writing through
        their own reference must resolve it first (own_task)."""
        validate_status_update(task.status, status)
        self._own_tasks()
        stored = self.tasks.get(task.uid)
        if stored is not None and stored is not task \
                and stored.resreq is task.resreq:
            # pre-ownership twin of the stored clone — mutate the clone,
            # not the shared original backing the other side's snapshot
            task = stored
        if stored is None:
            raise KeyError(
                f"failed to find task <{task.namespace}/{task.name}> in job "
                f"<{self.namespace}/{self.name}>")
        if allocated_status(stored.status):
            self.allocated.sub(stored.resreq)
        if stored is not task:
            # legacy replace-the-entry path: a genuinely different
            # TaskInfo lands under the uid — the priority walk result
            # may change with it
            self._prio_memo = _PRIO_UNSET
            self.total_request.sub(stored.resreq)
            self.total_request.add(task.resreq)
        index = self.task_status_index.get(stored.status)
        if index is not None:
            index.pop(stored.uid, None)
            if not index:
                del self.task_status_index[stored.status]
        task.status = status
        self.tasks[task.uid] = task
        self._add_task_index(task)
        if task.pod.priority is not None:
            self.priority = task.priority
        if allocated_status(status):
            self.allocated.add(task.resreq)

    def get_tasks(self, *statuses: TaskStatus) -> List[TaskInfo]:
        """Clones of tasks in the given states (ref: job_info.go:217-229)."""
        res: List[TaskInfo] = []
        for status in statuses:
            for task in self.task_status_index.get(status, {}).values():
                res.append(task.clone())
        return res

    def count(self, *statuses: TaskStatus) -> int:
        # hot at session close (8+ calls per job per cycle): plain loop,
        # no default-dict allocation, no generator frame
        idx = self.task_status_index
        if len(statuses) == 1:
            bucket = idx.get(statuses[0])
            return len(bucket) if bucket else 0
        n = 0
        for s in statuses:
            bucket = idx.get(s)
            if bucket:
                n += len(bucket)
        return n

    @property
    def desired_members(self) -> int:
        """Elastic desired size: max_member when set, else min_member."""
        return max(self.min_available, self.max_available)

    # --- readiness (fork semantics, ref: job_info.go:374-388) -------------
    def get_readiness(self) -> JobReadiness:
        allocated_cnt = self.count(*allocated_statuses())
        if allocated_cnt >= self.min_available:
            return JobReadiness.READY
        over_backfill_cnt = self.count(TaskStatus.ALLOCATED_OVER_BACKFILL)
        if allocated_cnt + over_backfill_cnt >= self.min_available:
            return JobReadiness.ALMOST_READY
        return JobReadiness.NOT_READY

    def fit_error(self) -> str:
        """Human-readable unschedulable explanation
        (ref: job_info.go:343-372)."""
        if not self.nodes_fit_delta:
            return "0 nodes are available"
        reasons: Dict[str, int] = {}
        for delta in self.nodes_fit_delta.values():
            if delta.milli_cpu < 0:
                reasons["cpu"] = reasons.get("cpu", 0) + 1
            if delta.memory < 0:
                reasons["memory"] = reasons.get("memory", 0) + 1
            if delta.milli_gpu < 0:
                reasons["GPU"] = reasons.get("GPU", 0) + 1
        parts = sorted(f"{v} insufficient {k}" for k, v in reasons.items())
        return (f"0/{len(self.nodes_fit_delta)} nodes are available, "
                f"{', '.join(parts)}.")

    def clone(self) -> "JobInfo":
        """Deep copy (ref: job_info.go:294-326) with a COPY-ON-WRITE task
        map: the clone shares the task dicts AND TaskInfo objects with
        the source, and whichever side mutates first materializes a
        private deep copy (_own_tasks) — the other side keeps the shared
        originals untouched. In the steady regime most refreshed jobs
        are fully Running and never mutated by the session, so their
        per-task clone cost (the dominant open-phase term per
        docs/SCALING.md) drops to two dict references. Equivalence with
        the eager deep copy is pinned by the incremental-snapshot
        oracle (debug.snapshot_diff == 0 in tests).

        The reference's quirk — tasks carrying an explicit pod priority
        re-stamp the job priority in insertion order — is preserved via
        the maintained ``_prio_memo`` (the walk's last explicit value),
        so the steady-regime clone is O(1): the per-task walk only runs
        when a mutation invalidated the memo (that walk was the
        open-phase dominator at 10k pods)."""
        info = JobInfo(self.uid)
        info.name = self.name
        info.namespace = self.namespace
        info.queue = self.queue
        info.priority = self.priority
        info.min_available = self.min_available
        info.max_available = self.max_available
        info.node_selector = dict(self.node_selector)
        info.creation_timestamp = self.creation_timestamp
        info.pod_group = self.pod_group
        info.pdb = self.pdb
        info.tasks = self.tasks
        info.task_status_index = self.task_status_index
        info._tasks_shared = True
        self._tasks_shared = True
        restamp = self._prio_memo
        if restamp is _PRIO_UNSET:
            restamp = None
            for t in self.tasks.values():
                if t.pod.priority is not None:
                    restamp = t.priority
            self._prio_memo = restamp
        if restamp is not None:
            info.priority = restamp
        info._prio_memo = restamp
        info.allocated = self.allocated.clone()
        info.total_request = self.total_request.clone()
        info.affinity_tasks = self.affinity_tasks
        return info

    def __repr__(self) -> str:
        return (f"Job({self.uid}): ns={self.namespace} queue={self.queue} "
                f"name={self.name} minAvailable={self.min_available} "
                f"tasks={len(self.tasks)}")


def job_terminated(job: JobInfo) -> bool:
    """ref: api/helpers.go:99-104."""
    return job.pod_group is None and job.pdb is None and not job.tasks
