"""SchedulerCache — the cluster-state mirror between sessions.

ref: pkg/scheduler/cache/cache.go + event_handlers.go + util.go.

- Event ingestion is a plain method surface (``add_pod``/``update_node``/...)
  fed by any event source (the synthetic ``sim`` cluster here).
- Decision write-back (bind/evict/status) updates local state under the
  lock, then fires the seam call, on a thread pool when
  ``async_writeback`` is set. Failures enqueue the task on a rate-limited
  retry queue; ``drain()`` pumps it (``sync_task`` re-fetches ground truth
  and replays the cache update, ref event_handlers.go:88-106) and is the
  deterministic barrier for tests and benchmarks.
- ``snapshot()`` deep-clones into an immutable-by-convention ClusterInfo
  every cycle (ref cache.go:515-583): the snapshot-primary mode. The
  incremental event fold of the reference package is not part of this
  package yet, so ``incremental_snapshot=True`` is refused.
- ``device`` names where the cycle's device arrays live
  (``device_session``); it defaults to the CUDA card and raises at
  construction when that is asked for and absent.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from concurrent.futures import TimeoutError as FuturesTimeoutError
from typing import Callable, Dict, List, Optional, Tuple

from ..api import (ClusterInfo, JobInfo, NodeInfo, QueueInfo, Resource,
                   TaskInfo, TaskStatus, allocated_status, job_terminated)
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device
from ..objects import (Node, Pod, PodDisruptionBudget, PodGroup,
                       PodGroupPhase, PodPhase, PriorityClass, Queue,
                       UNSCHEDULABLE_CONDITION, is_backfill_pod)
from .interface import (Binder, EventRecorder, Evictor, ListRecorder,
                        NullBinder, NullEvictor, NullStatusUpdater,
                        NullVolumeBinder, StatusUpdater, VolumeBinder)

SHADOW_POD_GROUP_KEY = "kube-batch/shadow-pod-group"

#: retry backoff: base * 2^retries seconds, capped
RETRY_BASE_DELAY = 0.005
RETRY_MAX_DELAY = 10.0


def shadow_pod_group(pg: Optional[PodGroup]) -> bool:
    """ref: cache/util.go:104-111 (nil PodGroup counts as shadow)."""
    return pg is None or SHADOW_POD_GROUP_KEY in pg.annotations


def create_shadow_pod_group(pod: Pod) -> PodGroup:
    """Implicit single-member gang for ownerless/ungrouped pods
    (ref: cache/util.go:113-136)."""
    job_id = pod.owner_uid or pod.uid
    return PodGroup(name=str(job_id), namespace=pod.namespace, min_member=1,
                    annotations={SHADOW_POD_GROUP_KEY: str(job_id)})


def _is_terminated(status: TaskStatus) -> bool:
    return status in (TaskStatus.SUCCEEDED, TaskStatus.FAILED)


class RetryQueue:
    """Rate-limited retry queue (the workqueue.RateLimiting equivalent).
    Items become due after base * 2^retries seconds, capped."""

    def __init__(self, base_delay: float = RETRY_BASE_DELAY,
                 max_delay: float = RETRY_MAX_DELAY):
        self._items: deque = deque()
        self._retries: Dict[int, int] = {}
        self._base = base_delay
        self._max = max_delay
        self._lock = threading.Lock()

    def add_rate_limited(self, item) -> None:
        with self._lock:
            n = self._retries.get(id(item), 0)
            self._retries[id(item)] = n + 1
            delay = min(self._base * (2 ** n), self._max)
            self._items.append((time.monotonic() + delay, item))

    def forget(self, item) -> None:
        with self._lock:
            self._retries.pop(id(item), None)

    def pop_due(self) -> List:
        now = time.monotonic()
        due, later = [], deque()
        with self._lock:
            for ready_at, item in self._items:
                (due if ready_at <= now else later).append((ready_at, item))
            self._items = deque(later)
        return [item for _, item in due]

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def next_due_in(self) -> Optional[float]:
        with self._lock:
            if not self._items:
                return None
            return max(0.0, min(t for t, _ in self._items) - time.monotonic())


class SchedulerCache:
    """ref: cache/cache.go:70-105."""

    def __init__(self,
                 scheduler_name: str = "kube-batch",
                 default_queue: str = "default",
                 binder: Optional[Binder] = None,
                 evictor: Optional[Evictor] = None,
                 status_updater: Optional[StatusUpdater] = None,
                 volume_binder: Optional[VolumeBinder] = None,
                 recorder: Optional[EventRecorder] = None,
                 pod_lister: Optional[Callable[[str, str], Optional[Pod]]] = None,
                 async_writeback: bool = True,
                 incremental_snapshot: bool = False,
                 device: DeviceLike = DEFAULT_DEVICE):
        if incremental_snapshot:
            raise NotImplementedError(
                "incremental_snapshot=True needs the event fold, which this "
                "package does not have yet (ROADMAP: event fold)")
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        self.scheduler_name = scheduler_name
        self.default_queue = default_queue

        self.jobs: Dict[str, JobInfo] = {}
        self.nodes: Dict[str, NodeInfo] = {}
        self.queues: Dict[str, QueueInfo] = {}
        self.priority_classes: Dict[str, PriorityClass] = {}
        self.default_priority_class: Optional[PriorityClass] = None
        self.default_priority: int = 0

        self.binder = binder if binder is not None else NullBinder()
        self.evictor = evictor if evictor is not None else NullEvictor()
        self.status_updater = (status_updater if status_updater is not None
                               else NullStatusUpdater())
        self.volume_binder = (volume_binder if volume_binder is not None
                              else NullVolumeBinder())
        self.recorder = recorder if recorder is not None else ListRecorder()

        #: ground-truth pod lookup for the resync repair loop; None means
        #: "replay from the task's own pod" (no external source of truth)
        self.pod_lister = pod_lister

        self.err_tasks = RetryQueue()
        self.deleted_jobs = RetryQueue()

        #: bumped on node shape changes; a TermsCache built by a session
        #: whose snapshot predates the change is refused persistence
        self._shape_epoch = 0
        self._handout_shape_epoch = 0
        #: persistent static-term encoder state (kernels/encode.TermsCache);
        #: invalidated whenever node labels/taints/shape change
        self.terms_cache = None
        #: per-cache sticky shape holds (kernels/tensorize.sticky_bucket)
        self.pad_sticky: Dict[str, list] = {}
        #: maintained sum of node allocatable over the cluster
        self._alloc_total: Optional[Resource] = None
        #: bumped whenever the node iteration order can change
        self._node_order_epoch = 0

        self._pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=8,
                               thread_name_prefix="kb-writeback")
            if async_writeback else None)
        self._inflight: set = set()
        self._inflight_lock = threading.Lock()

    def stop(self) -> None:
        """Shut the write-back pool down (in-flight binds finish). The
        retry queues are pumped by drain(); the reference's background
        repair worker comes with the scheduler loop."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    # ------------------------------------------------------------------
    # write-back plumbing
    # ------------------------------------------------------------------
    def _submit(self, fn: Callable[[], None]) -> None:
        if self._pool is not None:
            fut: Future = self._pool.submit(fn)
            with self._inflight_lock:
                self._inflight.add(fut)
            fut.add_done_callback(self._discard_inflight)
        else:
            fn()

    def _discard_inflight(self, fut: Future) -> None:
        with self._inflight_lock:
            self._inflight.discard(fut)

    def drain(self, timeout: float = 5.0) -> bool:
        """Barrier: wait for in-flight write-backs and due retries. Returns
        False on timeout."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                pending = list(self._inflight)
            if pending:
                try:
                    for fut in pending:
                        fut.result(
                            timeout=max(0.0, deadline - time.monotonic()))
                except FuturesTimeoutError:
                    return False
                continue
            self.process_resync_tasks()
            self.process_cleanup_jobs()
            if not self.err_tasks and not self.deleted_jobs:
                with self._inflight_lock:
                    if not self._inflight:
                        return True
                continue
            nxt = self.err_tasks.next_due_in()
            nxt2 = self.deleted_jobs.next_due_in()
            waits = [w for w in (nxt, nxt2) if w is not None]
            time.sleep(min(min(waits, default=0.001), 0.01))
        return False

    def _mark_node_shape(self) -> None:
        """A node's static profile or the node set changed: static-term
        encodings and the allocatable total are stale."""
        self.terms_cache = None
        self._shape_epoch += 1
        self._alloc_total = None

    def offer_terms_cache(self, tc) -> None:
        """Persist a session-built TermsCache for later cycles — refused
        when a node shape change landed after the building session's
        snapshot."""
        with self._lock:
            if self._shape_epoch == self._handout_shape_epoch \
                    and self.terms_cache is None:
                self.terms_cache = tc

    # ------------------------------------------------------------------
    # pod/task ingestion (ref: event_handlers.go:37-247)
    # ------------------------------------------------------------------
    def _pod_relevant(self, pod: Pod) -> bool:
        """Informer filter (ref: cache.go:246-258): pending pods only for
        our scheduler; non-pending pods always (they occupy nodes)."""
        if pod.phase == PodPhase.PENDING:
            return pod.scheduler_name == self.scheduler_name
        return True

    def _get_or_create_job(self, ti: TaskInfo) -> JobInfo:
        """ref: event_handlers.go:41-61 (shadow PodGroup for ungrouped)."""
        if not ti.job:
            pg = create_shadow_pod_group(ti.pod)
            ti.job = pg.name
            if ti.job not in self.jobs:
                job = JobInfo(ti.job)
                job.set_pod_group(pg)
                job.queue = self.default_queue
                self.jobs[ti.job] = job
        elif ti.job not in self.jobs:
            self.jobs[ti.job] = JobInfo(ti.job)
        return self.jobs[ti.job]

    def _add_task(self, ti: TaskInfo) -> None:
        job = self._get_or_create_job(ti)
        job.add_task_info(ti)
        if ti.node_name:
            if ti.node_name not in self.nodes:
                # placeholder until the node event arrives
                self.nodes[ti.node_name] = NodeInfo(None)
                self._node_order_epoch += 1
            if not _is_terminated(ti.status):
                self.nodes[ti.node_name].add_task(ti)

    def _delete_task(self, ti: TaskInfo) -> None:
        errs = []
        if ti.job:
            job = self.jobs.get(ti.job)
            if job is not None:
                try:
                    job.delete_task_info(ti)
                except KeyError as e:
                    errs.append(e)
            else:
                errs.append(KeyError(f"failed to find Job <{ti.job}> for "
                                     f"Task {ti.namespace}/{ti.name}"))
        if ti.node_name:
            node = self.nodes.get(ti.node_name)
            if node is not None:
                try:
                    node.remove_task(ti)
                except KeyError as e:
                    errs.append(e)
        if errs:
            raise KeyError("; ".join(str(e) for e in errs))

    def add_pod(self, pod: Pod) -> None:
        if not self._pod_relevant(pod):
            return
        with self._lock:
            self._add_task(TaskInfo(pod))

    def update_pod(self, old: Pod, new: Pod) -> None:
        """Delete + re-add (ref: event_handlers.go:108-122). Relevance is
        per-side: a pod filtered at add time is treated as a fresh add."""
        with self._lock:
            if self._pod_relevant(old):
                self._delete_pod_locked(old)
            if self._pod_relevant(new):
                self._add_task(TaskInfo(new))

    def delete_pod(self, pod: Pod) -> None:
        with self._lock:
            self._delete_pod_locked(pod)

    def _delete_pod_locked(self, pod: Pod) -> None:
        """ref: event_handlers.go:151-171 — prefer the cache's own task (it
        may be in Binding state with a node the stale event lacks)."""
        ti = TaskInfo(pod)
        job = self.jobs.get(ti.job)
        task = ti
        if job is not None:
            task = job.tasks.get(ti.uid, ti)
        self._delete_task(task)
        if job is not None and job_terminated(job):
            self.deleted_jobs.add_rate_limited(job)

    # ------------------------------------------------------------------
    # node ingestion (ref: event_handlers.go:249-356)
    # ------------------------------------------------------------------
    def add_node(self, node: Node) -> None:
        with self._lock:
            if node.name in self.nodes:
                self.nodes[node.name].set_node(node)
            else:
                self.nodes[node.name] = NodeInfo(node)
                self._node_order_epoch += 1
            self._mark_node_shape()

    def update_node(self, old: Node, new: Node) -> None:
        with self._lock:
            ni = self.nodes.get(new.name)
            if ni is None:
                raise KeyError(f"node <{new.name}> does not exist")
            if (old.allocatable != new.allocatable or old.taints != new.taints
                    or old.labels != new.labels
                    or old.unschedulable != new.unschedulable):
                ni.set_node(new)
                self._mark_node_shape()

    def delete_node(self, node: Node) -> None:
        with self._lock:
            if node.name not in self.nodes:
                raise KeyError(f"node <{node.name}> does not exist")
            del self.nodes[node.name]
            self._node_order_epoch += 1
            self._mark_node_shape()

    # ------------------------------------------------------------------
    # PodGroup / PDB / Queue / PriorityClass (ref: event_handlers.go:358-769)
    # ------------------------------------------------------------------
    def add_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            self._set_pod_group(pg)

    def update_pod_group(self, old: PodGroup, new: PodGroup) -> None:
        with self._lock:
            self._set_pod_group(new)

    def delete_pod_group(self, pg: PodGroup) -> None:
        with self._lock:
            job_id = f"{pg.namespace}/{pg.name}"
            job = self.jobs.get(job_id)
            if job is None:
                raise KeyError(f"can not find job {job_id}")
            job.unset_pod_group()
            self.deleted_jobs.add_rate_limited(job)

    def _set_pod_group(self, pg: PodGroup) -> None:
        job_id = f"{pg.namespace}/{pg.name}"
        if job_id not in self.jobs:
            self.jobs[job_id] = JobInfo(job_id)
        self.jobs[job_id].set_pod_group(pg)
        if not pg.queue:
            self.jobs[job_id].queue = self.default_queue

    def add_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            self._set_pdb(pdb)

    def update_pdb(self, old: PodDisruptionBudget,
                   new: PodDisruptionBudget) -> None:
        with self._lock:
            self._set_pdb(new)

    def delete_pdb(self, pdb: PodDisruptionBudget) -> None:
        with self._lock:
            job_id = pdb.owner_uid
            job = self.jobs.get(job_id)
            if job is None:
                raise KeyError(f"can not find job {job_id}")
            job.unset_pdb()
            self.deleted_jobs.add_rate_limited(job)

    def _set_pdb(self, pdb: PodDisruptionBudget) -> None:
        """PDBs are grouped by their controller owner
        (ref: event_handlers.go:477-493)."""
        job_id = pdb.owner_uid
        if not job_id:
            raise ValueError("the controller of PodDisruptionBudget is empty")
        if job_id not in self.jobs:
            self.jobs[job_id] = JobInfo(job_id)
        self.jobs[job_id].set_pdb(pdb)
        self.jobs[job_id].queue = self.default_queue

    def add_queue(self, queue: Queue) -> None:
        with self._lock:
            qi = QueueInfo(queue)
            self.queues[qi.uid] = qi

    def update_queue(self, old: Queue, new: Queue) -> None:
        with self._lock:
            self.queues.pop(old.name, None)
            qi = QueueInfo(new)
            self.queues[qi.uid] = qi

    def delete_queue(self, queue: Queue) -> None:
        with self._lock:
            self.queues.pop(queue.name, None)

    def add_priority_class(self, pc: PriorityClass) -> None:
        with self._lock:
            self._add_priority_class(pc)

    def update_priority_class(self, old: PriorityClass,
                              new: PriorityClass) -> None:
        with self._lock:
            self._delete_priority_class(old)
            self._add_priority_class(new)

    def delete_priority_class(self, pc: PriorityClass) -> None:
        with self._lock:
            self._delete_priority_class(pc)

    def _add_priority_class(self, pc: PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = pc
            self.default_priority = pc.value
        self.priority_classes[pc.name] = pc

    def _delete_priority_class(self, pc: PriorityClass) -> None:
        if pc.global_default:
            self.default_priority_class = None
            self.default_priority = 0
        self.priority_classes.pop(pc.name, None)

    # ------------------------------------------------------------------
    # decisions out (ref: cache.go:349-442)
    # ------------------------------------------------------------------
    def _find_job_and_task(self, ti: TaskInfo) -> Tuple[JobInfo, TaskInfo]:
        job = self.jobs.get(ti.job)
        if job is None:
            raise KeyError(f"failed to find Job {ti.job} for Task {ti.uid}")
        # CoW: the cache twin must be privately owned before the caller
        # mutates it in place — the shared object may still back a live
        # session's snapshot (JobInfo.clone is copy-on-write)
        job._own_tasks()
        task = job.tasks.get(ti.uid)
        if task is None:
            raise KeyError(f"failed to find task in status {ti.status} "
                           f"by id {ti.uid}")
        return job, task

    def bind(self, ti: TaskInfo, hostname: str) -> None:
        """Local state flips to Binding under the lock; the API call runs
        through the binder seam with resync-on-failure
        (ref: cache.go:392-432)."""
        with self._lock:
            job, task = self._find_job_and_task(ti)
            node = self.nodes.get(hostname)
            if node is None:
                raise KeyError(f"failed to bind Task {task.uid} to host "
                               f"{hostname}, host does not exist")
            # the backfill mark travels on the pod annotation; refresh
            # before node accounting so lent capacity lands in
            # NodeInfo.backfilled
            if not task.is_backfill and is_backfill_pod(task.pod):
                task.is_backfill = True
            job.update_task_status(task, TaskStatus.BINDING)
            task.node_name = hostname
            node.add_task(task)
            pod = task.pod
        self._submit(lambda: self._bind_one(task, pod, hostname))

    def _bind_one(self, task: TaskInfo, pod, hostname: str) -> None:
        """The API-side half of a bind: POST through the binder seam, resync
        the task on failure, emit the Scheduled event on success."""
        try:
            self.binder.bind(pod, hostname)
        except Exception:
            self.resync_task(task)
        else:
            self.recorder.eventf(
                pod, "Normal", "Scheduled",
                f"Successfully assigned {pod.namespace}/{pod.name} "
                f"to {hostname}")

    def bind_many(self, bindings: List[Tuple[TaskInfo, str]]) -> None:
        """Batched bind: identical state flips to per-task bind(), with one
        lock acquisition for the whole decision batch and the arithmetic
        as per-job / per-node float64 sums (same values in a different
        addition order, far below the fit epsilons)."""
        from ..kernels.tensorize import (batch_clone_tasks, batch_set_attr,
                                         extract_resreq)

        submits = []
        binding = TaskStatus.BINDING
        with self._lock:
            # resolve every lookup BEFORE mutating: a vanished pod or a
            # duplicate key rejects the batch while the cache is still
            # consistent
            resolved = []
            for ti, hostname in bindings:
                job = self.jobs.get(ti.job)
                if job is not None:
                    job._own_tasks()
                task = job.tasks.get(ti.uid) if job is not None else None
                if task is None:
                    job, task = self._find_job_and_task(ti)
                node = self.nodes.get(hostname)
                if node is None:
                    raise KeyError(f"failed to bind Task {task.uid} to host "
                                   f"{hostname}, host does not exist")
                resolved.append((job, task, node, hostname))
            if len({t.uid for _, t, _, _ in resolved}) != len(resolved):
                seen_uids: set = set()
                for _, task, _, _ in resolved:
                    if task.uid in seen_uids:
                        raise KeyError(
                            f"task {task.uid} appears twice in one "
                            f"bind_many batch")
                    seen_uids.add(task.uid)
            #: hostname -> indices into resolved, in bindings order
            by_host: Dict[str, list] = {}
            for k, (_, task, _, hostname) in enumerate(resolved):
                by_host.setdefault(hostname, []).append(k)
            for hostname, idxs in by_host.items():
                node = self.nodes[hostname]
                key_set = {resolved[k][1].key for k in idxs}
                if len(key_set) != len(idxs) or key_set & node.tasks.keys():
                    seen: set = set()
                    for k in idxs:      # error path: first conflict wins
                        task = resolved[k][1]
                        if task.key in node.tasks or task.key in seen:
                            raise KeyError(
                                f"task <{task.namespace}/{task.name}> "
                                f"already on node <{node.name}>")
                        seen.add(task.key)

            twins = [r[1] for r in resolved]
            hostnames = [r[3] for r in resolved]
            raw = extract_resreq(twins)

            # --- job side: index moves off the OLD status, allocated as
            #     per-job net sums, priority restamp (last explicit wins)
            by_job: Dict[str, list] = {}
            for k, (job, _, _, _) in enumerate(resolved):
                by_job.setdefault(job.uid, []).append(k)
            cpu_l = raw[:, 0].tolist()
            mem_l = raw[:, 1].tolist()
            gpu_l = raw[:, 2].tolist()
            for idxs in by_job.values():
                job = resolved[idxs[0]][0]
                index = job.task_status_index
                c = m = g = 0.0
                for k in idxs:
                    task = resolved[k][1]
                    bucket = index.get(task.status)
                    if bucket is not None:
                        bucket.pop(task.uid, None)
                        if not bucket:
                            del index[task.status]
                    # update_task_status(task, BINDING), inlined: Binding
                    # is an allocated status; a twin already in one
                    # contributes sub+add = nothing
                    if not allocated_status(task.status):
                        c += cpu_l[k]
                        m += mem_l[k]
                        g += gpu_l[k]
                job.allocated.add_vec((c, m, g))
                bucket = index.get(binding)
                if bucket is None:
                    bucket = index[binding] = {}
                bucket.update((resolved[k][1].uid, resolved[k][1])
                              for k in idxs)
                for k in reversed(idxs):
                    if resolved[k][1].pod.priority is not None:
                        job.priority = resolved[k][1].priority
                        break

            for t in twins:
                if not t.is_backfill and is_backfill_pod(t.pod):
                    t.is_backfill = True
            batch_set_attr(twins, "status", binding)
            batch_set_attr(twins, "node_name", hostnames)
            clones = batch_clone_tasks(twins, binding, hostnames)

            # --- node side: NodeInfo.add_task with the per-task
            #     arithmetic batched per node; Binding consumes idle
            for hostname, idxs in by_host.items():
                node = self.nodes[hostname]
                if node.node is not None:
                    for k in idxs:
                        if twins[k].is_backfill:
                            node.backfilled.add(twins[k].resreq)
                    take = raw[idxs].sum(axis=0)
                    node.idle.sub_vec(take)
                    node.used.add_vec(take)
                if any(resolved[k][0].affinity_tasks for k in idxs):
                    node.affinity_tasks += sum(
                        1 for k in idxs if twins[k].pod.has_pod_affinity())
                node._own_tasks()
                node.tasks.update((twins[k].key, clones[k]) for k in idxs)

            submits.extend((t, t.pod, h) for t, h in zip(twins, hostnames))
        self._submit_binds(submits)

    def _submit_binds(self, submits: List[tuple]) -> None:
        """Ship a decision batch through the binder seam: a binder with
        ``bind_many`` gets the batch in chunks, otherwise one ``bind`` per
        task."""
        if not submits:
            return
        binder_many = getattr(self.binder, "bind_many", None)
        if binder_many is None:
            if self._pool is None:
                for task, pod, hostname in submits:
                    self._bind_one(task, pod, hostname)
                return
            for task, pod, hostname in submits:
                self._submit(
                    lambda t=task, p=pod, h=hostname: self._bind_one(t, p, h))
            return
        n_chunks = 8 if self._pool is not None else 1
        size = max(1, -(-len(submits) // n_chunks))
        for i in range(0, len(submits), size):
            chunk = submits[i:i + size]
            if self._pool is None:
                self._bind_batch(chunk)
            else:
                self._submit(lambda c=chunk: self._bind_batch(c))

    def _bind_batch(self, chunk: List[tuple]) -> None:
        """One ``binder.bind_many`` call for the chunk; on failure every
        task of the chunk resyncs."""
        try:
            self.binder.bind_many([(pod, hostname)
                                   for _, pod, hostname in chunk])
        except Exception:
            for task, _, _ in chunk:
                self.resync_task(task)
            return
        for _, pod, hostname in chunk:
            self.recorder.eventf(
                pod, "Normal", "Scheduled",
                f"Successfully assigned {pod.namespace}/{pod.name} "
                f"to {hostname}")

    def evict(self, ti: TaskInfo, reason: str) -> None:
        """ref: cache.go:349-389."""
        with self._lock:
            job, task = self._find_job_and_task(ti)
            node = self.nodes.get(task.node_name)
            if node is None:
                raise KeyError(f"failed to evict Task {task.uid} on host "
                               f"{task.node_name}, host does not exist")
            job.update_task_status(task, TaskStatus.RELEASING)
            node.update_task(task)
            pod = task.pod
            pg = job.pod_group

        def do_evict(task=task, pod=pod):
            try:
                self.evictor.evict(pod)
            except Exception:
                self.resync_task(task)

        self._submit(do_evict)
        if not shadow_pod_group(pg):
            self.recorder.eventf(pg, "Normal", "Evict", reason)

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        self.volume_binder.allocate_volumes(task, hostname)

    def bind_volumes(self, task: TaskInfo) -> None:
        self.volume_binder.bind_volumes(task)

    # ------------------------------------------------------------------
    # repair loops (ref: cache.go:464-513, event_handlers.go:88-106)
    # ------------------------------------------------------------------
    def resync_task(self, task: TaskInfo) -> None:
        self.err_tasks.add_rate_limited(task)

    def process_resync_tasks(self) -> None:
        for task in self.err_tasks.pop_due():
            try:
                self.sync_task(task)
                self.err_tasks.forget(task)
            except Exception:
                self.err_tasks.add_rate_limited(task)

    def sync_task(self, old_task: TaskInfo) -> None:
        """Re-fetch ground truth and replay (ref: event_handlers.go:88-106)."""
        with self._lock:
            if self.pod_lister is None:
                new_pod: Optional[Pod] = old_task.pod
            else:
                new_pod = self.pod_lister(old_task.namespace, old_task.name)
            self._delete_task(old_task)
            if new_pod is not None:
                self._add_task(TaskInfo(new_pod))

    def process_cleanup_jobs(self) -> None:
        for job in self.deleted_jobs.pop_due():
            with self._lock:
                if job_terminated(job):
                    self.jobs.pop(job.uid, None)
                    self.deleted_jobs.forget(job)
                else:
                    self.deleted_jobs.add_rate_limited(job)

    # ------------------------------------------------------------------
    # snapshot (ref: cache.go:515-583)
    # ------------------------------------------------------------------
    def snapshot(self) -> ClusterInfo:
        """From-scratch deep clone of cache truth for one session."""
        with self._lock:
            self._handout_shape_epoch = self._shape_epoch
            snap = ClusterInfo()
            snap.allocatable_total = self._allocatable_total_locked()
            snap.node_order_epoch = self._node_order_epoch
            excluded = 0
            for node in self.nodes.values():
                snap.nodes[node.name] = node.clone()
            for uid, q in self.queues.items():
                snap.queues[uid] = q.clone()
            for uid, job in self.jobs.items():
                if self._job_excluded(job, snap.queues):
                    excluded += 1
                    continue
                self._stamp_priority(job)
                snap.jobs[uid] = job.clone()
            snap.jobs_excluded = excluded
            return snap

    @staticmethod
    def _job_excluded(job: JobInfo, queues: Dict[str, QueueInfo]) -> bool:
        """ref: cache.go:528-551 — jobs without a PodGroup/PDB or with a
        missing queue are skipped."""
        return (job.pod_group is None and job.pdb is None) \
            or job.queue not in queues

    def _allocatable_total_locked(self) -> Resource:
        """Cluster-wide allocatable sum, recomputed only after node-shape
        changes."""
        if self._alloc_total is None:
            total = Resource.empty()
            for ni in self.nodes.values():
                total.add(ni.allocatable)
            self._alloc_total = total
        return self._alloc_total.clone()

    def _stamp_priority(self, job: JobInfo) -> None:
        """ref: cache.go:561-576 (PriorityClass -> job priority)."""
        if job.pod_group is not None:
            job.priority = self.default_priority
            pc = self.priority_classes.get(
                job.pod_group.priority_class_name)
            if pc is not None:
                job.priority = pc.value

    def device_session(self, ssn):
        """A fresh DeviceSession for this cycle's nodes on the cache's
        device."""
        from ..kernels.solver import DeviceSession

        return DeviceSession(ssn.nodes, device=self.device)

    # ------------------------------------------------------------------
    # status write-back (ref: cache.go:615-658)
    # ------------------------------------------------------------------
    def task_unschedulable(self, task: TaskInfo, message: str) -> None:
        """ref: cache.go:445-462."""
        pod = task.pod
        self.recorder.eventf(pod, "Warning", "Unschedulable", message)
        self.status_updater.update_pod_condition(pod, {
            "type": "PodScheduled",
            "status": "False",
            "reason": "Unschedulable",
            "message": message,
        })

    def record_job_status_event(self, job: JobInfo) -> None:
        """ref: cache.go:616-643."""
        job_err = job.fit_error()
        if not shadow_pod_group(job.pod_group):
            pg_unschedulable = job.pod_group is not None and (
                job.pod_group.status.phase in (PodGroupPhase.PENDING,
                                               PodGroupPhase.UNKNOWN))
            pdb_unschedulable = (job.pdb is not None
                                 and job.count(TaskStatus.PENDING) != 0)
            if pg_unschedulable or pdb_unschedulable:
                msg = (f"{job.count(TaskStatus.PENDING)}/{len(job.tasks)} "
                       f"tasks in gang unschedulable: {job_err}")
                self.recorder.eventf(job.pod_group, "Warning",
                                     UNSCHEDULABLE_CONDITION, msg)
        for status in (TaskStatus.ALLOCATED, TaskStatus.PENDING):
            for task in list(job.task_status_index.get(status, {}).values()):
                self.task_unschedulable(task, job_err)

    def update_job_status(self, job: JobInfo) -> JobInfo:
        """ref: cache.go:646-658."""
        if not shadow_pod_group(job.pod_group):
            pg = self.status_updater.update_pod_group(job.pod_group)
            job.pod_group = pg
        self.record_job_status_event(job)
        return job
