"""Cache seam interfaces — the boundaries tests fake and the runtime wires
to a real cluster API.

ref: pkg/scheduler/cache/interface.go. The Binder/Evictor/StatusUpdater/
VolumeBinder seams are exactly where the reference's unit tests inject
fakes (SURVEY.md sect. 4 tier 2); we keep that architecture so the same
test strategy applies.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

from ..api import ClusterInfo, JobInfo, TaskInfo
from ..objects import Pod, PodGroup


@runtime_checkable
class Binder(Protocol):
    def bind(self, pod: Pod, hostname: str) -> None:
        """Bind pod to host; raise on failure (ref: interface.go:63-65).

        A binder MAY additionally expose ``bind_many(pairs)`` taking a
        list of ``(pod, hostname)`` tuples; the cache then ships whole
        decision batches through one call per chunk instead of one seam
        crossing per task (cache.py _submit_binds). All-or-nothing per
        chunk: a raise resyncs every task of the chunk."""
        ...


@runtime_checkable
class Evictor(Protocol):
    def evict(self, pod: Pod) -> None:
        """Delete the pod (3s grace in the reference, cache.go:125-142)."""
        ...


@runtime_checkable
class StatusUpdater(Protocol):
    def update_pod_condition(self, pod: Pod, condition: dict) -> None:
        ...

    def update_pod_group(self, pg: PodGroup) -> PodGroup:
        ...


@runtime_checkable
class VolumeBinder(Protocol):
    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        ...

    def bind_volumes(self, task: TaskInfo) -> None:
        ...


@runtime_checkable
class EventRecorder(Protocol):
    def eventf(self, obj, event_type: str, reason: str, message: str) -> None:
        ...


class Cache(Protocol):
    """ref: cache/interface.go:28-57."""

    def run(self) -> None: ...
    def snapshot(self) -> ClusterInfo: ...
    def wait_for_cache_sync(self) -> bool: ...
    def bind(self, task: TaskInfo, hostname: str) -> None: ...
    def evict(self, task: TaskInfo, reason: str) -> None: ...
    def record_job_status_event(self, job: JobInfo) -> None: ...
    def update_job_status(self, job: JobInfo) -> Optional[JobInfo]: ...
    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None: ...
    def bind_volumes(self, task: TaskInfo) -> None: ...


class NullBinder:
    """In-process binder for simulation: flips the pod's node_name."""

    def bind(self, pod: Pod, hostname: str) -> None:
        pod.node_name = hostname

    def bind_many(self, pairs) -> None:
        """Batched form (see Binder protocol): one call per decision
        chunk instead of one per task."""
        for pod, hostname in pairs:
            pod.node_name = hostname


class NullEvictor:
    def evict(self, pod: Pod) -> None:
        pod.deletion_timestamp = 0.0


class NullStatusUpdater:
    def update_pod_condition(self, pod: Pod, condition: dict) -> None:
        pod.status_conditions.append(condition)

    def update_pod_group(self, pg: PodGroup) -> PodGroup:
        return pg


class NullVolumeBinder:
    """Volume handling is a no-op in simulation (the reference delegates to
    the upstream k8s volumebinder with a 30s timeout, cache.go:164-184)."""

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        task.volume_ready = True

    def bind_volumes(self, task: TaskInfo) -> None:
        return None


class SimVolumeBinder:
    """Functional volume binder for simulation: tracks per-host volume
    capacity (volumes pending + bound per hostname) and fails allocation
    when a host is out of slots — the sim stand-in for the upstream
    volumebinder's AssumePodVolumes/BindPodVolumes pair
    (ref: cache/cache.go:164-184, k8s.io/kubernetes volumebinder).

    A non-default volume binder also forces the decision replay onto the
    exact per-event path (actions/cycle_inputs.py bulk-replay gate), so
    this class doubles as the seam tests use to exercise that fallback
    and mid-replay failure recovery.
    """

    def __init__(self, slots_per_host: int = 0):
        #: 0 = unlimited
        self.slots_per_host = slots_per_host
        self.allocated: dict = {}      # hostname -> set of task uids
        self.bound: set = set()        # task uids with bound volumes

    def allocate_volumes(self, task: TaskInfo, hostname: str) -> None:
        holders = self.allocated.setdefault(hostname, set())
        if (self.slots_per_host
                and len(holders) >= self.slots_per_host
                and task.uid not in holders):
            raise RuntimeError(
                f"host {hostname} has no volume slots left for "
                f"{task.namespace}/{task.name}")
        holders.add(task.uid)
        task.volume_ready = True

    def bind_volumes(self, task: TaskInfo) -> None:
        if not task.volume_ready:
            raise RuntimeError(
                f"volumes for {task.namespace}/{task.name} were never "
                f"allocated")
        self.bound.add(task.uid)


class ListRecorder:
    """Collects (event_type, reason, message) tuples; the sim equivalent of
    the k8s event stream."""

    def __init__(self):
        self.events = []

    def eventf(self, obj, event_type: str, reason: str, message: str) -> None:
        self.events.append((obj, event_type, reason, message))
