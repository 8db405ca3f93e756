"""NodeInfo — per-node resource accounting.

ref: pkg/scheduler/api/node_info.go. The Idle/Used/Releasing/Backfilled
relations here are what the solver tensors project onto the node axis.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..objects import Node
from .job import TaskInfo
from .resource import Resource
from .types import TaskStatus


class NodeInfo:
    """Per-node aggregate (ref: node_info.go:27-45).

    - idle:       allocatable minus everything placed (non-pipelined)
    - used:       running + terminating placements
    - releasing:  resreq of tasks being deleted, less pipelined reuse
    - backfilled: resreq occupied by backfill tasks (fork feature)
    """

    def __init__(self, node: Optional[Node] = None):
        self.name: str = node.name if node else ""
        self.node: Optional[Node] = node
        self.releasing = Resource.empty()
        self.used = Resource.empty()
        self.backfilled = Resource.empty()
        if node is not None:
            self.idle = Resource.from_resource_list(node.allocatable)
            self.allocatable = Resource.from_resource_list(node.allocatable)
            self.capability = Resource.from_resource_list(node.capacity)
        else:
            self.idle = Resource.empty()
            self.allocatable = Resource.empty()
            self.capability = Resource.empty()
        self.tasks: Dict[str, TaskInfo] = {}
        self._tasks_shared = False
        #: tasks whose pod carries inter-pod (anti-)affinity (see
        #: JobInfo.affinity_tasks)
        self.affinity_tasks: int = 0

    def clone(self) -> "NodeInfo":
        """Deep copy: the maintained accounting is copied rather than
        re-derived task by task (equivalent, since add_task maintains it
        incrementally; this runs O(nodes) per snapshot, every cycle).

        The task map is shared COPY-ON-WRITE: no code path mutates a
        node-held TaskInfo in place (status changes go through
        remove+add / update_task, which replace the entry), so clones
        can share the dict — and its task objects — until one side's
        map changes shape. Mutators call _own_tasks() first; a direct
        ``node.tasks[k] = ...`` write without it corrupts the other
        side's snapshot."""
        res = object.__new__(NodeInfo)
        res.name = self.name
        res.node = self.node
        res.releasing = self.releasing.clone()
        res.used = self.used.clone()
        res.backfilled = self.backfilled.clone()
        res.idle = self.idle.clone()
        # allocatable/capability are REPLACE-ONLY (set_node assigns fresh
        # Resource objects; no code path calls add/sub on them — grep
        # before changing that), so clones share the objects: two fewer
        # Resource allocations per node per snapshot
        res.allocatable = self.allocatable
        res.capability = self.capability
        res.tasks = self.tasks
        res._tasks_shared = True
        self._tasks_shared = True
        res.affinity_tasks = self.affinity_tasks
        return res

    def _own_tasks(self) -> None:
        """Materialize a private task map before the first shape change
        (shallow copy: the TaskInfo values stay shared, see clone)."""
        if self._tasks_shared:
            self.tasks = dict(self.tasks)
            self._tasks_shared = False

    def set_node(self, node: Node) -> None:
        """Recompute accounting from scratch for a (re)seen node
        (ref: node_info.go:95-111)."""
        self.name = node.name
        self.node = node
        self.allocatable = Resource.from_resource_list(node.allocatable)
        self.capability = Resource.from_resource_list(node.capacity)
        self.idle = Resource.from_resource_list(node.allocatable)
        # Reference resets only Idle here (node_info.go:101), double-counting
        # Used/Releasing on repeated node events and never refreshing
        # Backfilled — an accounting bug we fix, like accessible().
        self.used = Resource.empty()
        self.releasing = Resource.empty()
        self.backfilled = Resource.empty()
        for task in self.tasks.values():
            if task.is_backfill:
                self.backfilled.add(task.resreq)
            if task.status == TaskStatus.RELEASING:
                self.releasing.add(task.resreq)
                self.idle.sub(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                # pipelined tasks reuse releasing resources (same invariant
                # as add_task; the reference recompute misses this too)
                self.releasing.sub(task.resreq)
            else:
                self.idle.sub(task.resreq)
            self.used.add(task.resreq)

    def add_task(self, task: TaskInfo) -> None:
        """ref: node_info.go:113-145. Holds a CLONE of the task so later
        session status flips can't corrupt node accounting."""
        key = task.key
        if key in self.tasks:
            raise KeyError(f"task <{task.namespace}/{task.name}> already on "
                           f"node <{self.name}>")
        ti = task.clone()
        if self.node is not None:
            if task.is_backfill:
                self.backfilled.add(task.resreq)
            if ti.status == TaskStatus.RELEASING:
                self.releasing.add(ti.resreq)
                self.idle.sub(ti.resreq)
            elif ti.status == TaskStatus.PIPELINED:
                self.releasing.sub(ti.resreq)
            else:
                self.idle.sub(ti.resreq)
            self.used.add(ti.resreq)
        if ti.pod.has_pod_affinity():
            self.affinity_tasks += 1
        self._own_tasks()
        self.tasks[key] = ti

    def remove_task(self, ti: TaskInfo) -> None:
        """ref: node_info.go:147-177 (inverse of add_task)."""
        key = ti.key
        task = self.tasks.get(key)
        if task is None:
            raise KeyError(f"failed to find task <{ti.namespace}/{ti.name}> "
                           f"on host <{self.name}>")
        if self.node is not None:
            if task.is_backfill:
                self.backfilled.sub(task.resreq)
            if task.status == TaskStatus.RELEASING:
                self.releasing.sub(task.resreq)
                self.idle.add(task.resreq)
            elif task.status == TaskStatus.PIPELINED:
                self.releasing.add(task.resreq)
            else:
                self.idle.add(task.resreq)
            self.used.sub(task.resreq)
        if task.pod.has_pod_affinity():
            self.affinity_tasks -= 1
        self._own_tasks()
        del self.tasks[key]

    def update_task(self, ti: TaskInfo) -> None:
        self.remove_task(ti)
        self.add_task(ti)

    def accessible(self) -> Resource:
        """Idle + Backfilled — the resources an allocation may claim when it
        is allowed to displace backfill tasks (fork feature).

        ref: node_info.go:209-211 (GetAccessibleResource). The reference
        implementation mutates Idle in place while computing this
        (``ni.Idle.Add(...)``) — an accounting bug we do not reproduce;
        this is a pure read.
        """
        return self.idle.plus(self.backfilled)

    def pods(self):
        return [t.pod for t in self.tasks.values()]

    def __repr__(self) -> str:
        return (f"Node({self.name}): idle={self.idle}, used={self.used}, "
                f"releasing={self.releasing}, backfilled={self.backfilled}, "
                f"tasks={len(self.tasks)}")
