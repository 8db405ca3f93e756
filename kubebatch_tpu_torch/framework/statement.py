"""Statement — deferred-operation transaction for preemption.

ref: pkg/scheduler/framework/statement.go. Evict/Pipeline apply session
state immediately and log an op; Commit replays real cache evictions;
Discard rolls back in reverse order. Pipeline's commit is a session-only
no-op — binding happens in a later cycle once resources free up
(statement.go:153-154).
"""
from __future__ import annotations

from typing import List, Tuple

from ..api import TaskInfo, TaskStatus


class Statement:
    def __init__(self, ssn):
        self.ssn = ssn
        self.operations: List[Tuple[str, tuple]] = []

    # --- session-visible ops ---------------------------------------------
    def evict(self, reclaimee: TaskInfo, reason: str) -> None:
        """ref: statement.go:35-67."""
        self.ssn.touched_nodes.add(reclaimee.node_name)
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            # CoW: resolve to the job's canonical task before any write;
            # the op log records the resolved object so rollback mutates
            # the same one (Session.pipeline has the same contract)
            reclaimee = job.own_task(reclaimee)
            job.update_task_status(reclaimee, TaskStatus.RELEASING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_deallocate(reclaimee)
        self.operations.append(("evict", (reclaimee, reason)))

    def pipeline(self, task: TaskInfo, hostname: str) -> None:
        """ref: statement.go:110-151."""
        self.ssn.touched_nodes.add(hostname)
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            task = job.own_task(task)   # CoW (see evict)
            job.update_task_status(task, TaskStatus.PIPELINED)
        task.node_name = hostname
        node = self.ssn.nodes.get(hostname)
        if node is not None:
            node.add_task(task)
        self.ssn._fire_allocate(task)
        self.operations.append(("pipeline", (task, hostname)))

    # --- rollback helpers --------------------------------------------------
    def _unevict(self, reclaimee: TaskInfo) -> None:
        """ref: statement.go:81-108. Rollback is a divergence source too:
        the sub-then-add Resource round trip need not restore the exact
        float bits a fresh clone carries."""
        self.ssn.touched_nodes.add(reclaimee.node_name)
        job = self.ssn.jobs.get(reclaimee.job)
        if job is not None:
            job.update_task_status(reclaimee, TaskStatus.RUNNING)
        node = self.ssn.nodes.get(reclaimee.node_name)
        if node is not None:
            node.update_task(reclaimee)
        self.ssn._fire_allocate(reclaimee)

    def _unpipeline(self, task: TaskInfo) -> None:
        """ref: statement.go:156-192."""
        self.ssn.touched_nodes.add(task.node_name)
        job = self.ssn.jobs.get(task.job)
        if job is not None:
            job.update_task_status(task, TaskStatus.PENDING)
        node = self.ssn.nodes.get(task.node_name)
        if node is not None:
            node.remove_task(task)
        task.node_name = ""
        self.ssn._fire_deallocate(task)

    # --- transaction close -------------------------------------------------
    def _retire(self) -> None:
        """Leave the session's open-statement registry (session.py
        tracks statements so CloseSession can discard any a mid-action
        fault left open)."""
        open_list = getattr(self.ssn, "open_statements", None)
        if open_list is not None:
            try:
                open_list.remove(self)
            except ValueError:
                pass

    def commit(self) -> None:
        """Replay real evictions through the cache (ref: statement.go:207-217).
        Pipelines stay session-only."""
        for name, args in self.operations:
            if name == "evict":
                reclaimee, reason = args
                try:
                    self.ssn.cache.evict(reclaimee, reason)
                except Exception:
                    self._unevict(reclaimee)
        self.operations = []
        self._retire()

    def discard(self) -> None:
        """Roll back in reverse order (ref: statement.go:194-205)."""
        for name, args in reversed(self.operations):
            if name == "evict":
                self._unevict(args[0])
            elif name == "pipeline":
                self._unpipeline(args[0])
        self.operations = []
        self._retire()
