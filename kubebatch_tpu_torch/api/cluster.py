"""QueueInfo and ClusterInfo — the snapshot container.

ref: pkg/scheduler/api/queue_info.go, cluster_info.go.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..objects import Queue
from .job import JobInfo
from .node import NodeInfo


class QueueInfo:
    """ref: queue_info.go:307-336."""

    __slots__ = ("uid", "name", "weight", "queue")

    def __init__(self, queue: Queue):
        self.uid: str = queue.name
        self.name: str = queue.name
        self.weight: int = queue.weight
        self.queue: Queue = queue

    def clone(self) -> "QueueInfo":
        q = object.__new__(QueueInfo)
        q.uid = self.uid
        q.name = self.name
        q.weight = self.weight
        q.queue = self.queue
        return q

    def __repr__(self) -> str:
        return f"Queue({self.name}, weight={self.weight})"


class ClusterInfo:
    """Immutable-by-convention snapshot handed to each Session
    (ref: cluster_info.go:168-172)."""

    def __init__(self,
                 jobs: Optional[Dict[str, JobInfo]] = None,
                 nodes: Optional[Dict[str, NodeInfo]] = None,
                 queues: Optional[Dict[str, QueueInfo]] = None):
        self.jobs: Dict[str, JobInfo] = jobs if jobs is not None else {}
        self.nodes: Dict[str, NodeInfo] = nodes if nodes is not None else {}
        self.queues: Dict[str, QueueInfo] = queues if queues is not None else {}
        #: uids freshly cloned from cache truth this snapshot; None =
        #: every job (full clones). Close-session uses this to know which
        #: untouched jobs verifiably carry an unchanged status.
        self.refreshed_jobs = None

    def __repr__(self) -> str:
        return (f"ClusterInfo(jobs={len(self.jobs)}, nodes={len(self.nodes)}, "
                f"queues={len(self.queues)})")
