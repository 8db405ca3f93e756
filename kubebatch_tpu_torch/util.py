"""Priority queue + node selection helpers
(ref: pkg/scheduler/util/priority_queue.go, sort.go)."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, List

from .api import NodeInfo

LessFn = Callable[[object, object], bool]


class _Entry:
    __slots__ = ("item", "less", "seq")

    def __init__(self, item, less: LessFn, seq: int):
        self.item = item
        self.less = less
        self.seq = seq

    def __lt__(self, other: "_Entry") -> bool:
        if self.less(self.item, other.item):
            return True
        if self.less(other.item, self.item):
            return False
        return self.seq < other.seq  # stable for equal elements


class PriorityQueue:
    """Heap ordered by a LessFn (ref: priority_queue.go:224-287)."""

    def __init__(self, less: LessFn):
        self._less = less
        self._heap: List[_Entry] = []
        self._seq = itertools.count()

    def push(self, item) -> None:
        heapq.heappush(self._heap, _Entry(item, self._less, next(self._seq)))

    def pop(self):
        if not self._heap:
            return None
        return heapq.heappop(self._heap).item

    def peek(self):
        if not self._heap:
            return None
        return self._heap[0].item

    def empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)


def select_best_node(node_scores: Dict[float, List[NodeInfo]]) -> List[NodeInfo]:
    """Flatten score buckets in descending score order
    (ref: util/sort.go:312-324)."""
    out: List[NodeInfo] = []
    for score in sorted(node_scores, reverse=True):
        out.extend(node_scores[score])
    return out
