"""Allocation events — how stateful plugins (drf, proportion) observe
session mutations (ref: pkg/scheduler/framework/event.go)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..api import TaskInfo


@dataclass
class Event:
    task: TaskInfo


@dataclass
class EventHandler:
    allocate_func: Optional[Callable[[Event], None]] = None
    deallocate_func: Optional[Callable[[Event], None]] = None
    #: registering plugin's name. Purely an optimization hint: the bulk
    #: decision-replay path (actions/cycle_inputs.py) knows how to apply the
    #: built-in drf/proportion handlers as per-job/per-queue aggregates; any
    #: handler without a recognized owner forces the exact per-event replay.
    owner: Optional[str] = None
