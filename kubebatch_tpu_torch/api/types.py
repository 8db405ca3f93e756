"""Task status / job readiness enums and callback type aliases.

ref: pkg/scheduler/api/types.go. Includes the fork-specific
``ALLOCATED_OVER_BACKFILL`` state and the three-valued ``JobReadiness``
(types.go:22-80).
"""
from __future__ import annotations

import enum
from typing import Callable, List


class TaskStatus(enum.IntFlag):
    """Pod/task lifecycle states (ref: types.go:22-61)."""
    PENDING = enum.auto()
    #: allocated onto resources currently occupied by backfill tasks:
    #: Idle < Resreq <= Allocatable (fork feature, types.go:26-30)
    ALLOCATED_OVER_BACKFILL = enum.auto()
    #: allocated onto idle resources only
    ALLOCATED = enum.auto()
    #: assigned a host, waiting for releasing resources to free up
    PIPELINED = enum.auto()
    #: bind request in flight to the API
    BINDING = enum.auto()
    BOUND = enum.auto()
    RUNNING = enum.auto()
    #: being deleted
    RELEASING = enum.auto()
    SUCCEEDED = enum.auto()
    FAILED = enum.auto()
    UNKNOWN = enum.auto()

    def __str__(self) -> str:  # match reference's display names
        return _STATUS_NAMES.get(self, "Unknown")


_STATUS_NAMES = {
    TaskStatus.PENDING: "Pending",
    TaskStatus.ALLOCATED: "Allocated",
    TaskStatus.ALLOCATED_OVER_BACKFILL: "AllocatedOverBackfill",
    TaskStatus.PIPELINED: "Pipelined",
    TaskStatus.BINDING: "Binding",
    TaskStatus.BOUND: "Bound",
    TaskStatus.RUNNING: "Running",
    TaskStatus.RELEASING: "Releasing",
    TaskStatus.SUCCEEDED: "Succeeded",
    TaskStatus.FAILED: "Failed",
    TaskStatus.UNKNOWN: "Unknown",
}


class JobReadiness(enum.IntFlag):
    """ref: types.go:63-80 (fork feature).

    READY:        #Allocated-family tasks >= MinAvailable
    ALMOST_READY: not Ready, but #Allocated + #AllocatedOverBackfill >= MinAvailable
    NOT_READY:    otherwise
    """
    READY = enum.auto()
    ALMOST_READY = enum.auto()
    NOT_READY = enum.auto()


def allocated_statuses() -> List[TaskStatus]:
    """States that count toward a job's allocation (ref: types.go:82-84).
    NB: deliberately excludes ALLOCATED_OVER_BACKFILL — those only count
    toward AlmostReady."""
    return [TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING,
            TaskStatus.ALLOCATED]


def ready_statuses() -> List[TaskStatus]:
    """States counting toward gang readiness — the pipelined-inclusive
    definition (upstream v0.4.1 readyTaskNum; see plugins/gang.py for why
    the fork's narrower set is a regression). Single source of truth for
    gang, the allocate paths, and the kernels' init counters."""
    return [TaskStatus.BOUND, TaskStatus.BINDING, TaskStatus.RUNNING,
            TaskStatus.ALLOCATED, TaskStatus.SUCCEEDED, TaskStatus.PIPELINED]


def allocated_status(status: TaskStatus) -> bool:
    """ref: api/helpers.go:63-70."""
    return status in (TaskStatus.BOUND, TaskStatus.BINDING,
                      TaskStatus.RUNNING, TaskStatus.ALLOCATED)


def validate_status_update(old: TaskStatus, new: TaskStatus) -> None:
    """Transition validator — intentionally permissive, like the reference
    stub (ref: types.go:114-116)."""
    return None


class ValidateResult:
    """ref: types.go:130-136."""

    def __init__(self, passed: bool, reason: str = "", message: str = ""):
        self.passed = passed
        self.reason = reason
        self.message = message


# Callback aliases — the vocabulary of the tiered plugin dispatch
# (ref: types.go:118-147). Tensor-producing plugin hooks used by the device
# kernels live in kernels/; these remain for host-side policy composition.
LessFn = Callable[[object, object], bool]
CompareFn = Callable[[object, object], int]
ValidateFn = Callable[[object], bool]
ValidateExFn = Callable[[object], ValidateResult]
JobReadyFn = Callable[[object], JobReadiness]
BackFillEligibleFn = Callable[[object], bool]
