"""Process-lifetime counters the allocate cycle touches.

Plain integers (no Prometheus exporter in this package yet): consumers
read a counter before and after a window and diff. Two are counted: the
blocking device->host copies (``device.to_host``, one per fused solve)
and engine demotions (a requested engine that could not run and handed
the cycle to another). The remaining functions are the hooks the
framework and the gang plugin call; with no exporter they record nothing.
"""
from __future__ import annotations

_blocking_readbacks = 0
_engine_demotions = 0


def count_blocking_readback(n: int = 1) -> None:
    """Record n blocking device->host copies. Called only by
    ``device.to_host``, before the copy, so an interrupted cycle still
    counts the attempt."""
    global _blocking_readbacks
    _blocking_readbacks += n


def blocking_readbacks() -> int:
    return _blocking_readbacks


def count_engine_demotion(from_engine: str, to_engine: str) -> None:
    """Record one cycle whose requested engine could not run and passed
    the cycle to another (fused -> host on an unsupported snapshot)."""
    global _engine_demotions
    _engine_demotions += 1


def engine_demotions_total() -> int:
    return _engine_demotions


def count_backfill_over_placement(n: int = 1) -> None:
    """An AllocatedOverBackfill placement (session.py)."""


def update_task_schedule_duration(seconds: float) -> None:
    """Task creation -> bind latency (ref: framework/session.go:319)."""


def update_pod_schedule_status(result: str, count: int) -> None:
    """Per-cycle scheduled / unschedulable pod counts."""


def update_unschedule_task_count(job_id: str, count: int) -> None:
    """Unready tasks of a gang after a cycle (gang plugin)."""


def update_unschedule_job_count(count: int) -> None:
    """Unschedulable gangs after a cycle (gang plugin)."""


def register_job_retries(job_id: str) -> None:
    """A gang that stayed unready this cycle (gang plugin)."""
