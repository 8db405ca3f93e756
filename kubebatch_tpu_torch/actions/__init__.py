"""Scheduling actions (ref: pkg/scheduler/actions).

Importing this package registers the built-in actions this package has:
allocate. Reclaim, backfill and preempt are later slices of the port.
"""
from . import allocate

__all__ = ["allocate"]
