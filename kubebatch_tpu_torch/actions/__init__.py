"""Scheduling actions (ref: pkg/scheduler/actions).

Importing this package registers the four built-in actions of the shipped
policy: reclaim, allocate, backfill and preempt.
"""
from . import allocate, backfill, preempt, reclaim

__all__ = ["allocate", "backfill", "preempt", "reclaim"]
