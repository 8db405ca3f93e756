"""Tracing for the scheduler loop: the span tracer (:mod:`.spans`).

A minimal port of the reference's obs/spans.py: named, categorized
intervals in a per-cycle tree (cycle -> session -> action -> kernel ->
readback), with the per-phase, per-action, kernel and end-to-end metric
accumulators fired at span exit. The reference's exporters, flight
recorder, profiler arming, rpc grafting and ledger are not here (ROADMAP
queue A, A5).
"""
from .spans import (Span, begin_cycle, current_cycle, end_cycle, enabled,
                    last_cycle, set_enabled, span)

__all__ = ["Span", "begin_cycle", "current_cycle", "end_cycle", "enabled",
           "last_cycle", "set_enabled", "span"]
