"""Flight recorder — the last K cycles, self-contained, dumped on failure
(ref: kubebatch_tpu/obs/flight.py).

A failure deep in a long run would otherwise mean log archaeology: the
degradation ladder demotes engines on signals that only exist as
interleaved log lines, and by the time a human looks, the cycles that
mattered are gone. The recorder keeps a bounded ring of per-cycle records — the full span tree,
a counter snapshot (every process-lifetime mirror counter in
metrics.counters_snapshot), and the degradation-ladder state — and
auto-dumps the ring to disk when something goes wrong:

- a ``cycle_failures_total`` increment (the scheduler's guarded cycle
  counted an exception / deadline overrun / recompile overrun);
- a degradation-ladder demotion (faults.py notifies via
  ``on_ladder_demotion``);
- an active-set engine demotion (kernels/activeset.py ``demote``), an
  SLO breach (obs/slo.py) and a timeline drift (obs/timeline.py).

Recording is a cycle hook (obs.spans.CYCLE_HOOKS) and only runs while
ARMED — the steady hot path pays nothing when the recorder is off. Arm
it with ``arm(directory)`` (arming from the daemon's settings comes with
the CLI, ROADMAP A9). Each dump is one JSON file:

    <dir>/flightrec-<seq>-<reason>.json
    { "reason": ..., "ts": ...,
      "cycles": [ {spans, counters, ladder, telemetry}... ] }

so the artifact answers "what did the last K cycles look like, and what
were the counters at each of them" without any other file.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from .. import metrics
from .spans import CYCLE_HOOKS, Span

log = logging.getLogger("kubebatch.obs")

__all__ = ["FlightRecorder", "RECORDER", "arm", "disarm", "armed",
           "record_cycle", "dump", "maybe_dump_on_failure"]

#: default ring depth: enough cycles to cover a demote->probe->re-trip
#: sequence, small enough that a dump is a few hundred KB
DEFAULT_CAPACITY = 16

#: cap on dumps per process — a crash-looping scheduler must fill disks
#: with cycles, not dumps
MAX_DUMPS = 64


def _ladder_state() -> dict:
    from .. import faults
    lad = faults.LADDER
    return {
        "level": lad.level,
        "level_name": faults.LADDER_LEVELS[lad.level],
        "demote_after": lad.demote_after,
        "promote_after": lad.promote_after,
        "armed_plan": (dict(faults.active_plan().injected)
                       if faults.active_plan() is not None else None),
    }


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = capacity
        self.directory: Optional[str] = None
        self._ring: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._seq = 0
        self.dumps: List[str] = []
        #: cycle_failures_total at the last record/dump check — the
        #: failure trigger fires on the DELTA, not the absolute count
        self._failures_seen = metrics.cycle_failures_total()

    # ---- recording ----------------------------------------------------
    def record_cycle(self, root: Span) -> None:
        """Cycle hook: ring-buffer one record. Cheap — one to_dict walk
        of a tree with tens of nodes plus dict copies of the counters."""
        from . import telemetry
        rec = {
            "ts": time.time(),
            "spans": root.to_dict(),
            "counters": metrics.counters_snapshot(),
            "ladder": _ladder_state(),
            # last decoded device telemetry frame per engine — the
            # kernel's own account of the cycle, alongside the host view
            "telemetry": telemetry.last_frames(),
        }
        with self._lock:
            self._ring.append(rec)

    # ---- dumping ------------------------------------------------------
    def dump(self, reason: str) -> Optional[str]:
        """Write the ring to disk; returns the path (None if unarmed,
        empty, or over the dump cap)."""
        with self._lock:
            if self.directory is None or not self._ring:
                return None
            if len(self.dumps) >= MAX_DUMPS:
                return None
            self._seq += 1
            seq = self._seq
            cycles = list(self._ring)
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in reason)[:80]
        path = os.path.join(self.directory,
                            f"flightrec-{seq:04d}-{safe}.json")
        doc = {"reason": reason, "ts": time.time(),
               "ladder": _ladder_state(),
               "counters": metrics.counters_snapshot(),
               "cycles": cycles}
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except Exception:
            log.exception("flight-recorder dump failed (%s)", reason)
            return None
        with self._lock:
            self.dumps.append(path)
        log.warning("flight recorder dumped %d cycles to %s (%s)",
                    len(cycles), path, reason)
        return path

    def maybe_dump_on_failure(self, reason: Optional[str] = None
                              ) -> Optional[str]:
        """Dump iff cycle_failures_total advanced since the last check
        (the scheduler calls this after every guarded failure path,
        passing the failing cycle's actual reason so the artifact is
        named after THIS failure, not the historically dominant one)."""
        total = metrics.cycle_failures_total()
        if total <= self._failures_seen:
            return None
        self._failures_seen = total
        return self.dump(f"cycle_failure-{reason or 'failure'}")

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dumps.clear()
            self._failures_seen = metrics.cycle_failures_total()


RECORDER = FlightRecorder()


def _on_cycle(root: Span) -> None:
    RECORDER.record_cycle(root)


def _on_demotion(level: int) -> None:
    RECORDER.dump(f"ladder_demotion-level{level}")


def arm(directory: str, capacity: int = DEFAULT_CAPACITY) -> FlightRecorder:
    """Arm the process-wide recorder: record every cycle into a ring of
    ``capacity`` and auto-dump to ``directory`` on the trigger set."""
    from .. import faults
    os.makedirs(directory, exist_ok=True)
    RECORDER.directory = directory
    if capacity != RECORDER.capacity:
        RECORDER.capacity = capacity
        with RECORDER._lock:
            RECORDER._ring = deque(RECORDER._ring, maxlen=capacity)
    RECORDER._failures_seen = metrics.cycle_failures_total()
    if _on_cycle not in CYCLE_HOOKS:
        CYCLE_HOOKS.append(_on_cycle)
    faults.on_ladder_demotion(_on_demotion)
    log.warning("flight recorder ARMED (dir=%s, last %d cycles)",
                directory, capacity)
    return RECORDER


def disarm() -> None:
    from .. import faults
    RECORDER.directory = None
    RECORDER.reset()
    try:
        CYCLE_HOOKS.remove(_on_cycle)
    except ValueError:
        pass
    faults.remove_ladder_demotion_hook(_on_demotion)


def armed() -> bool:
    return RECORDER.directory is not None


def record_cycle(root: Span) -> None:
    RECORDER.record_cycle(root)


def dump(reason: str) -> Optional[str]:
    return RECORDER.dump(reason)


def maybe_dump_on_failure(reason: Optional[str] = None) -> Optional[str]:
    return RECORDER.maybe_dump_on_failure(reason)
