"""The long-horizon timeline: O(1)-memory per-cycle digests for
multi-hour soaks, with JSONL spill and an EWMA drift rung (ref:
kubebatch_tpu/obs/timeline.py).

A ≥10k-cycle soak needs a replayable record of what every cycle did
WITHOUT retaining 10k span trees. Armed, the timeline hooks cycle ends
and keeps a bounded ring of per-cycle digests — epoch, cycle wall,
span count, COUNTER DELTAS (decisions, blocking/deferred readbacks,
recompiles, cycle failures, ledger closes), current RSS, and a compact
telemetry-frame summary — spilling them append-only to
``<dir>/timeline.jsonl`` every ``spill_every`` digests, so the full
run replays from disk while resident memory stays flat at the ring
bound.

The drift rung is the "instead of silently degrading" half: fast/slow
EWMAs over cycle wall and RSS; when the fast track runs persistently
above the slow one (``DRIFT_PATIENCE`` consecutive ticks past the
tolerance, after a warm-up), the timeline fires ONCE per episode —
``metrics.count_timeline_drift(kind)`` plus a flight-recorder dump,
made after the timeline's lock is released (the dump reads
``stats()``). A leak or a slow latency rot in hour three becomes a
counted, dumped event, not a surprise OOM.

The spill directory is an argument (``arm(directory)``,
``Scheduler(timeline_dir=)``). The digests' ``deferred_readbacks`` and
``recompiles`` deltas are the pipelined executor's and the compile
service's (ROADMAP A4, A6) and stay 0 here.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, List, Optional

from .. import metrics

__all__ = ["Timeline", "TIMELINE", "arm", "disarm", "armed", "flush",
           "stats", "recent", "MIN_TICKS", "DRIFT_PATIENCE"]

#: EWMA smoothing factors (per-cycle): the fast track reacts within a
#: few dozen cycles, the slow one is the multi-hour baseline
FAST_ALPHA = 0.08
SLOW_ALPHA = 0.005

#: drift tolerances: fast must exceed slow by this fraction
DUR_TOL = 1.5                      # cycle wall: +150% sustained
RSS_TOL = 0.25                     # resident set: +25% sustained

#: ticks before the rung may fire (EWMAs must converge first) and
#: consecutive over-tolerance ticks required (a blip never fires)
MIN_TICKS = 64
DRIFT_PATIENCE = 16

_PAGE = 4096
try:
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (AttributeError, ValueError, OSError):  # pragma: no cover
    pass


def _rss_mb() -> float:
    """Current resident set in MB (|/proc| on linux, peak-RSS fallback
    elsewhere) — cheap enough for once per cycle."""
    try:
        with open("/proc/self/statm", "rb") as f:
            return int(f.read().split()[1]) * _PAGE / 1e6
    except Exception:                  # pragma: no cover — non-linux
        import resource
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e3


class _Ewma:
    __slots__ = ("fast", "slow", "over")

    def __init__(self) -> None:
        self.fast: Optional[float] = None
        self.slow: Optional[float] = None
        self.over = 0

    def update(self, v: float) -> None:
        self.fast = (v if self.fast is None
                     else self.fast + FAST_ALPHA * (v - self.fast))
        self.slow = (v if self.slow is None
                     else self.slow + SLOW_ALPHA * (v - self.slow))

    def drifting(self, tol: float) -> bool:
        if self.slow is None or self.slow <= 0:
            return False
        return self.fast > self.slow * (1.0 + tol)


class Timeline:
    """Owns the ring, the spill file and the drift state. The module
    singleton ``TIMELINE`` is what arm()/the cycle hook use; tests build
    their own with a synthetic clock."""

    def __init__(self, now: Callable[[], float] = time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._armed = False
        self._dir: Optional[str] = None
        self._ring: deque = deque(maxlen=2048)
        self._pending: List[dict] = []
        self._spill_every = 256
        self._ticks = 0
        self._spilled = 0
        self._dur = _Ewma()
        self._rss = _Ewma()
        self._drift_fired = {"cycle_ms": False, "rss_mb": False}
        self._prev: Optional[dict] = None

    def arm(self, directory: Optional[str] = None, capacity: int = 2048,
            spill_every: int = 256) -> "Timeline":
        with self._lock:
            self._armed = True
            self._dir = directory
            if directory:
                os.makedirs(directory, exist_ok=True)
            self._ring = deque(maxlen=int(capacity))
            self._pending = []
            self._spill_every = max(1, int(spill_every))
            self._ticks = 0
            self._spilled = 0
            self._dur = _Ewma()
            self._rss = _Ewma()
            self._drift_fired = {"cycle_ms": False, "rss_mb": False}
            self._prev = None
        return self

    def disarm(self) -> None:
        self.flush()
        with self._lock:
            self._armed = False

    @property
    def path(self) -> Optional[str]:
        return (os.path.join(self._dir, "timeline.jsonl")
                if self._dir else None)

    # -- the per-cycle tick --------------------------------------------
    def _counter_sample(self) -> dict:
        acct = metrics.readback_accounting()
        sample = {
            "decisions": acct.get("decisions", 0),
            "blocking_readbacks": acct.get("readbacks", 0),
            "deferred_readbacks": acct.get("deferred_readbacks", 0),
            "recompiles": 0,
            "cycle_failures": metrics.cycle_failures_total(),
            "subcycles": metrics.subcycles_total(),
        }
        try:
            from . import ledger as _ledger
            sample["ledger_closed"] = _ledger.stats()["closed_total"]
        except Exception:              # pragma: no cover
            sample["ledger_closed"] = 0
        return sample

    @staticmethod
    def _telemetry_summary() -> Optional[dict]:
        try:
            from . import telemetry as _telemetry
            frames = _telemetry.last_frames()
        except Exception:
            return None
        if not frames:
            return None
        out = {}
        for engine, frame in list(frames.items())[:8]:
            if isinstance(frame, dict):
                out[str(engine)] = {
                    k: frame[k] for k in ("waves", "bound", "failed")
                    if k in frame}
            else:                      # pragma: no cover — defensive
                out[str(engine)] = {}
        return out or None

    def tick(self, root) -> None:
        """One digest from a finished cycle root. Never raises."""
        try:
            self._tick(root)
        except Exception:              # pragma: no cover
            import logging
            logging.getLogger("kubebatch.obs").exception(
                "timeline tick failed")

    def _tick(self, root) -> None:
        drifted = []
        with self._lock:
            if not self._armed:
                return
            cycle_ms = root.dur * 1e3
            rss = _rss_mb()
            sample = self._counter_sample()
            prev = self._prev or sample
            digest = {
                "ts": round(self._now(), 3),
                "epoch": (root.args or {}).get("epoch"),
                "name": root.name,
                "cycle_ms": round(cycle_ms, 3),
                "spans": root.count(),
                "rss_mb": round(rss, 2),
                "deltas": {k: sample[k] - prev.get(k, 0)
                           for k in sample},
            }
            telem = self._telemetry_summary()
            if telem:
                digest["telemetry"] = telem
            self._prev = sample
            self._ring.append(digest)
            self._pending.append(digest)
            self._ticks += 1
            # ---- drift rung ------------------------------------------
            self._dur.update(cycle_ms)
            self._rss.update(rss)
            if self._ticks >= MIN_TICKS:
                for kind, ewma, tol in (("cycle_ms", self._dur, DUR_TOL),
                                        ("rss_mb", self._rss, RSS_TOL)):
                    if self._drift(kind, ewma, tol):
                        drifted.append(kind)
            if len(self._pending) >= self._spill_every:
                self._spill_locked()
        for kind in drifted:
            # once per episode: count it, dump the flight ring — the
            # alternative is silently degrading for hours
            metrics.count_timeline_drift(kind)
            from . import flight as _flight
            _flight.dump(f"timeline_drift-{kind}")

    def _drift(self, kind: str, ewma: _Ewma, tol: float) -> bool:
        """Advance ``kind``'s drift state; True when an episode starts
        (the caller counts and dumps it)."""
        if ewma.drifting(tol):
            ewma.over += 1
            if (ewma.over >= DRIFT_PATIENCE
                    and not self._drift_fired[kind]):
                self._drift_fired[kind] = True
                return True
        else:
            ewma.over = 0
            self._drift_fired[kind] = False
        return False

    # -- spill ---------------------------------------------------------
    def _spill_locked(self) -> None:
        pending, self._pending = self._pending, []
        if not self._dir:
            return                     # ring-only mode still bounds
        try:
            with open(self.path, "a") as f:
                for d in pending:
                    f.write(json.dumps(d, separators=(",", ":")) + "\n")
            self._spilled += len(pending)
        except OSError:                # pragma: no cover — disk gone
            import logging
            logging.getLogger("kubebatch.obs").exception(
                "timeline spill failed")

    def flush(self) -> None:
        with self._lock:
            self._spill_locked()

    # -- surfaces ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            return {
                "armed": int(self._armed),
                "ticks": self._ticks,
                "ring": len(self._ring),
                "ring_capacity": self._ring.maxlen,
                "spilled": self._spilled,
                "pending": len(self._pending),
                "cycle_ms_fast": (round(self._dur.fast, 3)
                                  if self._dur.fast is not None else None),
                "cycle_ms_slow": (round(self._dur.slow, 3)
                                  if self._dur.slow is not None else None),
                "rss_mb_fast": (round(self._rss.fast, 2)
                                if self._rss.fast is not None else None),
                "rss_mb_slow": (round(self._rss.slow, 2)
                                if self._rss.slow is not None else None),
                "drift_total": metrics.timeline_drift_total(),
            }

    def recent(self, n: int = 32) -> List[dict]:
        with self._lock:
            return list(self._ring)[-n:]


TIMELINE = Timeline()


def _on_cycle(root) -> None:
    TIMELINE.tick(root)


def arm(directory: Optional[str] = None, capacity: int = 2048,
        spill_every: int = 256) -> Timeline:
    """Arm the module timeline and hook cycle ends (idempotent)."""
    from . import spans as _spans
    TIMELINE.arm(directory, capacity, spill_every)
    if _on_cycle not in _spans.CYCLE_HOOKS:
        _spans.CYCLE_HOOKS.append(_on_cycle)
    return TIMELINE


def disarm() -> None:
    from . import spans as _spans
    while _on_cycle in _spans.CYCLE_HOOKS:
        _spans.CYCLE_HOOKS.remove(_on_cycle)
    TIMELINE.disarm()


def armed() -> bool:
    return TIMELINE._armed


def flush() -> None:
    TIMELINE.flush()


def stats() -> dict:
    return TIMELINE.stats()


def recent(n: int = 32) -> List[dict]:
    return TIMELINE.recent(n)
