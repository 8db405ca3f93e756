"""The SLO plane: declarative latency objectives over the decision
ledger, evaluated as multi-window burn rates (ref:
kubebatch_tpu/obs/slo.py).

An :class:`Objective` names a latency bound and the fraction of
observations that must meet it (e.g. "latency-lane arrival->decision
p99 <= 50 ms" is ``threshold_ms=50, target=0.99``). Evaluation is the
standard multi-window burn-rate scheme: the error budget is
``1 - target``; over a window the burn rate is ``error_rate / budget``,
and a breach fires only when BOTH the fast window (catches the spike)
and the slow window (confirms it is not a blip) burn past the
threshold. Windows diff cumulative (total, bad) counts captured once
per cycle tick — O(1) per tick over the ledger's streaming histograms,
no raw samples anywhere.

A breach fires ONCE per episode (re-arming only after the fast window
recovers): ``metrics.count_slo_breach(objective, window)`` for each
burning window plus one flight-recorder dump — the span trees and
counters of the cycles that blew the budget are exactly what the ring
holds. The ``obs.slo`` fault seam sits in the evaluation tick: a fired
seam forces a synthetic "injected" breach through the SAME pipeline
(counter + flight dump), proving that the breach path itself cannot
corrupt a cycle. Breaches fire after the plane's lock is released: the
flight dump reads ``metrics.counters_snapshot``, which reads this
plane's burn rates under the same lock.

The plane is armed explicitly (``Scheduler(slo=True)``, or
:func:`arm`); disarmed it costs nothing and ``/debug/slo`` says so.
Clocks are injectable, and :meth:`SLOPlane.tick` takes ``t=``, so the
burn-rate window math is testable against a synthetic clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from .. import metrics
from . import ledger as _ledger

__all__ = ["Objective", "DEFAULT_OBJECTIVES", "SLOPlane", "PLANE",
           "arm", "disarm", "armed", "snapshot", "metrics_section"]


@dataclass(frozen=True)
class Objective:
    """One declarative latency objective.

    ``kind`` picks the observation stream: "ledger" = arrival->bind
    records (optionally filtered by ``lane``), "cycle" = scheduler cycle
    durations (fed by the plane's own cycle hook). ``target`` is the
    fraction of observations that must land under ``threshold_ms``
    (0.99 -> a p99 objective; the error budget is 1 - target)."""

    name: str
    kind: str                      # "ledger" | "cycle"
    threshold_ms: float
    target: float
    lane: Optional[str] = None
    fast_s: float = 60.0
    slow_s: float = 600.0
    burn_threshold: float = 1.0
    min_count: int = 8             # a window with fewer obs never fires


#: shipped objectives: the latency-lane arrival->decision p99 bound and
#: a generous cycle-p50 guard (a real deployment overrides thresholds
#: per box; the defaults must never false-fire on a healthy cpu box)
DEFAULT_OBJECTIVES: Tuple[Objective, ...] = (
    Objective(name="latency_arrival_p99", kind="ledger",
              lane=_ledger.LATENCY_LANE, threshold_ms=50.0, target=0.99),
    Objective(name="arrival_decision_p99", kind="ledger",
              threshold_ms=5000.0, target=0.99),
    Objective(name="cycle_p50", kind="cycle",
              threshold_ms=5000.0, target=0.50),
)


class _ObjState:
    __slots__ = ("obj", "snaps", "breached", "breaches")

    def __init__(self, obj: Objective):
        self.obj = obj
        #: (t, total, bad) cumulative snapshots, oldest first; bounded
        #: far past slow_s coverage at one tick per cycle
        self.snaps: deque = deque(maxlen=8192)
        self.breached = False
        self.breaches = 0


class SLOPlane:
    """Owns objective state + the per-cycle evaluation tick. The module
    singleton ``PLANE`` hooks spans.CYCLE_HOOKS when armed; tests build
    their own plane with a synthetic clock and call :meth:`tick`."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES,
                 now: Callable[[], float] = time.monotonic):
        self._now = now
        self._lock = threading.Lock()
        self._objs: List[_ObjState] = [_ObjState(o) for o in objectives]
        self._cycle = _ledger.StreamHist()
        self._armed = False
        self._injected = 0

    # -- observation streams ------------------------------------------
    def _totals(self, obj: Objective) -> Tuple[int, int]:
        """Cumulative (total, bad) for an objective's stream."""
        thr_s = obj.threshold_ms / 1e3
        if obj.kind == "cycle":
            return (self._cycle.count,
                    _ledger.count_over_threshold(self._cycle.buckets,
                                                 thr_s))
        total, bad = 0, 0
        for (lane, _, _), h in list(_ledger._hists.items()):
            if obj.lane is not None and lane != obj.lane:
                continue
            n, _, buckets = h.snapshot()
            total += n
            bad += _ledger.count_over_threshold(buckets, thr_s)
        return total, bad

    @staticmethod
    def _window(snaps: deque, t: float, w_s: float,
                total: int, bad: int) -> Tuple[int, int, float]:
        """(d_total, d_bad, covered_s) over the last ``w_s`` seconds —
        diffed against the newest snapshot at or before the window
        start (partial coverage early on uses the oldest)."""
        base_t, base_total, base_bad = t, total, bad
        start = t - w_s
        for st, stotal, sbad in snaps:
            if st <= start:
                base_t, base_total, base_bad = st, stotal, sbad
            else:
                break
        if base_t is t and snaps:       # window predates every snapshot
            base_t, base_total, base_bad = snaps[0]
        return total - base_total, bad - base_bad, t - base_t

    def _burn(self, st: _ObjState, t: float, w_s: float,
              total: int, bad: int) -> dict:
        d_total, d_bad, covered = self._window(st.snaps, t, w_s,
                                               total, bad)
        budget = max(1e-9, 1.0 - st.obj.target)
        rate = (d_bad / d_total) if d_total else 0.0
        return {"seconds": w_s, "covered_s": round(covered, 3),
                "count": d_total, "bad": d_bad,
                "error_rate": round(rate, 6),
                "burn": round(rate / budget, 4),
                "burning": bool(d_total >= st.obj.min_count
                                and rate / budget
                                >= st.obj.burn_threshold)}

    def tick(self, cycle_dur_s: Optional[float] = None,
             t: Optional[float] = None) -> None:
        """One evaluation pass; the cycle hook calls this with the root
        span's duration. Never raises (a broken SLO plane must not fail
        a scheduling cycle)."""
        try:
            self._tick(cycle_dur_s, t)
        except Exception:                  # pragma: no cover
            import logging
            logging.getLogger("kubebatch.obs").exception(
                "slo tick failed")

    def _tick(self, cycle_dur_s, t) -> None:
        from .. import faults
        if t is None:
            t = self._now()
        fires = []
        with self._lock:
            if cycle_dur_s is not None:
                self._cycle.observe(cycle_dur_s)
            if faults.should_fail("obs.slo"):
                # the fault seam: force a breach through the real fire
                # path (counter + flight dump) without any objective
                # burning
                self._injected += 1
                fires.append("injected")
            for st in self._objs:
                total, bad = self._totals(st.obj)
                fast = self._burn(st, t, st.obj.fast_s, total, bad)
                slow = self._burn(st, t, st.obj.slow_s, total, bad)
                if fast["burning"] and slow["burning"]:
                    if not st.breached:    # single-fire per episode
                        st.breached = True
                        st.breaches += 1
                        fires.append(st.obj.name)
                elif not fast["burning"]:
                    st.breached = False    # fast recovery re-arms
                st.snaps.append((t, total, bad))
        for objective in fires:
            self._fire(objective, ("fast", "slow"))

    @staticmethod
    def _fire(objective: str, windows) -> None:
        for w in windows:
            metrics.count_slo_breach(objective, w)
        from . import flight as _flight
        _flight.dump(f"slo_breach-{objective}")

    # -- surfaces ------------------------------------------------------
    def snapshot(self) -> dict:
        """The /debug/slo payload."""
        with self._lock:
            t = self._now()
            objs = []
            for st in self._objs:
                total, bad = self._totals(st.obj)
                objs.append({
                    "name": st.obj.name, "kind": st.obj.kind,
                    "lane": st.obj.lane,
                    "threshold_ms": st.obj.threshold_ms,
                    "target": st.obj.target,
                    "windows": {
                        "fast": self._burn(st, t, st.obj.fast_s,
                                           total, bad),
                        "slow": self._burn(st, t, st.obj.slow_s,
                                           total, bad)},
                    "breached": st.breached,
                    "breaches_total": st.breaches,
                })
            return {"armed": self._armed,
                    "injected_total": self._injected,
                    "breaches_total": metrics.slo_breaches_total(),
                    "objectives": objs}

    def metrics_section(self) -> dict:
        """Compact numeric section for counters_snapshot -> OpenMetrics
        gauges (burn rates per objective/window)."""
        with self._lock:
            t = self._now()
            burn: Dict[str, float] = {}
            breached: Dict[str, int] = {}
            for st in self._objs:
                total, bad = self._totals(st.obj)
                burn[f"{st.obj.name}_fast"] = self._burn(
                    st, t, st.obj.fast_s, total, bad)["burn"]
                burn[f"{st.obj.name}_slow"] = self._burn(
                    st, t, st.obj.slow_s, total, bad)["burn"]
                breached[st.obj.name] = int(st.breached)
            return {"armed": int(self._armed), "burn_rate": burn,
                    "breached": breached,
                    "injected_total": self._injected}


PLANE = SLOPlane()


def _on_cycle(root) -> None:
    PLANE.tick(root.dur)


def arm(objectives=None) -> SLOPlane:
    """Arm the module plane (fresh objective state) and hook cycle
    ends. Idempotent re-arm resets window state."""
    global PLANE
    from . import spans as _spans
    disarm()
    PLANE = SLOPlane(objectives or DEFAULT_OBJECTIVES)
    PLANE._armed = True
    _spans.CYCLE_HOOKS.append(_on_cycle)
    return PLANE


def disarm() -> None:
    from . import spans as _spans
    PLANE._armed = False
    while _on_cycle in _spans.CYCLE_HOOKS:
        _spans.CYCLE_HOOKS.remove(_on_cycle)


def armed() -> bool:
    return PLANE._armed


def snapshot() -> dict:
    return PLANE.snapshot()


def metrics_section() -> Optional[dict]:
    """None when disarmed (counters_snapshot stays quiet)."""
    return PLANE.metrics_section() if PLANE._armed else None
