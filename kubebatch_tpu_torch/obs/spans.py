"""The span tracer (ref: kubebatch_tpu/obs/spans.py).

A span is a named, categorized interval; spans opened inside a cycle
root form that cycle's tree (cycle -> session -> action -> phase ->
kernel dispatch -> readback). At exit a span fires the metric view of
its category: "phase" -> ``metrics.update_host_phase``, "kernel" ->
``update_solver_kernel_duration``, "action" -> ``update_action_duration``,
"plugin" -> ``update_plugin_duration``, "tensorize" ->
``update_tensorize_duration``, "e2e" -> ``update_e2e_duration``; other
categories ("host", "readback", "cycle", "compile") only build the tree.
"phase" and "e2e" views fire on an exception exit too (the partial wall
counts), the others only on a clean one. A kernel span also enters a
``torch.profiler.record_function`` annotation, so a surrounding profiler
session sees the span names.

Retention happens only inside an open cycle root: a span closed with no
root fires its view and is dropped. ``set_enabled(False)`` turns tree
building off and leaves the views on.

Hooks: ``SPAN_HOOKS`` run on every clean span exit (the decision ledger
stamps its stages there, obs/ledger.py), ``CYCLE_HOOKS`` on every
outermost cycle root's end (the flight recorder, the trace exporter, the
SLO plane, the timeline, the cycle-latency histogram). A hook must be
cheap and never raise; one that does is logged and the cycle goes on.

Thread model: one tree per thread. The scheduler loop owns its cycle
root; a schedule-on-arrival sub-cycle opens its own root ("subcycle")
on the thread that delivered the arrival. The reference's rpc stitching
(``begin_server_root``, ``end_server_root``, ``graft``) comes with the
rpc sidecar (ROADMAP A8).
"""
from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from .. import metrics

__all__ = ["Span", "span", "begin_cycle", "end_cycle", "current_cycle",
           "current_epoch", "last_cycle", "set_enabled", "enabled",
           "cycle", "add_event", "arm_profile", "span_overhead_estimate",
           "CYCLE_HOOKS", "SPAN_HOOKS", "tracer_stats", "spans_total",
           "now"]

_perf = time.perf_counter
log = logging.getLogger("kubebatch.obs")


class Span:
    """One timed interval: ``t0``/``dur`` in perf_counter seconds."""

    __slots__ = ("name", "cat", "t0", "dur", "args", "children")

    def __init__(self, name: str, cat: str, args: Optional[dict] = None):
        self.name = name
        self.cat = cat
        self.t0 = 0.0
        self.dur = 0.0
        self.args = args
        self.children: List["Span"] = []

    def to_dict(self) -> dict:
        d: Dict = {"name": self.name, "cat": self.cat,
                   "t0": self.t0, "dur": self.dur}
        if self.args:
            d["args"] = dict(self.args)
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        sp = cls(d.get("name", "?"), d.get("cat", "host"),
                 dict(d["args"]) if d.get("args") else None)
        sp.t0 = float(d.get("t0", 0.0))
        sp.dur = float(d.get("dur", 0.0))
        sp.children = [cls.from_dict(c) for c in d.get("children", ())]
        return sp

    def count(self) -> int:
        """Spans in this subtree."""
        return 1 + sum(c.count() for c in self.children)

    def shift(self, delta: float) -> None:
        """Rebase the subtree's timestamps by ``delta`` seconds."""
        self.t0 += delta
        for c in self.children:
            c.shift(delta)

    def find(self, name: str) -> Optional["Span"]:
        """Depth-first lookup by span name."""
        if self.name == name:
            return self
        for c in self.children:
            hit = c.find(name)
            if hit is not None:
                return hit
        return None


_TLS = threading.local()
_ENABLED = True
#: hooks called with the finished outermost cycle root
CYCLE_HOOKS: List[Callable[[Span], None]] = []
#: hooks called with every span that exits cleanly
SPAN_HOOKS: List[Callable[[Span], None]] = []
#: the most recent finished outermost cycle root on any thread
_last_cycle: Optional[Span] = None
#: process-lifetime completed-span count
_spans_total = 0
#: process-unique epoch stamped on every cycle root
_epoch_seq = itertools.count(1)


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def now() -> float:
    """The tracer's clock (perf_counter seconds)."""
    return _perf()


def set_enabled(on: bool) -> None:
    """Toggle tree retention; the metric views stay on."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


def spans_total() -> int:
    """Process-lifetime completed-span count; consumers diff a window."""
    return _spans_total


_VIEWS = {
    "phase": lambda sp: metrics.update_host_phase(sp.name, sp.dur),
    "kernel": lambda sp: metrics.update_solver_kernel_duration(sp.name,
                                                               sp.dur),
    "action": lambda sp: metrics.update_action_duration(sp.name, sp.dur),
    "plugin": lambda sp: metrics.update_plugin_duration(
        sp.name, (sp.args or {}).get("phase", ""), sp.dur),
    "tensorize": lambda sp: metrics.update_tensorize_duration(sp.dur),
    "e2e": lambda sp: metrics.update_e2e_duration(sp.dur),
}
_VIEW_ON_ERROR = frozenset({"phase", "e2e"})


class _SpanCtx:
    __slots__ = ("sp", "_pushed", "_trace")

    def __init__(self, sp: Span):
        self.sp = sp
        self._pushed = False
        self._trace = None

    def __enter__(self) -> Span:
        sp = self.sp
        if _ENABLED:
            st = _stack()
            if st:
                st[-1].children.append(sp)
            st.append(sp)
            self._pushed = True
        if sp.cat == "kernel":
            from torch.profiler import record_function
            self._trace = record_function(sp.name)
            self._trace.__enter__()
        sp.t0 = _perf()
        return sp

    def __exit__(self, exc_type, exc, tb) -> None:
        global _spans_total
        sp = self.sp
        sp.dur = _perf() - sp.t0
        if self._trace is not None:
            self._trace.__exit__(exc_type, exc, tb)
        if self._pushed:
            st = _stack()
            if st and st[-1] is sp:
                st.pop()
            elif sp in st:
                while st and st[-1] is not sp:
                    st.pop()
                if st:
                    st.pop()
        _spans_total += 1
        if exc_type is None or sp.cat in _VIEW_ON_ERROR:
            view = _VIEWS.get(sp.cat)
            if view is not None:
                view(sp)
            if SPAN_HOOKS and exc_type is None:
                # clean exits only: an aborted dispatch stamps no stage
                try:
                    for hook in SPAN_HOOKS:
                        hook(sp)
                except Exception:
                    log.exception("span hook failed")
        if not _ENABLED or (self._pushed and not _stack()):
            sp.children = []               # retention off / rootless


def span(name: str, cat: str = "host", **args) -> _SpanCtx:
    """A child span under this thread's open span (``with span(...)``)."""
    return _SpanCtx(Span(name, cat, args or None))


def begin_cycle(cycle_id: Optional[int] = None, name: str = "cycle",
                **args) -> Span:
    """Open a cycle root on this thread; close it with :func:`end_cycle`
    (the caller reads ``dur`` afterwards, for the deadline budget).
    ``name`` labels the root: "cycle" for the period loop, "subcycle"
    for schedule-on-arrival. Every root carries a process-unique
    ``epoch`` argument."""
    if cycle_id is not None:
        args["cycle"] = cycle_id
    args["epoch"] = next(_epoch_seq)
    root = Span(name, "cycle", args)
    if _ENABLED:
        st = _stack()
        if st:                             # nested root: a plain child
            st[-1].children.append(root)
        st.append(root)
    _profile_cycle_begin()
    root.t0 = _perf()
    return root


def end_cycle(root: Span, **args) -> Span:
    """Close a cycle root: stamps ``dur``, merges ``args``, sweeps any
    span a raising action left open above it and fires the cycle hooks.
    A younger cycle root still open above it (overlapping roots) is
    detached from its tree and stays live, to end as a root of its own.
    The outermost root becomes :func:`last_cycle`."""
    global _last_cycle, _spans_total
    root.dur = _perf() - root.t0
    if args:
        root.args = dict(root.args or {}, **args)
    st = _stack()
    if root in st:
        i = st.index(root)
        nested = any(s.cat == "cycle" for s in st[:i])
        above = st[i:]
        del st[i:]
        for j in range(1, len(above)):
            if above[j].cat == "cycle":
                parent = above[j - 1]
                if above[j] in parent.children:
                    parent.children.remove(above[j])
                st.extend(above[j:])
                break
    else:
        nested = any(s.cat == "cycle" for s in st)
    _spans_total += 1
    _profile_cycle_end()
    if not nested:
        _last_cycle = root
        if _ENABLED:
            for hook in list(CYCLE_HOOKS):
                try:
                    hook(root)
                except Exception:          # a hook never fails a cycle
                    log.exception("cycle hook failed")
    return root


class _CycleCtx:
    __slots__ = ("root",)

    def __init__(self, root: Span):
        self.root = root

    def __enter__(self) -> Span:
        return self.root

    def __exit__(self, exc_type, exc, tb) -> None:
        end_cycle(self.root,
                  **({"error": exc_type.__name__} if exc_type else {}))


def cycle(cycle_id: Optional[int] = None, **args) -> _CycleCtx:
    """``with obs.cycle(i) as root:``, the with-statement form of
    begin_cycle / end_cycle."""
    return _CycleCtx(begin_cycle(cycle_id, **args))


def current_cycle() -> Optional[Span]:
    """This thread's innermost open cycle root, or None."""
    for s in reversed(getattr(_TLS, "stack", None) or ()):
        if s.cat == "cycle":
            return s
    return None


def current_epoch() -> Optional[int]:
    """The ``epoch`` of this thread's current cycle root, or None."""
    sp = current_cycle()
    return (sp.args or {}).get("epoch") if sp is not None else None


def last_cycle() -> Optional[Span]:
    """The most recently finished outermost cycle root (any thread)."""
    return _last_cycle


def add_event(name: str, dur: float, cat: str = "compile", **args) -> None:
    """Attach an already finished interval (ending now) to this thread's
    open span."""
    st = getattr(_TLS, "stack", None)
    if not st:
        return
    sp = Span(name, cat, args or None)
    sp.dur = dur
    sp.t0 = _perf() - dur
    st[-1].children.append(sp)


# ---------------------------------------------------------------------
# the armed torch.profiler capture over the next N cycle roots
# ---------------------------------------------------------------------

_profile_state = {"remaining": 0, "dir": "", "prof": None}


def arm_profile(cycles: int, directory: str) -> None:
    """Capture a ``torch.profiler`` trace (host and, on a card, CUDA
    activity) over the next ``cycles`` cycle roots, written to
    ``<directory>/torch_profile.json`` when the last one ends."""
    _profile_state["remaining"] = int(cycles)
    _profile_state["dir"] = directory


def _profile_cycle_begin() -> None:
    ps = _profile_state
    if ps["remaining"] <= 0 or ps["prof"] is not None:
        return
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        ps["prof"] = prof
    except Exception:                      # never fail a cycle for a trace
        log.exception("profiler capture failed to start")
        ps["remaining"] = 0


def _profile_cycle_end() -> None:
    ps = _profile_state
    prof = ps["prof"]
    if prof is None:
        return
    ps["remaining"] -= 1
    if ps["remaining"] > 0:
        return
    ps["prof"] = None
    try:
        prof.stop()
        os.makedirs(ps["dir"], exist_ok=True)
        prof.export_chrome_trace(os.path.join(ps["dir"],
                                              "torch_profile.json"))
    except Exception:
        log.exception("profiler capture failed to stop")


# ---------------------------------------------------------------------
# overhead evidence
# ---------------------------------------------------------------------

_overhead_estimate: Optional[float] = None


def span_overhead_estimate(samples: int = 2000) -> float:
    """Measured per-span cost in seconds (enter and exit of a retained
    host span), calibrated once per process."""
    global _overhead_estimate
    if _overhead_estimate is None:
        with cycle(None):
            t0 = _perf()
            for _ in range(samples):
                with span("calib", cat="host"):
                    pass
            _overhead_estimate = (_perf() - t0) / samples
    return _overhead_estimate


def tracer_stats() -> dict:
    """The tracer's section of /debug/vars."""
    lc = _last_cycle
    return {
        "enabled": _ENABLED,
        "spans_total": _spans_total,
        "last_cycle_spans": lc.count() if lc is not None else 0,
        "span_overhead_us": (round(_overhead_estimate * 1e6, 3)
                             if _overhead_estimate is not None else None),
    }
