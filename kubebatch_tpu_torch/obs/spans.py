"""The span tracer (ref: kubebatch_tpu/obs/spans.py, the core of it).

A span is a named, categorized interval; spans opened inside a cycle
root form that cycle's tree (cycle -> session -> action -> kernel ->
readback). At exit a span fires the metric view of its category:
"phase" -> ``metrics.update_host_phase``, "kernel" ->
``update_solver_kernel_duration``, "action" -> ``update_action_duration``,
"e2e" -> ``update_e2e_duration``; other categories ("host", "readback",
"cycle") only build the tree. "phase" and "e2e" views fire on an
exception exit too (the partial wall counts), the others only on a
clean one.

Retention happens only inside an open cycle root: a span closed with no
root fires its view and is dropped. ``set_enabled(False)`` turns tree
building off and leaves the views on.

Thread model: one tree per thread. The scheduler loop owns its cycle
root; a schedule-on-arrival sub-cycle opens its own root ("subcycle")
on the thread that delivered the arrival.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, Optional

from .. import metrics

_perf = time.perf_counter


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
#: the most recent finished outermost cycle root on any thread
_last_cycle: Optional[Span] = None
#: process-unique epoch stamped on every cycle root
_epoch_seq = itertools.count(1)


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


def set_enabled(on: bool) -> None:
    """Toggle tree retention; the metric views stay on."""
    global _ENABLED
    _ENABLED = bool(on)


def enabled() -> bool:
    return _ENABLED


_VIEWS = {
    "phase": lambda sp: metrics.update_host_phase(sp.name, sp.dur),
    "kernel": lambda sp: metrics.update_solver_kernel_duration(sp.name,
                                                               sp.dur),
    "action": lambda sp: metrics.update_action_duration(sp.name, sp.dur),
    "e2e": lambda sp: metrics.update_e2e_duration(sp.dur),
}
_VIEW_ON_ERROR = frozenset({"phase", "e2e"})


class _SpanCtx:
    __slots__ = ("sp", "_pushed")

    def __init__(self, sp: Span):
        self.sp = sp
        self._pushed = False

    def __enter__(self) -> Span:
        sp = self.sp
        if _ENABLED:
            st = _stack()
            if st:
                st[-1].children.append(sp)
            st.append(sp)
            self._pushed = True
        sp.t0 = _perf()
        return sp

    def __exit__(self, exc_type, exc, tb) -> None:
        sp = self.sp
        sp.dur = _perf() - sp.t0
        if self._pushed:
            st = _stack()
            if st and st[-1] is sp:
                st.pop()
            elif sp in st:
                while st and st[-1] is not sp:
                    st.pop()
                if st:
                    st.pop()
        if exc_type is None or sp.cat in _VIEW_ON_ERROR:
            view = _VIEWS.get(sp.cat)
            if view is not None:
                view(sp)
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
    root.t0 = _perf()
    return root


def end_cycle(root: Span, **args) -> Span:
    """Close a cycle root: stamps ``dur``, merges ``args`` and sweeps any
    span a raising action left open above it. The outermost root becomes
    :func:`last_cycle`."""
    global _last_cycle
    root.dur = _perf() - root.t0
    if args:
        root.args = dict(root.args or {}, **args)
    st = _stack()
    if root in st:
        i = st.index(root)
        nested = any(s.cat == "cycle" for s in st[:i])
        del st[i:]
    else:
        nested = any(s.cat == "cycle" for s in st)
    if not nested:
        _last_cycle = root
    return root


def current_cycle() -> Optional[Span]:
    """This thread's innermost open cycle root, or None."""
    for s in reversed(getattr(_TLS, "stack", None) or ()):
        if s.cat == "cycle":
            return s
    return None


def last_cycle() -> Optional[Span]:
    """The most recently finished outermost cycle root (any thread)."""
    return _last_cycle
