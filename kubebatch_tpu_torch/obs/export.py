"""Chrome trace-event export — span trees as Perfetto-loadable JSON
(ref: kubebatch_tpu/obs/export.py).

The format is the Trace Event "JSON Object Format": a dict with a
``traceEvents`` list of complete events (``"ph": "X"``, timestamps and
durations in microseconds). chrome://tracing and ui.perfetto.dev both
load it directly: a scheduling cycle's host phases, kernel dispatches
and blocking readbacks land on one zoomable timeline, next to the
``torch.profiler`` capture ``obs.arm_profile`` writes into the same
directory.

Lanes: pid "kubebatch" carries local spans; subtrees marked
``remote=True`` (the rpc sidecar's grafted roots, ROADMAP A8) get pid
"sidecar".

Arming: ``arm(dir)`` registers a cycle hook that buffers each finished
cycle root (bounded ring — a soak must not grow memory) and ``flush()``
(atexit-registered) writes ``<dir>/trace.json``.
"""
from __future__ import annotations

import atexit
import json
import os
import threading
from collections import deque
from typing import List, Optional

from .spans import CYCLE_HOOKS, Span

__all__ = ["to_trace_events", "to_chrome_trace", "write_trace", "arm",
           "flush", "armed_dir", "disarm"]

#: bounded cycle buffer for the armed exporter — bounded for a
#: multi-hour soak
_MAX_BUFFERED_CYCLES = 512

_lock = threading.Lock()
_buffer: deque = deque(maxlen=_MAX_BUFFERED_CYCLES)
_dir: Optional[str] = None
_atexit_installed = False


def _emit(events: List[dict], sp: Span, pid: str, tid: int) -> None:
    if sp.args and sp.args.get("remote"):
        pid = "sidecar"
    ev = {"name": sp.name, "cat": sp.cat, "ph": "X",
          "ts": round(sp.t0 * 1e6, 3), "dur": round(sp.dur * 1e6, 3),
          "pid": pid, "tid": tid}
    if sp.args:
        ev["args"] = {k: v for k, v in sp.args.items() if k != "remote"}
    events.append(ev)
    for child in sp.children:
        _emit(events, child, pid, tid)


def to_trace_events(roots) -> List[dict]:
    """Flatten span trees into a trace-event list."""
    events: List[dict] = []
    for root in roots:
        _emit(events, root, "kubebatch", 1)
    return events


def to_chrome_trace(roots) -> dict:
    """The JSON Object Format document for a set of cycle roots."""
    return {"traceEvents": to_trace_events(roots),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "kubebatch_tpu_torch.obs"}}


def write_trace(path: str, roots) -> str:
    """Write the trace document; returns the path."""
    doc = to_chrome_trace(roots)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)          # a killed writer never leaves half a file
    return path


# ---------------------------------------------------------------------
# armed per-cycle export
# ---------------------------------------------------------------------

def _on_cycle(root: Span) -> None:
    with _lock:
        if _dir is not None:
            _buffer.append(root)


def arm(directory: str) -> str:
    """Buffer every finished cycle and write ``<directory>/trace.json``
    at flush/exit. Returns the trace file path."""
    global _dir, _atexit_installed
    os.makedirs(directory, exist_ok=True)
    with _lock:
        _dir = directory
        if _on_cycle not in CYCLE_HOOKS:
            CYCLE_HOOKS.append(_on_cycle)
        if not _atexit_installed:
            atexit.register(flush)
            _atexit_installed = True
    return os.path.join(directory, "trace.json")


def armed_dir() -> Optional[str]:
    return _dir


def flush() -> Optional[str]:
    """Write the buffered cycles (if armed and non-empty); returns the
    written path or None. Best-effort at interpreter exit."""
    with _lock:
        directory = _dir
        roots = list(_buffer)
    if directory is None or not roots:
        return None
    try:
        return write_trace(os.path.join(directory, "trace.json"), roots)
    except Exception:                      # pragma: no cover — exit path
        return None


def disarm() -> None:
    """Tests: stop buffering and drop state."""
    global _dir
    with _lock:
        _dir = None
        _buffer.clear()
    try:
        CYCLE_HOOKS.remove(_on_cycle)
    except ValueError:
        pass
