"""Host decode of the solve telemetry frame (ref: kubebatch_tpu/obs/
telemetry.py).

Every engine ships a fixed [TELEM_WIDTH] int32 frame (kernels/telemetry.py)
in the packed block of its one counted device->host copy, or, for the
victim kernels, assembles it on the host from that copy. :func:`record`
decodes it, keeps the last frame per engine, attaches it to the dispatch
span's arguments (so it shows in the Chrome trace and the flight
recorder's dumps) and folds it into ``metrics.observe_telemetry`` (the
per-engine last frames, the histograms and the decisions count that
readbacks-per-decision divides by). It reads host numbers only, never
device memory. The cycle hook feeds the cycle-latency histogram.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from .. import metrics
from ..kernels.telemetry import ENGINE_NAMES, FIELDS, TELEM_WIDTH
from . import spans as _spans

__all__ = ["TELEM_WIDTH", "FIELDS", "decode", "record", "last_frame",
           "last_frames"]

_lock = threading.Lock()
_last: dict = {}


def decode(words) -> dict:
    """[TELEM_WIDTH] int32 words -> {field: int}, the engine id resolved
    to its name (longer inputs are cut to the frame)."""
    w = np.asarray(words).reshape(-1)[:TELEM_WIDTH]
    frame = {name: int(w[i]) for i, name in enumerate(FIELDS)}
    frame["engine"] = ENGINE_NAMES.get(frame["engine"],
                                       str(frame["engine"]))
    return frame


def record(words, span=None, tenant: Optional[str] = None) -> dict:
    """Decode one frame and publish it: the last-frame store, the
    dispatch span's arguments (``span``, else this thread's innermost
    open span) and ``metrics.observe_telemetry``."""
    frame = decode(words)
    with _lock:
        _last[frame["engine"]] = frame
    if span is None:
        st = getattr(_spans._TLS, "stack", None)
        span = st[-1] if st else None
    if span is not None:
        span.args = dict(span.args or {}, telemetry=frame)
    metrics.observe_telemetry(frame["engine"], frame, tenant=tenant)
    return frame


def last_frame(engine: str) -> Optional[dict]:
    """The most recent decoded frame of ``engine``, or None."""
    with _lock:
        return _last.get(engine)


def last_frames() -> dict:
    """The last decoded frame per engine (a copy)."""
    with _lock:
        return dict(_last)


def _cycle_hook(root) -> None:
    metrics.observe_cycle_latency_ms(root.dur * 1e3)


_spans.CYCLE_HOOKS.append(_cycle_hook)
