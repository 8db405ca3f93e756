"""Device choice and the one counted device->host copy.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a machine without a
usable CUDA device raises instead of quietly running on the CPU. Tests
pass ``device="cpu"``.

Every device->host copy on the scheduling path goes through this module:
:func:`to_host`, the blocking copy (``metrics.blocking_readbacks``: a
fused allocate solve makes exactly one, the packed host block), or
:class:`DeferredCopy`, the pipelined executor's copy started at dispatch
and read a cycle later (``metrics.deferred_readbacks``).
"""
from __future__ import annotations

import time
from typing import Tuple, Union

import numpy as np
import torch

from .metrics import count_blocking_readback, count_deferred_readback

DEFAULT_DEVICE = "cuda"

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = DEFAULT_DEVICE) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    no CUDA device is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            f"is False; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def on_card(cache) -> bool:
    """True when ``cache`` keeps its device arrays on a CUDA device."""
    dev = getattr(cache, "device", None)
    return dev is not None and torch.device(dev).type == "cuda"


def to_host(t: torch.Tensor, out: torch.Tensor = None) -> np.ndarray:
    """The counted blocking device->host copy (for a CPU tensor a copy-free
    view, counted all the same so the accounting is device-independent).
    ``out``: a host tensor of ``t``'s shape and dtype (a pinned staging
    buffer) to copy into; the result is then a view of it."""
    count_blocking_readback()
    if out is not None:
        out.copy_(t.detach())
        return out.numpy()
    return t.detach().cpu().numpy()


class DeferredCopy:
    """A device->host copy started now and read later: the pipelined
    consume's one readback. On the card the copy goes on the current
    stream, behind everything launched there, into a pinned host buffer
    (``non_blocking``) between two CUDA events; nothing on the host waits
    for it until :meth:`wait`. The buffer is this copy's alone, so
    nothing reuses it before it is read. On the CPU the tensor already
    is host memory. Counted once, at :meth:`wait`, as a deferred
    readback, never as a blocking one."""

    __slots__ = ("_src", "_host", "_events", "_read")

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self._read = False
        if t.device.type != "cuda":
            self._src, self._host, self._events = None, t, None
            return
        #: the device buffer stays alive until the copy has been read
        self._src = t
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        start.record()
        self._host.copy_(t, non_blocking=True)
        done.record()
        self._events = (start, done)

    def wait(self) -> Tuple[np.ndarray, float]:
        """Block until the copy has landed and count it: (the host array,
        the host milliseconds spent waiting). Once only."""
        if self._read:
            raise RuntimeError("a deferred copy is read once")
        self._read = True
        count_deferred_readback()
        t0 = time.perf_counter()
        if self._events is not None:
            self._events[1].synchronize()
        wait_ms = (time.perf_counter() - t0) * 1e3
        self._src = None
        return self._host.numpy(), wait_ms

    def device_ms(self) -> float:
        """The copy's device milliseconds (CUDA events; NaN on the CPU),
        after :meth:`wait`."""
        if self._events is None:
            return float("nan")
        return self._events[0].elapsed_time(self._events[1])
