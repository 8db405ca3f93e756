"""Host->device input packing.

A cycle's per-task / per-job / per-queue inputs are ~20 small arrays.
Copying each to the device separately pays a copy call apiece; packing
them into one flat buffer per dtype class makes the upload three copies.
The device side slices the buffers back into named views (no copy).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["pack", "unpack", "pack_inputs"]


def pack_inputs(get, f32_names, i32_names, bool_names):
    """Pack one buffer per dtype class. ``get(name)`` resolves an array;
    returns (buf_f, lay_f, buf_i, lay_i, buf_b, lay_b)."""
    buf_f, lay_f = pack([(n, get(n)) for n in f32_names], np.float32)
    buf_i, lay_i = pack([(n, get(n)) for n in i32_names], np.int32)
    buf_b, lay_b = pack([(n, get(n)) for n in bool_names], np.bool_)
    return buf_f, lay_f, buf_i, lay_i, buf_b, lay_b


def pack(values, dtype):
    """Concatenate (name, array) pairs into one flat buffer + a layout
    tuple of (name, offset, shape)."""
    layout = []
    flats = []
    off = 0
    for name, arr in values:
        arr = np.asarray(arr)
        layout.append((name, off, tuple(arr.shape)))
        flats.append(arr.ravel().astype(dtype, copy=False))
        off += arr.size
    buf = np.concatenate(flats) if flats else np.zeros(0, dtype)
    return buf, tuple(layout)


def unpack(buf: torch.Tensor, layout):
    """Slice a packed 1-D tensor back into named views. A scalar entry
    (shape ``()``) comes back as a 0-d view."""
    out = {}
    for name, off, shape in layout:
        size = int(np.prod(shape)) if shape else 1
        out[name] = buf[off:off + size].view(shape)
    return out
