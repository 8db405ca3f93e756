"""Device choice and the one counted device->host copy.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a machine without a
usable CUDA device raises instead of quietly running on the CPU. Tests
pass ``device="cpu"``.

Every device->host copy on the scheduling path goes through
:func:`to_host`, which counts it (``metrics.blocking_readbacks``). A fused
allocate solve makes exactly one: the packed host block.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .metrics import count_blocking_readback

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


def to_host(t: torch.Tensor) -> np.ndarray:
    """The counted blocking device->host copy (for a CPU tensor a copy-free
    view, counted all the same so the accounting is device-independent)."""
    count_blocking_readback()
    return t.detach().cpu().numpy()
