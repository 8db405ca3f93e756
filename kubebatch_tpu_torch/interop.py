"""The reference package's cycle arrays as this package's tensors.

Parity tests build one problem with the reference package (kubebatch_tpu)
and hand its arrays, as numpy, to both packages. These helpers are the
only bridge: they take plain numpy arrays (nothing of the reference
package is imported) and return tensors on ``device`` with the dtypes the
port's solve takes, keyed by its argument names. ``engine`` names the
solve: ``"fused"`` (``kernels.fused.fused_allocate``) or ``"batched"``
(``kernels.batched.batched_allocate``; its arrays are the reference's
packed batched inputs unpacked, including task_pair, pair_sig and
pair_nz).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels import batched, fused

#: DeviceSession attribute -> fused_allocate argument
NODE_FIELDS = {"idle": "idle", "releasing": "releasing",
               "backfilled": "backfilled",
               "allocatable_cm": "allocatable_cm", "nz_req": "nz_req0",
               "max_task_num": "max_task_num", "n_tasks": "n_tasks",
               "node_ok": "node_ok"}

_ENGINES = {"fused": fused, "batched": batched}


def _engine(engine: str):
    if engine not in _ENGINES:
        raise ValueError(f"engine {engine!r} is not one of "
                         f"{tuple(_ENGINES)}")
    return _ENGINES[engine]


def _tensor(mod, name: str, arr, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=mod.arg_dtype(name),
                        device=device)


def cycle_inputs_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike, engine: str = "fused"
                            ) -> Dict[str, torch.Tensor]:
    """Every cycle array the ``engine``'s solve reads (its ``CYCLE_ARGS``),
    as tensors on ``device``. ``arrays`` maps field name -> numpy array
    (extra keys are ignored)."""
    mod = _engine(engine)
    dev = resolve_device(device)
    return {n: _tensor(mod, n, arrays[n], dev) for n in mod.CYCLE_ARGS}


def device_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike, engine: str = "fused"
                            ) -> Dict[str, torch.Tensor]:
    """The eight DeviceSession node arrays (keyed by their DeviceSession
    names: idle, releasing, backfilled, allocatable_cm, nz_req, n_tasks,
    max_task_num, node_ok) as tensors on ``device``, keyed by the
    ``engine``'s argument names (fused renames nz_req to nz_req0)."""
    mod = _engine(engine)
    dev = resolve_device(device)
    names = NODE_FIELDS if engine == "fused" else {
        n: n for n in batched.NODE_ARGS}
    return {arg: _tensor(mod, arg, arrays[attr], dev)
            for attr, arg in names.items()}
