"""The reference package's cycle arrays as this package's tensors.

Parity tests build one problem with the reference package (kubebatch_tpu)
and hand its arrays, as numpy, to both packages. These helpers are the
only bridge: they take plain numpy arrays (nothing of the reference
package is imported) and return tensors on ``device`` with the dtypes
``kernels.fused.fused_allocate`` takes, keyed by its argument names.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .kernels.fused import CYCLE_ARGS, arg_dtype

#: DeviceSession attribute -> fused_allocate argument
NODE_FIELDS = {"idle": "idle", "releasing": "releasing",
               "backfilled": "backfilled",
               "allocatable_cm": "allocatable_cm", "nz_req": "nz_req0",
               "max_task_num": "max_task_num", "n_tasks": "n_tasks",
               "node_ok": "node_ok"}


def _tensor(name: str, arr, device: torch.device) -> torch.Tensor:
    return torch.tensor(np.asarray(arr), dtype=arg_dtype(name),
                        device=device)


def cycle_inputs_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike) -> Dict[str, torch.Tensor]:
    """Every CycleInputs array field fused_allocate reads (``CYCLE_ARGS``),
    as tensors on ``device``. ``arrays`` maps field name -> numpy array
    (extra keys are ignored)."""
    dev = resolve_device(device)
    return {n: _tensor(n, arrays[n], dev) for n in CYCLE_ARGS}


def device_state_from_numpy(arrays: Mapping[str, np.ndarray],
                            device: DeviceLike) -> Dict[str, torch.Tensor]:
    """The eight DeviceSession node arrays (keyed by their DeviceSession
    names: idle, releasing, backfilled, allocatable_cm, nz_req, n_tasks,
    max_task_num, node_ok) as tensors on ``device``, keyed by the
    fused_allocate argument names."""
    dev = resolve_device(device)
    return {arg: _tensor(arg, arrays[attr], dev)
            for attr, arg in NODE_FIELDS.items()}
