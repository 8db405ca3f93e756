"""Many tenants' fused allocate solves as one launch (ref:
kubebatch_tpu/tenantsvc/megasolve.py:56 ``_mega_fused``, the reference's
``jax.vmap`` of ``kernels/fused.py`` ``fused_allocate`` over B lanes).

Every argument is the fused solve's argument stacked over a leading lane
axis ([B, ...], one lane per coalesced tenant request; all lanes share
one shape and one set of statics). Two implementations of one function,
chosen by the tensors' device:

- :func:`mega_fused_plain` — ``fused_allocate_plain`` lane by lane. The
  reference documents its vmapped lanes as bit-identical to the
  dedicated dispatch; the plain version is that dedicated solve per lane.
- the CUDA kernel ``csrc/mega_fused.cu`` — one thread-block cluster per
  lane, each running the fused loop of ``csrc/fused_body.cuh`` (the code
  ``csrc/fused_allocate.cu`` launches on one cluster) on its lane's
  slice, so a lane's result is bitwise a single fused launch's. The
  cluster size comes from the lane count (kernels/fused.py
  ``launch_shape``): the largest whose clusters the card keeps resident
  all at once; more lanes run in waves.

:func:`mega_fused` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other,
and a failed build or launch raises. Both return ``(host_blocks, idle,
releasing, n_tasks, nz)``, each the fused solve's result stacked over the
lanes: host_blocks is int32 [B, 3, T + 1 + TELEM_WIDTH].

The reference pads B up to 2, 4 or 8 by copying lane 0 (the lane count is
an XLA compile shape) and discards the copies; the kernel takes B at run
time, so only the real lanes are launched.
"""
from __future__ import annotations

import torch

from .fused import (CYCLE_ARGS, NODE_ARGS, _fused_allocate_cuda,
                    fused_allocate_plain)

__all__ = ["mega_fused", "mega_fused_plain", "ARG_NAMES"]

#: the positional argument order (fused_allocate's)
ARG_NAMES = NODE_ARGS + CYCLE_ARGS


def mega_fused_plain(*stacked, **statics):
    """``fused_allocate_plain`` on each lane of the stacked arguments;
    the five results stacked over the lanes."""
    if len(stacked) != len(ARG_NAMES):
        raise TypeError(f"mega_fused: {len(ARG_NAMES)} stacked arguments, "
                        f"got {len(stacked)}")
    lanes = [fused_allocate_plain(*(a[b] for a in stacked), **statics)
             for b in range(stacked[0].shape[0])]
    return tuple(torch.stack([lane[k] for lane in lanes])
                 for k in range(len(lanes[0])))


def mega_fused(*stacked, **statics):
    """The stacked fused solves on the inputs' device: one launch of
    ``csrc/mega_fused.cu`` for CUDA tensors, :func:`mega_fused_plain`
    for CPU tensors."""
    if len(stacked) != len(ARG_NAMES):
        raise TypeError(f"mega_fused: {len(ARG_NAMES)} stacked arguments, "
                        f"got {len(stacked)}")
    devs = {a.device.type for a in stacked}
    if devs == {"cpu"}:
        return mega_fused_plain(*stacked, **statics)
    if devs != {"cuda"}:
        raise ValueError(f"mega_fused: inputs on mixed devices {devs}")
    return _fused_allocate_cuda(dict(zip(ARG_NAMES, stacked)),
                                lanes=stacked[0].shape[0], **statics)
