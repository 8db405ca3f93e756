"""Cross-tenant dispatch batching — requests of one shape become ONE
mega-solve (ref: kubebatch_tpu/tenantsvc/megasolve.py).

A pool service serving N schedulers sees N concurrent small steady
solves a period, each one a fused solve on one cluster of the card. The
fused solve is a pure function of its arguments, the wire decode pads
every tenant's snapshot with the same ``pad_to_bucket``, and tenants
running one cluster class therefore arrive with the same (shapes x
statics) signature — so their lanes ride one launch of
``kernels/mega.py`` ``mega_fused`` (``csrc/mega_fused.cu``: one cluster per
lane), with one counted device->host copy for the group and the
per-tenant host blocks scattered back. A lane's result is bitwise a
single fused solve's.

The reference pads the lane count to ``MEGA_LANE_BUCKETS`` (an XLA
compile shape) by duplicating lane 0; the port's kernel takes the lane
count at run time and launches the real lanes only, while the
``solve_mega`` span still records ``lanes_padded`` as the reference's
does. The reference's compile-signature provider (``compile_signatures``)
waits for the build warm-up of ROADMAP A6.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import obs
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device, to_host
from ..kernels.mega import mega_fused

__all__ = ["MEGA_LANE_BUCKETS", "MAX_MEGA_LANES", "lane_bucket",
           "lane_key", "solve_lanes"]

#: lane-count buckets (the reference's compile shapes); the dispatcher
#: never pulls more than the top
MEGA_LANE_BUCKETS: Tuple[int, ...] = (2, 4, 8)
MAX_MEGA_LANES = MEGA_LANE_BUCKETS[-1]

_MEGA_STATICS = ("job_keys", "queue_keys", "gang_enabled", "prop_overused",
                 "dyn_enabled", "max_iters")


def lane_bucket(n: int) -> int:
    """Smallest lane bucket >= n (callers chunk at the top)."""
    for b in MEGA_LANE_BUCKETS:
        if n <= b:
            return b
    return MEGA_LANE_BUCKETS[-1]


def lane_key(args: tuple, statics: dict) -> tuple:
    """Coalescing key for ONE lane: two requests share a mega launch iff
    each argument's shape and dtype and the sorted statics coincide —
    the parts of the reference's signature key (compilesvc/registry.py:
    the entry, each argument's aval, the sorted statics) that vary."""
    return (tuple((tuple(np.shape(a)), np.asarray(a).dtype.str)
                  for a in args),
            tuple(sorted((k, statics[k]) for k in _MEGA_STATICS)))


def _stack_lanes(lane_args: List[tuple]) -> tuple:
    """[B lanes of numpy arguments] -> per-argument stacked [B, ...]."""
    return tuple(np.stack([la[i] for la in lane_args])
                 for i in range(len(lane_args[0])))


def solve_lanes(lanes: List[Tuple[tuple, dict]],
                device: DeviceLike = DEFAULT_DEVICE
                ) -> Tuple[List[np.ndarray], float]:
    """One mega launch over coalesced lanes (same key — the caller
    grouped them) on ``device``. Returns (per-lane host blocks, solve
    wall ms); ONE counted device->host copy for the whole group."""
    assert lanes and len(lanes) <= MAX_MEGA_LANES
    dev = resolve_device(device)
    statics = lanes[0][1]
    b = len(lanes)
    stacked = tuple(torch.from_numpy(a).to(dev)
                    for a in _stack_lanes([args for args, _ in lanes]))
    # solve_ms is the launch span alone, the copy back outside it, as on
    # the single fused path (rpc/server.solve_snapshot)
    with obs.span("solve_mega", cat="host", engine="mega",
                  lanes=b, lanes_padded=lane_bucket(b)) as sp:
        host_blocks = mega_fused(*stacked, **statics)[0]
    with obs.span("readback", cat="readback"):
        host_blocks = to_host(host_blocks)
    return [host_blocks[i] for i in range(b)], sp.dur * 1e3
