"""Solve telemetry — one fixed-width int32 frame per dispatch, riding the
engine's packed host block so it costs no extra device->host copy.

Field layout and engine ids match the reference package's frame word for
word (kubebatch_tpu/kernels/telemetry.py), so the two host blocks compare
directly. The CUDA fused kernel writes the same frame in its epilogue
(csrc/fused_allocate.cu), and so do the batched round kernel
(csrc/batched_allocate.cu) and the two-level / active-set kernel
(csrc/hier_allocate.cu); :func:`decision_frame` is the plain PyTorch
version the plain engines use. The victim kernels' results are bool
bitmaps, so their frames are assembled on the host from the same single
readback (:func:`host_frame`) and kept in :data:`victim_frames`.
"""
from __future__ import annotations

from collections import deque

import numpy as np
import torch

__all__ = ["TELEM_WIDTH", "WAVE_SLOTS", "FIELDS", "ENGINE_NAMES",
           "ENGINE_BATCHED", "ENGINE_FUSED", "ENGINE_HIER", "ENGINE_SHARDED",
           "ENGINE_HIER_SHARDED", "ENGINE_ACTIVESET", "ENGINE_VICTIM_WAVE",
           "ENGINE_VICTIM_VISIT", "decision_frame", "host_frame",
           "victim_frames"]

#: frame width in int32 words
TELEM_WIDTH = 20

#: per-wave bound-task histogram slots (wave index clips into the last)
WAVE_SLOTS = 4

# field indices ---------------------------------------------------------
F_ENGINE = 0        # engine id (ENGINE_* below)
F_WAVES = 1         # waves / rounds / iterations the solve ran
F_BOUND = 2         # tasks bound (ALLOC | ALLOC_OB | PIPELINE)
F_FAILED = 3        # tasks the solve marked FAIL
F_PENDING = 4       # valid tasks left SKIP (not visited / job dropped)
F_CENSUS = 5        # valid tasks presented
F_WAVE_BOUND0 = 6   # .. F_WAVE_BOUND0+WAVE_SLOTS-1: bound per wave slot
F_POOL_OCC = 10     # hier: pools with >=1 eligible candidate, wave 0
F_BUCKET_FILL = 11  # hier: candidate count in the winning pool, wave 0
F_NARROW = 12       # narrow score dtype engaged for this dispatch (0/1)
F_NARROW_GATE = 13  # shape wanted narrow but the exactness gate refused
F_RETRIES = 14      # stranded-gang epilogue passes (batched, hier)
F_STRANDED = 15     # gangs the epilogue finally retired (batched, hier)
F_ACT_TASKS = 16    # activeset: active (pending) tasks in the packed set
F_ACT_NODES = 17    # activeset: candidate nodes (eligible pools x pool)
F_ACT_SCATTER = 18  # activeset: node rows scattered back (blocks x pool)
F_ACT_DEMOTED = 19  # activeset: audit divergences (nonzero = demote)

#: decode order — index i of the frame is FIELDS[i]
FIELDS = ("engine", "waves", "bound", "failed", "pending", "census",
          "wave_bound0", "wave_bound1", "wave_bound2", "wave_bound3",
          "pool_occ", "bucket_fill", "narrow", "narrow_gate",
          "retries", "stranded", "act_tasks", "act_nodes", "act_scatter",
          "act_demoted")

# engine ids (the reference package's numbering) -------------------------
ENGINE_VISIT = 1
ENGINE_BATCHED = 2
ENGINE_FUSED = 3
ENGINE_HIER = 4
ENGINE_SHARDED = 5
ENGINE_HIER_SHARDED = 6
ENGINE_VICTIM_WAVE = 7
ENGINE_VICTIM_VISIT = 8
ENGINE_ACTIVESET = 9

ENGINE_NAMES = {ENGINE_VISIT: "visit", ENGINE_BATCHED: "batched",
                ENGINE_FUSED: "fused", ENGINE_HIER: "hier",
                ENGINE_SHARDED: "sharded",
                ENGINE_HIER_SHARDED: "hier_sharded",
                ENGINE_VICTIM_WAVE: "victim_wave",
                ENGINE_VICTIM_VISIT: "victim_visit",
                ENGINE_ACTIVESET: "activeset"}

#: the frames of the latest victim dispatches, oldest first (bounded)
victim_frames: deque = deque(maxlen=65536)

# decision codes (solver.py/fused.py agree on these)
_SKIP, _ALLOC, _ALLOC_OB, _PIPELINE, _FAIL = 0, 1, 2, 3, 4


def decision_frame(engine: int, task_state: torch.Tensor,
                   task_seq: torch.Tensor, task_valid: torch.Tensor,
                   waves, stride: int, *, narrow: bool = False,
                   narrow_gate: bool = False, retries=0, stranded=0,
                   pool_occ=0, bucket_fill=0, act_tasks=0, act_nodes=0,
                   act_scatter=0, act_demoted=0) -> torch.Tensor:
    """The [TELEM_WIDTH] int32 frame for a solve's decision arrays, on
    their device. ``stride`` maps task_seq to a wave slot (seq // stride,
    clipped); untouched tasks hold int32 max in task_seq and weigh 0."""
    i32 = torch.int32
    dev = task_state.device
    valid = task_valid.to(torch.bool)
    state = task_state.to(i32)
    placed = valid & ((state == _ALLOC) | (state == _ALLOC_OB)
                      | (state == _PIPELINE))
    slot = torch.clamp(task_seq.to(i32) // max(int(stride), 1), 0,
                       WAVE_SLOTS - 1).to(torch.int64)
    wave_bound = torch.zeros(WAVE_SLOTS, dtype=i32, device=dev).index_add_(
        0, slot, placed.to(i32))
    head = torch.stack([
        torch.tensor(engine, dtype=i32, device=dev),
        torch.as_tensor(waves, dtype=i32).to(dev).reshape(()),
        placed.sum().to(i32),
        (valid & (state == _FAIL)).sum().to(i32),
        (valid & (state == _SKIP)).sum().to(i32),
        valid.sum().to(i32)])
    tail = torch.tensor(
        [int(pool_occ), int(bucket_fill), int(bool(narrow)),
         int(bool(narrow_gate)), int(retries), int(stranded),
         int(act_tasks), int(act_nodes), int(act_scatter),
         int(act_demoted)], dtype=i32, device=dev)
    return torch.cat([head, wave_bound, tail])


def host_frame(engine: int, **fields) -> np.ndarray:
    """Numpy frame for engines whose telemetry is assembled host-side
    from the already-read-back packed block (the victim kernels: their
    result block is a bool bitmap, so the frame is derived from the
    same single readback instead of widening the transfer 4x).
    Unknown field names are a programming error."""
    out = np.zeros(TELEM_WIDTH, np.int32)
    out[F_ENGINE] = engine
    index = {name: i for i, name in enumerate(FIELDS)}
    for name, val in fields.items():
        out[index[name]] = int(val)
    return out
