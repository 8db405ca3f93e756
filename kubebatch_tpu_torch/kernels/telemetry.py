"""Solve telemetry — one fixed-width int32 frame per dispatch, riding the
engine's packed host block so it costs no extra device->host copy.

Field layout and engine ids match the reference package's frame word for
word (kubebatch_tpu/kernels/telemetry.py), so the two host blocks compare
directly. The CUDA fused kernel writes the same frame in its epilogue
(csrc/fused_allocate.cu); :func:`decision_frame` is the plain PyTorch
version the plain fused engine uses.
"""
from __future__ import annotations

import torch

__all__ = ["TELEM_WIDTH", "WAVE_SLOTS", "FIELDS", "ENGINE_NAMES",
           "ENGINE_FUSED", "decision_frame"]

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
F_NARROW = 12       # narrow score dtype engaged for this dispatch (0/1)
F_NARROW_GATE = 13  # shape wanted narrow but the exactness gate refused

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

ENGINE_NAMES = {ENGINE_VISIT: "visit", ENGINE_BATCHED: "batched",
                ENGINE_FUSED: "fused"}

# decision codes (solver.py/fused.py agree on these)
_SKIP, _ALLOC, _ALLOC_OB, _PIPELINE, _FAIL = 0, 1, 2, 3, 4


def decision_frame(engine: int, task_state: torch.Tensor,
                   task_seq: torch.Tensor, task_valid: torch.Tensor,
                   waves, stride: int, *, narrow: bool = False,
                   narrow_gate: bool = False) -> torch.Tensor:
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
    tail = torch.zeros(TELEM_WIDTH - 6 - WAVE_SLOTS, dtype=i32, device=dev)
    tail[F_NARROW - 6 - WAVE_SLOTS] = 1 if narrow else 0
    tail[F_NARROW_GATE - 6 - WAVE_SLOTS] = 1 if narrow_gate else 0
    return torch.cat([head, wave_bound, tail])
