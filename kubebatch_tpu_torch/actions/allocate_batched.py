"""Host wrapper for the batched (round-based) allocate solve: session ->
tensors -> ONE solve on the device (every round inside it) -> ONE counted
copy back -> replay the decisions through the Session.

Same tensorization and replay as the fused path (actions/cycle_inputs.py)
— only the device algorithm differs: kernels/batched.py places many tasks
per round instead of one per loop iteration (see its docstring for the
faithfulness contract). The reference package's two-level, active-set and
sharded branches are not in this package (ROADMAP queue A, scale and
multi-device).
"""
from __future__ import annotations

import time
from typing import Dict

from ..framework import Session
from ..kernels.batched import solve_batched
from .cycle_inputs import (EMPTY_CYCLE, build_cycle_inputs, cycle_supported,
                           replay_decisions)

batched_supported = cycle_supported

#: host wall milliseconds of the last execute_batched's phases (tensorize,
#: upload, solve, sync, replay) plus ``kernel`` — the solve's device time
#: from CUDA events when it ran on the card; the same names as
#: allocate_fused.last_phases
last_phases: Dict[str, float] = {}

#: rounds and telemetry frame of the last batched solve
last_solve: Dict[str, object] = {}


def execute_batched(ssn: Session) -> bool:
    """Run the whole allocate action as one batched solve. Returns False —
    without consuming any state — when the snapshot has features the
    solve can't express (the caller decides what happens then)."""
    t0 = time.perf_counter()
    inputs = build_cycle_inputs(ssn)
    t1 = time.perf_counter()
    if inputs is EMPTY_CYCLE:
        return True
    if inputs is None:
        return False
    phases: Dict[str, float] = {}
    task_state, task_node, task_seq, rounds, telem = solve_batched(
        inputs, phases=phases)
    t4 = time.perf_counter()
    replay_decisions(ssn, inputs, task_state, task_node, task_seq)
    t5 = time.perf_counter()
    last_phases.clear()
    last_phases.update(tensorize=(t1 - t0) * 1e3, **phases,
                       replay=(t5 - t4) * 1e3)
    last_solve.clear()
    last_solve.update(rounds=rounds, telemetry=telem.tolist())
    return True
