"""Host wrapper for the round-based allocate solves: session -> tensors ->
ONE solve on the device (every round inside it) -> ONE counted copy back
-> replay the decisions through the Session.

Same tensorization and replay as the fused path (actions/cycle_inputs.py)
— only the device algorithm differs: kernels/batched.py places many tasks
per round instead of one per loop iteration (see its docstring for the
faithfulness contract), with the inter-pod affinity / host-port
vocabulary in its rounds; at cluster scale the two-level engine
(kernels/hier.py) runs those rounds pool by pool, and on steady cycles
the active-set engine (kernels/activeset.py) claims the cycle first; with
a node mesh of more than one rank the sharded engine
(kernels/batched_sharded.py) runs the rounds with the node axis split
over it.
"""
from __future__ import annotations

import time
from typing import Dict

from ..faults import check as _fault_check
from ..framework import Session
from ..kernels import activeset as _activeset
from ..kernels.batched import solve_batched
from ..kernels.batched_sharded import solve_batched_sharded
from ..kernels.hier import solve_hier
from ..metrics import count_engine_demotion
from ..parallel.mesh import world_size
from .cycle_inputs import (EMPTY_CYCLE, build_cycle_inputs, cycle_supported,
                           replay_decisions)

batched_supported = cycle_supported

#: host wall milliseconds of the last execute_batched's phases (tensorize,
#: upload, solve, sync, replay) plus ``kernel`` — the solve's device time
#: from CUDA events when it ran on the card; the same names as
#: allocate_fused.last_phases
last_phases: Dict[str, float] = {}

#: rounds, telemetry frame and whether the affinity vocabulary rode the
#: last solve
last_solve: Dict[str, object] = {}


def execute_batched(ssn: Session, hier: bool = False,
                    activeset: bool = False, inputs=None,
                    sharded: bool = False, mesh=None):
    """Run the whole allocate action as one solve. Returns the engine that
    ran ("activeset" / "hier" / "batched", truthy), or False — without
    consuming any state — when the snapshot has features the solves
    can't express (the caller decides what happens then). Inter-pod
    affinity and host ports ride the batched solve (kernels/affinity.py);
    a vocabulary past its caps refuses, counted in
    metrics.affinity_host_fallback_total.

    ``hier``: the two-level engine (auto at AUTO_HIER_MIN_NODES nodes or
    more). The two-level engine has no affinity carry: like the
    reference, an affinity cycle demotes to the batched engine (counted
    in engine_demotions_total). ``activeset``: the active-set engine may
    claim the cycle first; it declines (and the two-level solve runs)
    for a cold-sized active set, inexact pairs, or once demoted.

    ``sharded``: the node-sharded engine over ``mesh`` (rank 0 of a
    node mesh, parallel/mesh.py), the affinity vocabulary included; with
    no mesh or a one-rank mesh it demotes to batched, counted, as the
    reference does on one device. A hier cycle with affinity keeps the
    sharded upgrade when a mesh of more than one rank is attached (the
    reference's demotion goes to its sharded engine there), counted as
    ("hier", "sharded").

    ``inputs``: this session's CycleInputs when the caller built them
    already (the pipelined executor, falling back here when the
    asynchronous dispatch declines): building them consumes one-shot
    cache state (the event fold's active rows), so a second build in
    one session would see an empty active set."""
    t0 = time.perf_counter()
    if inputs is None:
        inputs = build_cycle_inputs(ssn, allow_affinity=True)
    t1 = time.perf_counter()
    if inputs is EMPTY_CYCLE:
        return "hier" if hier else "batched"
    if inputs is None:
        return False
    # injection seam: after the support gates (no state consumed yet),
    # before the device dispatch and the replay
    _fault_check("device.dispatch")
    phases: Dict[str, float] = {}
    res = None
    engine = "batched"
    if hier and inputs.affinity is None:
        if activeset:
            res = _activeset.solve_cycle(inputs, phases=phases)
            engine = "activeset"
        if res is None:
            res = solve_hier(inputs, phases=phases)
            engine = "hier"
    elif hier:
        # the two-level engine has no affinity carry: the reference
        # demotes the cycle to the flat engines, keeping the sharded
        # upgrade when a mesh is there
        sharded = world_size(mesh) > 1
        count_engine_demotion("hier", "sharded" if sharded else "batched")
    if res is None and sharded:
        if world_size(mesh) > 1:
            t2 = time.perf_counter()
            res = solve_batched_sharded(mesh, inputs.device, inputs)
            phases["solve"] = (time.perf_counter() - t2) * 1e3
            engine = "sharded"
        else:
            # one device: the mesh adds nothing, the one-card engine runs
            count_engine_demotion("sharded", "batched")
    if res is None:
        res = solve_batched(inputs, phases=phases)
    task_state, task_node, task_seq, rounds, telem = res
    t4 = time.perf_counter()
    replay_decisions(ssn, inputs, task_state, task_node, task_seq)
    t5 = time.perf_counter()
    last_phases.clear()
    last_phases.update(tensorize=(t1 - t0) * 1e3, **phases,
                       replay=(t5 - t4) * 1e3)
    last_solve.clear()
    last_solve.update(rounds=rounds, telemetry=telem.tolist(),
                      affinity=inputs.affinity is not None)
    return engine
