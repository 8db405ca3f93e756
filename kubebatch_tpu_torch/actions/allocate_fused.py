"""Host wrapper for the fused allocate solve: session -> tensors -> ONE
solve on the device -> ONE counted copy back -> replay the decisions
through the Session.

The replay (ssn.allocate / ssn.pipeline in the solve's assignment order)
keeps host-side plugin state, event handlers, and the gang dispatch
barrier identical to what the per-visit paths produce — the kernel
only *decides*, the Session still *applies*.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from .. import obs
from ..device import to_host
from ..faults import check as _fault_check
from ..framework import Session
from ..kernels.fused import fused_allocate, unpack_host_block
from ..kernels.narrow import narrow_enabled
from ..kernels.pack import pack_inputs, unpack
from .cycle_inputs import EMPTY_CYCLE, build_cycle_inputs, replay_decisions

#: per-cycle inputs shipped as packed buffers (see kernels/pack.py);
#: node-axis arrays live on the DeviceSession already
_F32 = ("resreq", "init_resreq", "task_nz", "sig_scores", "job_priority",
        "q_weight", "q_deserved", "q_alloc0", "j_alloc0", "cluster_total",
        "dyn_weights")
_I32 = ("task_job", "task_rank", "task_sig", "min_available",
        "order_min_available", "init_allocated", "job_queue",
        "job_create_rank", "q_entries", "q_create_rank")
_BOOL = ("task_valid", "job_valid", "sig_pred")

#: host wall milliseconds of the last execute_fused's phases (tensorize,
#: upload, solve, sync, replay) plus ``kernel`` — the solve's device time
#: from CUDA events when it ran on the card
last_phases: Dict[str, float] = {}


def prepare_fused(inputs):
    """The (args, statics) of the fused solve for these CycleInputs:
    args maps every fused_allocate argument name to a tensor on the
    DeviceSession's device (the per-cycle arrays uploaded as three packed
    buffers), statics holds the keyword options."""
    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    j_pad = inputs.job_valid.shape[0]
    q_pad = inputs.q_weight.shape[0]
    max_iters = int(t_pad + 3 * j_pad + q_pad + 8)
    buf_f, lay_f, buf_i, lay_i, buf_b, lay_b = pack_inputs(
        lambda n: getattr(inputs, n), _F32, _I32, _BOOL)
    dev = device.device
    args = dict(idle=device.idle, releasing=device.releasing,
                backfilled=device.backfilled,
                allocatable_cm=device.allocatable_cm, nz_req0=device.nz_req,
                max_task_num=device.max_task_num, n_tasks=device.n_tasks,
                node_ok=device.node_ok)
    for buf, lay in ((buf_f, lay_f), (buf_i, lay_i), (buf_b, lay_b)):
        args.update(unpack(torch.from_numpy(buf).to(dev), lay))
    # AUTO narrow requires a bf16-exact score scale (kernels/narrow.py)
    n_pad = int(device.node_ok.shape[0])
    narrow = narrow_enabled(
        n_pad, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None))
    statics = dict(
        job_keys=inputs.job_keys, queue_keys=inputs.queue_keys,
        gang_enabled=inputs.gang_enabled,
        prop_overused=inputs.prop_overused,
        dyn_enabled=inputs.dyn_enabled, max_iters=max_iters,
        narrow=narrow,
        # telemetry: the shape thresholds alone wanted the narrow store
        # but the score/weight scale refused it
        narrow_gate=(not narrow and narrow_enabled(n_pad, t_pad)))
    return args, statics


def execute_fused(ssn: Session) -> bool:
    """Run the whole allocate action as one device solve. Returns False —
    without consuming any state — when the snapshot has features the
    solve can't express (the caller falls back to the host path)."""
    t0 = time.perf_counter()
    inputs = build_cycle_inputs(ssn)
    t1 = time.perf_counter()
    if inputs is EMPTY_CYCLE:
        return True
    if inputs is None:
        return False
    # injection seam: after the support gates, before the dispatch
    _fault_check("device.dispatch")
    device = inputs.device
    args, statics = prepare_fused(inputs)
    t2 = time.perf_counter()
    on_card = device.device.type == "cuda"
    with obs.span("fused_allocate", cat="kernel") as sp:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        host_block, idle_f, rel_f, ntasks_f, nz_f = fused_allocate(
            **args, **statics)
        if on_card:
            end.record()
        t3 = time.perf_counter()
        with obs.span("readback", cat="readback"):
            host = to_host(host_block)  # the cycle's ONE device->host copy
        t4 = time.perf_counter()
        task_state, task_node, task_seq, _, telem = unpack_host_block(host)
        obs.telemetry.record(telem, span=sp)
    device.idle, device.releasing, device.n_tasks = idle_f, rel_f, ntasks_f
    device.nz_req = nz_f
    replay_decisions(ssn, inputs, task_state, task_node, task_seq)
    t5 = time.perf_counter()
    last_phases.clear()
    last_phases.update(tensorize=(t1 - t0) * 1e3, upload=(t2 - t1) * 1e3,
                       solve=(t3 - t2) * 1e3, sync=(t4 - t3) * 1e3,
                       replay=(t5 - t4) * 1e3,
                       kernel=(start.elapsed_time(end) if on_card
                               else float("nan")))
    return True
