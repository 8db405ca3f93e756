"""Unschedulability explainer — why is a pending pod still pending?
(ref: kubebatch_tpu/obs/explain.py)

kube-batch answers this with per-pod ``Unschedulable`` events; here the
answer comes from the device-resident predicate state. An opt-in debug
pass (``Scheduler(explain_unschedulable=True)``, never on by default):
for every still-pending task it counts, over the candidate nodes, the
nodes that fail each of a fixed set of reasons, in one launch of
``csrc/explain_counts.cu`` on a CUDA cache, and reads the [T, 6] counts
back in exactly one counted copy. The counts fold into per-job reasons
on the host:

    {"job": "sim/job-0042", "pending": 143, "unschedulable": 143,
     "reasons": {"port-conflict": 143}, ...}

meaning "143 tasks failed port-conflict on all candidate nodes".

Reasons, over CANDIDATE nodes (real, schedulable rows):

- ``no-candidate-nodes`` — the cluster has zero schedulable nodes;
- ``predicate``     — the task's static predicate signature row (node
  selector, required node affinity, taints: kernels/encode.py) excludes
  the node;
- ``resources``     — some request dimension exceeds the node's idle
  capacity (``resreq <= idle`` fails, no epsilon: the task cannot
  allocate now; it may still pipeline);
- ``task-slots``    — the node is at its max_task_num pod cap;
- ``port-conflict`` — a required host port is already claimed on the
  node (affinity vocabulary present only).

A reason is BLOCKING for a task when it fails on every candidate node; a
task is unschedulable when no candidate node passes all reasons.

:func:`failure_counts_device` reads the device session's live carry
(idle, n_tasks, max_task_num, node_ok): the state the next solve would
see. :func:`failure_counts_host` reads the ``NodeState`` host mirror;
the two agree on freshly built inputs.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import to_host
from ..kernels import _build

REASONS = ("predicate", "resources", "task-slots", "port-conflict")

__all__ = ["REASONS", "ARG_DTYPES", "explain_counts",
           "explain_counts_plain", "explain_args",
           "failure_counts_host", "failure_counts_device", "fold_reasons",
           "summarize", "explain_session", "latest", "set_latest"]


# ---------------------------------------------------------------------
# the [T, 6] counts: kernel and plain version
# ---------------------------------------------------------------------

def explain_counts_plain(idle, node_ok, n_tasks, max_task_num, sig_pred,
                         task_sig, task_valid, resreq, task_ports, port_base,
                         has_ports: bool) -> torch.Tensor:
    """Per-task failure counts over the candidate nodes as one int32
    [T, 6] block: the four reason columns, the eligible-node count and
    the candidate count (on every row); columns 0-4 are zero on padded
    task rows. ``idle`` [N, 3] f32, ``node_ok`` [N] bool, ``n_tasks`` /
    ``max_task_num`` [N] i32, ``sig_pred`` [S, N] bool, ``task_sig`` [T]
    i32, ``task_valid`` [T] bool, ``resreq`` [T, 3] f32, ``task_ports``
    [T, PT] bool, ``port_base`` [N, PT] bool (read only with
    ``has_ports``)."""
    i32 = torch.int32
    cand = node_ok[None, :]
    pred_ok = sig_pred[task_sig.long()]                          # [T, N]
    res_ok = torch.all(resreq[:, None, :] <= idle[None, :, :], dim=-1)
    slots_ok = (n_tasks < max_task_num)[None, :]
    if has_ports:
        # 0/1 products summed in float32: exact up to PT <= 64
        conflict = (task_ports.to(torch.float32)
                    @ port_base.to(torch.float32).T) > 0
        ports_ok = ~conflict
    else:
        ports_ok = torch.ones_like(pred_ok)

    def count_fail(ok):
        return (~ok & cand).sum(dim=1, dtype=i32)

    counts = torch.stack([count_fail(pred_ok), count_fail(res_ok),
                          count_fail(slots_ok.expand_as(res_ok)),
                          count_fail(ports_ok)], dim=1)
    eligible = (pred_ok & res_ok & slots_ok & ports_ok & cand).sum(
        dim=1, dtype=i32)
    tvalid = task_valid.to(i32)
    n_cand = node_ok.sum(dtype=i32)
    return torch.cat([counts * tvalid[:, None], (eligible * tvalid)[:, None],
                      n_cand.expand(tvalid.shape[0])[:, None]], dim=1)


#: the phase timers of csrc/explain_counts.cu, in its order: the ring's
#: waits, the compaction to candidates, the cells, the cluster's sum
PHASES = ("stage", "compact", "cells", "reduce")
#: the latest launch: its phase timers (``phase_ns``, an int64 tensor on
#: the card, PHASES order) and its sizes (``sizes``: T_pad, N_pad, S_pad
#: and PT, 0 without ports; :func:`launch_shape` reads the cluster)
last_launch: Dict[str, object] = {}

#: explain_counts' tensor arguments and their dtypes, in call order
ARG_DTYPES = (("idle", torch.float32), ("node_ok", torch.bool),
              ("n_tasks", torch.int32), ("max_task_num", torch.int32),
              ("sig_pred", torch.bool), ("task_sig", torch.int32),
              ("task_valid", torch.bool), ("resreq", torch.float32),
              ("task_ports", torch.bool), ("port_base", torch.bool))


def explain_counts(idle, node_ok, n_tasks, max_task_num, sig_pred, task_sig,
                   task_valid, resreq, task_ports, port_base,
                   has_ports: bool) -> torch.Tensor:
    """The [T, 6] counts on the tensors' device: one launch of
    ``csrc/explain_counts.cu`` for CUDA tensors, the plain version for
    CPU tensors."""
    args = (idle, node_ok, n_tasks, max_task_num, sig_pred, task_sig,
            task_valid, resreq, task_ports, port_base)
    devs = {a.device.type for a in args}
    if devs == {"cpu"}:
        return explain_counts_plain(*args, has_ports=has_ports)
    if devs != {"cuda"}:
        raise ValueError(f"explain_counts: mixed devices {devs}")
    n, t = idle.shape[0], task_valid.shape[0]
    pt = task_ports.shape[1]
    want = {"idle": (n, 3), "node_ok": (n,), "n_tasks": (n,),
            "max_task_num": (n,), "sig_pred": (sig_pred.shape[0], n),
            "task_sig": (t,), "task_valid": (t,), "resreq": (t, 3),
            "task_ports": (t, pt), "port_base": (n, pt)}
    for a, (name, dtype) in zip(args, ARG_DTYPES):
        if a.dtype != dtype or tuple(a.shape) != want[name] \
                or not a.is_contiguous():
            raise ValueError(f"explain_counts: {name} must be a contiguous "
                             f"{dtype} {want[name]}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if not 1 <= pt <= 64:
        raise ValueError(f"explain_counts: {pt} ports, the kernel packs "
                         f"1 to 64 into one word")
    if n == 0 or sig_pred.shape[0] == 0:
        raise ValueError("explain_counts: the kernel takes at least one "
                         "node and one signature row")
    for a, (name, _) in zip(args, ARG_DTYPES):
        if a.data_ptr() % 4:
            raise ValueError(f"explain_counts: {name} must start on a "
                             f"4-byte boundary (the kernel stages 4-byte "
                             f"units)")
    out = torch.empty((t, 6), dtype=torch.int32, device=idle.device)
    if t == 0:
        return out
    phase_ns = torch.empty(len(PHASES), dtype=torch.int64,
                           device=idle.device)
    lib = _build.library("explain_counts.cu")
    err = lib.kb_explain_counts(
        *(a.data_ptr() for a in args), t, n, sig_pred.shape[0], pt,
        int(bool(has_ports)), out.data_ptr(), phase_ns.data_ptr(),
        torch.cuda.current_stream(idle.device).cuda_stream)
    _build.check_launch("explain_counts", err)
    _build.count_launch("explain_counts")
    last_launch.update(phase_ns=phase_ns, sizes=(
        t, n, sig_pred.shape[0], pt if has_ports else 0))
    return out


def launch_shape(t_pad: int, n_pad: int, s_pad: int, pt: int) -> dict:
    """The launch csrc/explain_counts.cu makes for these sizes (pt 0
    without ports), read from the built kernel: the cluster's CTAs, the
    raw nodes of a chunk, whether the predicate bytes ride the ring, the
    shared bytes a CTA and the tiles of task rows."""
    import ctypes

    info = (ctypes.c_int * 5)()
    err = _build.library("explain_counts.cu").kb_explain_shape(
        int(t_pad), int(n_pad), int(s_pad), int(pt), ctypes.addressof(info))
    _build.check_launch("explain_counts shape", err)
    return dict(zip(("ctas", "chunk", "pred_staged", "smem_bytes", "tiles"),
                    info))


def explain_args(inputs) -> Tuple[Dict[str, torch.Tensor], bool]:
    """explain_counts' arguments for CycleInputs: the device session's
    live carry and the cycle's task and signature arrays uploaded to its
    device, and ``has_ports``."""
    device = inputs.device
    dev = device.device
    aff = inputs.affinity
    has_ports = bool(aff is not None and np.any(aff.task_ports))
    t_pad = inputs.task_valid.shape[0]
    if has_ports:
        task_ports, port_base = aff.task_ports, aff.port_base
    else:
        # one-wide placeholders: the kernel reads no port word then
        task_ports = np.zeros((t_pad, 1), bool)
        port_base = np.zeros((device.n_padded, 1), bool)

    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

    args = {"idle": device.idle, "node_ok": device.node_ok,
            "n_tasks": device.n_tasks, "max_task_num": device.max_task_num,
            "sig_pred": up(inputs.sig_pred, bool),
            "task_sig": up(inputs.task_sig, np.int32),
            "task_valid": up(inputs.task_valid, bool),
            "resreq": up(inputs.resreq, np.float32),
            "task_ports": up(task_ports, bool),
            "port_base": up(port_base, bool)}
    return {k: v.contiguous() for k, v in args.items()}, has_ports


def failure_counts_device(inputs) -> Tuple[np.ndarray, np.ndarray, int]:
    """(counts [T_real, 4], eligible [T_real], n_candidates) from the
    device session's live carry: one explain_counts launch and ONE
    counted device->host copy."""
    from . import span

    args, has_ports = explain_args(inputs)
    packed = explain_counts(**args, has_ports=has_ports)
    with span("readback", cat="readback"):
        host = to_host(packed)         # the explainer's ONE copy back
    n_real = len(inputs.tasks)
    return (host[:n_real, :4], host[:n_real, 4],
            int(host[0, 5]) if len(host) else 0)


# ---------------------------------------------------------------------
# host oracle — same semantics from the numpy mirror, no device work
# ---------------------------------------------------------------------

def failure_counts_host(inputs) -> Tuple[np.ndarray, np.ndarray, int]:
    """The numpy twin of failure_counts_device, computed from the device
    session's host mirror (NodeState)."""
    state = inputs.device.state
    cand = np.asarray(state.schedulable & state.valid)          # [N_pad]
    n_cand = int(cand.sum())
    t_real = len(inputs.tasks)
    idle = np.asarray(state.idle, np.float32)
    pred_ok = np.asarray(inputs.sig_pred)[
        np.asarray(inputs.task_sig)[:t_real]]                   # [T, N]
    res_ok = np.all(np.asarray(inputs.resreq, np.float32)[:t_real, None, :]
                    <= idle[None, :, :], axis=-1)
    slots_ok = np.broadcast_to(
        (np.asarray(state.n_tasks)
         < np.asarray(state.max_task_num))[None, :], res_ok.shape)
    aff = inputs.affinity
    if aff is not None and np.any(aff.task_ports):
        conflict = (aff.task_ports[:t_real].astype(np.int32)
                    @ aff.port_base.T.astype(np.int32)) > 0
        ports_ok = ~conflict
    else:
        ports_ok = np.ones_like(pred_ok)
    candf = cand[None, :]

    def count_fail(ok):
        return np.sum(~ok & candf, axis=1).astype(np.int32)

    counts = np.stack([count_fail(pred_ok), count_fail(res_ok),
                       count_fail(slots_ok), count_fail(ports_ok)], axis=1)
    eligible = np.sum(pred_ok & res_ok & slots_ok & ports_ok & candf,
                      axis=1).astype(np.int32)
    return counts, eligible, n_cand


# ---------------------------------------------------------------------
# folding into per-job structured reasons
# ---------------------------------------------------------------------

def fold_reasons(inputs, counts: np.ndarray, eligible: np.ndarray,
                 n_cand: int) -> dict:
    """Fold the [T, R] failure counts into the structured snapshot
    served by /debug/explain."""
    per_job: Dict[int, dict] = {}
    task_job = np.asarray(inputs.task_job)
    for i in range(len(inputs.tasks)):
        ji = int(task_job[i])
        rec = per_job.get(ji)
        if rec is None:
            job = inputs.jobs[ji] if 0 <= ji < len(inputs.jobs) else None
            rec = per_job[ji] = {
                "job": (f"{job.namespace}/{job.name}" if job is not None
                        else f"job[{ji}]"),
                "pending": 0, "unschedulable": 0,
                "reasons": {},
            }
        rec["pending"] += 1
        if n_cand == 0:
            rec["unschedulable"] += 1
            rec["reasons"]["no-candidate-nodes"] = \
                rec["reasons"].get("no-candidate-nodes", 0) + 1
            continue
        if int(eligible[i]) == 0:
            rec["unschedulable"] += 1
            for r, name in enumerate(REASONS):
                if int(counts[i, r]) == n_cand:
                    rec["reasons"][name] = rec["reasons"].get(name, 0) + 1
    jobs = sorted(per_job.values(),
                  key=lambda r: (-r["unschedulable"], r["job"]))
    return {
        "ts": time.time(),
        "candidate_nodes": n_cand,
        "pending_tasks": int(sum(r["pending"] for r in jobs)),
        "unschedulable_tasks": int(sum(r["unschedulable"] for r in jobs)),
        "jobs": [r for r in jobs if r["pending"]],
    }


def summarize(snapshot: dict, limit: int = 8) -> List[str]:
    """Human lines per job: '143 tasks failed port-conflict on all
    candidate nodes'."""
    lines = []
    for rec in snapshot.get("jobs", ())[:limit]:
        if not rec["unschedulable"]:
            continue
        if rec["reasons"]:
            why = "; ".join(
                f"{n} tasks failed {reason} on all candidate nodes"
                for reason, n in sorted(rec["reasons"].items(),
                                        key=lambda kv: -kv[1]))
        else:
            why = (f"{rec['unschedulable']} tasks have no single node "
                   f"passing every reason (mixed per-node failures)")
        lines.append(f"{rec['job']}: {why}")
    return lines


# ---------------------------------------------------------------------
# session entry point + the /debug/explain snapshot
# ---------------------------------------------------------------------

_lock = threading.Lock()
_latest: Optional[dict] = None


def explain_session(ssn) -> dict:
    """Run the explainer against a live Session (after the actions,
    before close: the pending set is what this cycle could not place).
    Builds cycle inputs through the solvers' own tensorize path (the
    cached device snapshot is reused), runs the device pass (one launch,
    one counted copy), folds, and publishes the snapshot for
    /debug/explain."""
    from ..actions.cycle_inputs import EMPTY_CYCLE, build_cycle_inputs

    inputs = build_cycle_inputs(ssn, allow_affinity=True)
    if inputs is EMPTY_CYCLE:
        snap = {"ts": time.time(), "candidate_nodes": len(ssn.nodes),
                "pending_tasks": 0, "unschedulable_tasks": 0, "jobs": []}
    elif inputs is None:
        # over the device vocabulary: no device arrays to fold
        snap = {"ts": time.time(), "error":
                "cycle features exceed the device vocabulary; "
                "explainer has no predicate tensors for this snapshot"}
    else:
        counts, eligible, n_cand = failure_counts_device(inputs)
        snap = fold_reasons(inputs, counts, eligible, n_cand)
    set_latest(snap)
    return snap


def set_latest(snapshot: Optional[dict]) -> None:
    global _latest
    with _lock:
        _latest = snapshot


def latest() -> Optional[dict]:
    """The most recent snapshot (None when the explainer never ran)."""
    with _lock:
        return _latest
