"""Snapshot tensorization — ClusterInfo becomes dense host arrays.

This is the layer with no reference counterpart: the per-entity structs of
pkg/scheduler/api (Resource rows, NodeInfo accounting, TaskInfo requests)
are projected onto fixed-shape float32/int32 numpy arrays, which the
device session copies to the card. Pure Python gathers (no native
packer). Axis conventions:

- node axis: order of ``NodeState.names`` (padded to a pow2 bucket so
  shapes repeat across cycles; padded rows are masked invalid)
- resource axis: [cpu_milli, mem_MiB, gpu_milli] (api.resource.RESOURCE_NAMES)

The epsilon-fit rule on device is elementwise ``req <= avail + VEC_EPS``
(strictly mirroring Resource.less_equal: ``r < R or |R - r| < eps`` equals
``r < R + eps`` for the operands we produce, since requests and availability
are finite floats).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..api import NodeInfo, TaskInfo
from ..api.resource import RESOURCE_DIM, VEC_EPS, VEC_SCALE

__all__ = ["NodeState", "TaskBatch", "pad_to_bucket", "sticky_bucket",
           "VEC_EPS", "batch_clone_tasks", "batch_set_attr",
           "NONZERO_MILLI_CPU", "NONZERO_MEM_MIB"]

#: upstream DefaultNonZeroRequest (priorityutil.GetNonzeroRequests) in
#: device units: 100m CPU, 200MB memory (= 200 MiB exactly)
NONZERO_MILLI_CPU = 100.0
NONZERO_MEM_MIB = 200.0


def pack_node_raw(nodes_seq) -> np.ndarray:
    """[k, 4, RESOURCE_DIM] float64 HOST-unit idle/releasing/backfilled/
    allocatable rows for a list of NodeInfo — THE node extraction, shared
    by every NodeState build."""
    k = len(nodes_seq)
    return np.array(
        [(ni.idle.milli_cpu, ni.idle.memory, ni.idle.milli_gpu,
          ni.releasing.milli_cpu, ni.releasing.memory,
          ni.releasing.milli_gpu,
          ni.backfilled.milli_cpu, ni.backfilled.memory,
          ni.backfilled.milli_gpu,
          ni.allocatable.milli_cpu, ni.allocatable.memory,
          ni.allocatable.milli_gpu) for ni in nodes_seq],
        np.float64).reshape(k, 4, RESOURCE_DIM)


def accumulate_nz(tasks, rows, n_rows: int) -> np.ndarray:
    """[n_rows, 2] float32 per-row sums of nonzero (cpu_milli, mem_MiB)
    requests — upstream GetNonzeroRequests semantics, accumulated in
    float64 and cast ONCE."""
    out = np.zeros((n_rows, 2), np.float64)
    if tasks:
        res = np.empty((len(tasks), 2), np.float64)
        for i, t in enumerate(tasks):
            res[i] = (t.resreq.milli_cpu, t.resreq.memory)
        nz = np.empty((len(tasks), 2), np.float64)
        nz[:, 0] = np.where(res[:, 0] != 0, res[:, 0], NONZERO_MILLI_CPU)
        mem_mib = res[:, 1] / (1024.0 * 1024.0)
        nz[:, 1] = np.where(mem_mib != 0, mem_mib, NONZERO_MEM_MIB)
        np.add.at(out, np.asarray(rows, np.int64), nz)
    return out.astype(np.float32)


#: above this, buckets re-grain from pow2 to multiples of LARGE_GRAIN:
#: pow2 padding wastes up to 2x, and at cfg6/cfg7 axis sizes (50-100k)
#: that waste is [T, N]-squared — 100k nodes would pad to 131072 (+31%)
#: where the 4096 grain pads to 102400 (+2.4%). Every config at or
#: below cfg5 scale (axes <= 16384) keeps its historical pow2 bucket,
#: so existing compile signatures don't move.
LARGE_BUCKET = 16384
LARGE_GRAIN = 4096


def pad_to_bucket(n: int, minimum: int = 8) -> int:
    """Next bucket >= max(n, minimum) — keeps shapes repeating across
    cycles while cluster size drifts. Power-of-two up to LARGE_BUCKET;
    past it, the next multiple of LARGE_GRAIN (the cfg6/cfg7 re-bucket:
    fewer, denser buckets so one cluster-size step costs one bounded
    compile, and [T, N] padding waste stays a few percent, not 2x)."""
    if n > LARGE_BUCKET:
        return -(-n // LARGE_GRAIN) * LARGE_GRAIN
    b = minimum
    while b < n:
        b *= 2
    return b


#: sticky_bucket state: key -> [held bucket, consecutive one-below calls]
_STICKY: Dict[str, list] = {}


def sticky_bucket(key: str, n: int, minimum: int = 8,
                  decay: int = 12, store: Optional[dict] = None) -> int:
    """pad_to_bucket with one-bucket hysteresis per call-site ``key``.

    A steady churn regime whose entity count oscillates across a pow2
    boundary (e.g. 250..260 pending around 256) would otherwise flip the
    padded shape every few cycles. Holding the larger bucket while the
    count sits ONE bucket below pins the shape; after ``decay``
    consecutive one-below cycles the hold steps down. A drop of two or
    more buckets snaps down immediately so big shapes never leak onto
    small runs. (The reference package also freezes the decay once its
    compile manager is warm; this package has no compile manager.)

    ``store``: optional per-stream state dict (one per SchedulerCache);
    defaults to the process-global map."""
    st = _STICKY if store is None else store
    b = pad_to_bucket(n, minimum)
    ent = st.get(key)
    if ent is None or b >= ent[0]:
        st[key] = [b, 0]
        return b
    # "one bucket below": the pow2 half-step, or one LARGE_GRAIN step
    # when the HELD bucket sits on the re-grained axis
    one_below = (b * 2 == ent[0]
                 or (ent[0] > LARGE_BUCKET and ent[0] - b == LARGE_GRAIN))
    if one_below:
        ent[1] += 1
        if ent[1] >= decay:
            ent[0], ent[1] = b, 0
            return b
        return ent[0]
    st[key] = [b, 0]
    return b


def batch_clone_tasks(tasks, statuses, node_names):
    """TaskInfo.clone over a whole decision batch, with status/node_name
    overridden in the same pass. ``statuses``: a list (per task) or one
    shared status; ``node_names``: a list of hostnames."""
    per_task = isinstance(statuses, list)
    out = []
    for i, t in enumerate(tasks):
        c = t.clone()
        c.status = statuses[i] if per_task else statuses
        c.node_name = node_names[i]
        out.append(c)
    return out


def extract_resreq(tasks) -> np.ndarray:
    """[n, 3] float64 host-unit resreq rows for a task list."""
    n = len(tasks)
    out = np.empty((n, RESOURCE_DIM), np.float64)
    for i, t in enumerate(tasks):
        rr = t.resreq
        out[i] = (rr.milli_cpu, rr.memory, rr.milli_gpu)
    return out


def batch_set_attr(objs, name: str, values) -> None:
    """objs[i].name = values[i] (list) or = values (shared)."""
    if isinstance(values, list):
        for o, v in zip(objs, values):
            setattr(o, name, v)
    else:
        for o in objs:
            setattr(o, name, values)


@dataclass
class NodeState:
    """Host mirror of the mutable node accounting, in the layout the
    device session uploads. The host NodeInfo structs remain the source
    of truth between actions (see kernels/solver.py)."""
    names: List[str]
    #: [N,R] float32 arrays (MiB-scaled memory)
    idle: np.ndarray
    releasing: np.ndarray
    backfilled: np.ndarray
    allocatable: np.ndarray
    #: [N,2] float32 — nonzero-request (cpu_milli, mem_MiB) sums over the
    #: node's tasks, upstream GetNonzeroRequests semantics (feeds the
    #: in-kernel least-requested / balanced-resource scores)
    nz_requested: np.ndarray
    #: [N] int32 / bool
    max_task_num: np.ndarray
    n_tasks: np.ndarray
    schedulable: np.ndarray   # NOT unschedulable and real (non-padded) node
    valid: np.ndarray         # non-padded row
    index: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_nodes(cls, nodes: Dict[str, NodeInfo],
                   min_bucket: int = 8) -> "NodeState":
        ordered = sorted(nodes.values(), key=lambda ni: ni.name)
        n = len(ordered)
        n_pad = pad_to_bucket(n, min_bucket)
        shape = (n_pad, RESOURCE_DIM)
        idle = np.zeros(shape, np.float32)
        releasing = np.zeros(shape, np.float32)
        backfilled = np.zeros(shape, np.float32)
        allocatable = np.zeros(shape, np.float32)
        nz_requested = np.zeros((n_pad, 2), np.float32)
        max_task_num = np.zeros(n_pad, np.int32)
        n_tasks = np.zeros(n_pad, np.int32)
        schedulable = np.zeros(n_pad, bool)
        valid = np.zeros(n_pad, bool)
        index: Dict[str, int] = {}
        if n:
            # one packed pass instead of per-Resource to_vec array
            # allocations — this runs over every node each snapshot
            raw = pack_node_raw(ordered)
            raw *= VEC_SCALE
            raw32 = raw.astype(np.float32)
            idle[:n] = raw32[:, 0]
            releasing[:n] = raw32[:, 1]
            backfilled[:n] = raw32[:, 2]
            allocatable[:n] = raw32[:, 3]
            max_task_num[:n] = [ni.allocatable.max_task_num for ni in ordered]
            n_tasks[:n] = [len(ni.tasks) for ni in ordered]
            schedulable[:n] = [not (bool(ni.node.unschedulable) if ni.node
                                    else True) for ni in ordered]
            valid[:n] = True
            all_tasks = []
            t_row = []
            for i, ni in enumerate(ordered):
                all_tasks.extend(ni.tasks.values())
                t_row.extend([i] * len(ni.tasks))
            nz_requested[:n] = accumulate_nz(all_tasks, t_row, n)
        for i, ni in enumerate(ordered):
            index[ni.name] = i
        return cls(names=[ni.name for ni in ordered], idle=idle,
                   releasing=releasing, backfilled=backfilled,
                   allocatable=allocatable, nz_requested=nz_requested,
                   max_task_num=max_task_num, n_tasks=n_tasks,
                   schedulable=schedulable, valid=valid, index=index)

    @property
    def n_padded(self) -> int:
        return self.idle.shape[0]


@dataclass
class TaskBatch:
    """A job's pending tasks, in task-order, padded to a pow2 bucket."""
    tasks: List[TaskInfo]
    resreq: np.ndarray        # [T,R] steady-state request (node accounting)
    init_resreq: np.ndarray   # [T,R] launch request (fit checks)
    nz_req: np.ndarray        # [T,2] nonzero (cpu,mem) for dynamic scoring
    valid: np.ndarray         # [T] non-padded row
    #: [T,R] float64 HOST units (memory in bytes) — the exact values the
    #: Resource arithmetic uses; the bulk decision replay sums these per
    #: node/job instead of calling per-task Resource methods
    resreq_raw: np.ndarray = None

    @classmethod
    def from_tasks(cls, tasks: Sequence[TaskInfo],
                   min_bucket: int = 8) -> "TaskBatch":
        t = len(tasks)
        raw = None
        if t:
            raw = np.array(
                [(tk.resreq.milli_cpu, tk.resreq.memory,
                  tk.resreq.milli_gpu,
                  tk.init_resreq.milli_cpu, tk.init_resreq.memory,
                  tk.init_resreq.milli_gpu) for tk in tasks],
                np.float64)
        return cls._from_extracted(tasks, raw, min_bucket)

    @classmethod
    def _from_extracted(cls, tasks, raw, min_bucket: int) -> "TaskBatch":
        t = len(tasks)
        t_pad = pad_to_bucket(t, min_bucket)
        resreq = np.zeros((t_pad, RESOURCE_DIM), np.float32)
        init_resreq = np.zeros((t_pad, RESOURCE_DIM), np.float32)
        nz_req = np.zeros((t_pad, 2), np.float32)
        valid = np.zeros(t_pad, bool)
        resreq_raw = np.zeros((t_pad, RESOURCE_DIM), np.float64)
        if t:
            raw = np.ascontiguousarray(raw).reshape(t, 2, RESOURCE_DIM)
            resreq_raw[:t] = raw[:, 0]
            raw *= VEC_SCALE
            raw32 = raw.astype(np.float32)
            resreq[:t] = raw32[:, 0]
            init_resreq[:t] = raw32[:, 1]
            nz_req[:t, 0] = np.where(resreq[:t, 0] != 0, resreq[:t, 0],
                                     NONZERO_MILLI_CPU)
            nz_req[:t, 1] = np.where(resreq[:t, 1] != 0, resreq[:t, 1],
                                     NONZERO_MEM_MIB)
            valid[:t] = True
        return cls(tasks=list(tasks), resreq=resreq,
                   init_resreq=init_resreq, nz_req=nz_req, valid=valid,
                   resreq_raw=resreq_raw)

    @property
    def t_padded(self) -> int:
        return self.resreq.shape[0]
