"""Device session and the shared node-score term.

Decision codes (the host applies them through Session.allocate/pipeline
so plugin event handlers and the gang dispatch barrier still fire):

  0 SKIP      task not processed (job became ready first, or its job was
              never visited)
  1 ALLOC     init_resreq fits node idle -> Allocated
  2 ALLOC_OB  fits idle+backfilled but not idle -> AllocatedOverBackfill
  3 PIPELINE  fits releasing -> Pipelined onto releasing resources
  4 FAIL      no feasible node -> job dropped this cycle (allocate.go:187)

Fit rules mirror allocate.go:153-184: a node is feasible if the launch
request fits accessible (idle+backfilled) OR releasing; the highest-scoring
feasible node wins (ties -> lowest node index); the fit kind is then read
off that node.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..api import NodeInfo
from ..api.resource import VEC_EPS, VEC_SCALE
from ..device import DEFAULT_DEVICE, DeviceLike, resolve_device, to_host
from . import _build
from .telemetry import ENGINE_VISIT, TELEM_WIDTH, decision_frame
from .tensorize import NodeState, TaskBatch, accumulate_nz, pack_node_raw

SKIP, ALLOC, ALLOC_OB, PIPELINE, FAIL = 0, 1, 2, 3, 4


class Decision(NamedTuple):
    kind: int
    node_name: str


def _least_balanced(nz_req: torch.Tensor, t_nz: torch.Tensor,
                    allocatable_cm: torch.Tensor):
    """nodeorder's two allocation-dependent terms over all nodes, [N]
    float32 each (or [..., N] for a batch of requests ``t_nz`` [..., 2]):
    least-requested and balanced-resource, unweighted."""
    f32 = torch.float32
    dev = nz_req.device
    ten = torch.tensor(10.0, dtype=f32, device=dev)
    req = nz_req + t_nz[..., None, :]                   # [..., N, 2]
    cap = allocatable_cm                                # [N,2]
    d = torch.arange(1, 11, dtype=f32, device=dev).view(
        (10,) + (1,) * req.dim())
    ge = (cap - req)[None] * ten >= d * cap
    zero = torch.zeros((), dtype=f32, device=dev)
    one = torch.ones((), dtype=f32, device=dev)
    dim = torch.where((cap > 0) & (req <= cap), ge.sum(dim=0).to(f32), zero)
    least = torch.floor((dim[..., 0] + dim[..., 1]) / 2.0)
    frac = torch.where(cap > 0, req / torch.where(cap > 0, cap, one), one)
    diff = torch.abs(frac[..., 0] - frac[..., 1])
    # 10 - diff * 10 as one fused multiply-add, as XLA:CPU's compiled
    # kernels evaluate it (its LLVM backend contracts the pair on an FMA
    # target): the float64 product and difference are exact, so the one
    # rounding to float32 is the FMA's
    fused = (10.0 - diff.to(torch.float64) * 10.0).to(f32)
    balanced = torch.where((frac[..., 0] >= 1.0) | (frac[..., 1] >= 1.0),
                           zero, torch.trunc(fused))
    return least, balanced


def dynamic_node_score_plain(nz_req: torch.Tensor, t_nz: torch.Tensor,
                             allocatable_cm: torch.Tensor,
                             dyn_weights: torch.Tensor) -> torch.Tensor:
    """nodeorder's allocation-dependent terms over all nodes, [N] float32
    (or [..., N] for a batch of requests ``t_nz`` [..., 2]).

    Mirrors plugins/nodeorder.py least_requested_score /
    balanced_resource_score (upstream k8s-1.13 arithmetic). The Go integer
    division ``((cap - req) * 10) // cap`` is evaluated as a threshold
    count (how many d in 1..10 satisfy (cap-req)*10 >= d*cap), so float32
    rounding can only bite when a product pair is within an ulp of equal.
    dyn_weights: [least_requested_w, balanced_resource_w] float32.
    """
    least, balanced = _least_balanced(nz_req, t_nz, allocatable_cm)
    return least * dyn_weights[0] + balanced * dyn_weights[1]


def scan_node_score_plain(nz_req: torch.Tensor, t_nz: torch.Tensor,
                          allocatable_cm: torch.Tensor,
                          dyn_weights: torch.Tensor) -> torch.Tensor:
    """The dynamic node score as the reference's compiled visit scan
    evaluates it: the weighted sum is one fused multiply-add,
    ``fma(balanced, w1, least * w0)`` (the whole-cycle engines' graphs
    round both products; with integer weights the two agree). The
    float64 product and sum are exact for these small integer-valued
    terms, so the one rounding to float32 is the FMA's."""
    least, balanced = _least_balanced(nz_req, t_nz, allocatable_cm)
    lw = (least * dyn_weights[0]).to(torch.float64)
    return (balanced.to(torch.float64) * dyn_weights[1].to(torch.float64)
            + lw).to(torch.float32)


def dynamic_node_score_np(nz_req: np.ndarray, t_nz: np.ndarray,
                          allocatable_cm: np.ndarray,
                          dyn_weights: np.ndarray) -> np.ndarray:
    """The node score in numpy float32, for the victim chooser's
    host-side fresh-score recompute (kernels/victims.py), as the
    reference's numpy recompute evaluates it: every scalar pinned to
    float32 and, unlike the compiled kernels, 10 - diff * 10 as two
    roundings."""
    f32 = np.float32
    ten = f32(10.0)
    req = nz_req + t_nz[None, :]                      # [N,2]
    cap = allocatable_cm                              # [N,2]
    d = np.arange(1.0, 11.0, dtype=f32)               # [10]
    ge = ((cap - req)[None] * ten >= d[:, None, None] * cap[None])
    dim = np.where((cap > 0) & (req <= cap),
                   ge.sum(axis=0).astype(f32), f32(0.0))   # [N,2]
    least = np.floor((dim[:, 0] + dim[:, 1]) / f32(2.0))
    frac = np.where(cap > 0, req / np.where(cap > 0, cap, f32(1.0)),
                    f32(1.0))
    diff = np.abs(frac[:, 0] - frac[:, 1])
    balanced = np.where((frac[:, 0] >= 1.0) | (frac[:, 1] >= 1.0),
                        f32(0.0), np.trunc(ten - diff * ten))
    return least * dyn_weights[0] + balanced * dyn_weights[1]


def dynamic_node_score(nz_req: torch.Tensor, t_nz: torch.Tensor,
                       allocatable_cm: torch.Tensor,
                       dyn_weights: torch.Tensor) -> torch.Tensor:
    """The node score on the tensors' device: the CUDA kernel
    (csrc/node_score.cu) for CUDA tensors, the plain version for CPU
    tensors."""
    args = (nz_req, t_nz, allocatable_cm, dyn_weights)
    devs = {a.device.type for a in args}
    if devs == {"cpu"}:
        return dynamic_node_score_plain(*args)
    if devs != {"cuda"}:
        raise ValueError(f"dynamic_node_score: mixed devices {devs}")
    n = nz_req.shape[0]
    for name, t, shape in (("nz_req", nz_req, (n, 2)), ("t_nz", t_nz, (2,)),
                           ("allocatable_cm", allocatable_cm, (n, 2)),
                           ("dyn_weights", dyn_weights, (2,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"dynamic_node_score: {name} must be float32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    nz_req, t_nz, allocatable_cm, dyn_weights = (
        a.contiguous() for a in args)
    out = torch.empty(n, dtype=torch.float32, device=nz_req.device)
    lib = _build.library("node_score.cu")
    err = lib.kb_dynamic_node_score(
        nz_req.data_ptr(), t_nz.data_ptr(), allocatable_cm.data_ptr(),
        dyn_weights.data_ptr(), out.data_ptr(), n,
        torch.cuda.current_stream(nz_req.device).cuda_stream)
    _build.check_launch("dynamic_node_score", err)
    _build.count_launch("dynamic_node_score")
    return out


#: argument order of allocate_scan: the node carry and node state, then
#: the job's task batch and its [T, N] rows, then the readiness scalars
#: and the nodeorder weights
SCAN_NODE_ARGS = ("idle", "releasing", "backfilled", "allocatable_cm",
                  "nz_req", "max_task_num", "n_tasks", "node_ok")
SCAN_TASK_ARGS = ("resreq", "init_resreq", "task_nz", "task_valid", "scores",
                  "pred_mask")
SCAN_ARGS = SCAN_NODE_ARGS + SCAN_TASK_ARGS + (
    "min_available", "init_allocated", "dyn_weights")

_SCAN_I32 = {"max_task_num", "n_tasks"}
_SCAN_BOOL = {"node_ok", "task_valid", "pred_mask"}


def scan_arg_dtype(name: str) -> torch.dtype:
    """The dtype allocate_scan takes for tensor argument ``name``."""
    return (torch.bool if name in _SCAN_BOOL
            else torch.int32 if name in _SCAN_I32 else torch.float32)


def allocate_scan_plain(idle, releasing, backfilled, allocatable_cm, nz_req,
                        max_task_num, n_tasks, node_ok, resreq, init_resreq,
                        task_nz, task_valid, scores, pred_mask,
                        min_available: int, init_allocated: int,
                        dyn_weights, dyn_enabled: bool = False):
    """One job visit in plain PyTorch, on the inputs' device: the task
    scan of the reference's ``_allocate_scan`` (kubebatch_tpu/kernels/
    solver.py), one Python step per task row.

    Each step masks the nodes (``node_ok``, a free task slot, the task's
    predicate row, and a launch request that fits idle + backfilled or
    releasing within VEC_EPS), adds the dynamic node score when
    ``dyn_enabled``, takes the lowest-index argmax (-inf for masked nodes:
    every node masked gives node 0 and FAIL), decides, and commits the
    request to the winner: into idle for an allocation, releasing for a
    pipeline; the winner's task count and nonzero sums grow for both. The
    scan stops deciding once the job fails or crosses readiness
    (``min_available``; ALLOC_OB does not count), but every row still
    reports its argmax node, as the reference's scan does.

    Returns ``(packed, idle, releasing, n_tasks, nz_req)``: packed is
    int32 [2T + 1 + TELEM_WIDTH] — decisions, node indices, the
    became-ready flag, the telemetry frame — and the carry is new
    tensors (the inputs are not modified). Float orders are the
    reference's compiled scan's: ``(idle + backfilled) + eps``,
    ``score + dyn`` with dyn from :func:`scan_node_score_plain`, and ``nz_req + 0.0`` on every row the step does not
    place on (a -0.0 sum becomes +0.0; idle and releasing keep their
    -0.0 rows: ``x - 0.0`` is x)."""
    dev = idle.device
    f32, i32 = torch.float32, torch.int32
    eps = torch.from_numpy(VEC_EPS).to(dev)
    neg_inf = torch.tensor(float("-inf"), dtype=f32, device=dev)
    idle = idle.clone()
    rel = releasing.clone()
    n_tasks = n_tasks.clone()
    nz = nz_req + 0.0
    n = idle.shape[0]
    t_pad = resreq.shape[0]
    index = torch.arange(n, device=dev)
    decisions = torch.zeros(t_pad, dtype=i32, device=dev)
    node_idx = torch.zeros(t_pad, dtype=i32, device=dev)
    allocated = int(init_allocated)
    done = False
    for t in range(t_pad):
        accessible = idle + backfilled
        pred = node_ok & (n_tasks < max_task_num) & pred_mask[t]
        req = init_resreq[t]
        fit_alloc = (req <= accessible + eps).all(dim=-1)
        fit_idle = (req <= idle + eps).all(dim=-1)
        fit_pipe = (req <= rel + eps).all(dim=-1)
        eligible = pred & (fit_alloc | fit_pipe)
        score = scores[t]
        if dyn_enabled:
            score = score + scan_node_score_plain(
                nz, task_nz[t], allocatable_cm, dyn_weights)
        masked = torch.where(eligible, score, neg_inf)
        best = int(torch.where(masked == masked.max(), index, n).min()) \
            if n else 0
        feasible = n > 0 and bool(eligible[best])
        is_alloc = n > 0 and bool(fit_alloc[best])
        over_backfill = is_alloc and not bool(fit_idle[best])
        active = bool(task_valid[t]) and not done
        do = active and feasible
        decisions[t] = (SKIP if not active else FAIL if not feasible
                        else PIPELINE if not is_alloc
                        else ALLOC_OB if over_backfill else ALLOC)
        node_idx[t] = best
        if do:
            if is_alloc:
                idle[best] = idle[best] - resreq[t]
            else:
                rel[best] = rel[best] - resreq[t]
            n_tasks[best] += 1
            nz[best] = nz[best] + task_nz[t]
            if not over_backfill:
                allocated += 1
        done = done or (active and not feasible) or (
            do and allocated >= min_available)
    ready = torch.tensor([int(allocated >= min_available)], dtype=i32,
                         device=dev)
    frame = decision_frame(ENGINE_VISIT, decisions, torch.zeros_like(
        decisions), task_valid, waves=1, stride=1)
    packed = torch.cat([decisions, node_idx, ready, frame])
    return packed, idle, rel, n_tasks, nz


def allocate_scan(idle, releasing, backfilled, allocatable_cm, nz_req,
                  max_task_num, n_tasks, node_ok, resreq, init_resreq,
                  task_nz, task_valid, scores, pred_mask,
                  min_available: int, init_allocated: int, dyn_weights,
                  dyn_enabled: bool = False):
    """One job visit on the inputs' device: the CUDA kernel
    (csrc/allocate_scan.cu) for CUDA tensors, :func:`allocate_scan_plain`
    for CPU tensors. Same arguments and results; one launch per call."""
    args = (idle, releasing, backfilled, allocatable_cm, nz_req,
            max_task_num, n_tasks, node_ok, resreq, init_resreq, task_nz,
            task_valid, scores, pred_mask)
    devs = {a.device.type for a in args + (dyn_weights,)}
    if devs == {"cpu"}:
        return allocate_scan_plain(*args, min_available, init_allocated,
                                   dyn_weights, dyn_enabled)
    if devs != {"cuda"}:
        raise ValueError(f"allocate_scan: mixed devices {devs}")
    n = idle.shape[0]
    t_pad = resreq.shape[0]
    shapes = {"idle": (n, 3), "releasing": (n, 3), "backfilled": (n, 3),
              "allocatable_cm": (n, 2), "nz_req": (n, 2),
              "max_task_num": (n,), "n_tasks": (n,), "node_ok": (n,),
              "resreq": (t_pad, 3), "init_resreq": (t_pad, 3),
              "task_nz": (t_pad, 2), "task_valid": (t_pad,),
              "scores": (t_pad, n), "pred_mask": (t_pad, n)}
    named = dict(zip(SCAN_NODE_ARGS + SCAN_TASK_ARGS, args))
    for name, t in named.items():
        if t.dtype != scan_arg_dtype(name) or tuple(t.shape) != shapes[name]:
            raise ValueError(
                f"allocate_scan: {name} must be {scan_arg_dtype(name)} "
                f"{shapes[name]}, got {t.dtype} {tuple(t.shape)}")
    if dyn_weights.dtype != torch.float32 or tuple(dyn_weights.shape) != (2,):
        raise ValueError("allocate_scan: dyn_weights must be float32 (2,)")
    if n == 0 or t_pad == 0:
        raise ValueError("allocate_scan: empty node or task axis")
    c = {k: v.contiguous() for k, v in named.items()}
    dev = idle.device
    out_idle = torch.empty_like(c["idle"])
    out_rel = torch.empty_like(c["releasing"])
    out_nt = torch.empty_like(c["n_tasks"])
    out_nz = torch.empty_like(c["nz_req"])
    packed = torch.empty(2 * t_pad + 1 + TELEM_WIDTH, dtype=torch.int32,
                         device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    lib = _build.library("allocate_scan.cu")
    err = lib.kb_allocate_scan(
        *(c[k].data_ptr() for k in SCAN_NODE_ARGS + SCAN_TASK_ARGS),
        dyn_weights.contiguous().data_ptr(), eps.data_ptr(),
        out_idle.data_ptr(), out_rel.data_ptr(), out_nt.data_ptr(),
        out_nz.data_ptr(), packed.data_ptr(),
        n, t_pad, int(min_available), int(init_allocated),
        int(bool(dyn_enabled)),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("allocate_scan", err)
    _build.count_launch("allocate_scan")
    return packed, out_idle, out_rel, out_nt, out_nz


def ensure_device_snapshot(ssn) -> "DeviceSession":
    """The session's shared DeviceSession, with every node row the
    CURRENT session has touched re-packed from host truth on each call.

    Actions run in sequence against one session; the first device
    consumer builds the snapshot (``cache.device_session`` folds the
    event-dirty AND already-touched rows into a reused DeviceSession),
    but a LATER action must not consume rows an earlier action's
    host-side mutations made stale — reclaim's evictions land on host
    NodeInfo between the victim build and allocate's solve, and
    backfill's host-only placements can re-touch nodes a previous sync
    already covered. Re-packing the full touched set is idempotent (host
    truth is authoritative after each action's replay) and O(touched)."""
    device = ssn.device_snapshot
    if device is None:
        device = ssn.cache.device_session(ssn)
        ssn.device_snapshot = device
        return device
    touched = ssn.touched_nodes
    if touched and not device.update_rows(ssn.nodes, touched):
        # node set changed: rebuild
        device = DeviceSession(ssn.nodes, device=device.device)
        ssn.device_snapshot = device
    return device


#: words of one packed scatter row: the destination row, then 16 value
#: words (csrc/scatter_rows.cu)
SCATTER_WORDS = 17


def pack_scatter_rows(idx: np.ndarray, idle: np.ndarray,
                      releasing: np.ndarray, backfilled: np.ndarray,
                      allocatable_cm: np.ndarray, nz_req: np.ndarray,
                      n_tasks: np.ndarray, max_task_num: np.ndarray,
                      node_ok: np.ndarray, n_pad: int) -> np.ndarray:
    """The k dirty rows as one int32 [k, 17] block (the layout
    :func:`scatter_rows` takes): the destination row, the float32 values
    as their bit patterns, the int32 counts and node_ok as 0/1. One block
    means one host-to-device copy for all eight arrays."""
    idx = np.asarray(idx, np.int32)
    k = idx.shape[0]
    if k and (idx.min() < 0 or idx.max() >= n_pad):
        raise ValueError(f"scatter rows outside [0, {n_pad})")
    floats = np.concatenate(
        [np.asarray(a, np.float32).reshape(k, -1)
         for a in (idle, releasing, backfilled, allocatable_cm, nz_req)],
        axis=1)
    if floats.shape[1] != 13:
        raise ValueError(f"scatter rows: {floats.shape[1]} float words per "
                         f"row, expected 13")
    block = np.empty((k, SCATTER_WORDS), np.int32)
    block[:, 0] = idx
    block[:, 1:14] = floats.view(np.int32)
    block[:, 14] = np.asarray(n_tasks, np.int32)
    block[:, 15] = np.asarray(max_task_num, np.int32)
    block[:, 16] = np.asarray(node_ok, bool)
    return block


def scatter_rows_plain(dst, block: torch.Tensor) -> None:
    """The dirty-row scatter as eight ``index_copy_`` calls, in place:
    ``dst`` is (idle, releasing, backfilled, allocatable_cm, nz_req,
    n_tasks, max_task_num, node_ok), ``block`` the int32 [k, 17] rows of
    :func:`pack_scatter_rows` on the arrays' device."""
    idle, releasing, backfilled, alloc_cm, nz_req, n_tasks, max_tn, ok = dst
    idx = block[:, 0].long()
    f = block[:, 1:14].contiguous().view(torch.float32)
    idle.index_copy_(0, idx, f[:, 0:3])
    releasing.index_copy_(0, idx, f[:, 3:6])
    backfilled.index_copy_(0, idx, f[:, 6:9])
    alloc_cm.index_copy_(0, idx, f[:, 9:11])
    nz_req.index_copy_(0, idx, f[:, 11:13])
    n_tasks.index_copy_(0, idx, block[:, 14])
    max_tn.index_copy_(0, idx, block[:, 15])
    ok.index_copy_(0, idx, block[:, 16] != 0)


#: (name, dtype, trailing shape) of the eight scatter destinations
_SCATTER_DST = (("idle", torch.float32, (3,)),
                ("releasing", torch.float32, (3,)),
                ("backfilled", torch.float32, (3,)),
                ("allocatable_cm", torch.float32, (2,)),
                ("nz_req", torch.float32, (2,)),
                ("n_tasks", torch.int32, ()),
                ("max_task_num", torch.int32, ()),
                ("node_ok", torch.bool, ()))


def scatter_rows(dst, block: torch.Tensor) -> None:
    """The dirty-row scatter on the tensors' device, in place: the CUDA
    kernel (csrc/scatter_rows.cu) for CUDA tensors, the plain version
    for CPU tensors."""
    devs = {t.device.type for t in dst} | {block.device.type}
    if devs == {"cpu"}:
        scatter_rows_plain(dst, block)
        return
    if devs != {"cuda"}:
        raise ValueError(f"scatter_rows: mixed devices {devs}")
    n_pad = dst[0].shape[0]
    for t, (name, dtype, tail) in zip(dst, _SCATTER_DST):
        if t.dtype != dtype or tuple(t.shape) != (n_pad,) + tail \
                or not t.is_contiguous():
            raise ValueError(f"scatter_rows: {name} must be a contiguous "
                             f"{dtype} {(n_pad,) + tail}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if block.dtype != torch.int32 or block.dim() != 2 \
            or block.shape[1] != SCATTER_WORDS or not block.is_contiguous():
        raise ValueError(f"scatter_rows: block must be a contiguous int32 "
                         f"[k, {SCATTER_WORDS}], got {block.dtype} "
                         f"{tuple(block.shape)}")
    k = block.shape[0]
    if k == 0:
        return
    lib = _build.library("scatter_rows.cu")
    err = lib.kb_scatter_rows(
        block.data_ptr(), k, n_pad, *(t.data_ptr() for t in dst),
        torch.cuda.current_stream(block.device).cuda_stream)
    _build.check_launch("scatter_rows", err)
    _build.count_launch("scatter_rows")


class DeviceSession:
    """Per-session node arrays on the device, kept in lock-step with the
    host Session's NodeInfo maps (the host applies exactly the decisions
    the kernel produced). ``state`` is the host numpy mirror."""

    def __init__(self, nodes: Dict[str, NodeInfo], min_bucket: int = 8,
                 device: DeviceLike = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.state = NodeState.from_nodes(nodes, min_bucket)
        st = self.state

        def up(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.idle = up(st.idle)
        self.releasing = up(st.releasing)
        self.backfilled = up(st.backfilled)
        self.allocatable_cm = up(st.allocatable[:, :2])
        self.nz_req = up(st.nz_requested)
        self.n_tasks = up(st.n_tasks)
        self.max_task_num = up(st.max_task_num)
        self.node_ok = up(st.schedulable & st.valid)

    @property
    def n_padded(self) -> int:
        return self.state.n_padded

    def node_name(self, idx: int) -> str:
        return self.state.names[idx]

    def node_index(self, name: str) -> Optional[int]:
        return self.state.index.get(name)

    @property
    def arrays(self):
        """The eight node arrays in scatter order (see _SCATTER_DST)."""
        return (self.idle, self.releasing, self.backfilled,
                self.allocatable_cm, self.nz_req, self.n_tasks,
                self.max_task_num, self.node_ok)

    def update_rows(self, nodes: Dict[str, NodeInfo], names) -> bool:
        """Re-pack the given nodes' rows from host truth (numpy mirror and
        device arrays both), reusing everything else from the previous
        cycle — the steady-state complement of the full per-cycle build.
        Returns False when the node set changed (caller rebuilds fresh).

        Soundness: rows NOT in ``names`` were neither event-mutated
        (cache dirty set) nor session-mutated (touched set folded in by
        the caller) since they were last packed, so both mirrors still
        hold their host-truth values."""
        state = self.state
        if len(nodes) != len(state.names) \
                or any(n not in state.index for n in nodes):
            return False
        rows = sorted(state.index[n] for n in names if n in state.index)
        if rows:
            self._update_rows_inner(nodes, rows, state)
        return True

    def _update_rows_inner(self, nodes, rows, state) -> None:
        k = len(rows)
        dirty_nodes = [nodes[state.names[r]] for r in rows]
        raw = pack_node_raw(dirty_nodes)
        t_row: List[int] = []
        t_tasks: List = []
        for j, (r, ni) in enumerate(zip(rows, dirty_nodes)):
            t_tasks.extend(ni.tasks.values())
            t_row.extend([j] * len(ni.tasks))
            state.max_task_num[r] = ni.allocatable.max_task_num
            state.n_tasks[r] = len(ni.tasks)
            state.schedulable[r] = not (bool(ni.node.unschedulable)
                                        if ni.node else True)
        nz = accumulate_nz(t_tasks, t_row, k)
        raw *= VEC_SCALE
        raw32 = raw.astype(np.float32)
        idx = np.asarray(rows, np.int32)
        state.idle[idx] = raw32[:, 0]
        state.releasing[idx] = raw32[:, 1]
        state.backfilled[idx] = raw32[:, 2]
        state.allocatable[idx] = raw32[:, 3]
        state.nz_requested[idx] = nz
        # no padding of k (the reference pads to a pow2 high-water so XLA
        # does not recompile; nothing here recompiles)
        block = pack_scatter_rows(
            idx, raw32[:, 0], raw32[:, 1], raw32[:, 2], raw32[:, 3, :2], nz,
            state.n_tasks[idx], state.max_task_num[idx],
            state.schedulable[idx] & state.valid[idx], state.n_padded)
        scatter_rows(self.arrays,
                     torch.from_numpy(block).to(self.device))

    def resync(self, nodes: Dict[str, NodeInfo]) -> None:
        """Rebuild device arrays from host truth (used if a host-side apply
        failed halfway)."""
        fresh = DeviceSession(nodes, min_bucket=self.n_padded,
                              device=self.device)
        self.__dict__.update(fresh.__dict__)

    def solve_job(self, batch: TaskBatch, min_available: int,
                  init_allocated: int,
                  scores: Optional[np.ndarray] = None,
                  pred_mask: Optional[np.ndarray] = None,
                  dyn=None) -> Tuple[List[Decision], bool]:
        """One job visit: the allocate scan over the job's pending tasks
        (``batch``, in task order) with the session's node carry, through
        :func:`allocate_scan` — one kernel launch on a CUDA session — and
        ONE counted device->host copy of the packed block. Commits the
        updated carry (idle, releasing, n_tasks, nz_req) to the session's
        arrays. Returns per-real-task decisions and whether the job
        crossed readiness. ``scores`` / ``pred_mask`` are the [T_pad, N]
        static rows (``SolverTerms.matrices``); ``dyn`` a
        terms.DynamicScoreSpec enabling the in-kernel nodeorder terms."""
        from .. import obs

        t_pad, n_pad = batch.t_padded, self.n_padded
        if scores is None:
            scores = np.zeros((t_pad, n_pad), np.float32)
        if pred_mask is None:
            pred_mask = np.ones((t_pad, n_pad), bool)
        dyn_enabled = bool(dyn is not None and dyn.enabled)
        weights = np.asarray(
            [dyn.least_requested, dyn.balanced_resource] if dyn_enabled
            else [0.0, 0.0], np.float32)

        def up(a) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        with obs.span("allocate_scan", cat="kernel") as sp:
            packed, idle, releasing, n_tasks, nz_req = allocate_scan(
                self.idle, self.releasing, self.backfilled,
                self.allocatable_cm, self.nz_req, self.max_task_num,
                self.n_tasks, self.node_ok, up(batch.resreq),
                up(batch.init_resreq), up(batch.nz_req), up(batch.valid),
                up(np.asarray(scores, np.float32)),
                up(np.asarray(pred_mask, bool)), int(min_available),
                int(init_allocated), up(weights), dyn_enabled=dyn_enabled)
            with obs.span("readback", cat="readback"):
                host = to_host(packed)      # the visit's ONE copy back
            obs.telemetry.record(host[2 * t_pad + 1:], span=sp)
        self.idle, self.releasing, self.n_tasks = idle, releasing, n_tasks
        self.nz_req = nz_req
        decisions = host[:t_pad]
        node_idx = host[t_pad:2 * t_pad]
        out: List[Decision] = []
        for i in range(len(batch.tasks)):
            kind = int(decisions[i])
            name = (self.state.names[int(node_idx[i])]
                    if kind in (ALLOC, ALLOC_OB, PIPELINE) else "")
            out.append(Decision(kind, name))
        return out, bool(host[2 * t_pad])
