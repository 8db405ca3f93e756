"""The explicit-collective allocate scan with the node axis over a mesh.

Replaces kubebatch_tpu/kernels/sharded.py:113 ``build_sharded_allocate``
(its ``shard_map`` scan, ``_sharded_scan_body`` :58-110). It pins the
communication pattern of the node-sharded engines: per task step every
rank packs ``[masked score, fit_alloc, fit_idle, fit_pipe, eligible]``
over its node block, ONE all-gather joins the rows, every rank takes the
same first argmax, and only the rank that owns the winning node updates
its idle, releasing and task count; the pipelined-inclusive readiness is
replicated. As in the reference it carries no inter-pod affinity
vocabulary and no action reaches it (tools and tests do).

Two implementations of one rank's steps: :class:`ScanPlain` (plain
PyTorch, CPU tensors) and :class:`ScanCuda` (``csrc/sharded_scan.cu``,
one launch a step over a thread-block cluster: the previous step's
winner applied, the next row packed, the argmax on the device).
:func:`build_sharded_allocate` returns the callable with the
reference's 13 inputs and 6 outputs on rank 0 of a mesh; the other
ranks serve (parallel/worker.py).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from . import _build
from .tensorize import VEC_EPS

SKIP, ALLOC, ALLOC_OB, PIPELINE, FAIL = 0, 1, 2, 3, 4

#: the reference's inputs, in its order (node block arrays, task arrays,
#: the [T, N] score and predicate rows, two scalars)
INPUTS = ("idle", "releasing", "backfilled", "max_task_num", "n_tasks",
          "node_ok", "resreq", "init_resreq", "task_valid", "scores",
          "pred_mask", "min_available", "init_allocated")
#: node-axis inputs (split by rows) and the [T, N] ones (split by columns)
NODE_INPUTS = ("idle", "releasing", "backfilled", "max_task_num", "n_tasks",
               "node_ok")
COL_INPUTS = ("scores", "pred_mask")
_DTYPES = {"max_task_num": torch.int32, "n_tasks": torch.int32,
           "node_ok": torch.bool, "task_valid": torch.bool,
           "pred_mask": torch.bool, "min_available": torch.int32,
           "init_allocated": torch.int32}
W = 5
#: the phase timers of csrc/sharded_scan.cu, in its order
SCAN_PHASES = ("argmax", "decision", "pack")


def _dtype(name: str) -> torch.dtype:
    return _DTYPES.get(name, torch.float32)


def _words(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


class ScanPlain:
    """One rank's scan steps in plain PyTorch on CPU tensors. ``block``
    holds NODE_INPUTS over the rank's nodes and COL_INPUTS [T, N_block];
    ``rep`` the task rows and the two scalars; ``lo`` the block's first
    global node."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], lo: int):
        for name, t in list(block.items()) + list(rep.items()):
            if t.device.type != "cpu":
                raise ValueError(f"ScanPlain runs on CPU tensors ({name} is "
                                 f"on {t.device})")
        self.b = {k: v.clone() for k, v in block.items()}
        self.rep = rep
        self.lo = int(lo)
        self.nb = int(block["node_ok"].shape[0])
        self.steps = int(rep["task_valid"].shape[0])
        self.eps = torch.from_numpy(VEC_EPS)
        self.allocated = rep["init_allocated"].reshape(()).clone()
        self.done = torch.tensor(False)
        self.decision = torch.zeros(self.steps, dtype=torch.int32)
        self.node_idx = torch.zeros(self.steps, dtype=torch.int32)

    def _pack(self, t: int) -> torch.Tensor:
        b, eps = self.b, self.eps
        init = self.rep["init_resreq"][t]
        accessible = b["idle"] + b["backfilled"]
        room = b["n_tasks"] < b["max_task_num"]
        p = b["node_ok"] & room & b["pred_mask"][t]
        fit_alloc = (init <= accessible + eps).all(dim=-1)
        fit_idle = (init <= b["idle"] + eps).all(dim=-1)
        fit_pipe = (init <= b["releasing"] + eps).all(dim=-1)
        eligible = p & (fit_alloc | fit_pipe)
        masked = torch.where(eligible, b["scores"][t],
                             torch.tensor(-torch.inf))
        return _words(torch.stack(
            [masked, fit_alloc.to(torch.float32), fit_idle.to(torch.float32),
             fit_pipe.to(torch.float32), eligible.to(torch.float32)], dim=-1))

    def first(self) -> torch.Tensor:
        return self._pack(0)

    def step(self, t: int, g: torch.Tensor):
        """Apply step ``t``'s winner from the gathered rows [k, N_block,
        W]; returns the rows of step t + 1 (None after the last)."""
        b, rep = self.b, self.rep
        packed = g.reshape(-1, W).contiguous().view(torch.float32)
        best = int(packed[:, 0].argmax())
        feasible = bool(packed[best, 4] > 0)
        is_alloc = bool(packed[best, 1] > 0)
        over_bf = is_alloc and not bool(packed[best, 2] > 0)
        active = bool(rep["task_valid"][t]) and not bool(self.done)
        take = active and feasible
        d = (SKIP if not active else FAIL if not feasible
             else PIPELINE if not is_alloc
             else ALLOC_OB if over_bf else ALLOC)
        local = best - self.lo
        if take and 0 <= local < self.nb:
            q = rep["resreq"][t]
            ma = torch.tensor(1.0 if is_alloc else 0.0)
            mp = torch.tensor(0.0 if is_alloc else 1.0)
            b["idle"][local] = b["idle"][local] - ma * q
            b["releasing"][local] = b["releasing"][local] - mp * q
            b["n_tasks"][local] += 1
        self.allocated = self.allocated + (1 if take and not over_bf else 0)
        self.done = self.done | (active and not feasible) | (
            take and bool(self.allocated >= rep["min_available"]))
        self.decision[t] = d
        self.node_idx[t] = best
        return self._pack(t + 1) if t + 1 < self.steps else None

    def result(self):
        """(decisions, node_idx, idle, releasing, n_tasks, became_ready)
        with the node arrays over this rank's block."""
        b = self.b
        return (self.decision, self.node_idx, b["idle"], b["releasing"],
                b["n_tasks"], self.allocated >= self.rep["min_available"])


class ScanCuda:
    """One rank's scan steps as launches of ``csrc/sharded_scan.cu`` on
    CUDA tensors; same interface and rows as :class:`ScanPlain`."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], lo: int, world: int):
        dev = block["idle"].device
        for name, t in list(block.items()) + list(rep.items()):
            if t.device != dev or dev.type != "cuda":
                raise ValueError(f"ScanCuda: {name} is on {t.device}, not "
                                 f"{dev} (CUDA)")
            if t.dtype != _dtype(name):
                raise ValueError(f"ScanCuda: {name} must be {_dtype(name)}")
        self.dev = dev
        self.b = {k: v.contiguous().clone() for k, v in block.items()}
        self.rep = {k: v.contiguous() for k, v in rep.items()}
        self.lo, self.world = int(lo), int(world)
        self.nb = int(block["node_ok"].shape[0])
        self.steps = int(rep["task_valid"].shape[0])
        self.eps = torch.from_numpy(VEC_EPS).to(dev)
        self.state = torch.stack([self.rep["init_allocated"].reshape(()),
                                  torch.zeros((), dtype=torch.int32,
                                              device=dev)])
        self.decision = torch.zeros(self.steps, dtype=torch.int32, device=dev)
        self.node_idx = torch.zeros(self.steps, dtype=torch.int32, device=dev)
        self.min_av = self.rep["min_available"].reshape(1)
        b = self.b
        self.ptrs = np.asarray([
            b["idle"].data_ptr(), b["releasing"].data_ptr(),
            b["backfilled"].data_ptr(), b["max_task_num"].data_ptr(),
            b["n_tasks"].data_ptr(), b["node_ok"].data_ptr(),
            self.rep["resreq"].data_ptr(), self.rep["init_resreq"].data_ptr(),
            self.rep["task_valid"].data_ptr(), b["scores"].data_ptr(),
            b["pred_mask"].data_ptr(), self.eps.data_ptr(),
            self.min_av.data_ptr(), self.state.data_ptr(),
            self.decision.data_ptr(), self.node_idx.data_ptr()],
            dtype=np.uint64)
        self.out = torch.empty((self.nb, W), dtype=torch.int32, device=dev)
        #: the kernel's phase timers, added to by every launch (phase_ms)
        self.phase_ns = torch.zeros(len(SCAN_PHASES), dtype=torch.int64,
                                    device=dev)
        #: the launch's ints; word 0 (the step) is set per launch
        self.ints = np.asarray([0, self.steps, self.nb, self.lo, self.world],
                               dtype=np.int32)
        self.lib = _build.library("sharded_scan.cu")
        self.launches = 0
        #: CUDA event pairs of this rank's launches (kernel_ms)
        self.events: List[tuple] = []

    def _launch(self, t: int, g):
        self.ints[0] = t
        if g is not None:
            if g.device != self.dev or g.dtype != torch.int32:
                raise ValueError("sharded_scan: gathered rows must be int32 "
                                 "on the rank's device")
            g = g.contiguous()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = self.lib.kb_sharded_scan(
            self.ptrs.ctypes.data, self.ptrs.shape[0], self.ints.ctypes.data,
            self.ints.shape[0], 0 if g is None else g.data_ptr(),
            self.out.data_ptr(), self.phase_ns.data_ptr(),
            torch.cuda.current_stream(self.dev).cuda_stream)
        _build.check_launch("sharded_scan", err)
        end.record()
        _build.count_launch("sharded_scan")
        self.launches += 1
        self.events.append((start, end))
        return self.out if t + 1 < self.steps else None

    def kernel_ms(self) -> float:
        """Device ms of this rank's launches (synchronizes)."""
        torch.cuda.synchronize(self.dev)
        return sum(s.elapsed_time(e) for s, e in self.events)

    def phase_ms(self) -> Dict[str, float]:
        """The phase timers' ms over this rank's launches (CTA 0's thread
        0 on the global timer; synchronizes)."""
        return {p: v / 1e6 for p, v in zip(SCAN_PHASES,
                                           self.phase_ns.cpu().tolist())}

    def first(self):
        return self._launch(-1, None)

    def step(self, t: int, g):
        return self._launch(t, g)

    def result(self):
        b = self.b
        return (self.decision, self.node_idx, b["idle"], b["releasing"],
                b["n_tasks"], self.state[0] >= self.min_av[0])


def scan_shape(world: int, nb: int) -> Dict[str, int]:
    """The thread-block cluster of a csrc/sharded_scan.cu step over
    ``world`` ranks of ``nb`` nodes (read from the built kernel): its
    CTAs, the gathered rows a CTA reduces, the block's nodes a CTA
    packs."""
    import ctypes

    info = (ctypes.c_int * 3)()
    err = _build.library("sharded_scan.cu").kb_sharded_scan_shape(
        int(world), int(nb), ctypes.addressof(info))
    _build.check_launch("sharded_scan shape", err)
    return {"ctas": info[0], "rows_a_cta": info[1], "nodes_a_cta": info[2]}


class ScanChecked:
    """A :class:`ScanCuda` held bitwise against a :class:`ScanPlain` on
    CPU copies at every step (the rows it packs) and at the end."""

    def __init__(self, cuda: ScanCuda, plain: ScanPlain):
        self.cuda, self.plain = cuda, plain
        self.compared = 0
        #: the checks that differed (the scan goes on in step; the
        #: callers raise at the end)
        self.mismatches: List[str] = []

    def _same(self, what, got, want):
        if got is None and want is None:
            return
        if not torch.equal(got.cpu(), want):
            self.mismatches.append(f"sharded_scan {what} (block at "
                                   f"{self.cuda.lo}): kernel differs from "
                                   f"the plain version")
        self.compared += 1

    def first(self):
        got = self.cuda.first()
        self._same("first rows", got, self.plain.first())
        return got

    def step(self, t, g):
        got = self.cuda.step(t, g)
        want = self.plain.step(t, g.cpu())
        self._same(f"step {t}", None if got is None else got.clone(), want)
        return got

    def result(self):
        got = self.cuda.result()
        for i, (x, y) in enumerate(zip(got, self.plain.result())):
            self._same(f"result {i}", x, y)
        return got


def scan_rank(mesh, block_np, rep_np, check: bool = False):
    """This rank's part of a sharded scan on ``mesh``. Returns
    (decisions, node_idx, became_ready on this rank's device, the
    gathered node carry [N, 7] words: idle 3, releasing 3, n_tasks)."""
    dev = mesh.device
    lo, _ = mesh.block(block_np["node_ok"].shape[0] * mesh.world)
    block = {k: torch.as_tensor(np.asarray(v)).to(_dtype(k)).to(dev)
             for k, v in block_np.items()}
    rep = {k: torch.as_tensor(np.asarray(v)).to(_dtype(k)).to(dev)
           for k, v in rep_np.items()}
    if dev.type == "cpu":
        rank = ScanPlain(block, rep, lo)
    else:
        rank = ScanCuda(block, rep, lo, mesh.world)
        if check:
            rank = ScanChecked(rank, ScanPlain(
                {k: v.cpu() for k, v in block.items()},
                {k: v.cpu() for k, v in rep.items()}, lo))
    mesh.reset_stats()
    rows = rank.first()
    for t in range(int(rep["task_valid"].shape[0])):
        rows = rank.step(t, mesh.all_gather(rows))
    dec, idx, idle, rel, ntasks, ready = rank.result()
    carry = torch.cat([_words(idle), _words(rel), ntasks[:, None]], dim=1)
    return dec, idx, ready, mesh.all_gather(carry).reshape(-1, 7), rank


def split_scan_inputs(args: Dict[str, np.ndarray], world: int):
    """(per-rank blocks, the replicated inputs) of the reference's
    inputs as numpy."""
    n = args["node_ok"].shape[0]
    if n % world:
        raise ValueError(f"{n} nodes do not split over {world} ranks (the "
                         f"reference's shard_map needs equal blocks)")
    nb = n // world
    blocks = []
    for r in range(world):
        sl = slice(r * nb, (r + 1) * nb)
        blk = {k: np.ascontiguousarray(args[k][sl]) for k in NODE_INPUTS}
        blk.update({k: np.ascontiguousarray(args[k][:, sl])
                    for k in COL_INPUTS})
        blocks.append(blk)
    rep = {k: np.asarray(args[k]) for k in INPUTS
           if k not in NODE_INPUTS and k not in COL_INPUTS}
    return blocks, rep


def scan_lockstep(args: Dict[str, np.ndarray], world: int, device,
                  check: bool = False):
    """The sharded scan with ``world`` ranks in this process, in lock
    step, without a process group (each step's rows concatenated).
    Returns (the 6 outputs as :func:`build_sharded_allocate`'s, the
    ranks)."""
    dev = torch.device(device)
    blocks, rep_np = split_scan_inputs(args, world)
    nb = args["node_ok"].shape[0] // world
    rep = {k: torch.as_tensor(np.asarray(v)).to(_dtype(k)).to(dev)
           for k, v in rep_np.items()}
    ranks = []
    for r, blk in enumerate(blocks):
        b = {k: torch.as_tensor(np.asarray(v)).to(_dtype(k)).to(dev)
             for k, v in blk.items()}
        if dev.type == "cpu":
            ranks.append(ScanPlain(b, rep, r * nb))
            continue
        rank = ScanCuda(b, rep, r * nb, world)
        if check:
            rank = ScanChecked(rank, ScanPlain(
                {k: v.cpu() for k, v in b.items()},
                {k: v.cpu() for k, v in rep.items()}, r * nb))
        ranks.append(rank)
    rows = [x.first() for x in ranks]
    for t in range(int(rep["task_valid"].shape[0])):
        g = torch.stack(rows)
        rows = [x.step(t, g) for x in ranks]
    res = [x.result() for x in ranks]
    bad = [m for x in ranks for m in getattr(x, "mismatches", ())]
    if bad:
        raise AssertionError("; ".join(bad[:4]))
    cat = [torch.cat([r[i] for r in res]) for i in (2, 3, 4)]
    return (res[0][0], res[0][1], *cat, res[0][5]), ranks


#: stats of the last scan on rank 0: per rank collectives, stages,
#: collective ms, launches
last_scan: Dict[str, object] = {}


def build_sharded_allocate(mesh, check: bool = False):
    """The sharded scan on rank 0 of ``mesh`` (reference
    ``build_sharded_allocate``): a callable taking the reference's 13
    inputs (numpy arrays or tensors, the node axis whole) and returning
    its 6 outputs (decisions [T], node_idx [T], idle [N, 3], releasing
    [N, 3], n_tasks [N] as tensors on the mesh's device, became_ready a
    0-d bool). ``check``: every rank holds each launch against the plain
    version (:class:`ScanChecked`)."""
    import time

    from ..device import to_host

    if mesh.rank != 0:
        raise ValueError("build_sharded_allocate runs on rank 0; the other "
                         "ranks serve (parallel.worker.serve)")

    def run(*inputs):
        if len(inputs) != len(INPUTS):
            raise TypeError(f"sharded allocate takes {len(INPUTS)} inputs "
                            f"({', '.join(INPUTS)})")
        args = {}
        for name, x in zip(INPUTS, inputs):
            if isinstance(x, torch.Tensor):
                x = to_host(x) if x.device.type != "cpu" else x.numpy()
            dt = _dtype(name)
            np_dt = (np.float32 if dt == torch.float32
                     else bool if dt == torch.bool else np.int32)
            args[name] = np.asarray(x, np_dt)
        blocks, rep = split_scan_inputs(args, mesh.world)
        t0 = time.perf_counter()
        mesh.send_objects({"op": "scan", "rep": rep, "check": check}, blocks)
        dec, idx, ready, carry, rank = scan_rank(mesh, blocks[0], rep, check)
        replies = mesh.gather_objects(_scan_stats(mesh, rank))
        last_scan.clear()
        last_scan.update(ranks=replies,
                         wall_ms=(time.perf_counter() - t0) * 1e3)
        bad = [m for r in replies for m in r["mismatches"]]
        if bad:
            raise AssertionError("; ".join(bad[:4]))
        f32 = torch.float32
        return (dec, idx, carry[:, 0:3].contiguous().view(f32),
                carry[:, 3:6].contiguous().view(f32),
                carry[:, 6].contiguous(), ready)

    return run


def _scan_stats(mesh, rank) -> dict:
    base = getattr(rank, "cuda", rank)
    return dict(mesh.stats, launches=getattr(base, "launches", 0),
                kernel_ms=(base.kernel_ms() if isinstance(base, ScanCuda)
                           else 0.0),
                compared=getattr(rank, "compared", 0),
                mismatches=list(getattr(rank, "mismatches", ())))


def scan_worker(mesh, header, block) -> dict:
    """A serving rank's part of one scan (parallel/worker.py)."""
    _, _, _, _, rank = scan_rank(mesh, block, header["rep"], header["check"])
    return _scan_stats(mesh, rank)
