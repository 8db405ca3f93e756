"""Node-sharded batched allocate — the round engine's node axis over a mesh.

Replaces kubebatch_tpu/kernels/batched_sharded.py (``_sharded_entry``
:130, ``solve_batched_sharded`` :184, ``prepare_sharded`` :233): the
reference runs kernels/batched.py's round loop under GSPMD with the node
axis of every big array split over a ``"nodes"`` mesh axis, task / job /
queue arrays replicated, compaction off, and XLA placing the collectives.
Here the node axis is split over a ``torch.distributed`` group
(:mod:`..parallel.mesh`): every rank holds its contiguous block of the
node bucket (the node carry, the static node rows, the [S, N_block]
predicate and score rows) and the replicated task, job and queue arrays,
and the collectives sit where the reference's node-axis reductions are.

A round on one rank (the port's plain round, kernels/batched.py
``_round``, with each node-axis step restricted to the rank's block):

1. the block's accessible pool rows are all-gathered; every rank sums
   the columns in the one-card order (the demand window), then runs the
   replicated job chain (ordering, the window, the global task rank);
2. the [P, N_block] pair scores and the row pass over the block: per
   task any-eligible and the (score, lowest global index) argmax, with
   the carry row of the block's best node; all-gathered, the first
   maximum in global node order wins (all ``-inf``: node 0);
3. fail / kill / part2 and the majority pair, replicated; the block's
   waterfall columns (the pair's score, capacity mass, room count) are
   all-gathered and every rank runs the same [N] sort and tiled cumsums;
4. the owner of each task's waterfall slot decides the slot's
   eligibility and sends the slot's carry row (all-gathered);
5. acceptance from the gathered carry rows (replicated), the commit's
   segment sums on the owner's block; the retry row pass on the
   mid-round carry (all-gathered as in 2), its acceptance and commit,
   the job and queue aggregates (replicated).

The stranded-gang rollback runs on the owner's block and the replicated
job side, with no collective. Five all-gathers a round, each of int32
words (float rows by bit view).

Exactness: every rank's chain sees the same gathered views the one-card
round reads, so the result is bitwise the port's one-card plain batched
solve with ``compact_bucket=0`` on the same node bucket (decisions,
nodes, sequence numbers, rounds and the node carry). With k = 2 or 4 the
bucket is the one-card bucket; k = 3 pads it to a multiple of 3 (padding
nodes ``node_ok=False``: inert).

Two implementations of each rank's steps behind one interface: the
plain one (:class:`PlainRank`, CPU tensors) and the CUDA kernels of
``csrc/sharded_round.cu`` (:class:`CudaRank`: one cooperative launch a
step, the replicated chain reusing ``batched_round.cuh``). A rank takes
the kernels for CUDA tensors and the plain version for CPU tensors.
:class:`CheckedRank` runs both on every step and holds each launch's
payload bitwise against the plain version on that rank's inputs.

The inter-pod affinity vocabulary does not ride this engine yet: a cycle
carrying it raises ``NotImplementedError`` (ROADMAP queue B, B14a's
affinity branch).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import _build
from .batched import (CYCLE_ARGS, NODE_ARGS, CycleArrays, RoundState, _IMAX,
                      _accept_rows, _admit, _avail_pool, _cell_elig,
                      _commit_jobs, _commit_node, _maj_pair, _pair_scores,
                      _pool_sums, _rollback_stranded, _row_pass, _settle,
                      _stranded_jobs, _waterfall_slots, arg_dtype)
from .fused import JOB_KEY_CODES, K_PROP_SHARE, SKIP
from .telemetry import ENGINE_SHARDED, TELEM_WIDTH, decision_frame
from .tensorize import VEC_EPS

#: int32 words of each step's payload a row: the accessible pool
#: (avail 3, max(rel, 0) 3); a carry row (idle + bf 3, idle 3, rel 3,
#: maxt - n_tasks); a row-pass partial (any, score bits, global index,
#: the carry row at the block's best); a waterfall column (score bits,
#: capacity mass 3, room count); the slot owner's answer (eligible, the
#: carry row at the slot)
W_AVAIL, W_ROW, W_PART, W_COLS, W_OWN = 6, 10, 13, 5, 11
#: words of a node's final carry (idle 3, rel 3, n_tasks, nz 2)
W_CARRY = 9

#: ROADMAP item that brings the affinity vocabulary to this engine
AFFINITY_ITEM = ("ROADMAP queue B, B14a's affinity branch (the replicated "
                 "[P,D] carry over the mesh)")

#: the static node rows each rank receives for its block (besides the
#: [S, N] predicate and score rows)
_NODE_STATIC = ("backfilled", "allocatable_cm", "max_task_num", "node_ok")
#: the replicated cycle arrays (CYCLE_ARGS less the [S, N] rows)
REP_ARGS = tuple(n for n in CYCLE_ARGS
                 if n not in ("sig_scores", "sig_pred"))
#: widths of the node arrays in the staged node block, in NODE_ARGS order
_NODE_WIDTH = {"idle": 3, "releasing": 3, "n_tasks": 1, "nz_req": 2,
               "backfilled": 3, "allocatable_cm": 2, "max_task_num": 1,
               "node_ok": 1}

_F32, _I32 = torch.float32, torch.int32


def _words(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == _F32:
        return t.contiguous().view(_I32)
    return t.to(_I32)


def _floats(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().view(_F32)


# ---- the plain version ----------------------------------------------------

class PlainRank:
    """One rank's steps of the sharded solve in plain PyTorch on CPU
    tensors. ``block``: the rank's node arrays (NODE_ARGS [N_block, ...],
    ``sig_scores`` / ``sig_pred`` [S, N_block]); ``rep``: REP_ARGS;
    ``lo``: the block's first global node; ``n_sh``: the node bucket."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], statics: dict, lo: int,
                 n_sh: int):
        for name, t in list(block.items()) + list(rep.items()):
            if t.device.type != "cpu":
                raise ValueError(f"PlainRank runs on CPU tensors ({name} is "
                                 f"on {t.device}; its segment sums are "
                                 f"index_add_'s sequential order)")
        self.lo, self.n_sh = int(lo), int(n_sh)
        self.nb = int(block["node_ok"].shape[0])
        self.opts = statics
        self.eps = torch.from_numpy(VEC_EPS)
        self.a = CycleArrays(**{k: block[k] for k in _NODE_STATIC},
                             sig_scores=block["sig_scores"],
                             sig_pred=block["sig_pred"],
                             **{k: rep[k] for k in REP_ARGS
                                if k in CycleArrays._fields})
        t_pad = rep["task_valid"].shape[0]
        self.state = RoundState(
            idle=block["idle"].clone(), releasing=block["releasing"].clone(),
            n_tasks=block["n_tasks"].clone(), nz_req=block["nz_req"].clone(),
            q_allocated=rep["q_alloc0"].clone(),
            j_allocated=rep["j_alloc0"].clone(),
            alloc_cnt=rep["init_allocated"].clone(),
            job_alive=rep["job_valid"].clone(),
            task_state=torch.full((t_pad,), SKIP, dtype=_I32),
            task_node=torch.full((t_pad,), -1, dtype=_I32),
            task_seq=torch.full((t_pad,), _IMAX, dtype=_I32))
        self.r = {}                        # the round's replicated values

    # ---- block helpers ---------------------------------------------------

    def avail(self) -> torch.Tensor:
        """[N_block, W_AVAIL] the block's accessible pool rows."""
        av, rel = _avail_pool(self.state, self.a, True)
        return torch.cat([_words(av), _words(rel)], dim=1)

    def _rows(self, node: torch.Tensor) -> torch.Tensor:
        """[len(node), W_ROW] carry rows at local nodes ``node``."""
        s, a = self.state, self.a
        n = node.long()
        acc = s.idle[n] + a.backfilled[n]
        room = a.max_task_num[n] - s.n_tasks[n]
        return torch.cat([_words(acc), _words(s.idle[n]),
                          _words(s.releasing[n]), room[:, None]], dim=1)

    def _partial(self, mask: torch.Tensor) -> torch.Tensor:
        """The row pass over the block for tasks ``mask`` against the
        carry as it stands: [T, W_PART] (zeros outside ``mask``)."""
        s, a = self.state, self.a
        any_b, best, _ = _row_pass(s.idle, s.releasing, s.n_tasks, a,
                                   self.opts["pipe_enabled"], self.eps,
                                   self.sc, mask)
        val = torch.where(any_b, self.sc[a.task_pair.long(), best.long()],
                          torch.tensor(-torch.inf))
        out = torch.cat([any_b.to(_I32)[:, None], _words(val)[:, None],
                         (best + self.lo)[:, None], self._rows(best)], dim=1)
        return torch.where(mask[:, None], out, torch.tensor(0, dtype=_I32))

    def _accept(self, proposal, mask, rows):
        """Acceptance with each proposer's carry row from ``rows`` (the
        owner's answer) instead of the node arrays."""
        return _accept_rows(self.a, self.r["global_rank"], proposal, mask,
                            _floats(rows[:, 0:3]), _floats(rows[:, 3:6]),
                            _floats(rows[:, 6:9]), rows[:, 9],
                            self.opts["pipe_enabled"], self.n_sh)

    def _commit(self, accept, prop_alloc, proposal, fold_nz: bool):
        """The commit's segment sums on the owner's block."""
        s = self.state
        idle, rel, ntasks, nz = _commit_node(
            self.a, accept, prop_alloc & accept, ~prop_alloc & accept,
            proposal, s.idle, s.releasing, s.n_tasks, s.nz_req, fold_nz,
            lo=self.lo)
        self.state = s._replace(idle=idle, releasing=rel, n_tasks=ntasks,
                                nz_req=nz)

    @staticmethod
    def _combine(g: torch.Tensor):
        """(any, best global node, carry row) of gathered row-pass
        partials [k, T, W_PART]: the first maximum over the ranks in
        global node order, node 0 when no rank has an eligible node."""
        any_k = g[:, :, 0] != 0
        val = torch.where(any_k, _floats(g[:, :, 1]),
                          torch.tensor(-torch.inf))
        any_t = any_k.any(dim=0)
        # argmax returns the first maximum; a rank with no eligible node
        # reads -inf, and with none anywhere rank 0 (whose best is 0)
        r = torch.where(any_t, val.argmax(dim=0), torch.tensor(0))
        t = torch.arange(g.shape[1])
        best = torch.where(any_t, g[r, t, 2], torch.tensor(0, dtype=_I32))
        return any_t, best, g[r, t, 3:]

    # ---- the steps -------------------------------------------------------

    def start(self) -> torch.Tensor:
        return self.avail()

    def rows1(self, round_idx: int, g_avail: torch.Tensor) -> torch.Tensor:
        """Ordering and the demand window from the gathered pool, the pair
        scores and the first row pass over the block."""
        s, a, o = self.state, self.a, self.opts
        g = _floats(g_avail.reshape(-1, W_AVAIL))
        pool = _pool_sums(g[:, 0:3].contiguous(),
                          g[:, 3:6].contiguous() if o["pipe_enabled"]
                          else None)
        participating, order, global_rank = _admit(
            s, a, o["job_keys"], o["queue_keys"], o["prop_overused"], pool)
        self.r = {"round": round_idx, "participating": participating,
                  "order": order, "global_rank": global_rank,
                  "base": a.node_ok & (s.n_tasks < a.max_task_num)}
        self.sc = _pair_scores(s, a, o["dyn_enabled"])       # [P, N_block]
        return self._partial(participating)

    def cols(self, g_part: torch.Tensor) -> torch.Tensor:
        """Combine the first row pass; fail / kill / part2 and the
        majority pair; the block's waterfall columns."""
        s, a, r = self.state, self.a, self.r
        any_elig, fb, rows_fb = self._combine(g_part)
        part = r["participating"]
        fail_first, job_killed, part2 = _settle(
            a, part, any_elig, part & ~any_elig, r["global_rank"])
        maj = _maj_pair(a, part2)
        r.update(fb=fb, rows_fb=rows_fb, fail_first=fail_first,
                 job_killed=job_killed, part2=part2)
        maj_ok = a.sig_pred[int(a.pair_sig[maj])] & r["base"]
        zero = torch.tensor(0.0)
        cm = torch.where(maj_ok[:, None],
                         torch.maximum(s.idle + a.backfilled, zero), zero)
        room = torch.clamp(a.max_task_num - s.n_tasks, min=0).to(_F32)
        cnt = torch.where(maj_ok, room, zero)
        return torch.cat([_words(self.sc[maj])[:, None], _words(cm),
                          _words(cnt)[:, None]], dim=1)

    def owner(self, g_cols: torch.Tensor) -> torch.Tensor:
        """The shared waterfall on the gathered columns (replicated), then
        the owner's answer at each part2 task's slot."""
        a, r, s = self.a, self.r, self.state
        g = g_cols.reshape(-1, W_COLS)
        ord_sh, slot = _waterfall_slots(
            a, r["part2"], r["order"], _floats(g[:, 0]), _floats(g[:, 1:4]),
            _floats(g[:, 4]))
        p_water = ord_sh[slot.clamp(max=self.n_sh - 1)].to(_I32)
        r.update(slot_ok=slot < self.n_sh, p_water=p_water)
        mine = r["part2"] & (p_water >= self.lo) & (p_water < self.lo
                                                    + self.nb)
        local = (p_water - self.lo).clamp(0, self.nb - 1)
        elig = _cell_elig(s.idle, s.releasing, s.n_tasks, a,
                          self.opts["pipe_enabled"], self.eps, local)
        out = torch.cat([elig.to(_I32)[:, None], self._rows(local)], dim=1)
        return torch.where(mine[:, None], out, torch.tensor(0, dtype=_I32))

    def retry(self, g_own: torch.Tensor) -> torch.Tensor:
        """Proposals, phase-1 acceptance and the owner's commit, then the
        retry row pass over the block on the mid-round carry."""
        r = self.r
        p_water = r["p_water"]
        owner = (p_water // self.nb).long()
        t = torch.arange(g_own.shape[1])
        water = (g_own[owner, t, 0] != 0) & r["slot_ok"]
        proposal1 = torch.where(water, p_water, r["fb"])
        rows1 = torch.where(water[:, None], g_own[owner, t, 1:],
                            r["rows_fb"])
        accept1, ob1, pa1 = self._accept(proposal1, r["part2"], rows1)
        self._commit(accept1, pa1, proposal1, True)
        mask = r["part2"] & ~accept1
        r.update(phase1=(accept1, ob1, proposal1, pa1), mask=mask)
        return self._partial(mask)

    def finish(self, g_part: torch.Tensor) -> Tuple[bool, torch.Tensor]:
        """The retry's acceptance and commit, the job / queue aggregates
        and the decisions. Returns (progress, the next accessible pool)."""
        r = self.r
        any_r, fb_r, rows_r = self._combine(g_part)
        retry = r["mask"] & any_r
        accept_r, ob_r, pa_r = self._accept(fb_r, retry, rows_r)
        self._commit(accept_r, pa_r, fb_r, False)
        fields, _, _, changed = _commit_jobs(
            self.state, self.a, r["phase1"], (accept_r, ob_r, fb_r, pa_r),
            r["fail_first"], r["job_killed"], r["global_rank"], r["round"],
            self.a.task_valid.shape[0])
        self.state = self.state._replace(**fields)
        return bool(changed.any()), self.avail()

    def stranded(self) -> bool:
        """Any stranded gang (killed ones included)."""
        return bool(_stranded_jobs(self.state, self.a).any())

    def rollback(self, revive: bool) -> Tuple[int, torch.Tensor]:
        """The stranded-gang rollback: the node carry on the owner's
        block, the job side replicated. Returns (stranded gangs, the next
        accessible pool)."""
        self.state, stranded = _rollback_stranded(self.state, self.a, revive,
                                                  lo=self.lo)
        return int(stranded.sum()), self.avail()

    def result(self, rounds: int, retries: int, stranded: int):
        """(packed [3T + 1 + TELEM_WIDTH] int32, the block's carry
        [N_block, W_CARRY] words)."""
        s, o = self.state, self.opts
        t_pad = s.task_state.shape[0]
        frame = decision_frame(ENGINE_SHARDED, s.task_state, s.task_seq,
                               self.a.task_valid, waves=rounds, stride=t_pad,
                               narrow=o["narrow"],
                               narrow_gate=o["narrow_gate"],
                               retries=retries, stranded=stranded)
        packed = torch.cat([s.task_state, s.task_node, s.task_seq,
                            torch.tensor([rounds], dtype=_I32), frame])
        carry = torch.cat([_words(s.idle), _words(s.releasing),
                           s.n_tasks[:, None], _words(s.nz_req)], dim=1)
        return packed, carry


# ---- the CUDA kernels ------------------------------------------------------

#: the affinity pointer slots of batched_round.cuh's P_* (null here)
_AFF_SLOTS = 19

#: sharded_round.cu's steps, in the order of its SEG_* codes
SEGMENTS = ("start", "rows1", "cols", "owner", "retry", "finish",
            "stranded", "rollback", "frame")


class CudaRank:
    """One rank's steps as launches of ``csrc/sharded_round.cu`` on CUDA
    tensors: one cooperative launch a step, the replicated state in a
    workspace that lives across the launches, each step's payload
    written to a device buffer. Same interface and payloads as
    :class:`PlainRank`. Reading a flag (progress, stranded) is a counted
    device->host copy."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], statics: dict, lo: int,
                 n_sh: int):
        import ctypes

        dev = block["idle"].device
        for name, t in list(block.items()) + list(rep.items()):
            if t.device != dev or t.device.type != "cuda":
                raise ValueError(f"CudaRank: {name} is on {t.device}, not "
                                 f"{dev} (CUDA)")
            if t.dtype != arg_dtype(name):
                raise ValueError(f"CudaRank: {name} must be "
                                 f"{arg_dtype(name)}, got {t.dtype}")
        o = statics
        if len(o["job_keys"]) > 3 or any(k not in JOB_KEY_CODES
                                         for k in o["job_keys"]):
            raise ValueError(f"CudaRank: unsupported job keys "
                             f"{o['job_keys']}")
        if any(k != K_PROP_SHARE for k in o["queue_keys"]):
            raise ValueError(f"CudaRank: unsupported queue keys "
                             f"{o['queue_keys']}")
        self.dev = dev
        self.lo, self.n_sh = int(lo), int(n_sh)
        nb = self.nb = int(block["node_ok"].shape[0])
        t = self.t = int(rep["task_valid"].shape[0])
        j = int(rep["job_valid"].shape[0])
        q = int(rep["q_deserved"].shape[0])
        p = int(rep["pair_sig"].shape[0])
        c = {k: v.contiguous() for k, v in list(block.items())
             + list(rep.items())}
        # the block's carry lives in these (the kernel updates it)
        self.idle = c["idle"].clone()
        self.rel = c["releasing"].clone()
        self.ntasks = c["n_tasks"].clone()
        self.nz = c["nz_req"].clone()
        self.c = c
        self.packed = torch.empty(3 * t + 1 + TELEM_WIDTH, dtype=_I32,
                                  device=dev)
        self.eps = torch.from_numpy(VEC_EPS).to(dev)
        codes = [JOB_KEY_CODES[k] for k in o["job_keys"]] + [0] * (
            3 - len(o["job_keys"]))
        self.ints = np.asarray([
            n_sh, t, j, q, p, len(o["job_keys"]), *codes,
            int(K_PROP_SHARE in o["queue_keys"]), int(o["prop_overused"]),
            int(o["dyn_enabled"]), int(o["pipe_enabled"]),
            int(o["max_rounds"]), 0, int(o["gang_enabled"]),
            int(o["narrow"]), int(o["narrow_gate"]), 0, 0, 0, 0, 0,
            self.lo, nb], dtype=np.int32)
        self.lib = _build.library("sharded_round.cu")
        ws = ctypes.c_longlong(0)
        sws = ctypes.c_longlong(0)
        _build.check_launch("sharded_round", self.lib.kb_sharded_workspace(
            self.ints.ctypes.data, self.ints.shape[0], ctypes.addressof(ws),
            ctypes.addressof(sws)))
        self.ws = torch.empty(ws.value, dtype=torch.uint8, device=dev)
        self.sws = torch.empty(sws.value, dtype=torch.uint8, device=dev)
        self.phase_ns = torch.zeros(32, dtype=torch.int64, device=dev)
        self.out = {
            "avail": torch.empty((nb, W_AVAIL), dtype=_I32, device=dev),
            "part": torch.empty((t, W_PART), dtype=_I32, device=dev),
            "cols": torch.empty((nb, W_COLS), dtype=_I32, device=dev),
            "own": torch.empty((t, W_OWN), dtype=_I32, device=dev),
        }
        self.flags = torch.zeros(4, dtype=_I32, device=dev)
        self.ptrs = np.asarray([
            self.idle.data_ptr(), self.rel.data_ptr(),
            self.ntasks.data_ptr(), self.nz.data_ptr(),
            *(c[k].data_ptr() for k in (
                "backfilled", "allocatable_cm", "max_task_num", "node_ok",
                "resreq", "init_resreq", "task_nz", "task_job", "task_rank",
                "task_sig", "task_pair", "task_valid", "sig_scores",
                "sig_pred", "pair_sig", "pair_nz", "order_min_available",
                "init_allocated", "job_queue", "job_priority",
                "job_create_rank", "job_valid", "q_deserved",
                "q_create_rank", "q_alloc0", "j_alloc0", "cluster_total",
                "dyn_weights")),
            self.eps.data_ptr(), self.packed.data_ptr(),
            self.phase_ns.data_ptr(), *([0] * _AFF_SLOTS),
            self.ws.data_ptr(), self.sws.data_ptr(), self.flags.data_ptr()],
            dtype=np.uint64)
        self.info = np.zeros(3, dtype=np.int32)
        #: CUDA event pairs of this rank's launches (device ms: kernel_ms)
        self.events: List[tuple] = []
        self.launches = 0

    def _launch(self, seg: str, args=(), inp=None, out=None):
        if inp is not None:
            if inp.device != self.dev or inp.dtype != _I32:
                raise ValueError(f"sharded_round {seg}: input must be int32 "
                                 f"on {self.dev}")
            inp = inp.contiguous()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = self.lib.kb_sharded_round(
            self.ptrs.ctypes.data, self.ptrs.shape[0], self.ints.ctypes.data,
            self.ints.shape[0], SEGMENTS.index(seg),
            *(int(x) for x in tuple(args) + (0,) * (3 - len(args))),
            0 if inp is None else inp.data_ptr(),
            0 if out is None else out.data_ptr(), self.info.ctypes.data,
            torch.cuda.current_stream(self.dev).cuda_stream)
        _build.check_launch(f"sharded_round {seg}", err)
        end.record()
        _build.count_launch("sharded_round")
        self.launches += 1
        self.events.append((seg, start, end))
        return out

    def _flag(self, i: int) -> int:
        from ..device import to_host

        return int(to_host(self.flags)[i])

    def kernel_ms(self) -> Dict[str, float]:
        """Device ms of this rank's launches by step (synchronizes)."""
        torch.cuda.synchronize(self.dev)
        out: Dict[str, float] = {}
        for seg, s, e in self.events:
            out[seg] = out.get(seg, 0.0) + s.elapsed_time(e)
        return out

    def start(self):
        return self._launch("start", out=self.out["avail"])

    def rows1(self, round_idx, g_avail):
        self._round = round_idx
        return self._launch("rows1", (round_idx,), g_avail, self.out["part"])

    def cols(self, g_part):
        return self._launch("cols", (), g_part, self.out["cols"])

    def owner(self, g_cols):
        return self._launch("owner", (), g_cols, self.out["own"])

    def retry(self, g_own):
        return self._launch("retry", (), g_own, self.out["part"])

    def finish(self, g_part):
        self._launch("finish", (self._round,), g_part, self.out["avail"])
        return bool(self._flag(0)), self.out["avail"]

    def stranded(self):
        self._launch("stranded")
        return bool(self._flag(1))

    def rollback(self, revive):
        self._launch("rollback", (int(revive),), out=self.out["avail"])
        return self._flag(2), self.out["avail"]

    def result(self, rounds, retries, stranded):
        self._launch("frame", (rounds, retries, stranded))
        carry = torch.cat([_words(self.idle), _words(self.rel),
                           self.ntasks[:, None], _words(self.nz)], dim=1)
        return self.packed, carry


class CheckedRank:
    """Runs a :class:`CudaRank` and a :class:`PlainRank` on CPU copies of
    the same inputs side by side: every step's payload from the kernel is
    held bitwise against the plain version's on the same gathered input
    (the kernel's), and so are the flags and the final result.
    ``compared`` counts the checks, ``mismatches`` lists the ones that
    differed (the solve goes on with the kernel's payloads, so every
    rank stays in step; the callers raise at the end)."""

    def __init__(self, cuda: CudaRank, plain: PlainRank):
        self.cuda, self.plain = cuda, plain
        self.compared = 0
        self.mismatches: List[str] = []

    def _check(self, seg, got, want):
        g = got.cpu() if isinstance(got, torch.Tensor) else got
        if isinstance(g, torch.Tensor):
            same = g.shape == want.shape and torch.equal(g, want)
        else:
            same = g == want
        if not same:
            where = ""
            if isinstance(g, torch.Tensor) and g.shape == want.shape:
                bad = torch.nonzero(g != want)
                where = f" at {bad[:4].tolist()} ({bad.shape[0]} words)"
            self.mismatches.append(f"sharded_round {seg} (rank block at "
                                   f"{self.cuda.lo}): kernel differs from "
                                   f"the plain version{where}")
        self.compared += 1
        return got

    def start(self):
        return self._check("start", self.cuda.start(), self.plain.start())

    def rows1(self, round_idx, g):
        return self._check("rows1", self.cuda.rows1(round_idx, g),
                           self.plain.rows1(round_idx, g.cpu()))

    def cols(self, g):
        return self._check("cols", self.cuda.cols(g), self.plain.cols(g.cpu()))

    def owner(self, g):
        return self._check("owner", self.cuda.owner(g),
                           self.plain.owner(g.cpu()))

    def retry(self, g):
        return self._check("retry", self.cuda.retry(g),
                           self.plain.retry(g.cpu()))

    def finish(self, g):
        pc, ac = self.cuda.finish(g)
        pp, ap = self.plain.finish(g.cpu())
        self._check("finish progress", pc, pp)
        return pc, self._check("finish", ac, ap)

    def stranded(self):
        return self._check("stranded", self.cuda.stranded(),
                           self.plain.stranded())

    def rollback(self, revive):
        sc, ac = self.cuda.rollback(revive)
        sp, ap = self.plain.rollback(revive)
        self._check("rollback count", sc, sp)
        return sc, self._check("rollback", ac, ap)

    def result(self, rounds, retries, stranded):
        pc, cc = self.cuda.result(rounds, retries, stranded)
        pp, cp = self.plain.result(rounds, retries, stranded)
        self._check("frame", pc, pp)
        self._check("carry", cc, cp)
        return pc, cc


def make_rank(block, rep, statics, lo: int, n_sh: int, check: bool = False):
    """The rank solver for the tensors' device: :class:`CudaRank` on CUDA
    tensors (with ``check``, a :class:`CheckedRank` beside a plain rank
    on CPU copies), :class:`PlainRank` on CPU tensors."""
    devs = {t.device.type for t in list(block.values())
            + list(rep.values())}
    if devs == {"cpu"}:
        return PlainRank(block, rep, statics, lo, n_sh)
    if devs != {"cuda"}:
        raise ValueError(f"sharded solve: inputs on mixed devices {devs}")
    rank = CudaRank(block, rep, statics, lo, n_sh)
    if check:
        cpu = {k: v.cpu() for k, v in block.items()}
        rank = CheckedRank(rank, PlainRank(
            cpu, {k: v.cpu() for k, v in rep.items()}, statics, lo, n_sh))
    return rank


def drive(ranks: list, gather, max_rounds: int, gang: bool):
    """Run the solve on ``ranks`` (this process's: one on a process
    mesh, k in lock step without one), joining them at every step with
    ``gather`` (a list of payloads, one a rank here, -> the list of what
    each receives: [k, ...] words). Returns (rounds, retries, stranded).
    Every rank computes the replicated flags; they must agree."""
    def agree(vals):
        if any(v != vals[0] for v in vals):
            raise AssertionError(f"sharded solve: ranks disagree {vals}")
        return vals[0]

    def rounds_loop(start, avail):
        rnd, progress = start, True
        while progress and rnd < max_rounds:
            g = gather(avail)
            g = gather([r.rows1(rnd, x) for r, x in zip(ranks, g)])
            g = gather([r.cols(x) for r, x in zip(ranks, g)])
            g = gather([r.owner(x) for r, x in zip(ranks, g)])
            g = gather([r.retry(x) for r, x in zip(ranks, g)])
            outs = [r.finish(x) for r, x in zip(ranks, g)]
            progress = agree([o[0] for o in outs])
            avail = [o[1] for o in outs]
            rnd += 1
        return rnd, avail

    rounds, avail = rounds_loop(0, [r.start() for r in ranks])
    retries = stranded = 0
    if gang:
        while retries < 3 and agree([r.stranded() for r in ranks]):
            outs = [r.rollback(True) for r in ranks]
            rounds, avail = rounds_loop(rounds, [o[1] for o in outs])
            retries += 1
        stranded = agree([r.rollback(False)[0] for r in ranks])
    return rounds, retries, stranded


# ---- inputs ---------------------------------------------------------------

def _np_node_cols(a: np.ndarray, n_sh: int) -> np.ndarray:
    """[S, N] rows padded on the node columns to ``n_sh`` (zeros: a
    padding node has no predicate and no score)."""
    out = np.zeros((a.shape[0], n_sh), a.dtype)
    out[:, :a.shape[1]] = a
    return out


def prepare_sharded(world: int, device, inputs, max_rounds: int = 0):
    """(node, rep, statics, n_sh) of the sharded solve for these
    CycleInputs on a mesh of ``world`` ranks (reference
    ``prepare_sharded``): ``node`` maps NODE_ARGS and the [S, N] rows to
    numpy arrays padded to the shard bucket (padding nodes
    ``node_ok=False`` and zero: inert), ``rep`` the replicated cycle
    arrays; the narrow words use the reference's per-shard policy. The
    DeviceSession's node arrays leave the device in ONE counted copy."""
    from ..device import to_host
    from ..parallel.mesh import shard_bucket
    from .narrow import narrow_enabled

    if getattr(inputs, "affinity", None) is not None:
        raise NotImplementedError(
            f"the sharded engine does not carry the inter-pod affinity / "
            f"host-port vocabulary yet: {AFFINITY_ITEM}")
    n_pad = int(device.n_padded)
    n_sh = shard_bucket(n_pad, world)
    t_pad = int(inputs.task_valid.shape[0])
    if max_rounds <= 0:
        max_rounds = t_pad + 8
    # the node arrays, staged as one block of words
    cols = [_words(getattr(device, k).reshape(n_pad, -1)) for k in NODE_ARGS]
    host = to_host(torch.cat(cols, dim=1))
    node, c0 = {}, 0
    for k in NODE_ARGS:
        w = _NODE_WIDTH[k]
        words = np.ascontiguousarray(host[:, c0:c0 + w])
        c0 += w
        dt = arg_dtype(k)
        arr = (words.view(np.float32) if dt == torch.float32
               else words.astype(bool) if dt == torch.bool else words)
        if w == 1:
            arr = arr[:, 0]
        pad = np.zeros((n_sh,) + arr.shape[1:], arr.dtype)
        pad[:n_pad] = arr
        node[k] = pad
    node["sig_scores"] = _np_node_cols(
        np.asarray(inputs.sig_scores, np.float32), n_sh)
    node["sig_pred"] = _np_node_cols(np.asarray(inputs.sig_pred, bool), n_sh)
    task_pair, pair_sig, pair_nz, _ = inputs.pair_terms()
    extra = {"task_pair": task_pair, "pair_sig": pair_sig,
             "pair_nz": pair_nz}
    rep = {}
    for k in REP_ARGS:
        v = extra[k] if k in extra else getattr(inputs, k)
        dt = arg_dtype(k)
        np_dt = (np.float32 if dt == torch.float32
                 else bool if dt == torch.bool else np.int32)
        rep[k] = np.ascontiguousarray(np.asarray(v, np_dt))
    per_shard = max(1, n_sh // world)
    narrow = narrow_enabled(
        per_shard, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None))
    statics = dict(
        job_keys=tuple(inputs.job_keys), queue_keys=tuple(inputs.queue_keys),
        prop_overused=bool(inputs.prop_overused),
        dyn_enabled=bool(inputs.dyn_enabled),
        pipe_enabled=bool(inputs.pipe_enabled),
        max_rounds=min(max_rounds, 4096),
        gang_enabled=bool(inputs.gang_enabled), narrow=bool(narrow),
        narrow_gate=bool(not narrow and narrow_enabled(per_shard, t_pad)))
    return node, rep, statics, n_sh


def split_blocks(node: Dict[str, np.ndarray], world: int, n_sh: int):
    """Per rank, its node block (the [S, N] rows by column block)."""
    nb = n_sh // world
    out = []
    for r in range(world):
        sl = slice(r * nb, (r + 1) * nb)
        out.append({k: np.ascontiguousarray(v[:, sl] if k in (
            "sig_scores", "sig_pred") else v[sl]) for k, v in node.items()})
    return out


def _tensors(arrays: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(arg_dtype(k))
            .to(dev) for k, v in arrays.items()}


def solve_rank(mesh, block_np, rep_np, statics, n_sh: int,
               check: bool = False):
    """This rank's part of a sharded solve on ``mesh`` (every rank calls
    it with its own block). Returns (packed on this rank's device, the
    gathered carry [N_sh, W_CARRY] words, stats)."""
    dev = mesh.device
    lo, _ = mesh.block(n_sh)
    t0 = time.perf_counter()
    rank = make_rank(_tensors(block_np, dev), _tensors(rep_np, dev), statics,
                     lo, n_sh, check)
    mesh.reset_stats()
    rounds, retries, stranded = drive(
        [rank], lambda xs: [mesh.all_gather(xs[0])], statics["max_rounds"],
        statics["gang_enabled"])
    packed, carry = rank.result(rounds, retries, stranded)
    carry_all = mesh.all_gather(carry.contiguous()).reshape(n_sh, W_CARRY)
    stats = dict(mesh.stats, rounds=rounds, retries=retries,
                 stranded=stranded, wall_ms=(time.perf_counter() - t0) * 1e3,
                 launches=0, kernel_ms={}, compared=0, mismatches=[])
    base = rank.cuda if isinstance(rank, CheckedRank) else rank
    if isinstance(base, CudaRank):
        stats.update(launches=base.launches, kernel_ms=base.kernel_ms())
    if isinstance(rank, CheckedRank):
        stats.update(compared=rank.compared, mismatches=rank.mismatches)
    return packed, carry_all, stats


def solve_lockstep(node_np, rep_np, statics, n_sh: int, world: int, device,
                   check: bool = False):
    """The sharded solve with ``world`` ranks in this process, in lock
    step, without a process group (each step's payloads concatenated).
    Returns (packed, carry [N_sh, W_CARRY] words, the ranks)."""
    dev = torch.device(device)
    nb = n_sh // world
    ranks = [make_rank(_tensors(b, dev), _tensors(rep_np, dev), statics,
                       r * nb, n_sh, check)
             for r, b in enumerate(split_blocks(node_np, world, n_sh))]

    def gather(xs):
        g = torch.stack([x.contiguous() for x in xs])
        return [g] * len(xs)

    rounds, retries, stranded = drive(ranks, gather, statics["max_rounds"],
                                      statics["gang_enabled"])
    outs = [r.result(rounds, retries, stranded) for r in ranks]
    bad = [m for r in ranks for m in getattr(r, "mismatches", ())]
    if bad:
        raise AssertionError("; ".join(bad[:4]))
    for p, _ in outs[1:]:
        if not torch.equal(p, outs[0][0]):
            raise AssertionError("sharded solve: ranks' results differ")
    carry = torch.cat([c for _, c in outs])
    return outs[0][0], carry, ranks


#: stats of the last solve_batched_sharded on rank 0: per rank (rank
#: order) rounds, collectives, stages, collective ms, launches and
#: kernel device ms by step; plus the solve's host wall
last_solve: Dict[str, object] = {}


def solve_batched_sharded(mesh, device, inputs, max_rounds: int = 0,
                          check: bool = False):
    """Sharded twin of kernels/batched.solve_batched on rank 0 of
    ``mesh`` (the other ranks serve: parallel/worker.py): same
    CycleInputs in, (task_state, task_node, task_seq, rounds, telemetry)
    numpy out. ``device`` is the session's DeviceSession: its node
    carry goes out in one counted copy and the final carry, gathered
    from every rank and trimmed to the one-card bucket, is written back.
    Readbacks as the reference counts them: the packed result (1) and
    the carry's four arrays (4), plus the node block's stage, one per
    round (the progress flag) and the epilogue's flags, and every stage
    of a host-staged collective. ``check``: every rank holds each launch
    against the plain version (:class:`CheckedRank`). The mesh's device
    and the session's must be of one type (ValueError otherwise)."""
    from .. import obs
    from ..device import to_host

    if mesh.rank != 0:
        raise ValueError("solve_batched_sharded runs on rank 0; the other "
                         "ranks serve (parallel.worker.serve)")
    if mesh.device.type != device.device.type:
        # the ranks solve on the mesh's device: a CPU mesh under a card's
        # session would run the plain ranks on the host in hiding
        raise ValueError(f"solve_batched_sharded: the mesh's ranks are on "
                         f"{mesh.device}, the session's node carry on "
                         f"{device.device}")
    t_pad = int(inputs.task_valid.shape[0])
    n_pad = int(device.n_padded)
    t0 = time.perf_counter()
    node, rep, statics, n_sh = prepare_sharded(mesh.world, device, inputs,
                                               max_rounds)
    blocks = split_blocks(node, mesh.world, n_sh)
    with obs.span("batched_allocate_sharded", cat="kernel") as sp:
        mesh.send_objects({"op": "batched", "rep": rep, "statics": statics,
                           "n_sh": n_sh, "check": check}, blocks)
        packed, carry, stats = solve_rank(mesh, blocks[0], rep, statics,
                                          n_sh, check)
        replies = mesh.gather_objects(stats)
        with obs.span("readback", cat="readback"):
            host = to_host(packed)
        obs.telemetry.record(host[3 * t_pad + 1:], span=sp)
        with obs.span("readback_carry", cat="readback", n=4):
            c = carry[:n_pad]
            idle = to_host(c[:, 0:3].contiguous()).view(np.float32)
            rel = to_host(c[:, 3:6].contiguous()).view(np.float32)
            ntasks = to_host(c[:, 6].contiguous())
            nz = to_host(c[:, 7:9].contiguous()).view(np.float32)
        dev = device.device
        device.idle = torch.from_numpy(idle.copy()).to(dev)
        device.releasing = torch.from_numpy(rel.copy()).to(dev)
        device.n_tasks = torch.from_numpy(ntasks.copy()).to(dev)
        device.nz_req = torch.from_numpy(nz.copy()).to(dev)
    last_solve.clear()
    last_solve.update(ranks=replies, n_sh=n_sh, world=mesh.world,
                      wall_ms=(time.perf_counter() - t0) * 1e3)
    bad = [m for r in replies for m in r.get("mismatches", ())]
    if bad:
        raise AssertionError("; ".join(bad[:4]))
    return (host[:t_pad], host[t_pad:2 * t_pad],
            host[2 * t_pad:3 * t_pad], int(host[3 * t_pad]),
            host[3 * t_pad + 1:])
