"""Node-sharded batched allocate — the round engine's node axis over a mesh.

Replaces kubebatch_tpu/kernels/batched_sharded.py (``_sharded_entry``
:130, ``solve_batched_sharded`` :184, ``prepare_sharded`` :233, the
affinity placement of ``_specs_for`` :74): the reference runs
kernels/batched.py's round loop under GSPMD with the node axis of every
big array split over a ``"nodes"`` mesh axis, task / job / queue arrays
replicated, compaction off, and XLA placing the collectives. Here the
node axis is split over a ``torch.distributed`` group
(:mod:`..parallel.mesh`): every rank holds its contiguous block of the
node bucket (the node carry, the static node rows, the [S, N_block]
predicate and score rows, the host ports in use and claimed) and the
replicated task, job and queue arrays, and the collectives sit where the
reference's node-axis reductions are.

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

**Inter-pod affinity and host ports** (the reference's ``_specs_for(
affinity=True)``): the [P,D] domain carry and the [T,P] term arrays are
replicated, the ports in use and claimed (``port_base`` / ``port_claim``
[N,PT]) stay on the owner's block, and every rank holds the whole
``node_dom`` [P, N_sh] (static for the cycle), so the domains of any
proposed, slotted or placed node are local everywhere: the in-round
serialization, the carry's commit and rollback and the wait rule's
"present anywhere" need no collective. The row pass adds the affinity
predicates of the block's nodes; the slot owner's answer adds them at
the slot (its port bits included); one port claimant a node is chosen
from the gathered proposals and global ranks. The interpod score
normalises each row by the min and max of its counts over every real
node: each rank takes them over its block for the rows that can score
at the next round's start and sends them with the accessible pool that
opens the round, so a round stays at five all-gathers; the row pass's
payload gains the row's "scored" bit (a scored task leaves the shared
waterfall).

**Node windows.** A round may run on a window of the bucket (a pool of
the two-level solve over the mesh, kernels/hier.py
``solve_hier_sharded``): each rank takes the window's part of its block
(possibly empty; it still joins every gather), node indices are the
window's, and the placements are written in global nodes.
:class:`HierPlainRank` / :class:`CudaHierRank` run that solve's waves:
a coarse step per rank over its block (per (task, pool) eligibility
bits and each pool's best majority score over the pool's nodes it
holds), all-gathered and combined by OR and max (both exact), the
winner and the waiting rule replicated, the pool's rounds as above.

Exactness: every rank's chain sees the same gathered views the one-card
round reads, so the result is bitwise the port's one-card plain batched
solve with ``compact_bucket=0`` on the same node bucket (decisions,
nodes, sequence numbers, rounds, the node carry, the [P,D] carry and the
port claims), and the two-level solve bitwise the one-card plain
two-level solve on the same bucket and pool. With k = 2 or 4 the bucket
is the one-card bucket; k = 3 pads it to a multiple of 3 (padding nodes
``node_ok=False``, no domain, no ports: inert).

Two implementations of each rank's steps behind one interface: the
plain one (:class:`PlainRank`, CPU tensors) and the CUDA kernels of
``csrc/sharded_round.cu`` (:class:`CudaRank`: one cooperative launch a
step, the replicated chain reusing ``batched_round.cuh``). A rank takes
the kernels for CUDA tensors and the plain version for CPU tensors.
:class:`CheckedRank` runs both on every step and holds each launch's
payload bitwise against the plain version on that rank's inputs.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _build
from .batched import (AFF_ARGS, CYCLE_ARGS, IP_ARG, NODE_ARGS, PORT_ARGS,
                      CycleArrays, RoundState, _IMAX, _AffRound,
                      _accept_rows, _admit, _aff_commit, _aff_gather,
                      _aff_involved, _aff_serialize, _avail_pool,
                      _cell_elig, _commit_jobs, _commit_node, _distinct_rows,
                      _eligibility, _ip_stats, _maj_pair, _pair_scores,
                      _pool_sums,
                      _rollback_stranded, _row_pass, _segsum, _settle,
                      _stranded_jobs, _waterfall_slots, arg_dtype)
from .fused import JOB_KEY_CODES, K_PROP_SHARE, SKIP
from .hier import _block_arrays, _block_state, _merge_block
from .solver import dynamic_node_score_plain, scan_node_score_plain
from .telemetry import (ENGINE_HIER_SHARDED, ENGINE_SHARDED, TELEM_WIDTH,
                        decision_frame)
from .tensorize import VEC_EPS
from .xla_order import WEIGHTED_SUM_FMA

#: int32 words of each step's payload a row: the accessible pool
#: (avail 3, max(rel, 0) 3); a carry row (idle + bf 3, idle 3, rel 3,
#: maxt - n_tasks); a row-pass partial (any, score bits, global index,
#: the carry row at the block's best; with an interpod score one more,
#: the row's "scored" bit: :func:`w_part`); a waterfall column (score
#: bits, capacity mass 3, room count); the slot owner's answer
#: (eligible, the carry row at the slot)
W_AVAIL, W_ROW, W_PART, W_COLS, W_OWN = 6, 10, 13, 5, 11
#: words a task row adds to the pool payload with an interpod score (the
#: min and max of its counts over the block's real nodes)
W_IP = 2
#: words of a node's final carry (idle 3, rel 3, n_tasks, nz 2); the
#: host ports claimed follow, one word a port
W_CARRY = 9

#: the static node rows each rank receives for its block (besides the
#: [S, N] predicate and score rows and, with host ports, ``port_base``)
_NODE_STATIC = ("backfilled", "allocatable_cm", "max_task_num", "node_ok")
#: the replicated cycle arrays (CYCLE_ARGS less the [S, N] rows)
REP_ARGS = tuple(n for n in CYCLE_ARGS
                 if n not in ("sig_scores", "sig_pred"))
#: widths of the node arrays in the staged node block, in NODE_ARGS order
_NODE_WIDTH = {"idle": 3, "releasing": 3, "n_tasks": 1, "nz_req": 2,
               "backfilled": 3, "allocatable_cm": 2, "max_task_num": 1,
               "node_ok": 1}
#: the replicated [P,D] carry's initial arrays and their RoundState fields
_AFF_CARRY = (("aff_grp_cnt0", "aff_grp_cnt"), ("aff_anti_cnt0",
                                                "aff_anti_cnt"),
              ("aff_pref_w0", "aff_pref_w"), ("aff_grp_total0",
                                              "aff_grp_total"))

_F32, _I32 = torch.float32, torch.int32


def _words(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == _F32:
        return t.contiguous().view(_I32)
    return t.to(_I32)


def _floats(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().view(_F32)


def w_part(ip: bool) -> int:
    """Words of a row-pass partial: W_PART, one more with an interpod
    score."""
    return W_PART + int(ip)


def parts_of(world: int, block: int, off: int, width: int):
    """[(lo, nb)] of each rank's part of the node window [off, off +
    width) of a bucket split in blocks of ``block`` nodes: window-local
    starts (in rank order, contiguous) and sizes (0 where the window
    misses the rank's block)."""
    out = []
    for r in range(world):
        lo = min(max(r * block, off), off + width) - off
        hi = min(max((r + 1) * block, off), off + width) - off
        out.append((lo, hi - lo))
    return out


def payload_words(parts, t_pad: int, ip: bool) -> Dict[str, int]:
    """int32 words a rank sends at the node-sized gathers of a round over
    ``parts`` (every rank the same, padded to the largest part): the
    pool (with an interpod score the rows' count ranges) and the
    waterfall columns. The task-sized ones are [T, w_part] and [T,
    W_OWN]."""
    nbmax = max(nb for _, nb in parts)
    return {"avail": nbmax * W_AVAIL + (t_pad * W_IP if ip else 0),
            "cols": nbmax * W_COLS}


def _window_rows(g: torch.Tensor, parts, width: int) -> torch.Tensor:
    """The gathered per-rank node payloads [k, L] words (rank r's first
    nb_r * width words its part's rows) as [N_window, width] in window
    order."""
    return torch.cat([g[r, :nb * width].reshape(nb, width)
                      for r, (_, nb) in enumerate(parts)])


def _rank_min_max(f: torch.Tensor):
    """Per row, the min of column 0 and the max of column 1 over the
    ranks of [k, T, 2] floats, rank by rank (the kernel's order; the
    payload holds no -0.0, so every order gives these bits)."""
    lo, hi = f[0, :, 0], f[0, :, 1]
    for r in range(1, f.shape[0]):
        lo = torch.where(f[r, :, 0] < lo, f[r, :, 0], lo)
        hi = torch.where(f[r, :, 1] > hi, f[r, :, 1], hi)
    return lo, hi


def _pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """[n, w] words padded with zero rows to [rows, w]."""
    if x.shape[0] == rows:
        return x
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype)
    out[:x.shape[0]] = x
    return out


def _arrays(block: Dict[str, torch.Tensor], rep: Dict[str, torch.Tensor]):
    """(CycleArrays, the initial affinity carry fields) of one rank from
    its node block and the replicated arrays (affinity ones included
    when the cycle carries the vocabulary: ``node_dom`` whole, the port
    rows of the block)."""
    fields = {k: block[k] for k in _NODE_STATIC}
    fields.update(sig_scores=block["sig_scores"], sig_pred=block["sig_pred"])
    fields.update({k: rep[k] for k in REP_ARGS if k in CycleArrays._fields})
    carry = {}
    if "node_dom" in rep:
        fields.update({k: rep[k] for k in AFF_ARGS[:7]})
        if "port_base" in block:
            fields.update(task_ports=rep["task_ports"],
                          port_base=block["port_base"])
            carry["port_claim"] = torch.zeros_like(block["port_base"])
        if IP_ARG in rep:
            fields["ip_weight"] = rep[IP_ARG].reshape(())
        carry.update({f: rep[k].clone() for k, f in _AFF_CARRY})
    return CycleArrays(**fields), carry


def _initial_state(block, rep, carry) -> RoundState:
    t_pad = rep["task_valid"].shape[0]
    return RoundState(
        idle=block["idle"].clone(), releasing=block["releasing"].clone(),
        n_tasks=block["n_tasks"].clone(), nz_req=block["nz_req"].clone(),
        q_allocated=rep["q_alloc0"].clone(),
        j_allocated=rep["j_alloc0"].clone(),
        alloc_cnt=rep["init_allocated"].clone(),
        job_alive=rep["job_valid"].clone(),
        task_state=torch.full((t_pad,), SKIP, dtype=_I32),
        task_node=torch.full((t_pad,), -1, dtype=_I32),
        task_seq=torch.full((t_pad,), _IMAX, dtype=_I32), **carry)


def _aff_words(state: RoundState) -> Optional[torch.Tensor]:
    """The final [P,D] carry as words (grp, anti, pref [P*D] each, then
    the [P] totals), None without the vocabulary."""
    if state.aff_grp_cnt is None:
        return None
    return torch.cat([_words(state.aff_grp_cnt).flatten(),
                      _words(state.aff_anti_cnt).flatten(),
                      _words(state.aff_pref_w).flatten(),
                      _words(state.aff_grp_total)])


def _aff_result(words: torch.Tensor, rep, carry: torch.Tensor) -> dict:
    """The final affinity carry as numpy (kernels/batched.py AFF_OUT
    names) from the [P,D] carry words (:func:`_aff_words`) and the
    gathered node carry's port columns (None without host ports)."""
    p_cnt, d_cap = rep["aff_grp_cnt0"].shape
    f = words.cpu().numpy().view(np.float32)
    pd = p_cnt * d_cap
    claim = carry[:, W_CARRY:].cpu().numpy() != 0
    return {"aff_grp_cnt": f[:pd].reshape(p_cnt, d_cap),
            "aff_anti_cnt": f[pd:2 * pd].reshape(p_cnt, d_cap),
            "aff_pref_w": f[2 * pd:3 * pd].reshape(p_cnt, d_cap),
            "aff_grp_total": f[3 * pd:],
            "port_claim": claim if claim.shape[1] else None}


def _check_cpu(what: str, *groups) -> None:
    for g in groups:
        for name, t in g.items():
            if t.device.type != "cpu":
                raise ValueError(f"{what} runs on CPU tensors ({name} is on "
                                 f"{t.device}; its segment sums are "
                                 f"index_add_'s sequential order)")


# ---- the plain version ----------------------------------------------------

class PlainRank:
    """One rank's steps of the sharded solve in plain PyTorch on CPU
    tensors. ``block``: the rank's node arrays (NODE_ARGS [N_block, ...],
    ``sig_scores`` / ``sig_pred`` [S, N_block], with host ports
    ``port_base``); ``rep``: REP_ARGS (with the affinity vocabulary its
    replicated arrays, ``node_dom`` whole); ``lo``: the block's first
    global node; ``n_sh``: the node bucket (a multiple of the block)."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], statics: dict, lo: int,
                 n_sh: int):
        _check_cpu("PlainRank", block, rep)
        a, carry = _arrays(block, rep)
        nb = int(block["node_ok"].shape[0])
        self._setup(_initial_state(block, rep, carry), a, statics,
                    int(lo) // nb, parts_of(int(n_sh) // nb, nb, 0,
                                            int(n_sh)))

    @classmethod
    def window(cls, state: RoundState, a: CycleArrays, statics: dict,
               rank: int, parts, elsewhere=None, weighted_fma=False):
        """A rank's rounds on its ``parts[rank]`` of a node window:
        ``state`` and ``a`` hold that part's nodes (window-local
        proposals; the caller maps them back), ``elsewhere`` the tasks
        eligible in another pool (they wait instead of failing)."""
        self = cls.__new__(cls)
        self._setup(state, a, statics, rank, parts, elsewhere, weighted_fma)
        return self

    def _setup(self, state, a, statics, rank, parts, elsewhere=None,
               weighted_fma=False):
        self.state, self.a, self.opts = state, a, statics
        self.rank, self.parts = int(rank), list(parts)
        self.lo, self.nb = self.parts[self.rank]
        self.n_sh = sum(nb for _, nb in self.parts)
        self.nbmax = max(nb for _, nb in self.parts)
        self.his = torch.tensor([lo + nb for lo, nb in self.parts])
        self.elsewhere = elsewhere
        self.fma = bool(weighted_fma)
        self.eps = torch.from_numpy(VEC_EPS)
        self.ip = a.ip_weight is not None
        self.wp = w_part(self.ip)
        self.aff = None
        #: the rounds, the task rows of this rank's row passes
        #: (participating and retrying) and, with an interpod score, those
        #: that can score and their terms (kernels/batched.py _ip_stats,
        #: replicated)
        self.stats = {"rounds": 0, "rows": 0}
        self.r = {}                        # the round's replicated values

    # ---- block helpers ---------------------------------------------------

    def _aff_round(self) -> Optional[_AffRound]:
        """The round-start affinity views of the block's nodes (the
        domain presence over the whole axis for the wait rule), None
        without the vocabulary."""
        a, s = self.a, self.state
        if a.node_dom is None:
            return None
        has_dom, _, gcnt, _ = _aff_gather(s, a)
        present_any = (has_dom & (gcnt > 0)).any(dim=1)
        blk = a._replace(node_dom=a.node_dom[:, self.lo:self.lo + self.nb])
        return _AffRound(s, blk, present_any)

    def _ip_words(self) -> torch.Tensor:
        """[T * W_IP] words: for each pending valid task row that can
        carry an interpod term at the next round's start (a preferred
        term of its own, or a group bit of a pair with carried weight),
        the min and max of its counts over the block's real nodes (+inf
        / -inf with none); zeros for the other rows."""
        s, a = self.state, self.a
        t_pad = a.task_valid.shape[0]
        out = torch.zeros((t_pad, W_IP), dtype=_I32)
        pref_any = (s.aff_pref_w != 0).any(dim=1)
        can = (a.task_pref_w != 0).any(dim=1) | (
            a.task_grp & pref_any[None, :]).any(dim=1)
        rows = torch.nonzero(a.task_valid & (s.task_state == SKIP)
                             & can).flatten()
        if rows.numel():
            lo = torch.full((rows.numel(),), torch.inf)
            hi = torch.full((rows.numel(),), -torch.inf)
            if self.nb:
                counts = self._aff_round().ip_counts(rows)
                valid = a.node_ok[None, :]
                lo = torch.where(valid, counts, torch.inf).amin(dim=1)
                hi = torch.where(valid, counts, -torch.inf).amax(dim=1)
            out[rows, 0] = _words(lo + 0.0)
            out[rows, 1] = _words(hi + 0.0)
        return out.flatten()

    def avail(self) -> torch.Tensor:
        """The pool payload: the block's accessible pool rows [N_block,
        W_AVAIL] padded to the largest part, flat, then with an interpod
        score the rows' count ranges."""
        av, rel = _avail_pool(self.state, self.a, True)
        rows = _pad_rows(torch.cat([_words(av), _words(rel)], dim=1),
                         self.nbmax).flatten()
        if self.ip:
            rows = torch.cat([rows, self._ip_words()])
        return rows

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
        carry as it stands: [T, w_part] (zeros outside ``mask``; the
        score word +0.0 for -0.0, which compares equal)."""
        s, a = self.state, self.a
        t_pad = mask.shape[0]
        self.stats["rows"] += int(mask.sum())
        if self.ip:
            _ip_stats(self.stats, s, a, mask)
        if self.nb == 0:
            return torch.zeros((t_pad, self.wp), dtype=_I32)
        any_b, best, scored, val = _row_pass(
            s.idle, s.releasing, s.n_tasks, a, self.opts["pipe_enabled"],
            self.eps, self.sc, mask, self.aff, values=True)
        cols = [any_b.to(_I32)[:, None], _words(val + 0.0)[:, None],
                (best + self.lo)[:, None], self._rows(best)]
        if self.ip:
            cols.append(scored.to(_I32)[:, None])
        out = torch.cat(cols, dim=1)
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
        return any_t, best, g[r, t, 3:3 + W_ROW]

    # ---- the steps -------------------------------------------------------

    def start(self) -> torch.Tensor:
        return self.avail()

    def rows1(self, round_idx: int, g_avail: torch.Tensor) -> torch.Tensor:
        """Ordering and the demand window from the gathered pool, the pair
        scores and the first row pass over the block."""
        s, a, o = self.state, self.a, self.opts
        g = g_avail.reshape(len(self.parts), -1)
        rows = _floats(_window_rows(g, self.parts, W_AVAIL))
        pool = _pool_sums(rows[:, 0:3].contiguous(),
                          rows[:, 3:6].contiguous() if o["pipe_enabled"]
                          else None)
        participating, order, global_rank = _admit(
            s, a, o["job_keys"], o["queue_keys"], o["prop_overused"], pool)
        self.stats["rounds"] += 1
        self.r = {"round": round_idx, "participating": participating,
                  "order": order, "global_rank": global_rank,
                  "base": a.node_ok & (s.n_tasks < a.max_task_num)}
        self.sc = _pair_scores(s, a, o["dyn_enabled"], self.fma)
        self.aff = self._aff_round()
        if self.aff is not None and self.ip:
            tail = _floats(g[:, self.nbmax * W_AVAIL:]).reshape(
                g.shape[0], -1, W_IP)
            self.aff.ip_range = _rank_min_max(tail)
        return self._partial(participating)

    def cols(self, g_part: torch.Tensor) -> torch.Tensor:
        """Combine the first row pass; fail / kill / part2 and the
        majority pair; the block's waterfall columns."""
        s, a, r = self.state, self.a, self.r
        g_part = g_part.reshape(len(self.parts), -1, self.wp)
        any_elig, fb, rows_fb = self._combine(g_part)
        part = r["participating"]
        fail_now = part & ~any_elig
        if self.aff is not None:
            # a positive-affinity task whose group a same-cycle placement
            # can still populate waits instead of killing its job
            fail_now = fail_now & ~self.aff.could_wait
        if self.elsewhere is not None:
            # a pool-restricted round: eligible in another pool waits
            fail_now = fail_now & ~self.elsewhere
        fail_first, job_killed, part2 = _settle(
            a, part, any_elig, fail_now, r["global_rank"])
        maj = _maj_pair(a, part2)
        r.update(fb=fb, rows_fb=rows_fb, fail_first=fail_first,
                 job_killed=job_killed, part2=part2)
        if self.ip:
            r["ip_scored"] = (g_part[:, :, W_PART] != 0).any(dim=0)
        maj_ok = a.sig_pred[int(a.pair_sig[maj])] & r["base"]
        zero = torch.tensor(0.0)
        cm = torch.where(maj_ok[:, None],
                         torch.maximum(s.idle + a.backfilled, zero), zero)
        room = torch.clamp(a.max_task_num - s.n_tasks, min=0).to(_F32)
        cnt = torch.where(maj_ok, room, zero)
        return _pad_rows(torch.cat([_words(self.sc[maj])[:, None],
                                    _words(cm), _words(cnt)[:, None]],
                                   dim=1), self.nbmax).flatten()

    def owner(self, g_cols: torch.Tensor) -> torch.Tensor:
        """The shared waterfall on the gathered columns (replicated), then
        the owner's answer at each part2 task's slot."""
        a, r, s = self.a, self.r, self.state
        g = _window_rows(g_cols.reshape(len(self.parts), -1), self.parts,
                         W_COLS)
        ord_sh, slot = _waterfall_slots(
            a, r["part2"], r["order"], _floats(g[:, 0]), _floats(g[:, 1:4]),
            _floats(g[:, 4]))
        p_water = ord_sh[slot.clamp(max=self.n_sh - 1)].to(_I32)
        r.update(slot_ok=slot < self.n_sh, p_water=p_water)
        t_pad = p_water.shape[0]
        if self.nb == 0:
            return torch.zeros((t_pad, W_OWN), dtype=_I32)
        mine = r["part2"] & (p_water >= self.lo) & (p_water < self.lo
                                                    + self.nb)
        local = (p_water - self.lo).clamp(0, self.nb - 1)
        elig = _cell_elig(s.idle, s.releasing, s.n_tasks, a,
                          self.opts["pipe_enabled"], self.eps, local)
        if self.aff is not None:
            elig = elig & self.aff.cell_ok(local)
        out = torch.cat([elig.to(_I32)[:, None], self._rows(local)], dim=1)
        return torch.where(mine[:, None], out, torch.tensor(0, dtype=_I32))

    def retry(self, g_own: torch.Tensor) -> torch.Tensor:
        """Proposals, phase-1 acceptance (serialized for the affinity
        vocabulary) and the owner's commit, then the retry row pass over
        the block on the mid-round carry."""
        r = self.r
        g_own = g_own.reshape(len(self.parts), -1, W_OWN)
        p_water = r["p_water"]
        owner = torch.searchsorted(self.his, p_water.long(), right=True
                                   ).clamp(max=len(self.parts) - 1)
        t = torch.arange(g_own.shape[1])
        water = (g_own[owner, t, 0] != 0) & r["slot_ok"]
        if self.ip:
            # interpod-scored tasks leave the shared waterfall
            water = water & ~r["ip_scored"]
        proposal1 = torch.where(water, p_water, r["fb"])
        rows1 = torch.where(water[:, None], g_own[owner, t, 1:],
                            r["rows_fb"])
        accept1, ob1, pa1 = self._accept(proposal1, r["part2"], rows1)
        if self.aff is not None:
            accept1 = _aff_serialize(self.state, self.a, accept1, proposal1,
                                     r["global_rank"])
        self._commit(accept1, pa1, proposal1, True)
        mask = r["part2"] & ~accept1
        if self.aff is not None:
            # affinity-involved tasks sit the retry out
            mask = mask & ~_aff_involved(self.state, self.a)
        r.update(phase1=(accept1, ob1, proposal1, pa1), mask=mask)
        return self._partial(mask)

    def finish(self, g_part: torch.Tensor) -> Tuple[bool, torch.Tensor]:
        """The retry's acceptance and commit, the job / queue aggregates,
        the decisions and the affinity carry. Returns (progress, the next
        pool payload)."""
        r = self.r
        g_part = g_part.reshape(len(self.parts), -1, self.wp)
        any_r, fb_r, rows_r = self._combine(g_part)
        retry = r["mask"] & any_r
        accept_r, ob_r, pa_r = self._accept(fb_r, retry, rows_r)
        self._commit(accept_r, pa_r, fb_r, False)
        fields, accept, proposal, changed = _commit_jobs(
            self.state, self.a, r["phase1"], (accept_r, ob_r, fb_r, pa_r),
            r["fail_first"], r["job_killed"], r["global_rank"], r["round"],
            self.a.task_valid.shape[0])
        if self.a.node_dom is not None:
            fields.update(_aff_commit(self.state, self.a, accept, proposal,
                                      self.lo))
        self.state = self.state._replace(**fields)
        return bool(changed.any()), self.avail()

    def stranded(self) -> bool:
        """Any stranded gang (killed ones included)."""
        return bool(_stranded_jobs(self.state, self.a).any())

    def rollback(self, revive: bool) -> Tuple[int, torch.Tensor]:
        """The stranded-gang rollback: the node carry and the port claims
        on the owner's block, the job side and the [P,D] carry
        replicated. Returns (stranded gangs, the next pool payload)."""
        self.state, stranded = _rollback_stranded(self.state, self.a, revive,
                                                  lo=self.lo)
        return int(stranded.sum()), self.avail()

    def result(self, rounds: int, retries: int, stranded: int):
        """(packed [3T + 1 + TELEM_WIDTH] int32, the block's carry
        [N_block, W_CARRY (+ PT)] words, the [P,D] carry words or
        None)."""
        s, o = self.state, self.opts
        t_pad = s.task_state.shape[0]
        frame = decision_frame(ENGINE_SHARDED, s.task_state, s.task_seq,
                               self.a.task_valid, waves=rounds, stride=t_pad,
                               narrow=o["narrow"],
                               narrow_gate=o["narrow_gate"],
                               retries=retries, stranded=stranded)
        packed = torch.cat([s.task_state, s.task_node, s.task_seq,
                            torch.tensor([rounds], dtype=_I32), frame])
        return packed, _carry_words(s), _aff_words(s)


def _carry_words(s: RoundState) -> torch.Tensor:
    cols = [_words(s.idle), _words(s.releasing), s.n_tasks[:, None],
            _words(s.nz_req)]
    if s.port_claim is not None:
        cols.append(s.port_claim.to(_I32))
    return torch.cat(cols, dim=1)


# ---- the CUDA kernels ------------------------------------------------------

#: sharded_round.cu's steps, in the order of its SEG_* codes
SEGMENTS = ("start", "rows1", "cols", "owner", "retry", "finish",
            "stranded", "rollback", "frame", "coarse", "wave", "avail",
            "hframe")

#: the affinity pointer slots of batched_round.cuh's P_*
_AFF_SLOTS = 19


class CudaRank:
    """One rank's steps as launches of ``csrc/sharded_round.cu`` on CUDA
    tensors: one cooperative launch a step, the replicated state in a
    workspace that lives across the launches, each step's payload
    written to a device buffer. Same interface and payloads as
    :class:`PlainRank`. Reading a flag (progress, stranded) is a counted
    device->host copy. ``pool``: the two-level solve's pool width (0:
    the flat solve)."""

    def __init__(self, block: Dict[str, torch.Tensor],
                 rep: Dict[str, torch.Tensor], statics: dict, lo: int,
                 n_sh: int, pool: int = 0, weighted_fma: bool = False):
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
        self.world = self.n_sh // nb
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
        aff_ptrs, aff_ints = [0] * _AFF_SLOTS, [0] * 5
        self.aff_out = None
        self.ip = IP_ARG in rep
        if "node_dom" in rep:
            p_cnt, d_cap = c["aff_grp_cnt0"].shape
            pt = c["task_ports"].shape[1] if "task_ports" in c else 0
            if not 1 <= p_cnt <= 128 or pt > 64:
                raise ValueError(f"CudaRank: {p_cnt} affinity pairs and {pt} "
                                 f"ports exceed the kernel's 128 / 64")
            self.aff_out = {f: torch.empty_like(c[k]) for k, f in _AFF_CARRY}
            self.pclaim = (torch.empty_like(c["port_base"]) if pt
                           else None)
            aff_ptrs = [c[k].data_ptr() for k in AFF_ARGS] + [
                c["task_ports"].data_ptr() if pt else 0,
                c["port_base"].data_ptr() if pt else 0,
                c[IP_ARG].data_ptr() if self.ip else 0] + [
                self.aff_out[f].data_ptr() for _, f in _AFF_CARRY] + [
                self.pclaim.data_ptr() if pt else 0]
            aff_ints = [1, p_cnt, d_cap, pt, int(self.ip)]
        self.wp = w_part(self.ip)
        self.pool = int(pool)
        n_pools = self.n_sh // self.pool if self.pool else 0
        codes = [JOB_KEY_CODES[k] for k in o["job_keys"]] + [0] * (
            3 - len(o["job_keys"]))
        self.ints = np.asarray([
            n_sh, t, j, q, p, len(o["job_keys"]), *codes,
            int(K_PROP_SHARE in o["queue_keys"]), int(o["prop_overused"]),
            int(o["dyn_enabled"]), int(o["pipe_enabled"]),
            int(o["max_rounds"]), 0, int(o["gang_enabled"]),
            int(o["narrow"]), int(o["narrow_gate"]), *aff_ints,
            self.lo, nb, self.world, int(weighted_fma), self.pool, n_pools,
            0, self.n_sh, 0], dtype=np.int32)
        #: the ints' window slots (off, width, elsewhere), csrc I_OFF ...
        self._win = len(self.ints) - 3
        self.lib = _build.library("sharded_round.cu")
        ws = ctypes.c_longlong(0)
        sws = ctypes.c_longlong(0)
        _build.check_launch("sharded_round", self.lib.kb_sharded_workspace(
            self.ints.ctypes.data, self.ints.shape[0], ctypes.addressof(ws),
            ctypes.addressof(sws)))
        self.ws = torch.empty(ws.value, dtype=torch.uint8, device=dev)
        self.sws = torch.empty(sws.value, dtype=torch.uint8, device=dev)
        self.phase_ns = torch.zeros(32, dtype=torch.int64, device=dev)
        words = payload_words(parts_of(self.world, nb, 0, self.n_sh), t,
                              self.ip)
        bw = (n_pools + 31) // 32
        self.out = {
            "avail": torch.empty(words["avail"], dtype=_I32, device=dev),
            "part": torch.empty((t, self.wp), dtype=_I32, device=dev),
            "cols": torch.empty(words["cols"], dtype=_I32, device=dev),
            "own": torch.empty((t, W_OWN), dtype=_I32, device=dev),
            "coarse": torch.empty(max(1, t * bw + n_pools), dtype=_I32,
                                  device=dev),
        }
        self.flags = torch.zeros(8, dtype=_I32, device=dev)
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
            self.phase_ns.data_ptr(), *aff_ptrs,
            self.ws.data_ptr(), self.sws.data_ptr(), self.flags.data_ptr()],
            dtype=np.uint64)
        self.info = np.zeros(3, dtype=np.int32)
        #: CUDA event pairs of this rank's launches (device ms: kernel_ms)
        self.events: List[tuple] = []
        self.launches = 0
        self.set_window(0, self.n_sh, False)

    def set_window(self, off: int, width: int, elsewhere: bool) -> None:
        """The node window of the following round launches ([off, off +
        width) of the bucket; ``elsewhere``: the tasks the last wave
        found eligible in another pool wait instead of failing)."""
        i = self._win
        self.ints[i:i + 3] = (off, width, int(elsewhere))
        self.parts = parts_of(self.world, self.nb, off, width)
        self.sizes = payload_words(self.parts, self.t, self.ip)

    def _launch(self, seg: str, args=(), inp=None, out=None, words=None):
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
        if out is not None and words is not None:
            return out[:words]
        return out

    def _flags(self) -> np.ndarray:
        from ..device import to_host

        return to_host(self.flags)

    def kernel_ms(self) -> Dict[str, float]:
        """Device ms of this rank's launches by step (synchronizes)."""
        torch.cuda.synchronize(self.dev)
        out: Dict[str, float] = {}
        for seg, s, e in self.events:
            out[seg] = out.get(seg, 0.0) + s.elapsed_time(e)
        return out

    def start(self):
        return self._launch("start", out=self.out["avail"],
                            words=self.sizes["avail"])

    def rows1(self, round_idx, g_avail):
        self._round = round_idx
        return self._launch("rows1", (round_idx,), g_avail, self.out["part"])

    def cols(self, g_part):
        return self._launch("cols", (), g_part, self.out["cols"],
                            self.sizes["cols"])

    def owner(self, g_cols):
        return self._launch("owner", (), g_cols, self.out["own"])

    def retry(self, g_own):
        return self._launch("retry", (), g_own, self.out["part"])

    def finish(self, g_part):
        avail = self._launch("finish", (self._round,), g_part,
                             self.out["avail"], self.sizes["avail"])
        return bool(self._flags()[0]), avail

    def stranded(self):
        self._launch("stranded")
        return bool(self._flags()[1])

    def rollback(self, revive):
        avail = self._launch("rollback", (int(revive),), out=self.out["avail"],
                             words=self.sizes["avail"])
        return int(self._flags()[2]), avail

    def result(self, rounds, retries, stranded):
        self._launch("frame", (rounds, retries, stranded))
        return self.packed, self._carry(), self._aff()

    def _carry(self) -> torch.Tensor:
        cols = [_words(self.idle), _words(self.rel), self.ntasks[:, None],
                _words(self.nz)]
        if self.aff_out is not None and self.pclaim is not None:
            cols.append(self.pclaim.to(_I32))
        return torch.cat(cols, dim=1)

    def _aff(self) -> Optional[torch.Tensor]:
        if self.aff_out is None:
            return None
        o = self.aff_out
        return torch.cat([_words(o["aff_grp_cnt"]).flatten(),
                          _words(o["aff_anti_cnt"]).flatten(),
                          _words(o["aff_pref_w"]).flatten(),
                          _words(o["aff_grp_total"])])


class CheckedRank:
    """Runs a :class:`CudaRank` and a :class:`PlainRank` on CPU copies of
    the same inputs side by side: every step's payload from the kernel is
    held bitwise against the plain version's on the same gathered input
    (the kernel's), and so are the flags and the final result.
    ``compared`` counts the checks, ``mismatches`` lists the ones that
    differed (the solve goes on with the kernel's payloads, so every
    rank stays in step; the callers raise at the end)."""

    def __init__(self, cuda, plain):
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
        pc, cc, fc = self.cuda.result(rounds, retries, stranded)
        pp, cp, fp = self.plain.result(rounds, retries, stranded)
        self._check("frame", pc, pp)
        self._check("carry", cc, cp)
        if fp is not None:
            self._check("affinity carry", fc, fp)
        return pc, cc, fc


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


def _agree(vals):
    if any(v != vals[0] for v in vals):
        raise AssertionError(f"sharded solve: ranks disagree {vals}")
    return vals[0]


def _rounds_loop(ranks, gather, start: int, avail, max_rounds: int):
    """Rounds from ``start`` while one makes progress (at most up to
    ``max_rounds``), each rank's pool payload in ``avail``. Returns (the
    next round, the last pool payloads, whether any round progressed)."""
    rnd, progress, any_progress = start, True, False
    while progress and rnd < max_rounds:
        g = gather(avail)
        g = gather([r.rows1(rnd, x) for r, x in zip(ranks, g)])
        g = gather([r.cols(x) for r, x in zip(ranks, g)])
        g = gather([r.owner(x) for r, x in zip(ranks, g)])
        g = gather([r.retry(x) for r, x in zip(ranks, g)])
        outs = [r.finish(x) for r, x in zip(ranks, g)]
        progress = _agree([o[0] for o in outs])
        any_progress = any_progress or progress
        avail = [o[1] for o in outs]
        rnd += 1
    return rnd, avail, any_progress


def drive(ranks: list, gather, max_rounds: int, gang: bool):
    """Run the solve on ``ranks`` (this process's: one on a process
    mesh, k in lock step without one), joining them at every step with
    ``gather`` (a list of payloads, one a rank here, -> the list of what
    each receives: [k, ...] words). Returns (rounds, retries, stranded).
    Every rank computes the replicated flags; they must agree."""
    rounds, avail, _ = _rounds_loop(ranks, gather, 0,
                                    [r.start() for r in ranks], max_rounds)
    retries = stranded = 0
    if gang:
        while retries < 3 and _agree([r.stranded() for r in ranks]):
            outs = [r.rollback(True) for r in ranks]
            rounds, avail, _ = _rounds_loop(ranks, gather, rounds,
                                            [o[1] for o in outs], max_rounds)
            retries += 1
        stranded = _agree([r.rollback(False)[0] for r in ranks])
    return rounds, retries, stranded


# ---- the two-level solve over the mesh ------------------------------------

#: wave step modes (csrc/sharded_round.cu WAVE_*): the first wave of a
#: waves loop (the quarantine cleared), the first wave of the solve (its
#: pool occupancy and fill recorded), the terminal FAIL sweep
WAVE_RESET, WAVE_RECORD, WAVE_TERMINAL = 1, 2, 4


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[T, B] bool -> [T, ceil(B / 32)] int32 words (bit b & 31 of word
    b >> 5)."""
    t_pad, n_pools = bits.shape
    bw = (n_pools + 31) // 32
    out = torch.zeros((t_pad, bw), dtype=torch.int64)
    for b in range(n_pools):
        out[:, b >> 5] |= bits[:, b].to(torch.int64) << (b & 31)
    out = torch.where(out >= 2 ** 31, out - 2 ** 32, out)
    return out.to(_I32)


def _unpack_bits(words: torch.Tensor, n_pools: int) -> torch.Tensor:
    w = words.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([((w[:, b >> 5] >> (b & 31)) & 1) != 0
                        for b in range(n_pools)], dim=1)


class HierPlainRank:
    """One rank's steps of the two-level solve over the mesh in plain
    PyTorch on CPU tensors (the one-card plain ``hier_allocate``,
    kernels/hier.py, with every node-axis step restricted to the rank's
    block): ``coarse`` (the block's per (task, pool) eligibility bits and
    pool scores), ``wave`` (the gathered pass combined, the winner, the
    quarantine and the waiting rule, replicated), ``pool_avail`` (the
    winning pool's rounds open on the rank's part of it: the round steps
    of :class:`PlainRank` until ``end_pool``), and the epilogue over the
    whole block. ``stats`` counts the rank's work (the bound's)."""

    def __init__(self, block, rep, statics, lo: int, n_sh: int, pool: int):
        _check_cpu("HierPlainRank", block, rep)
        if "node_dom" in rep:
            raise ValueError("the two-level solve carries no affinity")
        self.a, _ = _arrays(block, rep)
        self.state = _initial_state(block, rep, {})
        self.opts = statics
        self.lo, self.n_sh, self.pool = int(lo), int(n_sh), int(pool)
        self.nb = int(block["node_ok"].shape[0])
        self.world = self.n_sh // self.nb
        self.n_pools = self.n_sh // self.pool
        self.fma = WEIGHTED_SUM_FMA["hier_sharded"]
        self.eps = torch.from_numpy(VEC_EPS)
        self.blocked = torch.zeros(self.n_pools, dtype=torch.bool)
        self.winner, self.occ, self.fill = 0, 0, 0
        self.round: Optional[PlainRank] = None
        #: this rank's work: the coarse passes, their pending rows and the
        #: cells they needed (per row and pool part, up to and including
        #: the first eligible node, or the whole part), the rounds' task
        #: rows and their (row x real node) and (pair x real node) cells
        #: over the rank's part of each pool, rounds, waves, and the
        #: winning pools whose nodes span more than one rank
        self.stats = {"coarse_passes": 0, "coarse_rows": 0,
                      "coarse_cells": 0, "rows": 0, "row_cells": 0,
                      "pair_cells": 0, "rounds": 0, "waves": 0,
                      "straddling": 0}

    def _pool_part(self, b: int):
        """(start, end) of pool b's nodes in this block (local)."""
        s = min(max(b * self.pool - self.lo, 0), self.nb)
        e = min(max((b + 1) * self.pool - self.lo, 0), self.nb)
        return s, e

    def coarse(self) -> torch.Tensor:
        """[T * BW + B] words: per pending task, one bit per pool (any
        eligible node of the pool in this block), then per pool the
        majority pair's best masked score over the pool's nodes here
        (-inf for none; the kernel's order, -0.0 read as +0.0)."""
        s, a = self.state, self.a
        self.stats["coarse_passes"] += 1
        t_pad = a.task_valid.shape[0]
        tj0 = a.task_job.clamp(min=0).long()
        pending = (a.task_valid & (s.task_state == SKIP)
                   & s.job_alive[tj0] & a.job_valid[tj0])
        self.pending = pending
        gather, init, sig, _ = _distinct_rows(a, torch.arange(t_pad))
        rows_elig = torch.zeros((init.shape[0], self.n_pools),
                                dtype=torch.bool)
        rows_cells = torch.zeros(init.shape[0], dtype=torch.int64)
        for c in range(0, init.shape[0], 256):
            sl = slice(c, c + 256)
            elig = _eligibility(s.idle, s.releasing, s.n_tasks, a,
                                self.opts["pipe_enabled"], self.eps,
                                init[sl], sig[sl])
            for b in range(self.n_pools):
                p0, p1 = self._pool_part(b)
                if p1 <= p0:
                    continue
                e = elig[:, p0:p1]
                anyb = e.any(dim=1)
                rows_elig[sl, b] = anyb
                first = e.to(torch.uint8).argmax(dim=1) + 1
                rows_cells[sl] += torch.where(anyb, first, p1 - p0)
        bits = rows_elig[gather] & pending[:, None]
        self.stats["coarse_rows"] += int(pending.sum())
        self.stats["coarse_cells"] += int(rows_cells[gather][pending].sum())
        pair_demand = _segsum(pending.to(_I32), a.task_pair.long(),
                              a.pair_sig.shape[0])
        maj = int(pair_demand.argmax())
        msig = int(a.pair_sig[maj])
        sc_maj = a.sig_scores[msig]
        if self.opts["dyn_enabled"]:
            score = scan_node_score_plain if self.fma \
                else dynamic_node_score_plain
            sc_maj = sc_maj + score(s.nz_req, a.pair_nz[maj],
                                    a.allocatable_cm, a.dyn_weights)
        base = a.node_ok & (s.n_tasks < a.max_task_num)
        vals = torch.where(a.sig_pred[msig] & base, sc_maj,
                           torch.tensor(-3.0e38))
        best = torch.full((self.n_pools,), -torch.inf)
        for b in range(self.n_pools):
            p0, p1 = self._pool_part(b)
            if p1 > p0:
                best[b] = vals[p0:p1].amax() + 0.0
        return torch.cat([_pack_bits(bits).flatten(), _words(best)])

    def wave(self, g: torch.Tensor, mode: int, progressed: bool):
        """The gathered coarse pass combined (bits by OR, pool scores by
        max), the quarantine updated for the last wave, the candidates,
        the winner and the waiting rule. Returns (has work, winner)."""
        k, t_pad = g.shape[0], self.a.task_valid.shape[0]
        g = g.reshape(k, -1)
        bw = (self.n_pools + 31) // 32
        words = g[:, :t_pad * bw].reshape(k, t_pad, bw)
        ored = words[0].clone()
        for r in range(1, k):
            ored |= words[r]
        bits = _unpack_bits(ored, self.n_pools)
        fb = _floats(g[:, t_pad * bw:])
        best = fb[0].clone()
        for r in range(1, k):
            best = torch.where(fb[r] > best, fb[r], best)
        if mode & WAVE_RESET:
            self.blocked = torch.zeros_like(self.blocked)
        elif progressed:
            self.blocked = torch.zeros_like(self.blocked)
        else:
            self.blocked = self.blocked.clone()
            self.blocked[self.winner] = True
        cand = (bits & self.pending[:, None]).sum(dim=0)
        if mode & WAVE_TERMINAL:
            self.winner = 0
            self.elsewhere = bits.any(dim=1)
            return False, 0
        key = torch.where((cand > 0) & ~self.blocked, best,
                          torch.tensor(-torch.inf))
        has_work = bool((key > -torch.inf).any())
        self.winner = int(key.argmax())
        if mode & WAVE_RECORD:
            self.occ = int((cand > 0).sum())
            self.fill = int(cand[self.winner])
        others = torch.arange(self.n_pools) != self.winner
        self.elsewhere = (bits & others[None, :]).any(dim=1)
        self.stats["waves"] += 1
        if has_work and sum(nb > 0 for _, nb in parts_of(
                self.world, self.nb, self.winner * self.pool,
                self.pool)) > 1:
            self.stats["straddling"] += 1
        return has_work, self.winner

    def pool_avail(self) -> torch.Tensor:
        """Open the winning pool's rounds on this rank's part of it;
        returns the part's pool payload."""
        off = self.winner * self.pool
        parts = parts_of(self.world, self.nb, off, self.pool)
        s0 = min(max(off - self.lo, 0), self.nb)
        size = parts[self.lo // self.nb][1]
        self.round = PlainRank.window(
            _block_state(self.state, s0, size),
            _block_arrays(self.a, s0, size), self.opts, self.lo // self.nb,
            parts, self.elsewhere, self.fma)
        self._pool = (off, s0, size)
        self._pool_rounds = 0
        return self.round.avail()

    def rows1(self, round_idx, g):
        self.stats["rounds"] += 1
        self._pool_rounds += 1
        return self.round.rows1(round_idx, g)

    def cols(self, g):
        return self.round.cols(g)

    def owner(self, g):
        return self.round.owner(g)

    def retry(self, g):
        return self.round.retry(g)

    def finish(self, g):
        return self.round.finish(g)

    def end_pool(self) -> None:
        """Fold the pool's rounds back into the block: the part's node
        carry, the task / job / queue state whole, this pool's new
        placements at global nodes."""
        off, s0, size = self._pool
        real = int(self.round.a.node_ok.sum())
        rows = self.round.stats["rows"]
        self.stats["rows"] += rows
        self.stats["row_cells"] += rows * real
        self.stats["pair_cells"] += (self._pool_rounds * real
                                     * self.a.pair_sig.shape[0])
        self.state = _merge_block(self.state, self.round.state, s0, size,
                                  node_off=off)
        self.round = None

    def stranded(self) -> bool:
        return bool(_stranded_jobs(self.state, self.a).any())

    def rollback(self, revive: bool) -> int:
        """The stranded-gang rollback over the whole block. Returns the
        stranded gangs."""
        self.state, stranded = _rollback_stranded(self.state, self.a, revive,
                                                  lo=self.lo)
        return int(stranded.sum())

    def result(self, rounds: int, retries: int, stranded: int):
        """(packed, the block's carry words, None)."""
        s, o = self.state, self.opts
        t_pad = s.task_state.shape[0]
        frame = decision_frame(ENGINE_HIER_SHARDED, s.task_state, s.task_seq,
                               self.a.task_valid, waves=rounds, stride=t_pad,
                               narrow=o["narrow"],
                               narrow_gate=o["narrow_gate"],
                               retries=retries, stranded=stranded,
                               pool_occ=self.occ, bucket_fill=self.fill)
        packed = torch.cat([s.task_state, s.task_node, s.task_seq,
                            torch.tensor([rounds], dtype=_I32), frame])
        return packed, _carry_words(s), None


class CudaHierRank(CudaRank):
    """:class:`HierPlainRank`'s steps as launches of
    ``csrc/sharded_round.cu``: the coarse step and the wave step, the
    pool's rounds in a node window, the epilogue over the block, the
    frame under ENGINE_HIER_SHARDED. One counted readback a wave (its
    has-work flag and winner)."""

    def __init__(self, block, rep, statics, lo: int, n_sh: int, pool: int):
        super().__init__(block, rep, statics, lo, n_sh, pool=pool,
                         weighted_fma=WEIGHTED_SUM_FMA["hier_sharded"])
        self.n_pools = self.n_sh // self.pool
        bw = (self.n_pools + 31) // 32
        self.coarse_words = self.t * bw + self.n_pools
        self.winner = 0

    def begin(self) -> None:
        """The solve's initial state (the flat solve's start step)."""
        self.set_window(0, self.n_sh, False)
        self._launch("start", out=self.out["avail"])

    def coarse(self):
        self.set_window(0, self.n_sh, False)
        return self._launch("coarse", out=self.out["coarse"],
                            words=self.coarse_words)

    def wave(self, g, mode, progressed):
        self._launch("wave", (mode, int(progressed)), g)
        if mode & WAVE_TERMINAL:
            self.winner = 0
            return False, 0
        f = self._flags()
        self.winner = int(f[4])
        return bool(f[3]), self.winner

    def pool_avail(self):
        self.set_window(self.winner * self.pool, self.pool, True)
        return self._launch("avail", out=self.out["avail"],
                            words=self.sizes["avail"])

    def end_pool(self) -> None:
        self.set_window(0, self.n_sh, False)

    def rollback(self, revive):
        self.set_window(0, self.n_sh, False)
        self._launch("rollback", (int(revive),), out=self.out["avail"])
        return int(self._flags()[2])

    def result(self, rounds, retries, stranded):
        self._launch("hframe", (rounds, retries, stranded))
        return self.packed, self._carry(), None


class CheckedHierRank(CheckedRank):
    """:class:`CheckedRank` for the two-level solve's ranks."""

    def begin(self):
        self.cuda.begin()

    def coarse(self):
        return self._check("coarse", self.cuda.coarse(), self.plain.coarse())

    def wave(self, g, mode, progressed):
        got = self.cuda.wave(g, mode, progressed)
        return self._check("wave", got, self.plain.wave(g.cpu(), mode,
                                                        progressed))

    def pool_avail(self):
        return self._check("avail", self.cuda.pool_avail(),
                           self.plain.pool_avail())

    def end_pool(self):
        self.cuda.end_pool()
        self.plain.end_pool()

    def rollback(self, revive):
        return self._check("rollback count", self.cuda.rollback(revive),
                           self.plain.rollback(revive))


def make_hier_rank(block, rep, statics, lo: int, n_sh: int, pool: int,
                   check: bool = False):
    """The two-level rank for the tensors' device (as :func:`make_rank`)."""
    devs = {t.device.type for t in list(block.values())
            + list(rep.values())}
    if devs == {"cpu"}:
        return HierPlainRank(block, rep, statics, lo, n_sh, pool)
    if devs != {"cuda"}:
        raise ValueError(f"sharded solve: inputs on mixed devices {devs}")
    rank = CudaHierRank(block, rep, statics, lo, n_sh, pool)
    if check:
        rank = CheckedHierRank(rank, HierPlainRank(
            {k: v.cpu() for k, v in block.items()},
            {k: v.cpu() for k, v in rep.items()}, statics, lo, n_sh, pool))
    return rank


def drive_hier(ranks: list, gather, max_rounds: int, max_waves: int,
               gang: bool):
    """The two-level solve's wave loop on ``ranks`` (kernels/hier.py
    ``hier_allocate``: waves until no pool has eligible pending work, a
    dead wave quarantining its pool, the terminal FAIL sweep on pool 0,
    the stranded-gang epilogue re-entering the waves), joined as
    :func:`drive` joins them. Returns (rounds, retries, stranded)."""
    for r in ranks:
        if hasattr(r, "begin"):
            r.begin()

    def pool_rounds(rounds):
        rounds, _, progressed = _rounds_loop(
            ranks, gather, rounds, [r.pool_avail() for r in ranks],
            max_rounds)
        for r in ranks:
            r.end_pool()
        return rounds, progressed

    def waves_loop(rounds, first):
        wave, progressed, has_work = 0, False, True
        while has_work and wave < max_waves:
            g = gather([r.coarse() for r in ranks])
            mode = (WAVE_RESET if wave == 0 else 0) | (
                WAVE_RECORD if first and wave == 0 else 0)
            has_work, _ = _agree([r.wave(x, mode, progressed)
                                  for r, x in zip(ranks, g)])
            if has_work:
                rounds, progressed = pool_rounds(rounds)
            wave += 1
        g = gather([r.coarse() for r in ranks])
        for r, x in zip(ranks, g):
            r.wave(x, WAVE_TERMINAL, progressed)
        rounds, _ = pool_rounds(rounds)
        return rounds

    rounds = waves_loop(0, True)
    retries = stranded = 0
    if gang:
        while retries < 3 and _agree([r.stranded() for r in ranks]):
            for r in ranks:
                r.rollback(True)
            rounds = waves_loop(rounds, False)
            retries += 1
        stranded = _agree([r.rollback(False) for r in ranks])
    return rounds, retries, stranded


# ---- inputs ---------------------------------------------------------------

def _np_node_cols(a: np.ndarray, n_sh: int, fill=0) -> np.ndarray:
    """[S, N] rows padded on the node columns to ``n_sh`` (zeros: a
    padding node has no predicate and no score; ``fill`` -1 for
    ``node_dom``: no domain)."""
    out = np.full((a.shape[0], n_sh), fill, a.dtype)
    out[:, :a.shape[1]] = a
    return out


def prepare_sharded(world: int, device, inputs, max_rounds: int = 0):
    """(node, rep, statics, n_sh) of the sharded solve for these
    CycleInputs on a mesh of ``world`` ranks (reference
    ``prepare_sharded``): ``node`` maps NODE_ARGS, the [S, N] rows and,
    with host ports, ``port_base`` to numpy arrays padded to the shard
    bucket (padding nodes ``node_ok=False``, zero, no ports: inert),
    ``rep`` the replicated cycle arrays; with the affinity vocabulary
    ``rep`` adds ``node_dom`` over the whole bucket (padded with -1: no
    domain), the [T,P] terms, the initial [P,D] carry, the task ports
    and the interpod weight. The narrow words use the reference's
    per-shard policy. The DeviceSession's node arrays leave the device
    in ONE counted copy."""
    from ..device import to_host
    from ..parallel.mesh import shard_bucket
    from .narrow import narrow_enabled

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
        rep[k] = np.ascontiguousarray(np.asarray(v, _np_dtype(k)))
    aff = getattr(inputs, "affinity", None)
    ip_weight = 0.0
    if aff is not None:
        rep.update(
            node_dom=_np_node_cols(np.asarray(aff.node_dom, np.int32), n_sh,
                                   -1),
            task_grp=aff.task_grp, task_req_aff=aff.task_req_aff,
            task_req_anti=aff.task_req_anti, task_self_ok=aff.task_self_ok,
            task_carry_w=aff.task_carry_w, task_pref_w=aff.task_pref_w,
            aff_grp_cnt0=aff.grp_cnt0, aff_anti_cnt0=aff.anti_cnt0,
            aff_pref_w0=aff.pref_w0, aff_grp_total0=aff.grp_total0)
        if np.any(aff.task_ports):
            rep["task_ports"] = aff.task_ports
            base = np.zeros((n_sh, aff.port_base.shape[1]), bool)
            base[:aff.port_base.shape[0]] = aff.port_base
            node["port_base"] = base
        if aff.ip_enabled:
            rep[IP_ARG] = np.asarray([aff.ip_weight], np.float32)
            ip_weight = aff.ip_weight
        for k in AFF_ARGS + PORT_ARGS:
            if k in rep:
                rep[k] = np.ascontiguousarray(np.asarray(rep[k],
                                                         _np_dtype(k)))
    per_shard = max(1, n_sh // world)
    narrow = narrow_enabled(
        per_shard, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None),
        ip_weight=ip_weight)
    statics = dict(
        job_keys=tuple(inputs.job_keys), queue_keys=tuple(inputs.queue_keys),
        prop_overused=bool(inputs.prop_overused),
        dyn_enabled=bool(inputs.dyn_enabled),
        pipe_enabled=bool(inputs.pipe_enabled),
        max_rounds=min(max_rounds, 4096),
        gang_enabled=bool(inputs.gang_enabled), narrow=bool(narrow),
        narrow_gate=bool(not narrow and narrow_enabled(per_shard, t_pad)))
    return node, rep, statics, n_sh


def _np_dtype(name: str):
    dt = arg_dtype(name)
    return (np.float32 if dt == torch.float32
            else bool if dt == torch.bool else np.int32)


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
    return {k: torch.from_numpy(np.array(v, copy=True)).to(arg_dtype(k))
            .to(dev) for k, v in arrays.items()}


def _rank_stats(mesh, rank, t0: float, rounds, retries, stranded) -> dict:
    stats = dict(mesh.stats, rounds=rounds, retries=retries,
                 stranded=stranded, wall_ms=(time.perf_counter() - t0) * 1e3,
                 launches=0, kernel_ms={}, compared=0, mismatches=[])
    base = getattr(rank, "cuda", rank)
    if isinstance(base, CudaRank):
        stats.update(launches=base.launches, kernel_ms=base.kernel_ms())
    if isinstance(rank, CheckedRank):
        stats.update(compared=rank.compared, mismatches=rank.mismatches)
    plain = getattr(rank, "plain", rank)
    if isinstance(plain, HierPlainRank):
        stats["work"] = dict(plain.stats)
    return stats


def solve_rank(mesh, block_np, rep_np, statics, n_sh: int,
               check: bool = False):
    """This rank's part of a sharded solve on ``mesh`` (every rank calls
    it with its own block). Returns (packed on this rank's device, the
    gathered carry [N_sh, W_CARRY (+ PT)] words, the [P,D] carry words
    or None, stats)."""
    dev = mesh.device
    lo, _ = mesh.block(n_sh)
    t0 = time.perf_counter()
    rank = make_rank(_tensors(block_np, dev), _tensors(rep_np, dev), statics,
                     lo, n_sh, check)
    mesh.reset_stats()
    rounds, retries, stranded = drive(
        [rank], lambda xs: [mesh.all_gather(xs[0])], statics["max_rounds"],
        statics["gang_enabled"])
    packed, carry, affw = rank.result(rounds, retries, stranded)
    carry_all = mesh.all_gather(carry.contiguous()).reshape(
        n_sh, carry.shape[1])
    return packed, carry_all, affw, _rank_stats(mesh, rank, t0, rounds,
                                                retries, stranded)


def solve_hier_rank(mesh, block_np, rep_np, statics, n_sh: int,
                    check: bool = False):
    """This rank's part of the two-level solve over ``mesh`` (as
    :func:`solve_rank`; ``statics`` carries ``pool_size`` and
    ``max_waves``). Returns (packed, gathered carry, None, stats)."""
    dev = mesh.device
    lo, _ = mesh.block(n_sh)
    t0 = time.perf_counter()
    rank = make_hier_rank(_tensors(block_np, dev), _tensors(rep_np, dev),
                          statics, lo, n_sh, statics["pool_size"], check)
    mesh.reset_stats()
    rounds, retries, stranded = drive_hier(
        [rank], lambda xs: [mesh.all_gather(xs[0])], statics["max_rounds"],
        statics["max_waves"], statics["gang_enabled"])
    packed, carry, _ = rank.result(rounds, retries, stranded)
    carry_all = mesh.all_gather(carry.contiguous()).reshape(
        n_sh, carry.shape[1])
    return packed, carry_all, None, _rank_stats(mesh, rank, t0, rounds,
                                                retries, stranded)


def _lockstep(ranks, run):
    def gather(xs):
        g = torch.stack([x.contiguous() for x in xs])
        return [g] * len(xs)

    rounds, retries, stranded = run(gather)
    outs = [r.result(rounds, retries, stranded) for r in ranks]
    bad = [m for r in ranks for m in getattr(r, "mismatches", ())]
    if bad:
        raise AssertionError("; ".join(bad[:4]))
    for o in outs[1:]:
        if not torch.equal(o[0], outs[0][0]):
            raise AssertionError("sharded solve: ranks' results differ")
        if o[2] is not None and not torch.equal(o[2], outs[0][2]):
            raise AssertionError("sharded solve: ranks' [P,D] carries "
                                 "differ")
    return outs[0][0], torch.cat([o[1] for o in outs]), outs[0][2]


def solve_lockstep(node_np, rep_np, statics, n_sh: int, world: int, device,
                   check: bool = False):
    """The sharded solve with ``world`` ranks in this process, in lock
    step, without a process group (each step's payloads concatenated).
    Returns (packed, carry [N_sh, W_CARRY (+ PT)] words, the ranks); with
    the affinity vocabulary ``last_solve["aff"]`` holds the final [P,D]
    carry and port claims."""
    dev = torch.device(device)
    nb = n_sh // world
    rep = _tensors(rep_np, dev)
    ranks = [make_rank(_tensors(b, dev), rep, statics, r * nb, n_sh, check)
             for r, b in enumerate(split_blocks(node_np, world, n_sh))]
    packed, carry, affw = _lockstep(ranks, lambda gather: drive(
        ranks, gather, statics["max_rounds"], statics["gang_enabled"]))
    last_solve.clear()
    if affw is not None:
        last_solve["aff"] = _aff_result(affw, rep_np, carry)
    return packed, carry, ranks


def solve_hier_lockstep(node_np, rep_np, statics, n_sh: int, world: int,
                        device, check: bool = False):
    """The two-level solve over ``world`` ranks in this process, in lock
    step (as :func:`solve_lockstep`). Returns (packed, carry, ranks)."""
    dev = torch.device(device)
    nb = n_sh // world
    rep = _tensors(rep_np, dev)
    ranks = [make_hier_rank(_tensors(b, dev), rep, statics, r * nb, n_sh,
                            statics["pool_size"], check)
             for r, b in enumerate(split_blocks(node_np, world, n_sh))]
    packed, carry, _ = _lockstep(ranks, lambda gather: drive_hier(
        ranks, gather, statics["max_rounds"], statics["max_waves"],
        statics["gang_enabled"]))
    return packed, carry, ranks


#: stats of the last solve_batched_sharded / solve_hier_sharded on rank
#: 0: per rank (rank order) rounds, collectives, stages, collective ms,
#: launches and kernel device ms by step (and the two-level solve's work
#: counts); the solve's host wall; with the affinity vocabulary the final
#: [P,D] carry and port claims (numpy)
last_solve: Dict[str, object] = {}


def run_sharded(mesh, device, inputs, op: str, statics_extra=None,
                max_rounds: int = 0, check: bool = False,
                span: str = "batched_allocate_sharded"):
    """Rank 0's side of a solve over ``mesh`` (the other ranks serve:
    parallel/worker.py): the inputs staged, each rank sent its block,
    this rank's part solved, the replies gathered, the packed result read
    back, the gathered node carry trimmed to the one-card bucket and
    written back to the DeviceSession. ``op``: "batched" or "hier".
    Returns (task_state, task_node, task_seq, rounds, telemetry)."""
    from .. import obs
    from ..device import to_host

    if mesh.rank != 0:
        raise ValueError(f"the sharded {op} solve runs on rank 0; the other "
                         f"ranks serve (parallel.worker.serve)")
    if mesh.device.type != device.device.type:
        # the ranks solve on the mesh's device: a CPU mesh under a card's
        # session would run the plain ranks on the host in hiding
        raise ValueError(f"the sharded {op} solve: the mesh's ranks are on "
                         f"{mesh.device}, the session's node carry on "
                         f"{device.device}")
    t_pad = int(inputs.task_valid.shape[0])
    n_pad = int(device.n_padded)
    t0 = time.perf_counter()
    node, rep, statics, n_sh = prepare_sharded(mesh.world, device, inputs,
                                               max_rounds)
    statics.update(statics_extra(n_sh) if statics_extra else {})
    blocks = split_blocks(node, mesh.world, n_sh)
    solve = solve_hier_rank if op == "hier" else solve_rank
    with obs.span(span, cat="kernel") as sp:
        mesh.send_objects({"op": op, "rep": rep, "statics": statics,
                           "n_sh": n_sh, "check": check}, blocks)
        packed, carry, affw, stats = solve(mesh, blocks[0], rep, statics,
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
                      statics=statics,
                      wall_ms=(time.perf_counter() - t0) * 1e3)
    if affw is not None:
        last_solve["aff"] = _aff_result(affw, rep, carry)
        last_solve["vocabulary"] = {
            "pairs": int(rep["node_dom"].shape[0]),
            "domains": int(rep["aff_grp_cnt0"].shape[1]),
            "ports": int(node["port_base"].shape[1]) if "port_base" in node
            else 0, "ip": IP_ARG in rep,
            "node_dom_bytes": int(rep["node_dom"].nbytes)}
    bad = [m for r in replies for m in r.get("mismatches", ())]
    if bad:
        raise AssertionError("; ".join(bad[:4]))
    return (host[:t_pad], host[t_pad:2 * t_pad],
            host[2 * t_pad:3 * t_pad], int(host[3 * t_pad]),
            host[3 * t_pad + 1:])


def solve_batched_sharded(mesh, device, inputs, max_rounds: int = 0,
                          check: bool = False):
    """Sharded twin of kernels/batched.solve_batched on rank 0 of
    ``mesh`` (the other ranks serve: parallel/worker.py): same
    CycleInputs in, the inter-pod affinity / host-port vocabulary
    included, (task_state, task_node, task_seq, rounds, telemetry) numpy
    out. ``device`` is the session's DeviceSession: its node carry goes
    out in one counted copy and the final carry, gathered from every rank
    and trimmed to the one-card bucket, is written back. Readbacks as the
    reference counts them: the packed result (1) and the carry's four
    arrays (4), plus the node block's stage, one per round (the progress
    flag) and the epilogue's flags, and every stage of a host-staged
    collective. ``check``: every rank holds each launch against the plain
    version (:class:`CheckedRank`). The mesh's device and the session's
    must be of one type (ValueError otherwise)."""
    return run_sharded(mesh, device, inputs, "batched",
                       max_rounds=max_rounds, check=check)
