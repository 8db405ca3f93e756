"""Batched allocate — the round engine: many placements per round.

The fused solve (kernels/fused.py) places one task per loop iteration; a
10,000-task cold cycle is 10,000+ dependent steps. This engine places as
many tasks per **round** as capacity allows, in parallel, and only the
capacity conflicts spill to the next round; a cold cycle resolves in a
handful of rounds. Round structure (reference package,
kubebatch_tpu/kernels/batched.py, whose docstring states the
faithfulness contract):

1. order — queue shares, DRF job shares and gang readiness from the
   committed state, composed into the configured lexicographic job order
   and flattened into a global task rank; a demand window and per-queue
   budgets admit the best-ranked jobs only;
2. eligibility — per (task, node) predicate + count room + fit against
   round-start capacity; a participating task with no eligible node
   fails and kills its job's later-ranked tasks;
3. proposals — one shared waterfall over nodes in the majority cohort's
   score order; a task whose waterfall slot is not eligible for it takes
   its masked argmax;
4. acceptance — per node, proposers in global-rank order while the
   cumulative requests fit; then one retry phase against the mid-round
   carry;
5. commit — capacity, shares and gang counters.

After the rounds a stranded-gang epilogue rolls back partial gangs,
revives them for up to three more passes, then retires what is left.

Two implementations of one function, chosen by the tensors' device:

- :func:`batched_allocate_plain` — plain PyTorch on CPU tensors, in the
  reference's order of float operations (kernels/xla_order.py; segment
  sums are ``index_add_``, sequential in update order on the CPU). The
  rounds loop in Python. The CPU path, and the yardstick for the kernel.
- the CUDA kernel ``csrc/batched_allocate.cu`` — one cooperative grid
  runs every round, the compact branch and the epilogue on the card.

:func:`batched_allocate` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
Both return ``(packed, idle, releasing, n_tasks, nz_req)``: packed is the
reference's int32 ``[3*T + 1 + TELEM_WIDTH]`` (task_state, task_node,
task_seq, the round count, the telemetry frame) and the rest is the final
node carry.

Inter-pod affinity and host ports (kernels/affinity.py) ride the rounds
when the cycle carries them (the ``aff`` argument): a [P,D] per-(pair,
domain) carry of group members, anti carriers and preferred weights, the
cluster-wide group totals and a per-node port-claim matrix. Each round
adds the affinity predicates to eligibility (with the wait rule for
positive terms a same-cycle placement can still satisfy), adds the
interpod score to the argmax of the tasks it scores (they leave the
shared waterfall), serializes phase-1 acceptances per (pair, domain) and
per node for ports, keeps involved tasks out of the retry, and commits
the carry; the stranded-gang rollback subtracts it. With ``aff`` the
result gains a sixth element, the final affinity carry.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build
from .fused import (ALLOC, ALLOC_OB, FAIL, JOB_KEY_CODES, K_DRF_SHARE,
                    K_GANG_READY, K_PRIORITY, K_PROP_SHARE, PIPELINE, SKIP,
                    _share)
from .solver import dynamic_node_score_plain, scan_node_score_plain
from .telemetry import ENGINE_BATCHED, TELEM_WIDTH, decision_frame
from .tensorize import VEC_EPS
from .xla_order import associative_scan, column_sum, search_left, \
    tiled_cumsum

_IMAX = int(np.iinfo(np.int32).max)
_IMIN = int(np.iinfo(np.int32).min)

#: demand-window fraction (reference: batched.py _WINDOW_SLACK)
_WINDOW_SLACK = 0.85

#: task rows per chunk of the plain row pass, and pairs per chunk of the
#: plain pair scores (bound their [rows, N] memory)
_ROW_CHUNK = 1024
_PAIR_CHUNK = 64

#: node-axis arrays (DeviceSession names), then the cycle arrays, in the
#: order batched_allocate takes them
NODE_ARGS = ("idle", "releasing", "n_tasks", "nz_req", "backfilled",
             "allocatable_cm", "max_task_num", "node_ok")
CYCLE_ARGS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
              "task_sig", "task_pair", "task_valid", "sig_scores",
              "sig_pred", "pair_sig", "pair_nz", "order_min_available",
              "init_allocated", "job_queue", "job_priority",
              "job_create_rank", "job_valid", "q_deserved", "q_create_rank",
              "q_alloc0", "j_alloc0", "cluster_total", "dyn_weights")

#: the affinity arguments (the reference's packed-layout names), in the
#: order the kernel takes them; the port pair and the interpod weight are
#: present only when the cycle has ports / an interpod score
AFF_ARGS = ("node_dom", "task_grp", "task_req_aff", "task_req_anti",
            "task_self_ok", "task_carry_w", "task_pref_w", "aff_grp_cnt0",
            "aff_anti_cnt0", "aff_pref_w0", "aff_grp_total0")
PORT_ARGS = ("task_ports", "port_base")
IP_ARG = "aff_ip_weight"
#: names of the final affinity carry (the sixth result)
AFF_OUT = ("aff_grp_cnt", "aff_anti_cnt", "aff_pref_w", "aff_grp_total",
           "port_claim")

_BOOL_ARGS = {"node_ok", "task_valid", "sig_pred", "job_valid", "task_grp",
              "task_req_aff", "task_req_anti", "task_self_ok", "task_ports",
              "port_base"}
_I32_ARGS = {"n_tasks", "max_task_num", "task_job", "task_rank", "task_sig",
             "task_pair", "pair_sig", "order_min_available", "init_allocated",
             "job_queue", "job_create_rank", "q_create_rank", "node_dom"}


def arg_dtype(name: str) -> torch.dtype:
    """The dtype batched_allocate takes for argument ``name``."""
    return (torch.bool if name in _BOOL_ARGS
            else torch.int32 if name in _I32_ARGS else torch.float32)


class RoundState(NamedTuple):
    """Carry across rounds."""
    idle: torch.Tensor         # [N,R]
    releasing: torch.Tensor    # [N,R]
    n_tasks: torch.Tensor      # [N]
    nz_req: torch.Tensor       # [N,2]
    q_allocated: torch.Tensor  # [Q,R]
    j_allocated: torch.Tensor  # [J,R]
    alloc_cnt: torch.Tensor    # [J] allocated-family count (readiness)
    job_alive: torch.Tensor    # [J] bool — not yet dropped on failure
    task_state: torch.Tensor   # [T] SKIP while pending
    task_node: torch.Tensor    # [T]
    task_seq: torch.Tensor     # [T] round * T_pad + in-round rank
    # --- inter-pod affinity / host-port carry; None without the features
    aff_grp_cnt: Optional[torch.Tensor] = None    # [P,D] group members
    aff_anti_cnt: Optional[torch.Tensor] = None   # [P,D] req-anti carriers
    aff_pref_w: Optional[torch.Tensor] = None     # [P,D] preferred weight
    aff_grp_total: Optional[torch.Tensor] = None  # [P] cluster-wide members
    port_claim: Optional[torch.Tensor] = None     # [N,PT] bool (this cycle)


class CycleArrays(NamedTuple):
    """Arrays static across rounds."""
    backfilled: torch.Tensor       # [N,R]
    allocatable_cm: torch.Tensor   # [N,2]
    max_task_num: torch.Tensor     # [N]
    node_ok: torch.Tensor          # [N]
    resreq: torch.Tensor           # [T,R]
    init_resreq: torch.Tensor      # [T,R]
    task_nz: torch.Tensor          # [T,2]
    task_job: torch.Tensor         # [T]
    task_rank: torch.Tensor        # [T]
    task_sig: torch.Tensor         # [T] (predicate rows)
    task_pair: torch.Tensor        # [T] (scoring / waterfall cohorts)
    task_valid: torch.Tensor       # [T]
    sig_scores: torch.Tensor       # [S,N]
    sig_pred: torch.Tensor         # [S,N]
    pair_sig: torch.Tensor         # [P]
    pair_nz: torch.Tensor          # [P,2]
    order_min_available: torch.Tensor  # [J]
    job_queue: torch.Tensor        # [J]
    job_priority: torch.Tensor     # [J]
    job_create_rank: torch.Tensor  # [J]
    job_valid: torch.Tensor        # [J]
    q_deserved: torch.Tensor       # [Q,R]
    q_create_rank: torch.Tensor    # [Q]
    cluster_total: torch.Tensor    # [R]
    dyn_weights: torch.Tensor      # [2]
    # --- static affinity / port vocabulary; None without the features ---
    node_dom: Optional[torch.Tensor] = None       # [P,N] int32, -1 = none
    task_grp: Optional[torch.Tensor] = None       # [T,P] bool
    task_req_aff: Optional[torch.Tensor] = None   # [T,P] bool
    task_req_anti: Optional[torch.Tensor] = None  # [T,P] bool
    task_self_ok: Optional[torch.Tensor] = None   # [T,P] bool
    task_carry_w: Optional[torch.Tensor] = None   # [T,P] f32
    task_pref_w: Optional[torch.Tensor] = None    # [T,P] f32
    task_ports: Optional[torch.Tensor] = None     # [T,PT] bool
    port_base: Optional[torch.Tensor] = None      # [N,PT] bool
    ip_weight: Optional[torch.Tensor] = None      # [] f32 (pod_aff weight)


#: task-axis fields of CycleArrays (gathered for the compact continuation)
_TASK_FIELDS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
                "task_sig", "task_pair", "task_valid")
#: affinity task-axis fields, gathered only when the cycle carries them
_AFF_TASK_FIELDS = ("task_grp", "task_req_aff", "task_req_anti",
                    "task_self_ok", "task_carry_w", "task_pref_w",
                    "task_ports")


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _segsum(vals: torch.Tensor, seg: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.ops.segment_sum``: sequential in update order (CPU)."""
    out = vals.new_zeros((num,) + tuple(vals.shape[1:]))
    return out.index_add_(0, seg.to(torch.int64), vals)


def _add_segsum(base: torch.Tensor, vals: torch.Tensor,
                seg: torch.Tensor) -> torch.Tensor:
    """``base + jax.ops.segment_sum(vals, seg)``. XLA folds the addition
    into the scatter, so each update adds onto ``base`` in turn (whereas
    ``base - segment_sum`` sums first, then subtracts)."""
    return base.clone().index_add_(0, seg.to(torch.int64), vals)


def _lexsort(keys) -> torch.Tensor:
    """``jnp.lexsort``: stable sorts from the first (least significant)
    key to the last (primary). Float keys are canonicalised (-0.0 sorts
    equal to +0.0, ``+ 0.0`` folds it) as JAX's sort comparator does."""
    order = None
    for k in keys:
        if k.dtype.is_floating_point:
            k = k + 0.0
        kk = k if order is None else k[order]
        idx = torch.sort(kk, stable=True).indices
        order = idx if order is None else order[idx]
    return order


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm, dtype=torch.int32)
    inv[perm] = torch.arange(perm.shape[0], dtype=torch.int32)
    return inv


def _segmented_prefix(values: torch.Tensor, starts: torch.Tensor
                      ) -> torch.Tensor:
    """Exclusive prefix sums within segments of a sorted array (reference
    ``_segmented_prefix``: an associative scan that restarts at each
    segment head)."""
    flag = torch.arange(values.shape[0]) == starts
    if values.dim() == 2:
        flag = flag[:, None].expand_as(values)

    def comb(a, b):
        sa, fa = a
        sb, fb = b
        return [torch.where(fb, sb, sa + sb), fa | fb]

    sums, _ = associative_scan(comb, [values, flag])
    return sums - values


def _eligibility(idle, releasing, n_tasks, a: CycleArrays, pipe_enabled: bool,
                 eps, init, sig) -> torch.Tensor:
    """[len(init), N] predicate + capacity eligibility of request rows
    ``init`` [k,R] with predicate rows ``sig`` [k]."""
    accessible = idle + a.backfilled
    base = a.node_ok & (n_tasks < a.max_task_num)
    fit = (init[:, None, :] <= (accessible + eps)[None]).all(dim=-1)
    if pipe_enabled:
        fit = fit | (init[:, None, :] <= (releasing + eps)[None]).all(dim=-1)
    return a.sig_pred[sig.long()] & base[None, :] & fit


def resource_eligibility(idle, releasing, n_tasks, a: CycleArrays,
                         pipe_enabled: bool, eps, rows) -> torch.Tensor:
    """[len(rows), N] predicate + capacity eligibility of task ``rows``
    (reference ``resource_eligibility``, without affinity terms)."""
    return _eligibility(idle, releasing, n_tasks, a, pipe_enabled, eps,
                        a.init_resreq[rows], a.task_sig[rows])


def _distinct_rows(a: CycleArrays, rows, pair_init=None):
    """Group task ``rows`` by what their eligibility and score row read:
    (predicate row, request, pair) — or, with ``pair_init`` (the
    active-set engine's exact-pair fold), the pair alone. Returns
    (inverse [len(rows)] into the groups, the groups' request rows
    [U,R], predicate rows [U] and pairs [U])."""
    pairs = a.task_pair[rows]
    if pair_init is not None:
        uniq, inv = torch.unique(pairs, return_inverse=True)
        return inv, pair_init[uniq.long()], a.pair_sig[uniq.long()], uniq
    key = torch.cat([a.task_sig[rows, None].to(torch.float64),
                     pairs[:, None].to(torch.float64),
                     a.init_resreq[rows].to(torch.float64)], dim=1)
    uniq, inv = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((uniq.shape[0],), rows.shape[0], dtype=torch.int64)
    first.scatter_reduce_(0, inv, torch.arange(rows.shape[0]), "amin")
    rep = rows[first]
    return inv, a.init_resreq[rep], a.task_sig[rep], pairs[first]


def _row_pass(idle, releasing, n_tasks, a, pipe_enabled, eps, sc, mask,
              aff=None, pair_init=None):
    """For every task with ``mask``: any eligible node, and the masked
    argmax of its score row over the eligible nodes (lowest index on
    ties; node 0 when none is eligible). The score row is its pair's;
    with ``aff`` (an :class:`_AffRound`) eligibility also takes the
    affinity predicates and, with an interpod score, the row adds its
    term. Returns (any_elig, best, ip_scored). Without affinity, rows
    that read the same predicate row, request and pair are identical,
    so each distinct one is evaluated once (with ``pair_init``: once a
    pair, from its representative request); with it, in chunks of task
    rows. The kernel does one task row per warp."""
    t_pad = mask.shape[0]
    any_elig = torch.zeros(t_pad, dtype=torch.bool)
    best = torch.zeros(t_pad, dtype=torch.int32)
    scored = torch.zeros(t_pad, dtype=torch.bool)
    rows_all = torch.nonzero(mask).flatten()
    if aff is None:
        if rows_all.numel() == 0:
            return any_elig, best, scored
        inv, init, sig, pairs = _distinct_rows(a, rows_all, pair_init)
        g_any = torch.zeros(init.shape[0], dtype=torch.bool)
        g_best = torch.zeros(init.shape[0], dtype=torch.int32)
        for c in range(0, init.shape[0], _ROW_CHUNK):
            sl = slice(c, c + _ROW_CHUNK)
            elig = _eligibility(idle, releasing, n_tasks, a, pipe_enabled,
                                eps, init[sl], sig[sl])
            g_any[sl] = elig.any(dim=1)
            masked = torch.where(elig, sc[pairs[sl].long()], -torch.inf)
            g_best[sl] = masked.argmax(dim=1).to(torch.int32)
        any_elig[rows_all] = g_any[inv]
        best[rows_all] = g_best[inv]
        return any_elig, best, scored
    for c in range(0, rows_all.shape[0], _ROW_CHUNK):
        rows = rows_all[c:c + _ROW_CHUNK]
        elig = resource_eligibility(idle, releasing, n_tasks, a,
                                    pipe_enabled, eps, rows)
        sc_rows = sc[a.task_pair[rows].long()]
        elig = elig & aff.ok_rows(rows)
        if aff.ip:
            term, scored[rows] = aff.ip_rows(rows)
            sc_rows = sc_rows + term
        any_elig[rows] = elig.any(dim=1)
        masked = torch.where(elig, sc_rows, -torch.inf)
        best[rows] = masked.argmax(dim=1).to(torch.int32)
    return any_elig, best, scored


def _cell_elig(idle, releasing, n_tasks, a, pipe_enabled, eps, node):
    """Eligibility of each task at one node each ([T] gathers)."""
    n = node.long()
    acc = (idle + a.backfilled)[n]
    base = a.node_ok[n] & (n_tasks[n] < a.max_task_num[n])
    fit = (a.init_resreq <= acc + eps).all(dim=-1)
    if pipe_enabled:
        fit = fit | (a.init_resreq <= releasing[n] + eps).all(dim=-1)
    return a.sig_pred[a.task_sig.long(), n] & base & fit


# ---- inter-pod affinity / host ports (vocabulary: kernels/affinity.py) ----

def _f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _aff_gather(state: RoundState, a: CycleArrays):
    """Per-(pair, node) views of the domain-count carry: the domain
    validity mask, the clipped domain, group-member and anti-carrier
    counts (reference ``_aff_gather``)."""
    d_cap = state.aff_grp_cnt.shape[1]
    has_dom = a.node_dom >= 0
    domc = a.node_dom.clamp(0, d_cap - 1).long()
    gcnt = torch.gather(state.aff_grp_cnt, 1, domc)
    acnt = torch.gather(state.aff_anti_cnt, 1, domc)
    return has_dom, domc, gcnt, acnt


class _AffRound:
    """The affinity predicates and the interpod score of one round,
    against the round-start carry (reference ``_aff_eligibility`` and
    ``_ip_score``), evaluated for chunks of task rows. The reference's
    [T,P] x [P,N] boolean products count ones and compare with 0.5;
    here they are float products of 0/1 values too, exact in any order.
    The score's products and sums are of integer-valued floats far below
    2**24, so they are exact in any order as well."""

    def __init__(self, state: RoundState, a: CycleArrays):
        self.a = a
        has_dom, domc, gcnt, acnt = _aff_gather(state, a)
        present = has_dom & (gcnt > 0)                       # [P,N]
        boot = (state.aff_grp_total <= 0)[None, :] & a.task_self_ok
        self.need = _f(a.task_req_aff & ~boot)               # [T,P]
        self.not_present = _f(~present)
        self.present = _f(present)
        self.sym = _f(has_dom & (acnt > 0))
        self.used = None
        if a.task_ports is not None:
            self.used = _f(a.port_base | state.port_claim).T   # [PT,N]
        # positive terms unsatisfiable anywhere whose group has other
        # still-pending members: the task waits instead of failing
        pending_members = ((a.task_valid & (state.task_state == SKIP))
                           [:, None] & a.task_grp)           # [T,P]
        grp_pending = pending_members.to(torch.int32).sum(dim=0)
        others_pending = (grp_pending[None, :] - _f(pending_members)) > 0.5
        pair_unsat = ~present.any(dim=1)                     # [P]
        self.could_wait = (a.task_req_aff & ~boot & others_pending
                           & pair_unsat[None, :]).any(dim=1)  # [T]
        self.ip = a.ip_weight is not None
        if self.ip:
            prefw = torch.gather(state.aff_pref_w, 1, domc)
            zero = _f32(0.0)
            self.gview = torch.where(has_dom, gcnt, zero)
            self.pview = torch.where(has_dom, prefw, zero)

    def ok_rows(self, rows) -> torch.Tensor:
        """[len(rows), N]: the affinity and host-port predicates."""
        a = self.a
        ok = ((self.need[rows] @ self.not_present) < 0.5) \
            & ((_f(a.task_req_anti[rows]) @ self.present) < 0.5) \
            & ((_f(a.task_grp[rows]) @ self.sym) < 0.5)
        if self.used is not None:
            ok = ok & ((_f(a.task_ports[rows]) @ self.used) < 0.5)
        return ok

    def ip_rows(self, rows):
        """([len(rows), N] interpod term, [len(rows)] scored): own
        preferred terms weigh the group's domain counts, the symmetric
        half the carried preferred weights; normalised over the real
        nodes as the host does (floor(10 * (c - cmin) / (cmax - cmin))
        times the pod_aff weight)."""
        a = self.a
        counts = a.task_pref_w[rows] @ self.gview \
            + _f(a.task_grp[rows]) @ self.pview
        valid = a.node_ok[None, :]
        cmin = torch.where(valid, counts, torch.inf).amin(dim=1,
                                                         keepdim=True)
        cmax = torch.where(valid, counts, -torch.inf).amax(dim=1,
                                                          keepdim=True)
        span = cmax - cmin
        pos = span > 0
        term = torch.where(pos, torch.floor(
            10.0 * (counts - cmin) / torch.where(pos, span, _f32(1.0))),
            _f32(0.0)) * a.ip_weight
        return torch.where(valid, term, _f32(0.0)), (term != 0.0).any(dim=1)

    def cell_ok(self, node) -> torch.Tensor:
        """[T]: the predicates of each task at one node each."""
        a = self.a
        n = node.long()
        ok = ~((self.need > 0) & (self.not_present[:, n].T > 0)).any(dim=1) \
            & ~(a.task_req_anti & (self.present[:, n].T > 0)).any(dim=1) \
            & ~(a.task_grp & (self.sym[:, n].T > 0)).any(dim=1)
        if self.used is not None:
            ok = ok & ~(a.task_ports & (self.used[:, n].T > 0)).any(dim=1)
        return ok


def _ip_stats(stats: dict, state: RoundState, a: CycleArrays, *masks):
    """Counts the row passes' rows that can carry an interpod term (a
    preferred term of their own, or a group bit of a pair with carried
    preferred weight: the kernel scores only those) in ``ip_rows``, and
    their preferred terms and group bits in ``ip_terms`` (a preferred
    term weighs twice: multiply and add)."""
    pref_any = (state.aff_pref_w != 0).any(dim=1)                # [P]
    pref = a.task_pref_w != 0
    grp = a.task_grp & pref_any[None, :]
    can = pref.any(dim=1) | grp.any(dim=1)
    terms = 2 * pref.sum(dim=1) + a.task_grp.sum(dim=1)
    for m in masks:
        rows = m & can
        stats["ip_rows"] = stats.get("ip_rows", 0) + int(rows.sum())
        stats["ip_terms"] = stats.get("ip_terms", 0) + int(terms[rows].sum())


def _aff_serialize(state: RoundState, a: CycleArrays, accept, proposal,
                   global_rank):
    """In-round hazard removal (reference ``_aff_serialize``): the
    accepted subset whose co-placement is sequentially legal. Per
    (pair, domain) an accepted anti carrier keeps alone if it ranks
    first, else the plain members keep; per bootstrapping pair the
    best-ranked bootstrapper fixes the domain; per node one port
    claimant."""
    d_cap = state.aff_grp_cnt.shape[1]
    p_cnt = a.node_dom.shape[0]
    imax = torch.tensor(_IMAX, dtype=torch.int32)
    rank = global_rank[None, :]                              # [1,T]
    dom_prop = a.node_dom[:, proposal.long()]                # [P,T]
    has = dom_prop >= 0
    seg = torch.where(has, dom_prop, torch.tensor(d_cap, dtype=torch.int32))
    flat = (torch.arange(p_cnt)[:, None] * (d_cap + 1) + seg).flatten()
    carrier = a.task_req_anti.T
    member = a.task_grp.T
    req = a.task_req_aff.T
    acc_car = accept[None, :] & carrier & has
    acc_mem = accept[None, :] & member & ~carrier & has

    def seg_min(mask):
        out = torch.full((p_cnt * (d_cap + 1),), _IMAX, dtype=torch.int32)
        out.scatter_reduce_(0, flat, torch.where(mask, rank, imax).flatten(),
                            "amin")
        return out[flat].view(seg.shape)

    cmin_t = seg_min(acc_car)
    mmin_t = seg_min(acc_mem)
    has_car = cmin_t < _IMAX
    keep_car = (rank == cmin_t) & (cmin_t < mmin_t)
    keep_mem = ~has_car | (mmin_t < cmin_t)
    keep = torch.where(carrier, keep_car,
                       torch.where(member, keep_mem, torch.ones_like(has)))
    acc_req = accept[None, :] & req
    bmin = torch.where(acc_req, rank, imax).amin(dim=1, keepdim=True)
    bdom = torch.where(acc_req & (rank == bmin), seg,
                       torch.tensor(-1, dtype=torch.int32)).amax(
        dim=1, keepdim=True)
    boot_active = (state.aff_grp_total <= 0)[:, None]
    keep_boot = torch.where(boot_active & req,
                            (rank == bmin) | ((seg == bdom) & (bdom < d_cap)),
                            torch.ones_like(has))
    keep = (keep & keep_boot).all(dim=0)
    if a.task_ports is not None:
        n_pad = a.node_ok.shape[0]
        claim = accept & a.task_ports.any(dim=1)
        node_seg = torch.where(claim, proposal,
                               torch.tensor(n_pad, dtype=torch.int32)).long()
        pmin = torch.full((n_pad + 1,), _IMAX, dtype=torch.int32)
        pmin.scatter_reduce_(0, node_seg, torch.where(claim, global_rank,
                                                      imax), "amin")
        keep = keep & (~a.task_ports.any(dim=1)
                       | (global_rank == pmin[node_seg]))
    return accept & keep


def _aff_involved(state: RoundState, a: CycleArrays) -> torch.Tensor:
    """[T] tasks kept out of the same-round retry (reference
    ``_aff_involved``): anti carriers, members of pairs with a carrier
    (pending or placed), bootstrap-reliant tasks and port claimers."""
    pair_has_carrier = ((a.task_req_anti & a.task_valid[:, None]).any(dim=0)
                        | (state.aff_anti_cnt > 0).any(dim=1))
    boot_active = state.aff_grp_total <= 0
    inv = (a.task_req_anti.any(dim=1)
           | (a.task_grp & pair_has_carrier[None, :]).any(dim=1)
           | (a.task_req_aff & boot_active[None, :]).any(dim=1))
    if a.task_ports is not None:
        inv = inv | a.task_ports.any(dim=1)
    return inv


def _aff_delta(a: CycleArrays, mask, nodes, d_cap: int):
    """Per-(pair, domain) sums of this round's placements (or reversals)
    of the tasks ``mask`` at their ``nodes`` (reference ``_aff_delta``).
    The values are integer-valued floats far below 2**24 (counts and
    k8s's integer weights), so every order of addition is exact."""
    p_cnt = a.node_dom.shape[0]
    dom = a.node_dom[:, nodes.long()]                        # [P,T]
    seg = torch.where(mask[None, :] & (dom >= 0), dom,
                      torch.tensor(d_cap, dtype=torch.int32))
    flat = (torch.arange(p_cnt)[:, None] * (d_cap + 1) + seg).flatten()
    mf = _f(mask)[:, None]

    def scat(vals):                                          # [T,P]
        out = torch.zeros(p_cnt * (d_cap + 1), dtype=torch.float32)
        out.index_add_(0, flat, vals.T.flatten())
        return out.view(p_cnt, d_cap + 1)[:, :d_cap]

    grp = _f(a.task_grp) * mf
    return (scat(grp), scat(_f(a.task_req_anti) * mf),
            scat(a.task_carry_w * mf), grp.sum(dim=0))


def _port_bits(a: CycleArrays, mask, nodes) -> torch.Tensor:
    """[N,PT]: the OR of the ports of tasks ``mask`` at their nodes."""
    n_pad = a.node_ok.shape[0]
    idx = torch.where(mask, nodes, torch.tensor(n_pad - 1,
                                                dtype=torch.int32)).long()
    bits = torch.zeros(a.port_base.shape, dtype=torch.int32)
    bits.index_add_(0, idx, (a.task_ports & mask[:, None]).to(torch.int32))
    return bits > 0


def _aff_commit(state: RoundState, a: CycleArrays, accept, proposal):
    d_cap = state.aff_grp_cnt.shape[1]
    d_grp, d_anti, d_pref, d_total = _aff_delta(a, accept, proposal, d_cap)
    upd = dict(aff_grp_cnt=state.aff_grp_cnt + d_grp,
               aff_anti_cnt=state.aff_anti_cnt + d_anti,
               aff_pref_w=state.aff_pref_w + d_pref,
               aff_grp_total=state.aff_grp_total + d_total)
    if a.task_ports is not None:
        upd["port_claim"] = state.port_claim | _port_bits(a, accept,
                                                          proposal)
    return upd


def _aff_rollback(state: RoundState, a: CycleArrays, revert):
    """Exact inverse of _aff_commit for the stranded-gang rollback; port
    claims are exclusive among the cycle's placements, so clearing the
    reverted tasks' bits is exact."""
    d_cap = state.aff_grp_cnt.shape[1]
    nodes = state.task_node.clamp(min=0)
    d_grp, d_anti, d_pref, d_total = _aff_delta(a, revert, nodes, d_cap)
    upd = dict(aff_grp_cnt=state.aff_grp_cnt - d_grp,
               aff_anti_cnt=state.aff_anti_cnt - d_anti,
               aff_pref_w=state.aff_pref_w - d_pref,
               aff_grp_total=state.aff_grp_total - d_total)
    if a.task_ports is not None:
        upd["port_claim"] = state.port_claim & ~_port_bits(a, revert, nodes)
    return upd


def _pair_scores(state, a, dyn_enabled, weighted_fma: bool = False):
    """[P,N] float32 pair scores: static sig score + the dynamic
    nodeorder term evaluated with the pair's own request (its weighted
    sum one FMA with ``weighted_fma``: xla_order.WEIGHTED_SUM_FMA)."""
    sc = a.sig_scores[a.pair_sig.long()]
    dyn = torch.zeros_like(sc)
    score = scan_node_score_plain if weighted_fma \
        else dynamic_node_score_plain
    if dyn_enabled:
        for p in range(0, sc.shape[0], _PAIR_CHUNK):
            dyn[p:p + _PAIR_CHUNK] = score(
                state.nz_req, a.pair_nz[p:p + _PAIR_CHUNK],
                a.allocatable_cm, a.dyn_weights)
    return sc + dyn


def _round(state: RoundState, a: CycleArrays, round_idx: int,
           job_keys, queue_keys, prop_overused: bool, dyn_enabled: bool,
           pipe_enabled: bool, seq_stride: int, stats=None,
           elig_elsewhere=None, pair_init=None, weighted_fma: bool = False):
    """One allocation round (reference ``_round``). Returns (new_state,
    progress). ``stats`` (a dict), when given, counts the round and the
    task rows of its two row passes.

    The two-level solves (kernels/hier.py, kernels/activeset.py) run the
    round on one node pool: ``state`` and ``a`` are then sliced to the
    pool's nodes (the node window) and ``elig_elsewhere`` ([T] bool)
    marks tasks eligible in another pool, which wait instead of failing
    when the pool has no node for them. ``pair_init`` ([P,R]): the
    active-set engine's exact-pair fold; every valid task's request row
    equals its pair's (checked on the host), so eligibility and the
    argmax are evaluated once a pair. ``weighted_fma``: the graph's
    evaluation of the dynamic score's weighted sum
    (xla_order.WEIGHTED_SUM_FMA)."""
    f32, i32 = torch.float32, torch.int32
    eps = torch.from_numpy(VEC_EPS)
    t_pad = a.task_valid.shape[0]
    n_pad = a.node_ok.shape[0]
    j_pad = a.job_valid.shape[0]
    q_pad = a.q_deserved.shape[0]
    tj = a.task_job.long()                   # -1 wraps to J-1, as in jnp
    tj0 = a.task_job.clamp(min=0).long()
    jq = a.job_queue.long()

    # ---- 1. ordering ------------------------------------------------------
    overused = torch.zeros(q_pad, dtype=torch.bool)
    if prop_overused:
        overused = (a.q_deserved < state.q_allocated + eps).all(dim=-1)
    q_share = torch.zeros(q_pad, dtype=f32)
    for k in queue_keys:
        if k == K_PROP_SHARE:
            q_share = _share(state.q_allocated, a.q_deserved)
    jkeys = []
    for k in job_keys:
        if k == K_PRIORITY:
            jkeys.append(-a.job_priority)
        elif k == K_GANG_READY:
            jkeys.append((state.alloc_cnt >= a.order_min_available).to(f32))
        elif k == K_DRF_SHARE:
            jkeys.append(_share(state.j_allocated, a.cluster_total[None, :]))
    keys = ([a.job_create_rank.to(f32)] + list(reversed(jkeys))
            + [a.q_create_rank[jq].to(f32), q_share[jq]])
    job_order = _lexsort(keys)
    job_sort_rank = _inverse(job_order)

    engaged = (a.task_valid & (state.task_state == SKIP)
               & state.job_alive[tj] & a.job_valid[tj] & ~overused[jq[tj]])

    # ---- demand window ----------------------------------------------------
    base = a.node_ok & (state.n_tasks < a.max_task_num)
    avail_pool = column_sum(torch.where(
        base[:, None], torch.maximum(state.idle + a.backfilled, _f32(0.0)),
        _f32(0.0)))
    if pipe_enabled:
        avail_pool = avail_pool + column_sum(
            torch.maximum(state.releasing, _f32(0.0)))
    job_demand = _segsum(torch.where(engaged[:, None], a.resreq, _f32(0.0)),
                         tj0, j_pad)
    eng_job = (job_demand > 0).any(dim=-1)
    norm = torch.where(avail_pool[None, :] > 0,
                       job_demand / torch.maximum(avail_pool[None, :],
                                                  _f32(1e-9)),
                       _f32(0.0)).amax(dim=-1)
    norm_ord = norm[job_order]
    slack = _f32(_WINDOW_SLACK)
    cum_excl = tiled_cumsum(norm_ord) - norm_ord
    in_window = cum_excl <= slack

    if prop_overused:
        q_remaining = torch.maximum(a.q_deserved - state.q_allocated,
                                    _f32(0.0))
        qr_job = q_remaining[jq]
        qn = torch.where(qr_job > 0,
                         job_demand / torch.maximum(qr_job, _f32(1e-9)),
                         _f32(0.0)).amax(dim=-1)
        qperm = _lexsort([job_sort_rank, a.job_queue])
        qj = a.job_queue[qperm]
        seg_start = search_left(qj, qj)
        q_prefix = _segmented_prefix(qn[qperm], seg_start)
        eng_cnt = _segmented_prefix(eng_job[qperm].to(f32), seg_start)
        first_engaged = eng_job[qperm] & (eng_cnt == 0.0)
        q_ok_perm = (q_prefix <= 1.0) | first_engaged
        q_ok = torch.zeros(j_pad, dtype=torch.bool)
        q_ok[qperm] = q_ok_perm
        norm_ord = norm_ord * q_ok[job_order].to(f32)
        cum_excl = tiled_cumsum(norm_ord) - norm_ord
        in_window = cum_excl <= slack
    else:
        q_ok = torch.ones(j_pad, dtype=torch.bool)

    admitted = torch.zeros(j_pad, dtype=torch.bool)
    admitted[job_order] = in_window
    admitted = admitted & q_ok
    participating = engaged & admitted[tj]

    # global task rank: (job order, task order); non-participants last
    jr = torch.where(participating, job_sort_rank[tj],
                     torch.tensor(_IMAX, dtype=i32))
    order = _lexsort([a.task_rank, jr])
    global_rank = _inverse(order)

    # ---- 2. exact eligibility + 3. the masked argmax (one row pass) -------
    sc = _pair_scores(state, a, dyn_enabled, weighted_fma)    # [P,N]
    aff = _AffRound(state, a) if a.node_dom is not None else None
    any_elig, fb, ip_scored = _row_pass(
        state.idle, state.releasing, state.n_tasks, a, pipe_enabled, eps, sc,
        participating, aff, pair_init)
    fail_now = participating & ~any_elig
    if aff is not None:
        # a positive-affinity task whose group a same-cycle placement can
        # still populate waits (stays SKIP) instead of killing its job
        fail_now = fail_now & ~aff.could_wait
    if elig_elsewhere is not None:
        # a pool-restricted round: eligibility in another pool means
        # waiting for a later wave, never FAIL
        fail_now = fail_now & ~elig_elsewhere
    fail_rank = torch.full((j_pad,), _IMAX, dtype=i32).scatter_reduce_(
        0, tj0, torch.where(fail_now, global_rank,
                            torch.tensor(_IMAX, dtype=i32)), "amin")
    job_killed = fail_rank < _IMAX
    fail_first = fail_now & (global_rank == fail_rank[tj])
    blocked = participating & (global_rank > fail_rank[tj])
    part2 = participating & ~fail_now & ~blocked & any_elig

    # ---- 3. proposals: the shared waterfall --------------------------------
    p_pad = a.pair_sig.shape[0]
    pair_demand = _segsum(part2.to(i32), a.task_pair.long(), p_pad)
    maj_pair = int(pair_demand.argmax())
    shared_sc = sc[maj_pair]
    ord_sh = _lexsort([-shared_sc])
    maj_ok = a.sig_pred[int(a.pair_sig[maj_pair])] & base
    cap_mass = torch.where(maj_ok[:, None],
                           torch.maximum(state.idle + a.backfilled,
                                         _f32(0.0)), _f32(0.0))
    room_cnt = torch.clamp(a.max_task_num - state.n_tasks, min=0).to(f32)
    cum_mass = tiled_cumsum(cap_mass[ord_sh])
    cum_cnt = tiled_cumsum(torch.where(maj_ok, room_cnt, _f32(0.0))[ord_sh])

    one_zero = torch.where(part2, _f32(1.0), _f32(0.0))
    mass_sorted = one_zero[order, None] * a.resreq[order]
    prefix_sorted = tiled_cumsum(mass_sorted) - mass_sorted
    cnt_sorted = one_zero[order]
    cnt_prefix_sorted = tiled_cumsum(cnt_sorted) - cnt_sorted
    prefix = torch.empty_like(mass_sorted)
    prefix[order] = prefix_sorted
    cnt_prefix = torch.empty_like(cnt_sorted)
    cnt_prefix[order] = cnt_prefix_sorted

    need = prefix + a.resreq
    slot = search_left(cum_mass[:, 0].contiguous(), need[:, 0].contiguous())
    for d in range(1, need.shape[1]):
        slot = torch.maximum(slot, search_left(cum_mass[:, d].contiguous(),
                                               need[:, d].contiguous()))
    slot = torch.maximum(slot, search_left(cum_cnt, cnt_prefix + 1.0))
    slot_ok = slot < n_pad
    p_water = ord_sh[slot.clamp(max=n_pad - 1)].to(i32)
    water_elig = _cell_elig(state.idle, state.releasing, state.n_tasks, a,
                            pipe_enabled, eps, p_water) & slot_ok
    if aff is not None:
        water_elig = water_elig & aff.cell_ok(p_water)
        if aff.ip:
            # interpod-scored tasks leave the shared waterfall
            water_elig = water_elig & ~ip_scored
    proposal1 = torch.where(water_elig, p_water, fb)

    # ---- 4. acceptance (two phases) ---------------------------------------
    def accept_phase(proposal, mask, idle_c, rel_c, ntasks_c):
        acc_c = idle_c + a.backfilled
        pl = proposal.long()
        prop_alloc = (a.init_resreq <= acc_c[pl] + eps).all(dim=-1)
        node_key = torch.where(mask, proposal,
                               torch.tensor(n_pad, dtype=i32))
        perm2 = _lexsort([global_rank, node_key])
        nid = node_key[perm2]
        seg_start = search_left(nid, nid)
        nid_c = nid.clamp(max=n_pad - 1).long()
        s_req = a.resreq[perm2]
        s_init = a.init_resreq[perm2]
        s_alloc = prop_alloc[perm2]
        s_part = mask[perm2]
        alloc_vals = torch.where((s_alloc & s_part)[:, None], s_req,
                                 _f32(0.0))
        pipe_vals = torch.where((~s_alloc & s_part)[:, None], s_req,
                                _f32(0.0))
        excl_alloc = _segmented_prefix(alloc_vals, seg_start)
        excl_pipe = _segmented_prefix(pipe_vals, seg_start)
        excl_cnt = _segmented_prefix(s_part.to(i32), seg_start)
        pool_acc = acc_c[nid_c]
        pool_idle = idle_c[nid_c]
        pool_rel = rel_c[nid_c]
        room_left = (a.max_task_num[nid_c] - ntasks_c[nid_c]
                     - excl_cnt) > 0
        ok_alloc = (s_alloc & s_part & room_left
                    & (s_init <= pool_acc - excl_alloc + eps).all(dim=-1))
        if pipe_enabled:
            ok_pipe = (~s_alloc & s_part & room_left
                       & (s_init <= pool_rel - excl_pipe + eps).all(dim=-1))
        else:
            ok_pipe = torch.zeros_like(ok_alloc)
        accept_s = ok_alloc | ok_pipe
        ob_s = ok_alloc & ~(s_init <= pool_idle - excl_alloc
                            + eps).all(dim=-1)
        accept = torch.empty_like(accept_s)
        accept[perm2] = accept_s
        ob = torch.empty_like(ob_s)
        ob[perm2] = ob_s
        return accept, ob, prop_alloc

    def commit_node(accept, is_alloc, is_pipe, proposal, idle_c, rel_c,
                    ntasks_c, nz_c, fold_nz):
        # fold_nz: XLA folds phase 1's ``nz + segment_sum`` into the
        # scatter (adds onto the carry in turn) but not the retry's
        # (sums first, then adds)
        node_seg = torch.where(accept, proposal, torch.tensor(0, dtype=i32))
        zero = _f32(0.0)
        idle_n = idle_c - _segsum(
            torch.where(is_alloc[:, None], a.resreq, zero), node_seg, n_pad)
        rel_n = rel_c - _segsum(
            torch.where(is_pipe[:, None], a.resreq, zero), node_seg, n_pad)
        ntasks_n = ntasks_c + _segsum(accept.to(i32), node_seg, n_pad)
        nz_vals = torch.where(accept[:, None], a.task_nz, zero)
        nz_n = (_add_segsum(nz_c, nz_vals, node_seg) if fold_nz
                else nz_c + _segsum(nz_vals, node_seg, n_pad))
        return idle_n, rel_n, ntasks_n, nz_n

    accept1, ob1, prop_alloc1 = accept_phase(
        proposal1, part2, state.idle, state.releasing, state.n_tasks)
    if aff is not None:
        # remove in-round affinity / port races before capacity commits
        accept1 = _aff_serialize(state, a, accept1, proposal1, global_rank)
    idle_c, rel_c, ntasks_c, nz_c = commit_node(
        accept1, prop_alloc1 & accept1, ~prop_alloc1 & accept1, proposal1,
        state.idle, state.releasing, state.n_tasks, state.nz_req, True)

    # retry phase: rejected tasks re-propose their argmax against the
    # mid-round carry (the scores stay the round's)
    retry = part2 & ~accept1
    if aff is not None:
        # affinity-involved tasks sit the retry out
        retry = retry & ~_aff_involved(state, a)
    any_r, fb_r, _ = _row_pass(idle_c, rel_c, ntasks_c, a, pipe_enabled,
                               eps, sc, retry, aff, pair_init)
    if stats is not None:
        stats["rounds"] = stats.get("rounds", 0) + 1
        stats["rows"] = (stats.get("rows", 0) + int(participating.sum())
                         + int(retry.sum()))
        if aff is not None and aff.ip:
            _ip_stats(stats, state, a, participating, retry)
    retry = retry & any_r
    accept_r, ob_r, prop_alloc_r = accept_phase(fb_r, retry, idle_c, rel_c,
                                                ntasks_c)
    idle_c, rel_c, ntasks_c, nz_c = commit_node(
        accept_r, prop_alloc_r & accept_r, ~prop_alloc_r & accept_r, fb_r,
        idle_c, rel_c, ntasks_c, nz_c, False)
    accept = accept1 | accept_r
    ob = torch.where(accept_r, ob_r, ob1)
    proposal = torch.where(accept_r, fb_r, proposal1)
    prop_alloc = torch.where(accept_r, prop_alloc_r, prop_alloc1)
    is_alloc = prop_alloc & accept
    is_pipe = ~prop_alloc & accept

    # ---- 5. commit (job / queue aggregates) -------------------------------
    zero_i = torch.tensor(0, dtype=i32)
    job_seg = torch.where(accept, a.task_job, zero_i)
    take_any = torch.where(accept[:, None], a.resreq, _f32(0.0))
    new_j_alloc = _add_segsum(state.j_allocated, take_any, job_seg)
    queue_seg = torch.where(accept, a.job_queue[tj0], zero_i)
    new_q_alloc = _add_segsum(state.q_allocated, take_any, queue_seg)
    counted = accept & ~ob
    new_alloc_cnt = state.alloc_cnt + _segsum(counted.to(i32), job_seg,
                                              j_pad)

    decision = torch.where(
        fail_first, FAIL,
        torch.where(is_pipe, PIPELINE,
                    torch.where(is_alloc & ob, ALLOC_OB,
                                torch.where(is_alloc, ALLOC, SKIP))))
    changed = accept | fail_first
    aff_upd = (_aff_commit(state, a, accept, proposal) if aff is not None
               else {})
    new_state = state._replace(
        idle=idle_c, releasing=rel_c, n_tasks=ntasks_c, nz_req=nz_c,
        q_allocated=new_q_alloc, j_allocated=new_j_alloc,
        alloc_cnt=new_alloc_cnt, job_alive=state.job_alive & ~job_killed,
        task_state=torch.where(changed, decision.to(i32), state.task_state),
        task_node=torch.where(accept, proposal, state.task_node),
        task_seq=torch.where(changed, round_idx * seq_stride + global_rank,
                             state.task_seq), **aff_upd)
    return new_state, bool(changed.any())


def _placed(state: RoundState, a: CycleArrays) -> torch.Tensor:
    st = state.task_state
    return ((st == ALLOC) | (st == ALLOC_OB) | (st == PIPELINE)) \
        & a.task_valid


def _stranded_jobs(state: RoundState, a: CycleArrays,
                   include_killed: bool = True) -> torch.Tensor:
    """Jobs holding this-cycle placements but below quorum (reference
    ``_stranded_jobs``). As there, a job with no task row at all reads
    ``segment_max``'s identity (int32 min), which is truthy."""
    j_pad = a.job_valid.shape[0]
    tj0 = a.task_job.clamp(min=0).long()
    job_placed = torch.full((j_pad,), _IMIN, dtype=torch.int32
                            ).scatter_reduce_(
        0, tj0, _placed(state, a).to(torch.int32), "amax") != 0
    ob_cnt = _segsum(((state.task_state == ALLOC_OB) & a.task_valid)
                     .to(torch.int32), tj0, j_pad)
    ready = state.alloc_cnt + ob_cnt >= a.order_min_available
    stranded = a.job_valid & job_placed & ~ready
    if not include_killed:
        stranded = stranded & state.job_alive
    return stranded


def _rollback_stranded(state: RoundState, a: CycleArrays,
                       revive: bool = False):
    """Revert every this-cycle placement of stranded jobs (reference
    ``_rollback_stranded``); task_node and task_seq keep their values."""
    i32, zero = torch.int32, _f32(0.0)
    stranded = _stranded_jobs(state, a, include_killed=revive)
    tj0 = a.task_job.clamp(min=0).long()
    revert = _placed(state, a) & stranded[tj0]
    is_pipe = revert & (state.task_state == PIPELINE)
    n_pad = state.idle.shape[0]
    j_pad = a.job_valid.shape[0]
    zero_i = torch.tensor(0, dtype=i32)
    node_seg = torch.where(revert, state.task_node, zero_i)
    idle = _add_segsum(state.idle, torch.where(
        (revert & ~is_pipe)[:, None], a.resreq, zero), node_seg)
    rel = _add_segsum(state.releasing, torch.where(
        is_pipe[:, None], a.resreq, zero), node_seg)
    ntasks = state.n_tasks - _segsum(revert.to(i32), node_seg, n_pad)
    nz = state.nz_req - _segsum(torch.where(revert[:, None], a.task_nz,
                                            zero), node_seg, n_pad)
    job_seg = torch.where(revert, a.task_job, zero_i)
    take = torch.where(revert[:, None], a.resreq, zero)
    j_alloc = state.j_allocated - _segsum(take, job_seg, j_pad)
    queue_seg = torch.where(revert, a.job_queue[tj0], zero_i)
    q_alloc = state.q_allocated - _segsum(take, queue_seg,
                                          a.q_deserved.shape[0])
    counted = revert & (state.task_state != ALLOC_OB)
    alloc_cnt = state.alloc_cnt - _segsum(counted.to(i32), job_seg, j_pad)
    if revive:
        alive = state.job_alive | stranded
        clear = revert | ((state.task_state == FAIL) & stranded[tj0])
    else:
        alive = state.job_alive & ~stranded
        clear = revert
    aff_upd = (_aff_rollback(state, a, revert) if a.node_dom is not None
               else {})
    return state._replace(
        idle=idle, releasing=rel, n_tasks=ntasks, nz_req=nz,
        q_allocated=q_alloc, j_allocated=j_alloc, alloc_cnt=alloc_cnt,
        job_alive=alive,
        task_state=torch.where(clear, torch.tensor(SKIP, dtype=i32),
                               state.task_state), **aff_upd), stranded


def _rounds_loop(state, a, start_round, max_rounds, seq_stride, opts,
                 stats):
    round_idx, progress = start_round, True
    while progress and round_idx < max_rounds:
        state, progress = _round(state, a, round_idx, *opts,
                                 seq_stride=seq_stride, stats=stats)
        round_idx += 1
    return state, round_idx


def _run_rounds(state: RoundState, a: CycleArrays, opts, max_rounds: int,
                compact_bucket: int, gang_enabled: bool, stats=None):
    """Reference ``batched_allocate``: the rounds, the compact
    continuation after round 0, then the stranded-gang epilogue. Returns
    (final state, rounds, epilogue retries, stranded gangs)."""
    t_pad = a.task_valid.shape[0]
    prop_overused = opts[2]
    if compact_bucket <= 0 or compact_bucket >= t_pad:
        state, rounds = _rounds_loop(state, a, 0, max_rounds, t_pad, opts,
                                     stats)
    else:
        state, _ = _round(state, a, 0, *opts, seq_stride=t_pad,
                          stats=stats)
        tj0 = a.task_job.clamp(min=0).long()
        unresolved = (a.task_valid & (state.task_state == SKIP)
                      & state.job_alive[tj0])
        if prop_overused:
            eps = torch.from_numpy(VEC_EPS)
            overused0 = (a.q_deserved < state.q_allocated + eps).all(dim=-1)
            unresolved = unresolved & ~overused0[a.job_queue[tj0].long()]
        cnt = int(unresolved.sum())
        if cnt > compact_bucket:
            state, rounds = _rounds_loop(state, a, 1, max_rounds, t_pad,
                                         opts, stats)
        elif cnt == 0:
            rounds = 1
        else:
            # the first compact_bucket unresolved tasks in index order,
            # fill slots (index t_pad) invalid, their rows clipped
            idx = torch.full((compact_bucket,), t_pad, dtype=torch.int64)
            nz_idx = torch.nonzero(unresolved).flatten()[:compact_bucket]
            idx[:nz_idx.shape[0]] = nz_idx
            valid_k = idx < t_pad
            idx_c = idx.clamp(max=t_pad - 1)
            fields = _TASK_FIELDS + tuple(
                f for f in _AFF_TASK_FIELDS if getattr(a, f) is not None)
            ca = a._replace(**{f: getattr(a, f)[idx_c] for f in fields})
            ca = ca._replace(task_valid=ca.task_valid & valid_k)
            cs = state._replace(task_state=state.task_state[idx_c],
                                task_node=state.task_node[idx_c],
                                task_seq=state.task_seq[idx_c])
            fs, rounds = _rounds_loop(cs, ca, 1, max_rounds, t_pad, opts,
                                      stats)
            put = {}
            for f in ("task_state", "task_node", "task_seq"):
                full = getattr(state, f).clone()
                full[idx[valid_k]] = getattr(fs, f)[valid_k]
                put[f] = full
            state = fs._replace(**put)
    if not gang_enabled:
        return state, rounds, 0, 0
    retries = 0
    while retries < 3 and bool(_stranded_jobs(state, a).any()):
        state, _ = _rollback_stranded(state, a, revive=True)
        state, rounds = _rounds_loop(state, a, rounds, max_rounds, t_pad,
                                     opts, stats)
        retries += 1
    state, stranded = _rollback_stranded(state, a, revive=False)
    return state, rounds, retries, int(stranded.sum())


def batched_allocate_plain(
        idle, releasing, n_tasks, nz_req, backfilled, allocatable_cm,
        max_task_num, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_pair, task_valid, sig_scores, sig_pred, pair_sig, pair_nz,
        order_min_available, init_allocated, job_queue, job_priority,
        job_create_rank, job_valid, q_deserved, q_create_rank, q_alloc0,
        j_alloc0, cluster_total, dyn_weights, *,
        job_keys: Tuple[str, ...] = (K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
        queue_keys: Tuple[str, ...] = (K_PROP_SHARE,),
        prop_overused: bool = True, dyn_enabled: bool = False,
        pipe_enabled: bool = True, max_rounds: int = 64,
        compact_bucket: int = 0, gang_enabled: bool = True,
        narrow: bool = False, narrow_gate: bool = False, stats=None,
        aff=None):
    """The batched allocate cycle in plain PyTorch on CPU tensors (the
    reference's ``_batched_packed``). ``narrow`` and ``narrow_gate`` set
    only the telemetry words; scores are read at float32. ``stats`` (a
    dict), when given, receives the rounds run and the task rows of their
    row passes (the work a bound counts), with an interpod score also
    the rows that can score and their terms (``_ip_stats``). ``aff``: the affinity arrays
    (a dict keyed by AFF_ARGS, plus PORT_ARGS with ports and IP_ARG with
    an interpod score), or None; with it the result gains the final
    affinity carry (a dict keyed by AFF_OUT; port_claim None without
    ports)."""
    args = locals()
    aff = _check_aff(aff)
    for name in NODE_ARGS + CYCLE_ARGS:
        if args[name].device.type != "cpu":
            raise ValueError("batched_allocate_plain runs on CPU tensors "
                             "(its segment sums are index_add_'s "
                             "sequential order on the CPU); copy the "
                             "inputs to the CPU")
    for name, t in (aff or {}).items():
        if t.device.type != "cpu":
            raise ValueError(f"batched_allocate_plain: {name} is not on "
                             f"the CPU")
    t_pad = task_valid.shape[0]
    i32 = torch.int32
    carry = {}
    fields = {f: args[f] for f in CycleArrays._fields if f in args}
    if aff is not None:
        carry = dict(aff_grp_cnt=aff["aff_grp_cnt0"].clone(),
                     aff_anti_cnt=aff["aff_anti_cnt0"].clone(),
                     aff_pref_w=aff["aff_pref_w0"].clone(),
                     aff_grp_total=aff["aff_grp_total0"].clone())
        fields.update({k: aff[k] for k in AFF_ARGS[:7]})
        if "port_base" in aff:
            carry["port_claim"] = torch.zeros_like(aff["port_base"])
            fields.update(task_ports=aff["task_ports"],
                          port_base=aff["port_base"])
        if IP_ARG in aff:
            fields["ip_weight"] = aff[IP_ARG].reshape(())
    state = RoundState(
        idle=idle.clone(), releasing=releasing.clone(),
        n_tasks=n_tasks.clone(), nz_req=nz_req.clone(),
        q_allocated=q_alloc0.clone(), j_allocated=j_alloc0.clone(),
        alloc_cnt=init_allocated.clone(), job_alive=job_valid.clone(),
        task_state=torch.full((t_pad,), SKIP, dtype=i32),
        task_node=torch.full((t_pad,), -1, dtype=i32),
        task_seq=torch.full((t_pad,), _IMAX, dtype=i32), **carry)
    a = CycleArrays(**fields)
    opts = (tuple(job_keys), tuple(queue_keys), bool(prop_overused),
            bool(dyn_enabled), bool(pipe_enabled))
    final, rounds, retries, stranded = _run_rounds(
        state, a, opts, int(max_rounds), int(compact_bucket),
        bool(gang_enabled), stats)
    frame = decision_frame(ENGINE_BATCHED, final.task_state, final.task_seq,
                           task_valid, waves=rounds, stride=t_pad,
                           narrow=narrow, narrow_gate=narrow_gate,
                           retries=retries, stranded=stranded)
    packed = torch.cat([final.task_state, final.task_node, final.task_seq,
                        torch.tensor([rounds], dtype=i32), frame])
    out = (packed, final.idle, final.releasing, final.n_tasks, final.nz_req)
    if aff is None:
        return out
    return out + ({k: getattr(final, k) for k in AFF_OUT},)


def _check_aff(aff):
    """``aff`` with its names and dtypes checked (None passes through)."""
    if aff is None:
        return None
    names = set(aff)
    missing = [n for n in AFF_ARGS if n not in names]
    ports = [n for n in PORT_ARGS if n in names]
    extra = names - set(AFF_ARGS) - set(PORT_ARGS) - {IP_ARG}
    if missing or extra or len(ports) == 1:
        raise ValueError(f"batched_allocate: affinity arrays missing "
                         f"{missing}, unknown {sorted(extra)}, or only one "
                         f"of {PORT_ARGS}")
    for name, t in aff.items():
        if t.dtype != arg_dtype(name):
            raise ValueError(f"batched_allocate: {name} must be "
                             f"{arg_dtype(name)}, got {t.dtype}")
    return dict(aff)


def unpack_result(packed, t_pad: int):
    """(task_state, task_node, task_seq, rounds, telemetry) of a packed
    result (numpy arrays or tensors)."""
    return (packed[:t_pad], packed[t_pad:2 * t_pad],
            packed[2 * t_pad:3 * t_pad], packed[3 * t_pad],
            packed[3 * t_pad + 1:])


def batched_allocate(*args, **kwargs):
    """The batched allocate cycle on the inputs' device: the CUDA kernel
    for CUDA tensors, :func:`batched_allocate_plain` for CPU tensors.
    Same arguments and results as :func:`batched_allocate_plain`."""
    names = NODE_ARGS + CYCLE_ARGS
    statics = {k: kwargs.pop(k) for k in list(kwargs) if k not in names}
    bound = dict(zip(names, args))
    bound.update(kwargs)
    missing = [n for n in names if n not in bound]
    if missing:
        raise TypeError(f"batched_allocate: missing arguments {missing}")
    devs = {bound[n].device.type for n in names}
    devs |= {t.device.type for t in (statics.get("aff") or {}).values()}
    if devs == {"cpu"}:
        return batched_allocate_plain(*(bound[n] for n in names), **statics)
    if devs != {"cuda"}:
        raise ValueError(f"batched_allocate: inputs on mixed devices {devs}")
    return _batched_allocate_cuda(bound, **statics)


#: phases of a round the kernel times between its grid barriers, in the
#: order of csrc/batched_allocate.cu's PH_* (device ns summed per phase)
PHASES = ("setup", "order_jobs", "engage", "window", "pair_scores",
          "rank_and_rows", "fail", "part2", "waterfall", "propose",
          "fit", "accept_commit", "retry_views", "retry_rows",
          "retry_mask", "retry_fit", "retry_accept_commit", "compact",
          "epilogue", "aff_views", "aff_serialize", "aff_commit")

#: the affinity phases of PHASES (their share is the affinity work beside
#: the predicates and the score inside the row passes)
AFF_PHASES = ("aff_views", "aff_serialize", "aff_commit")

#: grid, threads, dynamic shared bytes and workspace bytes of the last
#: kernel launch, and its per-phase device ns (``phase_ns``: an int64
#: tensor on the card, PHASES order; reading it is a copy of its own)
last_launch: dict = {}


def _batched_allocate_cuda(a, *, job_keys=(K_PRIORITY, K_GANG_READY,
                                           K_DRF_SHARE),
                           queue_keys=(K_PROP_SHARE,), prop_overused=True,
                           dyn_enabled=False, pipe_enabled=True,
                           max_rounds=64, compact_bucket=0,
                           gang_enabled=True, narrow=False,
                           narrow_gate=False, aff=None):
    import ctypes

    for name, t in a.items():
        want = arg_dtype(name)
        if t.dtype != want:
            raise ValueError(f"batched_allocate: {name} must be {want}, got "
                             f"{t.dtype}")
    if len(job_keys) > 3 or any(k not in JOB_KEY_CODES for k in job_keys):
        raise ValueError(f"batched_allocate: unsupported job keys {job_keys}")
    if any(k != K_PROP_SHARE for k in queue_keys):
        raise ValueError(f"batched_allocate: unsupported queue keys "
                         f"{queue_keys}")
    dev = a["idle"].device
    n = a["idle"].shape[0]
    t = a["task_valid"].shape[0]
    j = a["job_valid"].shape[0]
    q = a["q_deserved"].shape[0]
    s = a["sig_scores"].shape[0]
    p = a["pair_sig"].shape[0]
    shapes = {"idle": (n, 3), "releasing": (n, 3), "n_tasks": (n,),
              "nz_req": (n, 2), "backfilled": (n, 3),
              "allocatable_cm": (n, 2), "max_task_num": (n,),
              "node_ok": (n,), "resreq": (t, 3), "init_resreq": (t, 3),
              "task_nz": (t, 2), "task_job": (t,), "task_rank": (t,),
              "task_sig": (t,), "task_pair": (t,), "sig_scores": (s, n),
              "sig_pred": (s, n), "pair_sig": (p,), "pair_nz": (p, 2),
              "order_min_available": (j,), "init_allocated": (j,),
              "job_queue": (j,), "job_priority": (j,),
              "job_create_rank": (j,), "q_deserved": (q, 3),
              "q_create_rank": (q,), "q_alloc0": (q, 3), "j_alloc0": (j, 3),
              "cluster_total": (3,), "dyn_weights": (2,)}
    for name, shape in shapes.items():
        if tuple(a[name].shape) != shape:
            raise ValueError(f"batched_allocate: {name} must have shape "
                             f"{shape}, got {tuple(a[name].shape)}")
    aff = _check_aff(aff)
    aff_out = None
    aff_ptrs = [0] * 19
    aff_ints = [0, 0, 0, 0, 0]
    if aff is not None:
        aff = {k: v.contiguous() for k, v in aff.items()}
        n_pairs, d_cap = aff["aff_grp_cnt0"].shape
        pt = aff["task_ports"].shape[1] if "task_ports" in aff else 0
        ashapes = {"node_dom": (n_pairs, n), "aff_grp_total0": (n_pairs,),
                   "aff_anti_cnt0": (n_pairs, d_cap),
                   "aff_pref_w0": (n_pairs, d_cap)}
        ashapes.update({k: (t, n_pairs) for k in AFF_ARGS[1:7]})
        if pt:
            ashapes.update(task_ports=(t, pt), port_base=(n, pt))
        if IP_ARG in aff:
            ashapes[IP_ARG] = ()
        for name, shape in ashapes.items():
            if tuple(aff[name].shape) != shape:
                raise ValueError(f"batched_allocate: {name} must have shape "
                                 f"{shape}, got {tuple(aff[name].shape)}")
        if not 1 <= n_pairs <= 128 or pt > 64:
            raise ValueError(f"batched_allocate: {n_pairs} affinity pairs "
                             f"and {pt} ports exceed the kernel's 128 / 64")
        aff_out = {k: torch.empty_like(aff[k + "0"]) for k in AFF_OUT[:4]}
        aff_out["port_claim"] = (torch.empty_like(aff["port_base"]) if pt
                                 else None)
        aff_ptrs = [aff[k].data_ptr() for k in AFF_ARGS] + [
            aff["task_ports"].data_ptr() if pt else 0,
            aff["port_base"].data_ptr() if pt else 0,
            aff[IP_ARG].data_ptr() if IP_ARG in aff else 0] + [
            aff_out[k].data_ptr() for k in AFF_OUT[:4]] + [
            aff_out["port_claim"].data_ptr() if pt else 0]
        aff_ints = [1, n_pairs, d_cap, pt, int(IP_ARG in aff)]
    c = {k: v.contiguous() for k, v in a.items()}
    # node carries live in the outputs (the JAX kernel returns new arrays)
    idle = c["idle"].clone()
    releasing = c["releasing"].clone()
    n_tasks = c["n_tasks"].clone()
    nz = c["nz_req"].clone()
    packed = torch.empty(3 * t + 1 + TELEM_WIDTH, dtype=torch.int32,
                         device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    codes = [JOB_KEY_CODES[k] for k in job_keys] + [0] * (3 - len(job_keys))
    ints = np.asarray([
        n, t, j, q, p, len(job_keys), *codes,
        int(K_PROP_SHARE in queue_keys), int(bool(prop_overused)),
        int(bool(dyn_enabled)), int(bool(pipe_enabled)), int(max_rounds),
        int(compact_bucket), int(bool(gang_enabled)), int(bool(narrow)),
        int(bool(narrow_gate)), *aff_ints], dtype=np.int32)
    lib = _build.library("batched_allocate.cu")
    ws_bytes = ctypes.c_longlong(0)
    _build.check_launch("batched_allocate", lib.kb_batched_workspace(
        ints.ctypes.data, ints.shape[0], ctypes.addressof(ws_bytes)))
    ws = torch.empty(ws_bytes.value, dtype=torch.uint8, device=dev)
    phase_ns = torch.zeros(len(PHASES), dtype=torch.int64, device=dev)
    ptrs = np.asarray([
        idle.data_ptr(), releasing.data_ptr(), n_tasks.data_ptr(),
        nz.data_ptr(),
        *(c[k].data_ptr() for k in (
            "backfilled", "allocatable_cm", "max_task_num", "node_ok",
            "resreq", "init_resreq", "task_nz", "task_job", "task_rank",
            "task_sig", "task_pair", "task_valid", "sig_scores", "sig_pred",
            "pair_sig", "pair_nz", "order_min_available", "init_allocated",
            "job_queue", "job_priority", "job_create_rank", "job_valid",
            "q_deserved", "q_create_rank", "q_alloc0", "j_alloc0",
            "cluster_total", "dyn_weights")),
        eps.data_ptr(), packed.data_ptr(), phase_ns.data_ptr(),
        *aff_ptrs, ws.data_ptr()], dtype=np.uint64)
    info = np.zeros(3, dtype=np.int32)
    err = lib.kb_batched_allocate(
        ptrs.ctypes.data, ptrs.shape[0], ints.ctypes.data, ints.shape[0],
        info.ctypes.data, torch.cuda.current_stream(dev).cuda_stream)
    _build.check_launch("batched_allocate", err)
    _build.count_launch("batched_allocate")
    last_launch.update(grid=int(info[0]), threads=int(info[1]),
                       smem_bytes=int(info[2]), workspace_bytes=ws.numel(),
                       phase_ns=phase_ns)
    if aff_out is None:
        return packed, idle, releasing, n_tasks, nz
    return packed, idle, releasing, n_tasks, nz, aff_out


#: per-cycle arrays shipped as packed buffers (kernels/pack.py), in the
#: reference's layout; node-axis arrays live on the DeviceSession
_PACK_F32 = ("resreq", "init_resreq", "task_nz", "sig_scores",
             "job_priority", "q_deserved", "cluster_total", "dyn_weights",
             "pair_nz", "q_alloc0", "j_alloc0")
_PACK_I32 = ("task_job", "task_rank", "task_sig", "task_pair",
             "order_min_available", "job_queue", "job_create_rank",
             "q_create_rank", "init_allocated", "pair_sig")
_PACK_BOOL = ("task_valid", "job_valid", "sig_pred")
#: affinity extensions, joined when the cycle carries the features
_AFF_F32 = ("task_carry_w", "task_pref_w", "aff_grp_cnt0", "aff_anti_cnt0",
            "aff_pref_w0", "aff_grp_total0")
_AFF_I32 = ("node_dom",)
_AFF_BOOL = ("task_grp", "task_req_aff", "task_req_anti", "task_self_ok")


def _integral(x: np.ndarray) -> bool:
    """Integer-valued and inside float32's exact-integer range: the CUDA
    kernel keeps the affinity carry as int32 (order-free atomics)."""
    x = np.asarray(x, np.float64)
    return bool(np.array_equal(x, np.round(x))
                and (x.size == 0 or np.abs(x).max() < 2.0 ** 24))


def prepare_batched(inputs, max_rounds: int = 0, compact_bucket=None):
    """The (args, statics) of the batched solve for these CycleInputs
    (actions/cycle_inputs.py): args maps every batched_allocate argument
    to a tensor on the DeviceSession's device (the per-cycle arrays
    uploaded as three packed buffers), statics holds the keyword options,
    sized as the reference's prepare_batched sizes them, and ``aff``, the
    affinity arrays, when the cycle carries the vocabulary.
    ``compact_bucket``: None sizes the post-round-0 compaction
    automatically; 0 forces the full-width loop."""
    from .narrow import narrow_enabled
    from .pack import pack_inputs, unpack

    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    if max_rounds <= 0:
        # every productive round places >= 1 task or fails >= 1 job; the
        # bound is a safety net, not the expected round count
        max_rounds = int(t_pad) + 8
    task_pair, pair_sig, pair_nz, _ = inputs.pair_terms()
    extra = {"task_pair": task_pair, "pair_sig": pair_sig,
             "pair_nz": pair_nz}
    f32_names, i32_names, bool_names = _PACK_F32, _PACK_I32, _PACK_BOOL
    aff = inputs.affinity
    aff_names = ()
    if aff is not None:
        extra.update(
            task_carry_w=aff.task_carry_w, task_pref_w=aff.task_pref_w,
            aff_grp_cnt0=aff.grp_cnt0, aff_anti_cnt0=aff.anti_cnt0,
            aff_pref_w0=aff.pref_w0, aff_grp_total0=aff.grp_total0,
            node_dom=aff.node_dom, task_grp=aff.task_grp,
            task_req_aff=aff.task_req_aff, task_req_anti=aff.task_req_anti,
            task_self_ok=aff.task_self_ok)
        f32_names = f32_names + _AFF_F32
        i32_names = i32_names + _AFF_I32
        bool_names = bool_names + _AFF_BOOL
        aff_names = AFF_ARGS
        if np.any(aff.task_ports):
            extra.update(task_ports=aff.task_ports, port_base=aff.port_base)
            bool_names = bool_names + PORT_ARGS
            aff_names = aff_names + PORT_ARGS
        if aff.ip_enabled:
            extra[IP_ARG] = np.float32(aff.ip_weight)
            f32_names = f32_names + (IP_ARG,)
            aff_names = aff_names + (IP_ARG,)
        bad = [n for n in _AFF_F32 if not _integral(extra[n])]
        if bad:
            raise ValueError(f"affinity arrays {bad} are not integer-valued "
                             f"(k8s affinity weights are integers)")
    bufs = pack_inputs(lambda nm: extra[nm] if nm in extra
                       else getattr(inputs, nm),
                       f32_names, i32_names, bool_names)
    dev = device.device
    args = {k: getattr(device, k) for k in NODE_ARGS}
    for buf, lay in zip(bufs[0::2], bufs[1::2]):
        args.update(unpack(torch.from_numpy(buf).to(dev), lay))
    aff_args = {k: args.pop(k) for k in aff_names}
    if compact_bucket is None:
        # compaction pays off once the [T,N] passes dwarf the stragglers
        compact = max(256, t_pad // 8) if t_pad >= 2048 else 0
    else:
        compact = int(compact_bucket)
    n_pad = int(device.node_ok.shape[0])
    narrow = narrow_enabled(
        n_pad, t_pad, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None),
        ip_weight=(aff.ip_weight
                   if aff is not None and aff.ip_enabled else 0.0))
    statics = dict(
        job_keys=inputs.job_keys, queue_keys=inputs.queue_keys,
        prop_overused=inputs.prop_overused,
        dyn_enabled=inputs.dyn_enabled, pipe_enabled=inputs.pipe_enabled,
        max_rounds=min(max_rounds, 4096), compact_bucket=compact,
        gang_enabled=inputs.gang_enabled, narrow=narrow,
        # telemetry: the shape thresholds alone wanted the narrow store
        # but the score/weight scale refused it
        narrow_gate=(not narrow and narrow_enabled(n_pad, t_pad)))
    if aff is not None:
        statics["aff"] = aff_args
    return args, statics


def solve_batched(inputs, max_rounds: int = 0, compact_bucket=None,
                  phases=None):
    """Run the batched solve for these CycleInputs and make its ONE
    counted device->host copy; commits the final node carry to the
    DeviceSession. Returns (task_state, task_node, task_seq, rounds,
    telemetry) as numpy. ``phases`` (a dict), when given, receives the
    host milliseconds of upload, solve (launch) and sync, and ``kernel``:
    the solve's device milliseconds from CUDA events (NaN on the CPU)."""
    import time

    from .. import obs
    from ..device import to_host

    device = inputs.device
    t_pad = inputs.task_valid.shape[0]
    t0 = time.perf_counter()
    args, statics = prepare_batched(inputs, max_rounds, compact_bucket)
    t1 = time.perf_counter()
    on_card = device.device.type == "cuda"
    with obs.span("batched_allocate", cat="kernel") as sp:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        packed, idle, releasing, n_tasks, nz = batched_allocate(
            **args, **statics)[:5]
        if on_card:
            end.record()
        t2 = time.perf_counter()
        with obs.span("readback", cat="readback"):
            host = to_host(packed)    # the solve's ONE device->host copy
        t3 = time.perf_counter()
        obs.telemetry.record(host[3 * t_pad + 1:], span=sp)
    device.idle, device.releasing, device.n_tasks = idle, releasing, n_tasks
    device.nz_req = nz
    if phases is not None:
        phases.update(upload=(t1 - t0) * 1e3, solve=(t2 - t1) * 1e3,
                      sync=(t3 - t2) * 1e3,
                      kernel=(start.elapsed_time(end) if on_card
                              else float("nan")))
    state, node, seq, rounds, telem = unpack_result(host, t_pad)
    return state, node, seq, int(rounds), telem
