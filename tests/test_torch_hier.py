"""The port's two-level engine against the reference package's, on the CPU.

Tolerance 0 throughout: ``hier_packed`` on CPU tensors (the plain
version, ``hier_allocate_plain``) against the reference's jitted
``_hier_packed`` on the reference's own prepare_hier plan, carried
across by ``interop.hier_args_from_numpy``: the packed result (decisions,
round count, telemetry frame) word for word and the final node carry bit
for bit. The cases are the reference's own (tests/test_zscale_hier.py:
the downsampled single-pool regime, contended multi-pool seeds, the
eligible-nowhere FAIL sweep) plus a stranded gang through the epilogue,
pipelined and over-backfill fits, the bf16 score store the reference
takes at cluster scale, and the coarse pass's pool score at the float
edges of the dynamic node score, in the two-level graph and the
active-set ones (kernels/xla_order.py WEIGHTED_SUM_FMA). The CUDA kernel
is held against the plain version on the card in
tests/test_torch_cuda.py.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
from kubebatch_tpu.actions.cycle_inputs import build_cycle_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession, OpenSession  # noqa: E402
from kubebatch_tpu.kernels import activeset as j_act  # noqa: E402
from kubebatch_tpu.kernels import hier as j_hier  # noqa: E402
from kubebatch_tpu.kernels.batched import (_PACK_BOOL, _PACK_F32,  # noqa: E402
                                           _PACK_I32)
from kubebatch_tpu.kernels.fused import (K_DRF_SHARE, K_GANG_READY,  # noqa: E402
                                         K_PRIORITY, K_PROP_SHARE)
from kubebatch_tpu.kernels.pack import pack_inputs  # noqa: E402
from kubebatch_tpu.objects import PodPhase  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec, build_cluster  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch.kernels import activeset as t_act  # noqa: E402
from kubebatch_tpu_torch.kernels import hier as t_hier  # noqa: E402
from kubebatch_tpu_torch.kernels.solver import _least_balanced  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import (F_ACT_DEMOTED,  # noqa: E402
                                                   F_POOL_OCC, F_RETRIES)

from .fixtures import build_group, build_node, build_pod, build_queue, rl  # noqa: E402
from .test_torch_batched import (CHAIN_EDGE_IDS, CHAIN_EDGES,  # noqa: E402
                                _assert_bitwise, _prep_fill)
from .test_zscale_hier import _B, _open  # noqa: E402

GiB = 1024 ** 3
f32 = np.float32
_PLACED = (1, 2, 3)


def assert_result(packed, final, got):
    """The port's (packed, idle, releasing, n_tasks, nz_req) against the
    reference's packed result and final state, word for word; returns
    the packed result (numpy)."""
    _assert_bitwise(packed, got[0].numpy(), "packed")
    for name, r, g in zip(("idle", "releasing", "n_tasks", "nz_req"),
                          (final.idle, final.releasing, final.n_tasks,
                           final.nz_req), got[1:]):
        _assert_bitwise(r, g.numpy(), name)
    return np.asarray(packed)


def check_plan(args, statics, final, packed, **port_statics):
    """The port's hier_packed on the reference plan's arrays against the
    reference's (final, packed); returns the packed result (numpy)."""
    arrays, st = interop.hier_args_from_numpy(
        [np.asarray(a) for a in args], statics, "cpu")
    st.update(port_statics)
    return assert_result(packed, final, t_hier.hier_packed(**arrays, **st))


def check_session(ssn, pool_size=8, **statics):
    """The reference's two-level solve of this session (its own plan)
    against the port's; returns (packed, T)."""
    inputs = build_cycle_inputs(ssn)
    args, st = j_hier.prepare_hier(inputs.device, inputs,
                                   pool_size=pool_size)
    st.update(statics)
    final, packed = j_hier._hier_packed(*args, **st)
    out = check_plan(args, st, final, packed)
    CloseSession(ssn)
    return out, inputs.task_valid.shape[0]


@pytest.mark.parametrize("n,pool", [(32, 0), (64, 0), (8192, 0),
                                    (53248, 0), (102400, 0), (53250, 0),
                                    (8196, 0), (64, 10), (53248, 5000),
                                    (16, 3)])
def test_pool_size_matches_reference(monkeypatch, n, pool):
    """The pool width and its divisor clamp: the reference reads the
    requested width from KUBEBATCH_HIER_POOL, the port from its
    argument."""
    if pool:
        monkeypatch.setenv("KUBEBATCH_HIER_POOL", str(pool))
    else:
        monkeypatch.delenv("KUBEBATCH_HIER_POOL", raising=False)
    got = t_hier.hier_pool_size(n, pool)
    assert got == j_hier.hier_pool_size(n)
    assert n % got == 0


def _sim_session(spec, prep=None):
    sim = build_cluster(spec)
    if prep:
        _prep_fill(sim, prep)
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False)
    sim.populate(cache)
    return OpenSession(cache, shipped_tiers())


#: cfg5's shape cut to 48 nodes (8 pools of 8): contended, jittered
#: requests (fractional MiB), the epilogue revives stranded gangs
REDUCED5 = ClusterSpec(n_nodes=48, n_groups=72, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=5)
#: a nearly full cluster (with _prep_fill: pipelined / over-backfill)
FILLED = ClusterSpec(n_nodes=16, n_groups=24, pods_per_group=4,
                     min_member=2, running_fill=0.9, n_queues=2,
                     queue_weights=(1, 3), pod_cpu_millis=1000,
                     pod_mem_bytes=GiB, seed=7)
REDUCED3 = ClusterSpec(n_nodes=64, n_groups=160, pods_per_group=4,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=800, pod_mem_bytes=GiB)


@pytest.mark.parametrize("seed,uniform_cpu,groups,pods", [
    (4, 8000, 6, 2), (0, 4000, 12, 4), (0, 0, 12, 4), (7, 0, 12, 4)],
    ids=["downsampled", "contended-uniform", "hetero-s0", "hetero-s7"])
def test_hier_matches_reference_on_its_cases(seed, uniform_cpu, groups,
                                             pods):
    """The reference's 24-node harness at pool 8 (3 pools): one pool
    holding the demand, and demand spilling over several waves."""
    packed, t = check_session(_open(n_nodes=24, n_groups=groups,
                                    pods_per_group=pods, seed=seed,
                                    uniform_cpu=uniform_cpu))
    assert np.isin(packed[:t], _PLACED).sum() > 0


@pytest.mark.parametrize("case,pool", [
    ((REDUCED5, None), 8), ((FILLED, "releasing"), 4),
    ((FILLED, "backfill"), 4), ((REDUCED3, None), 0)]
    + [((spec, None), 4) for spec in CHAIN_EDGES],
    ids=["epilogue", "pipelined", "over_backfill", "default_pool"]
    + CHAIN_EDGE_IDS)
def test_hier_matches_reference_on_sim_clusters(case, pool):
    packed, t = check_session(_sim_session(*case), pool_size=pool)
    frame = packed[3 * t + 1:]
    if case[0] is REDUCED5:
        assert frame[F_RETRIES] > 0     # stranded gangs went through it
    assert frame[F_POOL_OCC] > 0


def _oversized(cache, doomed):
    """16 nodes of 4 cpus: with ``doomed`` a feasible gang and a gang
    whose first task fits nowhere (its FAIL kills the later-ranked
    sibling), else three gangs of one oversized task each (no pool has
    work: zero waves, the terminal sweep fails them all)."""
    cache.add_queue(build_queue("q0"))
    for i in range(16):
        cache.add_node(build_node(f"n{i:03d}", rl(4000, 8 * GiB, pods=20)))
    groups = ([("ok", 2, [1000, 1000]), ("doomed", 1, [64000, 1000])]
              if doomed else [(f"huge{g}", 1, [64000]) for g in range(3)])
    for g, (name, min_member, cpus) in enumerate(groups):
        cache.add_pod_group(build_group("ns", name, min_member, queue="q0",
                                        creation_timestamp=float(g)))
        for p, cpu in enumerate(cpus):
            cache.add_pod(build_pod("ns", f"{name}-{p}", "",
                                    PodPhase.PENDING, rl(cpu, GiB),
                                    group=name,
                                    creation_timestamp=float(g * 100 + p)))


@pytest.mark.parametrize("doomed", [False, True],
                         ids=["eligible_nowhere", "doomed_gang"])
def test_hier_fail_sweep_matches_reference(doomed):
    cache = SchedulerCache(binder=_B(), async_writeback=False)
    _oversized(cache, doomed)
    packed, t = check_session(OpenSession(cache, shipped_tiers()))
    assert (packed[:t] == 4).sum() >= 1          # FAIL


def test_narrow_store_is_decision_identical():
    """At cfg6 / cfg7 shapes the reference stores the [P,N] / [T,N]
    scores in bf16 (where that is exact); the port keeps float32. With
    the reference forced to its bf16 store, the port (float32, the
    telemetry word set) decides and commits word for word alike."""
    ssn = _sim_session(REDUCED5)
    inputs = build_cycle_inputs(ssn)
    args, st = j_hier.prepare_hier(inputs.device, inputs, pool_size=8)
    st.update(narrow=True, narrow_gate=False)
    final, packed = j_hier._hier_packed(*args, **st)
    out = check_plan(args, st, final, packed)
    t = inputs.task_valid.shape[0]
    assert out[3 * t + 1 + 12] == 1              # F_NARROW
    CloseSession(ssn)


# ---- the coarse pass's pool score at the dynamic score's float edges -----

def _synthetic(n_nodes: int = 16):
    """A one-task, one-job cycle on ``n_nodes`` nodes, pools of 8: every
    node roomy and eligible; the test sets scores, allocatable and
    nonzero sums."""
    t, j, q, p, s = 8, 8, 4, 4, 1
    a = {
        "resreq": np.zeros((t, 3), f32), "init_resreq": np.zeros((t, 3), f32),
        "task_nz": np.zeros((t, 2), f32), "sig_scores": np.zeros((s, n_nodes),
                                                                 f32),
        "job_priority": np.zeros(j, f32), "q_deserved": np.full((q, 3), 1e9,
                                                               f32),
        "cluster_total": np.full(3, 1e9, f32),
        "dyn_weights": np.ones(2, f32), "pair_nz": np.zeros((p, 2), f32),
        "q_alloc0": np.zeros((q, 3), f32), "j_alloc0": np.zeros((j, 3), f32),
        "task_job": np.zeros(t, np.int32), "task_rank": np.arange(t,
                                                                  dtype=np.int32),
        "task_sig": np.zeros(t, np.int32), "task_pair": np.zeros(t, np.int32),
        "order_min_available": np.ones(j, np.int32),
        "job_queue": np.zeros(j, np.int32),
        "job_create_rank": np.arange(j, dtype=np.int32),
        "q_create_rank": np.arange(q, dtype=np.int32),
        "init_allocated": np.zeros(j, np.int32),
        "pair_sig": np.zeros(p, np.int32),
        "task_valid": np.arange(t) < 1, "job_valid": np.arange(j) < 1,
        "sig_pred": np.ones((s, n_nodes), bool)}
    a["resreq"][0] = a["init_resreq"][0] = (1.0, 1.0, 0.0)
    node = {"idle": np.full((n_nodes, 3), 1e6, f32),
            "releasing": np.zeros((n_nodes, 3), f32),
            "n_tasks": np.zeros(n_nodes, np.int32),
            "nz_req": np.zeros((n_nodes, 2), f32),
            "backfilled": np.zeros((n_nodes, 3), f32),
            "allocatable_cm": np.ones((n_nodes, 2), f32),
            "max_task_num": np.full(n_nodes, 10, np.int32),
            "node_ok": np.zeros(n_nodes, bool)}
    return a, node


def _solve_synthetic(a, node):
    """Both packages' two-level solve of a synthetic cycle; returns the
    placed node."""
    bufs = pack_inputs(lambda nm: a[nm], _PACK_F32, _PACK_I32, _PACK_BOOL)
    args = (bufs[0], bufs[2], bufs[4]) + tuple(
        node[k] for k in t_hier.NODE_ARGS)
    statics = dict(lay_f=bufs[1], lay_i=bufs[3], lay_b=bufs[5],
                   job_keys=(K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
                   queue_keys=(K_PROP_SHARE,), prop_overused=True,
                   dyn_enabled=True, pipe_enabled=False, max_rounds=16,
                   pool_size=8, gang_enabled=True, narrow=False,
                   narrow_gate=False)
    final, packed = j_hier._hier_packed(*args, **statics)
    out = check_plan(args, statics, final, packed)
    return int(out[8])                           # task_node[0]


def _balanced_edges():
    """float32 fraction differences d where trunc(10 - d * 10) differs
    between two roundings and one FMA (tests/test_torch_visit.py)."""
    out = []
    for k in range(1, 10):
        x = f32(k / 10)
        for _ in range(8):
            x = np.nextafter(x, f32(1.0))
            two = np.trunc(f32(10.0) - x * f32(10.0))
            fma = np.trunc(f32(10.0 - np.float64(x) * 10.0))
            if two != fma:
                out.append(x)
    return out


@pytest.mark.parametrize("other", [8, 1], ids=["coarse_pass", "round"])
def test_balanced_fma_edge(other):
    """Node 0's balanced term sits on an FMA edge (its allocatable 1.0,
    its fractions its nonzero sums); node ``other`` (no allocatable:
    dynamic score 0) carries the two-rounding total as its static score.
    Evaluated as one FMA, node 0's total is the smaller and ``other``
    wins — through the coarse pass's pool score (other pool, 8) or the
    round's waterfall order (same pool, 1) — as in the reference's
    graph."""
    import torch
    edges = _balanced_edges()
    assert len(edges) >= 3
    for d in edges[:3]:
        a, node = _synthetic()
        node["node_ok"][[0, other]] = True
        node["nz_req"][0] = (d, 0.0)
        node["allocatable_cm"][other] = 0.0
        least, bal = _least_balanced(torch.from_numpy(node["nz_req"][:1]),
                                     torch.zeros(2), torch.ones(1, 2))
        two = np.trunc(f32(10.0) - d * f32(10.0))
        assert float(bal[0]) < two
        a["sig_scores"][0, other] = float(least[0]) + two
        assert _solve_synthetic(a, node) == other


def weighted_edges(count: int):
    """(weights, two-rounding total, FMA total) of nodes with allocatable
    (6000, 7000) and nonzero sums (1000, 3000) where fma(balanced, w1,
    least * w0) differs from the two rounded products' sum."""
    import torch
    rng = np.random.default_rng(9)
    cap = np.array([6000.0, 7000.0], f32)
    nz = np.array([1000.0, 3000.0], f32)
    least, bal = _least_balanced(torch.from_numpy(nz[None]), torch.zeros(2),
                                 torch.from_numpy(cap[None]))
    l, b = np.float64(least[0]), np.float64(bal[0])
    w = rng.uniform(0.1, 3.0, (5000, 2)).astype(f32)
    lw = (l * w[:, 0].astype(np.float64)).astype(f32)
    bw = b * w[:, 1].astype(np.float64)
    fma = (bw + lw.astype(np.float64)).astype(f32)
    two = lw + bw.astype(f32)
    hits = np.nonzero(fma != two)[0][:count]
    assert len(hits) == count
    return cap, nz, [(w[k], two[k], fma[k]) for k in hits]


@pytest.mark.parametrize("other", [8, 1], ids=["coarse_pass", "round"])
def test_weighted_sum_edge(other):
    """Fractional nodeorder weights where fma(balanced, w1, least * w0)
    differs from the two rounded products' sum. Node 0 carries the
    dynamic score; node ``other`` (no allocatable: dynamic score 0) the
    larger of the two totals as its static score. In another pool (8)
    the coarse pass's pool score picks between them, in the same pool
    (1) the round's waterfall order does: the placement shows which
    evaluation the reference's graph makes (xla_order.WEIGHTED_SUM_FMA:
    the FMA, in both), and the port must make the same."""
    cap, nz, edges = weighted_edges(3)
    for w, two, fma in edges:
        a, node = _synthetic()
        a["dyn_weights"][:] = w
        node["node_ok"][[0, other]] = True
        node["nz_req"][0] = nz
        node["allocatable_cm"][0] = cap
        node["allocatable_cm"][other] = 0.0
        a["sig_scores"][0, other] = max(fma, two)
        assert _solve_synthetic(a, node) == (0 if fma >= two else other)


def _act_synthetic(a, node, audit: bool):
    """Both packages' active-set solve (or audit) of a synthetic one-task
    cycle (tests/test_torch_hier.py _synthetic); returns the placed
    node."""
    act = dict(a, pair_init_resreq=np.zeros((4, 3), f32))
    act["pair_init_resreq"][0] = a["init_resreq"][0]
    abufs = pack_inputs(lambda nm: act[nm], j_act._ACT_PACK_F32, _PACK_I32,
                        _PACK_BOOL)
    nodes = tuple(node[k] for k in t_hier.NODE_ARGS)
    base = dict(job_keys=(K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
                queue_keys=(K_PROP_SHARE,), prop_overused=True,
                dyn_enabled=True, pipe_enabled=False, pool_size=8,
                gang_enabled=True, narrow=False, narrow_gate=False)
    if not audit:
        st = dict(base, lay_f=abufs[1], lay_i=abufs[3], lay_b=abufs[5],
                  max_rounds=16)
        args = (abufs[0], abufs[2], abufs[4]) + nodes
        final, packed = j_act._activeset_packed(*args, **st)
        arrays, tst = interop.activeset_args_from_numpy(args, st, "cpu")
        return int(assert_result(packed, final,
                          t_act.activeset_packed(**arrays, **tst))[8])
    fbufs = pack_inputs(lambda nm: a[nm], _PACK_F32, _PACK_I32, _PACK_BOOL)
    st = dict(base, alay_f=abufs[1], alay_i=abufs[3], alay_b=abufs[5],
              flay_f=fbufs[1], flay_i=fbufs[3], flay_b=fbufs[5],
              amax_rounds=16, fmax_rounds=16)
    args = (abufs[0], abufs[2], abufs[4], fbufs[0], fbufs[2], fbufs[4]) \
        + nodes
    final, packed = j_act._activeset_audit_packed(*args, **st)
    node_t, act_t, full_t, tst = interop.activeset_audit_args_from_numpy(
        args, st, "cpu")
    out = assert_result(packed, final, t_act.activeset_audit_packed(
        node_t, act_t, full_t, **tst))
    assert out[3 * 8 + 1 + F_ACT_DEMOTED] == 0
    return int(out[8])


@pytest.mark.parametrize("other,audit", [(8, False), (1, False), (8, True)],
                         ids=["coarse_pass", "round", "audit"])
def test_weighted_sum_edge_active_set(other, audit):
    """test_weighted_sum_edge in the active-set graphs (the steady solve
    and the audit): the pair coarse pass and the rounds contract the
    weighted sum into one FMA as the two-level graph does."""
    cap, nz, edges = weighted_edges(2)
    for w, two, fma in edges:
        a, node = _synthetic()
        a["dyn_weights"][:] = w
        node["node_ok"][[0, other]] = True
        node["nz_req"][0] = nz
        node["allocatable_cm"][0] = cap
        node["allocatable_cm"][other] = 0.0
        a["sig_scores"][0, other] = max(fma, two)
        assert _act_synthetic(a, node, audit) == (0 if fma >= two
                                                  else other)
