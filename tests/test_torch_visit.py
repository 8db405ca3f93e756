"""The per-visit allocate scan against the reference package.

``kernels.solver.allocate_scan_plain`` (and ``allocate_scan``, which runs
it for CPU tensors) against the reference's jitted ``_allocate_scan`` on
the CPU: the packed block (decisions, node indices, the became-ready
flag, the telemetry frame) and the carry (idle, releasing, n_tasks,
nz_req) must be equal word for word — tolerance 0. Inputs come from a
numpy seed and reach both functions as the same arrays
(``interop.scan_inputs_from_numpy`` on the port's side). Beside the
random cases, targeted ones reach every decision kind and stop, and the
float orders the reference's compiled scan takes: the fit test's
``(idle + backfilled) + eps``, the balanced score's FMA, and the weighted
sum ``fma(balanced, w1, least * w0)``.

Then ``DeviceSession.solve_job`` against the reference's, and whole
``mode="jax"`` cycles and custom-order (``b8_tiers``) cycles against the
reference's allocate: per task the status and node, the bind order,
``last_cycle_engine``, and one counted copy back per visit on both
sides.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401
import kubebatch_tpu.plugins  # noqa: E402,F401
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu.actions import allocate as j_allocate_mod  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import solver as j_solver  # noqa: E402
from kubebatch_tpu.kernels.solver import _allocate_scan  # noqa: E402
from kubebatch_tpu.kernels.tensorize import TaskBatch as JBatch  # noqa: E402
from kubebatch_tpu.kernels.terms import solver_terms as j_terms  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import solver as t_solver  # noqa: E402
from kubebatch_tpu_torch.kernels.solver import (  # noqa: E402
    _least_balanced, allocate_scan, allocate_scan_plain)
from kubebatch_tpu_torch.kernels.tensorize import TaskBatch as TBatch  # noqa: E402
from kubebatch_tpu_torch.kernels.terms import solver_terms as t_terms  # noqa: E402

from .test_torch_cycle import REDUCED5, Side, b8_tiers, j_b8_tiers  # noqa: E402

f32 = np.float32
EPS = np.array([10.0, 10.0, 10.0], f32)     # VEC_EPS (cpu m, MiB, gpu m)


# ---------------------------------------------------------------------
# the scan alone
# ---------------------------------------------------------------------

def random_case(seed: int, n: int, t: int, n_valid: int = None):
    """Scan inputs at N nodes (the last tenth padding when n > 64) and T
    task rows, from a numpy seed: a partly used cluster with some
    releasing and lendable capacity, random predicate rows and small
    integer static scores."""
    rng = np.random.default_rng(seed)
    idle = np.stack([rng.uniform(0, 4000, n), rng.uniform(0, 8192, n),
                     rng.uniform(0, 2000, n)], 1).astype(f32)
    rel = (rng.uniform(0, 2000, (n, 3))
           * (rng.random((n, 1)) < 0.3)).astype(f32)
    back = (rng.uniform(0, 1000, (n, 3))
            * (rng.random((n, 1)) < 0.3)).astype(f32)
    cap = np.stack([rng.uniform(3200, 9600, n),
                    rng.uniform(6554, 19661, n)], 1).astype(f32)
    nz = (cap * rng.uniform(0, 1.1, (n, 2))).astype(f32)
    ok = rng.random(n) < 0.9
    if n > 64:
        ok[-(n // 10):] = False                    # padded nodes
    req = np.stack([rng.uniform(100, 2000, t), rng.uniform(100, 4000, t),
                    np.zeros(t)], 1).astype(f32)
    if n_valid is None:
        n_valid = max(1, t - int(rng.integers(0, 3)))
    valid = np.arange(t) < n_valid
    req[~valid] = 0.0
    return {
        "idle": idle, "releasing": rel, "backfilled": back,
        "allocatable_cm": cap, "nz_req": nz,
        "max_task_num": rng.integers(1, 6, n).astype(np.int32),
        "n_tasks": rng.integers(0, 5, n).astype(np.int32),
        "node_ok": ok, "resreq": req, "init_resreq": req.copy(),
        "task_nz": req[:, :2].copy(), "task_valid": valid,
        "scores": rng.integers(0, 5, (t, n)).astype(f32),
        "pred_mask": rng.random((t, n)) < 0.8,
        "min_available": int(rng.integers(0, t + 2)),
        "init_allocated": int(rng.integers(0, 3)),
        "dyn_weights": np.array([1.0, 1.0], f32)}


def reference_scan(a: dict, dyn: bool):
    out = _allocate_scan(
        *(a[k] for k in t_solver.SCAN_NODE_ARGS + t_solver.SCAN_TASK_ARGS),
        np.int32(a["min_available"]), np.int32(a["init_allocated"]),
        a["dyn_weights"], dyn_enabled=dyn)
    return [np.asarray(x) for x in out]


def assert_scan_equal(a: dict, dyn: bool, what: str):
    """The plain scan, and the wrapper on CPU tensors, equal the
    reference word for word; returns the reference's packed block."""
    want = reference_scan(a, dyn)
    kw = interop.scan_inputs_from_numpy(a, "cpu")
    for fn in (allocate_scan_plain, allocate_scan):
        got = [x.numpy() for x in fn(**kw, dyn_enabled=dyn)]
        for k, (w, g) in enumerate(zip(want, got)):
            assert w.dtype == g.dtype and w.shape == g.shape, (what, k)
            assert w.tobytes() == g.tobytes(), (
                f"{what}: {fn.__name__} output {k} differs at "
                f"{np.nonzero(w.view(np.uint8) != g.view(np.uint8))[0][:8]}")
    return want[0]


@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dyn"])
@pytest.mark.parametrize("n", [8, 64, 1000])
@pytest.mark.parametrize("t", [1, 8, 33])
def test_random_scans_match_reference(t, n, dyn):
    for seed in range(3):
        a = random_case(1000 * t + 10 * n + seed, n, t)
        assert_scan_equal(a, dyn, f"T={t} N={n} seed={seed}")


def _kinds(packed, t):
    return packed[:t].tolist()


def test_ready_stop():
    """The job crosses readiness mid-scan: the rest SKIP."""
    a = random_case(1, 64, 8, n_valid=8)
    a.update(node_ok=np.ones(64, bool), pred_mask=np.ones((8, 64), bool),
             max_task_num=np.full(64, 100, np.int32),
             idle=np.full((64, 3), 1e5, f32), min_available=3,
             init_allocated=0)
    packed = assert_scan_equal(a, True, "ready-stop")
    assert _kinds(packed, 8) == [1, 1, 1, 0, 0, 0, 0, 0]
    assert packed[16] == 1                         # became ready


def test_fail_stop():
    """A task no node fits fails the job: the rest SKIP."""
    a = random_case(2, 64, 8, n_valid=8)
    a.update(node_ok=np.ones(64, bool), pred_mask=np.ones((8, 64), bool),
             max_task_num=np.full(64, 100, np.int32),
             idle=np.full((64, 3), 5000.0, f32),
             releasing=np.zeros((64, 3), f32),
             backfilled=np.zeros((64, 3), f32), min_available=8)
    a["init_resreq"][2] = [1e6, 1.0, 0.0]
    packed = assert_scan_equal(a, True, "fail-stop")
    assert _kinds(packed, 8) == [1, 1, 4, 0, 0, 0, 0, 0]
    assert packed[16] == 0


def test_pipeline_and_over_backfill():
    """Idle too small: the launch request fits releasing on some nodes
    (PIPELINE) and idle + backfilled on others (ALLOC_OB)."""
    a = random_case(3, 8, 8, n_valid=8)
    a.update(node_ok=np.ones(8, bool), pred_mask=np.ones((8, 8), bool),
             max_task_num=np.full(8, 100, np.int32),
             idle=np.full((8, 3), 50.0, f32), min_available=100,
             scores=np.zeros((8, 8), f32))
    a["releasing"] = np.zeros((8, 3), f32)
    a["backfilled"] = np.zeros((8, 3), f32)
    a["releasing"][:4] = 1e5
    a["backfilled"][4:] = 1e5
    a["scores"][:, 4:] = 1.0                       # backfilled nodes first
    packed = assert_scan_equal(a, False, "pipe/ob")
    assert set(_kinds(packed, 8)) == {2}
    a["scores"][:] = 0.0
    a["scores"][:, :4] = 1.0                       # releasing nodes first
    packed = assert_scan_equal(a, False, "pipe/ob")
    assert set(_kinds(packed, 8)) == {3}


def test_all_masked_row_fails_at_node_zero():
    a = random_case(4, 64, 8, n_valid=8)
    a["pred_mask"][0] = False
    packed = assert_scan_equal(a, True, "all-masked")
    assert packed[0] == 4 and packed[8] == 0       # FAIL at node 0


def test_padded_tasks_skip():
    a = random_case(5, 64, 33, n_valid=5)
    a["min_available"] = 100
    packed = assert_scan_equal(a, True, "padding")
    assert set(_kinds(packed, 33)[5:]) == {0}


def test_negative_zero_ties_and_rows():
    """-0.0 and 0.0 scores tie (the lowest index wins); -0.0 idle rows
    stay -0.0 (x - 0 is x), -0.0 nonzero sums become +0.0 (the
    reference adds zero to every row)."""
    a = random_case(6, 64, 8, n_valid=8)
    a.update(node_ok=np.ones(64, bool), pred_mask=np.ones((8, 64), bool),
             max_task_num=np.full(64, 100, np.int32), min_available=100)
    a["scores"][:] = np.where(np.arange(64) % 2 == 0, f32(0.0),
                              f32(-0.0))[None]
    a["idle"][:] = 1e5
    a["idle"][10:20, 2] = -0.0
    a["nz_req"][30:40] = -0.0
    packed = assert_scan_equal(a, False, "-0.0")
    assert _kinds(packed, 8) == [1] * 8
    assert packed[8:16].tolist() == [0] * 8        # the lowest index
    a["scores"][:, 0] = -0.0
    assert_scan_equal(a, True, "-0.0 dyn")


def _single_task(n: int):
    """A one-task scan on n nodes, everything roomy and eligible."""
    return {
        "idle": np.full((n, 3), 1e5, f32), "releasing": np.zeros((n, 3), f32),
        "backfilled": np.zeros((n, 3), f32),
        "allocatable_cm": np.full((n, 2), 8000.0, f32),
        "nz_req": np.zeros((n, 2), f32),
        "max_task_num": np.full(n, 10, np.int32),
        "n_tasks": np.zeros(n, np.int32), "node_ok": np.ones(n, bool),
        "resreq": np.array([[100.0, 100.0, 0.0]], f32),
        "init_resreq": np.array([[100.0, 100.0, 0.0]], f32),
        "task_nz": np.array([[100.0, 100.0]], f32),
        "task_valid": np.ones(1, bool), "scores": np.zeros((1, n), f32),
        "pred_mask": np.ones((1, n), bool), "min_available": 1,
        "init_allocated": 0, "dyn_weights": np.array([1.0, 1.0], f32)}


def test_fit_association_at_ulp_edges():
    """init_resreq placed between (idle + backfilled) + eps and
    idle + (backfilled + eps): the reference sums idle and backfilled
    first. Cases on both sides of the difference."""
    rng = np.random.default_rng(7)
    hits = {True: 0, False: 0}
    while min(hits.values()) < 3:
        i, b = f32(rng.uniform(100, 4000)), f32(rng.uniform(0.001, 3))
        a1 = f32(f32(i + b) + EPS[0])
        a2 = f32(i + f32(b + EPS[0]))
        if a1 == a2:
            continue
        a = _single_task(8)
        a["idle"][:, 0] = i
        a["backfilled"][:, 0] = b
        a["init_resreq"][0, 0] = max(a1, a2)
        packed = assert_scan_equal(a, False, "fit edge")
        fits = bool(packed[0] in (1, 2))
        assert fits == (a1 >= a2)                  # (idle + back) + eps
        hits[fits] += 1


def _dyn_terms(nz, t_nz, cap):
    least, bal = _least_balanced(torch.from_numpy(nz), torch.from_numpy(t_nz),
                                 torch.from_numpy(cap))
    return least.numpy(), bal.numpy()


def _two_node_case(cap, nz, static0, w):
    """Node 0 has no allocatable (its dynamic score is 0) and the static
    score ``static0``; node 1 the given allocatable and nonzero sums and
    no static score."""
    a = _single_task(2)
    a["dyn_weights"] = np.asarray(w, f32)
    a["allocatable_cm"][0] = 0.0
    a["allocatable_cm"][1] = cap
    a["nz_req"][1] = nz
    a["scores"][0, 0] = static0
    return a


def _balanced_edges():
    """float32 differences d between the two request fractions for which
    trunc(10 - d * 10) differs between the two-rounding and the FMA
    evaluation: d * 10 just above an integer k rounds down to k, while
    the FMA keeps the excess and lands 10 - d * 10 just below 10 - k
    (three such d within 8 ulps above 0.1, 0.2, ..., 0.9)."""
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


def test_balanced_fma_edge():
    """Nodes whose balanced score differs between 10 - diff * 10 rounded
    twice and the one FMA the reference's compiled scan evaluates (node
    1: allocatable 1.0, so the fractions are its nonzero sums). Node 0
    carries the smaller of the two totals as a static score, so the
    argmax picks node 0 or node 1 by which one the scan computes."""
    edges = _balanced_edges()
    assert len(edges) >= 3
    t_nz = np.zeros(2, f32)
    cap = np.ones(2, f32)
    for d in edges:
        nz = np.array([d, 0.0], f32)
        least, bal = _dyn_terms(nz[None], t_nz, cap[None])
        two = np.trunc(f32(10.0) - d * f32(10.0))
        assert bal[0] != two                       # the FMA's value
        a = _two_node_case(cap, nz, least[0] + min(two, bal[0]), (1.0, 1.0))
        a["task_nz"][:] = 0.0
        packed = assert_scan_equal(a, True, "balanced fma")
        assert packed[1] == (1 if bal[0] > two else 0)


def test_weighted_sum_fma_edge():
    """Fractional nodeorder weights where fma(balanced, w1, least * w0)
    differs from the two rounded products' sum; node 0 carries the
    smaller total as a static score (see test_balanced_fma_edge)."""
    rng = np.random.default_rng(9)
    cap = np.array([6000.0, 7000.0], f32)
    nz = np.array([1000.0, 3000.0], f32)
    t_nz = np.array([100.0, 100.0], f32)
    least, bal = _dyn_terms(nz[None], t_nz, cap[None])
    l, b = np.float64(least[0]), np.float64(bal[0])
    assert l > 0 and b > 0
    w = rng.uniform(0.1, 3.0, (5000, 2)).astype(f32)
    lw = (l * w[:, 0].astype(np.float64)).astype(f32)
    bw = b * w[:, 1].astype(np.float64)
    fma = (bw + lw.astype(np.float64)).astype(f32)
    two = lw + bw.astype(f32)
    hits = np.nonzero(fma != two)[0][:4]
    assert len(hits) == 4
    for k in hits:
        a = _two_node_case(cap, nz, min(two[k], fma[k]), w[k])
        packed = assert_scan_equal(a, True, "weighted fma")
        assert packed[1] == (1 if fma[k] > two[k] else 0)


# ---------------------------------------------------------------------
# DeviceSession.solve_job
# ---------------------------------------------------------------------

@pytest.mark.parametrize("config", [2, REDUCED5], ids=["cfg2", "reduced5"])
def test_solve_job_matches_reference(config):
    """Every job of the cluster through solve_job in job order, one
    session per package: the decisions, the became-ready flags and the
    committed carry are the reference's."""
    j, t = Side(False, config), Side(True, config)
    jssn = JOpen(j.cache, j_tiers())
    tssn = TOpen(t.cache, t_tiers())
    jdev = j_solver.ensure_device_snapshot(jssn)
    tdev = t_solver.ensure_device_snapshot(tssn)

    def pending(ssn):
        return [tk for job in ssn.jobs.values()
                for tk in job.tasks.values()
                if tk.status.name == "PENDING" and not tk.resreq.is_empty()]

    jt = j_terms(jssn, jdev, pending(jssn))
    tt = t_terms(tssn, tdev, pending(tssn))
    visits = 0
    for uid in sorted(jssn.jobs):
        jtasks = sorted((tk for tk in jssn.jobs[uid].tasks.values()
                         if tk.status.name == "PENDING"),
                        key=lambda tk: tk.uid)
        ttasks = sorted((tk for tk in tssn.jobs[uid].tasks.values()
                         if tk.status.name == "PENDING"),
                        key=lambda tk: tk.uid)
        if not jtasks:
            continue
        jb, tb = JBatch.from_tasks(jtasks), TBatch.from_tasks(ttasks)
        mina = int(jssn.jobs[uid].min_available)
        js, jp = jt.matrices(jb)
        ts, tp = tt.matrices(tb)
        rb0 = t_metrics.blocking_readbacks()
        want = jdev.solve_job(jb, mina, 0, scores=js, pred_mask=jp,
                              dyn=jt.dynamic)
        got = tdev.solve_job(tb, mina, 0, scores=ts, pred_mask=tp,
                             dyn=tt.dynamic)
        assert t_metrics.blocking_readbacks() == rb0 + 1
        assert [tuple(d) for d in got[0]] == [tuple(d) for d in want[0]]
        assert got[1] == want[1]
        visits += 1
        for name in ("idle", "releasing", "n_tasks", "nz_req"):
            assert np.asarray(getattr(jdev, name)).tobytes() \
                == getattr(tdev, name).numpy().tobytes(), (uid, name)
    assert visits > 0
    JClose(jssn)
    TClose(tssn)


# ---------------------------------------------------------------------
# whole cycles
# ---------------------------------------------------------------------

class _Visits:
    """Counts solve_job calls on one DeviceSession class."""

    def __init__(self, monkeypatch, cls):
        self.n = 0
        inner = cls.solve_job

        def counted(dev, *a, **kw):
            self.n += 1
            return inner(dev, *a, **kw)

        monkeypatch.setattr(cls, "solve_job", counted)


def run_side(side: Side, mode: str, custom: bool):
    if side.torch_side:
        ssn = TOpen(side.cache, b8_tiers() if custom else t_tiers())
        TAllocate(mode=mode).execute(ssn)
        TClose(ssn)
        return t_allocate_mod.last_cycle_engine
    ssn = JOpen(side.cache, j_b8_tiers() if custom else j_tiers())
    JAllocate(mode=mode).execute(ssn)
    JClose(ssn)
    return j_allocate_mod.last_cycle_engine


CYCLE_CASES = [(2, "jax", False), (3, "jax", False), (REDUCED5, "jax", False),
               (2, "fused", True), (2, "batched", True),
               (REDUCED5, "fused", True), (REDUCED5, "batched", True)]
CYCLE_IDS = ["cfg2-jax", "cfg3-jax", "reduced5-jax", "cfg2-b8-fused",
             "cfg2-b8-batched", "reduced5-b8-fused", "reduced5-b8-batched"]


@pytest.mark.parametrize("config,mode,custom", CYCLE_CASES, ids=CYCLE_IDS)
def test_visit_cycles_match_reference(monkeypatch, config, mode, custom):
    """A whole cycle through the per-visit scan — asked for ("jax"), or
    the fused / batched engine refusing a custom job order — decides as
    the reference's: every task's status and node, the bind order, the
    engine label, the counted demotion, and one copy back per visit."""
    jv = _Visits(monkeypatch, j_solver.DeviceSession)
    tv = _Visits(monkeypatch, t_solver.DeviceSession)
    j, t = Side(False, config), Side(True, config)
    jrb0, trb0 = j_metrics.blocking_readbacks(), t_metrics.blocking_readbacks()
    jdem0 = j_metrics.engine_demotions_total()
    tdem0 = t_metrics.engine_demotions_total()
    j_engine = run_side(j, mode, custom)
    t_engine = run_side(t, mode, custom)
    assert t_engine == j_engine == f"{mode}-visit"
    assert t.binder.calls, "the cycle must bind"
    assert t.binder.calls == j.binder.calls
    assert t.task_states() == j.task_states()
    assert tv.n == jv.n > 0
    assert t_metrics.blocking_readbacks() - trb0 == tv.n
    assert j_metrics.blocking_readbacks() - jrb0 == jv.n
    assert t_metrics.engine_demotions_total() - tdem0 \
        == j_metrics.engine_demotions_total() - jdem0 == int(custom)


def test_visit_then_fused_churn_cycle(monkeypatch):
    """A jax-visit cold cycle, a kubelet tick and churn, then a fused
    cycle: the carry the visits committed never leaks (each session
    builds its own device state) and both packages agree throughout."""
    j, t = Side(False, REDUCED5), Side(True, REDUCED5)
    for mode in ("jax", "fused"):
        assert run_side(j, mode, False) == run_side(t, mode, False)
        assert t.binder.calls == j.binder.calls
        for side in (j, t):
            side.kubelet_tick()
            side.sim.churn_tick(side.cache, 16)
    assert t.task_states() == j.task_states()
