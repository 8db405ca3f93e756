"""The port's unschedulability explainer against the reference's, on the CPU.

Tolerance 0 throughout (the counts are integers):

- ``explain_counts_plain`` against the reference's jitted
  ``_explain_kernel`` on seeded random cases carried across by
  ``interop.explain_inputs_from_numpy``: T {1, 33, 300} x N {8, 64,
  1000}, padded task rows, ``has_ports`` off and on at PT 1 and 64, ties
  at ``resreq == idle``, every node cordoned, full slots, and port arrays
  that ``has_ports=False`` must ignore;
- the counts of ``failure_counts_device`` (the plain version on a CPU
  cache) against the reference's on freshly built 2p / 3p cycle inputs,
  and against the numpy host oracle there;
- ``explain_session`` snapshots (minus ``ts``) after whole cycles of the
  shipped policy through both packages' ``Scheduler(explain_unschedulable
  =True)`` on cfg2, 2p and 3p, and after hier / active-set cycles with the
  two-level threshold lowered;
- the reference's infeasible-mix cases: the reasons, the summary line,
  the off-by-default explainer and its one extra counted copy.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401
import kubebatch_tpu.plugins  # noqa: E402,F401
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.actions import allocate as j_allocate_mod  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.actions.cycle_inputs import \
    build_cycle_inputs as j_build_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import activeset as j_act  # noqa: E402
from kubebatch_tpu.obs import explain as j_explain  # noqa: E402
from kubebatch_tpu.obs import slo as j_slo  # noqa: E402
from kubebatch_tpu.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import obs as t_obs  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.actions.cycle_inputs import \
    build_cycle_inputs as t_build_inputs  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import activeset as t_act  # noqa: E402
from kubebatch_tpu_torch.obs import explain as t_explain  # noqa: E402
from kubebatch_tpu_torch.obs import slo as t_slo  # noqa: E402
from kubebatch_tpu_torch.runtime import Scheduler as TScheduler  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

GiB = 1024 ** 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_CONF = open(os.path.join(REPO, "config",
                                 "kube-batch-conf.yaml")).read()
_SETTINGS = ("KUBEBATCH_SOLVER", "KUBEBATCH_CYCLE_DEADLINE",
             "KUBEBATCH_AUDIT_EVERY", "KUBEBATCH_SUBCYCLE",
             "KUBEBATCH_PIPELINE", "KUBEBATCH_SLO", "KUBEBATCH_TIMELINE_DIR",
             "KUBEBATCH_FAULTS", "KUBEBATCH_VICTIM_SOLVER",
             "KUBEBATCH_RESERVED_BACKFILL")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Reference settings cleared, injection and the ladders reset, and
    every piece of process-wide explainer / SLO state put back after."""
    for name in _SETTINGS:
        monkeypatch.delenv(name, raising=False)
    for mod in (t_faults, j_faults):
        mod.reset()
        monkeypatch.setattr(mod.LADDER, "probe", lambda: True)
    yield
    for mod in (t_faults, j_faults):
        mod.reset()
    for mod in (t_slo, j_slo):
        mod.disarm()
    for mod in (t_explain, j_explain):
        mod.set_latest(None)
    j_act.reset()
    j_act._audit_every = None
    t_act.reset()
    t_act.set_audit_every(t_act.DEFAULT_AUDIT_EVERY)


# ---- the counts: plain version vs the reference's jitted kernel ----------

def _case(t, n, pt, seed, kind="random"):
    """Seeded explainer arguments: requests and idle drawn from one small
    grid (ties at resreq == idle are common), a fifth of the nodes
    cordoned or padded, some at their pod cap, a quarter of the task rows
    padded."""
    rng = np.random.default_rng(seed)
    grid = np.asarray([0.0, 250.0, 500.0, 1000.0, 2048.0], np.float32)
    s = 4
    a = {
        "idle": rng.choice(grid, (n, 3)).astype(np.float32),
        "node_ok": rng.random(n) < 0.8,
        "n_tasks": rng.integers(0, 6, n).astype(np.int32),
        "max_task_num": rng.integers(1, 6, n).astype(np.int32),
        "sig_pred": rng.random((s, n)) < 0.7,
        "task_sig": rng.integers(0, s, t).astype(np.int32),
        "task_valid": np.arange(t) < max(1, (3 * t) // 4),
        "resreq": rng.choice(grid, (t, 3)).astype(np.float32),
        "task_ports": rng.random((t, pt)) < 0.15,
        "port_base": rng.random((n, pt)) < 0.15,
    }
    if kind == "cordoned":
        a["node_ok"][:] = False
    elif kind == "full-slots":
        a["max_task_num"] = a["n_tasks"].copy()
    elif kind == "ties":
        # every request equals some node's idle exactly, -0.0 included
        a["idle"][0] = -0.0
        a["resreq"][:] = a["idle"][rng.integers(0, n, t)]
    return a


def _check_plain(a, has_ports):
    ref = np.asarray(j_explain._explain_kernel(
        *(jnp.asarray(a[k]) for k, _ in t_explain.ARG_DTYPES),
        has_ports=has_ports))
    got = t_explain.explain_counts_plain(
        **interop.explain_inputs_from_numpy(a, "cpu"), has_ports=has_ports)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    return ref


@pytest.mark.parametrize("ports", [(False, 1), (True, 1), (True, 64)],
                         ids=["no_ports", "pt1", "pt64"])
@pytest.mark.parametrize("n", [8, 64, 1000])
@pytest.mark.parametrize("t", [1, 33, 300])
def test_plain_counts_match_reference_kernel(t, n, ports):
    has_ports, pt = ports
    ref = _check_plain(_case(t, n, pt, seed=t * 7919 + n * 31 + pt),
                       has_ports)
    valid = np.arange(t) < max(1, (3 * t) // 4)
    assert (ref[~valid, :5] == 0).all()
    if not has_ports:
        assert (ref[:, 3] == 0).all()


@pytest.mark.parametrize("kind", ["cordoned", "full-slots", "ties"])
def test_plain_counts_edge_cases(kind):
    a = _case(33, 64, 12, seed=5, kind=kind)
    ref = _check_plain(a, True)
    valid = a["task_valid"]
    if kind == "cordoned":
        assert (ref[:, 5] == 0).all() and (ref[:, :5] == 0).all()
    elif kind == "full-slots":
        assert (ref[valid, 2] == ref[valid, 5]).all()
        assert (ref[:, 4] == 0).all()
    else:
        assert (ref[valid, 4] > 0).any()


def test_has_ports_false_ignores_the_port_arrays():
    a = _case(33, 64, 64, seed=9)
    a["task_ports"][:] = True
    a["port_base"][:] = True
    ref = _check_plain(a, False)
    assert (ref[:, 3] == 0).all() and (ref[a["task_valid"], 4] > 0).any()


# ---- on a shipped configuration's freshly built cycle inputs -------------

class _Binder:
    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((f"{pod.namespace}/{pod.name}", hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        pod.deletion_timestamp = 1.0


def _caches(config):
    """(reference, port) incremental caches populated from one spec."""
    out = []
    for torch_side in (False, True):
        binder = _Binder()
        if torch_side:
            sim = t_build(T_SPECS[config])
            cache = TCache(binder=binder, evictor=binder,
                           async_writeback=False, device="cpu")
        else:
            sim = j_build(J_SPECS[config])
            cache = JCache(binder=binder, evictor=binder,
                           async_writeback=False)
        sim.populate(cache)
        out.append((sim, cache, binder))
    return out


@pytest.mark.parametrize("config", ["2p", "3p"])
def test_fresh_inputs_counts_match_reference(config):
    """On freshly built inputs the port's device pass (the plain version
    on a CPU cache, one counted copy) equals the reference's device pass
    and both host oracles; the folded snapshots agree too."""
    (_, jc, _), (_, tc, _) = _caches(config)
    jssn, tssn = JOpen(jc, j_tiers()), TOpen(tc, t_tiers())
    ji = j_build_inputs(jssn, allow_affinity=True)
    ti = t_build_inputs(tssn, allow_affinity=True)
    assert ji.affinity is not None and ti.affinity is not None
    rb0 = t_metrics.blocking_readbacks()
    got = t_explain.failure_counts_device(ti)
    assert t_metrics.blocking_readbacks() - rb0 == 1
    want = j_explain.failure_counts_device(ji)
    for w, g, h in zip(want, got, t_explain.failure_counts_host(ti)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        np.testing.assert_array_equal(np.asarray(h), np.asarray(w))
    snaps = [mod.fold_reasons(i, *c) for mod, i, c in
             ((j_explain, ji, want), (t_explain, ti, got))]
    for s in snaps:
        s.pop("ts")
    assert snaps[0] == snaps[1]
    JClose(jssn)
    TClose(tssn)


# ---- whole cycles: the published snapshots --------------------------------

def _kubelet(sim, cache):
    for pod in list(sim.pods):
        if pod.node_name and pod.phase.name != "RUNNING":
            pod.phase = type(pod.phase).RUNNING
            cache.update_pod(pod, pod)


def _latest(mod):
    snap = dict(mod.latest())
    snap.pop("ts")
    return snap


@pytest.mark.parametrize("config,churn", [(2, 64), ("2p", 0), ("3p", 0)],
                         ids=["cfg2", "2p", "3p"])
def test_scheduler_snapshots_match_reference(config, churn):
    """Both packages' Scheduler(explain_unschedulable=True, slo=True) on
    the shipped policy: after each period the published snapshot equals
    the reference's, and the cycle's binds are the reference's."""
    sides = _caches(config)
    scheds = [JScheduler(sides[0][1], SHIPPED_CONF,
                         explain_unschedulable=True, slo=True),
              TScheduler(sides[1][1], SHIPPED_CONF,
                         explain_unschedulable=True, slo=True)]
    for period in range(2 if churn else 1):
        for (sim, cache, _), sched in zip(sides, scheds):
            if period:
                _kubelet(sim, cache)
                assert sim.churn_tick(cache, churn) > 0
            assert sched.run_cycle() is True
        assert sides[1][2].calls == sides[0][2].calls
        snap = _latest(t_explain)
        assert snap == _latest(j_explain)
        assert "error" not in snap
        assert snap["pending_tasks"] >= snap["unschedulable_tasks"]
    assert t_slo.armed() and j_slo.armed()


#: 40 nodes, 12 gangs x 4 in two queues, oversubscribed on cpu
SMALL = dict(n_nodes=40, n_groups=12, pods_per_group=4, n_queues=2,
             queue_weights=(1, 2), pod_cpu_millis=6000,
             pod_mem_bytes=6 * GiB, jitter=0.2, seed=5)


def test_scale_engine_snapshots_match_reference(monkeypatch):
    """With the two-level threshold lowered: a cold "hier" cycle, then a
    churn cycle in auto (the active set), each followed by
    explain_session on the still-open session; the snapshots and the
    engines equal the reference's."""
    monkeypatch.setattr(t_allocate_mod, "AUTO_HIER_MIN_NODES", 16)
    monkeypatch.setattr(j_allocate_mod, "AUTO_HIER_MIN_NODES", 16)
    j_act.set_audit_every(0)
    t_act.set_audit_every(0)
    sides = []
    for build, cache_cls, spec_cls, kw in (
            (j_build, JCache, JSpec, {}),
            (t_build, TCache, TSpec, {"device": "cpu"})):
        binder = _Binder()
        sim = build(spec_cls(**SMALL))
        cache = cache_cls(binder=binder, async_writeback=False, **kw)
        sim.populate(cache)
        sides.append((sim, cache, binder))
    trace = {False: [], True: []}
    for k, mode in enumerate(("hier", "auto")):
        for torch_side, (sim, cache, _) in enumerate(sides):
            if k:
                _kubelet(sim, cache)
                assert sim.churn_tick(cache, 8, arrival_queue=k % 2) > 0
            if torch_side:
                ssn = TOpen(cache, t_tiers())
                TAllocate(mode=mode).execute(ssn)
                snap = t_explain.explain_session(ssn)
                TClose(ssn)
                engine = t_allocate_mod.last_cycle_engine
            else:
                ssn = JOpen(cache, j_tiers())
                JAllocate(mode=mode).execute(ssn)
                snap = j_explain.explain_session(ssn)
                JClose(ssn)
                engine = j_allocate_mod.last_cycle_engine
            snap = dict(snap)
            snap.pop("ts")
            trace[bool(torch_side)].append((engine, snap))
        assert sides[1][2].calls == sides[0][2].calls
    assert trace[True] == trace[False]
    assert [e for e, _ in trace[True]] == ["hier", "activeset"]
    assert all(s["unschedulable_tasks"] > 0 for _, s in trace[True])


# ---- the reference's infeasible-mix cases ---------------------------------

def _infeasible_cache(torch_side):
    """2 nodes, one cordoned; one pod that fits, a gang of three that fit
    nowhere."""
    m = t_objects if torch_side else j_objects
    binder = _Binder()
    cache = (TCache(binder=binder, async_writeback=False, device="cpu")
             if torch_side else JCache(binder=binder, async_writeback=False))

    def rl(cpu, mem, pods=0):
        return m.resource_list(cpu=cpu, memory=mem, pods=pods)

    cache.add_queue(m.Queue(name="q", weight=1))
    for name, cordoned in (("n0", False), ("n1", True)):
        alloc = rl(4000, 8 * GiB, pods=10)
        cache.add_node(m.Node(name=name, allocatable=dict(alloc),
                              capacity=dict(alloc), unschedulable=cordoned))
    for group in ("fits", "huge"):
        cache.add_pod_group(m.PodGroup(name=group, namespace="ns",
                                       min_member=1, queue="q"))

    def pod(name, req, group):
        return m.Pod(uid=f"ns-{name}", name=name, namespace="ns",
                     phase=m.PodPhase.PENDING,
                     containers=[m.Container(requests=dict(req))],
                     annotations={m.GROUP_NAME_ANNOTATION: group})

    cache.add_pod(pod("ok-0", rl(500, GiB), "fits"))
    for i in range(3):
        cache.add_pod(pod(f"huge-{i}", rl(64000, 64 * GiB), "huge"))
    return cache


def test_infeasible_mix_reasons_match_reference():
    snaps = []
    for torch_side, (mod, opn, close, tiers) in enumerate((
            (j_explain, JOpen, JClose, j_tiers),
            (t_explain, TOpen, TClose, t_tiers))):
        ssn = opn(_infeasible_cache(bool(torch_side)), tiers())
        snap = mod.explain_session(ssn)
        close(ssn)
        assert mod.latest() is snap
        lines = mod.summarize(snap)
        snap = dict(snap)
        snap.pop("ts")
        snaps.append((snap, lines))
    assert snaps[0] == snaps[1]
    snap, lines = snaps[1]
    assert snap["pending_tasks"] == 4 and snap["unschedulable_tasks"] == 3
    assert snap["candidate_nodes"] == 1
    huge = next(r for r in snap["jobs"] if r["job"] == "ns/huge")
    assert huge["reasons"] == {"resources": 3}
    assert any("3 tasks failed resources on all candidate nodes" in ln
               for ln in lines), lines


def test_explainer_off_by_default_and_one_extra_copy():
    """Off, a cycle publishes nothing; on, the same cycle makes exactly
    one more counted copy and an "explain" span — in both packages."""
    out = []
    for torch_side, (sched_cls, mod, met, obs_mod) in enumerate((
            (JScheduler, j_explain, j_metrics, None),
            (TScheduler, t_explain, t_metrics, t_obs))):
        if obs_mod is None:
            from kubebatch_tpu import obs as obs_mod
        base = sched_cls(_infeasible_cache(bool(torch_side)),
                         schedule_period=0.01)
        rb0 = met.blocking_readbacks()
        assert base.run_cycle()
        plain = met.blocking_readbacks() - rb0
        assert mod.latest() is None
        on = sched_cls(_infeasible_cache(bool(torch_side)),
                       schedule_period=0.01, explain_unschedulable=True)
        rb1 = met.blocking_readbacks()
        assert on.run_cycle()
        out.append((met.blocking_readbacks() - rb1 - plain,
                    mod.latest()["unschedulable_tasks"],
                    obs_mod.last_cycle().find("explain") is not None))
    assert out[0] == out[1] == (1, 3, True)


def test_over_vocabulary_and_empty_cycles_publish_the_reference_snapshot(
        monkeypatch):
    """An empty pending set and an inputs build refused (None) give the
    reference's own snapshots, with no launch and no copy."""
    from kubebatch_tpu_torch.actions import cycle_inputs as t_ci
    cache = _infeasible_cache(True)
    ssn = TOpen(cache, t_tiers())
    monkeypatch.setattr(t_ci, "build_cycle_inputs",
                        lambda s, allow_affinity: None)
    rb0 = t_metrics.blocking_readbacks()
    snap = t_explain.explain_session(ssn)
    assert set(snap) == {"ts", "error"}
    monkeypatch.setattr(t_ci, "build_cycle_inputs",
                        lambda s, allow_affinity: t_ci.EMPTY_CYCLE)
    snap = t_explain.explain_session(ssn)
    assert snap["pending_tasks"] == 0 and snap["candidate_nodes"] == 2
    assert t_metrics.blocking_readbacks() == rb0
    TClose(ssn)
