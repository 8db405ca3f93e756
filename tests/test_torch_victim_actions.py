"""The port's reclaim, preempt and backfill actions against the reference.

Every scenario is built twice from one description — once in the
reference package's objects, once in the port's — into caches with
synchronous write-back and full snapshots (the port's on the CPU, where
the victim kernels run their plain versions). Both run the same actions;
every task's session status and node, the evictions and the binds must
be identical. Within the port, the device path is also held against its
``mode="host"`` oracle, and wave dispatch against per-visit dispatch.

The reference's scenarios come from tests/test_victims.py and
tests/test_preempt_reclaim.py (the non-affinity ones) and
tests/test_backfill.py; the four-action cycles run reduced forms of the
BASELINE cfg5 (cold, then two skewed churn cycles) and of a saturated
cfg4.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import functools  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.actions.backfill import BackfillAction as JBackfill  # noqa: E402
from kubebatch_tpu.actions.backfill import \
    reclaim_over_backfill as j_reclaim_over_backfill  # noqa: E402
from kubebatch_tpu.actions.preempt import PreemptAction as JPreempt  # noqa: E402
from kubebatch_tpu.actions.reclaim import ReclaimAction as JReclaim  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import PluginOption as JOpt  # noqa: E402
from kubebatch_tpu.conf import Tier as JTier  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.actions.backfill import BackfillAction as TBackfill  # noqa: E402
from kubebatch_tpu_torch.actions.backfill import \
    reclaim_over_backfill as t_reclaim_over_backfill  # noqa: E402
from kubebatch_tpu_torch.actions.preempt import PreemptAction as TPreempt  # noqa: E402
from kubebatch_tpu_torch.actions.reclaim import ReclaimAction as TReclaim  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import PluginOption as TOpt  # noqa: E402
from kubebatch_tpu_torch.conf import Tier as TTier  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import _build  # noqa: E402
from kubebatch_tpu_torch.kernels import victims as tv  # noqa: E402
from kubebatch_tpu_torch.kernels.affinity import RAW_PAIR_LIMIT  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_victims import (J_WORLD, T_WORLD,  # noqa: E402
                                 contended_build)

GiB = 1024 ** 3


class Recorder:
    """Binder and evictor: records binds and evictions, and marks an
    evicted pod as deleting, as the reference's tests do."""

    def __init__(self):
        self.binds = {}
        self.evicted = []

    def bind(self, pod, hostname):
        self.binds[f"{pod.namespace}/{pod.name}"] = hostname
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        self.evicted.append(f"{pod.namespace}/{pod.name}")
        pod.deletion_timestamp = 1.0


def backfill_tiers(torch_side):
    opt, tier = (TOpt, TTier) if torch_side else (JOpt, JTier)
    return [tier(plugins=[opt(name="priority"), opt(name="gang")]),
            tier(plugins=[opt(name="drf"), opt(name="proportion")])]


class Side:
    """One package's cache (and, for sim worlds, its sim)."""

    def __init__(self, torch_side: bool, build=None, spec=None):
        self.torch_side = torch_side
        self.rec = Recorder()
        if torch_side:
            self.cache = TCache(binder=self.rec, evictor=self.rec,
                                async_writeback=False, device="cpu")
        else:
            self.cache = JCache(binder=self.rec, evictor=self.rec,
                                async_writeback=False,
                                incremental_snapshot=False)
        self.sim = None
        if spec is not None:
            self.sim = (t_build(TSpec(**vars(spec))) if torch_side
                        else j_build(JSpec(**vars(spec))))
            self.sim.populate(self.cache)
        if build is not None:
            build(self.cache, T_WORLD if torch_side else J_WORLD)

    def open(self, tiers=None):
        if tiers is None:
            tiers = t_tiers() if self.torch_side else j_tiers()
        return (TOpen if self.torch_side else JOpen)(self.cache, tiers)

    def close(self, ssn):
        (TClose if self.torch_side else JClose)(ssn)
        self.cache.drain(timeout=5.0)

    def kubelet_tick(self):
        """Bound pods start running (the sim has no kubelet)."""
        for pod in self.sim.pods:
            if pod.node_name and pod.phase.name != "RUNNING":
                pod.phase = type(pod.phase).RUNNING
                self.cache.update_pod(pod, pod)


def session_result(ssn):
    statuses, placed = {}, {}
    for job in ssn.jobs.values():
        for task in job.tasks.values():
            statuses[task.key] = task.status.name
            placed[task.key] = task.node_name
    return statuses, placed


def make_actions(names, torch_side, mode="device", alloc="host",
                 fastpath=True, reserved=False):
    out = []
    for n in names:
        if n == "reclaim":
            out.append(TReclaim(mode=mode, fastpath=fastpath)
                       if torch_side else JReclaim())
        elif n == "preempt":
            out.append(TPreempt(mode=mode) if torch_side
                       else JPreempt())
        elif n == "allocate":
            out.append(TAllocate(mode=alloc) if torch_side
                       else JAllocate(mode=alloc))
        elif n == "backfill":
            out.append(TBackfill(reserved=reserved) if torch_side
                       else JBackfill(reserved=reserved))
    return out


def run(build, names, torch_side, tiers=None, **kw):
    side = Side(torch_side, build)
    ssn = side.open(tiers(torch_side) if tiers else None)
    for act in make_actions(names, torch_side, **kw):
        act.execute(ssn)
    statuses, placed = session_result(ssn)
    side.close(ssn)
    return statuses, placed, sorted(side.rec.evicted), side.rec.binds


def assert_same(a, b, what):
    for k, name in enumerate(("statuses", "placements", "evictions",
                              "binds")):
        assert a[k] == b[k], f"{what}: {name} diverge"


def assert_equivalent(build, names, tiers=None, **kw):
    """Reference == port device path == port host oracle."""
    ref = run(build, names, False, tiers=tiers)
    dev = run(build, names, True, tiers=tiers, **kw)
    host = run(build, names, True, tiers=tiers, mode="host")
    assert_same(ref, dev, "port device vs reference")
    assert_same(ref, host, "port host vs reference")
    return dev


# ---------------------------------------------------------------------
# targeted scenarios (tests/test_victims.py, tests/test_preempt_reclaim.py)
# ---------------------------------------------------------------------

def _one_node(cpu=4000, mem=8 * GiB):
    def base(cache, w):
        cache.add_queue(w.queue("q1"))
        cache.add_node(w.node("n1", w.rl(cpu, mem, pods=110)))
    return base


def inter_job(cache, w):
    _one_node()(cache, w)
    cache.add_pod_group(w.group("ns", "low", 1, queue="q1"))
    for i in range(2):
        cache.add_pod(w.pod("ns", f"low-{i}", "n1", True, w.rl(2000, 4 * GiB),
                            group="low", priority=1))
    cache.add_pod_group(w.group("ns", "high", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "high-0", "", False, w.rl(2000, 4 * GiB),
                        group="high", priority=100))


def min_available_one_quirk(cache, w):
    _one_node(2000, 4 * GiB)(cache, w)
    cache.add_pod_group(w.group("ns", "solo", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "solo-0", "n1", True, w.rl(2000, 4 * GiB),
                        group="solo", priority=1))
    cache.add_pod_group(w.group("ns", "vip", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "vip-0", "", False, w.rl(2000, 4 * GiB),
                        group="vip", priority=100))


def conformance_critical(cache, w):
    _one_node(2000, 4 * GiB)(cache, w)
    cache.add_pod_group(w.group("ns", "crit", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "crit-0", "n1", True, w.rl(2000, 4 * GiB),
                        group="crit", priority=1,
                        priority_class_name="system-cluster-critical"))
    cache.add_pod_group(w.group("ns", "vip", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "vip-0", "", False, w.rl(2000, 4 * GiB),
                        group="vip", priority=100))


def kube_system_protected(cache, w):
    _one_node()(cache, w)
    cache.add_pod_group(w.group("kube-system", "sys", 1, queue="q1"))
    for i in range(2):
        cache.add_pod(w.pod("kube-system", f"sys-{i}", "n1", True,
                            w.rl(2000, 4 * GiB), group="sys", priority=1))
    cache.add_pod_group(w.group("ns", "high", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "high-0", "", False, w.rl(2000, 4 * GiB),
                        group="high", priority=100))


def gang_quorum(cache, w):
    _one_node()(cache, w)
    cache.add_pod_group(w.group("ns", "pair", 2, queue="q1"))
    for i in range(2):
        cache.add_pod(w.pod("ns", f"pair-{i}", "n1", True,
                            w.rl(2000, 4 * GiB), group="pair", priority=1))
    cache.add_pod_group(w.group("ns", "vip", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "vip-0", "", False, w.rl(2000, 4 * GiB),
                        group="vip", priority=100))


def spill_across_nodes(cache, w):
    cache.add_queue(w.queue("q1"))
    cache.add_node(w.node("n1", w.rl(5000, 8 * GiB, pods=110)))
    cache.add_node(w.node("n2", w.rl(4000, 8 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "wide", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "wide-0", "n1", True, w.rl(5000, 2 * GiB),
                        group="wide", priority=1))
    cache.add_pod_group(w.group("ns", "tall", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "tall-0", "n2", True, w.rl(4000, 6 * GiB),
                        group="tall", priority=1))
    cache.add_pod_group(w.group("ns", "vip", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "vip-0", "", False, w.rl(4000, 6 * GiB),
                        group="vip", priority=100))


def multiple_preemption(cache, w):
    _one_node()(cache, w)
    cache.add_pod_group(w.group("ns", "low", 1, queue="q1"))
    for i in range(2):
        cache.add_pod(w.pod("ns", f"low-{i}", "n1", True, w.rl(2000, 4 * GiB),
                            group="low", priority=1))
    cache.add_pod_group(w.group("ns", "big", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "big-0", "", False, w.rl(4000, 8 * GiB),
                        group="big", priority=100))


def statement_discard(cache, w):
    cache.add_queue(w.queue("q1"))
    cache.add_node(w.node("n1", w.rl(2000, 4 * GiB, pods=110)))
    cache.add_node(w.node("n2", w.rl(2000, 4 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "low", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "low-0", "n1", True, w.rl(2000, 4 * GiB),
                        group="low", priority=1))
    cache.add_pod_group(w.group("ns", "solid", 2, queue="q1"))
    cache.add_pod(w.pod("ns", "solid-0", "n2", True, w.rl(2000, 4 * GiB),
                        group="solid", priority=1))
    cache.add_pod(w.pod("ns", "solid-1", "n1", True, w.rl(10, 1024 ** 2),
                        group="solid", priority=1))
    cache.add_pod_group(w.group("ns", "high", 2, queue="q1"))
    for i in range(2):
        cache.add_pod(w.pod("ns", f"high-{i}", "", False,
                            w.rl(2000, 4 * GiB), group="high", priority=100))


def _two_queues(victim_min, victim_count, victim_req, newb_req):
    def build(cache, w):
        cache.add_queue(w.queue("q1", 1))
        cache.add_queue(w.queue("q2", 1))
        cache.add_node(w.node("n1", w.rl(4000, 8 * GiB, pods=110)))
        cache.add_pod_group(w.group("ns", "hog", victim_min, queue="q1"))
        for i in range(victim_count):
            cache.add_pod(w.pod("ns", f"hog-{i}", "n1", True,
                                w.rl(*victim_req), group="hog"))
        cache.add_pod_group(w.group("ns", "newb", 1, queue="q2"))
        cache.add_pod(w.pod("ns", "newb-0", "", False, w.rl(*newb_req),
                            group="newb"))
    return build


def reclaim_cross_queue(cache, w):
    cache.add_queue(w.queue("qa", weight=1))
    cache.add_queue(w.queue("qb", weight=1))
    cache.add_node(w.node("n1", w.rl(4000, 8 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "hog", 1, queue="qa"))
    for i in range(4):
        cache.add_pod(w.pod("ns", f"hog-{i}", "n1", True, w.rl(1000, 2 * GiB),
                            group="hog", priority=1))
    cache.add_pod_group(w.group("ns", "newb", 1, queue="qb"))
    cache.add_pod(w.pod("ns", "newb-0", "", False, w.rl(1000, 2 * GiB),
                        group="newb", priority=1))


def mixed_two_queue(cache, w):
    cache.add_queue(w.queue("qa", weight=1))
    cache.add_queue(w.queue("qb", weight=3))
    for n in range(3):
        cache.add_node(w.node(f"n{n}", w.rl(4000, 8 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "old", 1, queue="qa"))
    for i in range(5):
        cache.add_pod(w.pod("ns", f"old-{i}", f"n{i % 3}", True,
                            w.rl(2000, 4 * GiB), group="old", priority=10))
    cache.add_pod_group(w.group("ns", "gang", 2, queue="qb"))
    for i in range(3):
        cache.add_pod(w.pod("ns", f"gang-{i}", "", False, w.rl(2000, 4 * GiB),
                            group="gang", priority=100))


def jobless_queue(cache, w):
    for q in ("q1", "q2", "q-empty"):
        cache.add_queue(w.queue(q))
    cache.add_node(w.node("n0", w.rl(4000, 8 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "hog", 1, queue="q1"))
    for i in range(4):
        cache.add_pod(w.pod("ns", f"hog-{i}", "n0", True, w.rl(1000, 2 * GiB),
                            group="hog"))
    cache.add_pod_group(w.group("ns", "want", 1, queue="q2"))
    cache.add_pod(w.pod("ns", "want-0", "", False, w.rl(1000, 2 * GiB),
                        group="want"))


def overused_queues(cache, w):
    cache.add_queue(w.queue("q1", 1))
    cache.add_queue(w.queue("q2", 1))
    cache.add_node(w.node("n1", w.rl(4000, 8 * GiB, pods=110)))
    for q in ("q1", "q2"):
        cache.add_pod_group(w.group("ns", f"run-{q}", 1, queue=q))
        for i in range(2):
            cache.add_pod(w.pod("ns", f"run-{q}-{i}", "n1", True,
                                w.rl(1000, 2 * GiB), group=f"run-{q}"))
    cache.add_pod_group(w.group("ns", "newb", 1, queue="q2"))
    cache.add_pod(w.pod("ns", "newb-0", "", False, w.rl(1000, 2 * GiB),
                        group="newb"))


PREEMPT = ("preempt",)
ALLOC_PREEMPT = ("allocate", "preempt")
RECLAIM = ("reclaim",)
CYCLE = ("reclaim", "allocate", "preempt")

#: name -> (world, actions, what it must show: the reference tests' own
#: assertions over (statuses, evictions))
SCENARIOS = {
    "inter_job": (inter_job, ALLOC_PREEMPT, lambda s, ev: (
        s["ns/high-0"] == "PIPELINED" and len(ev) == 1)),
    "min_available_one_quirk": (min_available_one_quirk, PREEMPT,
                                lambda s, ev: ev == ["ns/solo-0"]),
    "conformance_critical": (conformance_critical, PREEMPT,
                             lambda s, ev: (ev == [] and
                                            s["ns/vip-0"] == "PENDING")),
    "kube_system_protected": (kube_system_protected, ALLOC_PREEMPT,
                              lambda s, ev: ev == []),
    "gang_quorum_falls_through_to_drf": (gang_quorum, PREEMPT,
                                         lambda s, ev: len(ev) == 1),
    "spill_across_nodes": (spill_across_nodes, PREEMPT,
                           lambda s, ev: s["ns/vip-0"] == "PIPELINED"),
    "multiple_preemption": (multiple_preemption, ALLOC_PREEMPT,
                            lambda s, ev: ev == ["ns/low-0", "ns/low-1"]),
    "statement_discard": (statement_discard, PREEMPT,
                          lambda s, ev: (ev == [] and
                                         s["ns/low-0"] == "RUNNING")),
    "reclaim_cross_queue": (reclaim_cross_queue, RECLAIM,
                            lambda s, ev: s["ns/newb-0"] == "PIPELINED"),
    "reclaim_to_fair_share": (
        _two_queues(1, 2, (2000, 4 * GiB), (2000, 4 * GiB)), RECLAIM,
        lambda s, ev: ev == ["ns/hog-0"]),
    "reclaim_deserved_floor": (
        _two_queues(2, 2, (1000, 2 * GiB), (2000, 4 * GiB)), RECLAIM,
        lambda s, ev: ev == []),
    "reclaim_min1_quirk": (
        _two_queues(1, 1, (2000, 4 * GiB), (2000, 4 * GiB)), RECLAIM,
        lambda s, ev: ev == ["ns/hog-0"]),
    "reclaim_all_queues_overused": (overused_queues, RECLAIM,
                                    lambda s, ev: ev == []),
    "reclaim_jobless_queue": (jobless_queue, RECLAIM,
                              lambda s, ev: len(ev) >= 1),
    "mixed_two_queue_cycle": (mixed_two_queue, CYCLE, lambda s, ev: True),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scenario_matches_reference(name):
    build, names, expect = SCENARIOS[name]
    statuses, _, evicted, _ = assert_equivalent(build, names)
    assert expect(statuses, evicted)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_randomized_cycle_matches_reference(seed):
    """tests/test_victims.py's seeded sweep: reclaim + allocate + preempt
    on random clusters."""
    rng = np.random.default_rng(seed)
    n_nodes = int(rng.integers(3, 8))
    n_queues = int(rng.integers(1, 4))
    caps = [(int(rng.integers(2, 6)) * 1000, int(rng.integers(4, 12)) * GiB)
            for _ in range(n_nodes)]
    fills = [(f"fill-{i}", int(rng.integers(0, n_nodes)),
              int(rng.integers(1, 3)) * 500, int(rng.integers(1, 4)) * GiB,
              int(rng.integers(0, n_queues)), int(rng.integers(1, 20)))
             for i in range(int(rng.integers(3, 10)))]
    gangs = []
    for g in range(int(rng.integers(1, 4))):
        size = int(rng.integers(1, 4))
        gangs.append((f"gang-{g}", size, max(1, size - 1),
                      int(rng.integers(1, 3)) * 500,
                      int(rng.integers(1, 4)) * GiB,
                      int(rng.integers(0, n_queues)),
                      int(rng.integers(50, 200))))

    def build(cache, w):
        for q in range(n_queues):
            cache.add_queue(w.queue(f"q{q}", weight=q + 1))
        for i, (cpu, mem) in enumerate(caps):
            cache.add_node(w.node(f"n{i}", w.rl(cpu, mem, pods=20)))
        for name, node, cpu, mem, q, pri in fills:
            cache.add_pod_group(w.group("ns", name, 1, queue=f"q{q}"))
            cache.add_pod(w.pod("ns", f"{name}-0", f"n{node}", True,
                                w.rl(cpu, mem), group=name, priority=pri))
        for name, size, minav, cpu, mem, q, pri in gangs:
            cache.add_pod_group(w.group("ns", name, minav, queue=f"q{q}"))
            for i in range(size):
                cache.add_pod(w.pod("ns", f"{name}-{i}", "", False,
                                    w.rl(cpu, mem), group=name,
                                    priority=pri))

    assert_equivalent(build, CYCLE)


@pytest.mark.parametrize("seed", [3, 17, 41])
def test_contended_cycle_matches_reference(seed, monkeypatch):
    """The contended worlds of tests/test_victims.py: the reference, the
    port's wave path, its per-visit path (solvers built with
    ``VictimSolver(wave=False)``) and its host oracle agree."""
    build = contended_build(seed)
    ref = run(build, CYCLE, False)
    wave = run(build, CYCLE, True)
    with monkeypatch.context() as m:
        m.setattr(tv, "VictimSolver",
                  functools.partial(tv.VictimSolver, wave=False))
        solvers = _probe_solvers(m)
        visit = run(build, CYCLE, True)
    assert solvers and all(s.dispatch_kinds["visit"] == s.dispatches
                           for s in solvers)
    assert any(s.dispatches for s in solvers)
    host = run(build, CYCLE, True, mode="host")
    assert_same(ref, wave, "wave vs reference")
    assert_same(wave, visit, "wave vs per-visit")
    assert_same(ref, host, "host vs reference")
    assert ref[2], "the contended world must evict"


def _probe_solvers(monkeypatch):
    """Record every solver the actions build."""
    solvers = []
    inner = tv._build_victim_solver

    def probe(*a, **k):
        solver, reason = inner(*a, **k)
        if solver is not None:
            solvers.append(solver)
        return solver, reason

    monkeypatch.setattr(tv, "_build_victim_solver", probe)
    return solvers


def test_device_policy_waves_from_first_visit(monkeypatch):
    """Every device takes the reference's accelerator branch: waves from
    the first visit, sized to the pending set (64 to 512 lanes), and the
    launches and the counted copies move together."""
    solvers = _probe_solvers(monkeypatch)
    side = Side(True, contended_build(11, n_gangs=20))
    ssn = side.open()
    rb0 = t_metrics.blocking_readbacks()
    _build.reset_launch_counts()
    TPreempt().execute(ssn)
    side.close(ssn)
    assert solvers
    for s in solvers:
        assert s.dispatch_kinds["visit"] == 0
        assert s._wave_size == min(512, max(
            64, tv.pad_to_bucket(len(s.pending), 64)))
    dispatches = sum(s.dispatches for s in solvers)
    assert dispatches > 0
    assert t_metrics.blocking_readbacks() - rb0 == dispatches
    # CPU tensors: the plain versions ran, no kernel launched
    assert _build.launch_count("victim_wave") == 0


def test_reclaim_prefetch_single_dispatch(monkeypatch):
    """tests/test_victims.py's steady-regime property: a reclaim cycle
    whose visits all fail resolves from EXACTLY ONE wave (the prefetch)."""
    def build(cache, w):
        for q in range(3):
            cache.add_queue(w.queue(f"q{q}", weight=1))
            cache.add_node(w.node(f"n{q}", w.rl(4000, 8 * GiB, pods=20)))
            fill = f"fill-{q}"
            cache.add_pod_group(w.group("ns", fill, 2, queue=f"q{q}"))
            for i in range(2):
                cache.add_pod(w.pod("ns", f"{fill}-{i}", f"n{q}", True,
                                    w.rl(1750, 3 * GiB + 512 * 1024 ** 2),
                                    group=fill, priority=5))
            if q == 0:
                continue
            cache.add_pod_group(w.group("ns", f"want-{q}", 1,
                                        queue=f"q{q}"))
            cache.add_pod(w.pod("ns", f"want-{q}-0", "", False,
                                w.rl(2000, 4 * GiB), group=f"want-{q}",
                                priority=50))

    solvers = _probe_solvers(monkeypatch)
    ref = run(build, RECLAIM, False)
    got = run(build, RECLAIM, True)
    assert_same(ref, got, "prefetch world")
    assert not got[2]
    assert solvers and sum(s.dispatches for s in solvers) == 1
    assert solvers[0].dispatch_kinds["prefetch"] == 1


@pytest.mark.parametrize("seed", [2, 7, 11, 23, 31])
def test_reclaim_fastpath_fuzz(seed):
    """tests/test_preempt_reclaim.py's soundness net for the
    provably-idle gates: reclaim with the gates on decides exactly as
    with them off, and as the reference."""
    rng = np.random.default_rng(seed)
    spec = TSpec(
        n_nodes=int(rng.integers(10, 40)),
        n_groups=int(rng.integers(10, 30)),
        pods_per_group=int(rng.integers(1, 6)),
        n_queues=int(rng.integers(2, 5)),
        running_fill=float(rng.uniform(0.3, 0.95)),
        pod_cpu_millis=int(rng.integers(2, 12)) * 250,
        pod_mem_bytes=int(rng.integers(1, 4)) * GiB,
        jitter=float(rng.choice([0.0, 0.2])),
        seed=seed)

    def go(torch_side, **kw):
        side = Side(torch_side, spec=spec)
        ssn = side.open()
        for act in make_actions(RECLAIM, torch_side, **kw):
            act.execute(ssn)
        statuses, placed = session_result(ssn)
        side.close(ssn)
        return statuses, placed, sorted(side.rec.evicted)

    ref = go(False)
    on = go(True, fastpath=True)
    off = go(True, fastpath=False)
    assert on == off
    assert on == ref


def test_preemption_two_cycles_binds_like_reference():
    """Preempt, the kubelet finishes the eviction, the next cycle binds
    the preemptor — both packages."""
    out = []
    for torch_side in (False, True):
        side = Side(torch_side, inter_job)
        ssn = side.open()
        for act in make_actions(ALLOC_PREEMPT, torch_side):
            act.execute(ssn)
        side.close(ssn)
        for job in list(side.cache.jobs.values()):
            for task in list(job.tasks.values()):
                if task.status.name == "RELEASING":
                    side.cache.delete_pod(task.pod)
        ssn = side.open()
        make_actions(("allocate",), torch_side)[0].execute(ssn)
        side.close(ssn)
        out.append((side.rec.evicted, side.rec.binds))
    assert out[0] == out[1]
    assert out[1][1] == {"ns/high-0": "n1"}


# ---------------------------------------------------------------------
# vocabulary: an affinity snapshot the victim masks refuse runs the
# host loops on any cache, as the reference does
# ---------------------------------------------------------------------

def _affinity_world(cache, w):
    """A preemptor whose anti-affinity names more label selectors than
    the masks' raw collection window."""
    reclaim_cross_queue(cache, w)
    cache.add_pod_group(w.group("ns", "aff", 1, queue="qb"))
    pod = w.pod("ns", "aff-0", "", False, w.rl(1000, 2 * GiB), group="aff")
    pod.affinity = w.m.Affinity(pod_anti_affinity_required=[
        w.m.PodAffinityTerm(match_labels={f"k{i}": "block"})
        for i in range(RAW_PAIR_LIMIT + 1)])
    cache.add_pod(pod)


@pytest.mark.parametrize("action", ["preempt", "reclaim"])
def test_affinity_snapshot_takes_the_host_route_on_any_cache(action):
    """Past the masks' raw window the reference has no device route:
    its build_action_solver returns None and the action runs its host
    loops. The port does the same on a cache that claims the card (the
    refusal comes before anything is uploaded) and on a CPU cache,
    decides as the reference, and moves the counters as the reference's
    move: one affinity host fallback, no engine demotion."""
    from kubebatch_tpu import metrics as j_metrics

    jaff0 = j_metrics.affinity_host_fallback_total()
    jdem0 = j_metrics.engine_demotions_total()
    ref = run(_affinity_world, (action,), False)
    j_moves = (j_metrics.affinity_host_fallback_total() - jaff0,
               j_metrics.engine_demotions_total() - jdem0)
    assert j_moves == (1, 0)

    side = Side(True, _affinity_world)
    side.cache.device = torch.device("cuda")     # a cache claiming the card
    aff0 = t_metrics.affinity_host_fallback_total()
    dem0 = t_metrics.engine_demotions_total()
    ssn = side.open()
    make_actions((action,), True)[0].execute(ssn)
    statuses, placed = session_result(ssn)
    side.close(ssn)
    assert (t_metrics.affinity_host_fallback_total() - aff0,
            t_metrics.engine_demotions_total() - dem0) == j_moves
    assert_same(ref, (statuses, placed, sorted(side.rec.evicted),
                      side.rec.binds), f"claimed-card {action} vs reference")

    aff0 = t_metrics.affinity_host_fallback_total()
    dem0 = t_metrics.engine_demotions_total()
    got = run(_affinity_world, (action,), True)
    assert (t_metrics.affinity_host_fallback_total() - aff0,
            t_metrics.engine_demotions_total() - dem0) == j_moves
    assert_same(ref, got, f"CPU-cache {action} vs reference")


# ---------------------------------------------------------------------
# backfill (tests/test_backfill.py, plus the reserved path)
# ---------------------------------------------------------------------

def be_world(cache, w):
    cache.add_queue(w.queue("q1"))
    cache.add_node(w.node("n1", w.rl(2000, 4 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "full", 1, queue="q1"))
    cache.add_pod_group(w.group("ns", "be", 1, queue="q1"))
    cache.add_pod(w.pod("ns", "big", "n1", True, w.rl(2000, 4 * GiB),
                        group="full"))
    cache.add_pod(w.pod("ns", "effortless", "", False, w.rl(0, 0),
                        group="be"))


def topdog_world(cache, w):
    cache.add_queue(w.queue("q1"))
    cache.add_node(w.node("n1", w.rl(2000, 4 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "topdog", 3, queue="q1"))
    cache.add_pod_group(w.group("ns", "filler", 1, queue="q1"))
    for i in range(3):
        cache.add_pod(w.pod("ns", f"td-{i}", "", False, w.rl(1000, 2 * GiB),
                            group="topdog", creation_timestamp=1.0 + i))
    cache.add_pod(w.pod("ns", "fill-0", "", False, w.rl(1000, 2 * GiB),
                        group="filler", creation_timestamp=10.0))


def unready_backfill_world(cache, w):
    cache.add_queue(w.queue("q1"))
    cache.add_node(w.node("n1", w.rl(2000, 4 * GiB, pods=110)))
    cache.add_pod_group(w.group("ns", "bf", 2, queue="q1"))
    cache.add_pod(w.pod("ns", "bf-0", "", False, w.rl(1000, 2 * GiB),
                        group="bf"))
    cache.add_pod(w.pod("ns", "bf-1", "", False, w.rl(4000, 8 * GiB),
                        group="bf"))


def lent_world(tenants, node_cpu=4000, g0_cpu=1000, gang_req=1500,
               min_member=3):
    """A gang with one member running on n0 and the rest pending, and a
    backfill tenant on every node holding lent capacity they need."""
    def build(cache, w):
        cache.add_queue(w.queue("q1"))
        for n, cpu in enumerate(tenants):
            cache.add_node(w.node(f"n{n}", w.rl(node_cpu, 8 * GiB,
                                                 pods=110)))
            cache.add_pod_group(w.group("ns", f"tenant{n}", 1, queue="q1"))
            cache.add_pod(w.pod("ns", f"tenant{n}-0", f"n{n}", True,
                                w.rl(cpu, 2 * GiB), group=f"tenant{n}",
                                backfill=True))
        cache.add_pod_group(w.group("ns", "g", min_member, queue="q1"))
        cache.add_pod(w.pod("ns", "g-0", "n0", True, w.rl(g0_cpu, GiB),
                            group="g", creation_timestamp=0.0))
        for i in range(1, min_member):
            cache.add_pod(w.pod("ns", f"g-{i}", "", False,
                                w.rl(gang_req, GiB), group="g",
                                creation_timestamp=float(i)))
    return build


#: two nodes whose idle holds no gang member and whose lent capacity
#: holds exactly one each: allocate places both members over it
TWO_LENT = lent_world([1500, 1700], node_cpu=2000, g0_cpu=300,
                      gang_req=1200)

BACKFILL_CASES = {
    "best_effort": (be_world, ("allocate", "backfill"), False),
    "reserved_topdog": (topdog_world, ("allocate", "backfill"), True),
    "unready_backfill": (unready_backfill_world, ("backfill",), True),
    "over_reserve_and_reclaim": (lent_world([2500]), ("backfill",), True),
    "allocate_over_backfill_then_reclaim": (TWO_LENT,
                                            ("allocate", "backfill"), True),
}


@pytest.mark.parametrize("name", list(BACKFILL_CASES))
def test_backfill_matches_reference(name):
    build, names, reserved = BACKFILL_CASES[name]
    counters = []
    results = []
    for torch_side in (False, True):
        side = Side(torch_side, build)
        ssn = side.open(backfill_tiers(torch_side))
        if name == "reserved_topdog":
            # allocate reserved part of the top dog's quorum
            td = sorted(ssn.jobs["ns/topdog"].tasks.values(),
                        key=lambda t: t.name)
            ssn.allocate(td[0], "n1")
            ssn.allocate(td[1], "n1")
        for act in make_actions(names, torch_side, reserved=reserved):
            act.execute(ssn)
        statuses, placed = session_result(ssn)
        backfill = sorted(t.key for j in ssn.jobs.values()
                          for t in j.tasks.values() if t.is_backfill)
        side.close(ssn)
        conds = {uid: sorted(c.type for c in j.pod_group.status.conditions)
                 for uid, j in side.cache.jobs.items()
                 if j.pod_group is not None}
        results.append((statuses, placed, sorted(side.rec.evicted),
                        side.rec.binds, backfill, conds))
        if torch_side:
            counters.append((t_metrics.backfill_reclaims_total(),
                             t_metrics.backfill_tenants_evicted_total(),
                             t_metrics.lost_reservations_total()))
    assert results[0] == results[1]
    if name == "over_reserve_and_reclaim":
        statuses, _, evicted, binds = results[1][:4]
        assert evicted == ["ns/tenant0-0"]
        assert statuses["ns/g-1"] == statuses["ns/g-2"] == "BINDING"
    if name == "best_effort":
        assert results[1][3] == {"ns/effortless": "n1"}


def test_backfill_reclaim_discards_when_gang_cannot_reach_ready():
    """The atomic reclaim discards — tenants back, placements still over
    lent capacity — when a placement's node is gone mid-session."""
    out = []
    for torch_side in (False, True):
        side = Side(torch_side, TWO_LENT)
        ssn = side.open(backfill_tiers(torch_side))
        make_actions(("allocate",), torch_side)[0].execute(ssn)
        job = ssn.jobs["ns/g"]
        over = [t for t in job.tasks.values()
                if t.status.name == "ALLOCATED_OVER_BACKFILL"]
        assert len(over) == 2, [t.status.name for t in job.tasks.values()]
        assert over[0].node_name != over[-1].node_name
        gone = over[-1].node_name
        node = ssn.nodes.pop(gone)
        fn = t_reclaim_over_backfill if torch_side \
            else j_reclaim_over_backfill
        assert fn(ssn, job) is False
        ssn.nodes[gone] = node
        statuses, placed = session_result(ssn)
        out.append((statuses, placed))
        side.close(ssn)
        assert not side.rec.evicted
    assert out[0] == out[1]
    assert all(s != "RELEASING" for s in out[1][0].values())


# ---------------------------------------------------------------------
# four-action cycles of the shipped policy
# ---------------------------------------------------------------------

FOUR = ("reclaim", "allocate", "backfill", "preempt")


def _cycle(side, names, alloc_mode):
    ssn = side.open()
    for act in make_actions(names, side.torch_side, alloc=alloc_mode):
        act.execute(ssn)
    result = session_result(ssn)
    side.close(ssn)
    return result


def test_reduced_cfg5_four_action_cycles_match_reference(monkeypatch):
    """cfg5 cut to 128 nodes x 64 gangs of 8 (512 pods, 4 queues): a cold
    cycle (batched allocate, no victim work), then two skewed churn
    cycles (64 pods into queue 0, then queue 3). Reclaim runs its wave
    every churn cycle; both packages decide the same."""
    spec = dataclasses.replace(T_SPECS[5], n_nodes=128, n_groups=64)
    solvers = _probe_solvers(monkeypatch)
    j, t = Side(False, spec=spec), Side(True, spec=spec)
    for k, (arrival, engine) in enumerate(((None, "batched"), (0, "fused"),
                                           (3, "fused"))):
        if arrival is not None:
            for side in (j, t):
                side.kubelet_tick()
                assert side.sim.churn_tick(side.cache, 64,
                                           arrival_queue=arrival) == 64
        n0 = len(solvers)
        rj = _cycle(j, FOUR, engine)
        rt = _cycle(t, FOUR, "auto")
        assert t_allocate_mod.last_cycle_engine == engine
        assert rj == rt, f"cycle {k}: statuses/placements diverge"
        assert j.rec.binds == t.rec.binds and j.rec.evicted == t.rec.evicted
        built = solvers[n0:]
        if arrival is None:
            assert not built            # cold: no running task anywhere
        else:
            # reclaim's gates stay open: one solver, one prefetch wave
            assert [s.dispatches for s in built] == [1], \
                [s.dispatches for s in built]
    assert len(t.rec.binds) == 512 + 128


def test_reduced_saturated_cfg4_cycle_matches_reference():
    """cfg4 saturated (running_fill 0.95), cut to 200 nodes x 62 gangs:
    one four-action cycle in which preempt evicts and pipelines."""
    spec = dataclasses.replace(T_SPECS[4], n_nodes=200, n_groups=62,
                               running_fill=0.95)
    j, t = Side(False, spec=spec), Side(True, spec=spec)
    rj = _cycle(j, FOUR, "fused")
    rt = _cycle(t, FOUR, "auto")
    assert rj == rt
    assert sorted(j.rec.evicted) == sorted(t.rec.evicted)
    assert j.rec.binds == t.rec.binds
    assert len(t.rec.evicted) == 416
    assert sum(s == "PIPELINED" for s in rt[0].values()) > 0
