"""Whole four-action cycles with the affinity vocabulary: the port against
the reference, on the CPU.

The shipped policy (reclaim, allocate, backfill, preempt) runs on the
predicate-rich configurations 2p and 3p — a cold cycle, then skewed churn
cycles — in the reference's incremental cache, the port's incremental
cache and the port's snapshot-primary cache. Every cycle must agree in
task statuses, binds, evictions and pipelines, in the engine allocate
ran (``last_cycle_engine``: batched cold, host-visit once a churn cycle
falls under the batched threshold, as the reference's fused engine
refuses an affinity snapshot), and in the cycle's ``engine_demotions_total``
and ``affinity_host_fallback_total`` deltas. A saturated cluster has
preempt and reclaim choose nodes through the affinity masks; a snapshot
past the vocabulary's caps takes the counted host route.

The host-visit gate (which cycles run the host loops and which the
per-visit scan, against the reference's routes) and the two-level
request at scale have their own tests; a CUDA cache is only claimed
there where the gate refuses before any upload.
Tolerance 0 throughout.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.actions import allocate as j_allocate_mod  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import affinity as ta  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_cuda import AffWorld, aff_rollback_build  # noqa: E402
from .test_torch_cycle import b8_tiers, over_vocabulary_pod  # noqa: E402
from .test_torch_eventfold import four_actions  # noqa: E402
from .test_torch_fold_cycles import SimSide, session_result  # noqa: E402

GiB = 1024 ** 3

#: a saturated predicate-rich cluster: 95% running fill, pending gangs
#: with every affinity kind and host ports across 4 zones, two weighted
#: queues — preempt and reclaim evict and choose nodes through the masks
SATURATED_P = TSpec(n_nodes=24, n_groups=18, pods_per_group=4, min_member=2,
                    running_fill=0.95, n_queues=2, queue_weights=(1, 3),
                    pod_cpu_millis=1000, pod_mem_bytes=GiB, n_zones=4,
                    anti_affinity_frac=0.25, zone_affinity_frac=0.15,
                    pref_affinity_frac=0.25, hostport_frac=0.15, seed=7)


class AffSide(SimSide):
    """One package's sim and cache; ``incremental`` False makes the
    port's cache snapshot-primary."""

    def __init__(self, torch_side, spec, incremental=True):
        super(SimSide, self).__init__(torch_side, incremental)
        from kubebatch_tpu.sim import ClusterSpec as JSpec
        from kubebatch_tpu.sim import build_cluster as j_build
        self.sim = (t_build(spec) if torch_side
                    else j_build(JSpec(**vars(spec))))
        self.sim.populate(self.cache)
        self.alloc = t_allocate_mod if torch_side else j_allocate_mod


def make_sides(spec, extra=None):
    """Reference (incremental), port incremental and port
    snapshot-primary."""
    sides = [AffSide(False, spec), AffSide(True, spec),
             AffSide(True, spec, incremental=False)]
    if extra is not None:
        for s in sides:
            extra(s.cache, j_objects if not s.torch_side else t_objects)
    return sides


def affinity_cycle(sides, what):
    """One cycle of the shipped four actions on every side, compared."""
    out = []
    for s in sides:
        n_b, n_e = len(s.kubelet.binds), len(s.kubelet.evicted)
        dem0 = s.m.engine_demotions_total()
        aff0 = s.m.affinity_host_fallback_total()
        ssn = s.open()
        for act in four_actions(s.torch_side, "auto"):
            act.execute(ssn)
        result = session_result(ssn)
        s.close(ssn)
        out.append(dict(
            result=result, binds=list(s.kubelet.binds.items())[n_b:],
            evicted=s.kubelet.evicted[n_e:],
            engine=s.alloc.last_cycle_engine,
            demotions=s.m.engine_demotions_total() - dem0,
            aff_fallbacks=s.m.affinity_host_fallback_total() - aff0))
    ref = out[0]
    for k, got in enumerate(out[1:]):
        for key in ref:
            assert got[key] == ref[key], f"{what}, port side {k}: {key}"
    return ref


def run_cycles(spec, n_churn, churn, queues=1, extra=None):
    sides = make_sides(spec, extra)
    cycles = [affinity_cycle(sides, "cold")]
    for c in range(n_churn):
        for s in sides:
            s.kubelet_tick()
            s.sim.churn_tick(s.cache, churn,
                             arrival_queue=0 if c % 2 == 0 else queues - 1)
        cycles.append(affinity_cycle(sides, f"churn {c + 1}"))
    return cycles


#: (config, churn cycles, pods a churn cycle): a host-visit cycle walks
#: every node for every pending task in each side's host loops, so 3p's
#: 500 nodes take 16 pods a churn cycle where 2p takes 32
CYCLE_CASES = [("2p", 2, 32), ("3p", 2, 16)]


@pytest.mark.parametrize("config,n_churn,churn", CYCLE_CASES,
                         ids=[c[0] for c in CYCLE_CASES])
def test_predicate_rich_cycles_match_reference(config, n_churn, churn):
    spec = T_SPECS[config]
    cycles = run_cycles(spec, n_churn, churn, queues=spec.n_queues)
    engines = [c["engine"] for c in cycles]
    assert engines[0] == "batched" and "host-visit" in engines[1:]
    assert cycles[0]["binds"], "the cold cycle must bind"
    assert all(c["aff_fallbacks"] == 0 for c in cycles)
    # every host-visit cycle is the fused engine refusing the affinity
    # snapshot, counted as one demotion
    assert [c["demotions"] for c in cycles] \
        == [int(e == "host-visit") for e in engines]


def test_saturated_cycle_chooses_victim_nodes_through_the_masks(
        monkeypatch):
    """Preempt and reclaim evict on a saturated predicate-rich cluster,
    with the affinity masks folded into their node choice."""
    built = []

    class Counting(ta.SessionAffinityMasks):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(ta, "SessionAffinityMasks", Counting)
    cycles = run_cycles(SATURATED_P, 1, churn=8, queues=2)
    assert any(c["evicted"] for c in cycles), "nothing was evicted"
    assert built and all(m.supported for m in built)
    assert any(m.with_scores for m in built)


def test_over_vocabulary_snapshot_takes_the_counted_host_route():
    from kubebatch_tpu_torch.kernels.affinity import MAX_PAIRS

    sites0 = t_metrics.affinity_host_fallbacks_by_site()
    cycles = run_cycles(
        T_SPECS["2p"], 0, churn=0,
        extra=lambda cache, m: over_vocabulary_pod(cache, m, MAX_PAIRS + 1))
    assert cycles[0]["engine"] == "host-visit"
    assert cycles[0]["aff_fallbacks"] == 1
    assert cycles[0]["demotions"] == 1
    assert t_allocate_mod.last_host_reason.startswith("dynamic_features")
    # MAX_PAIRS + 1 pairs pass the raw window and fail the compact cap,
    # once on each of the two port sides
    sites = t_metrics.affinity_host_fallbacks_by_site()
    assert {k: v - sites0.get(k, 0) for k, v in sites.items()
            if v != sites0.get(k, 0)} == {"allocate-compact-cap": 2}


# ---- the host-visit gate ---------------------------------------------------

def _gate_cache(affinity: bool, device: str):
    cache = TCache(async_writeback=False, device="cpu")
    w = AffWorld(t_objects)
    cache.add_queue(w.queue())
    if affinity:
        aff_rollback_build(cache, w)
    else:
        w.hostname_nodes(cache, 4, cpu=2000)
        cache.add_pod_group(w.group("g", 2))
        for p in range(2):
            cache.add_pod(w.pod(f"g-{p}", req=(500, GiB), group="g"))
    cache.device = torch.device(device)      # a cache claiming the card
    return cache


def _j_gate_cache(affinity: bool):
    """The reference's twin of _gate_cache."""
    from kubebatch_tpu.cache import SchedulerCache as JCache

    cache = JCache(async_writeback=False, incremental_snapshot=False)
    w = AffWorld(j_objects)
    cache.add_queue(w.queue())
    if affinity:
        aff_rollback_build(cache, w)
    else:
        w.hostname_nodes(cache, 4, cpu=2000)
        cache.add_pod_group(w.group("g", 2))
        for p in range(2):
            cache.add_pod(w.pod(f"g-{p}", req=(500, GiB), group="g"))
    return cache


def _statuses(cache):
    return {t.uid: (t.status.name, t.node_name)
            for j in cache.jobs.values() for t in j.tasks.values()}


@pytest.mark.parametrize("custom,affinity,device,mode,route", [
    (False, True, "cuda", "fused", "host"),     # fused refuses affinity
    (True, False, "cpu", "jax", "visit"),       # the per-visit scan, asked
    (True, False, "cpu", "batched", "visit"),   # B8 behind batched's refusal
    (True, False, "cpu", "fused", "visit"),     # B8 behind fused's refusal
    (True, True, "cuda", "batched", "host"),    # custom order + affinity
])
def test_host_visit_gate(custom, affinity, device, mode, route):
    """The route of a cycle outside the requested engine, as the
    reference takes it on the same cluster: where the strict
    device_supported gate fails the host loops run, on any cache (a
    cache claiming the card included: the gate refuses before any
    upload); where it holds with custom order plugins every visit is
    the per-visit scan (B8; on a CPU cache here, the card's run is in
    tests/test_torch_cuda.py). Engines, demotion deltas and task
    statuses equal the reference's."""
    from kubebatch_tpu import metrics as j_metrics
    from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate
    from kubebatch_tpu.conf import shipped_tiers as j_tiers
    from kubebatch_tpu.framework import CloseSession as JClose
    from kubebatch_tpu.framework import OpenSession as JOpen

    from .test_torch_cycle import j_b8_tiers

    jcache = _j_gate_cache(affinity)
    jdem0 = j_metrics.engine_demotions_total()
    ssn = JOpen(jcache, j_b8_tiers() if custom else j_tiers())
    JAllocate(mode=mode).execute(ssn)
    JClose(ssn)

    cache = _gate_cache(affinity, device)
    ssn = TOpen(cache, b8_tiers() if custom else t_tiers())
    dem0 = t_metrics.engine_demotions_total()
    TAllocate(mode=mode).execute(ssn)
    want = "host-visit" if route == "host" else f"{mode}-visit"
    assert t_allocate_mod.last_cycle_engine == \
        j_allocate_mod.last_cycle_engine == want
    assert t_metrics.engine_demotions_total() - dem0 \
        == j_metrics.engine_demotions_total() - jdem0 == int(mode != "jax")
    if route == "host":
        reason = t_allocate_mod.last_host_reason
        assert reason.startswith("dynamic_features") == affinity
    TClose(ssn)
    assert _statuses(cache) == _statuses(jcache)


@pytest.mark.parametrize("affinity", [False, True])
def test_two_level_request_at_scale(monkeypatch, affinity):
    """Auto at AUTO_HIER_MIN_NODES nodes asks for the two-level engine
    (B10), as the reference does (the node threshold lowered for the
    test, in both packages): an affinity-free cycle runs it — its
    active set (B11) claims the cycle, as in the reference — an affinity
    cycle demotes to the batched engine, counted. Engines, demotion
    deltas and task statuses equal the reference's."""
    from kubebatch_tpu import metrics as j_metrics
    from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate
    from kubebatch_tpu.conf import shipped_tiers as j_tiers
    from kubebatch_tpu.framework import CloseSession as JClose
    from kubebatch_tpu.framework import OpenSession as JOpen
    from kubebatch_tpu.kernels import activeset as j_activeset
    from kubebatch_tpu_torch.kernels import activeset as t_activeset

    import jax

    monkeypatch.setattr(t_allocate_mod, "AUTO_HIER_MIN_NODES", 2)
    monkeypatch.setattr(j_allocate_mod, "AUTO_HIER_MIN_NODES", 2)
    # the reference demotes to its sharded engine when it sees more than
    # one device (the tests' 8-device CPU mesh); the port runs on one card
    one = jax.devices()[:1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: one)
    j_activeset.reset()
    t_activeset.reset()
    jcache = _j_gate_cache(affinity)
    jdem0 = j_metrics.engine_demotions_total()
    ssn = JOpen(jcache, j_tiers())
    JAllocate(mode="auto").execute(ssn)
    JClose(ssn)

    cache = _gate_cache(affinity, "cpu")
    ssn = TOpen(cache, t_tiers())
    dem0 = t_metrics.engine_demotions_total()
    TAllocate(mode="auto").execute(ssn)
    TClose(ssn)
    assert t_allocate_mod.last_cycle_engine \
        == j_allocate_mod.last_cycle_engine \
        == ("batched" if affinity else "activeset")
    assert t_metrics.engine_demotions_total() - dem0 \
        == j_metrics.engine_demotions_total() - jdem0 == int(affinity)
    assert _statuses(cache) == _statuses(jcache)