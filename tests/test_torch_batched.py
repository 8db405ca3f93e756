"""The port's batched round engine against the reference package's, on the
CPU.

Three layers, tolerance 0 throughout:

- the fixed-order float helpers (kernels/xla_order.py) against the
  ``jnp`` operations they stand for, at the shapes a round uses;
- the plain batched engine against the reference's ``_batched_packed``
  on the reference's own packed inputs: the packed result word for word
  and the final node carry bit for bit;
- whole allocate cycles: the port in ``auto`` at >= 512 pending runs the
  batched engine and binds exactly what the reference's batched cycle
  binds.

The CUDA kernel is held against the plain engine on the card in
tests/test_torch_cuda.py.
"""
from __future__ import annotations

import copy
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
from kubebatch_tpu.actions.cycle_inputs import build_cycle_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache  # noqa: E402
from kubebatch_tpu.conf import PluginOption, Tier, shipped_tiers  # noqa: E402
from kubebatch_tpu.framework import OpenSession  # noqa: E402
from kubebatch_tpu.kernels.batched import (_batched_packed,  # noqa: E402
                                           _segmented_prefix,
                                           prepare_batched)
from kubebatch_tpu.objects import BACKFILL_ANNOTATION  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS, ClusterSpec, build_cluster  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions import allocate_batched  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.interop import (cycle_inputs_from_numpy,  # noqa: E402
                                         device_state_from_numpy)
from kubebatch_tpu_torch.kernels import batched as t_batched  # noqa: E402
from kubebatch_tpu_torch.kernels import xla_order  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402

from .fixtures import build_group, build_node, build_pod, build_queue, rl  # noqa: E402
from .test_torch_cycle import (Side, _assert_same, b8_tiers,  # noqa: E402
                              over_vocabulary_pod)

GiB = 1024 ** 3
STATIC_KEYS = ("job_keys", "queue_keys", "prop_overused", "dyn_enabled",
               "pipe_enabled", "max_rounds", "compact_bucket",
               "gang_enabled", "narrow", "narrow_gate")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def _assert_bitwise(ref, got, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, \
        (what, ref.shape, got.shape, ref.dtype, got.dtype)
    same = (_bits(ref).reshape(ref.size, -1)
            == _bits(got).reshape(got.size, -1)).all(axis=1)
    if not same.all():
        i = int(np.argmin(same))
        raise AssertionError(f"{what}: flat index {i} differs "
                             f"({int((~same).sum())} of {same.size}): "
                             f"reference {ref.ravel()[i]!r}, port "
                             f"{got.ravel()[i]!r}")


# ---- the fixed-order helpers ------------------------------------------------

def _mass(rng, shape):
    """Seeded float32 magnitudes of cfg5's milli-cpu / MiB sums, a third
    of them zero (masked rows)."""
    x = rng.uniform(2e4, 7e4, shape).astype(np.float32)
    x[rng.random(shape[0]) < 0.3] = 0.0
    return x


#: [J] window, [N,3] capacity, [T,3] task prefixes, [T] counts
CUMSUM_SHAPES = [(8,), (17,), (2048,), (8192,), (16384,), (64, 3),
                 (8192, 3), (1024, 3), (16384, 3), (37, 3)]


@pytest.mark.parametrize("shape", CUMSUM_SHAPES, ids=str)
def test_tiled_cumsum_matches_jnp_cumsum(shape):
    x = _mass(np.random.default_rng(len(shape) * 100 + shape[0]), shape)
    ref = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=0))(x))
    got = xla_order.tiled_cumsum(torch.from_numpy(x)).numpy()
    _assert_bitwise(ref, got, f"cumsum {shape}")


@pytest.mark.parametrize("n", [8, 64, 512, 8192, 40, 5000])
def test_column_sum_matches_jnp_sum(n):
    x = _mass(np.random.default_rng(n), (n, 3))
    ref = np.asarray(jax.jit(lambda a: a.sum(axis=0))(x))
    got = xla_order.column_sum(torch.from_numpy(x)).numpy()
    _assert_bitwise(ref, got, f"sum [{n},3]")


@pytest.mark.parametrize("shape", [(2048,), (1024, 3), (16384, 3), (37,)],
                         ids=str)
def test_segmented_prefix_matches_associative_scan(shape):
    """The reference's _segmented_prefix (jax.lax.associative_scan) on
    segments of a sorted key, against the port's copy of the recursion."""
    rng = np.random.default_rng(shape[0])
    x = _mass(rng, shape)
    keys = np.sort(rng.integers(0, max(shape[0] // 6, 1), shape[0]))
    starts = np.searchsorted(keys, keys, side="left").astype(np.int32)
    ref = np.asarray(jax.jit(_segmented_prefix)(x, starts))
    got = t_batched._segmented_prefix(torch.from_numpy(x),
                                      torch.from_numpy(starts)).numpy()
    _assert_bitwise(ref, got, f"segmented prefix {shape}")


@pytest.mark.parametrize("n", [64, 8192])
def test_search_left_matches_jnp_searchsorted(n):
    rng = np.random.default_rng(n)
    a = np.cumsum(_mass(rng, (n,))).astype(np.float32)
    q = np.concatenate([a[rng.integers(0, n, 64)],
                        rng.uniform(0, a[-1] * 1.1, 256).astype(np.float32),
                        np.asarray([0.0, a[-1], a[-1] * 2], np.float32)])
    ref = np.asarray(jax.jit(
        lambda s, v: jnp.searchsorted(s, v, side="left"))(a, q))
    got = xla_order.search_left(torch.from_numpy(a), torch.from_numpy(q))
    np.testing.assert_array_equal(ref, got.numpy())


# ---- the packed solve, word for word ---------------------------------------

def _prep_fill(sim, kind):
    """Every other running fill pod terminating ("releasing": pipelined
    tasks) or lendable ("backfill": AllocatedOverBackfill tasks)."""
    for pod in [p for p in sim.pods if p.name.startswith("fill-")][::2]:
        if kind == "releasing":
            pod.deletion_timestamp = 1.0
        else:
            pod.annotations[BACKFILL_ANNOTATION] = "true"


def _sim_cache(spec, prep=None):
    sim = build_cluster(spec)
    if prep:
        _prep_fill(sim, prep)
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False)
    sim.populate(cache)
    return cache


def _fixture_cache(nodes, groups, pods, queues=("q1", "q2")):
    nodes, groups, pods = copy.deepcopy((nodes, groups, pods))
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False)
    for q in queues:
        cache.add_queue(build_queue(q))
    for n in nodes:
        cache.add_node(n)
    for g in groups:
        cache.add_pod_group(g)
    for p in pods:
        cache.add_pod(p)
    return cache


def reference_solve(cache, tiers=None, compact_bucket=None):
    """The reference's batched solve of one session: the port's arguments
    (node and cycle arrays as numpy, statics) and the reference's packed
    result and final node carry."""
    ssn = OpenSession(cache, tiers if tiers is not None else shipped_tiers())
    inputs = build_cycle_inputs(ssn)
    args, statics = prepare_batched(inputs.device, inputs,
                                    compact_bucket=compact_bucket)
    final, packed = _batched_packed(*args, **statics)
    arrays = {}
    for buf, lay in zip(args[:3], (statics["lay_f"], statics["lay_i"],
                                   statics["lay_b"])):
        buf = np.asarray(buf)
        for name, off, shape in lay:
            size = int(np.prod(shape)) if shape else 1
            arrays[name] = buf[off:off + size].reshape(shape)
    node = dict(zip(t_batched.NODE_ARGS, (np.asarray(x) for x in args[3:])))
    carry = [np.asarray(x) for x in (final.idle, final.releasing,
                                     final.n_tasks, final.nz_req)]
    return (node, arrays, {k: statics[k] for k in STATIC_KEYS},
            np.asarray(packed), carry)


def port_solve(node, arrays, statics):
    return t_batched.batched_allocate(
        **device_state_from_numpy(node, "cpu", engine="batched"),
        **cycle_inputs_from_numpy(arrays, "cpu", engine="batched"),
        **statics)


def _check_solve(cache, tiers=None, compact_bucket=None):
    node, arrays, statics, ref_packed, ref_carry = reference_solve(
        cache, tiers, compact_bucket)
    got = port_solve(node, arrays, statics)
    _assert_bitwise(ref_packed, got[0].numpy(), "packed")
    for r, g, name in zip(ref_carry, got[1:],
                          ("idle", "releasing", "n_tasks", "nz_req")):
        _assert_bitwise(r, g.numpy(), name)
    t_pad = arrays["task_valid"].shape[0]
    return statics, t_batched.unpack_result(ref_packed, t_pad), arrays


REDUCED3 = ClusterSpec(n_nodes=64, n_groups=160, pods_per_group=4,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=800, pod_mem_bytes=GiB)
#: cfg5's shape cut to 48 nodes; 72 gangs x 8 = 576 pods (the batched
#: regime); contended: the stranded-gang epilogue revives
REDUCED5 = ClusterSpec(n_nodes=48, n_groups=72, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=5)
#: a nearly full cluster (with _prep_fill: pipelined / over-backfill)
FILLED = ClusterSpec(n_nodes=16, n_groups=24, pods_per_group=4,
                     min_member=2, running_fill=0.9, n_queues=2,
                     queue_weights=(1, 3), pod_cpu_millis=1000,
                     pod_mem_bytes=GiB, seed=7)

NO_GANG_TIERS = [
    Tier(plugins=[PluginOption(name="priority"),
                  PluginOption(name="conformance")]),
    Tier(plugins=[PluginOption(name="drf"),
                  PluginOption(name="predicates"),
                  PluginOption(name="proportion"),
                  PluginOption(name="nodeorder")]),
]


def _contended(seed, n_nodes=8, n_jobs=40, max_pods=6):
    """Demand ~2x capacity with random gang sizes: acceptance conflicts,
    kills and stranded gangs."""
    rng = np.random.default_rng(seed)
    nodes = [build_node(f"n{i:03d}", rl(4000, 8 * GiB, pods=12))
             for i in range(n_nodes)]
    groups, pods = [], []
    for j in range(n_jobs):
        n_pods = int(rng.integers(1, max_pods + 1))
        min_member = int(rng.integers(1, n_pods + 1))
        groups.append(build_group("ns", f"pg{j:03d}", min_member,
                                  queue="q1" if j % 2 else "q2",
                                  creation_timestamp=float(j)))
        for p in range(n_pods):
            pods.append(build_pod(
                "ns", f"j{j:03d}-p{p}", "", "Pending",
                rl(int(rng.integers(1, 5)) * 500,
                   int(rng.integers(1, 7)) * GiB // 2),
                group=f"pg{j:03d}", priority=int(rng.integers(0, 3)),
                creation_timestamp=float(p)))
    return nodes, groups, pods


def _overused_queue():
    """q2's running pod holds more than its deserved share: q2 is
    overused from the start and its pending gangs never engage."""
    nodes = [build_node(f"n{i}", rl(8000, 16 * GiB, pods=110))
             for i in range(4)]
    groups = [build_group("ns", "pg-fill", 1, queue="q2",
                          creation_timestamp=0.0)]
    pods = [build_pod("ns", f"fill{i}", f"n{i}", "Running",
                      rl(7000, 14 * GiB), group="pg-fill") for i in range(4)]
    for j in range(12):
        q = "q2" if j % 3 == 0 else "q1"
        groups.append(build_group("ns", f"pg{j}", 2, queue=q,
                                  creation_timestamp=1.0 + j))
        pods += [build_pod("ns", f"j{j}-p{i}", "", "Pending",
                           rl(500, GiB), group=f"pg{j}")
                 for i in range(4)]
    return nodes, groups, pods


def _compact_shape():
    """tests/test_batched.py's compact-continuation shape: 80 jobs x 30
    pods on 6 nodes (2,400 tasks, T_pad 4096)."""
    rng = np.random.default_rng(7)
    nodes = [build_node(f"n{i}", rl(4000, 8 * GiB, pods=40))
             for i in range(6)]
    groups, pods = [], []
    for j in range(80):
        groups.append(build_group("ns", f"pg{j:03d}", 1, queue="q1",
                                  creation_timestamp=float(j)))
        for p in range(30):
            pods.append(build_pod(
                "ns", f"j{j:03d}-p{p}", "", "Pending",
                rl(int(rng.integers(1, 9)) * 100,
                   int(rng.integers(1, 5)) * GiB // 4),
                group=f"pg{j:03d}", creation_timestamp=float(p)))
    return nodes, groups, pods


@pytest.mark.parametrize("cfg", [2, 3])
def test_batched_solve_matches_reference_on_baseline(cfg):
    statics, (state, _, _, rounds, telem), _ = _check_solve(
        _sim_cache(BASELINE_SPECS[cfg]))
    assert rounds > 0 and telem[0] == 2
    assert (state == 1).any()


def test_batched_solve_matches_reference_reduced3():
    _, (state, _, _, _, _), _ = _check_solve(_sim_cache(REDUCED3))
    assert (state == 1).any()


def test_batched_solve_matches_reference_reduced5_contended():
    """Over 512 pods, contended: gangs fail and strand, and the epilogue
    revives at least once."""
    _, (state, _, _, _, telem), _ = _check_solve(_sim_cache(REDUCED5))
    assert int((state != 0).sum()) > 0
    assert telem[14] > 0, "the stranded-gang epilogue did not revive"


@pytest.mark.parametrize("prep,code", [("releasing", 3), ("backfill", 2)],
                         ids=["pipelined", "over_backfill"])
def test_batched_solve_matches_reference_filled(prep, code):
    statics, (state, _, _, _, _), _ = _check_solve(_sim_cache(FILLED,
                                                              prep))
    assert (state == code).any(), f"no decision {code} in the case"
    if prep == "releasing":
        assert statics["pipe_enabled"]


def test_batched_solve_matches_reference_without_gang():
    statics, _, _ = _check_solve(_fixture_cache(*_contended(3)),
                                 tiers=NO_GANG_TIERS)
    assert not statics["gang_enabled"]


@pytest.mark.parametrize("seed", [1, 2])
def test_batched_solve_matches_reference_contended(seed):
    _check_solve(_fixture_cache(*_contended(seed)))


def test_batched_solve_matches_reference_overused_queue():
    statics, (state, _, _, _, _), arrays = _check_solve(
        _fixture_cache(*_overused_queue()))
    assert statics["prop_overused"]
    over = np.all(arrays["q_deserved"]
                  < arrays["q_alloc0"] + t_batched.VEC_EPS, axis=-1)
    assert over[1], "q2 must start overused"
    assert (state == 1).any()


def test_compact_bucket_matches_reference_and_full_width():
    """The post-round-0 compaction against the reference, and against the
    full-width loop (the same decisions either way)."""
    out = {}
    for bucket in (0, 512):
        statics, res, _ = _check_solve(_fixture_cache(*_compact_shape()),
                                       compact_bucket=bucket)
        assert statics["compact_bucket"] == bucket
        out[bucket] = res
    assert out[512][3] > 1, "the compact continuation did not engage"
    for k in range(3):
        np.testing.assert_array_equal(out[0][k], out[512][k])


def test_batched_wrapper_rejects_mixed_devices():
    node, arrays, statics, _, _ = reference_solve(
        _sim_cache(BASELINE_SPECS[1]))
    args = {**device_state_from_numpy(node, "cpu", engine="batched"),
            **cycle_inputs_from_numpy(arrays, "cpu", engine="batched")}
    args["idle"] = args["idle"].to("meta")
    with pytest.raises(ValueError, match="mixed devices"):
        t_batched.batched_allocate(**args, **statics)


# ---- whole cycles ----------------------------------------------------------

#: cfg5's shape cut to 48 nodes with 72 gangs: 576 pending, auto's batched
#: regime on both sides
REDUCED5_T = TSpec(n_nodes=48, n_groups=72, pods_per_group=8, n_queues=4,
                   queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
                   pod_mem_bytes=2 * GiB, jitter=0.2, seed=5)


@pytest.mark.parametrize("config", [2, REDUCED5_T], ids=["cfg2", "reduced5"])
def test_auto_runs_batched_cycle_as_reference(config):
    """At >= 512 pending, auto runs the batched engine with one counted
    sync and no demotion, and binds in the same order with the same task
    states as the reference's batched cycle; the churn cycle after it
    runs fused in auto on both sides."""
    j, t = Side(False, config), Side(True, config)
    rb0 = t_metrics.blocking_readbacks()
    dem0 = t_metrics.engine_demotions_total()
    j.cycle("batched")
    t.cycle("auto")
    assert t_allocate_mod.last_cycle_engine == "batched"
    assert t_metrics.blocking_readbacks() - rb0 == 1
    assert t_metrics.engine_demotions_total() == dem0
    assert allocate_batched.last_solve["rounds"] > 0
    assert set(allocate_batched.last_phases) == {
        "tensorize", "upload", "solve", "sync", "kernel", "replay"}
    assert t.binder.calls, "scenario must bind"
    _assert_same(j, t)
    for side in (j, t):
        side.kubelet_tick()
        side.sim.churn_tick(side.cache, 16)
    j.cycle("auto")
    t.cycle("auto")
    assert t_allocate_mod.last_cycle_engine == "fused"
    _assert_same(j, t)


def test_batched_unsupported_snapshot_falls_back_to_host_counted():
    """2p with one pod whose anti-affinity names more label selectors
    than the vocabulary's caps: the batched engine refuses (counted as
    an affinity host fallback), the cycle runs the host loops as the
    reference does, counted as a demotion, and binds as the reference's
    host cycle binds."""
    from kubebatch_tpu import objects as j_objects
    from kubebatch_tpu_torch import objects as t_objects
    from kubebatch_tpu_torch.kernels.affinity import MAX_PAIRS

    j, t = Side(False, "2p"), Side(True, "2p")
    over_vocabulary_pod(j.cache, j_objects, MAX_PAIRS + 1)
    over_vocabulary_pod(t.cache, t_objects, MAX_PAIRS + 1)
    dem0 = t_metrics.engine_demotions_total()
    aff0 = t_metrics.affinity_host_fallback_total()
    j.cycle("host")
    t.cycle("batched")
    assert t_metrics.engine_demotions_total() == dem0 + 1
    assert t_metrics.affinity_host_fallback_total() == aff0 + 1
    assert t_allocate_mod.last_cycle_engine == "host-visit"
    assert t_allocate_mod.last_host_reason.startswith("dynamic_features")
    assert t.binder.calls
    _assert_same(j, t)


def test_batched_custom_order_runs_the_visit_scan():
    """Custom job order with device terms in batched mode: the batched
    engine refuses, the demotion is counted on both sides, and the cycle
    runs the per-visit scan (ROADMAP B8, "batched-visit") binding as the
    reference's."""
    from kubebatch_tpu import metrics as j_metrics
    from kubebatch_tpu.actions import allocate as j_allocate_mod
    from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate
    from kubebatch_tpu.framework import CloseSession as JClose
    from kubebatch_tpu.framework import OpenSession as JOpen

    from .test_torch_cycle import j_b8_tiers

    j, t = Side(False, 2), Side(True, 2)
    jdem0 = j_metrics.engine_demotions_total()
    tdem0 = t_metrics.engine_demotions_total()
    ssn = JOpen(j.cache, j_b8_tiers())
    JAllocate(mode="batched").execute(ssn)
    JClose(ssn)
    ssn = TOpen(t.cache, b8_tiers())
    TAllocate(mode="batched").execute(ssn)
    TClose(ssn)
    assert t_allocate_mod.last_cycle_engine == \
        j_allocate_mod.last_cycle_engine == "batched-visit"
    assert t_metrics.engine_demotions_total() - tdem0 \
        == j_metrics.engine_demotions_total() - jdem0 == 1
    assert t.binder.calls
    _assert_same(j, t)
