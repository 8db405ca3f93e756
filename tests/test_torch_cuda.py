"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no jax), so it runs on a machine with an
NVIDIA GPU and without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py

Every case needs a CUDA device and skips without one. Tolerance 0: the
kernels repeat the plain versions' float32 operations in the same order
(built with -fmad=false), so outputs are compared bit for bit. The plain
batched engine runs on CPU copies of the kernel's inputs (its segment
sums are index_add_'s sequential order on the CPU).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import kubebatch_tpu_torch.actions  # noqa: F401  (registers actions)
import kubebatch_tpu_torch.plugins  # noqa: F401  (registers plugins)
from kubebatch_tpu_torch import metrics
from kubebatch_tpu_torch.actions.allocate import AllocateAction
from kubebatch_tpu_torch.actions.allocate_fused import prepare_fused
from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
from kubebatch_tpu_torch.cache import SchedulerCache
from kubebatch_tpu_torch.conf import shipped_tiers
from kubebatch_tpu_torch.framework import CloseSession, OpenSession
from kubebatch_tpu_torch.kernels import _build
from kubebatch_tpu_torch.kernels.batched import (batched_allocate,
                                                 batched_allocate_plain,
                                                 prepare_batched)
from kubebatch_tpu_torch.kernels.fused import (fused_allocate,
                                               fused_allocate_plain)
from kubebatch_tpu_torch.kernels.solver import (dynamic_node_score,
                                                dynamic_node_score_plain)
from kubebatch_tpu_torch.conf import PluginOption, Tier
from kubebatch_tpu_torch.objects import (BACKFILL_ANNOTATION,
                                         GROUP_NAME_ANNOTATION, Container,
                                         Node, Pod, PodGroup, PodPhase, Queue,
                                         resource_list)
from kubebatch_tpu_torch.sim import BASELINE_SPECS, ClusterSpec, build_cluster

GiB = 1024 ** 3

pytestmark = pytest.mark.cuda


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "False)")


def _assert_bitwise(want, got, what):
    for k, (w, g) in enumerate(zip(want, got)):
        assert w.shape == g.shape and w.dtype == g.dtype, (what, k)
        assert torch.equal(w.contiguous().view(torch.uint8),
                           g.contiguous().view(torch.uint8)), (what, k)


def _score_inputs(seed: int, n: int):
    rng = np.random.default_rng(seed)
    cap = np.stack([rng.uniform(3200, 9600, n), rng.uniform(6554, 19661, n)],
                   axis=1).astype(np.float32)
    nz = (cap * rng.uniform(0.0, 1.1, (n, 2))).astype(np.float32)
    t_nz = np.asarray([1000.0, 2048.0], np.float32)
    cap[0] = 0.0                       # no allocatable
    cap[1, 0] = 0.0                    # cpu-less node
    nz[2] = cap[2] + 1.0               # past capacity
    nz[3] = cap[3] - t_nz              # frac exactly 1.0 with the task
    nz[4] = np.nextafter(cap[4] - t_nz, np.float32(0.0))
    w = np.asarray([1.0, 1.0], np.float32)
    return [torch.from_numpy(a).cuda() for a in (nz, t_nz, cap, w)]


@pytest.mark.parametrize("seed", [0, 1])
def test_dynamic_node_score_kernel_matches_plain(seed):
    _need_cuda()
    args = _score_inputs(seed, 8192)
    n0 = _build.launch_count("dynamic_node_score")
    got = dynamic_node_score(*args)
    torch.cuda.synchronize()
    assert _build.launch_count("dynamic_node_score") == n0 + 1
    _assert_bitwise([dynamic_node_score_plain(*args)], [got],
                    "dynamic_node_score")


def _prep_fill(sim, kind):
    """Every other running fill pod terminating ("releasing": pipelined
    tasks) or lendable ("backfill": AllocatedOverBackfill tasks)."""
    for pod in [p for p in sim.pods if p.name.startswith("fill-")][::2]:
        if kind == "releasing":
            pod.deletion_timestamp = 1.0
        else:
            pod.annotations[BACKFILL_ANNOTATION] = "true"


REDUCED3 = ClusterSpec(n_nodes=64, n_groups=160, pods_per_group=4,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=800, pod_mem_bytes=GiB)
REDUCED5 = ClusterSpec(n_nodes=48, n_groups=56, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=5)
FILLED = ClusterSpec(n_nodes=16, n_groups=24, pods_per_group=4,
                     min_member=2, running_fill=0.9, n_queues=2,
                     queue_weights=(1, 3), pod_cpu_millis=1000,
                     pod_mem_bytes=GiB, seed=7)
CASES = [(BASELINE_SPECS[1], None), (BASELINE_SPECS[2], None),
         (BASELINE_SPECS["t"], None), (REDUCED3, None), (REDUCED5, None),
         (FILLED, "releasing"), (FILLED, "backfill")]
IDS = ["cfg1", "cfg2", "t", "reduced3", "reduced5", "pipelined",
       "over_backfill"]


def _cache(case, device, binder=None):
    spec, prep = case
    sim = build_cluster(spec)
    if prep:
        _prep_fill(sim, prep)
    cache = SchedulerCache(binder=binder, async_writeback=False,
                           device=device)
    sim.populate(cache)
    return cache


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_fused_allocate_kernel_matches_plain(case):
    _need_cuda()
    args, statics = prepare_fused(build_cycle_inputs(
        OpenSession(_cache(case, "cuda"), shipped_tiers())))
    n0 = _build.launch_count("fused_allocate")
    got = fused_allocate(**args, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("fused_allocate") == n0 + 1
    _assert_bitwise(fused_allocate_plain(**args, **statics), got,
                    "fused_allocate")


class _Binder:
    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((pod.name, hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cycle_on_the_card_binds_what_the_cpu_binds(case):
    """A whole fused allocate cycle on the card equals the same cycle on
    the CPU (plain versions): same binds in the same order, one counted
    device->host copy."""
    _need_cuda()
    calls = {}
    for device in ("cuda", "cpu"):
        binder = _Binder()
        cache = _cache(case, device, binder)
        ssn = OpenSession(cache, shipped_tiers())
        rb0 = metrics.blocking_readbacks()
        AllocateAction(mode="fused").execute(ssn)
        assert metrics.blocking_readbacks() - rb0 == 1
        CloseSession(ssn)
        calls[device] = binder.calls
    assert calls["cuda"] == calls["cpu"]


#: cfg5's shape cut to 48 nodes with 72 gangs x 8 pods: 576 pending (the
#: batched regime), contended (the stranded-gang epilogue revives)
REDUCED5_B = ClusterSpec(n_nodes=48, n_groups=72, pods_per_group=8,
                         n_queues=4, queue_weights=(1, 2, 3, 4),
                         pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                         jitter=0.2, seed=5)
#: (case, compact bucket: None = the automatic size, 0 = full width)
BATCHED_CASES = [((BASELINE_SPECS[2], None), None),
                 ((BASELINE_SPECS[3], None), None),
                 ((BASELINE_SPECS[3], None), 0),
                 ((REDUCED3, None), None), ((REDUCED5_B, None), None),
                 ((FILLED, "releasing"), None), ((FILLED, "backfill"), None)]
BATCHED_IDS = ["cfg2", "cfg3", "cfg3_full_width", "reduced3", "reduced5",
               "pipelined", "over_backfill"]


@pytest.mark.parametrize("case,bucket", BATCHED_CASES, ids=BATCHED_IDS)
def test_batched_allocate_kernel_matches_plain(case, bucket):
    _need_cuda()
    args, statics = prepare_batched(build_cycle_inputs(
        OpenSession(_cache(case, "cuda"), shipped_tiers())),
        compact_bucket=bucket)
    n0 = _build.launch_count("batched_allocate")
    got = batched_allocate(**args, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("batched_allocate") == n0 + 1
    want = batched_allocate_plain(**{k: v.cpu() for k, v in args.items()},
                                  **statics)
    _assert_bitwise(want, [g.cpu() for g in got], "batched_allocate")


def test_batched_cycle_on_the_card_binds_what_the_cpu_binds():
    """A whole allocate cycle in auto at >= 512 pending runs the batched
    engine on the card and on the CPU, with one counted device->host
    copy each, and binds the same pods to the same nodes in the same
    order."""
    _need_cuda()
    from kubebatch_tpu_torch.actions import allocate as allocate_mod

    calls = {}
    for device in ("cuda", "cpu"):
        binder = _Binder()
        cache = _cache((REDUCED5_B, None), device, binder)
        ssn = OpenSession(cache, shipped_tiers())
        rb0 = metrics.blocking_readbacks()
        AllocateAction(mode="auto").execute(ssn)
        assert allocate_mod.last_cycle_engine == "batched"
        assert metrics.blocking_readbacks() - rb0 == 1
        CloseSession(ssn)
        calls[device] = binder.calls
    assert calls["cuda"] and calls["cuda"] == calls["cpu"]


# ---- hand-built clusters for the batched kernel's other branches ----------

def _node(name, cpu, mem, pods):
    alloc = resource_list(cpu=cpu, memory=mem, pods=pods)
    return Node(name=name, allocatable=dict(alloc), capacity=dict(alloc))


def _pod(name, node_name, phase, cpu, mem, group, priority=None,
         created=0.0):
    return Pod(uid=f"ns-{name}", name=name, namespace="ns",
               node_name=node_name, phase=phase,
               containers=[Container(requests=resource_list(cpu=cpu,
                                                            memory=mem))],
               annotations={GROUP_NAME_ANNOTATION: group},
               priority=priority, creation_timestamp=created)


def _contended(seed):
    """Demand ~2x capacity with random gang sizes and priorities over two
    queues: conflicts, kills and stranded gangs."""
    rng = np.random.default_rng(seed)
    nodes = [_node(f"n{i:03d}", 4000, 8 * GiB, 12) for i in range(8)]
    groups, pods = [], []
    for j in range(40):
        n_pods = int(rng.integers(1, 7))
        groups.append(PodGroup(name=f"pg{j:03d}", namespace="ns",
                               min_member=int(rng.integers(1, n_pods + 1)),
                               queue="q1" if j % 2 else "q2",
                               creation_timestamp=float(j)))
        for q in range(n_pods):
            pods.append(_pod(f"j{j:03d}-p{q}", "", PodPhase.PENDING,
                             int(rng.integers(1, 5)) * 500,
                             int(rng.integers(1, 7)) * GiB // 2,
                             f"pg{j:03d}", int(rng.integers(0, 3)),
                             float(q)))
    return nodes, groups, pods


def _overused_queue():
    """q2's running pods hold more than its deserved share in every
    resource: q2 is overused from the start."""
    nodes = [_node(f"n{i}", 8000, 16 * GiB, 110) for i in range(4)]
    groups = [PodGroup(name="pg-fill", namespace="ns", min_member=1,
                       queue="q2")]
    pods = [_pod(f"fill{i}", f"n{i}", PodPhase.RUNNING, 7000, 14 * GiB,
                 "pg-fill") for i in range(4)]
    for j in range(12):
        groups.append(PodGroup(name=f"pg{j}", namespace="ns", min_member=2,
                               queue="q2" if j % 3 == 0 else "q1",
                               creation_timestamp=1.0 + j))
        pods += [_pod(f"j{j}-p{i}", "", PodPhase.PENDING, 500, GiB,
                      f"pg{j}") for i in range(4)]
    return nodes, groups, pods


def _compact_shape():
    """80 jobs x 30 pods on 6 nodes: 2,400 tasks, T_pad 4096; with a
    bucket of 512 the post-round-0 continuation runs compact."""
    rng = np.random.default_rng(7)
    nodes = [_node(f"n{i}", 4000, 8 * GiB, 40) for i in range(6)]
    groups, pods = [], []
    for j in range(80):
        groups.append(PodGroup(name=f"pg{j:03d}", namespace="ns",
                               min_member=1, queue="q1",
                               creation_timestamp=float(j)))
        for q in range(30):
            pods.append(_pod(f"j{j:03d}-p{q}", "", PodPhase.PENDING,
                             int(rng.integers(1, 9)) * 100,
                             int(rng.integers(1, 5)) * GiB // 4,
                             f"pg{j:03d}", created=float(q)))
    return nodes, groups, pods


NO_GANG_TIERS = [
    Tier(plugins=[PluginOption(name="priority"),
                  PluginOption(name="conformance")]),
    Tier(plugins=[PluginOption(name="drf"),
                  PluginOption(name="predicates"),
                  PluginOption(name="proportion"),
                  PluginOption(name="nodeorder")]),
]

#: (cluster maker, tiers: None = shipped, compact bucket)
FIXTURE_CASES = [(lambda: _contended(1), None, None),
                 (lambda: _contended(3), NO_GANG_TIERS, None),
                 (_overused_queue, None, None),
                 (_compact_shape, None, 512)]
FIXTURE_IDS = ["contended", "without_gang", "overused_queue",
               "compact_bucket"]


@pytest.mark.parametrize("make_cluster,tiers,bucket", FIXTURE_CASES,
                         ids=FIXTURE_IDS)
def test_batched_allocate_kernel_matches_plain_on_fixtures(make_cluster,
                                                           tiers, bucket):
    _need_cuda()
    nodes, groups, pods = make_cluster()
    cache = SchedulerCache(async_writeback=False, device="cuda")
    for q in ("q1", "q2"):
        cache.add_queue(Queue(name=q, weight=1))
    for n in nodes:
        cache.add_node(n)
    for g in groups:
        cache.add_pod_group(g)
    for p in pods:
        cache.add_pod(p)
    ssn = OpenSession(cache, tiers if tiers is not None else shipped_tiers())
    args, statics = prepare_batched(build_cycle_inputs(ssn),
                                    compact_bucket=bucket)
    got = batched_allocate(**args, **statics)
    torch.cuda.synchronize()
    want = batched_allocate_plain(**{k: v.cpu() for k, v in args.items()},
                                  **statics)
    _assert_bitwise(want, [g.cpu() for g in got], "batched_allocate")
    assert statics["gang_enabled"] == (tiers is None)
