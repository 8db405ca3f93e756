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


# ---------------------------------------------------------------------
# the victim kernels (kernels/csrc/victims.cu)
# ---------------------------------------------------------------------

class World:
    """Fixture builders bound to one package's objects module (the
    reference's tests/fixtures.py, for either package; the CPU parity
    tests build the same worlds in the reference's objects too)."""

    def __init__(self, mod):
        self.m = mod

    def rl(self, cpu_milli=0.0, mem_bytes=0.0, gpu_milli=0.0, pods=0.0):
        return self.m.resource_list(cpu=cpu_milli, memory=mem_bytes,
                                    gpu=gpu_milli, pods=pods)

    def node(self, name, alloc):
        return self.m.Node(name=name, allocatable=dict(alloc),
                           capacity=dict(alloc))

    def pod(self, ns, name, node_name, running, req, group="",
            priority=None, backfill=False, **kw):
        m = self.m
        ann = {}
        if group:
            ann[m.GROUP_NAME_ANNOTATION] = group
        if backfill:
            ann[m.BACKFILL_ANNOTATION] = "true"
        return m.Pod(uid=f"{ns}-{name}", name=name, namespace=ns,
                     node_name=node_name,
                     phase=m.PodPhase.RUNNING if running
                     else m.PodPhase.PENDING,
                     containers=[m.Container(requests=dict(req))],
                     annotations=ann, priority=priority, **kw)

    def group(self, ns, name, min_member, queue=""):
        return self.m.PodGroup(name=name, namespace=ns,
                               min_member=min_member, queue=queue)

    def queue(self, name, weight=1):
        return self.m.Queue(name=name, weight=weight)


def contended_build(seed, n_nodes=24, n_fill=60, n_gangs=18):
    """The reference tests' contended world (tests/test_victims.py
    ``_contended_build``): running fill across 3 weighted queues and many
    pending gangs wanting preemption/reclaim."""
    rng = np.random.default_rng(seed)
    caps = [(int(rng.integers(4, 9)) * 1000, int(rng.integers(8, 17)) * GiB)
            for _ in range(n_nodes)]
    fills = [(f"fill-{i:03d}", int(rng.integers(0, n_nodes)),
              int(rng.integers(1, 4)) * 500, int(rng.integers(1, 4)) * GiB,
              int(rng.integers(0, 3)), int(rng.integers(1, 10)))
             for i in range(n_fill)]
    gangs = []
    for g in range(n_gangs):
        size = int(rng.integers(1, 4))
        gangs.append((f"gang-{g:02d}", size, max(1, size - 1),
                      int(rng.integers(1, 4)) * 500,
                      int(rng.integers(1, 4)) * GiB,
                      int(rng.integers(0, 3)), int(rng.integers(50, 200))))

    def build(cache, w):
        for q in range(3):
            cache.add_queue(w.queue(f"q{q}", weight=q + 1))
        for i, (cpu, mem) in enumerate(caps):
            cache.add_node(w.node(f"n{i:02d}", w.rl(cpu, mem, pods=12)))
        for name, node, cpu, mem, q, pri in fills:
            cache.add_pod_group(w.group("ns", name, 1, queue=f"q{q}"))
            cache.add_pod(w.pod("ns", f"{name}-0", f"n{node:02d}", True,
                                w.rl(cpu, mem), group=name, priority=pri))
        for name, size, minav, cpu, mem, q, pri in gangs:
            cache.add_pod_group(w.group("ns", name, minav, queue=f"q{q}"))
            for i in range(size):
                cache.add_pod(w.pod("ns", f"{name}-{i}", "", False,
                                    w.rl(cpu, mem), group=name,
                                    priority=pri))

    return build


def random_problem(seed, n_pad=64, n_real=50, v_pad=512, n_jobs=40,
                   n_queues=3, s_pad=8, lanes=16, guard_heavy=False):
    """A seeded victim problem in the reference's layout: rows in node
    slots, jobs and queues with random state, orderings built the way
    VictimState builds them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    v_node = np.sort(rng.integers(0, n_real, v_pad)).astype(np.int32)
    v_node[-v_pad // 8:] = 0                      # dead tail rows
    v_job = rng.integers(-1, n_jobs, v_pad).astype(np.int32)
    v_res = (rng.integers(1, 9, (v_pad, 3)) * np.array(
        [250.0, 512.0, 125.0]) * rng.choice([1.0, 1.0, 0.999], (v_pad, 3))
             ).astype(f32)
    v_res[rng.random(v_pad) < 0.5, 2] = 0.0
    v_crit = rng.random(v_pad) < 0.1
    v_live = (rng.random(v_pad) < 0.85) & (v_job >= 0)
    v_live[-v_pad // 8:] = False
    j_pad = 64
    job_queue = np.full(j_pad, -1, np.int32)
    job_queue[:n_jobs] = rng.integers(-1, n_queues, n_jobs)
    ready_cnt = np.zeros(j_pad, np.int32)
    ready_cnt[:n_jobs] = rng.integers(0, 6, n_jobs)
    min_av = np.zeros(j_pad, np.int32)
    min_av[:n_jobs] = rng.integers(1, 5, n_jobs)
    j_alloc = np.zeros((j_pad, 3), f32)
    j_alloc[:n_jobs] = (rng.uniform(0, 8000, (n_jobs, 3))
                        * [1, 2, 0]).astype(f32)
    q_pad = 4
    scale = 0.02 if guard_heavy else 1.0
    q_alloc = (rng.uniform(2000, 60000, (q_pad, 3)) * [1, 2, 0.1]
               * scale).astype(f32)
    q_deserved = (q_alloc * rng.uniform(0.3, 1.1, (q_pad, 3))).astype(f32)
    q_prop_ok = rng.random(q_pad) < 0.9
    cluster_total = np.asarray([200000.0, 400000.0,
                                rng.choice([0.0, 20000.0])], f32)
    nj_key = (v_node.astype(np.int64) << 32) + v_job.astype(np.int64) \
        + (1 << 31)
    perm_nj = np.argsort(nj_key, kind="stable").astype(np.int32)
    njs = nj_key[perm_nj]
    nj_head = np.ones(v_pad, bool)
    nj_head[1:] = njs[1:] != njs[:-1]
    vq = np.where(v_job >= 0, job_queue[np.maximum(v_job, 0)], -1)
    nq_key = (v_node.astype(np.int64) << 32) + vq.astype(np.int64) \
        + (1 << 31)
    perm_nq = np.argsort(nq_key, kind="stable").astype(np.int32)
    nqs = nq_key[perm_nq]
    nq_head = np.ones(v_pad, bool)
    nq_head[1:] = nqs[1:] != nqs[:-1]
    node_ok = np.zeros(n_pad, bool)
    node_ok[:n_real] = rng.random(n_real) < 0.9
    max_task_num = np.zeros(n_pad, np.int32)
    max_task_num[:n_real] = rng.integers(2, 20, n_real)
    n_tasks = np.zeros(n_pad, np.int32)
    n_tasks[:n_real] = rng.integers(0, 20, n_real)
    cap = np.zeros((n_pad, 2), f32)
    cap[:n_real] = rng.uniform(4000, 16000, (n_real, 2))
    nz_req = (cap * rng.uniform(0, 1.05, (n_pad, 2))).astype(f32)
    host_rank = np.full(n_pad, np.iinfo(np.int32).max, np.int32)
    host_rank[:n_real] = rng.permutation(n_real)
    dyn_w = np.asarray([1.0, 1.0], f32)
    sig_scores = rng.integers(0, 3, (s_pad, n_pad)).astype(f32)
    sig_pred = rng.random((s_pad, n_pad)) < 0.8
    static = (node_ok, max_task_num, cap, host_rank, v_node, v_job, v_res,
              v_crit, perm_nj, nj_head, perm_nq, nq_head, min_av,
              job_queue, q_deserved, q_prop_ok, cluster_total, dyn_w)
    mutable = (n_tasks, nz_req, v_live, ready_cnt, j_alloc, q_alloc)
    sig = (sig_scores, sig_pred)
    p_res = (rng.integers(1, 12, (lanes, 3)) * [250.0, 512.0, 0.0]
             ).astype(f32)
    p_resreq = (p_res * rng.choice([1.0, 0.5], (lanes, 1))).astype(f32)
    p_nz = np.maximum(p_resreq[:, :2], [100.0, 200.0]).astype(f32)
    p_sig = rng.integers(0, s_pad, lanes).astype(np.int32)
    p_job = rng.integers(0, n_jobs, lanes).astype(np.int32)
    p_queue = np.where(job_queue[p_job] >= 0, job_queue[p_job],
                       0).astype(np.int32)
    # the last two lanes are pads, as a wave's tail is
    p_res[-2:] = 0.0
    p_resreq[-2:] = 0.0
    p_nz[-2:] = 0.0
    p_sig[-2:] = 0
    p_job[-2:] = -1
    p_queue[-2:] = -1
    lanes_t = (p_res, p_resreq, p_nz, p_sig, p_job, p_queue)
    return static, mutable, sig, lanes_t



PREEMPT_TIERS = (("gang", "conformance"), ("drf",))
RECLAIM_TIERS = (("gang", "conformance"), ("proportion",))

#: (filter_kind, tiers, veto_critical, dyn_enabled, score_nodes,
#: room_check, guard_heavy)
VICTIM_CASES = [
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False),
    ("intra_job", PREEMPT_TIERS, True, True, True, True, False),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, False),
    ("other_queue", RECLAIM_TIERS, False, False, False, False, True),
]


def _victim_tensors(problem, device, visited=None):
    from kubebatch_tpu_torch.interop import victim_inputs_from_numpy

    static, mutable, sig, lanes = problem
    return victim_inputs_from_numpy(static, mutable, sig, lanes, device,
                                    visited=visited)


@pytest.mark.parametrize("case", VICTIM_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(VICTIM_CASES)])
def test_victim_kernels_match_plain(case):
    _need_cuda()
    from kubebatch_tpu_torch.kernels import victims

    fk, tiers, veto, dyn, score, room, guard_heavy = case
    cfg = dict(tiers=tiers, veto_critical=veto, filter_kind=fk,
               dyn_enabled=dyn, score_nodes=score, room_check=room)
    problem = random_problem(VICTIM_CASES.index(case), lanes=40,
                             guard_heavy=guard_heavy)
    kw = _victim_tensors(problem, "cuda")
    _build.reset_launch_counts()
    got = victims.victim_wave(**kw, **cfg)
    torch.cuda.synchronize()
    assert _build.launch_count("victim_wave") == 1
    want = victims.wave_plain(**_victim_tensors(problem, "cpu"), **cfg)
    _assert_bitwise([want], [got.cpu()], f"victim_wave {fk}")
    n_pad = problem[0][0].shape[0]
    rng = np.random.default_rng(1)
    for i in range(6):
        visited = rng.random(n_pad) < 0.3
        if i == 3:
            visited[:] = True                    # not found
        one = tuple(tuple(a[i:i + 1] for a in problem[3]))
        prob = problem[:3] + (one,)
        got = victims.victim_visit(**_victim_tensors(prob, "cuda", visited),
                                   **cfg)
        torch.cuda.synchronize()
        want = victims.visit_plain(**_victim_tensors(prob, "cpu", visited),
                                   **cfg)
        _assert_bitwise([want], [got.cpu()], f"victim_visit {fk} lane {i}")
    assert _build.launch_count("victim_visit") == 6


@pytest.mark.parametrize("seed", [3, 17])
def test_contended_victim_cycle_on_the_card_decides_as_the_cpu(seed):
    """reclaim + allocate + backfill + preempt on a contended world: a
    CUDA cache (the victim kernels launch) decides exactly as a CPU
    cache (their plain versions)."""
    _need_cuda()
    from kubebatch_tpu_torch import objects
    from kubebatch_tpu_torch.framework.registry import get_action

    results = []
    for device in ("cpu", "cuda"):
        evicted = []

        class Rec:
            def bind(self, pod, hostname):
                pod.node_name = hostname

            def evict(self, pod):
                evicted.append(pod.name)
                pod.deletion_timestamp = 1.0

        cache = SchedulerCache(binder=Rec(), evictor=Rec(),
                               async_writeback=False, device=device)
        contended_build(seed)(cache, World(objects))
        _build.reset_launch_counts()
        ssn = OpenSession(cache, shipped_tiers())
        for name in ("reclaim", "allocate", "backfill", "preempt"):
            act = get_action(name)
            if name == "allocate":
                act = AllocateAction(mode="host")
            act.execute(ssn)
        statuses = {t.key: (t.status.name, t.node_name)
                    for j in ssn.jobs.values() for t in j.tasks.values()}
        CloseSession(ssn)
        launches = (_build.launch_count("victim_wave")
                    + _build.launch_count("victim_visit"))
        results.append((statuses, sorted(evicted), launches))
    assert results[0][:2] == results[1][:2]
    assert results[0][1], "the contended world must evict"
    assert results[0][2] == 0 and results[1][2] > 0


@pytest.mark.parametrize("k,dups", [(1, 0), (300, 60), (512, 0)],
                         ids=["one-row", "duplicates", "every-row"])
def test_scatter_rows_kernel_matches_plain(k, dups):
    """The dirty-row scatter (csrc/scatter_rows.cu) against its plain
    version: one row, a few hundred with duplicate rows (identical
    values), and every row of N_pad."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import solver

    rng = np.random.default_rng(k)
    n_pad = 512
    base = [rng.uniform(0, 100, (n_pad, 3)).astype(np.float32)
            for _ in range(3)]
    base += [rng.uniform(0, 100, (n_pad, 2)).astype(np.float32)
             for _ in range(2)]
    base += [rng.integers(0, 110, n_pad).astype(np.int32)
             for _ in range(2)]
    base.append(rng.random(n_pad) < 0.5)
    n_unique = k - dups
    idx = rng.choice(n_pad, size=n_unique, replace=False).astype(np.int32)
    rows = [rng.uniform(-5, 5, (n_unique, 3)).astype(np.float32)
            for _ in range(3)]
    rows += [rng.uniform(-5, 5, (n_unique, 2)).astype(np.float32)
             for _ in range(2)]
    rows += [rng.integers(0, 110, n_unique).astype(np.int32)
             for _ in range(2)]
    rows.append(rng.random(n_unique) < 0.5)
    if dups:
        rep = rng.integers(0, n_unique, dups)
        idx = np.concatenate([idx, idx[rep]])
        rows = [np.concatenate([r, r[rep]]) for r in rows]
    block = solver.pack_scatter_rows(idx, *rows, n_pad=n_pad)
    want = tuple(torch.from_numpy(a.copy()) for a in base)
    solver.scatter_rows_plain(want, torch.from_numpy(block))
    got = tuple(torch.from_numpy(a.copy()).cuda() for a in base)
    n0 = _build.launch_count("scatter_rows")
    solver.scatter_rows(got, torch.from_numpy(block).cuda())
    torch.cuda.synchronize()
    assert _build.launch_count("scatter_rows") == n0 + 1
    _assert_bitwise(want, [g.cpu() for g in got], "scatter_rows")


def test_folded_cycles_on_the_card_decide_as_the_cpu():
    """Six folded four-action cycles (skewed churn on a reduced cfg5) on
    an incremental CUDA cache decide exactly as on an incremental CPU
    cache; the CUDA cache refreshes its DeviceSession rows through the
    scatter kernel and never rebuilds it while the node set holds."""
    _need_cuda()
    import dataclasses

    from kubebatch_tpu_torch.framework.registry import get_action

    spec = dataclasses.replace(BASELINE_SPECS[5], n_nodes=128, n_groups=64)
    results = []
    for device in ("cpu", "cuda"):
        binds, evicted = {}, []

        class Rec:
            def bind(self, pod, hostname):
                binds[pod.name] = hostname
                pod.node_name = hostname

            def evict(self, pod):
                evicted.append(pod.name)
                pod.deletion_timestamp = 1.0

        sim = build_cluster(spec)
        cache = SchedulerCache(binder=Rec(), evictor=Rec(),
                               async_writeback=False, device=device)
        assert cache._incremental
        sim.populate(cache)
        per_cycle = []
        for k in range(6):
            if k:
                for pod in sim.pods:
                    if pod.node_name and pod.phase == PodPhase.PENDING:
                        pod.phase = PodPhase.RUNNING
                        cache.update_pod(pod, pod)
                sim.churn_tick(cache, 64, arrival_queue=0 if k % 2 else 3)
            _build.reset_launch_counts()
            adopted = cache._dev_state
            ssn = OpenSession(cache, shipped_tiers())
            for name in ("reclaim", "allocate", "backfill", "preempt"):
                get_action(name).execute(ssn)
            statuses = {t.key: (t.status.name, t.node_name)
                        for j in ssn.jobs.values() for t in j.tasks.values()}
            reused = ssn.device_snapshot is adopted and adopted is not None
            CloseSession(ssn)
            per_cycle.append((statuses, dict(binds), sorted(evicted),
                              _build.launch_count("scatter_rows"), reused))
        results.append(per_cycle)
    for k, (c, g) in enumerate(zip(*results)):
        assert c[:3] == g[:3], f"cycle {k}"
        assert c[3] == 0
        if k:
            assert g[3] >= 1 and g[4], f"cycle {k}: no row refresh"


# ---- the affinity vocabulary (B12) -----------------------------------------

class AffWorld:
    """Affinity scenario constructors bound to one package's objects module
    (the CPU parity tests build the same worlds in the reference's
    objects too)."""

    def __init__(self, mod):
        self.m = mod

    def rl(self, cpu, mem, pods=110):
        return self.m.resource_list(cpu=cpu, memory=mem, gpu=0.0, pods=pods)

    def node(self, name, cpu=8000, mem=16 * GiB, labels=None):
        alloc = self.rl(cpu, mem)
        return self.m.Node(name=name, allocatable=dict(alloc),
                           capacity=dict(alloc), labels=dict(labels or {}))

    def pod(self, name, node="", req=(500, GiB), group="", labels=None,
            affinity=None, ports=(), running=False, ns="e2e", priority=None):
        m = self.m
        ann = {m.GROUP_NAME_ANNOTATION: group} if group else {}
        return m.Pod(uid=f"{ns}-{name}", name=name, namespace=ns,
                     node_name=node,
                     phase=m.PodPhase.RUNNING if running
                     else m.PodPhase.PENDING,
                     containers=[m.Container(
                         requests=dict(self.rl(req[0], req[1], 0)),
                         ports=list(ports))],
                     annotations=ann, labels=dict(labels or {}),
                     affinity=affinity, priority=priority)

    def group(self, name, min_member, queue="default"):
        return self.m.PodGroup(name=name, namespace="e2e",
                               min_member=min_member, queue=queue)

    def queue(self, name="default", weight=1):
        return self.m.Queue(name=name, weight=weight)

    def term(self, labels, topo="kubernetes.io/hostname"):
        return self.m.PodAffinityTerm(match_labels=dict(labels),
                                      topology_key=topo)

    def anti(self, labels, topo="kubernetes.io/hostname"):
        return self.m.Affinity(pod_anti_affinity_required=[
            self.term(labels, topo)])

    def aff(self, labels, topo="kubernetes.io/hostname"):
        return self.m.Affinity(pod_affinity_required=[
            self.term(labels, topo)])

    def pref(self, weight, labels, topo="kubernetes.io/hostname"):
        return self.m.Affinity(pod_affinity_preferred=[
            (weight, self.term(labels, topo))])

    def hostname_nodes(self, cache, n, cpu=8000, zone_of=None):
        for i in range(n):
            labels = {"kubernetes.io/hostname": f"n{i}"}
            if zone_of:
                labels["zone"] = zone_of(i)
            cache.add_node(self.node(f"n{i}", cpu=cpu, labels=labels))


def aff_rollback_build(cache, w):
    """Anti-affine 3-gangs over 4 hostnames beside gangs with preferred
    co-location and a host port: contended enough that partial gangs
    strand and the epilogue subtracts their carry."""
    w.hostname_nodes(cache, 4, cpu=2000, zone_of=lambda i: f"z{i % 2}")
    for j in range(5):
        cache.add_pod_group(w.group(f"g{j}", 3))
        for p in range(3):
            cache.add_pod(w.pod(
                f"g{j}-{p}", req=(700, GiB), group=f"g{j}",
                labels={"app": f"a{j % 2}"},
                affinity=(w.anti({"app": f"a{j % 2}"}) if j % 2 == 0
                          else w.pref(5, {"app": "a0"})),
                ports=[9000 + j] if j == 3 else ()))


def aff_compact_build(cache, w):
    """1,200 pending tasks (T_pad 2,048) on 40 roomy nodes: round 0
    places most of them and leaves a few hundred — the anti-affine jobs'
    serialized replicas, port claimants — for the rounds on the compact
    bucket. Every 12th job anti-affine, some with preferred terms or
    host ports."""
    rng = np.random.default_rng(7)
    w.hostname_nodes(cache, 40, cpu=16000, zone_of=lambda i: f"z{i % 2}")
    for j in range(60):
        cache.add_pod_group(w.group(f"pg{j:03d}", 1))
        for p in range(20):
            affinity, ports = None, ()
            if j % 12 == 0:
                affinity = w.anti({"app": f"a{j % 4}"})
            elif j % 7 == 1:
                affinity = w.pref(3, {"app": f"a{(j + 1) % 4}"})
            if j % 11 == 2:
                ports = [7000 + p % 3]
            cache.add_pod(w.pod(
                f"j{j:03d}-p{p}", group=f"pg{j:03d}",
                req=(int(rng.integers(1, 9)) * 100,
                     int(rng.integers(1, 5)) * GiB // 32),
                labels={"app": f"a{j % 4}"}, affinity=affinity,
                ports=ports))


T_AFF = AffWorld(__import__("kubebatch_tpu_torch.objects",
                            fromlist=["objects"]))

#: the affinity kernel's cases: predicate-rich cold cycles, the stranded
#: rollback, the compact bucket
AFF_CASES = ["2p", "3p", "5p", "rollback", "compact"]


def _aff_cache(case, device):
    cache = SchedulerCache(async_writeback=False, device=device)
    if case in ("rollback", "compact"):
        cache.add_queue(T_AFF.queue())
        (aff_rollback_build if case == "rollback"
         else aff_compact_build)(cache, T_AFF)
    else:
        build_cluster(BASELINE_SPECS[case]).populate(cache)
    return cache


def assert_affinity_kernel_matches_plain(args, statics):
    """One launch of the batched kernel with affinity against the plain
    engine on CPU copies: packed result, node carry and the affinity
    carry, bit for bit."""
    n0 = _build.launch_count("batched_allocate")
    got = batched_allocate(**args, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("batched_allocate") == n0 + 1
    cpu_statics = dict(statics, aff={k: v.cpu()
                                     for k, v in statics["aff"].items()})
    want = batched_allocate_plain(**{k: v.cpu() for k, v in args.items()},
                                  **cpu_statics)
    _assert_bitwise(want[:5], [g.cpu() for g in got[:5]], "batched_allocate")
    for name, w in want[5].items():
        g = got[5][name]
        assert (w is None) == (g is None), name
        if w is not None:
            _assert_bitwise([w], [g.cpu()], name)
    return want


@pytest.mark.parametrize("case", AFF_CASES)
def test_batched_affinity_kernel_matches_plain(case):
    _need_cuda()
    inputs = build_cycle_inputs(OpenSession(_aff_cache(case, "cuda"),
                                            shipped_tiers()),
                                allow_affinity=True)
    assert inputs.affinity is not None
    args, statics = prepare_batched(inputs)
    want = assert_affinity_kernel_matches_plain(args, statics)
    t_pad = inputs.task_valid.shape[0]
    if case == "compact":
        # (tests/test_torch_affinity.py shows the case takes the compact
        # branch)
        assert 0 < statics["compact_bucket"] < t_pad
    if case == "rollback":
        telem = want[0][3 * t_pad + 1:]
        assert int(telem[14]) > 0 or int(telem[15]) > 0


# ---------------------------------------------------------------------
# the per-visit allocate scan (csrc/allocate_scan.cu)
# ---------------------------------------------------------------------

def _scan_inputs(seed: int, n: int, t: int, edge: bool = False):
    """allocate_scan arguments on the card from a numpy seed: a partly
    used cluster (the last tenth padding when n > 64) with releasing and
    lendable capacity; ``edge`` adds -0.0 rows and ties, an all-masked
    task row and an unfittable task."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
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
        ok[-(n // 10):] = False
    req = np.stack([rng.uniform(100, 2000, t), rng.uniform(100, 4000, t),
                    np.zeros(t)], 1).astype(f32)
    valid = np.arange(t) < max(1, t - int(rng.integers(0, 3)))
    req[~valid] = 0.0
    scores = rng.integers(0, 5, (t, n)).astype(f32)
    pred = rng.random((t, n)) < 0.8
    init = req.copy()
    if edge:
        idle[: n // 4, 2] = -0.0
        nz[n // 4: n // 2] = -0.0
        scores[:, ::2] = -0.0
        scores[:, 1::2] = 0.0
        pred[0] = False
        if t > 2:
            init[2, 0] = 1e9
    kw = {"idle": idle, "releasing": rel, "backfilled": back,
          "allocatable_cm": cap, "nz_req": nz,
          "max_task_num": rng.integers(1, 6, n).astype(np.int32),
          "n_tasks": rng.integers(0, 5, n).astype(np.int32),
          "node_ok": ok, "resreq": req, "init_resreq": init,
          "task_nz": req[:, :2].copy(), "task_valid": valid,
          "scores": scores, "pred_mask": pred,
          "dyn_weights": np.array([1.0, 1.0], f32)}
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
           for k, v in kw.items()}
    out["min_available"] = int(rng.integers(0, t + 2))
    out["init_allocated"] = int(rng.integers(0, 3))
    return out


SCAN_CASES = [(8, 1, False), (64, 8, False), (1000, 33, False),
              (1000, 8, True), (8192, 8, False), (8192, 8, True),
              (5000, 64, False)]


@pytest.mark.parametrize("n,t,edge", SCAN_CASES,
                         ids=[f"N{n}-T{t}{'-edge' if e else ''}"
                              for n, t, e in SCAN_CASES])
@pytest.mark.parametrize("dyn", [False, True], ids=["static", "dyn"])
def test_allocate_scan_kernel_matches_plain(n, t, edge, dyn):
    """One launch per call; the packed block and the carry bitwise equal
    to the plain scan on the same card tensors; the inputs untouched."""
    from kubebatch_tpu_torch.kernels.solver import (allocate_scan,
                                                    allocate_scan_plain)

    _need_cuda()
    for seed in range(3):
        kw = _scan_inputs(100 * n + t + seed, n, t, edge)
        before = {k: v.clone() for k, v in kw.items()
                  if isinstance(v, torch.Tensor)}
        n0 = _build.launch_count("allocate_scan")
        got = allocate_scan(**kw, dyn_enabled=dyn)
        torch.cuda.synchronize()
        assert _build.launch_count("allocate_scan") == n0 + 1
        for k, v in before.items():
            assert torch.equal(kw[k], v), k
        _assert_bitwise(allocate_scan_plain(**kw, dyn_enabled=dyn), got,
                        "allocate_scan")


class FifoOrder:
    """A custom job-order plugin (creation order): outside every
    whole-cycle engine's key vocabulary, while the predicates and scores
    stay device terms, so allocate takes the per-visit scan. Duck-typed:
    the parity tests register this same class with the reference's
    registry too."""

    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self):
        return "fifo-order"

    def on_session_open(self, ssn):
        def job_order_fn(l, r):
            return (l.creation_timestamp > r.creation_timestamp) \
                - (l.creation_timestamp < r.creation_timestamp)
        ssn.add_job_order_fn("fifo-order", job_order_fn)

    def on_session_close(self, ssn):
        pass


def b8_tiers():
    """The shipped tiers with the custom job-order plugin in front."""
    from kubebatch_tpu_torch.framework.registry import \
        register_plugin_builder

    register_plugin_builder("fifo-order", FifoOrder)
    tiers = shipped_tiers()
    tiers[0].plugins.insert(0, PluginOption(name="fifo-order"))
    return tiers


@pytest.mark.parametrize("mode,custom", [("jax", False), ("fused", True),
                                         ("batched", True)])
@pytest.mark.parametrize("case", [(BASELINE_SPECS[2], None), (REDUCED5, None),
                                  (FILLED, "releasing"),
                                  (FILLED, "backfill")],
                         ids=["cfg2", "reduced5", "pipelined",
                              "over_backfill"])
def test_visit_cycle_on_the_card_binds_what_the_cpu_binds(case, mode,
                                                          custom):
    """A whole per-visit cycle on the card — asked for, or behind a
    whole-cycle engine refusing a custom job order — equals the CPU
    cycle: the engine label, the binds in order, one kernel launch and
    one counted copy back per visit."""
    from kubebatch_tpu_torch.actions import allocate as allocate_mod

    _need_cuda()
    out = {}
    for device in ("cuda", "cpu"):
        binder = _Binder()
        cache = _cache(case, device, binder)
        ssn = OpenSession(cache, b8_tiers() if custom else shipped_tiers())
        rb0 = metrics.blocking_readbacks()
        n0 = _build.launch_count("allocate_scan")
        AllocateAction(mode=mode).execute(ssn)
        launches = _build.launch_count("allocate_scan") - n0
        syncs = metrics.blocking_readbacks() - rb0
        CloseSession(ssn)
        out[device] = (allocate_mod.last_cycle_engine, binder.calls, syncs)
        if device == "cuda":
            assert launches == syncs > 0
        else:
            assert launches == 0
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] == f"{mode}-visit"


# ---- the two-level and active-set kernel (csrc/hier_allocate.cu) ---------

#: (case, pool width): contended multi-pool solves, with the epilogue
#: (reduced5), pipelined and over-backfill fits, cfg3 at the default pool
HIER_CASES = [((REDUCED5_B, None), 8), ((REDUCED3, None), 8),
              ((BASELINE_SPECS[3], None), 0), ((FILLED, "releasing"), 4),
              ((FILLED, "backfill"), 4)]
HIER_IDS = ["reduced5", "reduced3", "cfg3", "pipelined", "over_backfill"]


def _hier_inputs(case):
    return build_cycle_inputs(OpenSession(_cache(case, "cuda"),
                                          shipped_tiers()))


def _on_cpu(d):
    return {k: v.cpu() for k, v in d.items()}


def _scale_counters():
    """The last hier_allocate launch's work counters, by name."""
    from kubebatch_tpu_torch.kernels import hier

    return dict(zip(hier.COUNTERS,
                    hier.last_launch["counters"].cpu().tolist()))


def _plain_counters(stats):
    from kubebatch_tpu_torch.kernels import hier

    return {k: stats.get(k, 0) for k in hier.COUNTERS}


@pytest.mark.parametrize("case,pool", HIER_CASES, ids=HIER_IDS)
def test_hier_allocate_kernel_matches_plain(case, pool):
    from kubebatch_tpu_torch.kernels.hier import (hier_allocate_plain,
                                                  hier_packed, prepare_hier)

    _need_cuda()
    args, statics = prepare_hier(_hier_inputs(case), pool_size=pool)
    n0 = _build.launch_count("hier_allocate")
    got = hier_packed(**args, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("hier_allocate") == n0 + 1
    counters = _scale_counters()
    stats = {}
    want = hier_allocate_plain(**_on_cpu(args), **statics, stats=stats)
    _assert_bitwise(want, [g.cpu() for g in got], "hier_allocate")
    assert counters == _plain_counters(stats)


@pytest.mark.parametrize("grain", [0, 1024, 4096])
@pytest.mark.parametrize("case", [(REDUCED5_B, None), (BASELINE_SPECS[2],
                                                        None)],
                         ids=["reduced5", "cfg2"])
def test_activeset_kernels_match_plain(case, grain):
    """The active-set mode and the audit mode of the kernel against
    their plain versions: packed result, frame and node carry; the audit
    reports no divergence."""
    from kubebatch_tpu_torch.kernels.activeset import (
        activeset_allocate_plain, activeset_audit_packed,
        activeset_audit_plain, activeset_packed, prepare_activeset,
        prepare_activeset_audit)
    from kubebatch_tpu_torch.kernels.telemetry import F_ACT_DEMOTED

    _need_cuda()
    inputs = _hier_inputs(case)
    args, statics, g = prepare_activeset(inputs, grain=grain, pool_size=8)
    n0 = _build.launch_count("activeset_allocate")
    got = activeset_packed(**args, **statics)
    torch.cuda.synchronize()
    counters, stats = _scale_counters(), {}
    want = activeset_allocate_plain(**_on_cpu(args), **statics, stats=stats)
    _assert_bitwise(want, [x.cpu() for x in got], "activeset_allocate")
    assert counters == _plain_counters(stats)
    node, act, full, statics, _ = prepare_activeset_audit(
        inputs, grain=grain, pool_size=8)
    got = activeset_audit_packed(node, act, full, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("activeset_allocate") == n0 + 2
    counters, stats = _scale_counters(), {}
    want = activeset_audit_plain(_on_cpu(node), _on_cpu(act), _on_cpu(full),
                                 **statics, stats=stats)
    _assert_bitwise(want, [x.cpu() for x in got], "activeset audit")
    assert counters == _plain_counters(stats)
    t = full["task_valid"].shape[0]
    assert int(got[0][3 * t + 1 + F_ACT_DEMOTED]) == 0


def test_two_level_cycles_on_the_card_bind_what_the_cpu_binds(monkeypatch):
    """A cold two-level cycle, then auto at the (lowered) two-level
    threshold: churn cycles run the active set with an audit on its
    cadence; the card binds what the CPU binds, one launch and one
    counted copy a cycle."""
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.kernels import activeset

    _need_cuda()
    monkeypatch.setattr(allocate_mod, "AUTO_HIER_MIN_NODES", 16)
    out = {}
    try:
        for device in ("cuda", "cpu"):
            activeset.reset()
            activeset.set_audit_every(2)
            binder = _Binder()
            sim = build_cluster(REDUCED5_B)
            cache = SchedulerCache(binder=binder, async_writeback=False,
                                   device=device)
            sim.populate(cache)
            trace = []
            for k in range(4):
                if k:
                    for pod in sim.pods:
                        if pod.node_name and pod.phase == PodPhase.PENDING:
                            pod.phase = PodPhase.RUNNING
                            cache.update_pod(pod, pod)
                    sim.churn_tick(cache, 64, arrival_queue=k % 4)
                ssn = OpenSession(cache, shipped_tiers())
                rb0 = metrics.blocking_readbacks()
                n0 = (_build.launch_count("hier_allocate")
                      + _build.launch_count("activeset_allocate"))
                AllocateAction(mode="auto" if k else "hier").execute(ssn)
                launches = (_build.launch_count("hier_allocate")
                            + _build.launch_count("activeset_allocate") - n0)
                assert metrics.blocking_readbacks() - rb0 == 1
                assert launches == (device == "cuda")
                trace.append(allocate_mod.last_cycle_engine)
                CloseSession(ssn)
            out[device] = (trace, binder.calls, activeset.demoted())
    finally:
        activeset.reset()
        activeset.set_audit_every(activeset.DEFAULT_AUDIT_EVERY)
    assert out["cuda"] == out["cpu"]
    assert out["cuda"][0] == ["hier", "activeset", "activeset", "activeset"]
    assert out["cuda"][1] and not out["cuda"][2]


# ---- the unschedulability explainer (csrc/explain_counts.cu) -------------

def _explain_case(t, n, pt, seed, kind="random"):
    """Seeded explain_counts arguments (the CPU tests' generator): ties
    at resreq == idle from one small value grid, a fifth of the nodes
    cordoned, some at their pod cap, a quarter of the task rows padded."""
    rng = np.random.default_rng(seed)
    grid = np.asarray([0.0, 250.0, 500.0, 1000.0, 2048.0], np.float32)
    a = {"idle": rng.choice(grid, (n, 3)).astype(np.float32),
         "node_ok": rng.random(n) < 0.8,
         "n_tasks": rng.integers(0, 6, n).astype(np.int32),
         "max_task_num": rng.integers(1, 6, n).astype(np.int32),
         "sig_pred": rng.random((4, n)) < 0.7,
         "task_sig": rng.integers(0, 4, t).astype(np.int32),
         "task_valid": np.arange(t) < max(1, (3 * t) // 4),
         "resreq": rng.choice(grid, (t, 3)).astype(np.float32),
         "task_ports": rng.random((t, pt)) < 0.15,
         "port_base": rng.random((n, pt)) < 0.15}
    if kind == "cordoned":
        a["node_ok"][:] = False
    elif kind == "full-slots":
        a["max_task_num"] = a["n_tasks"].copy()
    elif kind == "ties":
        a["idle"][0] = -0.0
        a["resreq"][:] = a["idle"][rng.integers(0, n, t)]
    return a


@pytest.mark.parametrize("kind", ["random", "cordoned", "full-slots",
                                  "ties"])
@pytest.mark.parametrize("ports", [(False, 1), (True, 1), (True, 12),
                                   (True, 64)])
@pytest.mark.parametrize("t,n", [(1, 8), (33, 64), (300, 1000),
                                 (1000, 300)])
def test_explain_counts_kernel_matches_plain(t, n, ports, kind):
    from kubebatch_tpu_torch import interop
    from kubebatch_tpu_torch.obs.explain import (explain_counts,
                                                 explain_counts_plain)

    _need_cuda()
    has_ports, pt = ports
    a = _explain_case(t, n, pt, seed=t * 131 + n + pt, kind=kind)
    if kind == "random" and not has_ports:
        a["task_ports"][:] = True          # ignored without has_ports
    args = interop.explain_inputs_from_numpy(a, "cuda")
    c0 = _build.launch_count("explain_counts")
    got = explain_counts(**args, has_ports=has_ports)
    torch.cuda.synchronize()
    assert _build.launch_count("explain_counts") == c0 + 1
    want = explain_counts_plain(
        **interop.explain_inputs_from_numpy(a, "cpu"), has_ports=has_ports)
    _assert_bitwise([want], [got.cpu()], f"explain_counts {t}x{n} {kind}")


def test_explain_counts_refuses_what_the_kernel_does_not_take():
    """Mixed devices, a wrong dtype or a port width past one word raise
    before any launch; CPU tensors run the plain version (no launch)."""
    from kubebatch_tpu_torch import interop
    from kubebatch_tpu_torch.obs.explain import explain_counts

    _need_cuda()
    a = _explain_case(33, 64, 12, seed=1)
    cpu = interop.explain_inputs_from_numpy(a, "cpu")
    card = interop.explain_inputs_from_numpy(a, "cuda")
    c0 = _build.launch_count("explain_counts")
    with pytest.raises(ValueError, match="mixed devices"):
        explain_counts(**dict(card, idle=cpu["idle"]), has_ports=True)
    with pytest.raises(ValueError, match="task_sig"):
        explain_counts(**dict(card, task_sig=card["task_sig"].long()),
                       has_ports=True)
    wide = _explain_case(33, 64, 65, seed=1)
    with pytest.raises(ValueError, match="65 ports"):
        explain_counts(**interop.explain_inputs_from_numpy(wide, "cuda"),
                       has_ports=True)
    explain_counts(**cpu, has_ports=True)
    assert _build.launch_count("explain_counts") == c0


def test_explainer_cycle_on_the_card_matches_a_cpu_cache():
    """Scheduler(explain_unschedulable=True) on a CUDA and a CPU cache fed
    the same 2p cluster: one explain_counts launch on the card, one more
    counted copy than without the explainer, the same snapshot."""
    from kubebatch_tpu_torch.obs import explain
    from kubebatch_tpu_torch.runtime import Scheduler

    _need_cuda()
    conf = open(__file__.replace("tests/test_torch_cuda.py",
                                 "config/kube-batch-conf.yaml")).read()
    out = {}
    for device in ("cuda", "cpu"):
        rb = []
        for on in (False, True):
            sim = build_cluster(BASELINE_SPECS["2p"])
            cache = SchedulerCache(async_writeback=False, device=device)
            sim.populate(cache)
            sched = Scheduler(cache, conf, explain_unschedulable=on)
            c0 = _build.launch_count("explain_counts")
            rb0 = metrics.blocking_readbacks()
            assert sched.run_cycle()
            rb.append(metrics.blocking_readbacks() - rb0)
        snap = dict(explain.latest())
        snap.pop("ts")
        out[device] = (snap, rb[1] - rb[0],
                       _build.launch_count("explain_counts") - c0)
    explain.set_latest(None)
    assert out["cuda"][:2] == out["cpu"][:2]
    assert out["cuda"][1] == 1 and out["cuda"][2] == 1
    assert out["cpu"][2] == 0
