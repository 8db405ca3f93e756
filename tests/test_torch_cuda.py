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


# ---- the fused loop over a thread-block cluster (csrc/fused_body.cuh) -------

def fused_edge_case(seed, kind="drain", n=48, t=160, j=40, q=4, s=5):
    """A hand-built fused problem: numpy arrays by fused_allocate argument
    name, and the statics. Every kind has jobs of 1-8 tasks laid out
    shuffled, task ranks with ties, integer scores with ties, pipelined
    and backfill capacity, padded nodes, jobs and tasks, a task of an
    out-of-range job, and an overused queue (queue 0's deserved share is
    tiny); "drain" adds 20-59 entries past each queue's jobs (long
    job-less runs); "keys" gives job priorities -0.0 beside +0.0 and NaN,
    every job one DRF share, and node scores NaN and -0.0 (jnp.argmax
    takes the first NaN; -0.0 ties +0.0); "big" gives queue 1's jobs priority -inf
    (a key above _lex_argmin's BIG) and the last queue an infinite share.
    Used by the CPU parity tests too (tests/test_torch_kernels.py)."""
    rng = np.random.default_rng(seed)
    f32, i32 = np.float32, np.int32
    cap = np.stack([rng.choice([4000.0, 8000.0, 16000.0], n),
                    rng.choice([8192.0, 16384.0, 65536.0], n),
                    rng.choice([0.0, 0.0, 4.0], n)], axis=1).astype(f32)
    used = (cap * rng.uniform(0.0, 0.9, (n, 3))).astype(f32)
    n_real = n - n // 8
    node = dict(
        idle=(cap - used).astype(f32),
        releasing=(used * rng.choice([0.0, 0.5], (n, 1))).astype(f32),
        backfilled=(used * rng.choice([0.0, 0.25], (n, 1))).astype(f32),
        allocatable_cm=cap[:, :2].copy(), nz_req0=used[:, :2].copy(),
        max_task_num=rng.choice([3, 8, 110], n).astype(i32),
        n_tasks=rng.integers(0, 3, n).astype(i32),
        node_ok=(rng.random(n) < 0.9) & (np.arange(n) < n_real))
    j_real = j - 3
    owner = np.repeat(np.arange(j_real), rng.integers(1, 9, j_real))[:t - 4]
    task_job = np.full(t, -1, i32)
    task_job[rng.permutation(t - 4)[:len(owner)]] = owner
    task_job[t - 2] = j + 5
    req = np.stack([rng.choice([250.0, 500.0, 1000.0, 2000.0], t),
                    rng.choice([512.0, 1024.0, 4096.0], t),
                    rng.choice([0.0, 0.0, 0.0, 1.0], t)],
                   axis=1).astype(f32)
    init = req.copy()
    init[::7] *= f32(1.5)
    job_queue = rng.integers(0, q, j).astype(i32)
    job_valid = np.arange(j) < j_real
    prio = rng.choice([0.0, 1.0, 10.0], j).astype(f32)
    j_alloc0 = (rng.integers(0, 3, (j, 1))
                * np.asarray([[500.0, 1024.0, 0.0]])).astype(f32)
    if kind == "keys":
        prio[rng.random(j) < 0.5] = -0.0
        prio[rng.random(j) < 0.1] = np.nan
        j_alloc0[:] = j_alloc0[0]
    if kind == "big":
        prio[job_queue == 1] = -np.inf
    min_av = np.minimum(rng.integers(1, 5, j),
                        np.bincount(owner, minlength=j)).astype(i32)
    entries = np.bincount(job_queue[job_valid], minlength=q).astype(i32)
    if kind == "drain":
        entries += rng.integers(20, 60, q).astype(i32)
    total = cap[:n_real].sum(axis=0).astype(f32)
    deserved = np.tile(total / q, (q, 1)).astype(f32)
    deserved[0] = np.asarray([1500.0, 3000.0, 0.0], f32)
    q_alloc0 = np.zeros((q, 3), f32)
    if kind == "big":
        deserved[q - 1] = f32(1e-35)
        q_alloc0[q - 1] = f32(1e9)
    cyc = dict(
        resreq=req, init_resreq=init, task_nz=req[:, :2].copy(),
        task_job=task_job, task_rank=rng.integers(0, 4, t).astype(i32),
        task_sig=rng.integers(0, s, t).astype(i32),
        task_valid=(task_job != -1) & (rng.random(t) < 0.95),
        sig_scores=rng.integers(0, 6, (s, n)).astype(f32),
        sig_pred=rng.random((s, n)) < 0.85,
        min_available=min_av, order_min_available=min_av.copy(),
        init_allocated=rng.choice([0, 0, 1], j).astype(i32),
        job_queue=job_queue, job_priority=prio,
        job_create_rank=rng.permutation(j).astype(i32), job_valid=job_valid,
        q_weight=np.ones(q, f32), q_entries=entries,
        q_create_rank=np.arange(q).astype(i32), q_deserved=deserved,
        q_alloc0=q_alloc0, j_alloc0=j_alloc0, cluster_total=total,
        dyn_weights=np.asarray([1.0, 1.0], f32))
    if kind == "keys":
        cyc["sig_scores"][rng.random((s, n)) < 0.05] = np.nan
        cyc["sig_scores"][rng.random((s, n)) < 0.2] = -0.0
    statics = dict(job_keys=("priority", "gang_ready", "drf_share"),
                   queue_keys=("prop_share",), gang_enabled=True,
                   prop_overused=True, dyn_enabled=kind != "big",
                   max_iters=int(t + 3 * j + q + 8 + entries.sum()),
                   narrow=False, narrow_gate=False)
    return {**node, **cyc}, statics


def _edge_tensors(arrays, device):
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _fused_run(args, statics, monkeypatch, cluster):
    """One counted fused_allocate launch at ``cluster`` CTAs (0: the
    kernel's choice), held bitwise against the plain version; returns
    the launch's shape and counters."""
    from kubebatch_tpu_torch.kernels import fused

    monkeypatch.setattr(fused, "CLUSTER", cluster)
    n0 = _build.launch_count("fused_allocate")
    got = fused_allocate(**args, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("fused_allocate") == n0 + 1
    launch = dict(fused.last_launch)
    _assert_bitwise(fused_allocate_plain(**args, **statics), got,
                    f"fused_allocate C={cluster}")
    counts = dict(zip(fused.FUSED_COUNTS,
                      launch["phase_ns"].tolist()[len(fused.FUSED_PHASES):]))
    return launch, counts, got


@pytest.mark.parametrize("cluster", [0, 2, 8, 16])
@pytest.mark.parametrize("kind,seed", [("drain", 0), ("drain", 1),
                                       ("keys", 0), ("keys", 1),
                                       ("big", 0), ("big", 2)])
def test_fused_kernel_matches_plain_on_edge_cases(kind, seed, cluster,
                                                  monkeypatch):
    """Hand-built problems at C = 1 (the node count's choice), 2, 8 and
    16 (past the portable cluster size):
    long job-less runs with max_iters ending inside the last one, NaN /
    -0.0 / equal keys, keys above BIG; every output bitwise the plain
    version's, and the runs consumed a run at a time."""
    _need_cuda()
    arrays, statics = fused_edge_case(seed, kind)
    args = _edge_tensors(arrays, "cuda")
    if kind == "drain":
        whole = fused_allocate_plain(**args, **statics)
        iters = int(whole[0][0, -21])
        statics = dict(statics, max_iters=iters - 5)
    launch, counts, got = _fused_run(args, statics, monkeypatch, cluster)
    assert launch["cluster"] == (cluster or 1)
    if kind == "drain":
        # the last five iterations were job-less pops: cutting them leaves
        # every decision as it was, and the kernel took them as runs
        assert int(got[0][0, -21]) == iters - 5
        assert torch.equal(got[0][:, :-21], whole[0][:, :-21])
        assert counts["runs"] >= 1 and counts["passes"] < iters - 5


@pytest.mark.parametrize("n,j,shared", [
    (32768, 4096, {"node_carries": True, "node_inputs": False,
                   "job_pick": False, "job_updates": False}),
    (65536, 3000, {"node_carries": False, "node_inputs": True,
                   "job_pick": False, "job_updates": False})])
def test_fused_kernel_past_the_shared_budget(n, j, shared, monkeypatch):
    """Shapes whose state does not fit beside the node slice keep those
    groups in their global replicas (L2): the same kernel, bitwise the
    plain version's."""
    _need_cuda()
    arrays, statics = fused_edge_case(3, "drain", n=n, t=2 * j, j=j, q=8)
    launch, _, _ = _fused_run(_edge_tensors(arrays, "cuda"), statics,
                              monkeypatch, 0)
    assert launch["cluster"] == 8
    assert {k: launch["shared"][k] for k in shared} == shared


def test_fused_kernel_one_cta_at_n512(monkeypatch):
    """N_pad 512 takes a cluster of one CTA (block barriers, no DSMEM)
    with every group in shared memory."""
    _need_cuda()
    arrays, statics = fused_edge_case(4, "drain", n=512, t=1024, j=200)
    launch, counts, _ = _fused_run(_edge_tensors(arrays, "cuda"), statics,
                                   monkeypatch, 0)
    assert launch["cluster"] == 1 and all(launch["shared"].values())
    assert counts["runs"] >= 1


def test_mega_fused_waves_past_the_resident_clusters(monkeypatch):
    """A mega launch of more lanes than the card keeps clusters of 8
    resident: the clusters run in waves, every lane bitwise its plain
    solve."""
    from kubebatch_tpu_torch.kernels import fused
    from kubebatch_tpu_torch.kernels.mega import (ARG_NAMES, mega_fused,
                                                  mega_fused_plain)

    _need_cuda()
    monkeypatch.setattr(fused, "CLUSTER", 8)
    kinds = [(0, "drain"), (1, "keys"), (2, "big")]
    cases = [fused_edge_case(seed, kind) for seed, kind in kinds]
    statics = dict(cases[0][1], dyn_enabled=True,
                   max_iters=max(c[1]["max_iters"] for c in cases))
    one = cases[0][0]
    resident = fused.launch_shape(
        one["idle"].shape[0], one["task_valid"].shape[0],
        one["job_valid"].shape[0], one["q_entries"].shape[0],
        lanes=1)["resident_clusters"]
    b = resident + 3
    stacked = [torch.from_numpy(np.stack(
        [cases[i % 3][0][k] for i in range(b)])).cuda() for k in ARG_NAMES]
    got = mega_fused(*stacked, **statics)
    torch.cuda.synchronize()
    assert fused.last_launch["cluster"] == 8
    assert fused.last_launch["waves"] >= 2
    want = [mega_fused_plain(*(a[i:i + 1] for a in stacked), **statics)
            for i in range(3)]
    for i in range(b):
        _assert_bitwise([w[0] for w in want[i % 3]], [g[i] for g in got],
                        f"lane {i}")


#: cfg5's shape cut to 48 nodes with 72 gangs x 8 pods: 576 pending (the
#: batched regime), contended (the stranded-gang epilogue revives)
REDUCED5_B = ClusterSpec(n_nodes=48, n_groups=72, pods_per_group=8,
                         n_queues=4, queue_weights=(1, 2, 3, 4),
                         pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                         jitter=0.2, seed=5)
#: the round chain's stress shapes: task views past the grid chain's
#: threshold (csrc/batched_round.cuh GRID_CHAIN_MIN, 1,024 tasks), so the
#: sorts and segment passes run across the whole grid, with T_pad never a
#: multiple of the grid's 132 blocks (uneven chunks): uniform nodes (every
#: task's round-0 argmax is node 0, 6,000 tasks on 16 nodes: contended),
#: one job of 6,000 tasks (its task ranks take two counting passes), one
#: queue (two priority classes), one task, and T_pad 32,768 on 64 nodes
ARGMAX_ONE_NODE = ClusterSpec(n_nodes=16, n_groups=1500, pods_per_group=4)
SINGLE_JOB = ClusterSpec(n_nodes=32, n_groups=1, pods_per_group=6000,
                         min_member=1)
SINGLE_QUEUE = ClusterSpec(n_nodes=48, n_groups=1200, pods_per_group=4,
                           min_member=2, seed=2,
                           priority_classes=(("low", 10), ("high", 1000)))
ONE_TASK = ClusterSpec(n_nodes=4, n_groups=1, pods_per_group=1)
WIDE = ClusterSpec(n_nodes=64, node_cpu_millis=1000000,
                   node_mem_bytes=4096 * GiB, node_pods=1000,
                   n_groups=7500, pods_per_group=4, n_queues=4,
                   queue_weights=(1, 2, 3, 4), seed=3)
CHAIN_SPECS = [ARGMAX_ONE_NODE, SINGLE_JOB, SINGLE_QUEUE, ONE_TASK, WIDE]
CHAIN_IDS = ["argmax_one_node", "single_job", "single_queue", "t1",
             "t32768_n64"]
#: their pool widths in the two-level kernel (0: the default)
CHAIN_POOLS = [4, 8, 8, 0, 8]

#: (case, compact bucket: None = the automatic size, 0 = full width)
BATCHED_CASES = [((BASELINE_SPECS[2], None), None),
                 ((BASELINE_SPECS[3], None), None),
                 ((BASELINE_SPECS[3], None), 0),
                 ((REDUCED3, None), None), ((REDUCED5_B, None), None),
                 ((FILLED, "releasing"), None), ((FILLED, "backfill"), None)
                 ] + [((spec, None), None) for spec in CHAIN_SPECS]
BATCHED_IDS = ["cfg2", "cfg3", "cfg3_full_width", "reduced3", "reduced5",
               "pipelined", "over_backfill"] + CHAIN_IDS


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
#: room_check, guard_heavy[, shape]): shape, where given, is
#: random_problem's sizes plus "ties" (every node one score and one host
#: rank, so the lowest index wins across the cluster's CTAs) and "masked"
#: (every node not ok)
VICTIM_CASES = [
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False),
    ("intra_job", PREEMPT_TIERS, True, True, True, True, False),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, False),
    ("other_queue", RECLAIM_TIERS, False, False, False, False, True),
    # the cluster design's edges: V below the cluster size, V not a
    # multiple of the tile, V_pad 20,480 (five tiles of 4,096), tiles
    # past the shared-memory levels (V_pad 40,960), one node, N not a
    # multiple of the cluster, one lane, 256 lanes, more lanes than
    # the card holds clusters (the lanes loop)
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False,
     dict(n_pad=8, n_real=6, v_pad=5, n_jobs=4, lanes=4)),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, False,
     dict(v_pad=1000)),
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False,
     dict(n_pad=8192, n_real=8000, v_pad=20480, n_jobs=60, lanes=3)),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, True,
     dict(n_pad=8192, n_real=8000, v_pad=40960, n_jobs=60, lanes=3)),
    ("intra_job", PREEMPT_TIERS, True, True, True, True, False,
     dict(n_pad=1, n_real=1, v_pad=16, n_jobs=4)),
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False,
     dict(n_pad=100, n_real=90, v_pad=512)),
    ("inter_queue", PREEMPT_TIERS, True, False, True, True, False,
     dict(ties=True)),
    ("other_queue", RECLAIM_TIERS, True, False, True, True, False,
     dict(masked=True)),
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False,
     dict(lanes=3)),
    ("other_queue", RECLAIM_TIERS, True, False, False, True, False,
     dict(lanes=256)),
    ("inter_queue", PREEMPT_TIERS, True, True, True, True, False,
     dict(lanes=300)),
]


def _victim_tensors(problem, device, visited=None):
    from kubebatch_tpu_torch.interop import victim_inputs_from_numpy

    static, mutable, sig, lanes = problem
    return victim_inputs_from_numpy(static, mutable, sig, lanes, device,
                                    visited=visited)


def _victim_problem(seed, guard_heavy, shape):
    shape = dict(shape)
    ties = shape.pop("ties", False)
    masked = shape.pop("masked", False)
    problem = random_problem(seed, **{"lanes": 40, **shape},
                             guard_heavy=guard_heavy)
    static, mutable, sig, lanes = problem
    if ties:
        sig[0][:] = 1.0                  # sig_scores
        static[3][:] = 7                 # host_rank
    if masked:
        static[0][:] = False             # node_ok
    return problem


@pytest.mark.parametrize("case", VICTIM_CASES,
                         ids=[f"{c[0]}-{k}" for k, c in
                              enumerate(VICTIM_CASES)])
def test_victim_kernels_match_plain(case, monkeypatch):
    """Waves over clusters of 8 (the default), 1 and 4 CTAs, and six
    visits, bitwise equal to the plain versions on CPU copies."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import victims

    fk, tiers, veto, dyn, score, room, guard_heavy, *shape = case
    cfg = dict(tiers=tiers, veto_critical=veto, filter_kind=fk,
               dyn_enabled=dyn, score_nodes=score, room_check=room)
    problem = _victim_problem(VICTIM_CASES.index(case), guard_heavy,
                              shape[0] if shape else {})
    kw = _victim_tensors(problem, "cuda")
    want = victims.wave_plain(**_victim_tensors(problem, "cpu"), **cfg)
    lanes = kw["p_job"].shape[0]
    for cluster in (victims.CLUSTER, 1, 4):
        monkeypatch.setattr(victims, "CLUSTER", cluster)
        _build.reset_launch_counts()
        got = victims.victim_wave(**kw, **cfg)
        torch.cuda.synchronize()
        assert _build.launch_count("victim_wave") == 1
        assert victims.last_launch["cluster"] == cluster
        _assert_bitwise([want], [got.cpu()],
                        f"victim_wave {fk} cluster {cluster}")
    monkeypatch.undo()
    n_pad = problem[0][0].shape[0]
    rng = np.random.default_rng(1)
    _build.reset_launch_counts()
    for i in range(6):
        visited = rng.random(n_pad) < 0.3
        if i == 3:
            visited[:] = True                    # not found
        one = tuple(tuple(a[i % lanes:i % lanes + 1] for a in problem[3]))
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

def _scan_inputs(seed: int, n: int, t: int, edge=False):
    """allocate_scan arguments on the card from a numpy seed: a partly
    used cluster (the last tenth padding when n > 64) with releasing and
    lendable capacity; ``edge`` True adds -0.0 rows and ties, an
    all-masked task row and an unfittable task; "masked" takes every node
    out (each row's argmax is node 0, the first valid row fails); "ready"
    lets every task fit anywhere and sets min_available to 2, so the job
    crosses readiness mid-scan and the later rows skip."""
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
    if edge == "masked":
        kw["node_ok"][:] = False
    if edge == "ready":
        kw["idle"][:] = 1e6
        kw["node_ok"][:] = True
        kw["max_task_num"][:] = 1000
        kw["pred_mask"][:] = True
        kw["task_valid"][:] = True
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).cuda()
           for k, v in kw.items()}
    out["min_available"] = int(rng.integers(0, t + 2))
    out["init_allocated"] = int(rng.integers(0, 3))
    if edge == "ready":
        out["min_available"], out["init_allocated"] = 2, 0
    return out


#: the last cases are the cluster design's edges: one node, N not a
#: multiple of the cluster (2,049 over four CTAs; 9,000 over eight, two
#: nodes a thread), the carry past shared memory (32,768), T_pad 1 and
#: 64 at N_pad 8,192, every node masked, and readiness crossed mid-scan
SCAN_CASES = [(8, 1, False), (64, 8, False), (1000, 33, False),
              (1000, 8, True), (8192, 8, False), (8192, 8, True),
              (5000, 64, False),
              (1, 1, False), (1, 8, True), (2049, 8, False),
              (9000, 8, True), (32768, 8, False), (8192, 1, False),
              (8192, 64, True), (8192, 8, "masked"), (1000, 8, "ready"),
              (8192, 8, "ready")]


@pytest.mark.parametrize("n,t,edge", SCAN_CASES,
                         ids=[f"N{n}-T{t}"
                              + ("-edge" if e is True else f"-{e}" if e
                                 else "")
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
        want = allocate_scan_plain(**kw, dyn_enabled=dyn)
        _assert_bitwise(want, got, "allocate_scan")
        if edge == "masked":
            assert want[0][:t].tolist() == [4] + [0] * (t - 1)
            assert want[0][t:2 * t].tolist() == [0] * t
        if edge == "ready":
            assert want[0][2].item() == 0 and want[0][2 * t].item() == 1


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
              ((FILLED, "backfill"), 4)] + [
                  ((spec, None), pool)
                  for spec, pool in zip(CHAIN_SPECS, CHAIN_POOLS)]
HIER_IDS = ["reduced5", "reduced3", "cfg3", "pipelined",
            "over_backfill"] + CHAIN_IDS


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


#: the launch shapes every active-set card case runs: the route the
#: sizes choose, then each route forced (``launch(route=...)``)
ROUTES = (("auto", 0), ("grid", 0), ("cluster", 0))


def _want_route(*t_pads):
    """The route csrc/hier_allocate.cu takes for these task views."""
    from kubebatch_tpu_torch.kernels import hier

    view_max, _ = hier.route_limits()
    return "cluster" if max(t_pads) <= view_max else "grid"


def _check_route(route, cluster, *t_pads):
    from kubebatch_tpu_torch.kernels import hier

    want = _want_route(*t_pads) if route == "auto" else route
    assert hier.last_launch["route"] == want
    if want == "cluster":
        assert hier.last_launch["cluster"] == (cluster
                                               or hier.route_limits()[1])
        assert hier.last_launch["grid"] == hier.last_launch["cluster"]
    else:
        assert hier.last_launch["cluster"] == 0


@pytest.mark.parametrize("grain", [0, 1024, 4096])
@pytest.mark.parametrize("case", [(REDUCED5_B, None), (BASELINE_SPECS[2],
                                                        None)],
                         ids=["reduced5", "cfg2"])
def test_activeset_kernels_match_plain(case, grain):
    """The active-set mode and the audit mode of the kernel against
    their plain versions on every route: packed result, frame and node
    carry; the audit reports no divergence."""
    _check_activeset(case, grain, 8)


@pytest.mark.parametrize("spec,pool", list(zip(CHAIN_SPECS, CHAIN_POOLS)),
                         ids=CHAIN_IDS)
def test_activeset_kernels_match_plain_on_chain_shapes(spec, pool):
    """The same on the round chain's stress shapes, the grain forced to
    the task bucket: active-set views past the grid chain's threshold
    (one task: a grain of 8); the cluster route forced on them too."""
    _need_cuda()
    inputs = _hier_inputs((spec, None))
    grain = max(8, int(inputs.task_valid.shape[0]))
    _check_activeset((spec, None), grain, pool, inputs=inputs)


#: the cluster route's edges: (spec, pool width, grain). One task, one
#: pair, one pool; 40 full gangs of 8 on 16 nodes in two pools, whose
#: waves include dead ones that quarantine their pool (and the epilogue's
#: three retries); 40 gangs of 4 in four pools (three retries); the
#: gangs of 8 at a view of exactly the cluster route's largest (4,096
#: tasks) and at 4,104, past it
EDGE_GANGS = ClusterSpec(n_nodes=16, n_groups=40, pods_per_group=8,
                         n_queues=2, queue_weights=(1, 3),
                         pod_cpu_millis=1500, pod_mem_bytes=2 * GiB,
                         jitter=0.3, seed=4)
EDGE_RETRIES = ClusterSpec(n_nodes=16, n_groups=40, pods_per_group=4,
                           n_queues=2, queue_weights=(1, 3),
                           pod_cpu_millis=1500, pod_mem_bytes=2 * GiB,
                           jitter=0.3, seed=0)
ROUTE_EDGES = [(ONE_TASK, 8, 8), (EDGE_GANGS, 8, 0), (EDGE_RETRIES, 4, 0),
               (EDGE_GANGS, 8, 4096), (EDGE_GANGS, 8, 4104)]
ROUTE_EDGE_IDS = ["t1_one_pool", "dead_waves", "three_retries",
                  "at_crossover", "past_crossover"]


@pytest.mark.parametrize("cluster", [8, 16])
@pytest.mark.parametrize("spec,pool,grain", ROUTE_EDGES, ids=ROUTE_EDGE_IDS)
def test_activeset_route_edges(spec, pool, grain, cluster):
    """The cluster route's edges at clusters of 8 and 16 CTAs, beside the
    route the sizes choose and the grid: every launch bitwise equal to
    the plain version (which shows the edge: one pool, a dead wave, three
    retries), the route as the sizes say."""
    from kubebatch_tpu_torch.kernels.activeset import (
        activeset_allocate_plain, prepare_activeset)
    from kubebatch_tpu_torch.kernels.telemetry import F_RETRIES

    _need_cuda()
    inputs = _hier_inputs((spec, None))
    args, statics, _ = prepare_activeset(inputs, grain=grain,
                                         pool_size=pool)
    stats = {}
    want = activeset_allocate_plain(**_on_cpu(args), **statics, stats=stats)
    t = args["task_valid"].shape[0]
    frame = want[0][3 * t + 1:]
    if spec is ONE_TASK:
        assert int(args["task_valid"].sum()) == 1
        assert args["idle"].shape[0] == pool
    elif spec is EDGE_GANGS:
        assert stats.get("dead_waves", 0) > 0
        assert t == (grain or 1024)
    else:
        assert int(frame[F_RETRIES]) == 3
    _check_activeset(None, grain, pool, inputs=inputs, audit=False,
                     routes=(("auto", 0), ("grid", 0), ("cluster", cluster)),
                     want=(want, stats))


def test_activeset_refused_cluster_raises():
    """A cluster the card cannot place (32 CTAs, past the largest
    cluster) is refused: the launch raises, counts nothing and takes no
    other route."""
    from kubebatch_tpu_torch.kernels.activeset import (activeset_packed,
                                                       prepare_activeset)

    _need_cuda()
    args, statics, _ = prepare_activeset(_hier_inputs((EDGE_RETRIES, None)),
                                         pool_size=4)
    n0 = _build.launch_count("activeset_allocate")
    with pytest.raises(RuntimeError, match="CUDA error"):
        activeset_packed(**args, **statics, route="cluster", cluster=32)
    torch.cuda.synchronize()
    assert _build.launch_count("activeset_allocate") == n0


def _check_activeset(case, grain, pool, inputs=None, audit=True,
                     routes=ROUTES, want=None):
    """The active-set launch (and the audit's) on each (route, cluster)
    against one plain run: results bitwise, work counters, the route."""
    from kubebatch_tpu_torch.kernels.activeset import (
        activeset_allocate_plain, activeset_audit_packed,
        activeset_audit_plain, activeset_packed, prepare_activeset,
        prepare_activeset_audit)
    from kubebatch_tpu_torch.kernels.telemetry import F_ACT_DEMOTED

    _need_cuda()
    inputs = inputs if inputs is not None else _hier_inputs(case)
    args, statics, g = prepare_activeset(inputs, grain=grain,
                                         pool_size=pool)
    if want is None:
        stats = {}
        want = (activeset_allocate_plain(**_on_cpu(args), **statics,
                                         stats=stats), stats)
    t = args["task_valid"].shape[0]
    for route, cluster in routes:
        n0 = _build.launch_count("activeset_allocate")
        got = activeset_packed(**args, **statics, route=route,
                               cluster=cluster)
        torch.cuda.synchronize()
        assert _build.launch_count("activeset_allocate") == n0 + 1
        _check_route(route, cluster, t)
        _assert_bitwise(want[0], [x.cpu() for x in got],
                        f"activeset_allocate ({route}, {cluster})")
        assert _scale_counters() == _plain_counters(want[1])
    if not audit:
        return
    node, act, full, statics, _ = prepare_activeset_audit(
        inputs, grain=grain, pool_size=pool)
    stats = {}
    want = activeset_audit_plain(_on_cpu(node), _on_cpu(act), _on_cpu(full),
                                 **statics, stats=stats)
    t = full["task_valid"].shape[0]
    for route, cluster in routes:
        n0 = _build.launch_count("activeset_allocate")
        got = activeset_audit_packed(node, act, full, **statics,
                                     route=route, cluster=cluster)
        torch.cuda.synchronize()
        assert _build.launch_count("activeset_allocate") == n0 + 1
        _check_route(route, cluster, t, act["task_valid"].shape[0])
        _assert_bitwise(want, [x.cpu() for x in got],
                        f"activeset audit ({route}, {cluster})")
        assert _scale_counters() == _plain_counters(stats)
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


# ---- the pipelined executor's in-place launch and deferred copy ----------

def _clone_carry(args):
    from kubebatch_tpu_torch.kernels.batched import NODE_ARGS

    return dict(args, **{k: args[k].clone() for k in NODE_ARGS[:4]})


@pytest.mark.parametrize("grain", [0, 1024, 4096])
def test_activeset_inplace_launch_matches_cloning_and_plain(grain):
    """The in-place active-set launch writes the carry it was given, and
    its packed result and carry equal the cloning launch's and the plain
    version's bit for bit; an aliased or non-contiguous carry raises."""
    from kubebatch_tpu_torch.kernels.activeset import (
        activeset_allocate_plain, activeset_packed, activeset_packed_inplace,
        prepare_activeset)
    from kubebatch_tpu_torch.kernels.batched import NODE_ARGS

    _need_cuda()
    args, statics, _ = prepare_activeset(_hier_inputs((REDUCED5_B, None)),
                                         grain=grain, pool_size=8)
    want = activeset_allocate_plain(**_on_cpu(args), **statics)
    t = args["task_valid"].shape[0]
    for route, cluster in ROUTES:
        cloning = activeset_packed(**_clone_carry(args), **statics,
                                   route=route)
        mine = _clone_carry(args)
        n0 = _build.launch_count("activeset_allocate_inplace")
        got = activeset_packed_inplace(**mine, **statics, route=route)
        torch.cuda.synchronize()
        assert _build.launch_count("activeset_allocate_inplace") == n0 + 1
        _check_route(route, cluster, t)
        assert all(g is mine[k] for g, k in zip(got[1:], NODE_ARGS[:4]))
        _assert_bitwise(want, [x.cpu() for x in got],
                        f"in place vs plain ({route})")
        _assert_bitwise([x.cpu() for x in cloning], [x.cpu() for x in got],
                        f"in place vs cloning ({route})")
    aliased = _clone_carry(args)
    aliased["backfilled"] = aliased["idle"]
    with pytest.raises(ValueError, match="overlaps"):
        activeset_packed_inplace(**aliased, **statics)
    strided = _clone_carry(args)
    strided["idle"] = strided["idle"].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        activeset_packed_inplace(**strided, **statics)


def test_deferred_copy_is_counted_once():
    """A DeferredCopy of a card tensor counts no blocking readback, one
    deferred readback at its wait, returns the tensor's values, times
    the copy, and refuses a second read."""
    from kubebatch_tpu_torch.device import DeferredCopy

    _need_cuda()
    src = torch.arange(4099, dtype=torch.int32, device="cuda")
    rb0, dr0 = metrics.blocking_readbacks(), metrics.deferred_readbacks()
    copy = DeferredCopy(src * 3)
    assert metrics.deferred_readbacks() == dr0
    host, wait_ms = copy.wait()
    assert metrics.deferred_readbacks() == dr0 + 1
    assert metrics.blocking_readbacks() == rb0
    assert np.array_equal(host, np.arange(4099, dtype=np.int32) * 3)
    assert wait_ms >= 0.0 and copy.device_ms() >= 0.0
    with pytest.raises(RuntimeError):
        copy.wait()


@pytest.mark.parametrize("audit_every", [0, 2], ids=["audit_off",
                                                    "audit_every_2nd"])
def test_pipelined_scheduler_on_the_card_equals_sequential(audit_every):
    """Scheduler(pipeline=True) on a CUDA cache (the active set, its
    audit off or on every 2nd cycle) binds what its sequential twin
    binds, cycle for cycle after a drain, and what the same loops bind
    on a CPU cache; every dispatch is one launch (in place, or the
    cloning audit launch) consumed by one deferred readback, with no
    blocking readback on the pipelined cycles; the audits find no
    divergence."""
    _need_cuda()
    out = pipelined_run("cuda", audit_every)
    assert out[True][0] == out[False][0] and out[True][0]
    cycles, deferred, blocking, inplace, audits, diff = out[True][1]
    assert cycles == deferred == 4 and blocking == 0
    assert inplace + audits == 4 and diff == 0
    assert audits == (2 if audit_every else 0)
    assert out[False][1][:2] == [0, 0]
    # a CPU cache (the plain versions, no launch counted) decides alike
    cpu = pipelined_run("cpu", audit_every)
    for piped in (True, False):
        assert cpu[piped][0] == out[piped][0]
        assert cpu[piped][1][:3] + cpu[piped][1][4:] \
            == out[piped][1][:3] + out[piped][1][4:]


#: roomy: every cold pod binds, so each churn tick recycles gangs bound
#: cycles before and both loops see the same events
ROOMY = ClusterSpec(n_nodes=64, n_groups=48, pods_per_group=4, n_queues=2,
                    queue_weights=(1, 2), pod_cpu_millis=500,
                    pod_mem_bytes=GiB, jitter=0.2, seed=3)


def pipelined_run(device, audit_every=0):
    """ROOMY through Scheduler(pipeline=True) and its sequential twin on
    ``device`` (the active set's audit every ``audit_every`` cycles, 0:
    off): cold, one cycle with no churn, three churn-32 cycles (kubelet
    ticks between), then a drain. Per loop: (sorted binds, moves of
    pipeline_cycles_total, deferred_readbacks, blocking_readbacks,
    in-place launches, audits and divergences)."""
    from kubebatch_tpu_torch.kernels import activeset
    from kubebatch_tpu_torch.runtime import Scheduler, pipeline

    out = {}
    try:
        for piped in (True, False):
            activeset.reset()
            pipeline.reset()
            binder = _Binder()
            sim = build_cluster(ROOMY)
            cache = SchedulerCache(binder=binder, async_writeback=False,
                                   device=device)
            sim.populate(cache)
            sched = Scheduler(cache, schedule_period=3600.0,
                              pipeline=piped, solver="activeset",
                              solve_audit_every=audit_every)

            def counts():
                return (metrics.pipeline_cycles_total(),
                        metrics.deferred_readbacks(),
                        metrics.blocking_readbacks(),
                        _build.launch_count("activeset_allocate_inplace"),
                        metrics.activeset_audits_total(),
                        metrics.activeset_divergences_total())
            c0 = counts()
            for k in range(5):
                if k:
                    for pod in sim.pods:
                        if pod.node_name and pod.phase == PodPhase.PENDING:
                            pod.phase = PodPhase.RUNNING
                            cache.update_pod(pod, pod)
                    # the pipelined cold solve lands at cycle 1: churn
                    # from there on (the oldest gangs, bound in both)
                    if k > 1:
                        assert sim.churn_tick(cache, 32,
                                              arrival_queue=k % 2) == 32
                assert sched.run_cycle()
            if piped:
                sched._pipeline.drain()
            out[piped] = (sorted(binder.calls),
                          [b - a for a, b in zip(c0, counts())])
            cache.stop()
    finally:
        activeset.reset()
        activeset.set_audit_every(activeset.DEFAULT_AUDIT_EVERY)
        pipeline.reset()
    return out


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


def _explain_edge(name):
    """(arguments, has_ports) of a named explain_counts edge case: chunks
    of csrc/explain_counts.cu (256 raw nodes) with no candidate or only
    the last one holding any, port widths 1 / 33 / 64, whole tiles of
    padded task rows, N past one chunk ring (50,000 nodes), no candidate
    at all, clusters of odd size, a node count that puts the signature
    rows off a 4-byte boundary, and enough signatures that the predicate
    bytes leave the ring or the chunk shrinks."""
    shapes = {"empty-chunk": (300, 16384, 12),
              "last-chunk": (300, 20000, 12),
              "pt1": (300, 1000, 1), "pt33": (300, 1000, 33),
              "pt64": (300, 1000, 64), "padded-tiles": (1000, 700, 12),
              "n50000": (300, 50000, 12), "no-candidate": (600, 3000, 12),
              "odd-cluster": (513, 1301, 5), "sigs300": (400, 1500, 3),
              "sigs4096": (64, 600, 3)}
    t, n, pt = shapes[name]
    a = _explain_case(t, n, pt, seed=sum(map(ord, name)))
    rng = np.random.default_rng(len(name))
    if name == "empty-chunk":
        a["node_ok"][256:512] = False
        a["node_ok"][1024:1536] = False
    elif name == "last-chunk":
        a["node_ok"][:19800] = False
    elif name == "padded-tiles":
        a["task_valid"][:] = np.arange(t) < 300
    elif name == "no-candidate":
        a["node_ok"][:] = False
    elif name.startswith("sigs"):
        s = int(name[4:])
        a["sig_pred"] = rng.random((s, n)) < 0.6
        a["task_sig"] = rng.integers(0, s, t).astype(np.int32)
    return a, name != "sigs4096"


@pytest.mark.parametrize("name", ["empty-chunk", "last-chunk", "pt1", "pt33",
                                  "pt64", "padded-tiles", "n50000",
                                  "no-candidate", "odd-cluster", "sigs300",
                                  "sigs4096"])
def test_explain_counts_kernel_edge_cases(name):
    """csrc/explain_counts.cu at the edges of its chunk ring, its cluster
    and its tiles: one counted launch, bitwise equal to the plain
    version."""
    from kubebatch_tpu_torch import interop
    from kubebatch_tpu_torch.obs import explain

    _need_cuda()
    a, has_ports = _explain_edge(name)
    args = interop.explain_inputs_from_numpy(a, "cuda")
    c0 = _build.launch_count("explain_counts")
    got = explain.explain_counts(**args, has_ports=has_ports)
    torch.cuda.synchronize()
    assert _build.launch_count("explain_counts") == c0 + 1
    want = explain.explain_counts_plain(
        **interop.explain_inputs_from_numpy(a, "cpu"), has_ports=has_ports)
    _assert_bitwise([want], [got.cpu()], f"explain_counts {name}")
    shape = explain.launch_shape(*explain.last_launch["sizes"])
    n = a["idle"].shape[0]
    if name == "n50000":
        assert n > shape["ctas"] * 4 * shape["chunk"]
    if name == "odd-cluster":
        assert shape["ctas"] not in (1, 2, 4, 8)
    if name == "sigs300":
        assert not shape["pred_staged"]
    if name == "sigs4096":
        assert shape["chunk"] < 256 and not shape["pred_staged"]
    if name in ("empty-chunk", "last-chunk"):
        assert shape["chunk"] == 256


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


# ---------------------------------------------------------------------
# the tenant service's mega solve (csrc/mega_fused.cu)
# ---------------------------------------------------------------------

def _tenant_lanes(seeds, device, churn=False):
    """Each seeded tenant cluster's fused lane through the wire (encode,
    bytes, decode), as (numpy args, statics); ``churn`` takes the lane
    after a cold cycle, a kubelet tick and a churn of 8 pods."""
    from kubebatch_tpu_torch.objects import PodPhase as Phase
    from kubebatch_tpu_torch.rpc.client import build_snapshot
    from kubebatch_tpu_torch.rpc.server import fused_lane_args
    from kubebatch_tpu_torch.rpc.wire import SnapshotRequest
    from kubebatch_tpu_torch.sim.tenants import _tenant_cluster

    lanes = []
    for seed in seeds:
        sim, cache, binder = _tenant_cluster(seed, device=device)
        if churn:
            ssn = OpenSession(cache, shipped_tiers())
            AllocateAction(mode="auto").execute(ssn)
            CloseSession(ssn)
            for pod in binder.fresh:
                pod.phase = Phase.RUNNING
                cache.update_pod(pod, pod)
            sim.churn_tick(cache, 8)
        ssn = OpenSession(cache, shipped_tiers())
        req, _ = build_snapshot(ssn)
        CloseSession(ssn)
        req = SnapshotRequest.FromString(req.SerializeToString())
        lanes.append(fused_lane_args(req))
    return lanes


@pytest.mark.parametrize("churn", [False, True], ids=["cold", "churn"])
@pytest.mark.parametrize("b", [1, 2, 3, 8])
def test_mega_fused_kernel_matches_plain_and_single_launches(b, churn):
    """b lanes of different tenants in one launch: every lane's host
    block and node carries bitwise equal to mega_fused_plain's and to a
    single fused_allocate launch on that lane."""
    from kubebatch_tpu_torch.kernels.mega import mega_fused, mega_fused_plain
    from kubebatch_tpu_torch.tenantsvc.megasolve import (_stack_lanes,
                                                         lane_key)

    _need_cuda()
    lanes = _tenant_lanes(range(b), "cuda", churn)
    assert len({lane_key(*lane) for lane in lanes}) == 1
    statics = lanes[0][1]
    stacked = _stack_lanes([args for args, _ in lanes])
    dev = [torch.from_numpy(a).cuda() for a in stacked]
    c0 = _build.launch_count("mega_fused")
    got = mega_fused(*dev, **statics)
    torch.cuda.synchronize()
    assert _build.launch_count("mega_fused") == c0 + 1
    want = mega_fused_plain(*(torch.from_numpy(a) for a in stacked),
                            **statics)
    _assert_bitwise(want, [g.cpu() for g in got], f"mega b={b}")
    for i in range(b):
        single = fused_allocate(*(a[i] for a in dev), **statics)
        _assert_bitwise(single, [g[i] for g in got], f"lane {i}")
    assert int((got[0][:, 0, :-21] > 0).sum()) > 0      # something placed


def test_mega_fused_refuses_what_the_kernel_does_not_take():
    from kubebatch_tpu_torch.kernels.mega import mega_fused
    from kubebatch_tpu_torch.tenantsvc.megasolve import _stack_lanes

    _need_cuda()
    lanes = _tenant_lanes([0, 1], "cuda")
    statics = lanes[0][1]
    dev = [torch.from_numpy(a).cuda()
           for a in _stack_lanes([args for args, _ in lanes])]
    bad = list(dev)
    bad[0] = bad[0].double()
    with pytest.raises(ValueError):
        mega_fused(*bad, **statics)
    mixed = list(dev)
    mixed[1] = mixed[1].cpu()
    with pytest.raises(ValueError):
        mega_fused(*mixed, **statics)


def test_tenant_service_on_the_card_decides_as_the_cpu():
    """solve_many on the card: the coalesced lanes are one mega launch
    and one counted copy, each answer equal to a single solve's on the
    card and to the CPU service's; run_multi_tenant on the card equals
    its dedicated runs."""
    from kubebatch_tpu_torch.rpc.server import solve_snapshot
    from kubebatch_tpu_torch.sim.tenants import (_tenant_requests,
                                                 run_multi_tenant)
    from kubebatch_tpu_torch.tenantsvc.service import TenantSolveService

    _need_cuda()
    out = {}
    for device in ("cuda", "cpu"):
        reqs = _tenant_requests(4, device=device)
        svc = TenantSolveService(device=device)
        c0 = _build.launch_count("mega_fused")
        rb0 = metrics.blocking_readbacks()
        resps = svc.solve_many([(f"t{i}", "normal", r)
                                for i, r in enumerate(reqs)])
        launches = _build.launch_count("mega_fused") - c0
        syncs = metrics.blocking_readbacks() - rb0
        singles = [solve_snapshot(r, device=device) for r in reqs]
        assert [list(map(_dec, a.decisions)) for a in resps] == \
            [list(map(_dec, a.decisions)) for a in singles]
        out[device] = ([list(map(_dec, a.decisions)) for a in resps],
                       launches, syncs)
    assert out["cuda"][0] == out["cpu"][0]
    assert out["cuda"][1:] == (1, 1) and out["cpu"][1:] == (0, 1)
    rep = run_multi_tenant(n_tenants=4, cycles=2, device="cuda")
    assert rep.bit_identical, (rep.mismatched, rep.rpc_errors)


def _dec(d):
    return (d.kind, d.node_name, d.order)


# ---- the node-sharded engines (B14a, B14b) ----------------------------------

def _sharded_inputs(name):
    from kubebatch_tpu_torch.sim import ClusterSpec as Spec

    specs = {
        # contended: kills, stranded gangs, the epilogue's revivals
        "r5": (Spec(n_nodes=48, n_groups=72, pods_per_group=8, n_queues=4,
                    queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
                    pod_mem_bytes=2 * GiB, jitter=0.2, seed=5), None),
        # nearly full with releasing capacity: pipelined placements
        "filled": (Spec(n_nodes=16, n_groups=24, pods_per_group=4,
                        min_member=2, running_fill=0.9, n_queues=2,
                        queue_weights=(1, 3), pod_cpu_millis=1000,
                        pod_mem_bytes=GiB, seed=7), "releasing"),
        # the half-cfg5 partitioned cycle
        "half5": (Spec(n_nodes=1250, n_groups=312, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2), None),
        # contended task views of 1,024 tasks (T_pad 1,024: the chain in
        # block 0) and 1,032 (T_pad 2,048: on the grid), stranded gangs
        "t1024": (Spec(n_nodes=64, n_groups=128, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=11), None),
        "t1032": (Spec(n_nodes=64, n_groups=129, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=11), None),
        # a window of 2,048 nodes (1,100 real) and 320 tasks: the
        # gathered waterfall's order and the pool sums on the grid
        "n1100": (Spec(n_nodes=1100, n_groups=40, pods_per_group=8,
                       n_queues=2, queue_weights=(1, 3),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=13), None),
        # whole gangs (min_member 8) over 1,280 tasks: the epilogue's
        # rollbacks of stranded gangs on the grid
        "strand": (Spec(n_nodes=96, n_groups=160, pods_per_group=8,
                        min_member=8, n_queues=4, queue_weights=(1, 2, 3, 4),
                        pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                        jitter=0.3, seed=17), None),
    }
    spec, prep = specs[name]
    sim = build_cluster(spec)
    for pod in [p for p in sim.pods if p.name.startswith("fill-")][::2]:
        if prep == "releasing":
            pod.deletion_timestamp = 1.0
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False,
                           device="cpu")
    sim.populate(cache)
    return build_cycle_inputs(OpenSession(cache, shipped_tiers()))


def _one_card_plain(node, rep, statics):
    from kubebatch_tpu_torch.kernels.batched import CYCLE_ARGS, NODE_ARGS, \
        arg_dtype

    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(arg_dtype(k))
         for k, v in {**node, **rep}.items()}
    return batched_allocate_plain(**{k: t[k] for k in NODE_ARGS + CYCLE_ARGS},
                                  compact_bucket=0, **statics)


@pytest.mark.parametrize("name,k", [("r5", 1), ("r5", 2), ("r5", 4),
                                    ("filled", 2), ("filled", 4),
                                    ("half5", 4), ("t1024", 2),
                                    ("t1032", 2), ("t1032", 4),
                                    ("n1100", 2), ("n1100", 4),
                                    ("strand", 2)])
def test_sharded_round_kernels_match_plain(name, k):
    """Every launch of csrc/sharded_round.cu on k ranks in lock step (the
    per-block steps on column blocks, the chain on their concatenation)
    held bitwise against the plain version on the same inputs
    (CheckedRank), and the result bitwise the one-card plain solve. The
    task views just under and over GRID_CHAIN_MIN (t1024 / t1032), a
    window past it (n1100) and the stranded gangs' rollbacks past it
    (t1032, strand: the epilogue retried) take block 0 and the grid."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import batched_sharded as bs

    inputs = _sharded_inputs(name)
    node, rep, statics, n_sh = bs.prepare_sharded(k, inputs.device, inputs)
    want = _one_card_plain(node, rep, statics)
    _build.reset_launch_counts()
    packed, carry, ranks = bs.solve_lockstep(node, rep, statics, n_sh, k,
                                             "cuda", check=True)
    torch.cuda.synchronize()
    t_pad = inputs.task_valid.shape[0]
    p, c = packed.cpu(), carry.cpu()
    assert torch.equal(p[:3 * t_pad + 1], want[0][:3 * t_pad + 1])
    assert torch.equal(p[3 * t_pad + 2:], want[0][3 * t_pad + 2:])
    for cols, w in ((slice(0, 3), want[1]), (slice(3, 6), want[2]),
                    (slice(7, 9), want[4])):
        assert torch.equal(c[:, cols].contiguous().view(torch.float32), w)
    assert torch.equal(c[:, 6], want[3])
    launches = _build.launch_count("sharded_round")
    assert launches == sum(r.cuda.launches for r in ranks)
    # every launch's payload checked, the flags and the result too
    assert all(r.compared > r.cuda.launches for r in ranks)
    if name in ("t1032", "strand"):
        assert int(p[3 * t_pad + 15]) > 0    # the frame's retries
    if name == "n1100":
        assert n_sh > 1024


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sharded_scan_kernel_matches_plain(k):
    """Every launch of csrc/sharded_scan.cu on k ranks in lock step held
    bitwise against the plain version (ScanChecked), and the result
    equal to the plain ranks' (a contended cluster, -0.0 scores)."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import sharded as sh

    rng = np.random.default_rng(k)
    n, t = 256, 64
    args = dict(
        idle=rng.uniform(20, 120, (n, 3)).astype(np.float32),
        releasing=np.where(rng.random((n, 1)) < 0.3,
                           rng.uniform(10, 80, (n, 3)), 0).astype(np.float32),
        backfilled=np.where(rng.random((n, 1)) < 0.2,
                            rng.uniform(5, 30, (n, 3)), 0).astype(np.float32),
        max_task_num=rng.integers(1, 4, n).astype(np.int32),
        n_tasks=rng.integers(0, 2, n).astype(np.int32),
        node_ok=rng.random(n) < 0.9,
        resreq=rng.uniform(10, 90, (t, 3)).astype(np.float32),
        task_valid=rng.random(t) < 0.9,
        scores=np.round(rng.normal(size=(t, n)) * 4).astype(np.float32),
        pred_mask=rng.random((t, n)) < 0.7,
        min_available=np.int32(t // 2), init_allocated=np.int32(1))
    args["init_resreq"] = args["resreq"].copy()
    args["scores"][:, 7] = -0.0
    _build.reset_launch_counts()
    got, ranks = sh.scan_lockstep(args, k, "cuda", check=True)
    want, _ = sh.scan_lockstep(args, k, "cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert _build.launch_count("sharded_scan") == k * (t + 1)
    # the first rows, every step's rows but the last (none), the result
    assert all(r.compared == t + 6 for r in ranks)


def _scan_edge(name):
    """(the scan's inputs, k, steps) of a named csrc/sharded_scan.cu
    edge case: k = 1, 2, 3, 4 and 8 at blocks that spread each step over
    a cluster (8,192 / 4,096 / 1,001 / 2,048 / 1,040 nodes a rank: the
    gathered rows past 1,024 a CTA at k = 8, a block that is no multiple
    of the cluster's share at k = 3), equal maxima in several CTAs' and
    ranks' slices, steps with every row -inf, winners in the last node
    of a rank's block and of a CTA's share."""
    import chip_smoke as cs

    k, nb = {"k1": (1, 8192), "k2": (2, 4096), "k3": (3, 1001),
             "k4": (4, 2048), "k8": (8, 1040), "ties": (4, 2048),
             "zero-ties": (4, 2048), "all-inf": (2, 4096),
             "last-node": (4, 2048)}[name]
    t = 48
    args = cs.scan_args(k * nb, t, seed=sum(map(ord, name)))
    args["max_task_num"][:] = 8
    if name == "ties":
        # one score above every other at nodes in four CTAs and three
        # ranks; each step's lowest eligible one must win
        hot = np.asarray([7000, 5000, 3000, 1500, 2047, 2048])
        args["scores"][:, hot] = 500.0
        args["pred_mask"][:, hot] = True
        args["node_ok"][hot] = True
        args["idle"][hot] = 1e6
        args["scores"][1::2, 1500] = -0.0
        args["scores"][1::2, 3000] = 0.0
    elif name == "zero-ties":
        # odd steps: every row scores below 0 but -0.0 at node 1500 (rank
        # 0) and +0.0 at node 3000 (rank 1, another CTA's slice); equal
        # maxima, so the lower index, -0.0's, must win
        odd = args["scores"][1::2]
        args["scores"][1::2] = -np.abs(odd) - 1.0
        args["scores"][1::2, 1500] = -0.0
        args["scores"][1::2, 3000] = 0.0
        args["pred_mask"][:, [1500, 3000]] = True
        args["node_ok"][[1500, 3000]] = True
        args["idle"][[1500, 3000]] = 1e6
        args["max_task_num"][[1500, 3000]] = t
    elif name == "all-inf":
        args["pred_mask"][t // 2:] = False
        args["min_available"] = np.int32(t)
    elif name == "last-node":
        share = nb // 8
        ends = [r * nb + nb - 1 for r in range(k)] + [
            share * c - 1 for c in range(1, 9)]
        for s, node in enumerate(ends * (t // len(ends) + 1)):
            if s < t:
                args["scores"][s, node] = 900.0
                args["pred_mask"][s, node] = True
                args["node_ok"][node] = True
                args["idle"][node] = 1e6
        args["min_available"] = np.int32(t)
    return args, k, t


@pytest.mark.parametrize("name", ["k1", "k2", "k3", "k4", "k8", "ties",
                                  "zero-ties", "all-inf", "last-node"])
def test_sharded_scan_cluster_edges(name):
    """Every launch of csrc/sharded_scan.cu held bitwise against the plain
    version (ScanChecked) over a thread-block cluster at the edges of its
    shares and its argmax order; the result equal to the plain ranks';
    one counted launch a step a rank."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import sharded as sh

    args, k, t = _scan_edge(name)
    nb = args["node_ok"].shape[0] // k
    shape = sh.scan_shape(k, nb)
    assert shape["ctas"] > 1
    if name == "k3":
        assert nb % shape["nodes_a_cta"]
    if name == "k8":
        assert shape["rows_a_cta"] > 1024
    _build.reset_launch_counts()
    got, ranks = sh.scan_lockstep(args, k, "cuda", check=True)
    want, _ = sh.scan_lockstep(args, k, "cpu")
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert _build.launch_count("sharded_scan") == k * (t + 1)
    assert all(r.compared == t + 6 for r in ranks)
    dec = want[0].numpy()
    if name == "ties":
        assert want[1][0] == 1500 and (dec[:4] > 0).all()
    if name == "zero-ties":
        assert (want[1][1::2] == 1500).all()
        assert np.signbit(args["scores"][1, 1500])
    if name == "all-inf":
        assert (want[1][t // 2:] == 0).all()
        assert dec[t // 2] == sh.FAIL or dec[t // 2] == sh.SKIP
    if name == "last-node":
        assert int(want[1][0]) == nb - 1


def test_sharded_two_ranks_on_one_card(tmp_path):
    """Two ranks of a gloo group on cuda:0 (the transport the mesh
    chooses: all-gathers staged through pinned host buffers, each stage
    counted): AllocateAction(mode="sharded") on a CUDA cache equals the
    one-card batched kernel's solve with compact_bucket=0, and every
    launch on both ranks equals the plain version (check=True)."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import batched_sharded as bs
    from kubebatch_tpu_torch.kernels.batched import solve_batched
    from kubebatch_tpu_torch.parallel import worker

    def inputs():
        sim = build_cluster(ClusterSpec(
            n_nodes=600, n_groups=160, pods_per_group=4, n_queues=4,
            queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
            pod_mem_bytes=2 * GiB, jitter=0.2, seed=3))
        cache = SchedulerCache(async_writeback=False,
                               incremental_snapshot=False, device="cuda")
        sim.populate(cache)
        return build_cycle_inputs(OpenSession(cache, shipped_tiers()))

    with worker.launch(2, str(tmp_path / "store"), device="cuda",
                       timeout=300) as group:
        mesh = group.mesh
        assert mesh.backend == "gloo" and mesh.staged["all_gather"]
        assert not any(f["jax"] for f in worker.request_status(mesh))
        a, b = inputs(), inputs()
        want = solve_batched(a, compact_bucket=0)
        rb0 = metrics.blocking_readbacks()
        got = bs.solve_batched_sharded(mesh, b.device, b, check=True)
        ranks = bs.last_solve["ranks"]
        for w, g in zip(want[:3], got[:3]):
            np.testing.assert_array_equal(w, g)
        assert want[3] == got[3]
        for key in ("idle", "releasing", "n_tasks", "nz_req"):
            assert torch.equal(getattr(a.device, key),
                               getattr(b.device, key)), key
        assert all(r["compared"] > 0 and r["stages"] == r["collectives"]
                   for r in ranks)
        # the node stage, packed (1) + carry (4), one progress flag a
        # round, the epilogue's flags, and rank 0's stages
        assert metrics.blocking_readbacks() - rb0 >= 6 + got[3] \
            + ranks[0]["stages"]


# ---- the affinity branch over the mesh (B14a) and the two-level solve
# over it (B14c) ---------------------------------------------------------

def _tensor_args(node, rep, device="cpu"):
    from kubebatch_tpu_torch.kernels.batched import arg_dtype

    return {k: torch.from_numpy(np.array(v, copy=True)).to(arg_dtype(k))
            .to(device) for k, v in {**node, **rep}.items()}


def _sharded_aff_inputs(name):
    """A cycle carrying the affinity vocabulary: "3p" (the 3p mix cut to
    100 nodes and 800 pods: zones, anti-affinity, preferred terms with
    the interpod score, host ports) or "ports" (anti-affine gangs on four
    hostnames, preferred co-location and a host port: stranded gangs)."""
    import dataclasses

    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False,
                           device="cpu")
    if name in ("3p", "3p1k"):
        # 800 pods (T_pad 1,024: block 0) or 1,040 (2,048: the grid)
        build_cluster(dataclasses.replace(
            BASELINE_SPECS["3p"], n_nodes=100,
            n_groups=200 if name == "3p" else 260)).populate(cache)
    else:
        from kubebatch_tpu_torch import objects

        w = AffWorld(objects)
        cache.add_queue(w.queue())
        aff_rollback_build(cache, w)
    inputs = build_cycle_inputs(OpenSession(cache, shipped_tiers()),
                                allow_affinity=True)
    assert inputs.affinity is not None
    return inputs


@pytest.mark.parametrize("name,k", [("3p", 2), ("3p", 4), ("ports", 2),
                                    ("ports", 4), ("3p1k", 2)])
def test_sharded_affinity_kernels_match_plain(name, k):
    """The affinity branch of csrc/sharded_round.cu on k ranks in lock
    step: every launch held bitwise against the plain version
    (CheckedRank), the result (decisions, nodes, sequence numbers,
    rounds, node carry, [P,D] carry, port claims) bitwise the one-card
    plain solve and the one-card kernel (csrc/batched_allocate.cu's
    affinity branch) on the same bucket."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import batched_sharded as bs
    from kubebatch_tpu_torch.kernels.batched import (AFF_ARGS, AFF_OUT,
                                                     CYCLE_ARGS, IP_ARG,
                                                     NODE_ARGS)

    inputs = _sharded_aff_inputs(name)
    node, rep, statics, n_sh = bs.prepare_sharded(k, inputs.device, inputs)
    _build.reset_launch_counts()
    packed, carry, ranks = bs.solve_lockstep(node, rep, statics, n_sh, k,
                                             "cuda", check=True)
    torch.cuda.synchronize()
    got_aff = bs.last_solve["aff"]
    t_pad = inputs.task_valid.shape[0]
    p, c = packed.cpu(), carry.cpu()
    for dev in ("cpu", "cuda"):
        t = _tensor_args(node, rep, dev)
        aff = {kk: t[kk] for kk in AFF_ARGS}
        if "task_ports" in rep:
            aff.update(task_ports=t["task_ports"], port_base=t["port_base"])
        if IP_ARG in rep:
            aff[IP_ARG] = t[IP_ARG].reshape(())
        args = {kk: t[kk] for kk in NODE_ARGS + CYCLE_ARGS}
        want = (batched_allocate_plain if dev == "cpu" else batched_allocate)(
            **args, compact_bucket=0, aff=aff, **statics)
        want = [w.cpu() for w in want[:5]] + [
            {kk: (v.cpu() if v is not None else None)
             for kk, v in want[5].items()}]
        assert torch.equal(p[:3 * t_pad + 1], want[0][:3 * t_pad + 1]), dev
        assert torch.equal(p[3 * t_pad + 2:], want[0][3 * t_pad + 2:]), dev
        for cols, w in ((slice(0, 3), want[1]), (slice(3, 6), want[2]),
                        (slice(7, 9), want[4])):
            assert torch.equal(c[:, cols].contiguous().view(torch.float32),
                               w), dev
        assert torch.equal(c[:, 6], want[3]), dev
        for kk in AFF_OUT:
            if want[5][kk] is None:
                assert got_aff[kk] is None
            else:
                assert np.array_equal(want[5][kk].numpy(), got_aff[kk]), kk
    assert _build.launch_count("sharded_round") == sum(
        r.cuda.launches for r in ranks)
    assert all(r.compared > r.cuda.launches for r in ranks)


@pytest.mark.parametrize("k,seed,pool", [(4, 1, 32), (3, 0, 8), (2, 0, 8),
                                         (2, 0, 2048)])
def test_hier_sharded_kernels_match_plain(k, seed, pool):
    """The two-level steps of csrc/sharded_round.cu on k ranks in lock
    step (pools straddling the ranks' blocks at k = 4 and 3): every
    launch held bitwise against the plain version, the result bitwise the
    one-card plain two-level solve and one launch of
    csrc/hier_allocate.cu with the same pool on the same bucket. Pool
    2,048: 2,100 nodes, 1,280 tasks, so the rounds' windows, task views
    and rollbacks are past GRID_CHAIN_MIN (the grid)."""
    _need_cuda()
    from kubebatch_tpu_torch.kernels import batched_sharded as bs
    from kubebatch_tpu_torch.kernels import hier as th
    from kubebatch_tpu_torch.kernels.batched import CYCLE_ARGS, NODE_ARGS

    nodes, groups = (2100, 160) if pool > 1024 else (48, 72)
    sim = build_cluster(ClusterSpec(
        n_nodes=nodes, n_groups=groups, pods_per_group=8, n_queues=4,
        queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
        pod_mem_bytes=2 * GiB, jitter=0.2, min_member=6, seed=seed))
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False,
                           device="cpu")
    sim.populate(cache)
    inputs = build_cycle_inputs(OpenSession(cache, shipped_tiers()))
    node, rep, statics, n_sh = bs.prepare_sharded(k, inputs.device, inputs)
    t_pad = inputs.task_valid.shape[0]
    p_w = th.hier_pool_size(n_sh, pool)
    statics.update(pool_size=p_w, max_waves=(t_pad + 8) * (n_sh // p_w + 1))
    _build.reset_launch_counts()
    packed, carry, ranks = bs.solve_hier_lockstep(node, rep, statics, n_sh,
                                                  k, "cuda", check=True)
    torch.cuda.synchronize()
    p, c = packed.cpu(), carry.cpu()
    one = {kk: statics[kk] for kk in (
        "job_keys", "queue_keys", "prop_overused", "dyn_enabled",
        "pipe_enabled", "max_rounds", "pool_size", "max_waves",
        "gang_enabled", "narrow", "narrow_gate")}
    for dev in ("cpu", "cuda"):
        t = _tensor_args(node, rep, dev)
        want = [w.cpu() for w in th.hier_packed(
            **{kk: t[kk] for kk in NODE_ARGS + CYCLE_ARGS}, **one)]
        assert torch.equal(p[:3 * t_pad + 1], want[0][:3 * t_pad + 1]), dev
        assert torch.equal(p[3 * t_pad + 2:], want[0][3 * t_pad + 2:]), dev
        assert int(p[3 * t_pad + 1]) == 6 and int(want[0][3 * t_pad + 1]) \
            == 4
        for cols, w in ((slice(0, 3), want[1]), (slice(3, 6), want[2]),
                        (slice(7, 9), want[4])):
            assert torch.equal(c[:, cols].contiguous().view(torch.float32),
                               w), dev
        assert torch.equal(c[:, 6], want[3]), dev
    assert all(r.compared > r.cuda.launches for r in ranks)
    if k == 4:
        assert ranks[0].plain.stats["straddling"] > 0
