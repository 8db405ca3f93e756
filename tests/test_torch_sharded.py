"""The node-sharded engines (kernels/batched_sharded.py, kernels/sharded.py)
over a gloo process group on the CPU, against the port's one-card batched
solve and the reference's sharded engines.

Each mesh is k processes: this pytest process is rank 0 (it holds the
session) and k - 1 solver workers spawned through the port's own entry
(parallel/worker.py ``main``) join it over a FileStore under tmp_path.
The workers import the port only (each reports ``"jax" not in
sys.modules``). Exactness, tolerance 0:

- bitwise against the port's one-card plain batched solve with
  ``compact_bucket=0`` on the same node bucket: decisions, nodes,
  sequence numbers, rounds and the written-back node carry;
- against the reference's GSPMD ``solve_batched_sharded`` on its 8-device
  CPU mesh: decisions, sequence numbers and the nodes of placed tasks (as
  the reference's own tests/test_sharded_batched.py compares them);
- the scan bitwise against the reference's ``build_sharded_allocate``;
- with the inter-pod affinity / host-port vocabulary (B14a's affinity
  branch): bitwise against the one-card plain solve with its [P,D] carry
  and port claims, and decisions against the reference's GSPMD solve;
- the two-level solve over the mesh (``hier.solve_hier_sharded``, B14c):
  bitwise against the one-card plain two-level solve on the same bucket
  and pool, pools straddling ranks, and against the reference's
  ``solve_hier_sharded``; the reference graph's weighted-sum FMA probed.

One default process group at a time: the module's ``meshes`` fixture
launches the k it is asked for and closes the previous one, and the
tests are ordered so each k launches once.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import kubebatch_tpu_torch.actions  # noqa: F401  (registers actions)
import kubebatch_tpu_torch.plugins  # noqa: F401  (registers plugins)
from kubebatch_tpu_torch import faults as t_faults
from kubebatch_tpu_torch import metrics as t_metrics
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod
from kubebatch_tpu_torch.actions import allocate_batched as t_allocate_batched
from kubebatch_tpu_torch.actions.allocate import AllocateAction
from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
from kubebatch_tpu_torch.cache import SchedulerCache
from kubebatch_tpu_torch.conf import shipped_tiers
from kubebatch_tpu_torch.framework import CloseSession, OpenSession
from kubebatch_tpu_torch.kernels import batched as t_batched
from kubebatch_tpu_torch.kernels import batched_sharded as bs
from kubebatch_tpu_torch.kernels import hier as t_hier
from kubebatch_tpu_torch.kernels import sharded as t_sharded
from kubebatch_tpu_torch.objects import (GROUP_NAME_ANNOTATION, Container,
                                         Node, Pod, PodGroup, PodPhase, Queue,
                                         resource_list)
from kubebatch_tpu_torch.parallel import mesh as t_mesh
from kubebatch_tpu_torch.parallel import worker
from kubebatch_tpu_torch.runtime.scheduler import Scheduler
from kubebatch_tpu_torch.sim import ClusterSpec, build_cluster

GiB = 1024 ** 3


class _Binder:
    def bind(self, pod, hostname):
        pod.node_name = hostname


def _rl(cpu, mem, pods=0.0):
    return resource_list(cpu=cpu, memory=mem, pods=pods)


def port_cluster(cache, n_nodes=24, n_groups=12, pods_per_group=4,
                 n_queues=2, seed=0):
    """tests/test_sharded_batched.py ``build_cluster`` in the port's
    objects (the same draws from the same seed)."""
    rng = np.random.default_rng(seed)
    for q in range(n_queues):
        cache.add_queue(Queue(name=f"q{q}", weight=q + 1))
    for i in range(n_nodes):
        alloc = _rl(int(rng.integers(2, 8)) * 1000, 8 * GiB, pods=20)
        cache.add_node(Node(name=f"n{i:03d}", allocatable=dict(alloc),
                            capacity=dict(alloc)))
    for g in range(n_groups):
        name = f"g{g:03d}"
        cache.add_pod_group(PodGroup(
            name=name, namespace="ns", min_member=max(1, pods_per_group - 1),
            queue=f"q{g % n_queues}", creation_timestamp=float(g)))
        for p in range(pods_per_group):
            cache.add_pod(Pod(
                uid=f"ns-{name}-{p}", name=f"{name}-{p}", namespace="ns",
                node_name="", phase=PodPhase.PENDING,
                containers=[Container(requests=_rl(
                    int(rng.integers(1, 4)) * 500, 2 * GiB))],
                annotations={GROUP_NAME_ANNOTATION: name},
                priority=int(rng.integers(1, 5)),
                creation_timestamp=float(g * 100 + p)))


def _cache(seed):
    cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                           device="cpu")
    port_cluster(cache, seed=seed)
    return cache


def _inputs(cache, affinity=False):
    return build_cycle_inputs(OpenSession(cache, shipped_tiers()),
                              allow_affinity=affinity)


def port_affinity_cluster(cache, n_nodes=12, n_groups=10, seed=0):
    """tests/test_sharded_batched.py ``build_affinity_cluster`` in the
    port's objects (the same draws from the same seed): anti-affinity
    spread, zone co-location (zones z0-z2 cycle over the nodes, so every
    domain straddles the ranks' blocks), preferred steering toward a
    running pod, host ports."""
    from kubebatch_tpu_torch.objects import Affinity, PodAffinityTerm

    rng = np.random.default_rng(seed)
    cache.add_queue(Queue(name="default", weight=1))
    for i in range(n_nodes):
        alloc = _rl(8000, 16 * GiB, pods=110)
        cache.add_node(Node(name=f"n{i:03d}", allocatable=dict(alloc),
                            capacity=dict(alloc),
                            labels={"kubernetes.io/hostname": f"n{i:03d}",
                                    "zone": f"z{i % 3}"}))

    def pod(name, node, phase, req, group, labels, ts=0.0):
        return Pod(uid=f"ns-{name}", name=name, namespace="ns",
                   node_name=node, phase=phase,
                   containers=[Container(requests=dict(req))],
                   labels=dict(labels),
                   annotations={GROUP_NAME_ANNOTATION: group},
                   creation_timestamp=ts)

    cache.add_pod_group(PodGroup(name="db", namespace="ns", min_member=1,
                                 queue=""))
    cache.add_pod(pod("db-0", "n002", PodPhase.RUNNING, _rl(500, GiB), "db",
                      {"app": "db"}))
    apps = ["red", "blue", "green"]
    for g in range(n_groups):
        app = apps[int(rng.integers(len(apps)))]
        size = int(rng.integers(2, 5))
        cache.add_pod_group(PodGroup(name=f"g{g:03d}", namespace="ns",
                                     min_member=size, queue="",
                                     creation_timestamp=float(g)))
        for p in range(size):
            pd = pod(f"g{g:03d}-{p}", "", PodPhase.PENDING,
                     _rl(400, GiB // 2), f"g{g:03d}", {"app": app},
                     float(g * 100 + p))
            roll = rng.random()
            if roll < 0.3:
                pd.affinity = Affinity(pod_anti_affinity_required=[
                    PodAffinityTerm(match_labels={"app": app},
                                    topology_key="kubernetes.io/hostname")])
            elif roll < 0.5:
                pd.affinity = Affinity(pod_affinity_required=[
                    PodAffinityTerm(match_labels={"app": app},
                                    topology_key="zone")])
            elif roll < 0.7:
                pd.affinity = Affinity(pod_affinity_preferred=[
                    (50, PodAffinityTerm(match_labels={"app": "db"},
                                         topology_key="kubernetes.io/"
                                                      "hostname"))])
            elif roll < 0.8:
                pd.containers[0].ports = [8080]
            cache.add_pod(pd)


#: a predicate-rich sim mix (tests/test_sharded_batched.py's end-to-end
#: spec's fractions) at test scale
_AFF_SPEC = dict(n_queues=4, queue_weights=(1, 2, 3, 4), pod_cpu_millis=800,
                 pod_mem_bytes=GiB, n_zones=8, selector_frac=0.15,
                 taint_frac=0.1, toleration_frac=0.15,
                 anti_affinity_frac=0.08, zone_affinity_frac=0.05,
                 pref_affinity_frac=0.08, hostport_frac=0.04)


def _aff_case_cache(case):
    """A cycle carrying the vocabulary: "rollback" (anti-affine gangs on
    four hostnames, preferred co-location and a host port: partial gangs
    strand and the epilogue subtracts their carry), "interpod" (the
    reference's affinity cluster, seed 5: the interpod score and zone
    domains straddling every block) or "sim" (the predicate-rich sim mix,
    contended)."""
    if case == "rollback":
        return _aff_cache()
    cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                           incremental_snapshot=False, device="cpu")
    if case == "interpod":
        port_affinity_cluster(cache, seed=5)
    else:
        build_cluster(ClusterSpec(n_nodes=24, n_groups=40, pods_per_group=4,
                                  seed=2, **_AFF_SPEC)).populate(cache)
    return cache


def _tensor_args(node, rep):
    return {k: torch.from_numpy(np.array(v, copy=True)).to(
        t_batched.arg_dtype(k)) for k, v in {**node, **rep}.items()}


def _check_affinity_bitwise(mesh, case):
    """The sharded solve of ``case`` over ``mesh`` bitwise against the
    one-card plain batched solve (compact_bucket=0) on the same bucket:
    decisions, nodes, sequence numbers, rounds, the frame but its engine
    and narrow words, the node carry, the [P,D] carry and the port
    claims. Returns the one-card frame."""
    want_in = _inputs(_aff_case_cache(case), affinity=True)
    got_in = _inputs(_aff_case_cache(case), affinity=True)
    assert want_in.affinity is not None
    node, rep, statics, n_sh = bs.prepare_sharded(mesh.world,
                                                  want_in.device, want_in)
    t = _tensor_args(node, rep)
    aff = {k: t[k] for k in t_batched.AFF_ARGS}
    if "task_ports" in rep:
        aff.update(task_ports=t["task_ports"], port_base=t["port_base"])
    if t_batched.IP_ARG in rep:
        aff[t_batched.IP_ARG] = t[t_batched.IP_ARG].reshape(())
    want = t_batched.batched_allocate_plain(
        **{k: t[k] for k in t_batched.NODE_ARGS + t_batched.CYCLE_ARGS},
        compact_bucket=0, aff=aff, **statics)
    got = bs.solve_batched_sharded(mesh, got_in.device, got_in)
    t_pad = got_in.task_valid.shape[0]
    packed = want[0].numpy()
    for k in range(3):
        np.testing.assert_array_equal(packed[k * t_pad:(k + 1) * t_pad],
                                      got[k])
    assert int(packed[3 * t_pad]) == got[3]
    frame = packed[3 * t_pad + 1:]
    np.testing.assert_array_equal(frame[1:12], got[4][1:12])
    np.testing.assert_array_equal(frame[14:], got[4][14:])
    n_pad = got_in.device.n_padded
    for w, g in zip(want[1:5], _carry(got_in.device)):
        assert torch.equal(w[:n_pad], g)
    res = bs.last_solve["aff"]
    for name in ("aff_grp_cnt", "aff_anti_cnt", "aff_pref_w",
                 "aff_grp_total"):
        assert np.array_equal(want[5][name].numpy().view(np.uint32),
                              res[name].view(np.uint32)), name
    if want[5]["port_claim"] is None:
        assert res["port_claim"] is None
    else:
        np.testing.assert_array_equal(want[5]["port_claim"].numpy(),
                                      res["port_claim"])
    return frame


def _carry(device):
    return [getattr(device, k).clone() for k in
            ("idle", "releasing", "n_tasks", "nz_req")]


def _statuses(cache):
    return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
            for j in cache.jobs.values() for t in j.tasks.values()}


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """get(k): rank 0's mesh of a launched k-rank CPU group (the previous
    group closed first); every worker must import the port only."""
    state = {"k": None, "group": None}

    def get(k):
        if state["k"] != k:
            if state["group"] is not None:
                state["group"].close()
                state["group"] = None
            store = tmp_path_factory.mktemp(f"mesh{k}") / "store"
            group = worker.launch(k, str(store), device="cpu", timeout=120)
            state.update(k=k, group=group)
            for rank, facts in enumerate(worker.request_status(group.mesh)):
                if rank and (facts["jax"] or facts["kubebatch_tpu"]):
                    raise AssertionError(f"worker {rank} imported the "
                                         f"reference side: {facts}")
        return state["group"].mesh

    yield get
    if state["group"] is not None:
        state["group"].close()


def test_workers_import_the_port_only(meshes):
    mesh = meshes(4)
    facts = worker.request_status(mesh)
    assert len({f["pid"] for f in facts}) == 4
    assert not any(f["jax"] or f["kubebatch_tpu"] for f in facts[1:])
    assert mesh.world == 4 and mesh.rank == 0 and mesh.backend == "gloo"
    # CPU tensors: every collective runs in place, nothing staged
    assert not any(mesh.staged.values())


def test_sharded_against_reference_k4(meshes):
    """Decisions, sequence numbers and placed nodes equal to the
    reference's GSPMD solve on 4 of its CPU devices (tests/
    test_sharded_batched.py's fixture, seed 7)."""
    from kubebatch_tpu.kernels.batched_sharded import (
        node_mesh as j_node_mesh, solve_batched_sharded as j_solve)
    from kubebatch_tpu.actions.cycle_inputs import (
        build_cycle_inputs as j_build_inputs)

    from .test_sharded_batched import _open as j_open

    ssn = j_open(7)
    j_inputs = j_build_inputs(ssn)
    st_j, nd_j, seq_j, _ = j_solve(j_node_mesh(4), j_inputs.device, j_inputs)
    inputs = _inputs(_cache(7))
    st, nd, seq, rounds, telem = bs.solve_batched_sharded(
        meshes(4), inputs.device, inputs)
    np.testing.assert_array_equal(st, np.asarray(st_j))
    np.testing.assert_array_equal(seq, np.asarray(seq_j))
    placed = np.isin(st, [1, 2, 3])
    assert placed.sum() > 0
    np.testing.assert_array_equal(nd[placed], np.asarray(nd_j)[placed])
    assert telem[0] == 5                     # ENGINE_SHARDED


@pytest.mark.parametrize("seed", [0, 5])
def test_sharded_affinity_against_reference(meshes, seed):
    """With the affinity vocabulary: decisions, sequence numbers and
    placed nodes equal to the reference's GSPMD solve on its 8-device
    CPU mesh (tests/test_sharded_batched.py
    test_sharded_affinity_decisions_match_single_device's cluster)."""
    from kubebatch_tpu.actions.cycle_inputs import (
        build_cycle_inputs as j_build_inputs)
    from kubebatch_tpu.kernels.batched_sharded import (
        node_mesh as j_node_mesh, solve_batched_sharded as j_solve)

    from .test_sharded_batched import _open_affinity

    j_inputs = j_build_inputs(_open_affinity(seed), allow_affinity=True)
    st_j, nd_j, seq_j, _ = j_solve(j_node_mesh(), j_inputs.device, j_inputs)
    cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                           device="cpu")
    port_affinity_cluster(cache, seed=seed)
    inputs = _inputs(cache, affinity=True)
    assert inputs.affinity is not None
    st, nd, seq, _, telem = bs.solve_batched_sharded(meshes(4),
                                                     inputs.device, inputs)
    np.testing.assert_array_equal(st, np.asarray(st_j))
    np.testing.assert_array_equal(seq, np.asarray(seq_j))
    placed = np.isin(st, [1, 2, 3])
    assert placed.sum() > 0
    np.testing.assert_array_equal(nd[placed], np.asarray(nd_j)[placed])
    assert telem[0] == 5


def test_hier_sharded_against_reference(meshes):
    """The two-level solve over the mesh: decisions, nodes and sequence
    numbers equal to the reference's solve_hier_sharded on its 8-device
    CPU mesh (tests/test_zscale_hier.py
    test_hier_mesh_1d_and_2d_match_single_chip's cluster, pools of 8);
    the frame carries ENGINE_HIER_SHARDED."""
    from kubebatch_tpu.actions.cycle_inputs import (
        build_cycle_inputs as j_build_inputs)
    from kubebatch_tpu.kernels.batched_sharded import (
        node_mesh as j_node_mesh)
    from kubebatch_tpu.kernels.hier import solve_hier_sharded as j_solve

    from .test_zscale_hier import _open as j_open

    j_inputs = j_build_inputs(j_open(n_nodes=24, n_groups=12,
                                     pods_per_group=4, seed=3))
    st_j, nd_j, sq_j, _ = j_solve(j_node_mesh(), j_inputs.device, j_inputs,
                                  pool_size=8)
    inputs = _inputs(_cache(3))
    st, nd, sq, rounds, telem = t_hier.solve_hier_sharded(
        meshes(4), inputs.device, inputs, pool_size=8)
    np.testing.assert_array_equal(st, np.asarray(st_j))
    np.testing.assert_array_equal(nd, np.asarray(nd_j))
    np.testing.assert_array_equal(sq, np.asarray(sq_j))
    assert np.isin(st, [1, 2, 3]).sum() > 0
    assert telem[0] == 6                     # ENGINE_HIER_SHARDED


def test_sharded_half_cfg5_places_every_task(meshes):
    """The reference's half-cfg5 partitioned cycle (1,250 nodes, ~2.5k
    pods) over 4 ranks: every task placed, bitwise the one-card plain
    solve."""
    spec = ClusterSpec(n_nodes=1250, n_groups=312, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2)
    caches = []
    for _ in range(2):
        cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                               incremental_snapshot=False, device="cpu")
        build_cluster(spec).populate(cache)
        caches.append(_inputs(cache))
    a, b = caches
    want = t_batched.solve_batched(a, compact_bucket=0)
    got = bs.solve_batched_sharded(meshes(4), b.device, b)
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(w, g)
    assert want[3] == got[3]
    n_real = len(b.tasks)
    assert np.isin(got[0][:n_real], [1, 2]).sum() == n_real
    for w, g in zip(_carry(a.device), _carry(b.device)):
        assert torch.equal(w, g)
    ranks = bs.last_solve["ranks"]
    assert [r["rounds"] for r in ranks] == [got[3]] * 4
    # five all-gathers a round and the carry's
    assert all(r["collectives"] == 5 * got[3] + 1 for r in ranks)


def test_sharded_mode_end_to_end(meshes):
    """AllocateAction(mode="sharded", mesh=...) leaves the session in the
    state mode="batched" leaves it in (reference
    test_sharded_mode_end_to_end)."""
    mesh = meshes(4)
    results = {}
    for mode in ("batched", "sharded"):
        cache = _cache(3)
        ssn = OpenSession(cache, shipped_tiers())
        AllocateAction(mode=mode, mesh=mesh).execute(ssn)
        assert t_allocate_mod.last_cycle_engine == mode
        results[mode] = {f"{t.namespace}/{t.name}": (t.status, t.node_name)
                         for j in ssn.jobs.values()
                         for t in j.tasks.values()}
        CloseSession(ssn)
        results[mode + " closed"] = _statuses(cache)
    assert results["sharded closed"] == results["batched closed"]
    assert results["sharded"] == results["batched"]


def test_affinity_cycle_raises(meshes):
    """A cycle carrying the affinity vocabulary under mode "sharded" runs
    the sharded engine (it raised before the affinity branch came), with
    no engine demotion and no affinity host fallback, and leaves the
    session as mode="batched" does (the reference's
    test_sharded_mode_affinity_end_to_end_no_demotion: the cfg5p mix at
    test scale)."""
    spec = ClusterSpec(n_nodes=64, n_groups=48, pods_per_group=4, **_AFF_SPEC)
    results = {}
    for mode in ("batched", "sharded"):
        cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                               device="cpu")
        build_cluster(spec).populate(cache)
        ssn = OpenSession(cache, shipped_tiers())
        d0 = t_metrics.engine_demotions_total()
        f0 = t_metrics.affinity_host_fallback_total()
        AllocateAction(mode=mode, mesh=meshes(4)).execute(ssn)
        assert t_metrics.engine_demotions_total() == d0, mode
        assert t_metrics.affinity_host_fallback_total() == f0, mode
        assert t_allocate_mod.last_cycle_engine == mode
        assert t_allocate_batched.last_solve["affinity"]
        results[mode] = {f"{t.namespace}/{t.name}": (t.status, t.node_name)
                         for j in ssn.jobs.values()
                         for t in j.tasks.values()}
        CloseSession(ssn)
    assert results["sharded"] == results["batched"]


def _aff_cache():
    from .test_torch_cuda import AffWorld, aff_rollback_build
    from kubebatch_tpu_torch import objects as t_objects

    cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                           device="cpu")
    w = AffWorld(t_objects)
    cache.add_queue(w.queue())
    aff_rollback_build(cache, w)
    return cache


def test_upgraded_affinity_cycle_runs_batched_counted(meshes, monkeypatch):
    """An affinity cycle that auto's sharded upgrade (or the hier
    demotion's, with a mesh) sends to the sharded engine runs sharded,
    with no ("sharded", "batched") demotion (the hier demotion counted
    as ("hier", "sharded"), as the reference counts it), and leaves the
    session as mode="batched" does; Scheduler(mesh=...) binds such
    cycles on the sharded engine."""
    monkeypatch.setattr(t_allocate_mod, "AUTO_BATCHED_MIN", 1)
    monkeypatch.setattr(t_allocate_mod, "AUTO_SHARDED_MIN_NODES", 4)
    mesh = meshes(4)
    want_cache = _aff_cache()
    ssn = OpenSession(want_cache, shipped_tiers())
    AllocateAction(mode="batched").execute(ssn)
    CloseSession(ssn)
    want = _statuses(want_cache)
    assert any(node for _, node in want.values())
    key = ("sharded", "batched")
    for mode, extra in (("auto", {}), ("hier", {("hier", "sharded"): 1})):
        cache = _aff_cache()
        ssn = OpenSession(cache, shipped_tiers())
        pairs0 = dict(t_metrics.engine_demotions_by_pair())
        AllocateAction(mode=mode, mesh=mesh).execute(ssn)
        CloseSession(ssn)
        pairs = t_metrics.engine_demotions_by_pair()
        assert t_allocate_mod.last_cycle_engine == "sharded", mode
        for pair, n in {key: 0, **extra}.items():
            assert pairs.get(pair, 0) - pairs0.get(pair, 0) == n, (mode, pair)
        assert _statuses(cache) == want, mode
    cache = _aff_cache()
    sched = Scheduler(cache, schedule_period=3600.0, mesh=mesh)
    assert sched.run_cycle()
    assert t_allocate_mod.last_cycle_engine == "sharded"


@pytest.mark.parametrize("side", ["cpu mesh, card session",
                                  "card mesh, cpu session"])
def test_mesh_device_must_match_session(meshes, side):
    """The ranks solve on the mesh's device: a mesh of another device
    type than the session's node carry is refused before any rank
    works, never run on the host in hiding."""
    from types import SimpleNamespace

    inputs = _inputs(_cache(0))
    if side.startswith("cpu"):
        card = SimpleNamespace(device=torch.device("cuda"), n_padded=32)
        with pytest.raises(ValueError, match="mesh's ranks are on cpu"):
            bs.solve_batched_sharded(meshes(4), card, inputs)
    else:
        meshes(4)
        card_mesh = t_mesh.NodeMesh(device="cuda")
        assert card_mesh.world == 4 and card_mesh.staged["all_gather"]
        ssn = OpenSession(_cache(0), shipped_tiers())
        with pytest.raises(ValueError, match="mesh's ranks are on cuda"):
            AllocateAction(mode="sharded", mesh=card_mesh).execute(ssn)
    # the workers were not asked for anything: the group still serves
    got = bs.solve_batched_sharded(meshes(4), inputs.device, inputs)
    assert got[3] > 0


def _scan_inputs(seed, n=64, t=8):
    """__graft_entry__._example_problem's shapes with values from a
    seed: a contended, partly pipelined cluster."""
    rng = np.random.default_rng(seed)
    idle = rng.uniform(20, 120, (n, 3)).astype(np.float32)
    releasing = np.where(rng.random((n, 1)) < 0.3,
                         rng.uniform(10, 80, (n, 3)), 0).astype(np.float32)
    backfilled = np.where(rng.random((n, 1)) < 0.2,
                          rng.uniform(5, 30, (n, 3)), 0).astype(np.float32)
    max_task_num = rng.integers(1, 4, n).astype(np.int32)
    n_tasks = rng.integers(0, 2, n).astype(np.int32)
    node_ok = rng.random(n) < 0.9
    resreq = rng.uniform(10, 90, (t, 3)).astype(np.float32)
    task_valid = rng.random(t) < 0.9
    scores = np.round(rng.normal(size=(t, n)) * 4).astype(np.float32)
    scores[:, 5] = -0.0
    pred = rng.random((t, n)) < 0.7
    return (idle, releasing, backfilled, max_task_num, n_tasks, node_ok,
            resreq, resreq.copy(), task_valid, scores, pred,
            np.int32(t // 2), np.int32(1))


def test_scan_against_reference_k4(meshes):
    """The explicit-collective scan bitwise against the reference's
    build_sharded_allocate(demo_mesh(4)): all six outputs."""
    import jax.numpy as jnp
    from kubebatch_tpu.kernels.sharded import (build_sharded_allocate,
                                               demo_mesh)

    args = _scan_inputs(3)
    want = build_sharded_allocate(demo_mesh(4))(
        *args[:11], jnp.asarray(args[11]), jnp.asarray(args[12]))
    got = t_sharded.build_sharded_allocate(meshes(4))(*args)
    for w, g, name in zip(want, got, ("decisions", "node_idx", "idle",
                                      "releasing", "n_tasks", "ready")):
        w = np.asarray(w)
        g = g.numpy()
        assert w.shape == g.shape and w.dtype == g.dtype, name
        assert np.array_equal(w.view(np.uint8), g.view(np.uint8)), name
    assert len(set(np.asarray(want[0]).tolist())) > 1


#: the two-level cases: (spec seed, pool) — "contended" revives
#: stranded gangs through the epilogue over many waves, "straddle" takes
#: pools wider than a rank's block at k = 4
_HIER_CASES = {"contended": (0, 8), "straddle": (1, 32)}


def _hier_cache(seed):
    cache = SchedulerCache(binder=_Binder(), async_writeback=False,
                           incremental_snapshot=False, device="cpu")
    build_cluster(ClusterSpec(
        n_nodes=48, n_groups=72, pods_per_group=8, n_queues=4,
        queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
        pod_mem_bytes=2 * GiB, jitter=0.2, min_member=6,
        seed=seed)).populate(cache)
    return cache


def _check_hier_bitwise(mesh, seed, pool):
    """solve_hier_sharded over ``mesh`` bitwise against the one-card
    plain two-level solve on the same bucket and pool: decisions, nodes,
    sequence numbers, rounds, the frame but its engine id, the node
    carry. Returns (frame, rank 0's work counts)."""
    got_in, want_in = _inputs(_hier_cache(seed)), _inputs(_hier_cache(seed))
    got = t_hier.solve_hier_sharded(mesh, got_in.device, got_in,
                                    pool_size=pool)
    st = bs.last_solve["statics"]
    node, rep, _, n_sh = bs.prepare_sharded(mesh.world, want_in.device,
                                            want_in)
    t = _tensor_args(node, rep)
    want = t_hier.hier_allocate_plain(
        **{k: t[k] for k in t_batched.NODE_ARGS + t_batched.CYCLE_ARGS},
        **{k: st[k] for k in ("job_keys", "queue_keys", "prop_overused",
                              "dyn_enabled", "pipe_enabled", "max_rounds",
                              "pool_size", "max_waves", "gang_enabled",
                              "narrow", "narrow_gate")})
    t_pad = got_in.task_valid.shape[0]
    packed = want[0].numpy()
    for k in range(3):
        np.testing.assert_array_equal(packed[k * t_pad:(k + 1) * t_pad],
                                      got[k])
    assert int(packed[3 * t_pad]) == got[3]
    frame = packed[3 * t_pad + 1:]
    np.testing.assert_array_equal(frame[1:], got[4][1:])
    assert frame[0] == 4 and got[4][0] == 6
    n_pad = got_in.device.n_padded
    for w, g in zip(want[1:5], _carry(got_in.device)):
        assert torch.equal(w[:n_pad], g)
    return frame, bs.last_solve["ranks"][0]["work"]


@pytest.mark.parametrize("case", ["rollback", "interpod", "sim"])
def test_sharded_affinity_bitwise_k4(meshes, case):
    """B14a's affinity branch over 4 ranks, bitwise the one-card plain
    solve with its [P,D] carry and port claims (host ports, the
    interpod score, the stranded-gang rollback, domains straddling the
    blocks)."""
    frame = _check_affinity_bitwise(meshes(4), case)
    if case == "rollback":
        assert frame[14] > 0                 # the epilogue revived gangs


@pytest.mark.parametrize("case", sorted(_HIER_CASES))
def test_hier_sharded_bitwise_k4(meshes, case):
    """The two-level solve over 4 ranks bitwise the one-card plain
    two-level solve: pools straddling two ranks' blocks, and a contended
    multi-wave cycle through the epilogue."""
    seed, pool = _HIER_CASES[case]
    frame, work = _check_hier_bitwise(meshes(4), seed, pool)
    assert frame[14] > 0                     # the epilogue ran
    if case == "straddle":
        assert work["straddling"] > 0
    assert work["waves"] > 1 and work["rounds"] == frame[1]


@pytest.mark.parametrize("k,seed", [(4, 0), (4, 7), (2, 0), (2, 7)])
def test_sharded_bitwise_against_one_card(meshes, k, seed):
    """tests/test_sharded_batched.py's 24-node fixture over k ranks:
    bitwise the one-card plain solve with compact_bucket=0 (decisions,
    nodes, sequence numbers, rounds, the written-back carry)."""
    a, b = _inputs(_cache(seed)), _inputs(_cache(seed))
    want = t_batched.solve_batched(a, compact_bucket=0)
    rb0 = t_metrics.blocking_readbacks()
    got = bs.solve_batched_sharded(meshes(k), b.device, b)
    # the node block's stage, the packed result, the carry's four arrays
    assert t_metrics.blocking_readbacks() - rb0 == 6
    for w, g in zip(want[:3], got[:3]):
        np.testing.assert_array_equal(w, g)
    assert want[3] == got[3]
    # the frame but the engine id and the per-shard narrow words
    np.testing.assert_array_equal(want[4][1:12], got[4][1:12])
    np.testing.assert_array_equal(want[4][14:], got[4][14:])
    for w, g in zip(_carry(a.device), _carry(b.device)):
        assert torch.equal(w, g)


def test_auto_picks_sharded_with_a_mesh(meshes, monkeypatch):
    """Auto upgrades batched -> sharded where the reference's _auto_mode
    would (pending >= AUTO_BATCHED_MIN, nodes >= AUTO_SHARDED_MIN_NODES,
    here patched down to the fixture) with a 2-rank mesh, and stays
    batched without one; Scheduler(mesh=...) hands its mesh on."""
    monkeypatch.setattr(t_allocate_mod, "AUTO_BATCHED_MIN", 16)
    monkeypatch.setattr(t_allocate_mod, "AUTO_SHARDED_MIN_NODES", 16)
    mesh = meshes(2)
    engines = {}
    for name, m in (("mesh", mesh), ("none", None)):
        cache = _cache(0)
        ssn = OpenSession(cache, shipped_tiers())
        AllocateAction(mode="auto", mesh=m).execute(ssn)
        engines[name] = t_allocate_mod.last_cycle_engine
        CloseSession(ssn)
    assert engines == {"mesh": "sharded", "none": "batched"}
    monkeypatch.setattr(t_allocate_mod, "AUTO_SHARDED_MIN_NODES", 25)
    ssn = OpenSession(_cache(0), shipped_tiers())
    AllocateAction(mode="auto", mesh=mesh).execute(ssn)
    assert t_allocate_mod.last_cycle_engine == "batched"   # 24 nodes
    sched = Scheduler(_cache(0), schedule_period=3600.0, mesh=mesh)
    alloc = [a for a in sched.actions if a.name == "allocate"]
    assert alloc and alloc[0].mesh is mesh and alloc[0].mode == "auto"


@pytest.mark.parametrize("k,case", [(k, c) for k in (2, 3)
                                    for c in ("rollback", "interpod",
                                              "sim")])
def test_sharded_affinity_bitwise_against_one_card(meshes, k, case):
    """B14a's affinity branch at k = 2 and 3 (the bucket padded to a
    multiple of 3 with inert nodes: no domain, no ports), bitwise the
    one-card plain solve on the same bucket."""
    frame = _check_affinity_bitwise(meshes(k), case)
    if case == "rollback":
        assert frame[14] > 0


def test_non_pow2_bucket_k3(meshes):
    """k = 3 pads the node bucket to a multiple of 3 (32 -> 33, not a
    power of two): bitwise the one-card plain solve over that bucket,
    and the same decisions as the one-card solve on its own bucket."""
    inputs = _inputs(_cache(0))
    node, rep, statics, n_sh = bs.prepare_sharded(3, inputs.device, inputs)
    assert n_sh == 33 and inputs.device.n_padded == 32
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
        t_batched.arg_dtype(k)) for k, v in {**node, **rep}.items()}
    want = t_batched.batched_allocate_plain(
        **{k: t[k] for k in t_batched.NODE_ARGS + t_batched.CYCLE_ARGS},
        compact_bucket=0, **statics)
    b = _inputs(_cache(0))
    got = bs.solve_batched_sharded(meshes(3), b.device, b)
    t_pad = inputs.task_valid.shape[0]
    packed = want[0].numpy()
    for k in range(3):
        np.testing.assert_array_equal(packed[k * t_pad:(k + 1) * t_pad],
                                      got[k])
    assert int(packed[3 * t_pad]) == got[3]
    for w, g in zip(want[1:], _carry(b.device)):
        assert torch.equal(w[:32], g)
    one = t_batched.solve_batched(_inputs(_cache(0)), compact_bucket=0)
    np.testing.assert_array_equal(one[0], got[0])


def test_hier_sharded_bitwise_k3(meshes):
    """The two-level solve over 3 ranks (bucket 66, pools of 6: pools
    straddle the 22-node blocks) bitwise the one-card plain two-level
    solve, through the epilogue."""
    frame, work = _check_hier_bitwise(meshes(3), 0, 8)
    assert frame[14] > 0 and work["straddling"] > 0


def test_one_rank_mesh_and_no_mesh_demote_counted(meshes):
    """A one-rank mesh (a launched group of one) or none adds nothing:
    mode "sharded" demotes to batched, counted as the reference counts
    it on one device."""
    for mesh in (meshes(1), None):
        assert t_mesh.world_size(mesh) == 1
        cache = _cache(0)
        ssn = OpenSession(cache, shipped_tiers())
        pairs0 = dict(t_metrics.engine_demotions_by_pair())
        AllocateAction(mode="sharded", mesh=mesh).execute(ssn)
        pairs = t_metrics.engine_demotions_by_pair()
        assert t_allocate_mod.last_cycle_engine == "batched"
        key = ("sharded", "batched")
        assert pairs.get(key, 0) - pairs0.get(key, 0) == 1
        CloseSession(ssn)


def test_lockstep_contended_cycle_bitwise():
    """k ranks in lock step without a process group (the card tests'
    driver) on a nearly full cluster with releasing capacity: pipelined
    placements, the stranded-gang epilogue's three revivals, bitwise the
    one-card plain solve."""
    spec = ClusterSpec(n_nodes=16, n_groups=24, pods_per_group=4,
                       min_member=2, running_fill=0.9, n_queues=2,
                       queue_weights=(1, 3), pod_cpu_millis=1000,
                       pod_mem_bytes=GiB, seed=7)
    sim = build_cluster(spec)
    for pod in [p for p in sim.pods if p.name.startswith("fill-")][::2]:
        pod.deletion_timestamp = 1.0
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False,
                           device="cpu")
    sim.populate(cache)
    inputs = _inputs(cache)
    node, rep, statics, n_sh = bs.prepare_sharded(2, inputs.device, inputs)
    packed, carry, _ = bs.solve_lockstep(node, rep, statics, n_sh, 2, "cpu")
    want = t_batched.solve_batched(inputs, compact_bucket=0)
    t_pad = inputs.task_valid.shape[0]
    for k in range(3):
        np.testing.assert_array_equal(
            packed[k * t_pad:(k + 1) * t_pad].numpy(), want[k])
    frame = packed[3 * t_pad + 1:].numpy()
    assert frame[14] == 3 and (want[0] == 3).any()   # retries, pipelined
    c = carry.numpy()
    for cols, name in ((slice(0, 3), "idle"), (slice(3, 6), "releasing"),
                       (slice(7, 9), "nz_req")):
        np.testing.assert_array_equal(
            np.ascontiguousarray(c[:, cols]).view(np.float32),
            getattr(inputs.device, name).numpy())
    np.testing.assert_array_equal(c[:, 6], inputs.device.n_tasks.numpy())


def test_combine_first_max_in_global_order():
    """The cross-rank argmax keeps the first maximum in global node
    order, as one argmax over the whole row: ties across ranks, -0.0
    against +0.0, and a row with no eligible node (node 0)."""
    rng = np.random.default_rng(0)
    k, t, nb = 4, 64, 8
    scores = np.round(rng.normal(size=(t, k * nb)) * 2).astype(np.float32)
    scores[0] = -np.inf
    scores[1, 3], scores[1, 9] = 0.0, -0.0
    scores[1, scores[1] > 0] = -1.0
    elig = np.isfinite(scores) & (rng.random((t, k * nb)) < 0.8)
    elig[0] = False
    parts = []
    for r in range(k):
        sl = slice(r * nb, (r + 1) * nb)
        s = np.where(elig[:, sl], scores[:, sl], -np.inf)
        best = s.argmax(axis=1)
        anyb = elig[:, sl].any(axis=1)
        part = np.zeros((t, bs.W_PART), np.int32)
        part[:, 0] = anyb
        part[:, 1] = np.where(anyb, s[np.arange(t), best],
                              -np.inf).astype(np.float32).view(np.int32)
        part[:, 2] = best + r * nb
        part[:, 3] = r
        parts.append(part)
    any_t, best, rows = bs.PlainRank._combine(torch.from_numpy(
        np.stack(parts)))
    whole = np.where(elig, scores, -np.inf).argmax(axis=1)
    np.testing.assert_array_equal(any_t.numpy(), elig.any(axis=1))
    np.testing.assert_array_equal(best.numpy(), np.where(
        elig.any(axis=1), whole, 0))
    assert best[0] == 0 and rows[0, 0] == 0


def test_shard_bucket_and_transport(meshes, monkeypatch):
    """shard_bucket as the reference's (tests/test_sharded_batched.py),
    and the transport: a mesh on a card stages its gloo collectives
    through host memory, one on the CPU does not, and a group of another
    backend is refused when the mesh is built."""
    from kubebatch_tpu.kernels.batched_sharded import shard_bucket as j_sb

    for n, k in ((5000, 8), (8, 8), (9, 8), (24, 8), (24, 6), (5000, 12),
                 (24, 3), (8192, 2), (8192, 4), (8192, 3), (50000, 4)):
        assert t_mesh.shard_bucket(n, k) == j_sb(n, k)
    one = meshes(1)
    assert (one.rank, one.world, one.block(32)) == (0, 1, (0, 32))
    assert not one.staged["all_gather"]
    assert t_mesh.NodeMesh(device="cuda").staged["all_gather"]
    monkeypatch.setattr(t_mesh.dist, "get_backend", lambda group: "nccl")
    with pytest.raises(NotImplementedError, match="NCCL leg"):
        t_mesh.NodeMesh(device="cuda")
    words = torch.tensor([-0.0, 0.0, -1.5], dtype=torch.float32)
    g = one.all_gather(words.view(torch.int32))
    assert torch.equal(g[0], words.view(torch.int32))


@pytest.mark.parametrize("on_card", [False, True])
def test_cap_engine_sharded_matches_reference_ladder(on_card):
    """cap_engine("sharded") at every level equals the reference's ladder
    (tests/test_chaos.py: level 1 caps sharded to batched); over a CUDA
    cache the cap stops at the card's last level."""
    from kubebatch_tpu import faults as j_faults

    for level in range(4):
        lad = t_faults.DegradationLadder()
        lad.level = level
        ref = j_faults.DegradationLadder()
        ref.level = min(level, t_faults.CARD_MAX_LEVEL) if on_card else level
        assert lad.cap_engine("sharded", on_card=on_card) == \
            ref.cap_engine("sharded")
    lad = t_faults.DegradationLadder()
    lad.level = 1
    assert lad.cap_engine("sharded", on_card=on_card) == "batched"


@pytest.mark.parametrize("other", [8, 1], ids=["coarse_pass", "round"])
def test_hier_sharded_weighted_sum_fma(other):
    """The float order of the reference's two-level graph over the mesh
    (``_hier_sharded_entry``), probed on its 8-device CPU mesh with
    fractional nodeorder weights where fma(balanced, w1, least * w0)
    differs from the two rounded products' sum (tests/test_torch_hier.py
    test_weighted_sum_edge's cycle: in another pool the coarse pass's
    pool score decides, in the same pool the round's waterfall order):
    the graph contracts the sum, xla_order.WEIGHTED_SUM_FMA
    ["hier_sharded"] says so, and the port's two-level solve over two
    ranks places as the reference does."""
    import jax
    from jax.sharding import NamedSharding
    from kubebatch_tpu.kernels import hier as j_hier
    from kubebatch_tpu.kernels.batched import (CycleArrays as JArrays,
                                               RoundState as JState)
    from kubebatch_tpu.kernels.batched_sharded import (
        _specs_for, node_mesh as j_node_mesh)
    from kubebatch_tpu.kernels.fused import (K_DRF_SHARE, K_GANG_READY,
                                             K_PRIORITY, K_PROP_SHARE)
    from kubebatch_tpu_torch.kernels.xla_order import WEIGHTED_SUM_FMA

    from .test_torch_hier import _synthetic, weighted_edges

    mesh = j_node_mesh()
    array_specs, state_specs = _specs_for(mesh)
    statics = dict(job_keys=(K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
                   queue_keys=(K_PROP_SHARE,), prop_overused=True,
                   dyn_enabled=True, pipe_enabled=False, max_rounds=16,
                   gang_enabled=True, narrow=False, narrow_gate=False)

    def put(tree, specs):
        return type(tree)(**{k: jax.device_put(getattr(tree, k),
                                               NamedSharding(mesh, sp))
                             for k, sp in specs.items()})

    def reference(a, node):
        t_pad = a["task_valid"].shape[0]
        arrays = JArrays(**{k: a[k] if k in a else node[k]
                            for k in JArrays._fields
                            if k in a or k in node})
        state = JState(
            idle=node["idle"], releasing=node["releasing"],
            n_tasks=node["n_tasks"], nz_req=node["nz_req"],
            q_allocated=a["q_alloc0"], j_allocated=a["j_alloc0"],
            alloc_cnt=a["init_allocated"], job_alive=a["job_valid"],
            task_state=np.zeros(t_pad, np.int32),
            task_node=np.full(t_pad, -1, np.int32),
            task_seq=np.full(t_pad, np.iinfo(np.int32).max, np.int32))
        _, packed = j_hier._hier_sharded_entry(
            put(state, state_specs), put(arrays, array_specs), pool_size=8,
            **statics)
        return int(np.asarray(packed)[t_pad])

    def port(a, node):
        n = node["node_ok"].shape[0]
        nd = dict(node, sig_scores=a["sig_scores"], sig_pred=a["sig_pred"])
        rep = {k: a[k] for k in bs.REP_ARGS}
        st = dict(statics, pool_size=8, max_waves=(8 + 8) * (n // 8 + 1))
        packed, _, _ = bs.solve_hier_lockstep(nd, rep, st, n, 2, "cpu")
        return int(packed[a["task_valid"].shape[0]])

    assert WEIGHTED_SUM_FMA["hier_sharded"]
    cap, nz, edges = weighted_edges(3)
    for w, two, fma in edges:
        a, node = _synthetic()
        a["dyn_weights"][:] = w
        node["node_ok"][[0, other]] = True
        node["nz_req"][0] = nz
        node["allocatable_cm"][0] = cap
        node["allocatable_cm"][other] = 0.0
        a["sig_scores"][0, other] = max(fma, two)
        want = 0 if fma >= two else other
        assert reference(a, node) == want
        assert port(a, node) == want
