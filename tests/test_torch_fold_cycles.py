"""Folded four-action cycles: the port against the reference, on the CPU.

Both packages' caches run incremental, so every cycle after the first
opens on a folded snapshot, refreshes its DeviceSession rows through the
dirty-row scatter, reuses the persistent victim ``SegmentStore`` and the
drf/proportion/job-valid memos, and skips untouched settled jobs at
close. Over ten and more cycles of the shipped policy (reclaim,
allocate, backfill, preempt) with skewed churn, a node update, a node
delete, a podgroup delete and a priority-class change, the two packages
must agree per cycle in task statuses, binds, evictions, pipelines and
status writes, and in every array of the persistent store.

Also held word for word against the reference: the store after a forced
slot relocation, a row-space compaction, a job-space compaction and an
orphan job's return (tests/test_victims.py's persistent-store cases);
``wave_plain`` on those layouts against ``_wave_kernel``; the proportion
and drf memos across a re-sum boundary (``_RESUM_PERIOD`` patched to 4
in both packages' modules, a test-time patch); and ``scatter_rows_plain``
against the reference's ``_scatter_rows``, duplicate rows included.
Tolerance 0 throughout.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu.api import TaskStatus as JStatus  # noqa: E402
from kubebatch_tpu.kernels import solver as jsolver  # noqa: E402
from kubebatch_tpu.kernels import victims as jv  # noqa: E402
from kubebatch_tpu.plugins import proportion as j_proportion  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.api import TaskStatus as TStatus  # noqa: E402
from kubebatch_tpu_torch.debug import audit_cache  # noqa: E402
from kubebatch_tpu_torch.kernels import solver as tsolver  # noqa: E402
from kubebatch_tpu_torch.kernels import victims as tv  # noqa: E402
from kubebatch_tpu_torch.plugins import proportion as t_proportion  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_eventfold import (GiB, Side, four_actions,  # noqa: E402
                                   Twin)

#: SegmentStore fields compared word for word (arrays) or by value
STORE_ARRAYS = ("v_node", "v_job", "v_res", "v_crit", "v_live", "nz_mat",
                "cnt", "ready_cnt", "min_av", "j_alloc", "job_queue",
                "j_present", "host_rank")
STORE_VALUES = ("col_names", "slot_of", "rows_used", "dead_cap", "job_rows",
                "q_ids", "present_uids", "job_marks_pending", "orphan_uids",
                "host_rank_epoch")


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8)


def assert_bitwise(ref, got, what):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    assert ref.dtype == got.dtype, (what, ref.dtype, got.dtype)
    bad = np.flatnonzero(_bits(ref) != _bits(got))
    assert bad.size == 0, f"{what}: {bad.size} bytes differ"


def assert_stores_match(j, t, what=""):
    """The port's SegmentStore equals the reference's word for word."""
    if j is None or t is None:
        assert j is None and t is None, (what, j, t)
        return
    for f in STORE_ARRAYS:
        a, b = getattr(j, f), getattr(t, f)
        if a is None or b is None:
            assert a is None and b is None, (what, f)
            continue
        assert_bitwise(a, b, f"{what} store.{f}")
    for f in STORE_VALUES:
        assert getattr(j, f) == getattr(t, f), (what, f)
    assert [x.key if x is not None else None for x in j.row_tasks] \
        == [x.key if x is not None else None for x in t.row_tasks], what
    assert sorted(j.segs) == sorted(t.segs), what


def session_result(ssn):
    """Every task's (status, node), by task key."""
    return {t.key: (t.status.name, t.node_name)
            for job in ssn.jobs.values() for t in job.tasks.values()}


class SimSide(Side):
    """A Side on one package's sim of a ClusterSpec."""

    def __init__(self, torch_side, spec):
        super().__init__(torch_side)
        self.sim = (t_build(spec) if torch_side
                    else j_build(JSpec(**vars(spec))))
        self.sim.populate(self.cache)

    def kubelet_tick(self):
        """Bound pods start running; evicted pods are deleted."""
        gone = {p.uid for p in self.kubelet.evicted_pods}
        self.kubelet.tick(self.cache)
        if gone:
            self.sim.pods = [p for p in self.sim.pods if p.uid not in gone]
        for pod in self.sim.pods:
            if pod.node_name and pod.phase.name != "RUNNING":
                pod.phase = type(pod.phase).RUNNING
                self.cache.update_pod(pod, pod)
        assert self.cache.drain(timeout=5.0)


def fold_cycle(sides, what):
    """One four-action cycle on both sides (the port first; the reference
    runs the engine the port's auto chose), compared in full."""
    out = []
    for s in sorted(sides, key=lambda s: not s.torch_side):
        n_b, n_e, n_w = (len(s.kubelet.binds), len(s.kubelet.evicted),
                         len(s.status.writes))
        snap, diff = s.cache.audited_snapshot()
        assert not diff, (what, diff[:4])
        ssn = s.open(snapshot=snap)
        eng = "auto"
        if not s.torch_side:
            eng = t_allocate_mod.last_cycle_engine
        for act in four_actions(s.torch_side, eng):
            act.execute(ssn)
        result = session_result(ssn)
        pipelined = sorted(k for k, (st, _) in result.items()
                           if st == "PIPELINED")
        s.close(ssn)
        out.append((result, pipelined,
                    list(s.kubelet.binds.items())[n_b:],
                    s.kubelet.evicted[n_e:], s.status.writes[n_w:]))
    t, j = out
    for k, name in enumerate(("statuses", "pipelines", "binds",
                              "evictions", "status writes")):
        assert t[k] == j[k], f"{what}: {name} diverge"
    return t


def _events(k, sides, arrival):
    """The cycle-k events, the same on both sides."""
    for s in sides:
        s.kubelet_tick()
        s.sim.churn_tick(s.cache, 64, arrival_queue=arrival)
        sim, cache, m = s.sim, s.cache, s.w.m
        if k == 3:      # a node grows
            old = sim.nodes[1]
            new = dataclasses.replace(
                old, allocatable=dict(old.allocatable,
                                      cpu=old.allocatable["cpu"] * 2))
            cache.update_node(old, new)
            sim.nodes[1] = new
        if k == 5:      # a node leaves (its pods stay in their jobs)
            cache.delete_node(sim.nodes[-1])
        if k == 7:      # a gang is withdrawn: its pods, then its PodGroup
            key = m.GROUP_NAME_ANNOTATION
            bound = {p.annotations.get(key) for p in sim.pods
                     if p.node_name}
            jobs = [g for g in sim.groups if g.name.startswith("job-")]
            pg = next((g for g in jobs if g.name not in bound), jobs[-1])
            mine = [p for p in sim.pods if p.annotations.get(key) == pg.name]
            for p in mine:
                cache.delete_pod(p)
            cache.delete_pod_group(pg)
            sim.pods = [p for p in sim.pods if p not in mine]
            sim.groups.remove(pg)
        if k == 8:      # a cluster-wide priority-class change
            cache.add_priority_class(m.PriorityClass(
                name="batch-default", value=5, global_default=True))
        assert cache.drain(timeout=5.0)


@pytest.mark.parametrize("config,n_cycles", [
    ("cfg2", 10),
    ("reduced-cfg5", 11),
])
def test_folded_four_action_cycles_match_reference(config, n_cycles,
                                                   monkeypatch):
    """cfg2 (50 nodes, 100 gangs of 8, one queue) and cfg5 cut to 96
    nodes x 48 gangs (4 queues, skew alternating between queue 0 and 3):
    a cold cycle, then churn-64 cycles with a node update (cycle 3), a
    node delete (5), a podgroup delete (7) and a priority-class change
    (8). Port incremental against reference incremental."""
    spec = T_SPECS[2] if config == "cfg2" else dataclasses.replace(
        T_SPECS[5], n_nodes=96, n_groups=48)
    skew = config != "cfg2"
    builds = []
    inner = tv._build_victim_solver

    def probe(*a, **k):
        solver, reason = inner(*a, **k)
        if solver is not None:
            builds.append(solver.state.refreshed)
        return solver, reason

    monkeypatch.setattr(tv, "_build_victim_solver", probe)
    sides = (SimSide(False, spec), SimSide(True, spec))
    for k in range(n_cycles):
        if k:
            _events(k, sides, (0 if k % 2 else 3) if skew else None)
        fold_cycle(sides, f"{config} cycle {k}")
        assert_stores_match(sides[0].cache.victim_segments,
                            sides[1].cache.victim_segments,
                            f"{config} cycle {k}")
        assert not audit_cache(sides[1].cache)
    assert sides[1].cache._incremental
    assert sides[1].kubelet.binds
    # the persistent store served incremental builds: some refreshed
    # fewer nodes than the cluster holds
    assert builds and min(n for n, _ in builds) < spec.n_nodes, builds


# ---------------------------------------------------------------------
# the persistent store: relocation, compaction, orphan return
# ---------------------------------------------------------------------

def _pending(ssn, status):
    return [t for job in ssn.jobs.values()
            for t in job.task_status_index.get(status.PENDING, {}).values()]


def _twin_solvers(twin):
    """Open a session on both caches and build the preempt solver."""
    out = []
    for s, status, mod in ((twin.j, JStatus, jv), (twin.t, TStatus, tv)):
        ssn = s.open()
        solver = mod.build_victim_solver(
            ssn, _pending(ssn, status), "preemptable_fns",
            "preemptable_disabled", True)
        out.append((s, ssn, solver))
    return out


def _wave_matches_reference(js, jss):
    """wave_plain on the reference solver's own arrays (this layout)
    against _wave_kernel, for every pending task."""
    st = js.state
    jp = _pending(jss, JStatus)
    static, mutable, sig = (js.host_static_arrays(),
                            js.host_mutable_arrays(), js.host_sig_arrays())
    p = len(jp)
    lanes = [np.zeros((p, 3), np.float32), np.zeros((p, 3), np.float32),
             np.zeros((p, 2), np.float32), np.zeros(p, np.int32),
             np.full(p, -1, np.int32), np.full(p, -1, np.int32)]
    for i, t in enumerate(jp):
        lanes[0][i] = t.init_resreq.to_vec()
        lanes[1][i] = t.resreq.to_vec()
        lanes[2][i] = jv.nz_request_vec(t.resreq.to_vec())
        lanes[3][i] = js.terms.static.sig_of.get(t.uid, 0)
        ji = st.j_index.get(t.job, -1)
        lanes[4][i] = ji
        lanes[5][i] = st.job_queue[ji] if ji >= 0 else -1
    for fk in ("inter_queue", "intra_job"):
        cfg = dict(tiers=js.tiers, veto_critical=js.veto_critical,
                   filter_kind=fk, dyn_enabled=bool(js.dyn and js.dyn.enabled),
                   score_nodes=True, room_check=js.room_check)
        want = np.asarray(jv.run_wave_kernel(static, mutable, sig, *lanes,
                                             **cfg))
        kw = interop.victim_inputs_from_numpy(static, mutable, sig, lanes,
                                              "cpu")
        assert_bitwise(want, tv.victim_wave(**kw, **cfg).numpy(),
                       f"wave {fk}")


def _check_twin(twin, what, wave=True):
    """Build both solvers on a fresh session: the stores and the solvers'
    arrays equal word for word, and wave_plain equals _wave_kernel on
    this layout. Returns the port's store."""
    (_, jss, js), (_, tss, ts) = _twin_solvers(twin)
    assert (js is None) == (ts is None), what
    assert_stores_match(jss._victim_store, tss._victim_store, what)
    if js is not None:
        for x, y in zip(js.host_static_arrays(), ts.host_static_arrays()):
            assert_bitwise(x, y, f"{what} host_static_arrays")
        for x, y in zip(js.host_mutable_arrays(), ts.host_mutable_arrays()):
            assert_bitwise(x, y, f"{what} host_mutable_arrays")
        if wave:
            _wave_matches_reference(js, jss)
    store = tss._victim_store
    twin.j.close(jss)
    twin.t.close(tss)
    return store


def _running(twin, name, group, node, cpu=500, priority=1):
    def go(s, w):
        pod = s.objs[name] = w.pod(name, group, cpu, GiB, priority=priority)
        pod.node_name = node
        pod.phase = w.m.PodPhase.RUNNING
        s.cache.add_pod(pod)
    twin.apply(go)


def test_store_relocation_and_compaction_match_reference():
    """Ten nodes of 8 running tasks (slots of 9 rows); every round adds
    two running tasks to every node, so every slot outgrows its capacity
    and relocates to the tail; the dead capacity then passes the
    compaction threshold and the row space is laid out again."""
    twin = Twin(n_nodes=10)
    for n in range(10):
        twin.apply(lambda s, w, n=n: s.cache.add_pod_group(
            w.group(f"fill{n}", 1, "q1")))
    for n in range(10):
        for i in range(8):
            _running(twin, f"fill{n}-{i}", f"fill{n}", f"n{n:02d}")
    twin.add_gang("vip", 1, 1, "q2", cpu=4000, priority=100)
    store = _check_twin(twin, "fresh")
    assert store.rows_used == 90 and store.dead_cap == 0
    seen = {"relocated": False, "compacted": False}
    for rnd in range(3):
        for n in range(10):
            for i in range(2):
                _running(twin, f"fill{n}-x{rnd}{i}", f"fill{n}",
                         f"n{n:02d}")
        before = store.dead_cap
        store = _check_twin(twin, f"round {rnd}")
        seen["relocated"] |= store.dead_cap > before
        seen["compacted"] |= store.dead_cap < before
    assert seen == {"relocated": True, "compacted": True}, seen


def test_job_space_compaction_matches_reference():
    """80 single-pod jobs, then 76 of them finish: the assignment
    outgrows the live set and the job space compacts, remapping v_job."""
    twin = Twin(n_nodes=10)
    for g in range(80):
        twin.apply(lambda s, w, g=g: s.cache.add_pod_group(
            w.group(f"s{g:02d}", 1, "q1")))
        _running(twin, f"s{g:02d}-0", f"s{g:02d}", f"n{g % 10:02d}")
    twin.add_gang("vip", 1, 1, "q2", cpu=4000, priority=100)
    store = _check_twin(twin, "fresh")
    rows0 = len(store.job_rows)
    for g in range(76):
        twin.apply(lambda s, w, g=g: s.cache.delete_pod(
            s.objs[f"s{g:02d}-0"]))
    for s in twin.sides:
        assert s.cache.drain(timeout=5.0)
    store = _check_twin(twin, "after the jobs finished")
    assert len(store.job_rows) < rows0


def test_orphan_job_rows_repair_on_return():
    """A validate-dropped job's running rows are stored as v_job=-1;
    when the job returns (its new pods dirty only the job), its rows
    repair and go live — in both packages alike."""
    twin = Twin(n_nodes=1)
    twin.apply(lambda s, w: s.cache.add_pod_group(w.group("gappy", 4,
                                                          "q1")))
    for i in range(2):
        _running(twin, f"gappy-{i}", "gappy", "n00", cpu=1000)
    twin.add_gang("vip", 1, 1, "q1", cpu=4000, priority=100)
    store = _check_twin(twin, "gappy dropped")
    assert "ns/gappy" in store.orphan_uids

    def more(s, w):
        for i in (2, 3):
            s.cache.add_pod(w.pod(f"gappy-{i}", "gappy", 1000, GiB))
    twin.apply(more)
    store = _check_twin(twin, "gappy returns")
    assert "ns/gappy" in store.job_rows
    assert "ns/gappy" not in store.orphan_uids


# ---------------------------------------------------------------------
# the plugin memos across a re-sum boundary
# ---------------------------------------------------------------------

def _res(r):
    return (r.milli_cpu, r.memory, r.milli_gpu)


def test_proportion_and_drf_memos_match_reference(monkeypatch):
    """Nine cycles with the proportion re-sum period patched to 4 in both
    packages: the memoized queue rollups and drf attrs equal the
    reference's bit for bit at every open, through two re-sums."""
    monkeypatch.setattr(j_proportion, "_RESUM_PERIOD", 4)
    monkeypatch.setattr(t_proportion, "_RESUM_PERIOD", 4)
    spec = dataclasses.replace(T_SPECS[5], n_nodes=32, n_groups=24,
                               pods_per_group=4)
    sides = (SimSide(False, spec), SimSide(True, spec))
    opens = []
    for k in range(9):
        if k:
            for s in sides:
                s.kubelet_tick()
                s.sim.churn_tick(s.cache, 8, arrival_queue=k % 4)
                assert s.cache.drain(timeout=5.0)
        views = []
        for s in sides:
            ssn = s.open()
            prop, drf = ssn.plugins["proportion"], ssn.plugins["drf"]
            views.append((
                {q: (_res(a.allocated), _res(a.request), _res(a.deserved),
                     a.share) for q, a in prop.queue_opts.items()},
                list(prop.queue_opts),
                {u: (_res(a.allocated), a.share)
                 for u, a in drf.job_opts.items()},
                s.cache.plugin_scratch["proportion"]["opens"]))
            s.close(ssn)
        assert views[0] == views[1], f"cycle {k}"
        opens.append(views[1][3])
    assert opens == list(range(1, 10))


# ---------------------------------------------------------------------
# the dirty-row scatter's plain version against _scatter_rows
# ---------------------------------------------------------------------

@pytest.mark.parametrize("k,dups", [(1, 0), (37, 0), (300, 45), (64, 0)])
def test_scatter_rows_plain_matches_reference(k, dups):
    rng = np.random.default_rng(k + dups)
    n_pad = 64 if k <= 64 else 512
    base = [rng.uniform(0, 100, (n_pad, 3)).astype(np.float32)
            for _ in range(3)]
    base += [rng.uniform(0, 100, (n_pad, 2)).astype(np.float32)
             for _ in range(2)]
    base += [rng.integers(0, 110, n_pad).astype(np.int32) for _ in range(2)]
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
        # duplicate rows carry identical values (the reference pads its
        # block by repeating the first row)
        rep = rng.integers(0, n_unique, dups)
        idx = np.concatenate([idx, idx[rep]])
        rows = [np.concatenate([r, r[rep]]) for r in rows]
    want = jsolver._scatter_rows(*(jnp.asarray(a) for a in base),
                                 jnp.asarray(idx), *(jnp.asarray(r)
                                                     for r in rows))
    dst = tuple(torch.from_numpy(a.copy()) for a in base)
    block = tsolver.pack_scatter_rows(idx, *rows, n_pad=n_pad)
    tsolver.scatter_rows_plain(dst, torch.from_numpy(block))
    for w, g, name in zip(want, dst, ("idle", "releasing", "backfilled",
                                      "allocatable_cm", "nz_req", "n_tasks",
                                      "max_task_num", "node_ok")):
        assert_bitwise(np.asarray(w), g.numpy(), name)
    # the wrapper takes the plain version for CPU tensors
    dst2 = tuple(torch.from_numpy(a.copy()) for a in base)
    tsolver.scatter_rows(dst2, torch.from_numpy(block))
    for a, b in zip(dst, dst2):
        assert torch.equal(a, b)


def test_scatter_rows_rejects_rows_outside_the_arrays():
    with pytest.raises(ValueError, match="outside"):
        tsolver.pack_scatter_rows(
            np.array([0, 8], np.int32), np.zeros((2, 3)), np.zeros((2, 3)),
            np.zeros((2, 3)), np.zeros((2, 2)), np.zeros((2, 2)),
            np.zeros(2), np.zeros(2), np.zeros(2, bool), n_pad=8)
