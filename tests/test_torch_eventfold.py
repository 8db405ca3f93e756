"""The port's event fold against the reference package's, on the CPU.

Both packages' caches run incremental (the reference's default, and the
port's): every event folds into per-entity dirty marks, ``snapshot()``
patches the previous session's adopted clones, and ``snapshot_full()``
is the from-scratch oracle. For the same events on the same small
clusters:

- the port's folded snapshot equals its own ``snapshot_full()``
  (``debug.snapshot_diff`` is empty) after every event kind and every
  cycle;
- it equals the reference's snapshot entity by entity (jobs, tasks,
  nodes, queues, the refreshed-job set), and ``events_folded_total``
  moves per kind as the reference's does;
- the cases of tests/test_incremental_snapshot.py that the port's
  surface covers (no event-source thread, no sub-cycles, no fault
  seam), plus an audit divergence forced by hand, which must demote the
  fold to snapshot-primary.

Exact comparisons throughout (tolerance 0): both packages hold the same
float64 host values for the same events.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.actions.backfill import BackfillAction as JBackfill  # noqa: E402
from kubebatch_tpu.actions.preempt import PreemptAction as JPreempt  # noqa: E402
from kubebatch_tpu.actions.reclaim import ReclaimAction as JReclaim  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.actions.backfill import BackfillAction as TBackfill  # noqa: E402
from kubebatch_tpu_torch.actions.preempt import PreemptAction as TPreempt  # noqa: E402
from kubebatch_tpu_torch.actions.reclaim import ReclaimAction as TReclaim  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.cache.eventfold import EVENT_KINDS  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.debug import audit_cache, snapshot_diff  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels.solver import DeviceSession  # noqa: E402

GiB = 1024 ** 3

#: the device arrays of a DeviceSession, in scatter order
DEVICE_FIELDS = ("idle", "releasing", "backfilled", "allocatable_cm",
                 "nz_req", "n_tasks", "max_task_num", "node_ok")


class World:
    """Object builders bound to one package's objects module. Pod uids
    are ``ns-name`` in both packages, so task keys compare directly."""

    def __init__(self, mod):
        self.m = mod

    def rl(self, cpu_milli=0.0, mem_bytes=0.0, pods=0.0):
        return self.m.resource_list(cpu=cpu_milli, memory=mem_bytes,
                                    pods=pods)

    def node(self, name, cpu=4000, mem=8 * GiB, pods=16):
        alloc = self.rl(cpu, mem, pods)
        return self.m.Node(name=name, allocatable=dict(alloc),
                           capacity=dict(alloc))

    def pod(self, name, group, cpu, mem, priority=None, ts=0.0, ns="ns"):
        m = self.m
        return m.Pod(uid=f"{ns}-{name}", name=name, namespace=ns,
                     phase=m.PodPhase.PENDING,
                     containers=[m.Container(requests=self.rl(cpu, mem))],
                     annotations={m.GROUP_NAME_ANNOTATION: group},
                     priority=priority, creation_timestamp=ts)

    def group(self, name, min_member, queue, ts=0.0, max_member=0,
              priority_class="", ns="ns"):
        return self.m.PodGroup(name=name, namespace=ns,
                               min_member=min_member, max_member=max_member,
                               queue=queue, creation_timestamp=ts,
                               priority_class_name=priority_class)

    def queue(self, name, weight=1):
        return self.m.Queue(name=name, weight=weight)

    def priority_class(self, name, value):
        return self.m.PriorityClass(name=name, value=value)


J_WORLD, T_WORLD = World(j_objects), World(t_objects)


class StatusLog:
    """Status updater that records every PodGroup write."""

    def __init__(self):
        self.writes = []

    def update_pod_condition(self, pod, condition):
        pod.status_conditions.append(condition)

    def update_pod_group(self, pg):
        st = pg.status
        self.writes.append((pg.namespace, pg.name, st.phase.name,
                            st.running, st.failed, st.succeeded))
        return pg


class Kubelet:
    """Binder and evictor: records binds and evictions; ``tick`` starts
    bound pods and deletes evicted ones through cache events, as a
    kubelet and the API server would."""

    def __init__(self):
        self.binds = {}
        self.evicted = []
        self.bound_pods = []
        self.evicted_pods = []

    def bind(self, pod, hostname):
        self.binds[f"{pod.namespace}/{pod.name}"] = hostname
        pod.node_name = hostname
        self.bound_pods.append(pod)

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        self.evicted.append(f"{pod.namespace}/{pod.name}")
        self.evicted_pods.append(pod)

    def tick(self, cache):
        for pod in self.bound_pods:
            if pod.phase.name != "RUNNING":
                pod.phase = type(pod.phase).RUNNING
                cache.update_pod(pod, pod)
        self.bound_pods = []
        for pod in self.evicted_pods:
            cache.delete_pod(pod)
            pod.phase = type(pod.phase).SUCCEEDED     # gone
        self.evicted_pods = []


class Side:
    """One package's incremental cache with its kubelet and status log;
    ``objs`` keeps the objects each event was built from."""

    def __init__(self, torch_side: bool, incremental: bool = True):
        self.torch_side = torch_side
        self.w = T_WORLD if torch_side else J_WORLD
        self.kubelet = Kubelet()
        self.status = StatusLog()
        kw = dict(binder=self.kubelet, evictor=self.kubelet,
                  status_updater=self.status, async_writeback=False,
                  incremental_snapshot=incremental)
        self.cache = TCache(device="cpu", **kw) if torch_side \
            else JCache(**kw)
        self.objs = {}
        self.m = t_metrics if torch_side else j_metrics

    def open(self, snapshot=None):
        tiers = t_tiers() if self.torch_side else j_tiers()
        return (TOpen if self.torch_side else JOpen)(
            self.cache, tiers, snapshot=snapshot)

    def close(self, ssn):
        (TClose if self.torch_side else JClose)(ssn)
        assert self.cache.drain(timeout=5.0)


class Twin:
    """The same events into a reference cache and a port cache."""

    def __init__(self, n_nodes=4, incremental=True):
        self.j = Side(False, incremental)
        self.t = Side(True, incremental)
        self.sides = (self.j, self.t)
        self.apply(lambda s, w: [s.cache.add_queue(w.queue("q1", 1)),
                                 s.cache.add_queue(w.queue("q2", 3))])
        for n in range(n_nodes):
            self.add_node(f"n{n:02d}")

    def apply(self, fn):
        for s in self.sides:
            fn(s, s.w)

    def add_node(self, name, **kw):
        def go(s, w):
            s.objs[name] = w.node(name, **kw)
            s.cache.add_node(s.objs[name])
        self.apply(go)

    def add_gang(self, name, size, min_member, queue, cpu=500, mem=GiB,
                 priority=None, ts=0.0, **kw):
        def go(s, w):
            pg = s.objs[name] = w.group(name, min_member, queue, ts=ts, **kw)
            s.cache.add_pod_group(pg)
            for p in range(size):
                pod = s.objs[f"{name}-{p}"] = w.pod(
                    f"{name}-{p}", name, cpu, mem, priority=priority,
                    ts=ts * 100 + p)
                s.cache.add_pod(pod)
        self.apply(go)

    def tick(self):
        for s in self.sides:
            s.kubelet.tick(s.cache)
            assert s.cache.drain(timeout=5.0)


# ---------------------------------------------------------------------
# cross-package snapshot comparison
# ---------------------------------------------------------------------

def _res(r):
    return (r.milli_cpu, r.memory, r.milli_gpu, r.max_task_num)


def _job_view(job):
    return (job.queue, job.priority, job.min_available, job.max_available,
            job.creation_timestamp, _res(job.allocated),
            _res(job.total_request), job.pod_group is None,
            {uid: (t.status.name, t.node_name, t.is_backfill, _res(t.resreq))
             for uid, t in job.tasks.items()},
            {st.name: sorted(b) for st, b in job.task_status_index.items()
             if b},
            sorted(job.nodes_fit_delta))


def _node_view(node):
    return (tuple(_res(getattr(node, f)) for f in (
        "idle", "used", "releasing", "backfilled", "allocatable",
        "capability")),
        {k: (t.status.name, t.node_name) for k, t in node.tasks.items()})


def assert_snapshots_match(js, ts, what=""):
    """The port's snapshot equals the reference's entity by entity."""
    assert sorted(js.queues) == sorted(ts.queues), what
    for q in js.queues:
        assert (js.queues[q].name, js.queues[q].weight) == \
            (ts.queues[q].name, ts.queues[q].weight), (what, q)
    assert sorted(js.nodes) == sorted(ts.nodes), what
    for n in js.nodes:
        assert _node_view(js.nodes[n]) == _node_view(ts.nodes[n]), (what, n)
    assert list(js.jobs) == list(ts.jobs), what
    for uid in js.jobs:
        assert _job_view(js.jobs[uid]) == _job_view(ts.jobs[uid]), \
            (what, uid)
    assert js.refreshed_jobs == ts.refreshed_jobs, what
    assert js.jobs_excluded == ts.jobs_excluded, what


def audited_pair(twin, what):
    """Both caches' audited snapshots: the port's fold equals its full
    clone and the reference's snapshot."""
    (js, jd), (ts, td) = (s.cache.audited_snapshot() for s in twin.sides)
    assert not jd, (what, jd[:4])
    assert not td, (what, td[:4])
    assert_snapshots_match(js, ts, what)
    return js, ts


def _adopt_base(twin):
    """Open and close an empty session so the next event folds against
    an adopted base (the folded patch path, not the full-clone one)."""
    for s in twin.sides:
        s.close(s.open())


# ---------------------------------------------------------------------
# every event kind: fold == full == reference, counted per kind
# ---------------------------------------------------------------------

def _event_script(twin):
    """(kind, event) pairs covering EVENT_KINDS, in the reference test's
    order (tests/test_incremental_snapshot.py fold-vs-replay)."""
    def on_both(fn):
        return lambda: twin.apply(fn)

    def task(s, name):
        with s.cache._lock:
            return s.cache.jobs["ns/g0"].tasks[f"ns-{name}"]

    def pod_running(s, w):
        pod = s.objs["g0-0"]
        pod.phase = w.m.PodPhase.RUNNING
        pod.node_name = "n00"
        s.cache.update_pod(pod, pod)

    def node_update(s, w):
        s.objs["n99b"] = w.node("n99", cpu=8000, mem=16 * GiB, pods=32)
        s.cache.update_node(s.objs["n99"], s.objs["n99b"])

    def resync(s, w):
        pod = s.objs["g9-0"] = w.pod("g9-0", "g9", 500, GiB)
        s.cache.add_pod_group(w.group("g9", 1, "q1"))
        s.cache.add_pod(pod)
        s.cache.sync_task(task_of(s, "g9", "g9-0"))

    def task_of(s, group, name):
        with s.cache._lock:
            return s.cache.jobs[f"ns/{group}"].tasks[f"ns-{name}"]

    def podgroup_update(s, w):
        s.objs["g0b"] = w.group("g0", 1, "q2")
        s.cache.update_pod_group(s.objs["g0"], s.objs["g0b"])

    return [
        ("podgroup.add", on_both(lambda s, w: s.cache.add_pod_group(
            s.objs.setdefault("g0", w.group("g0", 1, "q1"))))),
        ("pod.add", on_both(lambda s, w: s.cache.add_pod(
            s.objs.setdefault("g0-0", w.pod("g0-0", "g0", 500, GiB,
                                            priority=3))))),
        ("podgroup.update", on_both(podgroup_update)),
        ("bind", on_both(lambda s, w: s.cache.bind(task(s, "g0-0"),
                                                   "n00"))),
        ("pod.update", on_both(pod_running)),
        ("evict", on_both(lambda s, w: s.cache.evict(task(s, "g0-0"),
                                                     "test eviction"))),
        ("pod.delete", on_both(lambda s, w: s.cache.delete_pod(
            s.objs["g0-0"]))),
        ("podgroup.delete", on_both(lambda s, w: s.cache.delete_pod_group(
            s.objs["g0b"]))),
        ("node.add", on_both(lambda s, w: s.cache.add_node(
            s.objs.setdefault("n99", w.node("n99"))))),
        ("node.update", on_both(node_update)),
        ("node.delete", on_both(lambda s, w: s.cache.delete_node(
            s.objs["n99b"]))),
        ("resync", on_both(resync)),
        ("invalidate", on_both(lambda s, w: s.cache.add_queue(
            w.queue("q9")))),
    ]


def test_event_script_covers_every_kind():
    assert sorted(k for k, _ in _event_script(Twin())) \
        == sorted(EVENT_KINDS)


@pytest.mark.parametrize("kind", EVENT_KINDS)
def test_fold_equals_full_and_reference_per_event_kind(kind):
    twin = Twin(n_nodes=3)
    _adopt_base(twin)
    for k, event in _event_script(twin):
        before = [s.m.events_folded_total() for s in twin.sides]
        event()
        after = [s.m.events_folded_total() for s in twin.sides]
        deltas = [{n: a.get(n, 0) - b.get(n, 0) for n in a
                   if a.get(n, 0) != b.get(n, 0)}
                  for a, b in zip(after, before)]
        assert deltas[0] == deltas[1], (k, deltas)
        assert deltas[1].get(k, 0) >= 1, (k, deltas[1])
        audited_pair(twin, k)
        _adopt_base(twin)
        if k == kind:
            break


# ---------------------------------------------------------------------
# multi-cycle churn (tests/test_incremental_snapshot.py cases)
# ---------------------------------------------------------------------

def churn(twin, rng, cycle, next_group):
    """A couple of gangs arrive; sometimes a running pod finishes."""
    for _ in range(int(rng.integers(1, 3))):
        g = f"g{next_group:03d}"
        size = int(rng.integers(1, 4))
        twin.add_gang(g, size, max(1, size - 1),
                      f"q{next_group % 2 + 1}",
                      cpu=int(rng.integers(1, 4)) * 500,
                      mem=int(rng.integers(1, 3)) * GiB,
                      priority=int(rng.integers(1, 5)), ts=float(cycle))
        next_group += 1
    if rng.random() < 0.5:
        names = [n for n, o in twin.t.objs.items()
                 if getattr(o, "phase", None) is not None
                 and o.phase.name == "RUNNING"]
        if names:
            twin.apply(lambda s, w: s.cache.delete_pod(
                s.objs.pop(names[0])))
    return next_group


def four_actions(torch_side, engine):
    if torch_side:
        return [TReclaim(), TAllocate(mode=engine), TBackfill(), TPreempt()]
    return [JReclaim(), JAllocate(mode=engine), JBackfill(), JPreempt()]


def run_cycle(twin, engine, audit=True, actions=four_actions):
    """One cycle on both caches from their audited (or plain) snapshots:
    the port first, then the reference with the engine the port ran.
    Returns the per-side (binds, evictions, status writes) of the
    cycle."""
    out = []
    for s in (twin.t, twin.j):
        n_b, n_e, n_w = (len(s.kubelet.binds), len(s.kubelet.evicted),
                         len(s.status.writes))
        snap = None
        if audit:
            snap, diff = s.cache.audited_snapshot()
            assert not diff, diff[:4]
        ssn = s.open(snapshot=snap)
        eng = engine
        if not s.torch_side and engine == "auto":
            eng = t_allocate_mod.last_cycle_engine
            eng = "fused" if eng in (None, "host-visit") else eng
        for act in actions(s.torch_side, eng):
            act.execute(ssn)
        s.close(ssn)
        out.append((list(s.kubelet.binds.items())[n_b:],
                    s.kubelet.evicted[n_e:], s.status.writes[n_w:]))
    assert out[0] == out[1], "port and reference decide differently"
    assert not audit_cache(twin.t.cache)
    return out[0]


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_churn_cycles_fold_equals_full_and_reference(engine):
    rng = np.random.default_rng(11)
    twin = Twin(n_nodes=10)
    next_group = 0
    binds = 0
    for cycle in range(8):
        next_group = churn(twin, rng, cycle, next_group)
        b, _, _ = run_cycle(twin, engine)
        binds += len(b)
        twin.tick()
    assert binds, "churn must schedule work"
    assert not snapshot_diff(twin.t.cache.snapshot(),
                             twin.t.cache.snapshot_full())


def test_unready_gang_and_fit_failures_stay_consistent():
    """A gang too big to fit leaves session tasks ALLOCATED but not
    dispatched and records nodes_fit_delta; the touched tracking must
    re-clone both away."""
    twin = Twin(n_nodes=2)
    twin.add_gang("big", 6, 6, "q1", cpu=2000)
    for engine in ("fused", "fused", "host"):
        b, _, _ = run_cycle(twin, engine)
        assert not b
    assert not twin.t.kubelet.binds


def test_priority_class_change_invalidates_base():
    twin = Twin(n_nodes=2)
    twin.add_gang("g0", 1, 1, "q1", priority_class="gold")
    run_cycle(twin, "fused")
    twin.apply(lambda s, w: s.cache.add_priority_class(
        w.priority_class("gold", 7777)))
    js, ts = audited_pair(twin, "priority class")
    assert ts.jobs["ns/g0"].priority == 7777
    assert ts.refreshed_jobs is None        # the invalidation forced full


def test_mid_session_invalidation_refuses_adoption():
    twin = Twin(n_nodes=2)
    twin.add_gang("g0", 1, 1, "q1", priority_class="gold")
    run_cycle(twin, "fused")
    for s in twin.sides:
        ssn = s.open()
        # a cluster-wide event lands while the session is open
        s.cache.add_priority_class(s.w.priority_class("gold", 4242))
        acts = four_actions(s.torch_side, "fused")
        acts[1].execute(ssn)
        s.close(ssn)     # adoption must be refused (epoch mismatch)
    t = twin.t.cache
    assert t.fold.base is None and t._dev_state is None
    assert t.victim_segments is None
    js, ts = audited_pair(twin, "mid-session invalidation")
    assert ts.jobs["ns/g0"].priority == 4242


def test_device_session_row_reuse_matches_fresh_build():
    """cache.device_session hands back the previous cycle's arrays with
    the dirty rows re-packed (the scatter's plain version on the CPU):
    bit-identical to a fresh DeviceSession of the same snapshot."""
    rng = np.random.default_rng(3)
    twin = Twin(n_nodes=10)
    cache = twin.t.cache
    next_group = 0
    reused_cycles = 0
    for cycle in range(6):
        next_group = churn(twin, rng, cycle, next_group)
        ssn = twin.t.open()
        adopted = cache._dev_state
        reused = cache.device_session(ssn)
        reused_cycles += reused is adopted and adopted is not None
        fresh = DeviceSession(ssn.nodes, min_bucket=reused.n_padded,
                              device="cpu")
        for fld in DEVICE_FIELDS:
            a, b = getattr(reused, fld), getattr(fresh, fld)
            assert a.dtype == b.dtype and a.shape == b.shape, fld
            assert bool((a == b).all()), f"cycle {cycle} field {fld}"
        assert reused.state.names == fresh.state.names
        ssn.device_snapshot = reused
        for act in four_actions(True, "auto"):
            act.execute(ssn)
        twin.t.close(ssn)
        twin.t.kubelet.tick(cache)
    assert reused_cycles >= 4
    assert twin.t.kubelet.binds


def test_snapshot_primary_schedules_like_the_fold():
    """incremental_snapshot=False (full clones every cycle) decides as
    the fold does: the same binds, evictions and final PodGroup phases
    (status writes differ by design: the fold skips untouched settled
    jobs)."""
    results = []
    for incremental in (True, False):
        rng = np.random.default_rng(2)
        twin = Twin(n_nodes=10, incremental=incremental)
        assert twin.t.cache._incremental is incremental
        next_group = 0
        for cycle in range(5):
            next_group = churn(twin, rng, cycle, next_group)
            run_cycle(twin, "auto", audit=False)
            twin.tick()
        t = twin.t
        phases = {n: o.status.phase.name for n, o in t.objs.items()
                  if hasattr(o, "min_member")}
        results.append((dict(t.kubelet.binds), list(t.kubelet.evicted),
                        phases))
    assert results[0] == results[1]


def test_soak_cycles_audit_green():
    """Ten churn cycles of allocate + backfill, each opening from the
    audited snapshot; the fold stays engaged and counts its events."""
    rng = np.random.default_rng(23)
    twin = Twin(n_nodes=8)
    folded0 = sum(t_metrics.events_folded_total().values())
    demoted0 = sum(t_metrics.fold_demotions_total().values())

    def alloc_backfill(torch_side, engine):
        return ([TAllocate(mode=engine), TBackfill()] if torch_side
                else [JAllocate(mode=engine), JBackfill()])

    next_group = 0
    for cycle in range(10):
        next_group = churn(twin, rng, cycle, next_group)
        run_cycle(twin, "auto", actions=alloc_backfill)
        twin.tick()
    assert twin.t.kubelet.binds
    assert twin.t.cache._incremental
    assert sum(t_metrics.events_folded_total().values()) > folded0
    assert sum(t_metrics.fold_demotions_total().values()) == demoted0


def test_min_member_update_dirties_job_rows():
    """An elastic resize lands as a podgroup UPDATE changing min_member;
    the fold must re-clone the job (a stale min_available would keep the
    gang barrier at the old quorum)."""
    twin = Twin(n_nodes=2)
    twin.add_gang("g0", 2, 3, "q1", max_member=3)
    b, _, _ = run_cycle(twin, "fused")
    assert not b

    def resize(s, w):
        new = w.group("g0", 2, "q1", max_member=3)
        s.cache.update_pod_group(s.objs["g0"], new)
    twin.apply(resize)
    js, ts = audited_pair(twin, "min_member update")
    assert ts.jobs["ns/g0"].min_available == 2
    b, _, _ = run_cycle(twin, "fused")
    assert len(b) == 2


def test_gc_deleted_job_vanishes_from_folded_snapshot():
    """The deleted-jobs GC pops from cache truth outside the handler
    surface; the folded snapshot must still patch the deletion out."""
    twin = Twin(n_nodes=2)
    twin.add_gang("keep", 1, 1, "q1")
    twin.add_gang("gone", 1, 1, "q1")
    _adopt_base(twin)

    def gone(s, w):
        s.cache.delete_pod(s.objs["gone-0"])
        s.cache.delete_pod_group(s.objs["gone"])
        assert s.cache.drain(timeout=5.0)
        assert "ns/gone" not in s.cache.jobs
    twin.apply(gone)
    js, ts = audited_pair(twin, "gc")
    assert "ns/gone" not in ts.jobs and "ns/keep" in ts.jobs


def test_forced_audit_divergence_demotes():
    """A base clone corrupted by hand: the audit finds the divergence,
    demotes the fold to snapshot-primary (counted), and hands back the
    full clone; later snapshots are full clones."""
    twin = Twin(n_nodes=2)
    twin.add_gang("g0", 1, 1, "q1")
    run_cycle(twin, "fused")
    twin.tick()
    run_cycle(twin, "fused")        # g0 settles: its clone is reused
    cache = twin.t.cache
    demoted0 = t_metrics.fold_demotions_total().get("audit", 0)
    base_jobs, _ = cache.fold.base
    base_jobs["ns/g0"].priority += 1
    snap, diffs = cache.audited_snapshot()
    assert diffs and any("ns/g0" in d for d in diffs)
    assert not cache._incremental
    assert t_metrics.fold_demotions_total()["audit"] == demoted0 + 1
    assert snap.refreshed_jobs is None
    assert not snapshot_diff(snap, cache.snapshot_full())
    folded0 = t_metrics.events_folded_total()
    twin.t.cache.add_node(T_WORLD.node("n50"))
    assert t_metrics.events_folded_total() == folded0   # no longer folds
    assert cache.snapshot().refreshed_jobs is None
