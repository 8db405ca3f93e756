"""The port's scheduler loop against the reference's.

Both packages drive the same cluster (each built from one ClusterSpec by
its own sim) through their ``Scheduler``: guarded periods of the shipped
policy, a fault-driven walk down and back up the degradation ladder, a
deadline overrun, and latency-lane arrivals placed by the
schedule-on-arrival sub-cycle. Every period's task statuses and binds,
every ladder level, and the ``cycle_failures_total`` and
``engine_demotions_total`` moves must be the reference's. The
reference's KUBEBATCH_* settings are cleared; the port takes the same
choices as arguments. Both ladders get the same stub recovery probe and
a zero cooldown; ``faults.reset()`` runs on both sides around each test.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import time  # noqa: E402

import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401
import kubebatch_tpu.plugins  # noqa: E402,F401
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu import obs as j_obs  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.obs.ledger import LANE_ANNOTATION as J_LANE  # noqa: E402
from kubebatch_tpu.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import obs as t_obs  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.runtime import Scheduler as TScheduler  # noqa: E402
from kubebatch_tpu_torch.runtime import subcycle as t_subcycle  # noqa: E402
from kubebatch_tpu_torch.runtime import watchdog  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

GiB = 1024 ** 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED_CONF = open(os.path.join(REPO, "config",
                                 "kube-batch-conf.yaml")).read()

#: the reference reads these at construction or every cycle
_SETTINGS = ("KUBEBATCH_SOLVER", "KUBEBATCH_CYCLE_DEADLINE",
             "KUBEBATCH_AUDIT_EVERY", "KUBEBATCH_SUBCYCLE",
             "KUBEBATCH_PIPELINE", "KUBEBATCH_SLO", "KUBEBATCH_TIMELINE_DIR",
             "KUBEBATCH_FAULTS", "KUBEBATCH_NO_BACKEND_PROBE",
             "KUBEBATCH_VICTIM_SOLVER", "KUBEBATCH_RESERVED_BACKFILL")


class Recorder:
    """Binder and evictor: binds flip the pod's node_name; both record."""

    def __init__(self):
        self.binds = []
        self.evicted = []

    def bind(self, pod, hostname):
        self.binds.append((f"{pod.namespace}/{pod.name}", hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        self.evicted.append(f"{pod.namespace}/{pod.name}")
        pod.deletion_timestamp = 1.0


class Side:
    """One package's cluster (cfg2 by default), incremental cache and
    scheduler."""

    def __init__(self, torch_side: bool, config=2, **kw):
        self.torch_side = torch_side
        self.rec = Recorder()
        self.m = t_objects if torch_side else j_objects
        if torch_side:
            self.sim = t_build(T_SPECS[config])
            self.cache = TCache(binder=self.rec, evictor=self.rec,
                                async_writeback=False, device="cpu")
            self.sched = TScheduler(self.cache, SHIPPED_CONF, **kw)
            # every port Scheduler installs its own probe: the stub
            # goes in after it
            t_faults.LADDER.probe = lambda: True
        else:
            self.sim = j_build(J_SPECS[config])
            self.cache = JCache(binder=self.rec, evictor=self.rec,
                                async_writeback=False)
            self.sched = JScheduler(self.cache, SHIPPED_CONF, **kw)
        self.sim.populate(self.cache)
        self.faults = t_faults if torch_side else j_faults
        self.metrics = t_metrics if torch_side else j_metrics

    def kubelet_tick(self):
        for pod in list(self.sim.pods):
            if pod.node_name and pod.phase.name != "RUNNING":
                pod.phase = type(pod.phase).RUNNING
                self.cache.update_pod(pod, pod)

    def states(self):
        """(status, node) per task by name (the two sims draw uids from
        process-wide counters)."""
        return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
                for j in self.cache.jobs.values() for t in j.tasks.values()}

    def counters(self):
        return (self.metrics.cycle_failures_total(),
                self.metrics.engine_demotions_total())


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for name in _SETTINGS:
        monkeypatch.delenv(name, raising=False)
    for mod in (t_faults, j_faults):
        mod.reset()
        monkeypatch.setattr(mod.LADDER, "probe", lambda: True)
        monkeypatch.setattr(mod.LADDER, "policy",
                            mod.BackoffPolicy(cooldown=0.0))
    yield
    for mod in (t_faults, j_faults):
        mod.reset()


def _settle(*ladders):
    """Wait until no ladder has a recovery probe in flight."""
    for _ in range(500):
        if not any(lad._probe_running for lad in ladders):
            return
        time.sleep(0.01)
    raise AssertionError("a recovery probe never answered")


def test_shipped_conf_periods_match_reference():
    """Four guarded periods of the shipped policy on cfg2 (cold, then
    churn), the kubelet tick between them: every period healthy, the
    statuses, binds and evictions the reference's."""
    j, t = Side(False), Side(True)
    for period in range(4):
        for s in (j, t):
            assert s.sched.run_cycle() is True
            s.kubelet_tick()
            s.sim.churn_tick(s.cache, 16)
        assert t.rec.binds == j.rec.binds, period
        assert t.rec.evicted == j.rec.evicted, period
        assert t.states() == j.states(), period
    assert t.rec.binds
    assert t.sched.last_cycle_failure is None
    assert t_faults.LADDER.level == 0


def test_fault_plan_walks_the_ladder_like_reference():
    """The same fail-first-4 plan at device.dispatch on both sides: two
    failed cycles demote a level, two more demote again, the healthy
    cycles after the plan runs dry climb back through the stub probe.
    Per cycle the result, the ladder level and the failure / demotion
    counter moves are the reference's, and so are the decisions."""
    sides = [Side(False), Side(True)]
    for s in sides:
        s.faults.arm(s.faults.FaultPlan(counts={"device.dispatch": 4}))
    trace = {False: [], True: []}
    for _ in range(12):
        for s in sides:
            c0 = s.counters()
            ok = s.sched.run_cycle()
            _settle(s.faults.LADDER)
            c1 = s.counters()
            trace[s.torch_side].append(
                (ok, s.faults.LADDER.level, c1[0] - c0[0], c1[1] - c0[1],
                 s.sched.last_cycle_failure))
            s.kubelet_tick()
    assert trace[True] == trace[False]
    levels = [lvl for _, lvl, _, _, _ in trace[True]]
    assert max(levels) == 2 and levels[-1] == 0
    assert [ok for ok, *_ in trace[True]][:4] == [False] * 4
    assert t_metrics.fault_injected_total().get("device.dispatch", 0) >= 4
    j, t = sides
    assert t.rec.binds == j.rec.binds and t.rec.binds
    assert t.states() == j.states()


MODES = ("auto", "rpc", "sharded", "hier", "activeset", "batched", "native",
         "fused", "jax", "host", "unknown")


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_cap_engine_matches_reference(level):
    """cap_engine over every mode at every level: the same engine and
    the same demotion count."""
    for mode in MODES:
        got = []
        for mod, met in ((j_faults, j_metrics), (t_faults, t_metrics)):
            lad = mod.DegradationLadder()
            lad.level = level
            d0 = met.engine_demotions_total()
            got.append((lad.cap_engine(mode),
                        met.engine_demotions_total() - d0))
        assert got[0] == got[1], (mode, level)


def _failing_walk(sched, ladder, monkeypatch, cycles=8):
    """Ladder levels over ``cycles`` cycles whose run_once raises."""
    def boom():
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(sched, "run_once", boom)
    levels = []
    for _ in range(cycles):
        assert sched.run_cycle() is False
        levels.append(ladder.level)
    return levels


def test_ladder_over_a_card_cache_stops_at_fused(monkeypatch):
    """The port keeps the card's work on the card: over a CUDA cache the
    failing cycles stop the ladder at level 2 ("fused"), where a CPU
    cache walks on to level 3 ("host") as the reference does; at a
    deeper level a card cycle's cap is level 2's and never the host
    loops unless the host engine was asked for."""
    walks = {}
    for side in ("reference", "cpu", "cuda"):
        for mod in (t_faults, j_faults):
            mod.LADDER.reset()
        if side == "reference":
            sched = JScheduler(JCache(async_writeback=False))
            ladder = j_faults.LADDER
        else:
            cache = TCache(async_writeback=False, device="cpu")
            sched = TScheduler(cache)
            cache.device = torch.device(side)   # no cycle reaches it
            ladder = t_faults.LADDER
        walks[side] = _failing_walk(sched, ladder, monkeypatch)
    assert walks == {"reference": [0, 1, 1, 2, 2, 3, 3, 3],
                     "cpu": [0, 1, 1, 2, 2, 3, 3, 3],
                     "cuda": [0, 1, 1, 2, 2, 2, 2, 2]}
    deep, at2 = t_faults.DegradationLadder(), t_faults.DegradationLadder()
    deep.level, at2.level = 3, 2
    for mode in MODES:
        d0 = t_metrics.engine_demotions_total()
        card = deep.cap_engine(mode, on_card=True)
        d1 = t_metrics.engine_demotions_total()
        assert (card, d1 - d0) == (at2.cap_engine(mode),
                                   t_metrics.engine_demotions_total() - d1)
        assert card != "host" or mode == "host"
    assert deep.cap_engine("batched") == "host"     # a CPU cache's cap


def test_each_scheduler_installs_its_own_probe(monkeypatch):
    """The newest Scheduler's cache decides what the recovery probe
    touches: a CPU loop built first leaves no probe behind for a card
    loop built after it, and faults.reset() clears probe and policy."""
    from kubebatch_tpu_torch.runtime import watchdog as wd

    asked = []
    monkeypatch.setattr(wd, "midrun_probe", lambda device="cuda", **kw:
                        asked.append(torch.device(device).type) or True)
    cpu_sched = TScheduler(TCache(async_writeback=False, device="cpu"))
    assert t_faults.LADDER.probe == cpu_sched._recovery_probe
    card = TCache(async_writeback=False, device="cpu")
    card.device = torch.device("cuda")
    card_sched = TScheduler(card)
    assert t_faults.LADDER.probe == card_sched._recovery_probe
    assert t_faults.LADDER.probe() is True and asked == ["cuda"]
    t_faults.LADDER.policy = t_faults.BackoffPolicy(cooldown=1.0)
    t_faults.reset()
    assert (t_faults.LADDER.probe, t_faults.LADDER.policy) == (None, None)


def test_fault_spec_and_seeded_schedule_match_reference():
    """parse_fault_spec and a plan's seeded rate schedule fire at the
    same crossings as the reference's (exact, family and wildcard rates,
    a fail-first-N count, a bare seam); check raises FaultInjected and
    check_raise the caller's type there; active_plan is the armed plan;
    fault_injected_total moves alike."""
    spec = ("device.dispatch:0.5, cache.evict:n3, cache.*:0.25, *:0.1, "
            "obs.span")
    seams = ["device.dispatch", "cache.bind", "cache.evict", "obs.span",
             "source.watch", "cache.fold"] * 40
    runs = []
    for mod, met in ((j_faults, j_metrics), (t_faults, t_metrics)):
        plan = mod.parse_fault_spec(spec, seed=7)
        f0 = dict(met.fault_injected_total())
        assert mod.arm(plan) is plan and mod.active_plan() is plan
        fired = []
        for k, seam in enumerate(seams):
            try:
                if k % 2:
                    mod.check(seam)
                else:
                    mod.check_raise(seam, KeyError)
                fired.append(None)
            except mod.FaultInjected:
                fired.append("injected")
            except KeyError:
                fired.append("typed")
        mod.disarm()
        assert mod.active_plan() is None and not mod.armed()
        moved = {k: v - f0.get(k, 0)
                 for k, v in met.fault_injected_total().items()
                 if v != f0.get(k, 0)}
        runs.append((plan.rates, plan.counts, plan.seed, plan.injected,
                     fired, moved))
    assert runs[0] == runs[1]
    assert runs[1][3]["cache.evict"] == 3 and runs[1][3]["obs.span"] == 40
    assert "injected" in runs[1][4] and "typed" in runs[1][4]


def test_demotion_hooks_match_reference(monkeypatch):
    """on_ladder_demotion observers hear each demotion's new level, once
    per registration, and a raising observer never fails the cycle."""
    heard = {}
    for mod in (j_faults, t_faults):
        monkeypatch.setattr(mod, "_DEMOTION_HOOKS", [])
        got = heard[mod is t_faults] = []

        def bad(level):
            raise ValueError(level)

        mod.on_ladder_demotion(got.append)
        mod.on_ladder_demotion(got.append)
        mod.on_ladder_demotion(bad)
        lad = mod.DegradationLadder()
        for _ in range(8):
            lad.record_failure()
    assert heard[True] == heard[False] == [1, 2, 3]


@pytest.mark.parametrize("retain", [True, False])
def test_span_retention_switch_matches_reference(retain):
    """set_enabled: with retention on, a cycle root keeps its session /
    action tree and current_cycle names it inside; off, no tree is kept
    and no root is current — either way the root becomes last_cycle and
    the e2e / action views fire — as the reference's tracer does."""
    out = []
    for obs_mod, met in ((j_obs, j_metrics), (t_obs, t_metrics)):
        obs_mod.set_enabled(retain)
        try:
            assert obs_mod.current_cycle() is None
            root = obs_mod.begin_cycle(3)
            with obs_mod.span("session", cat="e2e"):
                with obs_mod.span("allocate", cat="action"):
                    cur = obs_mod.current_cycle()
            obs_mod.end_cycle(root)
        finally:
            obs_mod.set_enabled(True)
        out.append((obs_mod.enabled(), cur is root, root.args["cycle"],
                    [c.name for c in root.children],
                    root.find("allocate") is not None,
                    obs_mod.last_cycle() is root,
                    obs_mod.current_cycle() is None))
    assert out[0] == out[1]
    assert out[1][1] is retain and out[1][4] is retain


def test_repromotion_waits_for_the_probe_and_deadline_counts():
    """Cycles over their deadline are counted failures and demote; with
    the deadline lifted, a probe that first refuses then answers decides
    when the ladder climbs back — identically on both sides."""
    answers = {False: [False, True], True: [False, True]}
    sides = [Side(False, cycle_deadline=1e-9), Side(True, cycle_deadline=1e-9)]
    for s in sides:
        s.faults.LADDER.probe = (lambda a=answers[s.torch_side]: a.pop(0))
    trace = {False: [], True: []}
    for k in range(10):
        for s in sides:
            if k == 2:
                s.sched.cycle_deadline = None
            f0 = s.metrics.cycle_failures_by_reason().get("deadline", 0)
            ok = s.sched.run_cycle()
            _settle(s.faults.LADDER)
            trace[s.torch_side].append(
                (ok, s.faults.LADDER.level,
                 s.metrics.cycle_failures_by_reason().get("deadline", 0)
                 - f0))
            s.kubelet_tick()
    assert trace[True] == trace[False]
    assert trace[True][:2] == [(False, 0, 1), (False, 1, 1)]
    assert trace[True][-1][1] == 0
    assert answers == {False: [], True: []}


def _latency_pods(m, lane, n_lone=2, gang=4):
    """Latency-lane pods: ``n_lone`` single-pod gangs, then one gang of
    ``gang`` pods, all in queue q1; returns (pod groups, pods)."""
    groups, pods = [], []
    req = m.resource_list(cpu=500, memory=GiB)
    for i in range(n_lone):
        groups.append(m.PodGroup(name=f"lat-{i}", namespace="sim",
                                 min_member=1, queue="q1"))
        pods.append(m.Pod(uid=f"sim-lat-{i}", name=f"lat-{i}", namespace="sim",
                          containers=[m.Container(requests=dict(req))],
                          annotations={m.GROUP_NAME_ANNOTATION: f"lat-{i}",
                                       lane: "latency"},
                          creation_timestamp=2e9 + i))
    groups.append(m.PodGroup(name="lat-g", namespace="sim",
                             min_member=gang, queue="q1"))
    for p in range(gang):
        pods.append(m.Pod(uid=f"sim-lat-g-{p}", name=f"lat-g-{p}",
                          namespace="sim",
                          containers=[m.Container(requests=dict(req))],
                          annotations={m.GROUP_NAME_ANNOTATION: "lat-g",
                                       lane: "latency"},
                          creation_timestamp=2e9 + 100 + p))
    return groups, pods


def test_latency_lane_arrivals_match_reference():
    """On a steady state of the tenant-sized cluster (room left after
    the cold cycle), latency-lane pods arrive one by one: each
    lone pod is placed by its own sub-cycle (one visit), the gang's
    members wait for the last one and are then placed together — the
    reference's decisions, binds and counters; the next full cycle
    re-places none of them."""
    sides = [Side(False, "t", subcycle=True), Side(True, "t", subcycle=True)]
    for s in sides:
        assert s.sched.run_cycle() is True
        s.kubelet_tick()
    n_bind = {s.torch_side: len(s.rec.binds) for s in sides}
    trace = {False: [], True: []}
    for s in sides:
        lane = t_subcycle.LANE_ANNOTATION if s.torch_side else J_LANE
        groups, pods = _latency_pods(s.m, lane)
        sub0 = s.metrics.subcycles_total()
        arr0 = s.metrics.arrivals_observed_total()
        for g in groups:
            s.cache.add_pod_group(g)
        for pod in pods:
            s.cache.add_pod(pod)
            trace[s.torch_side].append(
                (pod.name, s.metrics.subcycles_total() - sub0,
                 s.metrics.arrivals_observed_total() - arr0,
                 s.rec.binds[n_bind[s.torch_side]:]))
    assert trace[True] == trace[False]
    j, t = sides
    lat = [b for b in t.rec.binds[n_bind[True]:] if "/lat-" in b[0]]
    assert len(lat) == 6 and t.metrics.subcycles_total() > 0
    for s in sides:
        s.kubelet_tick()
        n = len(s.rec.binds)
        assert s.sched.run_cycle() is True
        assert not [b for b in s.rec.binds[n:] if "/lat-" in b[0]]
    assert t.rec.binds == j.rec.binds
    assert t.states() == j.states()


def test_unported_options_raise():
    cache = TCache(async_writeback=False, device="cpu")
    for mode, item in (("rpc", "A8"), ("native", "A7")):
        with pytest.raises(NotImplementedError, match=item):
            TAllocate(mode=mode)
        with pytest.raises(NotImplementedError, match=item):
            TScheduler(cache, solver=mode)
    # the sharded engines are ported (tests/test_torch_sharded.py): the
    # mode builds, and only an affinity cycle on it raises (B14a)
    assert TAllocate(mode="sharded").mode == "sharded"
    sched = TScheduler(cache, solver="sharded")
    assert [a.mode for a in sched.actions if a.name == "allocate"] == \
        ["sharded"]


def test_pipeline_option_builds_the_executor():
    """``pipeline=True`` (the reference's KUBEBATCH_PIPELINE) builds the
    pipelined executor, active and empty; without it there is none."""
    from kubebatch_tpu_torch.runtime.pipeline import PipelinedExecutor

    cache = TCache(async_writeback=False, device="cpu")
    sched = TScheduler(cache, pipeline=True)
    assert sched.pipeline_enabled
    assert isinstance(sched._pipeline, PipelinedExecutor)
    assert sched._pipeline.sched is sched
    assert sched._pipeline.active() and sched._pipeline.pending is None
    plain = TScheduler(cache)
    assert not plain.pipeline_enabled and plain._pipeline is None


def test_solver_argument_sets_the_allocate_mode(monkeypatch):
    """``solver=`` is KUBEBATCH_SOLVER: a "jax" loop runs every visit on
    the per-visit scan and binds as the reference's loop under
    KUBEBATCH_SOLVER=jax."""
    from kubebatch_tpu.actions import allocate as j_allocate_mod
    from kubebatch_tpu_torch.actions import allocate as t_allocate_mod

    t = Side(True, solver="jax")
    assert t.sched.run_cycle() is True
    assert t_allocate_mod.last_cycle_engine == "jax-visit"
    monkeypatch.setenv("KUBEBATCH_SOLVER", "jax")
    j = Side(False)
    assert j.sched.run_cycle() is True
    assert j_allocate_mod.last_cycle_engine == "jax-visit"
    assert t.rec.binds == j.rec.binds and t.rec.binds
    assert t.states() == j.states()


@pytest.mark.parametrize("solver", ["hier", "activeset"])
def test_two_level_solvers_run_as_the_reference(monkeypatch, solver):
    """``solver="hier"`` / ``"activeset"`` and ``solve_audit_every``: the
    loop runs the two-level engine (the active set claiming the cycle,
    its first engaged cycle an audit) and binds as the reference's loop
    under KUBEBATCH_SOLVER; both set the same audit cadence."""
    from kubebatch_tpu.actions import allocate as j_allocate_mod
    from kubebatch_tpu.kernels import activeset as j_activeset
    from kubebatch_tpu_torch.actions import allocate as t_allocate_mod
    from kubebatch_tpu_torch.kernels import activeset as t_activeset

    try:
        for mod in (j_activeset, t_activeset):
            mod.reset()
        t = Side(True, solver=solver, solve_audit_every=4)
        monkeypatch.setenv("KUBEBATCH_SOLVER", solver)
        j = Side(False, solve_audit_every=4)
        assert j_activeset.audit_every() == t_activeset.audit_every() == 4
        out = []
        for s, alloc in ((j, j_allocate_mod), (t, t_allocate_mod)):
            a0 = s.metrics.activeset_audits_total()
            assert s.sched.run_cycle() is True
            out.append((alloc.last_cycle_engine,
                        s.metrics.activeset_audits_total() - a0))
        assert out[0] == out[1] == (solver, int(solver == "activeset"))
        assert t.rec.binds == j.rec.binds and t.rec.binds
        assert t.states() == j.states()
    finally:
        for mod in (j_activeset, t_activeset):
            mod.reset()
            mod.set_audit_every(16)


def test_probe_runs_a_subprocess_on_the_card_only():
    assert watchdog.midrun_probe("cpu") is True
    status, detail = watchdog.probe_backend(timeout=60.0,
                                            probe_src="print('up')")
    assert (status, detail) == ("ok", "up")
    status, detail = watchdog.probe_backend(
        timeout=60.0, probe_src="raise SystemExit('down')")
    assert status == "error" and "down" in detail


def test_fold_seam_demotes_the_fold():
    """A fired cache.fold seam demotes the event fold to snapshot-primary
    (counted), never raising into the event handler — as the
    reference's."""
    out = []
    for mod, cache, met in (
            (j_faults, JCache(async_writeback=False), j_metrics),
            (t_faults, TCache(async_writeback=False, device="cpu"),
             t_metrics)):
        d0 = met.fold_demotions_total().get("fault", 0)
        mod.arm(mod.FaultPlan(counts={"cache.fold": 1}))
        cache.add_queue((j_objects if mod is j_faults else t_objects)
                        .Queue(name="q"))
        mod.disarm()
        out.append((cache.fold.enabled,
                    met.fold_demotions_total().get("fault", 0) - d0))
    assert out == [(False, 1), (False, 1)]
