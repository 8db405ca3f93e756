"""The port's pipelined executor against the reference's, on the CPU.

Both packages run the reference's pipeline harness (tests/test_pipeline.py:
24 nodes of 8 cpus, 12 gangs x 2 pods in two queues, a quiet churn stream
of one fresh 2-pod gang a cycle, bound pods flipped Running after each
cycle) through their ``Scheduler(pipeline=True)`` with the active-set
engine, its audit off unless a case sets ``solve_audit_every`` on both
sides: the reference's KUBEBATCH_SOLVER set to "activeset", the port's
``solver="activeset"``.
Tolerance 0 throughout:

- a quiet stream, with the audit off and on every 2nd cycle (the
  fourth audit's divergence word forced on both sides): binds in commit
  order, statuses, and the moves of ``pipeline_cycles_total``,
  ``deferred_readbacks``, ``blocking_readbacks``, the ledger's
  ``deferred_closed_total``, ``activeset_audits_total``, the
  divergences and the active set's demotions equal the reference's;
  the consume span carries its launching cycle's epoch; the port's
  pipelined binds equal its sequential loop's;
- conflicts mid-flight (a placed pod deleted, every node's capacity
  changed): the same outcomes and counters, nothing bound twice, the
  deleted pod never bound, and after ``restore_carry`` the port's carry
  equals the pre-dispatch carry bit for bit;
- the ``pipeline.conflict`` seam: one fire recovers, a storm demotes,
  with the reference's counters;
- the event fold's flight window (marks, capacity marks) and
  ``rebase_inputs`` (False for a placed task that no longer resolves).
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
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
from kubebatch_tpu.actions import cycle_inputs as j_ci  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.cache.eventfold import EventFold as JFold  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import activeset as j_act  # noqa: E402
from kubebatch_tpu.kernels import telemetry as j_telem  # noqa: E402
from kubebatch_tpu.runtime import pipeline as j_pipe  # noqa: E402
from kubebatch_tpu.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import obs as t_obs  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions import cycle_inputs as t_ci  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.cache.eventfold import EventFold as TFold  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import activeset as t_act  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import F_ACT_DEMOTED  # noqa: E402
from kubebatch_tpu_torch.runtime import Scheduler as TScheduler  # noqa: E402
from kubebatch_tpu_torch.runtime import pipeline as t_pipe  # noqa: E402

GiB = 1024 ** 3

#: the reference reads these at construction or every cycle
_SETTINGS = ("KUBEBATCH_SOLVER", "KUBEBATCH_CYCLE_DEADLINE",
             "KUBEBATCH_AUDIT_EVERY", "KUBEBATCH_SUBCYCLE",
             "KUBEBATCH_PIPELINE", "KUBEBATCH_SLO", "KUBEBATCH_TIMELINE_DIR",
             "KUBEBATCH_FAULTS", "KUBEBATCH_SOLVE_AUDIT_EVERY")


def _reset_planes():
    for faults in (j_faults, t_faults):
        faults.disarm()
    j_act.reset()
    t_act.reset()
    j_pipe.reset()
    t_pipe.reset()
    for o in (j_obs, t_obs):
        o.ledger.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both packages un-demoted (pipeline and active set), injection
    disarmed, ledgers cleared; the reference's settings cleared but its
    solver, the active-set audit off on both sides."""
    for name in _SETTINGS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("KUBEBATCH_SOLVER", "activeset")
    _reset_planes()
    j_act.set_audit_every(0)
    yield
    _reset_planes()
    j_act._audit_every = None
    t_act.set_audit_every(t_act.DEFAULT_AUDIT_EVERY)


class Seams:
    """Binder and evictor recording every bind in commit order."""

    def __init__(self):
        self.binds = {}
        self.bind_events = []
        self.fresh = []

    def bind(self, pod, hostname):
        self.bind_events.append((pod.name, hostname))
        self.binds[pod.name] = hostname
        pod.node_name = hostname
        self.fresh.append(pod)

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        pod.deletion_timestamp = 1.0


class Side:
    """One package's pipeline harness: the reference's ``_Harness`` over
    that package's objects, cache, Scheduler and counters."""

    def __init__(self, torch_side: bool, pipeline: bool = True,
                 seed: int = 5, audit_every: int = 0):
        self.torch_side = torch_side
        m = self.objects = t_objects if torch_side else j_objects
        self.metrics = t_metrics if torch_side else j_metrics
        self.faults = t_faults if torch_side else j_faults
        self.pipe = t_pipe if torch_side else j_pipe
        self.obs = t_obs if torch_side else j_obs
        self.seams = Seams()
        kw = {"device": "cpu"} if torch_side else {}
        self.cache = (TCache if torch_side else JCache)(
            binder=self.seams, evictor=self.seams, async_writeback=False,
            **kw)
        rng = np.random.default_rng(seed)
        for q in range(2):
            self.cache.add_queue(m.Queue(name=f"q{q}", weight=q + 1,
                                         uid=f"queue-q{q}"))
        for i in range(24):
            alloc = self.rl(8000, 8 * GiB, pods=20)
            self.cache.add_node(m.Node(name=f"n{i:03d}", uid=f"node-{i}",
                                       allocatable=alloc,
                                       capacity=dict(alloc)))
        for g in range(12):
            self._gang(f"g{g:03d}", 1, f"q{g % 2}", float(g),
                       [(int(rng.integers(1, 4)) * 500, 2 * GiB,
                         int(rng.integers(1, 5))) for _ in range(2)])
        if torch_side:
            self.sched = TScheduler(self.cache, schedule_period=3600.0,
                                    pipeline=pipeline, solver="activeset",
                                    solve_audit_every=audit_every)
        else:
            self.sched = JScheduler(self.cache, schedule_period=3600.0,
                                    pipeline=pipeline,
                                    solve_audit_every=audit_every)
        self.next_gid = 100

    def rl(self, cpu, mem, pods=0):
        return self.objects.resource_list(cpu=cpu, memory=mem, pods=pods)

    def _gang(self, name, min_member, queue, ts, pods):
        m = self.objects
        self.cache.add_pod_group(m.PodGroup(
            name=name, namespace="ns", uid=f"pg-{name}",
            min_member=min_member, queue=queue, creation_timestamp=ts))
        out = []
        for p, (cpu, mem, prio) in enumerate(pods):
            pod = m.Pod(
                uid=f"ns-{name}-{p}", name=f"{name}-{p}", namespace="ns",
                phase=m.PodPhase.PENDING,
                containers=[m.Container(requests=self.rl(cpu, mem))],
                annotations={m.GROUP_NAME_ANNOTATION: name},
                priority=prio, creation_timestamp=ts * 100 + p)
            self.cache.add_pod(pod)
            out.append(pod)
        return out

    def add_gang(self):
        g = self.next_gid
        self.next_gid += 1
        name = f"soak{g:03d}"
        return name, self._gang(name, 1, "q0", float(g),
                                [(500, GiB, None)] * 2)

    def kubelet_tick(self):
        running = self.objects.PodPhase.RUNNING
        for pod in self.seams.fresh:
            if pod.phase == self.objects.PodPhase.PENDING and pod.node_name:
                pod.phase = running
                self.cache.update_pod(pod, pod)
        self.seams.fresh.clear()

    def run_quiet(self, cycles: int):
        for _ in range(cycles):
            self.add_gang()
            assert self.sched.run_cycle(), "quiet cycle failed"
            self.kubelet_tick()

    def drain(self):
        if self.sched._pipeline is not None:
            self.sched._pipeline.drain()
            self.kubelet_tick()

    def in_flight(self) -> bool:
        return self.sched._pipeline._pending is not None

    def statuses(self):
        return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
                for j in self.cache.jobs.values() for t in j.tasks.values()}

    def counters(self):
        m = self.metrics
        return {"pipeline_cycles": m.pipeline_cycles_total(),
                "conflicts": m.pipeline_conflicts_by_outcome(),
                "demotions": m.pipeline_demotions_total(),
                "deferred_readbacks": m.deferred_readbacks(),
                "blocking_readbacks": m.blocking_readbacks(),
                "deferred_closed": self.obs.ledger.stats()[
                    "deferred_closed_total"],
                "audits": m.activeset_audits_total(),
                "divergences": m.activeset_divergences_total(),
                "act_demotions": m.activeset_demotions_total()}


def _delta(after, before):
    out = {}
    for k, v in after.items():
        if isinstance(v, dict):
            out[k] = {o: n - before[k].get(o, 0) for o, n in v.items()
                      if n - before[k].get(o, 0)}
        else:
            out[k] = v - before[k]
    return out


def _both(fn, **kw):
    """fn(side) on the reference's side, then the port's; the pair of
    results."""
    return [fn(Side(torch_side, **kw)) for torch_side in (False, True)]


def _force_divergence(monkeypatch, which: int):
    """Both packages' audit launches with the ``which``-th one's
    divergence word (the frame's act_demoted) set to 1 after the solve."""
    seen = {"j": 0, "t": 0}
    j_inner = j_act._activeset_audit_packed
    t_inner = t_act.activeset_audit_packed

    def j_audit(*args, **kw):
        final, packed = j_inner(*args, **kw)
        seen["j"] += 1
        if seen["j"] == which:
            t = (packed.shape[0] - 1 - j_telem.TELEM_WIDTH) // 3
            packed = packed.at[3 * t + 1 + j_telem.F_ACT_DEMOTED].set(1)
        return final, packed

    def t_audit(node, act, full, **statics):
        out = t_inner(node, act, full, **statics)
        seen["t"] += 1
        if seen["t"] == which:
            t = full["task_valid"].shape[0]
            out[0][3 * t + 1 + F_ACT_DEMOTED] = 1
        return out

    monkeypatch.setattr(j_act, "_activeset_audit_packed", j_audit)
    monkeypatch.setattr(t_act, "activeset_audit_packed", t_audit)
    return seen


def _consume_epochs(obs, roots):
    """(consume span's epoch, its root's epoch) per consume, in order."""
    out = []

    def walk(sp, root):
        if sp.name == "consume":
            out.append((sp.args["epoch"], root.args["epoch"]))
        for c in sp.children:
            walk(c, root)
    for r in roots:
        walk(r, r)
    return out


@pytest.mark.parametrize("audit", ["off", "every_2nd"])
def test_quiet_stream_matches_reference_and_sequential(audit, monkeypatch):
    """Twelve quiet cycles and a drain: binds in commit order, statuses
    and the pipeline / readback / ledger / audit counters equal the
    reference's; every consume commits, tagged with the epoch of the
    cycle before; the port's binds equal its sequential loop's. With
    the audit on every 2nd cycle its launches are in flight as the
    steady ones are, and the fourth audit's divergence word is forced on
    both sides: its consume demotes the active set, and the later
    cycles run sequentially (one blocking readback each)."""
    every = 0 if audit == "off" else 2
    seen = _force_divergence(monkeypatch, 4) if every else None

    def run(side):
        roots = []
        side.obs.CYCLE_HOOKS.append(roots.append)
        try:
            c0 = side.counters()
            side.run_quiet(12)
            side.drain()
        finally:
            side.obs.CYCLE_HOOKS.remove(roots.append)
        epochs = [r.args["epoch"] for r in roots]
        consumes = _consume_epochs(side.obs, roots)
        # each consume ran in the cycle after its dispatch
        assert consumes and all(
            epochs.index(root) == epochs.index(launch) + 1
            for launch, root in consumes)
        assert not side.pipe.demoted()
        return (side.seams.bind_events, side.statuses(),
                _delta(side.counters(), c0), len(consumes),
                (t_act if side.torch_side else j_act).demoted())

    ref, port = _both(run, audit_every=every)
    assert port == ref
    binds, _, counters, consumes, demoted = port
    assert len(binds) == len({p for p, _ in binds}) == 24 + 24
    assert counters["conflicts"] == {} and counters["demotions"] == 0
    if every:
        # audits on cycles 0, 2, 4 and 6; the fourth's consume (cycle 7)
        # demotes, and cycles 7-11 run sequentially
        assert seen == {"j": 4, "t": 4} and demoted
        assert counters["audits"] == 4 and counters["divergences"] == 1
        assert counters["act_demotions"] == 1
        assert counters["pipeline_cycles"] == consumes == 7
        assert counters["deferred_readbacks"] == 7
        assert counters["blocking_readbacks"] == 5
        assert 0 < counters["deferred_closed"] < len(binds)
    else:
        assert not demoted and counters["audits"] == 0
        assert counters["pipeline_cycles"] == consumes == 12
        assert counters["deferred_readbacks"] == 12
        assert counters["blocking_readbacks"] == 0
        assert counters["deferred_closed"] == len(binds)
    # the sequential loop, audit off: an audit commits the full-width
    # solve, which decides as the active set does
    t_act.reset()
    seq = Side(True, pipeline=False)
    seq.run_quiet(12)
    assert seq.seams.bind_events == binds


def test_conflicts_mid_flight_invalidate_and_restore(monkeypatch):
    """A placed pod deleted while its solve is in flight, and later every
    node's capacity changed while another is: both consumes invalidate
    ("conflict"), as the reference's do, and the cycles re-solve
    sequentially. Nothing binds twice, the deleted pod never binds, the
    sibling does, and each restore_carry leaves the port's carry equal
    to its pre-dispatch carry bit for bit."""
    pre = {}
    restored = []
    inner_async = t_act.solve_cycle_async
    inner_restore = t_act.PendingSolve.restore_carry

    def solve_cycle_async(inputs, phases=None):
        d = inputs.device
        carry = [c.clone() for c in (d.idle, d.releasing, d.n_tasks,
                                     d.nz_req)]
        pend = inner_async(inputs, phases)
        if pend is not None:
            pre[id(pend)] = carry
        return pend

    def restore_carry(self):
        inner_restore(self)
        d = self.device
        restored.append(all(
            torch.equal(a, b) and a.dtype == b.dtype
            for a, b in zip((d.idle, d.releasing, d.n_tasks, d.nz_req),
                            pre[id(self)])))

    monkeypatch.setattr(t_act, "solve_cycle_async", solve_cycle_async)
    monkeypatch.setattr(t_act.PendingSolve, "restore_carry", restore_carry)

    def run(side):
        side.run_quiet(4)
        assert side.in_flight()
        c0 = side.counters()
        name, pods = side.add_gang()
        assert side.sched.run_cycle()        # dispatches with the gang
        assert side.in_flight()
        side.cache.delete_pod(pods[0])
        side.run_quiet(2)
        c1 = side.counters()
        assert side.in_flight()
        for node in list(side.cache.nodes.values()):
            old = node.node
            alloc = dict(old.allocatable)
            alloc[side.objects.PODS] = 21
            side.cache.update_node(old, side.objects.Node(
                name=old.name, uid=old.uid, allocatable=alloc,
                capacity=dict(alloc)))
        side.run_quiet(2)
        side.drain()
        assert pods[0].name not in side.seams.binds
        assert pods[1].name in side.seams.binds
        assert len(side.seams.bind_events) == len(side.seams.binds)
        assert not side.pipe.demoted()
        return (side.seams.bind_events, side.statuses(), _delta(c1, c0),
                _delta(side.counters(), c1))

    ref, port = _both(run)
    assert port == ref
    for d in port[2:]:
        assert d["conflicts"] == {"conflict": 1}
    assert restored == [True, True]


def test_conflict_seam_recovers_then_storm_demotes():
    """One ``pipeline.conflict`` fire invalidates once ("fault") and the
    executor re-engages; CONFLICT_STORM_LIMIT fires in a row demote it
    (reason "storm"), and the cycles after go on binding sequentially.
    Binds, statuses and counters equal the reference's."""
    def run(side):
        f = side.faults
        side.run_quiet(3)
        c0 = side.counters()
        f.arm(f.FaultPlan(counts={"pipeline.conflict": 1}))
        side.run_quiet(4)
        f.disarm()
        c1 = side.counters()
        assert not side.pipe.demoted()
        f.arm(f.FaultPlan(counts={
            "pipeline.conflict": side.pipe.CONFLICT_STORM_LIMIT}))
        side.run_quiet(4 * side.pipe.CONFLICT_STORM_LIMIT)
        f.disarm()
        assert side.pipe.demoted() and not side.sched._pipeline.active()
        c2 = side.counters()
        n = len(side.seams.binds)
        side.run_quiet(2)
        assert len(side.seams.binds) > n
        assert len(side.seams.bind_events) == len(side.seams.binds)
        return (side.seams.bind_events, side.statuses(), _delta(c1, c0),
                _delta(c2, c1))

    ref, port = _both(run)
    assert port == ref
    assert port[2]["conflicts"] == {"fault": 1}
    assert port[2]["pipeline_cycles"] >= 2
    assert port[3]["conflicts"] == {"fault": 3}
    assert port[3]["demotions"] == 1


def test_flight_window_marks_as_the_reference():
    """Marks tag the flight window only while it is open, capacity marks
    apart, whether or not the fold is enabled; end_flight hands them
    back and clears them."""
    def run(fold):
        out = []
        fold.mark_job("j0")
        fold.mark_node("n0", cap=True)
        out.append(fold.end_flight())
        fold.begin_flight()
        fold.mark_job("j1")
        fold.mark_node("n1")
        fold.mark_node("n2", cap=True)
        fold.enabled = False
        fold.mark_job("j2")
        fold.mark_node("n3", cap=True)
        out.append(fold.end_flight())
        fold.mark_node("n4", cap=True)
        out.append(fold.end_flight())
        return out

    ref = run(JFold(None, True))
    port = run(TFold(True))
    assert port == ref
    assert port[1] == ({"j1", "j2"}, {"n1", "n2", "n3"}, {"n2", "n3"})


@pytest.mark.parametrize("case", ["resolves", "placed_deleted",
                                  "unplaced_deleted"])
def test_rebase_inputs_as_the_reference(case):
    """rebase_inputs against the reference's: onto the next session's
    objects when every placed task still resolves as pending; False when
    a placed one was deleted; a deleted task that was not placed keeps
    its old object."""
    def run(side):
        opn, tiers, ci = ((TOpen, t_tiers, t_ci) if side.torch_side
                          else (JOpen, j_tiers, j_ci))
        inputs = ci.build_cycle_inputs(opn(side.cache, tiers()))
        n = len(inputs.tasks)
        state = np.zeros(inputs.task_valid.shape[0], np.int32)
        state[:n] = 1                                       # ALLOC
        victim = inputs.tasks[0]
        if case == "unplaced_deleted":
            state[0] = 0                                    # SKIP
        if case != "resolves":
            pod = next(p for j in side.cache.jobs.values()
                       for t in j.tasks.values() if t.uid == victim.uid
                       for p in [t.pod])
            side.cache.delete_pod(pod)
        ssn = opn(side.cache, tiers())
        ok = ci.rebase_inputs(ssn, inputs, state)
        same = [t is ssn.jobs[t.job].tasks.get(t.uid)
                if t.job in ssn.jobs else False for t in inputs.tasks]
        return ok, same, [t.name for t in inputs.tasks]

    ref, port = _both(run)
    assert port == ref
    ok, same, _ = port
    assert ok == (case != "placed_deleted")
    if case == "resolves":
        assert all(same)
    if case == "unplaced_deleted":
        assert not same[0] and all(same[1:])


def test_inplace_entry_writes_the_carry_it_is_given():
    """The donated twin's counterpart on CPU tensors: the plain version,
    its carry written into the tensors given (returned as themselves),
    equal to the cloning entry's result, which leaves its inputs alone;
    the in-place launch's alias check refuses a carry that shares bytes
    with another argument."""
    from kubebatch_tpu_torch.kernels.batched import NODE_ARGS
    from kubebatch_tpu_torch.kernels.hier import _check_no_alias

    side = Side(True)
    inputs = t_ci.build_cycle_inputs(TOpen(side.cache, t_tiers()))
    args, statics, _ = t_act.prepare_activeset(inputs)
    before = {k: args[k].clone() for k in NODE_ARGS[:4]}
    cloning = t_act.activeset_packed(**args, **statics)
    assert all(torch.equal(args[k], before[k]) for k in before)
    got = t_act.activeset_packed_inplace(**args, **statics)
    assert all(g is args[k] for g, k in zip(got[1:], NODE_ARGS[:4]))
    for a, b in zip(cloning, got):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not torch.equal(args["idle"], before["idle"])
    idle = args["idle"]
    _check_no_alias("t", {"idle": idle}, [args["backfilled"]])
    for other in (idle, idle[1:], idle.view(-1)[:1]):
        with pytest.raises(ValueError, match="overlaps"):
            _check_no_alias("t", {"idle": idle}, [other])
