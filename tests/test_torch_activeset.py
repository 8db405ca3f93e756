"""The port's active-set engine against the reference package's, on the CPU.

Tolerance 0 throughout:

- ``activeset_packed`` and ``activeset_audit_packed`` on CPU tensors (the
  plain versions) against the reference's jitted ``_activeset_packed`` /
  ``_activeset_audit_packed`` on the reference's own plans, carried across
  by ``interop.activeset_args_from_numpy`` /
  ``activeset_audit_args_from_numpy``: packed result (decisions, rounds,
  the telemetry frame with its act_* words) word for word, the committed
  node carry bit for bit; at each grain, with zero audit divergence;
- the engine's gates: the grains, and the cycles it declines (inexact
  pairs, a pair whose members' init_resreq rows differ, an active set
  past 4,096), as the reference's plans decline them;
- the ``solve.activeset`` fault seam demoting for the rest of the
  process, and whole auto cycles (the two-level threshold lowered) on
  incremental caches: engines, binds, statuses and counters equal.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401
import kubebatch_tpu.plugins  # noqa: E402,F401
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu.actions import allocate as j_allocate_mod  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.actions.cycle_inputs import build_cycle_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels import activeset as j_act  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import interop  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.actions.cycle_inputs import \
    build_cycle_inputs as t_build_inputs  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels import activeset as t_act  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import (F_ACT_DEMOTED,  # noqa: E402
                                                   F_ACT_SCATTER,
                                                   F_ACT_TASKS)
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

from .test_torch_hier import assert_result  # noqa: E402

GiB = 1024 ** 3
f32 = np.float32

#: cfg5's shape cut to 48 nodes, 40 gangs x 8 (320 tasks: grain 1,024),
#: jittered requests, contended
REDUCED5 = dict(n_nodes=48, n_groups=40, pods_per_group=8, n_queues=4,
                queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
                pod_mem_bytes=2 * GiB, jitter=0.2, seed=5)
#: 40 nodes (5 pools of 8 real nodes), 12 gangs x 4 in two queues: the
#: whole-cycle and fault-seam cases (grain 256)
SMALL = dict(n_nodes=40, n_groups=12, pods_per_group=4, n_queues=2,
             queue_weights=(1, 2), pod_cpu_millis=1000,
             pod_mem_bytes=2 * GiB, jitter=0.2, seed=5)


@pytest.fixture(autouse=True)
def _clean():
    """Both engines un-demoted, their cadence at the default, injection
    disarmed — before and after every test."""
    def reset():
        for faults in (j_faults, t_faults):
            faults.disarm()
        j_act.reset()
        j_act._audit_every = None
        t_act.reset()
        t_act.set_audit_every(t_act.DEFAULT_AUDIT_EVERY)
    reset()
    yield
    reset()


def check_steady(inputs, grain=0, pool_size=8):
    """The reference's active-set solve of these inputs against the
    port's; returns (packed, grain)."""
    args, st, g = j_act.prepare_activeset(inputs.device, inputs,
                                          grain=grain, pool_size=pool_size)
    final, packed = j_act._activeset_packed(*args, **st)
    arrays, tst = interop.activeset_args_from_numpy(
        [np.asarray(a) for a in args], st, "cpu")
    return assert_result(packed, final, t_act.activeset_packed(**arrays, **tst)), g


def check_audit(inputs, grain=0, pool_size=8):
    """The reference's audit of these inputs against the port's; returns
    the packed result (full width)."""
    args, st, _ = j_act.prepare_activeset_audit(
        inputs.device, inputs, grain=grain, pool_size=pool_size)
    final, packed = j_act._activeset_audit_packed(*args, **st)
    node, act, full, tst = interop.activeset_audit_args_from_numpy(
        [np.asarray(a) for a in args], st, "cpu")
    return assert_result(packed, final, t_act.activeset_audit_packed(
        node, act, full, **tst))


def _sim_inputs(**spec):
    sim = j_build(JSpec(**spec))
    cache = JCache(async_writeback=False, incremental_snapshot=False)
    sim.populate(cache)
    return build_cycle_inputs(JOpen(cache, j_tiers()))


def test_grain_selection():
    for n in (0, 1, 255, 256, 257, 1024, 1025, 4096, 4097):
        assert t_act.activeset_grain(n) == j_act.activeset_grain(n)
    assert t_act.ACT_GRAINS == j_act.ACT_GRAINS


@pytest.mark.parametrize("spec,grain,audit", [
    (SMALL, 0, True), (REDUCED5, 0, True), (SMALL, 4096, False)],
    ids=["256", "1024-contended", "4096"])
def test_steady_and_audit_match_reference(spec, grain, audit):
    """Each grain: the steady solve (and the audit) word for word; the
    audit's divergence word 0, the act_* words the active set's. The
    1,024 case is contended with jittered requests: the epilogue revives
    stranded gangs in both solves."""
    inputs = _sim_inputs(**spec)
    n_real = int(np.asarray(inputs.task_valid).sum())
    packed, g = check_steady(inputs, grain)
    frame = packed[3 * g + 1:]
    assert g == (grain or t_act.activeset_grain(n_real))
    assert frame[F_ACT_TASKS] == n_real and frame[F_ACT_SCATTER] > 0
    if audit:
        t = inputs.task_valid.shape[0]
        out = check_audit(inputs, grain)
        assert out[3 * t + 1 + F_ACT_DEMOTED] == 0
        assert out[3 * t + 1 + F_ACT_TASKS] == n_real


# ---- the gates ----------------------------------------------------------------

def _gate_cluster(objects, n_pods: int, cpu_of, init_of=None):
    """Both packages' cache with 8 roomy nodes and ``n_pods`` one-pod
    gangs, the k-th requesting ``cpu_of(k)`` milli-cpus and, with
    ``init_of``, an init container of ``init_of(k)``."""
    if objects == "j":
        from kubebatch_tpu import objects as m
        cache = JCache(async_writeback=False, incremental_snapshot=False)
    else:
        from kubebatch_tpu_torch import objects as m
        cache = TCache(async_writeback=False, device="cpu")
    cache.add_queue(m.Queue(name="q0", weight=1))
    for i in range(8):
        alloc = m.resource_list(cpu=10 ** 7, memory=10 ** 6 * GiB,
                                pods=10 ** 5)
        cache.add_node(m.Node(name=f"n{i}", allocatable=alloc,
                              capacity=dict(alloc)))
    for k in range(n_pods):
        cache.add_pod_group(m.PodGroup(name=f"g{k}", namespace="ns",
                                       min_member=1, queue="q0",
                                       creation_timestamp=float(k)))
        init = []
        if init_of is not None and init_of(k):
            init = [m.Container(requests=m.resource_list(
                cpu=init_of(k), memory=GiB))]
        cache.add_pod(m.Pod(
            name=f"p{k}", namespace="ns",
            annotations={m.GROUP_NAME_ANNOTATION: f"g{k}"},
            containers=[m.Container(requests=m.resource_list(
                cpu=cpu_of(k), memory=GiB))],
            init_containers=init, creation_timestamp=float(k)))
    return cache


@pytest.mark.parametrize("case", ["inexact_pairs", "init_differs",
                                  "over_4096", "accepted"])
def test_gates_decline_as_the_reference(case):
    """The engine declines, in both packages, a cycle with more distinct
    (sig, request) pairs than the pair budget (octave-bucketed, inexact),
    one whose pair members' init_resreq rows differ, and an active set
    past the largest grain; a plain cycle it accepts."""
    n, cpu_of, init_of = {
        "inexact_pairs": (2100, lambda k: 100 + k, None),
        "init_differs": (8, lambda k: 100, lambda k: 500 if k == 3 else 0),
        "over_4096": (4097, lambda k: 100, None),
        "accepted": (8, lambda k: 100, None),
    }[case]
    plans = []
    for side in ("j", "t"):
        cache = _gate_cluster(side, n, cpu_of, init_of)
        if side == "j":
            inputs = build_cycle_inputs(JOpen(cache, j_tiers()))
            plans.append(j_act.prepare_activeset(inputs.device, inputs))
        else:
            inputs = t_build_inputs(TOpen(cache, t_tiers()))
            plans.append(t_act.prepare_activeset(inputs))
    assert (plans[0] is None) == (plans[1] is None) == (case != "accepted")


# ---- the demotion rung and whole cycles ----------------------------------------

class _Recorder:
    """Binds flip the pod's node_name; recorded by namespace/name."""

    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((f"{pod.namespace}/{pod.name}", hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)


def _pair_sides(spec):
    """(reference, port): sim, incremental cache and recorded binds."""
    out = []
    for build, cache_cls, spec_cls, kw in (
            (j_build, JCache, JSpec, {}),
            (t_build, TCache, TSpec, {"device": "cpu"})):
        binder = _Recorder()
        sim = build(spec_cls(**spec))
        cache = cache_cls(binder=binder, async_writeback=False, **kw)
        sim.populate(cache)
        out.append((sim, cache, binder))
    return out


def _cycle(side, mode, torch_side):
    sim, cache, _ = side
    if torch_side:
        ssn = TOpen(cache, t_tiers())
        TAllocate(mode=mode).execute(ssn)
        TClose(ssn)
        return t_allocate_mod.last_cycle_engine
    ssn = JOpen(cache, j_tiers())
    JAllocate(mode=mode).execute(ssn)
    JClose(ssn)
    return j_allocate_mod.last_cycle_engine


def _states(cache):
    return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
            for j in cache.jobs.values() for t in j.tasks.values()}


def _kubelet(side):
    sim, cache, _ = side
    for pod in sim.pods:
        if pod.node_name and pod.phase.name != "RUNNING":
            pod.phase = type(pod.phase).RUNNING
            cache.update_pod(pod, pod)


def test_fault_seam_demotes_for_the_rest_of_the_process():
    """An armed ``solve.activeset`` seam fires on the next engaged cycle:
    that cycle runs on the full-width engine, and so does every later
    one until reset(); counted under "fault" in both packages."""
    trace = []
    for torch_side, side in enumerate(_pair_sides(SMALL)):
        faults, act, met = ((t_faults, t_act, t_metrics) if torch_side
                            else (j_faults, j_act, j_metrics))
        d0 = met.activeset_demotions_by_reason().get("fault", 0)
        faults.arm(faults.FaultPlan(counts={"solve.activeset": 1}))
        out = []
        for k in range(3):
            if k == 1:
                faults.disarm()
            if k == 2:
                act.reset()
            out += [_cycle(side, "activeset", torch_side), act.demoted()]
            _kubelet(side)
            side[0].churn_tick(side[1], 8)
        trace.append((out, met.activeset_demotions_by_reason().get(
            "fault", 0) - d0))
    assert trace[0] == trace[1] == (
        ["hier", True, "hier", True, "activeset", False], 1)


def test_auto_cycles_match_reference(monkeypatch):
    """Auto with the two-level threshold lowered: a cold cycle then three
    skewed churn cycles on incremental caches, the audit every second
    engaged cycle. Engines, binds, statuses and the active-set and
    demotion counters equal the reference's."""
    monkeypatch.setattr(t_allocate_mod, "AUTO_HIER_MIN_NODES", 16)
    monkeypatch.setattr(j_allocate_mod, "AUTO_HIER_MIN_NODES", 16)
    j_act.set_audit_every(2)
    t_act.set_audit_every(2)
    j, t = _pair_sides(SMALL)
    counters = []
    for met in (j_metrics, t_metrics):
        counters.append([met.activeset_cycles_total(),
                         met.activeset_audits_total(),
                         met.activeset_demotions_total(),
                         met.engine_demotions_total()])
    engines = {False: [], True: []}
    for k in range(4):
        for torch_side, side in ((False, j), (True, t)):
            if k:
                _kubelet(side)
                assert side[0].churn_tick(side[1], 8,
                                          arrival_queue=k % 2) > 0
            engines[torch_side].append(_cycle(side, "auto", torch_side))
        assert t[2].calls == j[2].calls
        assert _states(t[1]) == _states(j[1])
    assert engines[True] == engines[False] == ["activeset"] * 4
    for c, met in zip(counters, (j_metrics, t_metrics)):
        c[:] = [met.activeset_cycles_total() - c[0],
                met.activeset_audits_total() - c[1],
                met.activeset_demotions_total() - c[2],
                met.engine_demotions_total() - c[3]]
    assert counters[0] == counters[1] == [4, 2, 0, 0]
