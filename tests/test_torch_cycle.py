"""The port's allocate cycle end to end against the reference package.

Both packages build the same cluster from one ClusterSpec (each with its
own sim), into caches with synchronous write-back and full snapshots, and
run the shipped tiers' allocate. The port runs on the CPU. Every task's
(status, node), the binder's call order, and the session-level results
must be identical — tolerance 0: the fused solve is bit-exact against the
host oracle in both packages.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.objects import PodPhase as JPhase  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS  # noqa: E402
from kubebatch_tpu.sim import ClusterSpec as JSpec  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.objects import BACKFILL_ANNOTATION  # noqa: E402
from kubebatch_tpu_torch.objects import PodPhase as TPhase  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import ClusterSpec as TSpec  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

GiB = 1024 ** 3


class RecordingBinder:
    """Binds by flipping the pod's node_name and records the call order."""

    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((f"{pod.namespace}/{pod.name}", hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)


class Side:
    """One package's cluster + cache + action classes."""

    def __init__(self, torch_side: bool, config, prep=None):
        self.torch_side = torch_side
        self.binder = RecordingBinder()
        if isinstance(config, TSpec):
            spec = config if torch_side else JSpec(**vars(config))
        else:
            spec = (T_SPECS if torch_side else J_SPECS)[config]
        if torch_side:
            self.sim = t_build(spec)
            self.cache = TCache(binder=self.binder, async_writeback=False,
                                incremental_snapshot=False, device="cpu")
        else:
            self.sim = j_build(spec)
            self.cache = JCache(binder=self.binder, async_writeback=False,
                                incremental_snapshot=False)
        # every other running fill pod terminating (releasing capacity:
        # pipelined tasks) or lendable (backfilled capacity:
        # AllocatedOverBackfill tasks)
        for pod in [p for p in self.sim.pods
                    if p.name.startswith("fill-")][::2]:
            if prep == "releasing":
                pod.deletion_timestamp = 1.0
            elif prep == "backfill":
                pod.annotations[BACKFILL_ANNOTATION] = "true"
        self.sim.populate(self.cache)

    def cycle(self, mode):
        if self.torch_side:
            ssn = TOpen(self.cache, t_tiers())
            TAllocate(mode=mode).execute(ssn)
            TClose(ssn)
        else:
            ssn = JOpen(self.cache, j_tiers())
            JAllocate(mode=mode).execute(ssn)
            JClose(ssn)

    def kubelet_tick(self):
        """Bound pods start running (the sim has no kubelet)."""
        running = TPhase.RUNNING if self.torch_side else JPhase.RUNNING
        for pod in self.sim.pods:
            if pod.node_name and pod.phase != running:
                pod.phase = running
                self.cache.update_pod(pod, pod)

    def task_states(self):
        out = {}
        for job in self.cache.jobs.values():
            for task in job.tasks.values():
                out[f"{task.namespace}/{task.name}"] = (task.status.name,
                                                        task.node_name)
        return out


def _assert_same(j: Side, t: Side):
    assert t.binder.calls == j.binder.calls
    assert t.task_states() == j.task_states()


# cfg1, cfg2 and the tenant mix from the shipped specs, plus a reduced,
# jittered cfg5 shape (4 weighted queues, contention: some gangs fail)
REDUCED5 = TSpec(n_nodes=48, n_groups=56, pods_per_group=8, n_queues=4,
                 queue_weights=(1, 2, 3, 4), pod_cpu_millis=1000,
                 pod_mem_bytes=2 * GiB, jitter=0.2, seed=5)
#: a nearly full cluster (half its fill terminating or lendable)
FILLED = TSpec(n_nodes=16, n_groups=24, pods_per_group=4, min_member=2,
               running_fill=0.9, n_queues=2, queue_weights=(1, 3),
               pod_cpu_millis=1000, pod_mem_bytes=GiB, seed=7)
CASES = [(1, None), (2, None), ("t", None), (REDUCED5, None),
         (FILLED, "releasing"), (FILLED, "backfill")]
IDS = ["cfg1", "cfg2", "t", "reduced5", "pipelined", "over_backfill"]


@pytest.mark.parametrize("mode", ["fused", "host"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_allocate_cycle_matches_reference(case, mode):
    j, t = Side(False, *case), Side(True, *case)
    j.cycle(mode)
    t.cycle(mode)
    assert t.binder.calls, "scenario must bind"
    _assert_same(j, t)
    assert t_allocate_mod.last_cycle_engine == (
        "fused" if mode == "fused" else "host-visit")


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_churn_cycle_in_auto_matches_reference(case):
    j, t = Side(False, *case), Side(True, *case)
    for side in (j, t):
        side.cycle("fused")
        side.kubelet_tick()
        side.sim.churn_tick(side.cache, 16)
    n0 = len(t.binder.calls)
    j.cycle("auto")
    t.cycle("auto")
    assert t_allocate_mod.last_cycle_engine == "fused"
    if case[1] is None:     # the filled cluster may have no room left
        assert len(t.binder.calls) > n0, "the churn cycle must bind"
    _assert_same(j, t)


@pytest.mark.parametrize("config", [2, REDUCED5], ids=["cfg2", "reduced5"])
def test_one_counted_sync_per_fused_solve(config):
    t = Side(True, config)
    rb0 = t_metrics.blocking_readbacks()
    dem0 = t_metrics.engine_demotions_total()
    t.cycle("fused")
    assert t_metrics.blocking_readbacks() - rb0 == 1
    assert t_metrics.engine_demotions_total() == dem0


def test_unsupported_snapshot_falls_back_to_host_counted():
    """Inter-pod affinity is outside the fused vocabulary: on a CPU cache
    the cycle runs the host path, the demotion is counted, and the binds
    still match the reference package."""
    j, t = Side(False, "2p"), Side(True, "2p")
    dem0 = t_metrics.engine_demotions_total()
    j.cycle("fused")
    t.cycle("fused")
    assert t_metrics.engine_demotions_total() == dem0 + 1
    assert t_allocate_mod.last_cycle_engine == "host-visit"
    assert t.binder.calls
    _assert_same(j, t)


def test_unsupported_snapshot_on_the_card_raises():
    """On a CUDA cache the same cycle raises instead of moving the
    allocate off the card. The cache only claims the card here: the
    vocabulary check refuses the cycle before anything is uploaded."""
    t = Side(True, "2p")
    t.cache.device = torch.device("cuda")
    dem0 = t_metrics.engine_demotions_total()
    ssn = TOpen(t.cache, t_tiers())
    with pytest.raises(NotImplementedError, match="affinity vocabulary"):
        TAllocate(mode="fused").execute(ssn)
    TClose(ssn)
    assert t_metrics.engine_demotions_total() == dem0
    assert not t.binder.calls


def test_auto_refuses_the_batched_regime():
    spec = TSpec(n_nodes=8, n_groups=130, pods_per_group=4,
                 pod_cpu_millis=100, pod_mem_bytes=GiB)
    t = Side(True, spec)
    ssn = TOpen(t.cache, t_tiers())
    with pytest.raises(NotImplementedError, match="batched"):
        TAllocate(mode="auto").execute(ssn)
    assert not t.binder.calls
    TClose(ssn)
