"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports torch and the port only (no jax), so it runs on a machine with an
NVIDIA GPU and without jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py

Every case needs a CUDA device and skips without one. Tolerance 0: the
kernels repeat the plain versions' float32 operations in the same order
(built with -fmad=false), so outputs are compared bit for bit.
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
from kubebatch_tpu_torch.kernels.fused import (fused_allocate,
                                               fused_allocate_plain)
from kubebatch_tpu_torch.kernels.solver import (dynamic_node_score,
                                                dynamic_node_score_plain)
from kubebatch_tpu_torch.objects import BACKFILL_ANNOTATION
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
