"""The port's device kernels against the reference package's, on the CPU.

Same inputs (seeded numpy, or the cycle arrays the reference package
builds for a cluster) go through the reference's jitted function and the
port's counterpart. Tolerance 0 throughout: every float operation of the
port's plain versions is the same IEEE float32 operation, in the same
order, as the reference's (XLA on the CPU contracts nothing here), so
results are compared bit for bit and decisions word for word.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""
from __future__ import annotations

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401  (registers actions)
import kubebatch_tpu.plugins  # noqa: E402,F401  (registers plugins)
from kubebatch_tpu.actions.allocate_fused import (_fused_packed,  # noqa: E402
                                                  prepare_fused)
from kubebatch_tpu.actions.cycle_inputs import build_cycle_inputs  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers  # noqa: E402
from kubebatch_tpu.framework import OpenSession  # noqa: E402
from kubebatch_tpu.objects import BACKFILL_ANNOTATION  # noqa: E402
from kubebatch_tpu.kernels.solver import \
    dynamic_node_score as j_dynamic_node_score  # noqa: E402
from kubebatch_tpu.kernels.telemetry import \
    decision_frame as j_decision_frame  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS, ClusterSpec, build_cluster  # noqa: E402
from kubebatch_tpu_torch.interop import (NODE_FIELDS,  # noqa: E402
                                         cycle_inputs_from_numpy,
                                         device_state_from_numpy)
from kubebatch_tpu_torch.kernels import _build  # noqa: E402
from kubebatch_tpu_torch.kernels.fused import (CYCLE_ARGS,  # noqa: E402
                                               fused_allocate,
                                               unpack_host_block)
from kubebatch_tpu_torch.kernels.solver import dynamic_node_score  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import decision_frame  # noqa: E402

GiB = 1024 ** 3
STATIC_KEYS = ("job_keys", "queue_keys", "gang_enabled", "prop_overused",
               "dyn_enabled", "max_iters", "narrow", "narrow_gate")


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint8)


def _assert_bitwise(ref, got, what):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert ref.shape == got.shape and ref.dtype == got.dtype, \
        (what, ref.shape, got.shape, ref.dtype, got.dtype)
    same = (_bits(ref).reshape(ref.size, -1)
            == _bits(got).reshape(got.size, -1)).all(axis=1)
    if not same.all():
        i = int(np.argmin(same))
        raise AssertionError(f"{what}: flat index {i} differs: reference "
                             f"{ref.ravel()[i]!r}, port {got.ravel()[i]!r}")


def _score_inputs(seed: int, n: int = 4096):
    """Seeded node-score inputs plus edge rows: cap 0, req past cap, a
    request exactly at capacity (frac 1.0), and requests a hair under it."""
    rng = np.random.default_rng(seed)
    cap = np.stack([rng.choice([4000.0, 8000.0, 9600.0, 6400.0], n),
                    rng.choice([16384.0, 13107.2, 19660.8, 8192.0], n)],
                   axis=1).astype(np.float32)
    cap *= rng.uniform(0.8, 1.2, (n, 2)).astype(np.float32)
    nz = (cap * rng.uniform(0.0, 1.1, (n, 2)).astype(np.float32))
    t_nz = np.asarray([1000.0 * rng.uniform(0.8, 1.2),
                       2048.0 * rng.uniform(0.8, 1.2)], np.float32)
    # edge rows
    cap[0] = 0.0                       # no allocatable at all
    cap[1, 0] = 0.0                    # cpu-less node
    nz[2] = cap[2] + 1.0               # request already past capacity
    nz[3] = cap[3] - t_nz              # frac exactly 1.0 after the task
    nz[4] = np.nextafter(cap[4] - t_nz, np.float32(0.0))
    nz[5] = 0.0
    weights = np.asarray([1.0, 1.0], np.float32)
    return nz.astype(np.float32), t_nz, cap, weights


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dynamic_node_score_matches_reference(seed):
    nz, t_nz, cap, w = _score_inputs(seed)
    ref = np.asarray(j_dynamic_node_score(
        jnp.asarray(nz), jnp.asarray(t_nz), jnp.asarray(cap),
        jnp.asarray(w)))
    got = dynamic_node_score(torch.from_numpy(nz), torch.from_numpy(t_nz),
                             torch.from_numpy(cap), torch.from_numpy(w))
    _assert_bitwise(ref, got.numpy(), "dynamic_node_score")
    # the edge rows exercise every branch of the score
    assert ref[0] == 0.0 and ref[2] == 0.0


@pytest.mark.parametrize("seed", [0, 1])
def test_decision_frame_matches_reference(seed):
    rng = np.random.default_rng(seed)
    t = 256
    state = rng.integers(0, 5, t).astype(np.int32)
    valid = rng.random(t) < 0.8
    seq = rng.integers(0, 400, t).astype(np.int32)
    seq[state == 0] = np.iinfo(np.int32).max
    for stride, narrow, gate in ((100, False, False), (1, True, False),
                                 (1000, False, True)):
        ref = np.asarray(j_decision_frame(
            3, jnp.asarray(state), jnp.asarray(seq), jnp.asarray(valid),
            waves=jnp.int32(77), stride=stride, narrow=narrow,
            narrow_gate=gate))
        got = decision_frame(3, torch.from_numpy(state),
                             torch.from_numpy(seq), torch.from_numpy(valid),
                             waves=77, stride=stride, narrow=narrow,
                             narrow_gate=gate)
        _assert_bitwise(ref, got.numpy(), f"decision_frame stride={stride}")


def prep_fill(sim, kind):
    """Turn every other running fill pod into a terminating pod
    ("releasing": its node carries releasing capacity, so a task that
    fits only there is pipelined) or a lendable backfill pod ("backfill":
    its capacity counts as backfilled, so a task that fits only over it
    is AllocatedOverBackfill)."""
    fill = [p for p in sim.pods if p.name.startswith("fill-")]
    for pod in fill[::2]:
        if kind == "releasing":
            pod.deletion_timestamp = 1.0
        else:
            pod.annotations[BACKFILL_ANNOTATION] = "true"
    return sim


def _reference_cycle(spec, prep=None):
    """The reference package's fused cycle: its CycleInputs, the exact
    dispatch arguments, and its results (as numpy)."""
    sim = build_cluster(spec)
    if prep:
        prep_fill(sim, prep)
    cache = SchedulerCache(async_writeback=False, incremental_snapshot=False)
    sim.populate(cache)
    ssn = OpenSession(cache, shipped_tiers())
    inputs = build_cycle_inputs(ssn)
    args, statics = prepare_fused(inputs)
    out = [np.asarray(x) for x in _fused_packed(*args, **statics)]
    node = {k: np.asarray(getattr(inputs.device, k)) for k in NODE_FIELDS}
    cycle = {k: getattr(inputs, k) for k in CYCLE_ARGS}
    return node, cycle, {k: statics[k] for k in STATIC_KEYS}, out


REDUCED3 = ClusterSpec(n_nodes=64, n_groups=160, pods_per_group=4,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=800, pod_mem_bytes=GiB)
REDUCED5 = ClusterSpec(n_nodes=48, n_groups=56, pods_per_group=8,
                       n_queues=4, queue_weights=(1, 2, 3, 4),
                       pod_cpu_millis=1000, pod_mem_bytes=2 * GiB,
                       jitter=0.2, seed=5)
#: a nearly full cluster (with prep_fill: pipelined / over-backfill tasks)
FILLED = ClusterSpec(n_nodes=16, n_groups=24, pods_per_group=4,
                     min_member=2, running_fill=0.9, n_queues=2,
                     queue_weights=(1, 3), pod_cpu_millis=1000,
                     pod_mem_bytes=GiB, seed=7)
#: (id, spec, prep_fill kind, decision code the case must produce)
CASES = [("cfg1", BASELINE_SPECS[1], None, 1),
         ("cfg2", BASELINE_SPECS[2], None, 1),
         ("t", BASELINE_SPECS["t"], None, 1),
         ("reduced3", REDUCED3, None, 1),
         ("reduced5", REDUCED5, None, 4),
         ("pipelined", FILLED, "releasing", 3),
         ("over_backfill", FILLED, "backfill", 2)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_fused_allocate_matches_reference(case):
    _, spec, prep, must_see = case
    node, cycle, statics, ref = _reference_cycle(spec, prep)
    got = fused_allocate(**device_state_from_numpy(node, "cpu"),
                         **cycle_inputs_from_numpy(cycle, "cpu"), **statics)
    names = ("host_block", "idle", "releasing", "n_tasks", "nz_req")
    for r, g, name in zip(ref, got, names):
        _assert_bitwise(r, g.numpy(), name)
    state, _, _, iters, telem = unpack_host_block(got[0].numpy())
    assert iters > 0 and telem[0] == 3
    assert (state == must_see).any(), f"no decision {must_see} in the case"


def test_fused_allocate_narrow_scores_match_reference(monkeypatch):
    """The reference's narrow (bfloat16) score store, forced on: its
    integer scores round-trip exactly, so the port, reading them at
    float32, gives the same decisions and the same telemetry words."""
    monkeypatch.setenv("KUBEBATCH_NARROW", "1")
    node, cycle, statics, ref = _reference_cycle(REDUCED5)
    assert statics["narrow"]
    got = fused_allocate(**device_state_from_numpy(node, "cpu"),
                         **cycle_inputs_from_numpy(cycle, "cpu"), **statics)
    for r, g in zip(ref, got):
        _assert_bitwise(r, g.numpy(), "narrow")


def test_fused_allocate_rejects_mixed_devices():
    node, cycle, statics, _ = _reference_cycle(BASELINE_SPECS[1])
    args = {**device_state_from_numpy(node, "cpu"),
            **cycle_inputs_from_numpy(cycle, "cpu")}
    args["idle"] = args["idle"].to("meta")
    with pytest.raises(ValueError, match="mixed devices"):
        fused_allocate(**args, **statics)


def test_fused_plain_matches_reference_on_a_drain_case():
    """The yardstick in the regime the cluster kernel collapses: a tiny
    hand-built problem (tests/test_torch_cuda.py fused_edge_case) whose
    queues end in long job-less runs, queue 0 overused, max_iters cut
    five iterations inside the last run; the plain version bitwise the
    reference's."""
    from kubebatch_tpu.kernels.fused import fused_allocate as j_fused
    from kubebatch_tpu_torch.kernels.fused import fused_allocate_plain

    from .test_torch_cuda import fused_edge_case

    arrays, statics = fused_edge_case(0, "drain", n=24, t=64, j=16, q=3)
    args = {k: torch.from_numpy(v) for k, v in arrays.items()}
    whole = fused_allocate_plain(**args, **statics)
    iters = int(whole[0][0, -21])
    statics = dict(statics, max_iters=iters - 5)
    got = fused_allocate_plain(**args, **statics)
    ref = j_fused(**{k: jnp.asarray(v) for k, v in arrays.items()},
                  **statics)
    for r, g, name in zip(ref, got, ("host_block", "idle", "releasing",
                                     "n_tasks", "nz_req")):
        _assert_bitwise(np.asarray(r), g.numpy(), name)
    state, _, _, it, _ = unpack_host_block(got[0].numpy())
    assert it == iters - 5
    # the cut fell inside a run: every decision is the uncut loop's
    assert np.array_equal(got[0].numpy()[:, :-21], whole[0].numpy()[:, :-21])
    # queue 0 ended past its tiny deserved share: its pops were overused
    placed = (state >= 1) & (state <= 3)
    tj = arrays["task_job"]
    q0 = np.zeros_like(placed)
    mine = (tj >= 0) & (tj < 16)
    q0[mine] = arrays["job_queue"][tj[mine]] == 0
    taken = arrays["resreq"][placed & q0].sum(axis=0)
    assert (taken > arrays["q_deserved"][0]).any()


def test_failed_build_raises(monkeypatch, tmp_path):
    """No nvcc, no silent fallback: building the kernels raises."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at the default location")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
