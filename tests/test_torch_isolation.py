"""The port stands alone: no jax, nothing of the reference package, and no
quiet fall back to the CPU.

Imports happen in a fresh interpreter with ``sys.modules["jax"] = None``,
so any ``import jax`` anywhere in the port (or in chip_smoke.py) fails
there. The reference package is matched by exact module name: the port's
own name starts with the string ``kubebatch_tpu``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None
sys.path.insert(0, sys.argv[1])
import kubebatch_tpu_torch
names = ["kubebatch_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(kubebatch_tpu_torch.__path__,
                                          "kubebatch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "kubebatch_tpu" or m.startswith("kubebatch_tpu.")
                or m == "jax" and sys.modules[m] is not None
                or m.startswith("jax."))
print(json.dumps({"imported": names, "leaked": leaked}))
"""


def test_port_imports_without_jax_or_reference_package():
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO.parent), env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == []
    mods = set(res["imported"])
    for must in ("kubebatch_tpu_torch.kernels.fused",
                 "kubebatch_tpu_torch.kernels.batched",
                 "kubebatch_tpu_torch.kernels.xla_order",
                 "kubebatch_tpu_torch.actions.allocate_batched",
                 "kubebatch_tpu_torch.kernels.solver",
                 "kubebatch_tpu_torch.actions.allocate",
                 "kubebatch_tpu_torch.runtime.pipeline",
                 "kubebatch_tpu_torch.cache.cache",
                 "kubebatch_tpu_torch.interop",
                 "kubebatch_tpu_torch.sim.cluster",
                 "kubebatch_tpu_torch.kernels.victims",
                 "kubebatch_tpu_torch.actions.preempt",
                 "kubebatch_tpu_torch.actions.reclaim",
                 "kubebatch_tpu_torch.actions.backfill",
                 "kubebatch_tpu_torch.kernels.affinity",
                 "kubebatch_tpu_torch.kernels.terms",
                 "kubebatch_tpu_torch.actions.cycle_inputs",
                 "kubebatch_tpu_torch.kernels.mega",
                 "kubebatch_tpu_torch.rpc.wire",
                 "kubebatch_tpu_torch.rpc.client",
                 "kubebatch_tpu_torch.rpc.server",
                 "kubebatch_tpu_torch.tenantsvc.admission",
                 "kubebatch_tpu_torch.tenantsvc.megasolve",
                 "kubebatch_tpu_torch.tenantsvc.service",
                 "kubebatch_tpu_torch.tenantsvc.sessions",
                 "kubebatch_tpu_torch.sim.tenants",
                 "kubebatch_tpu_torch.parallel",
                 "kubebatch_tpu_torch.parallel.mesh",
                 "kubebatch_tpu_torch.parallel.worker",
                 "kubebatch_tpu_torch.kernels.batched_sharded",
                 "kubebatch_tpu_torch.kernels.sharded",
                 "kubebatch_tpu_torch.kernels.hier",
                 "kubebatch_tpu_torch.kernels.telemetry"):
        assert must in mods


_NO_WIRE_LIBS = r"""
import importlib, json, pkgutil, sys
for blocked in ("jax", "grpc", "google.protobuf"):
    sys.modules[blocked] = None
sys.path.insert(0, sys.argv[1])
import kubebatch_tpu_torch
names = ["kubebatch_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(kubebatch_tpu_torch.__path__,
                                          "kubebatch_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from kubebatch_tpu_torch.rpc import wire
req = wire.SnapshotRequest(gang_enabled=True)
req.nodes.names = ["n0"]
raw = req.SerializeToString()
assert wire.SnapshotRequest.FromString(raw) == req
loaded = sorted(m for m in sys.modules
                if sys.modules[m] is not None
                and (m.split(".")[0] == "grpc"
                     or m.startswith("google.protobuf")))
print(json.dumps({"loaded": loaded, "n": len(names)}))
"""


def test_port_imports_neither_protobuf_nor_grpc():
    """Every module of the port (the wire codec and the tenant service
    among them) and chip_smoke.py import with grpc and protobuf blocked,
    and the codec works without them."""
    env = {**os.environ, "PYTHONPATH": ""}
    out = subprocess.run([sys.executable, "-c", _NO_WIRE_LIBS, str(REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO.parent), env=env)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["loaded"] == [] and res["n"] > 40


def test_no_environment_variable_steers_the_port():
    """Devices, engines and decisions are arguments, never environment
    variables: the only read of the environment is the CUDA toolkit's
    location for the kernel build."""
    readers = []
    for path in sorted((REPO / "kubebatch_tpu_torch").rglob("*.py")) + [
            REPO / "chip_smoke.py"]:
        for k, line in enumerate(path.read_text().splitlines(), 1):
            if "environ" in line or "getenv" in line:
                readers.append((path.relative_to(REPO).as_posix(), line))
    assert all(p == "kubebatch_tpu_torch/kernels/_build.py"
               and "CUDA_HOME" in line for p, line in readers), readers


def test_default_device_is_the_card_and_raises_without_one(monkeypatch):
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.device import resolve_device
    from kubebatch_tpu_torch.kernels.solver import DeviceSession

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SchedulerCache()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceSession({})
    with pytest.raises(RuntimeError):
        resolve_device("cuda:0")
    assert SchedulerCache(device="cpu").device.type == "cpu"
    assert DeviceSession({}, device="cpu").idle.device.type == "cpu"


def test_incremental_snapshot_is_the_default():
    """The cache folds events by default, as the reference does;
    ``incremental_snapshot=False`` is the snapshot-primary mode."""
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.objects import Node, Queue

    for kw, folded in (({}, True), ({"incremental_snapshot": False}, False)):
        cache = SchedulerCache(device="cpu", async_writeback=False, **kw)
        assert cache.fold.enabled is folded
        cache.add_queue(Queue(name="q"))
        cache.add_node(Node(name="n0", allocatable={"cpu": "1"}))
        assert cache.fold.dirty_nodes == ({"n0"} if folded else set())
        assert cache.snapshot().refreshed_jobs is None   # first: full


def test_chip_smoke_fails_without_a_card():
    """chip_smoke.py exits non-zero and prints no result when there is no
    CUDA device."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    out = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         cwd=str(REPO))
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
