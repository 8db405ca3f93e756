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
                 "kubebatch_tpu_torch.kernels.solver",
                 "kubebatch_tpu_torch.actions.allocate",
                 "kubebatch_tpu_torch.cache.cache",
                 "kubebatch_tpu_torch.interop",
                 "kubebatch_tpu_torch.sim.cluster"):
        assert must in mods


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


def test_incremental_snapshot_is_refused():
    from kubebatch_tpu_torch.cache import SchedulerCache

    with pytest.raises(NotImplementedError, match="event fold"):
        SchedulerCache(device="cpu", incremental_snapshot=True)


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
