"""Device health probe (ref: kubebatch_tpu/runtime/watchdog.py).

A wedged accelerator can block a device query forever, so the probe runs
one CUDA operation in a SUBPROCESS the parent can abandon: on timeout the
child is killed best-effort and left un-waited (start_new_session keeps
it out of this process group). ``midrun_probe`` is the between-cycles
form the degradation ladder (faults.py) calls before re-promoting onto a
device engine. A CPU cache has no device to probe and answers True
without a subprocess (the reference skips its probe through a setting;
here the device says so).
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from typing import Tuple

import torch

from ..device import DeviceLike

PROBE_SRC = ("import torch; "
             "print(float(torch.ones((), device='cuda').sum().item()))")


def probe_backend(timeout: float = 60.0,
                  probe_src: str = PROBE_SRC) -> Tuple[str, str]:
    """Run the device probe in an abandonable subprocess. Returns
    (status, detail): status is "ok" | "timeout" | "error"; detail is the
    child's output for "ok", the tail of its stderr for "error". Output
    goes to temp files, not pipes, so a chatty child cannot block."""
    with tempfile.TemporaryFile(mode="w+") as out_f, \
            tempfile.TemporaryFile(mode="w+") as err_f:
        proc = subprocess.Popen([sys.executable, "-c", probe_src],
                                stdout=out_f, stderr=err_f,
                                start_new_session=True)
        try:
            proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()   # pends if the child is in D state; do NOT reap
            return "timeout", ""
        out_f.seek(0)
        err_f.seek(0)
        if proc.returncode == 0:
            return "ok", out_f.read().strip() or "unknown"
        return "error", err_f.read().strip()[-400:]


def midrun_probe(device: DeviceLike = "cuda", timeout: float = 20.0,
                 probe_src: str = PROBE_SRC) -> bool:
    """Between-cycles health probe: True when the card answers one CUDA
    operation within ``timeout`` seconds. A CPU ``device`` answers True
    at once."""
    if torch.device(device).type != "cuda":
        return True
    status, _ = probe_backend(timeout, probe_src)
    return status == "ok"
