"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/*.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` into ``build/kubebatch_tpu_torch/``
under the repository root. A library is rebuilt when the hash of its
source, the headers in ``csrc/`` and the flags changes; all stale sources
compile in parallel (one nvcc each). Nothing here runs at import: the
first call of :func:`library` builds. A failed build raises.

Flags: ``-fmad=false`` keeps every multiply and add a separate IEEE
operation (nvcc contracts ``a * b + c`` into an FMA by default, which
rounds differently from the plain PyTorch versions and flips integer
node scores); there is deliberately no ``--use_fast_math``.

Every wrapper that launches a kernel adds one to its launch count here
(:func:`count_launch`), and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kubebatch_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

#: source file -> exported C functions and their ctypes argument kinds
#: ("p" pointer, "i" int); every entry point returns the cudaError_t of
#: its launch as an int
EXPORTS: Dict[str, Dict[str, str]] = {
    "node_score.cu": {
        "kb_dynamic_node_score": "p" * 5 + "i" + "p",
    },
    "fused_allocate.cu": {
        "kb_fused_allocate": "p" * 35 + "i" * 16 + "p",
        "kb_fused_shape": "i" * 5 + "p",
    },
    "mega_fused.cu": {
        "kb_mega_fused": "p" * 35 + "i" * 18 + "p",
        "kb_mega_shape": "i" * 6 + "p",
    },
    "batched_allocate.cu": {
        "kb_batched_workspace": "pip",
        "kb_batched_allocate": "pipipp",
    },
    "hier_allocate.cu": {
        "kb_hier_workspace": "pppp",
        "kb_hier_allocate": "pppppppp",
        "kb_hier_route_limits": "p",
    },
    "victims.cu": {
        "kb_victims_workspace": "iii",
        "kb_victims_resident": "iii",
        "kb_victims": "ppp",
    },
    "scatter_rows.cu": {
        "kb_scatter_rows": "pii" + "p" * 9,
    },
    "allocate_scan.cu": {
        "kb_allocate_scan": "p" * 21 + "i" * 5 + "pp",
        "kb_allocate_scan_shape": "ip",
    },
    "chain_probe.cu": {
        "kb_grid_probe": "ippp",
        "kb_cluster_probe": "iippp",
    },
    "sharded_round.cu": {
        "kb_sharded_workspace": "pipp",
        "kb_sharded_round": "pipi" + "iiii" + "pppp",
    },
    "sharded_scan.cu": {
        "kb_sharded_scan": "pipi" + "pppp",
        "kb_sharded_scan_shape": "iip",
    },
    "explain_counts.cu": {
        "kb_explain_counts": "p" * 10 + "i" * 5 + "p" * 3,
        "kb_explain_shape": "i" * 4 + "p",
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_launches: Dict[str, int] = {}
#: per-source build seconds and ptxas report of the last build
build_log: Dict[str, dict] = {}


def count_launch(name: str) -> None:
    _launches[name] = _launches.get(name, 0) + 1


def launch_count(name: str) -> int:
    return _launches.get(name, 0)


def reset_launch_counts() -> None:
    _launches.clear()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _digest(src: Path) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for f in [src] + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def _target(src: Path) -> Path:
    return BUILD_DIR / f"lib{src.stem}_{_digest(src)}.so"


def build_all(names=None) -> Dict[str, float]:
    """Compile every stale source (of ``names``, default all) in
    parallel. Returns per-source build seconds (0.0 for an up-to-date
    library)."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = []
    out: Dict[str, float] = {}
    for name in (EXPORTS if names is None else names):
        src = CSRC / name
        target = _target(src)
        if target.exists():
            out[name] = 0.0
            continue
        nvcc = nvcc or nvcc_path()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, target, tmp, time.perf_counter(),
                      subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)))
    errors: List[str] = []
    for name, target, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        out[name] = time.perf_counter() - t0
        build_log[name] = {"seconds": out[name], "log": log}
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):"
                          f"\n{log}")
            continue
        os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(source: str) -> ctypes.CDLL:
    """The loaded library for ``source`` (a file name in ``csrc/``),
    building every stale source first when its own is stale; loads every
    built library."""
    with _lock:
        lib = _libs.get(source)
        if lib is not None:
            return lib
        if not _target(CSRC / source).exists():
            build_all()
        for name, funcs in EXPORTS.items():
            if name in _libs or not _target(CSRC / name).exists():
                continue
            loaded = ctypes.CDLL(str(_target(CSRC / name)))
            for fn, kinds in funcs.items():
                f = getattr(loaded, fn)
                f.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                              for k in kinds]
                f.restype = ctypes.c_int
            _libs[name] = loaded
        return _libs[source]


def check_launch(name: str, err: int) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
