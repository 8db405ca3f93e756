"""Times the round kernels' chain on one NVIDIA GPU against another
build of the same kernels, on the same inputs.

    python3 chain_timing.py --before DIR [--out build/chain_timing/report.json]

DIR is an unpacked checkout of an earlier commit; its
kubebatch_tpu_torch/kernels/csrc/batched_allocate.cu and hier_allocate.cu
are built into build/chain_timing/before/, beside this checkout's sources
built as the port builds them and once more from a copy whose
batched_round.cuh sets GRID_CHAIN_MIN and GRID_JOBS_MIN to 0, so every
task view, job axis and node window takes the grid chain
(build/chain_timing/grid/). The launch
inputs are recorded once from the port's own allocate cycles on the card
(cfg5 cold through prepare_batched; 5p and 3p cold, the batched kernel
with the affinity carry; cfg6 cold, three cfg6 churn cycles on the active
set at grains 256, 1,024 and 4,096, cfg7 cold, the two-level kernel), then each
launch runs with each build in the order before, after, after, before:
every build's results must equal the earlier build's word for word, and
each is timed with CUDA events (best of its runs) beside its per-phase
device timers. The grid-barrier probe of csrc/chain_probe.cu runs last.
Prints one JSON line and writes it to --out. Needs torch with CUDA and
nvcc; imports nothing of jax or the reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("batched_allocate.cu", "hier_allocate.cu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def grid_sources(csrc: str) -> str:
    """A copy of csrc/ with the round chain's thresholds (batched_round.cuh
    GRID_CHAIN_MIN, GRID_JOBS_MIN) set to 0: every task view, job axis and
    node window on the grid chain."""
    out = os.path.join(HERE, "build", "chain_timing", "grid_src")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "batched_round.cuh")
    with open(path) as f:
        text, n = re.subn(r"constexpr int (GRID_CHAIN_MIN|GRID_JOBS_MIN) = "
                          r"\d+;", r"constexpr int \1 = 0;", f.read())
    if n != 2:
        raise RuntimeError("batched_round.cuh: the thresholds not found")
    with open(path, "w") as f:
        f.write(text)
    return out


def start_builds(csrc: str, tag: str) -> list:
    from kubebatch_tpu_torch.kernels import _build

    out_dir = os.path.join(HERE, "build", "chain_timing", tag)
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in SOURCES:
        target = os.path.join(out_dir, f"lib{src[:-3]}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target,
               os.path.join(csrc, src)]
        procs.append((src, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


def finish_builds(procs) -> dict:
    from kubebatch_tpu_torch.kernels import _build

    libs = {}
    for src, target, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {target}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {target}: {line.strip()}")
        lib = ctypes.CDLL(target)
        for fn, kinds in _build.EXPORTS[src].items():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                          for k in kinds]
            f.restype = ctypes.c_int
        libs[src] = lib
    return libs


def record_inputs(dev) -> list:
    """(label, kind, kwargs) of each launch, from the port's own cycles."""
    import chip_smoke as cs
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import activeset
    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    calls = []
    kw, statics = cs.build_batched_inputs(5, dev)
    calls.append(("cfg5 cold", "batched", {**kw, **statics}))
    for label in ("5p", "3p"):
        sim = build_cluster(BASELINE_SPECS[label])
        cache = SchedulerCache(device=dev, binder=NullBinder(),
                               async_writeback=False)
        sim.populate(cache)
        with cs.Recorder(batched_mod, "batched_allocate") as rec:
            ssn = OpenSession(cache, shipped_tiers())
            AllocateAction(mode="auto").execute(ssn)
            CloseSession(ssn)
        kw, _ = cs.copy_call(*rec.calls[0])
        calls.append((f"{label} cold", "batched", kw))
        cache.stop()
    activeset.reset()
    activeset.set_audit_every(0)
    tiers, actions = shipped_tiers(), CONFIG_ACTIONS[6]
    for label in (6, 7):
        sim = build_cluster(BASELINE_SPECS[label])
        binder = cs.FreshBinder()
        cache = SchedulerCache(binder=binder, async_writeback=False,
                               device=dev)
        sim.populate(cache)
        with cs.SolveRecorder() as rec:
            cs.run_cycle(cache, tiers, actions)
            churns = (256, 1024, 4096) if label == 6 else ()
            for k, n in enumerate(churns):
                binder.kubelet_tick(cache)
                sim.churn_tick(cache, n, arrival_queue=(0, 3)[k % 2])
                cs.run_cycle(cache, tiers, actions)
        names = [f"cfg{label} cold"] + [f"cfg{label} churn {n}"
                                          for n in churns]
        for name, c in zip(names, rec.calls):
            kw, _ = cs.copy_call(c["kw"], c["out"])
            calls.append((name, c["kind"], kw))
        cache.stop()
    activeset.set_audit_every(16)
    return calls


def launch(kind, kw):
    from kubebatch_tpu_torch.kernels import activeset
    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import hier as hier_mod

    if kind == "batched":
        out = batched_mod.batched_allocate(**kw)
        return out, batched_mod.last_launch
    fn = hier_mod.hier_packed if kind == "hier" else activeset.activeset_packed
    return fn(**kw), hier_mod.last_launch


def flat(out) -> list:
    got = []
    for o in out:
        if isinstance(o, dict):
            got += [o[k] for k in sorted(o) if o[k] is not None]
        elif o is not None:
            got.append(o)
    return [g.detach().cpu().contiguous() for g in got]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--before", required=True)
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "chain_timing", "report.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("chain_timing: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import kubebatch_tpu_torch.actions  # noqa: F401
    import kubebatch_tpu_torch.plugins  # noqa: F401
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import hier as hier_mod

    dev = torch.device("cuda")
    report = {"card": cs.card_line(), "kind": torch.cuda.get_device_name(0)}
    t0 = time.perf_counter()
    before = start_builds(os.path.join(os.path.abspath(args.before),
                                       "kubebatch_tpu_torch", "kernels",
                                       "csrc"), "before")
    grid = start_builds(grid_sources(str(_build.CSRC)), "grid")
    _build.build_all()
    for src in SOURCES:
        _build.library(src)
    libs = {"after": {s: _build._libs[s] for s in SOURCES},
            "before": finish_builds(before), "grid": finish_builds(grid)}
    report["build_s"] = time.perf_counter() - t0
    log(f"builds {report['build_s']:.1f} s; {report['card']}")

    def use(which):
        for s in SOURCES:
            _build._libs[s] = libs[which][s]

    use("after")
    t0 = time.perf_counter()
    calls = record_inputs(dev)
    log(f"inputs recorded in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(c[0] for c in calls))
    names = {"batched": batched_mod.PHASES,
             "hier": batched_mod.PHASES + hier_mod.HIER_PHASES}
    rows = []
    for label, kind, kw in calls:
        res, times, phases = {}, {}, {}
        order = ["before", "after", "after", "before", "grid", "grid"]
        for which in order:
            use(which)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out, last = launch(kind, kw)
            end.record()
            torch.cuda.synchronize()
            ms = start.elapsed_time(end)
            times.setdefault(which, []).append(ms)
            got = flat(out)
            if which not in res:
                res[which] = got
                pn = last["phase_ns"].cpu().tolist()
                keys = names["batched" if kind == "batched" else "hier"]
                phases[which] = {k: v / 1e6 for k, v in zip(keys, pn) if v}
        equal = {}
        for which in ("after", "grid"):
            equal[which] = len(res[which]) == len(res["before"]) and all(
                a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                for a, b in zip(res[which], res["before"]))
        t = kw["task_valid"].shape[0] if "task_valid" in kw else None
        row = {"label": label, "kind": kind, "t_pad": t,
               "ms": {k: min(v) for k, v in times.items()},
               "runs_ms": times, "equal_to_before": equal,
               "phase_ms": phases}
        rows.append(row)
        log(f"{label} ({kind}, T_pad {t}): ms "
            + json.dumps({k: round(v, 3) for k, v in row["ms"].items()})
            + f"; equal to before {json.dumps(equal)}")
        for which in ("before", "after", "grid"):
            log(f"  {which} phases: "
                + json.dumps({k: round(v, 3)
                              for k, v in phases[which].items()}))
    use("after")
    report["launches"] = rows
    report["grid_barrier"] = cs.grid_barrier_us()
    log(f"grid barrier: {json.dumps(report['grid_barrier'])}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    bad = [r["label"] for r in rows
           if not all(r["equal_to_before"].values())]
    if bad:
        log(f"results differ from the earlier build: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
