"""Times the round kernels' chain on one NVIDIA GPU against another
build of the same kernels, on the same inputs.

    python3 chain_timing.py --before DIR
        [--set small,round,sharded,scan,explain]
        [--only-before] [--out build/chain_timing/report.json]

DIR is an unpacked checkout of an earlier commit; its
kubebatch_tpu_torch/kernels/csrc/batched_allocate.cu and hier_allocate.cu
(the sets small and round), sharded_round.cu (the set sharded),
sharded_scan.cu (scan) and explain_counts.cu (explain) are built into
build/chain_timing/before/, beside this checkout's sources built as the
port builds them. The launch inputs are recorded once from
the port's own allocate cycles on the card, then each launch runs with
each build in turns; every build's results (packed result, frame, node
carry) must equal the earlier build's word for word, and each is timed
with CUDA events (best of its runs) and the profiler (device ms) beside
its per-phase device timers and the barriers it passed (hier_allocate's
last phase_ns word; an earlier build without that word reads 0).

The sets:

- ``round`` (the round chain): cfg5 cold through prepare_batched, 5p and
  3p cold (the batched kernel with the affinity carry), cfg6 and cfg7
  cold (the two-level kernel), in the order before, after, after,
  before, then a copy whose batched_round.cuh sets GRID_CHAIN_MIN and
  GRID_JOBS_MIN to 0 (every task view, job axis and node window on the
  grid chain; build/chain_timing/grid/);
- ``small`` (the small-view launches of csrc/hier_allocate.cu): cfg6
  cold, then six skewed churn cycles at grains 256, 256, 1,024, 1,024,
  4,096 and 4,096 with the audit on cycles 0 and 3 (chip_smoke.py phase
  (g)'s cycles), the in-place twin of each active-set launch
  (``activeset_packed_inplace`` on a copy of the carry, put back before
  each launch), and cfg7 cold and one churn-256 cycle (the coarse pass
  over 100,000 nodes). Each runs before, after, after, before, then this
  build with the route forced to the grid (``launch(route="grid")``),
  to the cluster and to a cluster of 8 CTAs, then the variants of VARIANTS
  (hier_allocate.cu rebuilt with other settings);
- ``sharded`` (csrc/sharded_round.cu, rows 10, 10a and 8m): the
  sharded inputs (batched_sharded.prepare_sharded) of the port's cold
  cycles on the card, cfg5 at k = 2 and 4 ranks, 5p and 3p at k = 2
  (the affinity branch), cfg6 at k = 2 through the two-level steps;
  each solved by the k ranks in lock step in this process
  (batched_sharded.solve_lockstep / solve_hier_lockstep on "cuda": one
  stream, each launch alone on the card, the gathers device-side
  stacks), in the order before, after, after, before, after one warm-up
  solve of each build (its steps reported as ``first_solve``: the
  first launches of a freshly loaded library). The packed result, the
  node carry and the affinity [P,D] carry and port claims must equal
  the earlier build's word for word. Per rank and step: CUDA-event ms
  (each timed run), profiler device ms (one more run, each launch
  matched to its step in launch order), the in-kernel phase timers and
  the grid barriers passed (phase_ns after each launch; an earlier
  build that does not count them reads 0). cfg5's bound at each k
  (chip_smoke.sharded_bounds, from the one-card plain engine's counts).

- ``scan`` (csrc/sharded_scan.cu, row 11): chip_smoke.scan_args at T
  256 x N_pad 8,192 (phase (k)'s scan) and a cfg5-shaped cut of it
  (5,000 real nodes), each at k = 2 and 4 ranks, solved by
  sharded.scan_lockstep on "cuda" (one stream, each launch alone on the
  card) in the order before, after, after, before after one warm-up
  scan of each build. The six outputs must equal the earlier build's and
  the plain ranks' word for word. Per rank: CUDA-event ms over its 257
  launches (each timed run), the profiler's device ms (one more run, the
  k ranks' launches taken in turn), the phase timers (argmax, decision,
  pack; a build without them reads 0), the bound a launch
  (chip_smoke.sharded_scan_bounds) and this build's cluster
  (sharded.scan_shape);
- ``explain`` (csrc/explain_counts.cu, row 12): the explainer's
  arguments on fresh cold sessions of cfg5, 5p, 3p and phase (h1)'s
  saturated cfg4 (every pod pending, phase (h)'s full-width inputs),
  launched before, after, after, before: the [T, 6] counts equal to the
  earlier build's and the plain version's; CUDA-event ms (50 launches
  back to back, the wrapper's host work included) and the profiler's
  device ms (10 launches), this build's phase timers and launch shape,
  and the bound (chip_smoke.explain_bounds).

``--only-before`` times the earlier build and this build's grid route
alone (the parent's design, its phases and barriers), no cluster launch;
in the sharded, scan and explain sets, the earlier build alone. The barrier probes of
csrc/chain_probe.cu run last (the grid barrier, the cluster barrier at
8 and 16 CTAs); the report also gives each build's library sizes.
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
SHARDED_SOURCES = ("sharded_round.cu",)
SCAN_SOURCES = ("sharded_scan.cu",)
EXPLAIN_SOURCES = ("explain_counts.cu",)

#: the scan set's solves: (label, ranks, real nodes of the 8,192: None
#: for chip_smoke.scan_args' own mask, 5,000 for the cfg5-shaped cut)
SCAN = (("T256xN8192 k=2", 2, None), ("T256xN8192 k=4", 4, None),
        ("cfg5-shaped k=2", 2, 5000), ("cfg5-shaped k=4", 4, 5000))
SCAN_PHASES = ("argmax", "decision", "pack")

#: builds of csrc/sharded_scan.cu and csrc/explain_counts.cu beside this
#: one, each from a copy with one ``constexpr`` set to another value and
#: timed after the main sequence: the scan with 256 / 1,024 threads a CTA
#: (4 / 1 gathered rows a thread) and at most 4 CTAs a cluster; the
#: explainer with clusters of at most 1, 2, 4 and 8 CTAs
SCAN_VARIANTS = {"nt256": {"NT": 256}, "nt1024": {"NT": 1024},
                 "c4": {"kMaxCluster": 4}}
EXPLAIN_VARIANTS = {f"c{c}": {"kMaxCluster": c} for c in (1, 2, 4, 8)}

#: the explain set's inputs: (label, BASELINE_SPECS key, running_fill
#: or None), each a fresh session over a cold cache (every pod pending),
#: as chip_smoke.py phase (h) times cfg5 and 5p at full width; "cfg4"
#: is (h1)'s saturated cfg4 (its fresh-inputs launch)
EXPLAIN = (("cfg5", 5, None), ("5p", "5p", None), ("3p", "3p", None),
           ("cfg4", 4, 0.95))

#: the sharded set's solves: (label, BASELINE_SPECS key, ranks, through
#: the two-level steps)
SHARDED = (("cfg5 k=2", 5, 2, False), ("cfg5 k=4", 5, 4, False),
           ("5p k=2", "5p", 2, False), ("3p k=2", "3p", 2, False),
           ("cfg6 k=2", 6, 2, True))

#: builds of csrc/hier_allocate.cu beside this one, each from a copy with
#: one of the cluster route's settings (a ``constexpr`` of that name) set
#: to another value, timed on the cluster route: "rollback_cta0" keeps the
#: epilogue's rollback in CTA 0, "scan4096" keeps scans of up to 4,096
#: elements in CTA 0, "row1" / "row4" test one / four nodes a lane a
#: row-pass step
VARIANTS = {
    "row1": {"CLUSTER_ROW_UNROLL": 1},
    "row4": {"CLUSTER_ROW_UNROLL": 4},
    "rollback_cta0": {"CLUSTER_ROLLBACK_MIN": 1024},
    "scan4096": {"CLUSTER_SCAN_MAX": 4096},
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def patched_sources(csrc: str, tag: str, source: str, values: dict) -> str:
    """A copy of csrc/ (build/chain_timing/<tag>_src/) whose ``source``
    sets each ``constexpr`` named in ``values`` to its value."""
    out = os.path.join(HERE, "build", "chain_timing", f"{tag}_src")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, source)
    with open(path) as f:
        text = f.read()
    for name, value in values.items():
        text, n = re.subn(rf"constexpr (int|bool) {name} = \w+;",
                          rf"constexpr \1 {name} = {value};", text)
        if n != 1:
            raise RuntimeError(f"{source}: {name} not found once")
    with open(path, "w") as f:
        f.write(text)
    return out


def grid_sources(csrc: str) -> str:
    """A copy of csrc/ with the round chain's thresholds (batched_round.cuh
    GRID_CHAIN_MIN, GRID_JOBS_MIN) set to 0: every task view, job axis and
    node window on the grid chain."""
    return patched_sources(csrc, "grid", "batched_round.cuh",
                           {"GRID_CHAIN_MIN": 0, "GRID_JOBS_MIN": 0})


def start_builds(csrc: str, tag: str, sources=SOURCES) -> list:
    from kubebatch_tpu_torch.kernels import _build

    out_dir = os.path.join(HERE, "build", "chain_timing", tag)
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in sources:
        target = os.path.join(out_dir, f"lib{src[:-3]}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target,
               os.path.join(csrc, src)]
        procs.append((src, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    return procs


class EarlierHier:
    """An earlier build of csrc/hier_allocate.cu as kernels/hier.py
    calls it: a build from before the routes leaves the info array's
    route word 0, which reads back as the grid route it took."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def kb_hier_allocate(self, *args):
        err = self.lib.kb_hier_allocate(*args)
        info = ctypes.cast(args[6], ctypes.POINTER(ctypes.c_int))
        if info[3] == 0:
            info[3] = 1
        return err


def finish_builds(procs, earlier=False) -> dict:
    """The built libraries, their exports typed as the port types them
    (an earlier build may lack some; ``earlier`` wraps its
    hier_allocate.cu in EarlierHier)."""
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
            f = getattr(lib, fn, None)
            if f is None and earlier:
                continue
            f.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                          for k in kinds]
            f.restype = ctypes.c_int
        libs[src] = (EarlierHier(lib) if earlier
                     and src == "hier_allocate.cu" else lib)
    return libs


def record_round(dev) -> list:
    """(label, kind, kw) of the round set's cold launches."""
    import chip_smoke as cs
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
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
    tiers, actions = shipped_tiers(), CONFIG_ACTIONS[6]
    for label in (6, 7):
        sim = build_cluster(BASELINE_SPECS[label])
        cache = SchedulerCache(binder=cs.FreshBinder(), async_writeback=False,
                               device=dev)
        sim.populate(cache)
        with cs.SolveRecorder() as rec:
            cs.run_cycle(cache, tiers, actions)
        kw, _ = cs.copy_call(rec.calls[0]["kw"], rec.calls[0]["out"])
        calls.append((f"cfg{label} cold", "hier", kw))
        cache.stop()
    return calls


def record_small(dev) -> list:
    """(label, kind, kw) of the small set: cfg6's six churn cycles (the
    audit on cycles 0 and 3) and the in-place twin of each active-set
    launch, cfg7's churn-256 active-set launch. An audit's kw holds its
    three argument dicts under "node", "act" and "full"."""
    import chip_smoke as cs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, shipped_tiers
    from kubebatch_tpu_torch.kernels import activeset
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    calls = []
    tiers, actions = shipped_tiers(), CONFIG_ACTIONS[6]
    try:
        for label, churns, audit_every in (
                (6, (256, 256, 1024, 1024, 4096, 4096), 3), (7, (256,), 0)):
            activeset.reset()
            activeset.set_audit_every(audit_every)
            sim = build_cluster(BASELINE_SPECS[label])
            binder = cs.FreshBinder()
            cache = SchedulerCache(binder=binder, async_writeback=False,
                                   device=dev)
            sim.populate(cache)
            cs.run_cycle(cache, tiers, actions)
            with cs.SolveRecorder() as rec:
                for k, n in enumerate(churns):
                    binder.kubelet_tick(cache)
                    sim.churn_tick(cache, n, arrival_queue=(0, 3)[k % 2])
                    cs.run_cycle(cache, tiers, actions)
            for k, (n, c) in enumerate(zip(churns, rec.calls)):
                name = f"cfg{label} churn {k} ({n})"
                kw, _ = cs.copy_call(c["kw"], None)
                if c["kind"] == "audit":
                    node, act, full = cs.copy_call(c["args"], None)[0]
                    calls.append((name + " audit", "audit",
                                  {"node": node, "act": act, "full": full,
                                   "statics": kw}))
                    continue
                calls.append((name, c["kind"], kw))
                if c["kind"] == "activeset":
                    calls.append((name + " in place", "inplace", kw))
            cache.stop()
    finally:
        activeset.reset()
        activeset.set_audit_every(activeset.DEFAULT_AUDIT_EVERY)
    return calls


class Launcher:
    """Runs one recorded launch with the loaded build; an in-place launch
    first puts its carry back from the recorded copy."""

    CARRY = ("idle", "releasing", "n_tasks", "nz_req")

    def __init__(self, kind, kw):
        self.kind, self.kw = kind, kw
        if kind == "inplace":
            self.mine = dict(kw, **{k: kw[k].clone() for k in self.CARRY})

    def reset(self):
        if self.kind == "inplace":
            for k in self.CARRY:
                self.mine[k].copy_(self.kw[k])

    def __call__(self, **opts):
        from kubebatch_tpu_torch.kernels import activeset
        from kubebatch_tpu_torch.kernels import batched as batched_mod
        from kubebatch_tpu_torch.kernels import hier as hier_mod

        kind, kw = self.kind, self.kw
        if kind == "batched":
            return batched_mod.batched_allocate(**kw), batched_mod.last_launch
        if kind == "hier":
            out = hier_mod.hier_packed(**kw, **opts)
        elif kind == "activeset":
            out = activeset.activeset_packed(**kw, **opts)
        elif kind == "inplace":
            out = activeset.activeset_packed_inplace(**self.mine, **opts)
        else:
            out = activeset.activeset_audit_packed(
                kw["node"], kw["act"], kw["full"], **kw["statics"], **opts)
        return out, hier_mod.last_launch


def flat(out) -> list:
    got = []
    for o in out:
        if isinstance(o, dict):
            got += [o[k] for k in sorted(o) if o[k] is not None]
        elif o is not None:
            got.append(o)
    return [g.detach().cpu().contiguous() for g in got]


def t_pad(kind, kw):
    if kind == "audit":
        return {"act": kw["act"]["task_valid"].shape[0],
                "full": kw["full"]["task_valid"].shape[0]}
    return kw["task_valid"].shape[0]


def run_launch(label, kind, kw, configs, use, cs) -> dict:
    """Each config (name, build, launch options) in turn: results, events
    ms (every run), profiler device ms (one config run each), phases,
    barriers, route."""
    import torch

    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import hier as hier_mod

    run = Launcher(kind, kw)
    keys = (batched_mod.PHASES if kind == "batched"
            else batched_mod.PHASES + hier_mod.HIER_PHASES)
    res, times, info = {}, {}, {}
    for name, build, opts in configs:
        use(build)
        run.reset()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out, last = run(**opts)
        end.record()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(start.elapsed_time(end))
        if name in res:
            continue
        res[name] = flat(out)
        pn = last["phase_ns"].cpu().tolist()
        info[name] = {
            "phase_ms": {k: v / 1e6 for k, v in zip(keys, pn) if v},
            "barriers": pn[len(keys)] if len(pn) > len(keys) else None,
            "route": last.get("route", "grid"),
            "ctas": last.get("grid"), "cluster": last.get("cluster", 0)}
        if "counters" in last:
            info[name]["counters"] = dict(zip(
                hier_mod.COUNTERS, last["counters"].cpu().tolist()))

        def again(opts=opts):
            run.reset()
            run(**opts)
        info[name]["profiler_ms"] = cs.profiled_ms(
            again, "batched_allocate_kernel" if kind == "batched"
            else "hier_allocate_kernel", reps=2)
    ref = res[configs[0][0]]
    equal = {}
    for name in res:
        equal[name] = len(res[name]) == len(ref) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(res[name], ref))
    row = {"label": label, "kind": kind, "t_pad": t_pad(kind, kw),
           "ms": {k: min(v) for k, v in times.items()}, "runs_ms": times,
           "equal_to_before": equal, "configs": info}
    log(f"{label} ({kind}, T_pad {row['t_pad']}): events ms "
        + json.dumps({k: round(v, 3) for k, v in row["ms"].items()})
        + "; profiler ms "
        + json.dumps({k: (round(v["profiler_ms"], 4)
                          if v["profiler_ms"] else None)
                      for k, v in info.items()})
        + f"; equal to before {json.dumps(equal)}")
    for name, v in info.items():
        log(f"  {name}: route {v['route']} ({v['ctas']} CTAs), barriers "
            f"{v['barriers']}, counters {json.dumps(v.get('counters'))}, "
            f"phases "
            + json.dumps({k: round(x, 3) for k, x in v["phase_ms"].items()}))
    return row


def record_sharded(dev) -> list:
    """(label, solve) of the sharded set: each cold cycle's sharded inputs
    (numpy node blocks, replicated arrays, statics, the shard bucket)
    with its ranks, whether the two-level steps solve it and, for cfg5,
    the one-card plain engine's counts (rank 0's bound)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import OpenSession
    from kubebatch_tpu_torch.kernels import batched_sharded as bs
    from kubebatch_tpu_torch.kernels import hier as hier_mod
    from kubebatch_tpu_torch.kernels.batched import (CYCLE_ARGS, NODE_ARGS,
                                                     arg_dtype,
                                                     batched_allocate_plain)
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    calls, cycles = [], {}
    for label, spec, k, two_level in SHARDED:
        if spec not in cycles:
            cache = SchedulerCache(device=dev, async_writeback=False,
                                   incremental_snapshot=False)
            build_cluster(BASELINE_SPECS[spec]).populate(cache)
            cycles[spec] = (cache, build_cycle_inputs(
                OpenSession(cache, shipped_tiers()),
                allow_affinity=spec in ("5p", "3p")))
        inputs = cycles[spec][1]
        node, rep, statics, n_sh = bs.prepare_sharded(k, inputs.device,
                                                      inputs)
        if two_level:
            statics.update(hier_mod.hier_sharded_statics(inputs, n_sh))
        x = {"node": node, "rep": rep, "statics": statics, "n_sh": n_sh,
             "k": k, "two_level": two_level}
        if spec == 5:
            t = {n: torch.from_numpy(np.ascontiguousarray(v)).to(arg_dtype(n))
                 for n, v in {**node, **rep}.items()}
            stats = {}
            batched_allocate_plain(**{n: t[n] for n in NODE_ARGS + CYCLE_ARGS},
                                   compact_bucket=0, stats=stats, **statics)
            x["bound"] = lambda packed, carry, x=x, stats=stats: \
                cs.sharded_bounds(x["node"], x["rep"], packed, carry, stats,
                                  bool(x["statics"]["pipe_enabled"]), x["k"])
        calls.append((label, x))
    for cache, _ in cycles.values():
        cache.stop()
    return calls


class StepLog:
    """While installed, every CudaRank launch is logged: the rank (its
    node block), the step and a copy of the rank's phase timers after it
    (on the stream: no synchronization)."""

    def __enter__(self):
        from kubebatch_tpu_torch.kernels import batched_sharded as bs

        self.cls, self.inner, self.rows = bs.CudaRank, bs.CudaRank._launch, []

        def launch(rank, seg, *args, **kw):
            out = self.inner(rank, seg, *args, **kw)
            self.rows.append((rank.lo // rank.nb, seg, rank.phase_ns.clone()))
            return out

        self.cls._launch = launch
        return self

    def __exit__(self, *exc):
        self.cls._launch = self.inner


def sharded_solve(x):
    """One lock-step solve of the sharded set's input on the card: its
    packed result, node carry and affinity carry (a list of tensors) and
    the ranks."""
    import torch

    from kubebatch_tpu_torch.kernels import batched_sharded as bs

    fn = bs.solve_hier_lockstep if x["two_level"] else bs.solve_lockstep
    bs.last_solve.clear()
    packed, carry, ranks = fn(x["node"], x["rep"], x["statics"], x["n_sh"],
                              x["k"], "cuda")
    torch.cuda.synchronize()
    words = [packed.cpu(), carry.cpu()]
    aff = bs.last_solve.get("aff")
    for name in sorted(aff or {}):
        if aff[name] is not None:
            words.append(torch.from_numpy(aff[name].copy()))
    return words, ranks


def sharded_detail(x, keys) -> dict:
    """One more solve with the current build under the profiler and the
    step log: per rank and step the launches, the profiler's device ms
    (each kernel matched to its launch in launch order; None when the
    trace's kernels and the launches do not pair up), the phase timers'
    ms and the barriers passed."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with StepLog() as steps, profile(activities=[ProfilerActivity.CPU,
                                                 ProfilerActivity.CUDA]) as pr:
        sharded_solve(x)
    kern = sorted((e for e in pr.events()
                   if "sharded_round_kernel" in e.name
                   and e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    paired = len(kern) == len(steps.rows)
    k = x["k"]
    out = [{"launches": {}, "profiler_ms": {} if paired else None,
            "phase_ms": {}, "barriers": {}} for _ in range(k)]
    prev = [torch.zeros_like(steps.rows[0][2]) for _ in range(k)]
    for i, (r, seg, ph) in enumerate(steps.rows):
        o = out[r]
        o["launches"][seg] = o["launches"].get(seg, 0) + 1
        if paired:
            o["profiler_ms"][seg] = (o["profiler_ms"].get(seg, 0.0)
                                     + kern[i].time_range.elapsed_us() / 1e3)
        d = (ph - prev[r]).cpu().tolist()
        prev[r] = ph
        tm = o["phase_ms"].setdefault(seg, {})
        for name, v in zip(keys, d):
            if v:
                tm[name] = tm.get(name, 0.0) + v / 1e6
        o["barriers"][seg] = o["barriers"].get(seg, 0) + d[len(keys)]
    return {"ranks": out, "profiler_paired": paired,
            "profiler_kernels": len(kern), "launches": len(steps.rows)}


def time_sharded(label, x, configs, use) -> dict:
    """Each config (name, build) in turn: the lock-step solve, its words,
    each rank's CUDA-event ms by step; then one detailed solve a build
    (sharded_detail)."""
    import torch

    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import hier as hier_mod

    keys = batched_mod.PHASES + hier_mod.HIER_PHASES[:2]
    res, runs, info = {}, {}, {}
    for name, build in configs:
        use(build)
        words, ranks = sharded_solve(x)
        runs.setdefault(name, []).append([r.kernel_ms() for r in ranks])
        res.setdefault(name, words)
    for name, build in dict.fromkeys(configs):
        use(build)
        info[name] = sharded_detail(x, keys)
    ref = res[configs[0][0]]
    equal = {n: len(w) == len(ref) and all(
        a.dtype == b.dtype and a.shape == b.shape
        and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
        for a, b in zip(w, ref)) for n, w in res.items()}
    rank0 = {n: min(sum(r[0].values()) for r in v) for n, v in runs.items()}
    row = {"label": label, "k": x["k"], "two_level": x["two_level"],
           "n_sh": x["n_sh"], "t_pad": int(x["rep"]["task_valid"].shape[0]),
           "rank0_events_ms": rank0, "events_ms": runs, "detail": info,
           "equal_to_before": equal}
    if "bound" in x:
        row["bound"] = x["bound"](*res[configs[0][0]][:2])
    log(f"{label} (k={x['k']}): rank 0's events ms (best run) "
        + json.dumps({n: round(v, 3) for n, v in rank0.items()})
        + f"; equal to before {json.dumps(equal)}"
        + (f"; bound {row['bound']['bound_ms']:.6f} ms "
           f"({row['bound']['bound_by']})" if "bound" in row else ""))
    for name, d in info.items():
        for r, o in enumerate(d["ranks"]):
            prof = o["profiler_ms"]
            log(f"  {name} rank {r}: launches {json.dumps(o['launches'])}; "
                f"profiler ms "
                + (json.dumps({s: round(v, 3) for s, v in prof.items()})
                   if prof is not None else
                   f"unpaired ({d['profiler_kernels']} kernels, "
                   f"{d['launches']} launches)")
                + "; barriers " + json.dumps(o["barriers"]))
            log(f"    phases " + json.dumps(
                {s: {k: round(v, 3) for k, v in ph.items()}
                 for s, ph in o["phase_ms"].items()}))
    return row


def scan_inputs(real):
    """The scan set's inputs: chip_smoke.scan_args at T 256 x N_pad
    8,192 (seed 0), with the nodes past ``real`` cut (node_ok false) for
    the cfg5-shaped case."""
    import chip_smoke as cs

    args = cs.scan_args(8192, 256, seed=0)
    if real is not None:
        args["node_ok"][real:] = False
    return args


def scan_detail(args, k) -> dict:
    """One more lock-step scan under the profiler: per rank the
    profiler's device ms over its launches (the k ranks launch in turn,
    so kernel j is rank j % k's; None when the trace's kernels and the
    launches do not pair up) and the phase timers' ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from kubebatch_tpu_torch.kernels import sharded as sh

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as pr:
        _, ranks = sh.scan_lockstep(args, k, "cuda")
        ranks[0].kernel_ms()
    kern = sorted((e for e in pr.events()
                   if "sharded_scan_kernel" in e.name
                   and e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    launches = sum(r.launches for r in ranks)
    prof = None
    if len(kern) == launches:
        prof = [0.0] * k
        for j, e in enumerate(kern):
            prof[j % k] += e.time_range.elapsed_us() / 1e3
    return {"profiler_ms": prof, "profiler_kernels": len(kern),
            "launches": [r.launches for r in ranks]}


def time_scan(label, args, k, configs, use, cs) -> dict:
    """Each config (name, build) in turn: the lock-step scan
    (sharded.scan_lockstep on "cuda": k ranks in this process, each
    launch alone on the card), its six outputs as words, each rank's
    CUDA-event ms and phase ms over its launches; then one profiled scan
    a build (scan_detail)."""
    import torch

    from kubebatch_tpu_torch.kernels import sharded as sh

    res, runs, info = {}, {}, {}
    for name, build in configs:
        use(build)
        out, ranks = sh.scan_lockstep(args, k, "cuda")
        torch.cuda.synchronize()
        runs.setdefault(name, []).append(
            {"events_ms": [r.kernel_ms() for r in ranks],
             "phase_ms": [r.phase_ms() for r in ranks]})
        res.setdefault(name, [o.cpu().reshape(-1) for o in out])
    for name, build in dict.fromkeys(configs):
        use(build)
        info[name] = scan_detail(args, k)
    ref = res[configs[0][0]]
    equal = {n: all(a.dtype == b.dtype and a.shape == b.shape
                    and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
                    for a, b in zip(w, ref)) for n, w in res.items()}
    launches = int(args["resreq"].shape[0]) + 1
    rank0 = {n: min(r["events_ms"][0] for r in v) for n, v in runs.items()}
    want, _ = sh.scan_lockstep(args, k, "cpu")
    plain = all(torch.equal(a.reshape(-1), b.cpu().reshape(-1))
                for a, b in zip(want, ref))
    nb = args["node_ok"].shape[0] // k
    row = {"label": label, "k": k, "nb": nb, "launches_a_rank": launches,
           "rank0_events_ms": rank0,
           "rank0_events_ms_a_launch": {n: v / launches
                                        for n, v in rank0.items()},
           "runs": runs, "detail": info, "equal_to_before": equal,
           "equal_to_plain": plain,
           "bound": cs.sharded_scan_bounds(args, want, k)}
    if "after" in res:
        use("after")
        row["shape"] = sh.scan_shape(k, nb)
    log(f"{label}: rank 0's events ms a launch (best run) "
        + json.dumps({n: round(v, 5) for n, v in
                      row["rank0_events_ms_a_launch"].items()})
        + f"; equal to before {json.dumps(equal)}, to plain {plain}; "
          f"bound a launch {row['bound']['launch_bound_ms']:.6f} ms "
          f"({row['bound']['launch_bound_by']}); cluster "
          f"{json.dumps(row.get('shape'))}")
    for name, d in info.items():
        prof = d["profiler_ms"]
        log(f"  {name}: profiler ms a launch by rank "
            + (json.dumps([round(v / launches, 5) for v in prof])
               if prof is not None else
               f"unpaired ({d['profiler_kernels']} kernels, "
               f"{sum(d['launches'])} launches)")
            + "; phase ms a launch, rank 0 "
            + json.dumps({p: round(v / launches, 5) for p, v in
                          runs[name][0]["phase_ms"][0].items()}))
    return row


def record_explain(dev) -> list:
    """(label, kw, has_ports, t_real, n_cand) of the explain set: the
    explainer's arguments (obs.explain.explain_args) on a fresh session
    over a cold cache of each spec, copied."""
    import dataclasses

    import chip_smoke as cs
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.obs import explain
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    calls = []
    for label, spec, fill in EXPLAIN:
        spec = BASELINE_SPECS[spec]
        if fill is not None:
            spec = dataclasses.replace(spec, running_fill=fill)
        sim = build_cluster(spec)
        cache = SchedulerCache(device=dev, binder=cs.FreshBinder())
        sim.populate(cache)
        ssn = OpenSession(cache, shipped_tiers())
        inputs = build_cycle_inputs(ssn, allow_affinity=True)
        kw, has_ports = explain.explain_args(inputs)
        kw = {k: v.clone() for k, v in kw.items()}
        CloseSession(ssn)
        cache.stop()
        calls.append((label, kw, has_ports, len(inputs.tasks),
                      int(kw["node_ok"].sum())))
    return calls


def time_explain(label, kw, has_ports, t_real, n_cand, configs, use,
                 cs) -> dict:
    """Each config (name, build) in turn: the [T, 6] counts, CUDA-event
    ms (50 launches back to back: the wrapper's host work included) and
    the profiler's device ms (10 launches); this build's phase timers;
    every result equal to the first config's and to the plain version."""
    import torch

    from kubebatch_tpu_torch.obs import explain

    def call():
        return explain.explain_counts(**kw, has_ports=has_ports)

    res, ev, prof = {}, {}, {}
    for name, build in configs:
        use(build)
        for _ in range(10):
            call()
        out = call()
        torch.cuda.synchronize()
        res.setdefault(name, out.cpu())
        ev.setdefault(name, []).append(cs.cuda_ms(call, 50))
        prof.setdefault(name, []).append(
            cs.profiled_ms(call, "explain_counts_kernel", reps=10))
    phases, shape = None, None
    if "after" in res:
        use("after")
        call()
        phases = {p: v / 1e6 for p, v in zip(
            explain.PHASES, explain.last_launch["phase_ns"].cpu().tolist())}
        shape = explain.launch_shape(*explain.last_launch["sizes"])
    ref = res[configs[0][0]]
    equal = {n: torch.equal(r, ref) for n, r in res.items()}
    plain = torch.equal(explain.explain_counts_plain(
        **{k: v.cpu() for k, v in kw.items()}, has_ports=has_ports), ref)
    row = {"label": label, "t_pad": int(kw["task_valid"].shape[0]),
           "n_pad": int(kw["idle"].shape[0]),
           "s_pad": int(kw["sig_pred"].shape[0]),
           "pt": int(kw["task_ports"].shape[1]), "has_ports": has_ports,
           "t_real": t_real, "n_cand": n_cand, "events_ms": ev,
           "profiler_ms": prof, "phase_ms_after": phases,
           "shape_after": shape,
           "equal_to_before": equal, "equal_to_plain": plain,
           "bound": cs.explain_bounds(kw, ref, has_ports, t_real, n_cand)}
    log(f"explain {label} (T_pad {row['t_pad']} x N_pad {row['n_pad']}, "
        f"S {row['s_pad']}, PT {row['pt']}, ports {has_ports}; {t_real} "
        f"tasks x {n_cand} candidates): profiler ms "
        + json.dumps({n: [round(x, 5) if x else None for x in v]
                      for n, v in prof.items()})
        + "; events ms " + json.dumps({n: [round(x, 5) for x in v]
                                       for n, v in ev.items()})
        + f"; equal to before {json.dumps(equal)}, to plain {plain}; "
          f"bound {row['bound']['bound_ms']:.6f} ms "
          f"({row['bound']['bound_by']}); this build's phases "
        + json.dumps({p: round(v, 5) for p, v in (phases or {}).items()})
        + f"; shape {json.dumps(shape)}")
    return row


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--before", required=True)
    ap.add_argument("--set", default="small,round")
    ap.add_argument("--only-before", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "chain_timing", "report.json"))
    args = ap.parse_args()
    sets = args.set.split(",")
    if not torch.cuda.is_available():
        log("chain_timing: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import cluster_timing
    import kubebatch_tpu_torch.actions  # noqa: F401
    import kubebatch_tpu_torch.plugins  # noqa: F401
    from kubebatch_tpu_torch.kernels import _build

    dev = torch.device("cuda")
    report = {"card": cs.card_line(), "kind": torch.cuda.get_device_name(0),
              "sets": sets, "only_before": args.only_before}
    t0 = time.perf_counter()
    sources = ((SOURCES if {"small", "round"} & set(sets) else ())
               + (SHARDED_SOURCES if "sharded" in sets else ())
               + (SCAN_SOURCES if "scan" in sets else ())
               + (EXPLAIN_SOURCES if "explain" in sets else ()))
    pending = {"before": start_builds(os.path.join(
        os.path.abspath(args.before), "kubebatch_tpu_torch", "kernels",
        "csrc"), "before", sources)}
    if "round" in sets and not args.only_before:
        pending["grid"] = start_builds(grid_sources(str(_build.CSRC)), "grid")
    for src, variants, on in (("sharded_scan.cu", SCAN_VARIANTS, "scan"),
                              ("explain_counts.cu", EXPLAIN_VARIANTS,
                               "explain")):
        if on in sets and not args.only_before:
            for name, values in variants.items():
                pending[name] = start_builds(
                    patched_sources(str(_build.CSRC), name, src, values),
                    name, (src,))
    if "small" in sets and not args.only_before:
        for name, values in VARIANTS.items():
            pending[name] = start_builds(
                patched_sources(str(_build.CSRC), name, "hier_allocate.cu",
                                values), name, ("hier_allocate.cu",))
    # the scan and explain sets record no allocate cycle: their own
    # sources and the barrier probe are enough (before alone: the probe)
    light = set(sets) <= {"scan", "explain"}
    after = () if light and args.only_before else sources
    _build.build_all(after + ("chain_probe.cu",) if light else None)
    for src in after:
        _build.library(src)
    libs = {"after": {s: _build._libs[s] for s in after}}
    for name, procs in pending.items():
        libs[name] = {**libs["after"],
                      **finish_builds(procs, earlier=name == "before")}
    report["build_s"] = time.perf_counter() - t0
    report["library_bytes"] = {
        "after": {s: os.path.getsize(_build._target(_build.CSRC / s))
                  for s in after},
        **{name: {src: os.path.getsize(target)
                  for src, target, _ in procs}
           for name, procs in pending.items()}}
    log(f"builds {report['build_s']:.1f} s; {report['card']}; library "
        f"bytes {json.dumps(report['library_bytes'])}")

    def use(which):
        for s in sources:
            if s in libs[which]:
                _build._libs[s] = libs[which][s]

    use("after")
    t0 = time.perf_counter()
    calls = []
    if "small" in sets:
        calls += record_small(dev)
    if "round" in sets:
        calls += record_round(dev)
    sharded = record_sharded(dev) if "sharded" in sets else []
    explained = record_explain(dev) if "explain" in sets else []
    log(f"inputs recorded in {time.perf_counter() - t0:.1f} s: "
        + ", ".join(c[0] for c in calls + sharded + explained))
    rows = []
    seq = (("before", "before"),) * 2 if args.only_before else (
        ("before", "before"), ("after", "after"), ("after", "after"),
        ("before", "before"))
    if "scan" in sets:
        from kubebatch_tpu_torch.kernels import sharded as sh

        warm = scan_inputs(None)
        report["scan_first_solve"] = {}
        for b in dict(seq):
            use(b)
            _, ranks = sh.scan_lockstep(warm, 2, "cuda")
            report["scan_first_solve"][b] = [r.kernel_ms() for r in ranks]
        log("first scan of each build (k=2), events ms by rank: "
            + json.dumps(report["scan_first_solve"]))
        more = [] if args.only_before else [
            (v, v) for v in SCAN_VARIANTS for _ in range(2)]
        report["scan"] = [time_scan(label, scan_inputs(real), k,
                                    list(seq) + more, use, cs)
                          for label, k, real in SCAN]
        rows += report["scan"]
    if explained:
        more = [] if args.only_before else [
            (v, v) for v in EXPLAIN_VARIANTS for _ in range(2)]
        report["explain"] = [time_explain(*x, list(seq) + more, use, cs)
                             for x in explained]
        rows += report["explain"]
    if sharded:
        builds = ("before",) if args.only_before else ("before", "after")
        report["sharded_first_solve"] = {}
        for b in builds:
            use(b)
            _, ranks = sharded_solve(sharded[0][1])
            report["sharded_first_solve"][b] = [r.kernel_ms() for r in ranks]
        log("first solve of each build (" + sharded[0][0] + "), rank 0 by "
            "step: " + json.dumps(
                {b: {k: round(v, 3) for k, v in r[0].items()}
                 for b, r in report["sharded_first_solve"].items()}))
        seq = (("before", "before"),) * 2 if args.only_before else (
            ("before", "before"), ("after", "after"), ("after", "after"),
            ("before", "before"))
        report["sharded"] = [time_sharded(label, x, list(seq), use)
                             for label, x in sharded]
    for label, kind, kw in calls:
        grid = {"route": "grid"}
        if args.only_before:
            configs = [("before", "before", {}), ("grid", "after", grid),
                       ("grid", "after", grid), ("before", "before", {})]
        elif kind == "batched" or (kind == "hier" and "grid" in libs):
            configs = [("before", "before", {}), ("after", "after", {}),
                       ("after", "after", {}), ("before", "before", {}),
                       ("grid", "grid", {}), ("grid", "grid", {})]
        else:
            configs = [("before", "before", {}), ("after", "after", {}),
                       ("after", "after", {}), ("before", "before", {}),
                       ("after grid", "after", grid),
                       ("after grid", "after", grid),
                       ("after cluster", "after", {"route": "cluster"}),
                       ("after cluster", "after", {"route": "cluster"}),
                       ("after C8", "after", {"route": "cluster",
                                              "cluster": 8}),
                       ("after C8", "after", {"route": "cluster",
                                              "cluster": 8})]
            for name in VARIANTS:
                configs += [(name, name, {"route": "cluster"})] * 2
        rows.append(run_launch(label, kind, kw, configs, use, cs))
    use("after")
    report["launches"] = [r for r in rows if "kind" in r]
    rows = rows + report.get("sharded", [])
    report["grid_barrier"] = cs.grid_barrier_us()
    report["cluster_barrier"] = [
        p for p in cluster_timing.cluster_probe()["probes"]
        if p["threads"] == 512 and p["cluster"] in (8, 16)]
    log(f"grid barrier: {json.dumps(report['grid_barrier'])}; cluster "
        f"barrier: {json.dumps(report['cluster_barrier'])}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report), flush=True)
    bad = [r["label"] for r in rows
           if not all(r["equal_to_before"].values())
           or not r.get("equal_to_plain", True)]
    if bad:
        log(f"results differ from the earlier build: {bad}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
