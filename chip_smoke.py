"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from kubebatch_tpu_torch/kernels/csrc,
holds each against its plain PyTorch version on the card, then drives the
port's main path at cfg5's full width (5,000 nodes, 1,250 gangs x 8 pods,
4 queues weighted 1-4, +-20% request jitter): a cold allocate cycle that
binds the backlog, a kubelet tick, a churn of 256 pods, and a steady
cycle in auto mode. It checks engine, kernel launches, one counted
device->host copy per solve, gang all-or-nothing, and that every solve's
host block equals the plain version's word for word; on cfg2 the fused
cycle must also bind exactly what the host oracle binds. Last it times
the kernels at the main path's shapes, and beside each fused solve its
roofline bound, the node-state re-read at the memory rate, and two
floors of the one-block design measured with csrc/chain_probe.cu.

Output: progress lines, then the card's name and power limit
(nvidia-smi), a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero without the last line. It needs torch with CUDA and the repo
checkout around it (it imports kubebatch_tpu_torch from its own
directory); it imports nothing of jax or the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: float32 operations per node of one node-pass evaluation (fit checks,
#: predicate, nodeorder dynamic score, select) — counted from
#: kernels/csrc/fused_allocate.cu eval_node and node_score.cuh
OPS_PER_NODE_FUSED = 90
OPS_PER_NODE_SCORE = 68
#: bytes of node state one node-pass evaluation reads (eval_node): idle,
#: backfilled and releasing (3 x f32 each), n_tasks and max_task_num
#: (i32), node_ok and the sig_pred byte, the sig_scores f32, nz_req and
#: allocatable_cm (2 x f32 each)
NODE_PASS_BYTES = 66
#: block barriers of a node-solve iteration that resumes a visit
#: (fused_allocate.cu: loop top, job resume, task pick, block_argmax's
#: three, loop end); an iteration that pops a queue and picks a job adds 16
BARRIERS_PER_SOLVE = 7
#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and
#: float32 operations/s outside the tensor cores without FMA contraction.
#: The data sheet's 67 TFLOP/s counts a fused multiply-add as two
#: operations; the sources are built with -fmad=false, so every operation
#: is one instruction and the lanes issue half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 33.5e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: int, ops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bounds(kw, out) -> dict:
    """The fused solve's bounds for one run, from its inputs and results.

    ``bound_ms`` is the roofline: each input read once and each output
    written once over the memory rate, against the node passes' float
    operations over the float32 rate. ``reread_ms`` counts what the node
    pass moves instead: the node state read again by every node solve,
    over the memory rate (a floor for a design that streams it from
    memory each time; the one-block kernel streams it from L2)."""
    frame = out[0][0, -20:].tolist()
    iters, n_solves = frame[1], frame[2] + frame[3]     # placed + failed
    n_pad = kw["idle"].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values()
                 if hasattr(t, "numel"))
    nbytes += sum(t.numel() * t.element_size() for t in out)
    b_ms, b_by = bound(nbytes, n_solves * n_pad * OPS_PER_NODE_FUSED)
    return {"iters": iters, "n_solves": n_solves, "n_pad": n_pad,
            "bound_ms": b_ms, "bound_by": b_by,
            "reread_ms": n_solves * n_pad * NODE_PASS_BYTES
            / PEAK_BYTES_PER_S * 1e3}


def probe_ms(n_pad: int, words: int, iters: int) -> float:
    """Device ms of csrc/chain_probe.cu: ``iters`` dependent iterations of
    one 1024-thread block, each with BARRIERS_PER_SOLVE barriers and an
    argmax over what a pass reading ``words`` words per node returns."""
    import torch

    from kubebatch_tpu_torch.kernels import _build

    lib = _build.library("chain_probe.cu")
    gen = torch.Generator(device="cuda").manual_seed(0)
    buf = torch.rand(max(words, 1) * n_pad, generator=gen, device="cuda")
    out = torch.empty(1, dtype=torch.int32, device="cuda")

    def run():
        err = lib.kb_chain_probe(buf.data_ptr(), n_pad, words, iters,
                                 BARRIERS_PER_SOLVE, out.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch("chain_probe", err)
        _build.count_launch("chain_probe")

    return cuda_ms(run, reps=2)


def max_abs_err(want, got) -> float:
    import torch

    err = 0.0
    for w, g in zip(want, got):
        if w.dtype == torch.bool:
            w, g = w.to(torch.int32), g.to(torch.int32)
        d = (w.double() - g.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def assert_bitwise(want, got, what: str) -> None:
    import torch

    for k, (w, g) in enumerate(zip(want, got)):
        if w.shape != g.shape or w.dtype != g.dtype or not torch.equal(
                w.contiguous().view(torch.uint8),
                g.contiguous().view(torch.uint8)):
            raise AssertionError(f"{what}: output {k} differs from the "
                                 f"plain version")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled_ms(fn, kernel: str, reps: int):
    """Device milliseconds per launch of the CUDA kernel whose name
    contains ``kernel``, from a torch.profiler trace of ``reps`` calls;
    None when the trace shows no device time for it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for evt in prof.key_averages():
        if kernel in evt.key:
            total_us += getattr(evt, "self_device_time_total",
                                getattr(evt, "self_cuda_time_total", 0.0))
            count += evt.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def score_edge_inputs(n: int, seed: int):
    """Random node-score inputs with edge rows: no allocatable, a cpu-less
    node, a request past capacity, one exactly at capacity."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    cap = np.stack([rng.uniform(3200, 9600, n), rng.uniform(6554, 19661, n)],
                   axis=1).astype(np.float32)
    nz = (cap * rng.uniform(0.0, 1.1, (n, 2))).astype(np.float32)
    t_nz = np.asarray([1000.0, 2048.0], np.float32)
    cap[0] = 0.0
    cap[1, 0] = 0.0
    nz[2] = cap[2] + 1.0
    nz[3] = cap[3] - t_nz
    w = np.asarray([1.0, 1.0], np.float32)
    return [torch.from_numpy(a).cuda() for a in (nz, t_nz, cap, w)]


class RecordingBinder:
    """Binds by flipping the pod's node_name; records the call order."""

    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((pod.name, hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)


class Recorder:
    """Wraps allocate_fused's solve entry to keep each solve's inputs and
    results (the main path's own tensors, for the plain comparison)."""

    def __init__(self, mod):
        self.mod = mod
        self.inner = mod.fused_allocate
        self.calls = []

    def __call__(self, **kw):
        out = self.inner(**kw)
        self.calls.append((kw, out))
        return out

    def __enter__(self):
        self.mod.fused_allocate = self
        return self

    def __exit__(self, *exc):
        self.mod.fused_allocate = self.inner


def build_session_inputs(cfg, device):
    """The port's host path for one config up to the solve's arguments."""
    from kubebatch_tpu_torch.actions.allocate_fused import prepare_fused
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import OpenSession
    from kubebatch_tpu_torch.sim import baseline_cluster

    cache = SchedulerCache(async_writeback=False, device=device)
    baseline_cluster(cfg).populate(cache)
    ssn = OpenSession(cache, shipped_tiers())
    return prepare_fused(build_cycle_inputs(ssn))


def gang_all_or_nothing(cache) -> int:
    """Number of PodGroups with some but fewer than min_member tasks
    placed (must be 0)."""
    from kubebatch_tpu_torch.api import allocated_status

    bad = 0
    for job in cache.jobs.values():
        if job.pod_group is None:
            continue
        placed = sum(1 for t in job.tasks.values()
                     if allocated_status(t.status))
        if 0 < placed < job.min_available:
            bad += 1
    return bad


def binding_count(cache) -> int:
    from kubebatch_tpu_torch.api import TaskStatus

    return sum(len(j.task_status_index.get(TaskStatus.BINDING, {}))
               for j in cache.jobs.values())


def placed_count(host_block) -> int:
    from kubebatch_tpu_torch.kernels.fused import unpack_host_block

    state = unpack_host_block(host_block)[0]
    return int(((state >= 1) & (state <= 3)).sum())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script "
            "runs on an NVIDIA GPU")
        return 2
    sys.path.insert(0, HERE)
    import kubebatch_tpu_torch.actions  # noqa: F401  (registers actions)
    import kubebatch_tpu_torch.plugins  # noqa: F401  (registers plugins)
    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.actions import allocate_fused
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels.fused import (fused_allocate,
                                                   fused_allocate_plain)
    from kubebatch_tpu_torch.kernels.solver import (dynamic_node_score,
                                                    dynamic_node_score_plain)
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.sim import baseline_cluster

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} ({torch.cuda.device_count()} visible), torch "
        f"{torch.__version__}, cuda {torch.version.cuda}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in per_source.items()))
    for name, rec in _build.build_log.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    _build.library("fused_allocate.cu")     # loads both libraries now

    # ---- 2. kernels vs plain versions on small and edge inputs ----------
    args = score_edge_inputs(5000, seed=0)
    assert_bitwise([dynamic_node_score_plain(*args)],
                   [dynamic_node_score(*args)], "dynamic_node_score N=5000")
    log("dynamic_node_score: N=5000 with edge rows bitwise equal to plain")
    for cfg in (2, 3):
        fargs, statics = build_session_inputs(cfg, dev)
        want = fused_allocate_plain(**fargs, **statics)
        got = fused_allocate(**fargs, **statics)
        torch.cuda.synchronize()
        assert_bitwise(want, got, f"fused_allocate cfg{cfg}")
        log(f"fused_allocate cfg{cfg}: host block [3,{got[0].shape[1]}] and "
            f"node carries bitwise equal to plain ({placed_count(got[0])} "
            f"placed)")

    # cfg2 end to end: fused binds exactly what the host oracle binds
    binds = {}
    for mode in ("fused", "host"):
        rec_binder = RecordingBinder()
        cache = SchedulerCache(binder=rec_binder, async_writeback=False,
                               device=dev)
        baseline_cluster(2).populate(cache)
        ssn = OpenSession(cache, shipped_tiers())
        AllocateAction(mode=mode).execute(ssn)
        CloseSession(ssn)
        binds[mode] = rec_binder.calls
    if not binds["fused"] or binds["fused"] != binds["host"]:
        raise AssertionError("cfg2: fused binds differ from the host oracle")
    log(f"cfg2 cycle: fused binds == host oracle binds "
        f"({len(binds['fused'])} binds, same order)")

    # ---- 3. the main path at cfg5 ---------------------------------------
    t0 = time.perf_counter()
    sim = baseline_cluster(5)
    cache = SchedulerCache(device="cuda", binder=NullBinder(),
                           incremental_snapshot=False)
    sim.populate(cache)
    log(f"cfg5: {len(cache.nodes)} nodes, {len(sim.pods)} pods, "
        f"{len(cache.queues)} queues populated in "
        f"{time.perf_counter() - t0:.1f} s")

    def drive(mode):
        b0 = binding_count(cache)
        rb0 = metrics.blocking_readbacks()
        t0 = time.perf_counter()
        snap = cache.snapshot()
        t1 = time.perf_counter()
        ssn = OpenSession(cache, shipped_tiers(), snapshot=snap)
        t2 = time.perf_counter()
        AllocateAction(mode=mode).execute(ssn)
        t3 = time.perf_counter()
        CloseSession(ssn)
        t4 = time.perf_counter()
        cache.drain(timeout=60.0)
        phases = {"snapshot": (t1 - t0) * 1e3, "open": (t2 - t1) * 1e3,
                  **allocate_fused.last_phases,
                  "allocate": (t3 - t2) * 1e3, "close": (t4 - t3) * 1e3}
        return {"engine": allocate_mod.last_cycle_engine,
                "syncs": metrics.blocking_readbacks() - rb0,
                "binds": binding_count(cache) - b0, "phases": phases}

    def kubelet_tick():
        for pod in sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)

    dem0 = metrics.engine_demotions_total()
    with Recorder(allocate_fused) as rec:
        _build.reset_launch_counts()
        c1 = drive("fused")
        l1 = _build.launch_count("fused_allocate")
        kubelet_tick()
        recycled = sim.churn_tick(cache, 256)
        c2 = drive("auto")
        launches = {n: _build.launch_count(n)
                    for n in ("fused_allocate", "dynamic_node_score")}
    cycles = [c1, c2]
    for k, c in enumerate(cycles, 1):
        log(f"cycle {k}: engine {c['engine']}, binds {c['binds']}, counted "
            f"syncs {c['syncs']}, phases ms "
            + json.dumps({p: round(v, 3) for p, v in c["phases"].items()}))
    if recycled != 256:
        raise AssertionError(f"churn recycled {recycled} pods, not 256")
    if any(c["engine"] != "fused" for c in cycles):
        raise AssertionError("a cycle did not run the fused engine")
    if l1 != 1 or launches["fused_allocate"] != 2:
        raise AssertionError(f"fused_allocate launches {l1} then "
                             f"{launches['fused_allocate']}, expected 1, 2")
    if any(c["syncs"] != 1 for c in cycles):
        raise AssertionError("a fused solve did not make exactly one "
                             "counted device->host copy")
    if metrics.engine_demotions_total() != dem0:
        raise AssertionError("an engine demotion happened on the main path")
    bad = gang_all_or_nothing(cache)
    if bad:
        raise AssertionError(f"{bad} PodGroups partially placed")
    if len(rec.calls) != 2:
        raise AssertionError("expected two recorded solves")

    # every main-path solve against the plain version on its own inputs
    plain_ms = {}
    fused_err = 0.0
    for k, ((kw, got), c) in enumerate(zip(rec.calls, cycles), 1):
        t0 = time.perf_counter()
        want = fused_allocate_plain(**kw)
        torch.cuda.synchronize()
        plain_ms[k] = (time.perf_counter() - t0) * 1e3
        fused_err = max(fused_err, max_abs_err(want, got))
        assert_bitwise(want, got, f"fused_allocate cfg5 cycle {k}")
        expected = placed_count(want[0])
        if c["binds"] != expected:
            raise AssertionError(f"cycle {k}: {c['binds']} binds, plain "
                                 f"version placed {expected}")
        log(f"cfg5 cycle {k}: kernel host block and carries bitwise equal "
            f"to plain; binds {c['binds']} == plain placements")
    if c1["binds"] != len(sim.pods) or c2["binds"] != 256:
        raise AssertionError(f"binds {c1['binds']} / {c2['binds']}, "
                             f"expected {len(sim.pods)} / 256")

    # ---- 4. timings at the main path's shapes ---------------------------
    kw1, out1 = rec.calls[0]
    fused_event_ms = cuda_ms(lambda: fused_allocate(**kw1), reps=3)
    fused_prof_ms = profiled_ms(lambda: fused_allocate(**kw1),
                                "fused_allocate_kernel", reps=2)
    fused_ms = fused_prof_ms if fused_prof_ms is not None else fused_event_ms
    # bounds, and the one-block design's floors, for both cycles' solves
    fb = [fused_bounds(kw, out) for kw, out in rec.calls]
    words = NODE_PASS_BYTES // 4          # rounded down: a floor
    for b in fb:
        b["chain_ms"] = probe_ms(b["n_pad"], 0, b["iters"])
        b["stream_ms"] = probe_ms(b["n_pad"], words, b["n_solves"])
    n_pad = fb[0]["n_pad"]

    dev_session_args = (kw1["nz_req0"], kw1["task_nz"][0],
                        kw1["allocatable_cm"], kw1["dyn_weights"])
    want = dynamic_node_score_plain(*dev_session_args)
    got = dynamic_node_score(*dev_session_args)
    assert_bitwise([want], [got], "dynamic_node_score cfg5")
    score_err = max_abs_err([want], [got])
    score_event_ms = cuda_ms(lambda: dynamic_node_score(*dev_session_args),
                             200)
    score_prof_ms = profiled_ms(lambda: dynamic_node_score(*dev_session_args),
                                "dynamic_node_score_kernel", reps=50)
    score_ms = score_prof_ms if score_prof_ms is not None else score_event_ms
    score_plain_ms = cuda_ms(
        lambda: dynamic_node_score_plain(*dev_session_args), 50)
    s_bound, s_by = bound(n_pad * (8 + 8 + 4) + 16,
                          n_pad * OPS_PER_NODE_SCORE)

    kernels = [
        {"name": "fused_allocate", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/fused_allocate.cu",
         "replaces": "kubebatch_tpu/kernels/fused.py:112",
         "launches": launches["fused_allocate"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": plain_ms[1],
         "bound_ms": fb[0]["bound_ms"], "bound_by": fb[0]["bound_by"],
         "library_ms": None, "reread_ms": fb[0]["reread_ms"],
         "chain_floor_ms": fb[0]["chain_ms"],
         "stream_floor_ms": fb[0]["stream_ms"]},
        {"name": "dynamic_node_score", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/node_score.cu",
         "replaces": "kubebatch_tpu/kernels/solver.py:67",
         "launches": launches["dynamic_node_score"],
         "max_abs_err": score_err, "ms": score_ms,
         "plain_ms": score_plain_ms, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None, "runs_inside": "fused_allocate"},
    ]
    log(f"fused_allocate cfg5 cycle 1: kernel {fused_event_ms:.3f} ms per "
        f"launch (CUDA events, 3 launches), {fused_prof_ms} ms device time "
        f"(profiler); plain {plain_ms[1]:.1f} ms; cycle 2 plain "
        f"{plain_ms[2]:.1f} ms")
    for k, (b, c) in enumerate(zip(fb, cycles), 1):
        log(f"fused_allocate cycle {k}: {b['iters']} iterations, "
            f"{b['n_solves']} node solves over {b['n_pad']} nodes; kernel "
            f"{c['phases']['kernel']:.3f} ms (events, main path); roofline "
            f"bound {b['bound_ms']:.6f} ms ({b['bound_by']}); node state "
            f"re-read per solve at the memory rate {b['reread_ms']:.3f} ms; "
            f"one-block floors (chain_probe.cu): {BARRIERS_PER_SOLVE} "
            f"barriers + argmax per iteration {b['chain_ms']:.3f} ms, plus "
            f"streaming {words * 4} B/node per solve {b['stream_ms']:.3f} "
            f"ms")
    log(f"dynamic_node_score N={n_pad}: {score_event_ms:.4f} ms per launch "
        f"back to back (CUDA events, 200 launches), {score_prof_ms} ms "
        f"device time (profiler); plain {score_plain_ms:.4f} ms")
    for k, c in enumerate(cycles, 1):
        wall = c["phases"]["snapshot"] + c["phases"]["open"] + \
            c["phases"]["allocate"] + c["phases"]["close"]
        log(f"cycle {k}: wall {wall:.1f} ms, kernel {c['phases']['kernel']:.3f}"
            f" ms, kernel share of host wall "
            f"{c['phases']['kernel'] / wall:.4f}")
    log(f"dynamic_node_score: {launches['dynamic_node_score']} main-path "
        f"launches of the standalone kernel; on the main path its "
        f"arithmetic (node_score.cuh) runs inside every fused_allocate "
        f"launch; the standalone kernel is timed at N={n_pad}")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    cache.stop()

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
