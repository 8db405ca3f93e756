"""Times the cluster kernels on one NVIDIA GPU against an earlier build of
the same kernels, on the same inputs.

    python3 cluster_timing.py --before DIR [--set victims|fused]
        [--out build/cluster_timing/report.json]

``--set victims`` (the default) times csrc/victims.cu and
csrc/allocate_scan.cu; ``--set fused`` times csrc/fused_allocate.cu and
csrc/mega_fused.cu (the loop of csrc/fused_body.cuh), as described at
FUSED_EDITS below.

For ``victims``, DIR is an unpacked checkout of an earlier commit whose
victims.cu and allocate_scan.cu run one lane and one visit on one CTA.
Their copies are given the same per-phase device timers as this
checkout's kernels (CTA 0's thread 0 on the global timer: filter, drf
scan, proportion scan, node pass, visit; prologue, rows, epilogue) and
the same C interface, and are built into build/cluster_timing/before/
beside this checkout's build. ``fused`` does the same for an earlier
one-block fused loop (FUSED_EDITS) and replays the launches that
record_fused_inputs records (time_fused).

The launch inputs are recorded once from the port's own cycles on the
card: the saturated cfg4 preempt cycle (its first full wave and a fixed
sample of its single-lane refreshes), the cfg5 churn cycle's one-lane
wave, 256-lane waves of the three filter kinds and a visit at that state,
and samples of the allocate_scan visits of a solver="jax" cold cfg5
period (T_pad 8) and of the custom-order cfg3 period. Each launch then
runs with each build in the order before, after, after, before: every
output must equal the earlier build's bit for bit; each build is timed
with CUDA events (the best single launch of its runs, and 20 launches
back to back: both include the wrapper's host work) and with the
profiler (the kernel's device time, 10 launches) beside its phase
timers. Waves of more than one lane also run with this build at one CTA
a lane (``after_c1``: victims.CLUSTER patched to 1), and every victim
launch with 1,024 threads a CTA (``after_nt1024``: victims.NT patched).
The cluster probe of
csrc/chain_probe.cu runs last. Prints one JSON line and writes it to
--out. Needs torch with CUDA and nvcc; imports nothing of jax or the
reference package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("victims.cu", "allocate_scan.cu")
FUSED_SOURCES = ("fused_allocate.cu", "mega_fused.cu")
OUT_DIR = os.path.join(HERE, "build", "cluster_timing")

#: (anchor, replacement) edits that give the one-CTA kernels the timers
#: and the C interface of the cluster kernels; each anchor must occur once
TIMER_MACRO = """
#define KB_MARK(p)                                              \\
    do {                                                        \\
        if (timer_) {                                           \\
            unsigned long long t_;                              \\
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
            ph_[p] += t_ - t_last_;                             \\
            t_last_ = t_;                                       \\
        }                                                       \\
    } while (0)
#define KB_TIMER(cond)                                          \\
    const bool timer_ = (cond);                                 \\
    unsigned long long ph_[5] = {0, 0, 0, 0, 0}, t_last_ = 0;   \\
    if (timer_)                                                 \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_last_))
"""
EDITS = {
    "victims.cu": [
        ("#include \"seg_scan.cuh\"\n",
         "#include \"seg_scan.cuh\"\n" + TIMER_MACRO),
        ("P_WS, P_OUT, N_PTRS", "P_WS, P_OUT, P_PHASE, N_PTRS"),
        ("    uint8_t* ws; void* out;\n",
         "    uint8_t* ws; void* out; unsigned long long* phase_ns;\n"),
        ("    const int N = a.N, V = a.V;\n",
         "    const int N = a.N, V = a.V;\n"
         "    KB_TIMER(blockIdx.x == 0 && tid == 0 && a.phase_ns);\n"),
        ("+ 2 * (size_t)N + r] = 0;\n        }\n        __syncthreads();\n",
         "+ 2 * (size_t)N + r] = 0;\n        }\n        __syncthreads();\n"
         "        KB_MARK(0);\n"),
        ("if (ok) w.flags[r] |= F_DRF;\n            }\n"
         "            __syncthreads();\n",
         "if (ok) w.flags[r] |= F_DRF;\n            }\n"
         "            __syncthreads();\n            KB_MARK(1);\n"),
        ("| (guard ? F_GUARD : 0));\n            }\n"
         "            __syncthreads();\n",
         "| (guard ? F_GUARD : 0));\n            }\n"
         "            __syncthreads();\n            KB_MARK(2);\n"),
        ("        __syncthreads();\n        if (!a.visit) continue;\n",
         "        __syncthreads();\n        KB_MARK(3);\n"
         "        if (!a.visit) continue;\n"),
        ("            out[3] = w.guard[node];\n        }\n    }\n}\n",
         "            out[3] = w.guard[node];\n        }\n"
         "        __syncthreads();\n        KB_MARK(4);\n    }\n"
         "    if (timer_)\n"
         "        for (int p = 0; p < 5; ++p) a.phase_ns[p] = ph_[p];\n}\n"),
        ("    a.out = (void*)ptrs[P_OUT];\n",
         "    a.out = (void*)ptrs[P_OUT];\n"
         "    a.phase_ns = (unsigned long long*)ptrs[P_PHASE];\n"),
        ("kb_victims_workspace(int V, int N) {",
         "kb_victims_resident(int, int, int) { return 264; }\n\n"
         "extern \"C\" int kb_victims_workspace(int V, int N, int) {"),
    ],
    "allocate_scan.cu": [
        ("#include \"node_score.cuh\"\n",
         "#include \"node_score.cuh\"\n" + TIMER_MACRO),
        ("int32_t* __restrict__ packed, int n,",
         "int32_t* __restrict__ packed, unsigned long long* phase_ns, int n,"),
        ("    const int warp = tid >> 5;\n",
         "    const int warp = tid >> 5;\n    KB_TIMER(tid == 0);\n"),
        ("    bool done = false;\n    __syncthreads();\n",
         "    bool done = false;\n    __syncthreads();\n    KB_MARK(0);\n"),
        ("        __syncthreads();\n    }\n\n    if (tid == 0) {",
         "        __syncthreads();\n    }\n    KB_MARK(1);\n\n"
         "    if (tid == 0) {"),
        ("        frame[6] = bound;       // every placement lands in wave "
         "slot 0\n    }\n}\n",
         "        frame[6] = bound;       // every placement lands in wave "
         "slot 0\n    }\n    KB_MARK(2);\n    if (timer_)\n"
         "        for (int p = 0; p < 3; ++p) phase_ns[p] = ph_[p];\n}\n"),
        ("int init_allocated, int dyn_enabled, void* stream) {",
         "int init_allocated, int dyn_enabled, void* phase_ns,\n"
         "        void* stream) {"),
        ("(int32_t*)packed, n, t_pad,",
         "(int32_t*)packed, (unsigned long long*)phase_ns, n, t_pad,"),
        ("}  // namespace\n",
         "}  // namespace\n\nextern \"C\" int kb_allocate_scan_shape("
         "int n, int* info) {\n    info[0] = 1;\n    info[1] = n;\n"
         "    info[2] = 0;\n    return 0;\n}\n"),
    ],
}


#: ``--set fused``: DIR is an unpacked checkout of an earlier commit whose
#: fused loop runs one problem on one 1,024-thread block (one block a lane
#: for mega_fused). Its fused_body.cuh gets the phase timers of this
#: checkout's (CTA 0's thread 0 on the global timer, in shared memory:
#: prologue, loop top and queue pick, job pick, task pick, node pass,
#: argmax in the exchange's slot, update, epilogue; then passes, node
#: solves, 0 runs and its job-less pops as run iterations), and its entry
#: points this checkout's C interface (one byte workspace split into the
#: old int32 and float32 ones, the phase buffer, a cluster argument they
#: ignore, the shape functions).
FUSED_TIMER_MACRO = """
#define KB_MARK(p)                                              \\
    do {                                                        \\
        if (timer_) {                                           \\
            unsigned long long t_;                              \\
            asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); \\
            kb_ph_[p] += t_ - t_last_;                          \\
            t_last_ = t_;                                       \\
        }                                                       \\
    } while (0)
#define KB_COUNT(k, n)                                          \\
    do {                                                        \\
        if (timer_) kb_ph_[8 + (k)] += (n);                     \\
    } while (0)
#define KB_TIMER(cond)                                          \\
    __shared__ unsigned long long kb_ph_[12];                   \\
    const bool timer_ = (cond);                                 \\
    unsigned long long t_last_ = 0;                             \\
    if (timer_) {                                               \\
        for (int k_ = 0; k_ < 12; ++k_) kb_ph_[k_] = 0;         \\
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_last_)); \\
    }
"""
WS_SPLIT = """
// the old int32 workspace of `lanes` problems, then the float32 one
static size_t ws_split(int lanes, int q, int j, int t) {
    return ((size_t)4 * lanes * (q + 4 * j + 1 + t) + 15) & ~(size_t)15;
}

static int old_shape(int n, int t, int j, int q, int* info) {
    for (int k = 0; k < 11; ++k) info[k] = 0;
    info[0] = 1;
    info[1] = n;
    info[8] = (int)(ws_split(1, q, j, t) + 4 * (3 * (size_t)q + 3 * j) + 16);
    return 0;
}
"""
FUSED_EDITS = {
    "fused_body.cuh": [
        ('#include "node_score.cuh"\n',
         '#include "node_score.cuh"\n' + FUSED_TIMER_MACRO),
        ("    // output: int32 [3, T + 1 + TELEM_WIDTH]\n",
         "    unsigned long long* phase_ns;\n"
         "    // output: int32 [3, T + 1 + TELEM_WIDTH]\n"),
        ("    const int lane = tid & 31;\n",
         "    const int lane = tid & 31;\n"
         "    KB_TIMER(blockIdx.x == 0 && tid == 0 && p.phase_ns != nullptr);\n"),
        ("    // ---- the while loop: one placement (or one skip) per "
         "iteration -------\n",
         "    KB_MARK(0);\n"
         "    // ---- the while loop: one placement (or one skip) per "
         "iteration -------\n"),
        ("        if (!s_cont) break;\n        const int current = s_current;\n",
         "        if (!s_cont) break;\n        const int current = s_current;\n"
         "        KB_COUNT(0, 1);\n"),
        ("            __syncthreads();\n            const int qi = s_qi;\n",
         "            __syncthreads();\n            KB_MARK(1);\n"
         "            const int qi = s_qi;\n"),
        ("            if (have_q && !overused) j_sel = job_lex_argmin(p, qi, "
         "s_f, s_i);\n",
         "            if (have_q && !overused) j_sel = job_lex_argmin(p, qi, "
         "s_f, s_i);\n            KB_MARK(2);\n"
         "            if (have_q && (overused || j_sel < 0)) KB_COUNT(3, 1);\n"),
        ("        __syncthreads();\n        const int tstar = s_tstar;\n",
         "        __syncthreads();\n        const int tstar = s_tstar;\n"
         "        KB_MARK(3);\n"),
        ("            const int best = block_argmax(bv, bi, s_f, s_i);\n",
         "            KB_MARK(4);\n"
         "            const int best = block_argmax(bv, bi, s_f, s_i);\n"
         "            KB_MARK(5);\n            KB_COUNT(1, 1);\n"),
        ("        __syncthreads();\n    }\n\n    // ---- epilogue",
         "        __syncthreads();\n        KB_MARK(6);\n    }\n\n"
         "    // ---- epilogue"),
        ("        p.host_block[row * W + T + col] = v;\n    }\n}\n",
         "        p.host_block[row * W + T + col] = v;\n    }\n"
         "    KB_MARK(7);\n    if (timer_)\n"
         "        for (int k_ = 0; k_ < 12; ++k_) p.phase_ns[k_] = kb_ph_[k_];\n"
         "}\n"),
    ],
    "fused_allocate.cu": [
        ("        const void* eps, void* ws_i32, void* ws_f32, void* host_block,\n",
         "        const void* eps, void* ws, void* phase_ns, void* host_block,\n"),
        ("        int dyn_enabled, int max_iters, int narrow, int narrow_gate,\n"
         "        void* stream) {\n",
         "        int dyn_enabled, int max_iters, int narrow, int narrow_gate,\n"
         "        int, void* stream) {\n    void* ws_i32 = ws;\n"
         "    void* ws_f32 = (char*)ws + ws_split(1, n_queues, n_jobs, "
         "n_tasks_total);\n"),
        ("    const Params p = make_params(", "    Params p = make_params("),
        ("        max_iters, narrow, narrow_gate);\n",
         "        max_iters, narrow, narrow_gate);\n"
         "    p.phase_ns = (unsigned long long*)phase_ns;\n"),
        ("}  // namespace\n",
         "}  // namespace\n" + WS_SPLIT
         + "\nextern \"C\" int kb_fused_shape(int n, int t, int j, int q, "
           "int, int* info) {\n    return old_shape(n, t, j, q, info);\n}\n"),
    ],
    "mega_fused.cu": [
        ("        const void* eps, void* ws_i32, void* ws_f32, void* host_block,\n",
         "        const void* eps, void* ws, void* phase_ns, void* host_block,\n"),
        ("        int n_lanes, int n_sigs, void* stream) {\n",
         "        int, int n_lanes, int n_sigs, void* stream) {\n"
         "    void* ws_i32 = ws;\n"
         "    void* ws_f32 = (char*)ws + ws_split(n_lanes, n_queues, n_jobs, "
         "n_tasks_total);\n"),
        ("    const Params p = make_params(", "    Params p = make_params("),
        ("        max_iters, narrow, narrow_gate);\n",
         "        max_iters, narrow, narrow_gate);\n"
         "    p.phase_ns = (unsigned long long*)phase_ns;\n"),
        ("}  // namespace\n",
         "}  // namespace\n" + WS_SPLIT
         + "\nextern \"C\" int kb_mega_shape(int n, int t, int j, int q, "
           "int, int, int* info) {\n    return old_shape(n, t, j, q, info);\n"
           "}\n"),
    ],
}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def timed_sources(csrc: str, file_edits=None) -> str:
    """A copy of an earlier csrc/ whose one-CTA kernels carry the phase
    timers and the cluster kernels' C interface (EDITS, or file_edits)."""
    out = os.path.join(OUT_DIR, "before_src")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for src, edits in (file_edits or EDITS).items():
        path = os.path.join(out, src)
        with open(path) as f:
            text = f.read()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{src}: anchor found {text.count(old)} "
                                   f"times: {old!r}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    return out


def build(csrc: str, tag: str, sources=SOURCES) -> dict:
    from kubebatch_tpu_torch.kernels import _build

    out_dir = os.path.join(OUT_DIR, tag)
    os.makedirs(out_dir, exist_ok=True)
    procs = []
    for src in sources:
        target = os.path.join(out_dir, f"lib{src[:-3]}.so")
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", target,
               os.path.join(csrc, src)]
        procs.append((src, target, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = {}
    for src, target, proc in procs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {target}:\n{text}")
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {tag}/{src}: {line.strip()}")
        lib = ctypes.CDLL(target)
        for fn, kinds in _build.EXPORTS[src].items():
            f = getattr(lib, fn)
            f.argtypes = [ctypes.c_void_p if k == "p" else ctypes.c_int
                          for k in kinds]
            f.restype = ctypes.c_int
        libs[src] = lib
    return libs


def pick(seq, k: int) -> list:
    """k evenly spaced items of seq (all when fewer), first and last
    included."""
    if len(seq) <= k:
        return list(seq)
    return [seq[round(i * (len(seq) - 1) / (k - 1))] for i in range(k)]


def record_victim_inputs(dev) -> list:
    """(label, kind, kw) of each victim launch, from the port's own
    cycles: kind "wave" or "visit", kw the wrapper's arguments."""
    import dataclasses

    import chip_smoke as cs
    import numpy as np

    from kubebatch_tpu_torch.api import TaskStatus
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import victims
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    calls = []
    # cfg4 saturated: the preempt cycle's full wave and refreshes
    sim4 = build_cluster(dataclasses.replace(BASELINE_SPECS[4],
                                             running_fill=0.95))
    cache4 = SchedulerCache(device=dev, binder=NullBinder(),
                            evictor=cs.CountingEvictor())
    sim4.populate(cache4)
    with cs.Recorder(victims, "victim_wave") as rec:
        cs.run_cycle(cache4, shipped_tiers())
    full = [kw for kw, _ in rec.calls if kw["p_job"].shape[0] >= 8]
    single = [kw for kw, _ in rec.calls if kw["p_job"].shape[0] == 1]
    log(f"cfg4: {len(rec.calls)} waves, {len(full)} full, {len(single)} "
        f"single-lane")
    calls.append((f"cfg4 full wave ({full[0]['p_job'].shape[0]} lanes)",
                  "wave", full[0]))
    for k, kw in enumerate(pick(single, 12)):
        calls.append((f"cfg4 refresh {k}", "wave", kw))
    cache4.stop()

    # cfg5: cold, then one skewed churn cycle (reclaim's one-lane wave)
    sim = build_cluster(BASELINE_SPECS[5])
    cache = SchedulerCache(device=dev, binder=cs.RecordingBinder(),
                           evictor=cs.CountingEvictor())
    sim.populate(cache)

    def kubelet_tick():
        for pod in sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)

    cs.run_cycle(cache, shipped_tiers())
    kubelet_tick()
    sim.churn_tick(cache, 256, arrival_queue=0)
    with cs.Recorder(victims, "victim_wave") as rec:
        cs.run_cycle(cache, shipped_tiers())
    for kw, _ in rec.calls:
        calls.append((f"cfg5 wave ({kw['p_job'].shape[0]} lane)", "wave",
                      kw))
    # (b) at that state: 256-lane waves of the three filter kinds, a visit
    kubelet_tick()
    sim.churn_tick(cache, 256, arrival_queue=0)
    ssn = OpenSession(cache, shipped_tiers())
    pending = [t for j in ssn.jobs.values()
               for t in j.task_status_index.get(TaskStatus.PENDING,
                                                {}).values()]
    pre = victims.build_victim_solver(ssn, pending, "preemptable_fns",
                                      "preemptable_disabled", True)
    rcl = victims.build_victim_solver(ssn, pending, "reclaimable_fns",
                                      "reclaimable_disabled", False)
    width = min(256, len(pending))
    chunk = pending[:width]
    for solver, kinds in ((pre, ("inter_queue", "intra_job")),
                          (rcl, ("other_queue",))):
        kw = solver.kernel_args(chunk, width)
        for fk in kinds:
            calls.append((f"cfg5 {fk} wave ({width} lanes)", "wave",
                          {**kw, **solver.config(fk)}))
    visited = np.zeros(pre.state.n_pad, bool)
    kw = pre.kernel_args(chunk[:1], 1, visited=visited)
    calls.append(("cfg5 visit", "visit", {**kw,
                                          **pre.config("inter_queue")}))
    CloseSession(ssn)
    cache.stop()
    return calls


def record_scan_inputs(dev) -> list:
    """(label, "scan", kw) of a sample of the allocate_scan launches of
    a solver="jax" cold cfg5 period and a custom-order cfg3 period."""
    import chip_smoke as cs

    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.framework.registry import \
        register_plugin_builder
    from kubebatch_tpu_torch.runtime import Scheduler
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster

    conf = open(os.path.join(HERE, "config", "kube-batch-conf.yaml")).read()
    register_plugin_builder("fifo-order", cs.FifoOrder)
    fifo_conf = conf.replace("  - name: priority",
                             "  - name: fifo-order\n  - name: priority", 1)
    calls = []
    for label, spec, tiers_conf, mode in (
            ("cfg5 jax", BASELINE_SPECS[5], conf, "jax"),
            ("cfg3 custom order", BASELINE_SPECS[3], fifo_conf, "fused")):
        sim = build_cluster(spec)
        cache = SchedulerCache(device=dev, binder=cs.RecordingBinder(),
                               async_writeback=False)
        sim.populate(cache)
        sched = Scheduler(cache, tiers_conf, solver=mode)
        with cs.ScanRecorder() as rec:
            sched.run_cycle()
        log(f"{label}: {len(rec.calls)} allocate_scan launches")
        for k, (kw, _) in enumerate(pick(rec.calls, 12)):
            calls.append((f"{label} visit {k} (T_pad "
                          f"{kw['resreq'].shape[0]})", "scan", kw))
        cache.stop()
    return calls


def record_fused_inputs(dev, tenants: int = 13) -> list:
    """(label, kind, payload) of fused launches from the port's own
    cycles: kind "fused" (fused_allocate's keyword arguments) or "mega"
    ((stacked tensors, statics)). cfg5's churn-256 cycles after its cold
    cycle (the shipped actions, allocate in auto: fused under 512
    pending), the cold fused solves of cfg5, cfg3 and cfg2, and the fused
    lanes of ``tenants`` cfg5 tenants (seeds 0..) after a cold cycle and a
    churn of 256, through the wire's bytes: 8 of them as one mega launch,
    lane 0 as a one-lane launch and as a single fused launch, and 13 as
    one launch."""
    import chip_smoke as cs
    import torch

    from kubebatch_tpu_torch.actions import allocate_fused
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels.mega import ARG_NAMES
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.rpc.client import build_snapshot
    from kubebatch_tpu_torch.rpc.server import fused_lane_args
    from kubebatch_tpu_torch.rpc.wire import SnapshotRequest
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, build_cluster
    from kubebatch_tpu_torch.sim.tenants import _tenant_cluster
    from kubebatch_tpu_torch.tenantsvc.megasolve import (_stack_lanes,
                                                         lane_key)

    calls = []
    sim = build_cluster(BASELINE_SPECS[5])
    cache = SchedulerCache(device=dev, binder=cs.RecordingBinder(),
                           evictor=cs.CountingEvictor())
    sim.populate(cache)
    cs.run_cycle(cache, shipped_tiers())
    with cs.Recorder(allocate_fused, "fused_allocate") as rec:
        for _ in range(3):
            for pod in sim.pods:
                if pod.node_name and pod.phase == PodPhase.PENDING:
                    pod.phase = PodPhase.RUNNING
                    cache.update_pod(pod, pod)
            sim.churn_tick(cache, 256)
            cs.run_cycle(cache, shipped_tiers())
    if not rec.calls:
        raise AssertionError("no fused launch in the cfg5 churn cycles")
    for k, (kw, _) in enumerate(rec.calls, 1):
        calls.append((f"cfg5 churn-256 cycle {k}", "fused", kw))
    cache.stop()
    for cfg in (5, 3, 2):
        kw, statics = cs.build_session_inputs(cfg, dev)
        calls.append((f"cfg{cfg} cold", "fused", dict(kw, **statics)))
    lanes = []
    for seed in range(tenants):
        sim, cache, binder = _tenant_cluster(seed, 5, dev)
        ssn = OpenSession(cache, shipped_tiers())
        AllocateAction(mode="auto").execute(ssn)
        CloseSession(ssn)
        for pod in binder.fresh:
            pod.phase = PodPhase.RUNNING
            cache.update_pod(pod, pod)
        sim.churn_tick(cache, 256)
        ssn = OpenSession(cache, shipped_tiers())
        req, _ = build_snapshot(ssn)
        CloseSession(ssn)
        cache.stop()
        lanes.append(fused_lane_args(
            SnapshotRequest.FromString(req.SerializeToString())))
    key = lane_key(*lanes[0])
    same = [lane for lane in lanes if lane_key(*lane) == key]
    log(f"tenant lanes: {len(same)} of {len(lanes)} share lane 0's key")

    def stacked(group):
        return ([torch.from_numpy(a).to(dev)
                 for a in _stack_lanes([a for a, _ in group])], group[0][1])

    calls.append((f"mega {min(8, len(same))} lanes (cfg5 tenants, churn "
                  f"256)", "mega", stacked(same[:8])))
    calls.append(("mega 1 lane (tenant 0)", "mega", stacked(same[:1])))
    one = {k: torch.from_numpy(a).to(dev)
           for k, a in zip(ARG_NAMES, same[0][0])}
    calls.append(("single launch of tenant 0's lane", "fused",
                  dict(one, **same[0][1])))
    many = (same * 13)[:13]
    calls.append((f"mega 13 lanes ({len(same[:13])} distinct tenants)",
                  "mega", stacked(many)))
    return calls


def launch_fused(kind, payload):
    from kubebatch_tpu_torch.kernels import fused, mega

    if kind == "mega":
        args, statics = payload
        return list(mega.mega_fused(*args, **statics)), fused.last_launch
    return list(fused.fused_allocate(**payload)), fused.last_launch


#: the kernel each kind of launch runs, as the profiler names it
KERNEL = {"wave": "victims_kernel", "visit": "victims_kernel",
          "scan": "allocate_scan_kernel", "fused": "fused_allocate_kernel",
          "mega": "mega_fused_kernel"}


def time_fused(args, report) -> list:
    """--set fused: every recorded launch through the earlier build and
    this one in turns (before, after, after, before), then this build
    without its phase timers and at forced cluster sizes; every output
    bitwise the earlier build's."""
    import chip_smoke as cs
    import torch

    from kubebatch_tpu_torch.kernels import _build, fused

    before_src = timed_sources(os.path.join(
        os.path.abspath(args.before), "kubebatch_tpu_torch", "kernels",
        "csrc"), FUSED_EDITS)
    t0 = time.perf_counter()
    _build.build_all()
    libs = {"after": build(str(_build.CSRC), "after", FUSED_SOURCES),
            "before": build(before_src, "before", FUSED_SOURCES)}
    report["build_s"] = time.perf_counter() - t0
    log(f"builds {report['build_s']:.1f} s; {report['card']}")
    modes = {"before": ("before", 0, True), "after": ("after", 0, True),
             "after_untimed": ("after", 0, False)}
    for c in (1, 2, 4, 8, 16):
        modes[f"after_c{c}"] = ("after", c, True)

    def use(which):
        tag, fused.CLUSTER, fused.PHASE_TIMERS = modes[which]
        for s in FUSED_SOURCES:
            _build._libs[s] = libs[tag][s]
        fused._shapes.clear()

    use("after")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    calls = record_fused_inputs(dev)
    report["record_s"] = time.perf_counter() - t0
    log(f"inputs recorded in {report['record_s']:.1f} s: "
        + ", ".join(c[0] for c in calls))
    names = fused.FUSED_PHASES + fused.FUSED_COUNTS
    rows = []
    for label, kind, payload in calls:
        order = ["before", "after", "after", "before", "after_untimed"]
        n_pad = (payload[0][0] if kind == "mega" else payload["idle"]).shape[
            -2]
        order += [f"after_c{c}" for c in (1, 2, 4, 8, 16)
                  if c == 1 or c * 1024 <= 2 * n_pad]
        res, times, phases, shape, dev_ms = {}, {}, {}, {}, {}
        for which in order:
            use(which)
            best = None
            for _ in range(3):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out, last = launch_fused(kind, payload)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                best = ms if best is None else min(best, ms)
            times.setdefault(which, []).append(best)
            if which not in dev_ms:
                dev_ms[which] = cs.profiled_ms(
                    lambda: launch_fused(kind, payload), KERNEL[kind],
                    reps=3)
            got = [o.detach().cpu().contiguous() for o in out]
            if which not in res:
                res[which] = got
                shape[which] = {k: v for k, v in last.items()
                                if k != "phase_ns"}
                if last["phase_ns"] is not None:
                    pn = last["phase_ns"].cpu().tolist()
                    phases[which] = {
                        k: (v / 1e6 if k in fused.FUSED_PHASES else v)
                        for k, v in zip(names, pn)}
        equal = {w: len(res[w]) == len(res["before"]) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(res[w], res["before"]))
            for w in res if w != "before"}
        row = {"label": label, "kind": kind,
               "ms": {k: min(v) for k, v in times.items()},
               "device_ms": dev_ms, "runs_ms": times,
               "equal_to_before": equal, "phase_ms": phases,
               "launch": shape}
        rows.append(row)
        log(f"{label}: ms " + json.dumps({k: round(v, 4) for k, v in
                                          row["ms"].items()})
            + "; device (profiler) " + json.dumps(dev_ms)
            + f"; equal to before {json.dumps(equal)}")
        for which, ph in phases.items():
            ph = {k: round(v, 4) for k, v in ph.items()}
            log(f"  {which} phases {json.dumps(ph)} launch "
                f"{json.dumps(shape[which])}")
    use("after")
    return rows


def launch(kind, kw):
    from kubebatch_tpu_torch.kernels import solver, victims

    if kind == "scan":
        return list(solver.allocate_scan(**kw)), solver.last_launch
    fn = victims.victim_visit if kind == "visit" else victims.victim_wave
    return [fn(**kw)], victims.last_launch


def cluster_probe(iters: int = 4000) -> dict:
    """csrc/chain_probe.cu's cluster probe at C = 1, 2, 8 and 16 CTAs of
    512 and 1,024 threads: us per cluster barrier, per dependent DSMEM
    load and per block barrier (the best of three launches)."""
    import torch

    from kubebatch_tpu_torch.kernels import _build

    lib = _build.library("chain_probe.cu")
    out = torch.zeros(4, dtype=torch.int64, device="cuda")
    res = []
    for threads in (512, 1024):
        for c in (1, 2, 8, 16):
            info = (ctypes.c_int * 2)(threads, 0)
            best = None
            for _ in range(3):
                _build.check_launch("cluster_probe", lib.kb_cluster_probe(
                    c, iters, out.data_ptr(), info,
                    torch.cuda.current_stream().cuda_stream))
                torch.cuda.synchronize()
                ns = out.cpu().tolist()
                best = ns if best is None else [min(a, b) for a, b in
                                                zip(best, ns)]
            res.append({"cluster": c, "threads": threads, "iters": iters,
                        "cluster_sync_us": best[0] / iters / 1e3,
                        "dsmem_load_us": best[1] / iters / 1e3,
                        "block_sync_us": best[2] / iters / 1e3})
    return {"probes": res}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--before", required=True)
    ap.add_argument("--set", choices=("victims", "fused"), default="victims")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "report.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        log("cluster_timing: torch.cuda.is_available() is False")
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    import kubebatch_tpu_torch.actions  # noqa: F401
    import kubebatch_tpu_torch.plugins  # noqa: F401
    from kubebatch_tpu_torch.kernels import _build, solver, victims

    dev = torch.device("cuda")
    report = {"card": cs.card_line(), "kind": torch.cuda.get_device_name(0),
              "set": args.set}
    if args.set == "fused":
        rows = time_fused(args, report)
        return finish(report, rows, args.out)
    t0 = time.perf_counter()
    before_src = timed_sources(os.path.join(
        os.path.abspath(args.before), "kubebatch_tpu_torch", "kernels",
        "csrc"))
    _build.build_all()
    libs = {"after": build(str(_build.CSRC), "after"),
            "before": build(before_src, "before")}
    report["build_s"] = time.perf_counter() - t0
    log(f"builds {report['build_s']:.1f} s; {report['card']}")

    cluster, nt = victims.CLUSTER, victims.NT
    modes = {
        "before": ("before", 1, nt),
        "after": ("after", cluster, nt),
        "after_c1": ("after", 1, nt),
        "after_nt1024": ("after", cluster, 1024),
    }

    def use(which):
        lib_tag, victims.CLUSTER, victims.NT = modes[which]
        for s in SOURCES:
            _build._libs[s] = libs[lib_tag][s]
        victims._resident.clear()

    use("after")
    t0 = time.perf_counter()
    calls = record_victim_inputs(dev) + record_scan_inputs(dev)
    report["record_s"] = time.perf_counter() - t0
    log(f"inputs recorded in {report['record_s']:.1f} s: "
        + ", ".join(c[0] for c in calls))
    names = {"wave": victims.PHASES, "visit": victims.PHASES,
             "scan": solver.SCAN_PHASES}
    rows = []
    for label, kind, kw in calls:
        order = ["before", "after", "after", "before"]
        if kind == "wave" and kw["p_job"].shape[0] > 1:
            order += ["after_c1", "after_c1"]
        if kind != "scan":
            order += ["after_nt1024", "after_nt1024"]
        res, times, b2b, phases, shape, dev_ms = {}, {}, {}, {}, {}, {}
        for which in order:
            use(which)
            best = None
            for _ in range(3):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out, last = launch(kind, kw)
                end.record()
                torch.cuda.synchronize()
                ms = start.elapsed_time(end)
                best = ms if best is None else min(best, ms)
            times.setdefault(which, []).append(best)
            b2b.setdefault(which, []).append(
                cs.cuda_ms(lambda: launch(kind, kw), reps=20))
            if which not in dev_ms:
                dev_ms[which] = [cs.profiled_ms(
                    lambda: launch(kind, kw), KERNEL[kind], reps=10)]
            got = [o.detach().cpu().contiguous() for o in out]
            if which not in res:
                res[which] = got
                pn = last["phase_ns"].cpu().tolist()
                phases[which] = {k: v / 1e6 for k, v in zip(names[kind], pn)
                                 if v}
                shape[which] = {k: v for k, v in last.items()
                                if k != "phase_ns"}
        equal = {w: len(res[w]) == len(res["before"]) and all(
            a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(res[w], res["before"]))
            for w in res if w != "before"}
        row = {"label": label, "kind": kind,
               "ms": {k: min(v) for k, v in times.items()},
               "back_to_back_ms": {k: min(v) for k, v in b2b.items()},
               "device_ms": {k: min((x for x in v if x is not None),
                                    default=None)
                             for k, v in dev_ms.items()},
               "runs_ms": times, "equal_to_before": equal,
               "phase_ms": phases, "launch": shape}
        rows.append(row)
        log(f"{label}: ms " + json.dumps({k: round(v, 4) for k, v in
                                          row["ms"].items()})
            + "; back to back " + json.dumps(
                {k: round(v, 4) for k, v in row["back_to_back_ms"].items()})
            + "; device (profiler) " + json.dumps(row["device_ms"])
            + f"; equal to before {json.dumps(equal)}")
        for which, ph in phases.items():
            ph = {k: round(v, 4) for k, v in ph.items()}
            log(f"  {which} phases {json.dumps(ph)} launch "
                f"{json.dumps(shape[which])}")
    use("after")
    return finish(report, rows, args.out)


def finish(report: dict, rows: list, out: str) -> int:
    """The probes, the report (printed and written to ``out``); 1 when a
    launch differed from the earlier build."""
    import chip_smoke as cs

    report["launches"] = rows
    report["cluster_probe"] = cluster_probe()
    log(f"cluster probe: {json.dumps(report['cluster_probe'])}")
    report["grid_barrier"] = cs.grid_barrier_us()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
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
