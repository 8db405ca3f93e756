"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from kubebatch_tpu_torch/kernels/csrc,
holds each against its plain PyTorch version on the card, then drives the
port's main path at cfg5's full width (5,000 nodes, 1,250 gangs x 8 pods,
4 queues weighted 1-4, +-20% request jitter) in auto mode: a cold
allocate cycle that binds the backlog (10,000 pending: the batched round
engine, csrc/batched_allocate.cu), a kubelet tick, a churn of 256 pods,
and a steady cycle (256 pending: the fused engine,
csrc/fused_allocate.cu). It checks engine, kernel launches, one counted
device->host copy per solve, gang all-or-nothing, and that every solve's
packed result equals the plain version's word for word (the plain batched
engine runs on CPU copies of the kernel's inputs); on cfg2 the fused
cycle must also bind exactly what the host oracle binds. The fused
kernel, no longer the cold path, stays held against its plain version on
a cfg5 cold solve. It then times the kernels at the main path's shapes,
with beside each its roofline bound and, for the fused solve (one
thread-block cluster: csrc/fused_body.cuh), its cluster shape, the
residency of its state, its phase timers and the floor of its design:
node solves x (one cluster barrier + the block barriers left), measured
with csrc/chain_probe.cu's cluster probe.

The shipped policy's four actions (reclaim, allocate, backfill, preempt)
then run on a fresh cfg5 cache: a cold cycle (no victim work), and two
skewed churn cycles (256 pods into queue 0, then queue 3) in which
reclaim's prefetch launches the victim-analysis kernel
(csrc/victims.cu) once each; every launch is held against its plain
version. At that state the wave kernel runs on 256-lane chunks for each
filter kind and the visit kernel on 8 lanes (the shapes a contended cfg5
cycle dispatches), checked and timed. Last, a saturated cfg4 (2,000
nodes, running fill 0.95) runs one four-action cycle in which preempt
evicts and pipelines through the victim kernels; a fixed sample of its
launches is held against the plain versions, its counts (9 full waves,
4,191 single-lane refreshes, 4,200 evictions, 4,200 pipelined, none left
pending) must be the ones the port has always made, and it prints a
refresh launch's shape and cluster, the kernels' per-phase device times
and the preempt span beside its launches' device total (the host's
share). The victim kernels run one lane over a thread-block cluster of
8 CTAs, the per-visit scan one visit over a cluster; the kernels line
gives each its cluster shape and per-phase device ms. Phases (a)-(c) run on
incremental caches, the default (the allocate-only cfg5 cycles above
stay snapshot-primary).

Phase (d) is the steady cycle the way kube-batch runs it every period:
an incremental cfg5 cache (the event fold: folded snapshots, dirty node
rows refreshed on the card by csrc/scatter_rows.cu, the persistent
victim segment store) and a snapshot-primary twin fed the same events, a
cold cycle and eight skewed churn-256 cycles through the four shipped
actions. Every cycle the folded snapshot passes the audit, both caches
decide alike, every scatter equals its plain version and leaves the
DeviceSession equal to a fresh build, and every victim_wave launch
equals its plain version; per-phase host ms of both caches are printed.

Phase (e) is the predicate-rich configurations through the shipped
policy on incremental caches: 5p (cfg5's shape with 16 zones,
selectors, taints, required anti-affinity, zone affinity, preferred
co-location and host ports) cold, then a churn-256 cycle, then 3p cold
and two skewed churn-256 cycles. A cold cycle's allocate runs the
affinity branch of the batched kernel (one launch, one counted sync, no
affinity host fallback), held bitwise against the plain engine with its [A,D] carry
and port claims, the final state validated against the affinity and
host-port predicates; a churn cycle's allocate runs the host loops, the
reference's route for a fused request on an affinity snapshot (the
reason from dynamic_features asserted), while reclaim's victim waves
fold the affinity masks into the node choice, each launch bitwise equal
to plain. The 5p cold launch is timed (events, profiler, the phase
timers' affinity phases) beside its bound.

Phase (f) is the scheduler loop, the port's entry point: a
``runtime.Scheduler`` (the shipped conf, ``subcycle=True``) on an
incremental cfg5 cache runs phase (a)'s three periods as guarded cycles
(the same placements, no cycle failure, ladder level 0, host ms per
action from the spans); a fault plan fails ``device.dispatch`` six
times while churn piles up, the ladder falls to level 2 and stays there
(over a CUDA cache the card's "fused" tier is its last: the host loops
are a CPU cache's level 3 only), its cycle runs fused, capped and
counted, and healthy cycles climb back to level
0 through the subprocess CUDA probe (a 1 s cooldown); 64 latency-lane
pods arrive through ``cache.add_pod`` and sub-cycles place them (one
``allocate_scan`` launch and one counted sync a visit; the next full
cycle re-places none). Then ``solver="jax"`` runs a cold cfg5 period,
1,250 visits on csrc/allocate_scan.cu, whose decisions must equal a CPU
cache's fed the same events, and a custom job order on cfg3 takes the
fused -> visit route. Every ``allocate_scan`` launch is recorded and
held bitwise against the plain scan on the card; the kernel is timed at
one cfg5 gang beside its bound.

Phase (g) is the scale engines: cfg6 (50,000 nodes, 6,250 gangs x 8) on
an incremental cache with its allocate-only conf, in auto. The cold
cycle (50,000 pending) runs the two-level solve, one launch of
csrc/hier_allocate.cu; six skewed churn cycles (256, 256, 1,024, 1,024,
4,096 and 4,096 pods, into queue 0 then 3) run the active set at every
grain in the same kernel, the audit (active-set and full-width solves in
one launch, compared in the kernel) on cycles 0 and 3; then one cold
cfg7 cycle (100,000 nodes, 13,000 gangs x 8). Every cycle: the engine,
one launch, one counted sync, every pod bound, gang all-or-nothing and
every node within its capacity (summed on the host from the sim's
pods); every cfg6 launch bitwise equal to its plain version on CPU
copies (packed result, frame and committed carry), its work counters
beside the plain version's; two audits with no divergence, no demotion.
cfg7 checks the invariants only (its plain comparison, a full-width
coarse pass of ~1e10 cells a wave on the host, is left out). The
launches are timed (events, profiler) beside their bounds.

Phase (h) is the observability plane: a saturated cfg4 (phase (c)'s
cluster) through ``Scheduler(explain_unschedulable=True, slo=True)`` on
the default conf, with the flight recorder, the timeline and the Chrome
trace export armed into build/chip_smoke_obs, beside a twin loop
without the explainer fed the same events (run with the decision ledger
and the cycle hooks off): a cold period and a kubelet tick + churn-256
period, each one ``explain_counts`` launch (csrc/explain_counts.cu) and
one counted sync more than the twin, ``resources`` among the reasons;
every launch bitwise equal to its plain version on the card, the
fresh-inputs device pass equal to the host oracle; the five debug
endpoints (127.0.0.1, an ephemeral port) answer and /debug/explain is
the latest snapshot; the ledger closed one record per bind; an injected
``device.dispatch`` failure and the ``obs.slo`` seam each write a flight
dump that parses. Then 5p and 3p cold periods through the shipped
policy, and the kernel at full width on fresh cold cfg5 and 5p sessions
(T_pad 16,384 x N_pad 8,192; 5p with its 12 host ports), checked and
timed (events, profiler) beside its bound and the plain version.

Phase (i) is the tenant solve service: eight cfg5 tenants (seeds 0-7,
uncut) through one ``TenantSolveService`` on the card, one thread each,
every request and answer through the wire's bytes (rpc/wire.py): a cold
cycle each (10,000 pending: a single, one batched_allocate launch), then
three churn-256 cycles whose fused lanes coalesce as they come; the end
states of tenants 0 and 1 equal dedicated in-process auto runs. Each
steady cycle's eight requests then go through ``solve_many``: one 8-lane
launch of csrc/mega_fused.cu (one cluster per lane, N_pad 8,192), bitwise
equal to the plain version and to eight single fused_allocate launches,
its decisions equal to ``solve_snapshot``'s; the launch is timed against
the eight single launches back to back. A 3p tenant's cold request takes
the service's affinity single and equals the in-process batched cycle;
``run_saturation`` measures solves/s at capacity and the tail under 2x
offered load on the eight steady requests; ``run_multi_tenant`` runs
four "t" tenants against their dedicated runs.

Phase (j) is the pipelined executor at cfg6 (uncut, allocate-only, in
auto): a sequential ``Scheduler`` on one incremental cache (cold: the
two-level solve; eight churn-256 and two churn-1,024 cycles with
kubelet ticks), then ``Scheduler(pipeline=True)`` on a second cache fed
the same events: each churn cycle dispatches the active-set solve in
place on the DeviceSession's carry (csrc/hier_allocate.cu) and returns,
and the next cycle consumes it through one deferred readback. Binds and
statuses must equal the sequential twin's, each dispatch one in-place
launch and one deferred readback with no blocking one; the window from
each launch to its consume runs under ``set_sync_debug_mode("warn")``
and every synchronizing call is reported with its site. A capacity
change on a node the in-flight decisions bind to must invalidate the
consume, swap the pre-dispatch carry back bit for bit and re-solve; a
``pipeline.conflict`` seam storm demotes the executor and later cycles
bind sequentially. Every in-place launch is held bitwise against the
plain version and its work counters; per cycle the host walls
(pipelined against sequential), the wait at consume, the kernel's event
time and the deferred copy are printed, and the launch is timed in
place against cloning at each grain.

Phase (k) is the node-sharded engines (kernels/batched_sharded.py,
kernels/sharded.py): k = 2 and 4 ranks of a gloo process group on the
one card, rank 0 here and k - 1 solver workers spawned through
kubebatch_tpu_torch/parallel/worker.py (each reports that it imported no
jax). cfg5 cold through ``AllocateAction(mode="sharded", mesh=...)``
must bind and leave statuses exactly as a one-card batched twin with
``compact_bucket=0`` does, with only csrc/sharded_round.cu launched and
the same launch count on every rank; the same cold inputs then run
again with every rank holding each launch bitwise against the plain
version on its own inputs. At k = 2 ``Scheduler(mesh=...)`` in auto
takes a cold cycle and two churn-256 cycles (sharded, fused, fused); at
k = 4 the explicit-collective scan runs at T 256 x N_pad 8,192
(csrc/sharded_scan.cu, one launch a step over a thread-block cluster),
checked the same way and against the plain ranks, then in lock step
(``scan_lockstep(..., "cuda")``: checked, then once unchecked; rank 0's
device ms over the unchecked scan, a launch's ms and phase ms beside
its bound a launch, go into the kernels line's ``lockstep_ms``). Per
rank: launches, device ms by step,
collectives, stages and their host ms. Last, cfg5's sharded inputs at
k = 2 run once more in lock step (``solve_lockstep(..., "cuda",
check=True)``: the k ranks in this process, each launch alone on the
card, every launch held against the plain version), then once
unchecked; rank 0's device ms in the unchecked solve goes beside the
mesh's (time-sliced) in the kernels line.

Phase (l) is the predicate-rich and two-level mesh, run in phase (k)'s
groups: at k = 2, (l1) 5p cold (full width: 5,000 nodes, 10,000 pods,
16 zones, both affinities, host ports) through ``Scheduler(mesh=...)``
in auto, which must run the sharded engine with the affinity branch of
csrc/sharded_round.cu, count no ("sharded", "batched") demotion and no
host fallback, and bind and leave statuses exactly as a one-card
``Scheduler`` whose batched solve has compact_bucket=0 (unchecked per
launch: the plain 5p solve takes minutes on the host); (l3) cfg6 cold
through ``hier.solve_hier_sharded`` (the two-level steps of the same
source), equal to one launch of csrc/hier_allocate.cu with the same pool
on the same bucket, then again with every launch on every rank held
against the plain version; at k = 2 and 4, (l2) 3p cold through
``solve_batched_sharded``, equal to the one-card batched kernel (its
[P,D] carry and port claims too), then every launch on every rank held
against the plain version. Per rank: launches, device ms by step,
collectives, stages and their host ms; waves, rounds and the straddling
pools met.

Last, csrc/chain_probe.cu's grid probe times a grid barrier of the
round kernels' cooperative grid (one 512-thread block per SM), and the
round kernels' launches named in DIGEST_LAUNCHES (cfg5, 5p, 3p, cfg6
and cfg7 cold) are held to the digests in
kubebatch_tpu_torch/kernels/round_digests.json, recorded from an earlier
build of the kernels: the same inputs must give the same packed result
and carries word for word. That is how cfg7, whose plain solve is left
out, is held to the earlier kernels. The per-phase device timers of
those launches print with the chain phases' share.

Output: progress lines, then the card's name and power limit
(nvidia-smi), a {"kernels": [...]} line, and as the last line
{"ok": true, "device": {...}}. Any failed check raises: the script exits
non-zero without the last line. It needs torch with CUDA and the repo
checkout around it (it imports kubebatch_tpu_torch from its own
directory); it imports nothing of jax or the reference package.
"""
from __future__ import annotations

import dataclasses
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
#: barriers of a node solve of the cluster design (csrc/fused_body.cuh)
#: besides its one cluster barrier (a block barrier at C = 1): the block
#: barrier before a CTA publishes its candidate; a pass that pops a queue
#: adds two more (the loop top's and the job pick's)
BLOCK_BARRIERS_PER_SOLVE = 1
#: float32 operations per task x node cell of a batched row pass (three
#: fit compares and the score compare; three more with pipelining) and per
#: pair x node cell of the pair scores (the dynamic score and the add) —
#: counted from kernels/csrc/batched_allocate.cu row_pass / pair_scores
OPS_PER_CELL_BATCHED = 4
OPS_PER_CELL_PIPE = 3
OPS_PER_PAIR_CELL = OPS_PER_NODE_SCORE + 1
#: H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and
#: float32 operations/s outside the tensor cores without FMA contraction.
#: The data sheet's 67 TFLOP/s counts a fused multiply-add as two
#: operations; the sources are built with -fmad=false, so every operation
#: is one instruction and the lanes issue half that rate.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 33.5e12
#: 32-bit integer and logical instructions/s: compute capability 9.0
#: issues 64 of them per clock per SM against 128 float32 adds or
#: multiplies (CUDA C++ Programming Guide, arithmetic instruction
#: throughput), half the float32 rate above
PEAK_I32_PER_S = PEAK_F32_PER_S / 2
#: 32-bit integer operations per task x node cell of the affinity and
#: host-port predicates (batched_allocate.cu aff_cell) at the least: the
#: cell's 24 32-bit inputs (need, anti, grp, present, sym on each half of
#: the two pair words, ports and used on the port word's halves) folded
#: to one by three-input logic operations (LOP3: 12), then the zero test
OPS_PER_CELL_AFF = 13
#: float32 operations per scoring task x node cell of the interpod score
#: besides the count sums (batched_allocate.cu ip_counts and row_pass:
#: own + sym, the min and max, c - cmin, 10 *, / span, floor, * weight,
#: the add to the pair score); the sums add two per preferred term
#: (multiply, add) and one per group bit
OPS_PER_IP_CELL = 9
#: float32 operations per victim row of one lane's analysis, counted from
#: kernels/csrc/victims.cu: the drf tier (the scan's ~2 combines of 3
#: adds, excl, cum, the job's allocation minus it, share3's 3 divisions
#: and 2 maxima, the 1e-6 test: 24), the proportion tier (scan 6, excl,
#: before, after 9, le_eps 3 x 4, guard 3: 30), the victim totals (3)
OPS_PER_ROW_DRF = 24
OPS_PER_ROW_PROP = 30
OPS_PER_ROW_TOTALS = 3
#: the four actions of the shipped policy (conf.CONFIG_ACTIONS[4], [5])
SHIPPED_ACTIONS = ("reclaim", "allocate", "backfill", "preempt")


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
    """The fused solve's roofline for one run, from its inputs and
    results: each input read once and each output written once over the
    memory rate, against the node passes' float operations over the
    float32 rate, counted over the real nodes (``node_ok``), not the
    padded axis."""
    frame = out[0][0, -20:].tolist()
    iters, n_solves = frame[1], frame[2] + frame[3]     # placed + failed
    n_pad = kw["idle"].shape[0]
    n_real = int(kw["node_ok"].sum())
    nbytes = sum(t.numel() * t.element_size() for t in kw.values()
                 if hasattr(t, "numel"))
    nbytes += sum(t.numel() * t.element_size() for t in out)
    b_ms, b_by = bound(nbytes, n_solves * n_real * OPS_PER_NODE_FUSED)
    return {"iters": iters, "n_solves": n_solves, "n_pad": n_pad,
            "n_real": n_real, "bound_ms": b_ms, "bound_by": b_by}


def batched_bounds(kw, out, stats, pipe: bool) -> dict:
    """The batched solve's roofline for one run: each input read once and
    each output written once over the memory rate, against the two row
    passes' cells (task rows x nodes, counted by the plain engine on the
    same inputs) and the [P,N] pair-score cells, per round, over the
    float32 rate."""
    n_pad = kw["idle"].shape[0]
    p_pad = kw["pair_sig"].shape[0]
    rounds = stats["rounds"]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values()
                 if hasattr(t, "numel"))
    nbytes += sum(t.numel() * t.element_size() for t in out)
    per_cell = OPS_PER_CELL_BATCHED + (OPS_PER_CELL_PIPE if pipe else 0)
    ops = (stats["rows"] * n_pad * per_cell
           + rounds * p_pad * n_pad * OPS_PER_PAIR_CELL)
    b_ms, b_by = bound(nbytes, ops)
    return {"rounds_run": rounds, "rows": stats["rows"], "bytes": nbytes,
            "ops": ops, "bound_ms": b_ms, "bound_by": b_by}


def victim_read_names(kw, visit: bool) -> tuple:
    """The tensor arguments a victim dispatch reads under its
    configuration (csrc/victims.cu): the drf arrays only when a tier
    holds drf, the proportion arrays only when one holds proportion,
    the room arrays only with room_check, and the node-choice arrays
    (ranks, the score inputs) only for a visit. The [S, N] rows are
    counted apart."""
    tiers = kw["tiers"]
    names = ["p_res", "p_sig", "p_job", "p_queue", "node_ok", "v_job",
             "v_res", "v_critical", "v_live", "node_rows", "node_off",
             "job_queue", "min_av", "ready_cnt"]
    if any("drf" in t for t in tiers):
        names += ["p_resreq", "perm_nj", "nj_head", "j_alloc",
                  "cluster_total"]
    if any("proportion" in t for t in tiers):
        names += ["perm_nq", "nq_head", "q_deserved", "q_alloc",
                  "q_prop_ok"]
    if kw["room_check"]:
        names += ["n_tasks", "max_task_num"]
    if visit:
        names += ["visited", "host_rank", "v_node"]
        if kw["score_nodes"] and kw["dyn_enabled"]:
            names += ["nz_req", "allocatable_cm", "dyn_weights", "p_nz"]
    return tuple(names)


def victim_bounds(kw, out, visit: bool) -> dict:
    """A victim dispatch's roofline: the arrays its configuration reads
    (victim_read_names) read once, one [S, N] predicate row per distinct
    signature of its lanes (and for a scoring visit the lane's score
    row), and the output written once, over the memory rate; against the
    rows' float32 operations per lane (the tiers the dispatch runs) and,
    for a visit, the node scores, over the float32 rate."""
    lanes = kw["p_job"].shape[0]
    n_pad = kw["node_ok"].shape[0]
    v_pad = kw["v_node"].shape[0]
    tiers = kw["tiers"]
    nbytes = sum(kw[k].numel() * kw[k].element_size()
                 for k in victim_read_names(kw, visit))
    n_sigs = len(set(kw["p_sig"].tolist()))
    nbytes += n_sigs * n_pad * kw["sig_pred"].element_size()
    if visit and kw["score_nodes"]:
        nbytes += n_pad * kw["sig_scores"].element_size()
    nbytes += out.numel() * out.element_size()
    per_row = OPS_PER_ROW_TOTALS
    if any("drf" in t for t in tiers):
        per_row += OPS_PER_ROW_DRF
    if any("proportion" in t for t in tiers):
        per_row += OPS_PER_ROW_PROP
    ops = lanes * v_pad * per_row
    if visit and kw["score_nodes"] and kw["dyn_enabled"]:
        ops += n_pad * (OPS_PER_NODE_SCORE + 1)
    b_ms, b_by = bound(nbytes, ops)
    return {"lanes": lanes, "v_pad": v_pad, "n_pad": n_pad,
            "bytes": nbytes, "ops": ops, "bound_ms": b_ms,
            "bound_by": b_by}


def split_config(kw):
    """(tensor arguments, static configuration) of a recorded victim
    kernel call."""
    names = ("tiers", "veto_critical", "filter_kind", "dyn_enabled",
             "score_nodes", "room_check")
    return ({k: v for k, v in kw.items() if k not in names},
            {k: kw[k] for k in names})


def check_victim_call(kw, got, visit: bool) -> float:
    """Hold one recorded victim kernel call against its plain version on
    CPU copies of its inputs; returns the max abs error (0)."""
    from kubebatch_tpu_torch.kernels import victims

    tensors, config = split_config(kw)
    plain = victims.visit_plain if visit else victims.wave_plain
    want = plain(**on_cpu(tensors), **config)
    got = got.cpu()
    assert_bitwise([want], [got], "victim_visit" if visit
                   else "victim_wave")
    return max_abs_err([want], [got])


def run_cycle(cache, tiers, names=SHIPPED_ACTIONS):
    """One scheduling cycle through the registered actions: host ms per
    phase and action, and the session's task statuses before close."""
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.framework.registry import get_action

    t0 = time.perf_counter()
    snap = cache.snapshot()
    t1 = time.perf_counter()
    ssn = OpenSession(cache, tiers, snapshot=snap)
    ms = {"snapshot": (t1 - t0) * 1e3,
          "open": (time.perf_counter() - t1) * 1e3}
    before_preempt = None
    for name in names:
        if name == "preempt":
            before_preempt = {t.key: t.status.name
                              for j in ssn.jobs.values()
                              for t in j.tasks.values()}
        t = time.perf_counter()
        get_action(name).execute(ssn)
        ms[name] = (time.perf_counter() - t) * 1e3
    statuses = {t.key: t.status.name for j in ssn.jobs.values()
                for t in j.tasks.values()}
    t = time.perf_counter()
    CloseSession(ssn)
    ms["close"] = (time.perf_counter() - t) * 1e3
    cache.drain(timeout=60.0)
    ms["wall"] = (time.perf_counter() - t0) * 1e3
    return ms, statuses, before_preempt


class CountingEvictor:
    """Evicts by marking the pod deleting; counts the calls."""

    def __init__(self):
        self.evicted = []

    def evict(self, pod):
        self.evicted.append(pod.name)
        pod.deletion_timestamp = 1.0


def cluster_barrier_us(cluster: int, threads: int,
                       iters: int = 4000) -> dict:
    """csrc/chain_probe.cu's cluster probe on one cluster of ``cluster``
    CTAs of ``threads`` threads: us per cluster barrier, per dependent
    DSMEM load and per block barrier (each the best of three launches)."""
    import ctypes

    import torch

    from kubebatch_tpu_torch.kernels import _build

    lib = _build.library("chain_probe.cu")
    out = torch.zeros(4, dtype=torch.int64, device="cuda")
    best = None
    for _ in range(3):
        info = (ctypes.c_int * 2)(threads, 0)
        _build.check_launch("cluster_probe", lib.kb_cluster_probe(
            cluster, iters, out.data_ptr(), info,
            torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        ns = out.cpu().tolist()
        best = ns if best is None else [min(a, b) for a, b in zip(best, ns)]
    return {"cluster": cluster, "threads": threads, "iters": iters,
            "cluster_sync_us": best[0] / iters / 1e3,
            "dsmem_load_us": best[1] / iters / 1e3,
            "block_sync_us": best[2] / iters / 1e3}


def fused_floor(b: dict, launch: dict) -> dict:
    """The cluster design's floor for one fused run: its node solves x
    (one cluster barrier, a block barrier at C = 1, + the
    BLOCK_BARRIERS_PER_SOLVE left), from the cluster probe at the
    launch's shape."""
    probe = cluster_barrier_us(launch["cluster"], launch["threads"])
    sync = (probe["cluster_sync_us"] if launch["cluster"] > 1
            else probe["block_sync_us"])
    per = sync + BLOCK_BARRIERS_PER_SOLVE * probe["block_sync_us"]
    return {"floor_ms": b["n_solves"] * per / 1e3, "probe": probe}


def launch_phases(launch: dict) -> dict:
    """A fused launch's shape, its phase timers in device ms and its
    counters (kernels/fused.py last_launch)."""
    from kubebatch_tpu_torch.kernels import fused

    out = {k: v for k, v in launch.items() if k != "phase_ns"}
    if launch.get("phase_ns") is not None:
        ns = launch["phase_ns"].cpu().tolist()
        k = len(fused.FUSED_PHASES)
        out["phase_ms"] = {p: v / 1e6 for p, v in
                           zip(fused.FUSED_PHASES, ns[:k])}
        out["counts"] = dict(zip(fused.FUSED_COUNTS, ns[k:]))
    return out


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


#: digests of the round kernels' results on the launches named in
#: DIGEST_LAUNCHES, recorded from an earlier build of the kernels; every
#: run must reproduce them (the same inputs, the same decisions and
#: carries word for word), which is how launches no plain comparison
#: reaches (cfg7) are held to the earlier kernels. The cold launches
#: only: a churn cycle's fresh pods take uids from a process-wide counter
#: that the earlier phases advance by a count that varies run to run, so
#: its inputs do not repeat (the churn launches are held to their plain
#: versions in every run instead)
ROUND_DIGESTS = os.path.join(HERE, "kubebatch_tpu_torch", "kernels",
                             "round_digests.json")
DIGEST_LAUNCHES = ("cfg5 cold", "5p cold", "3p cold", "cfg6 cold",
                   "cfg7 cold")
#: this run's digests, by launch label (written to build/)
DIGESTS: dict = {}


def tensor_digest(obj) -> str:
    """sha256 (32 hex digits) of the tensors in ``obj`` (a tensor, a list
    or tuple, a dict by sorted key, None): dtype, shape and bytes; other
    values by repr."""
    import hashlib

    import torch

    h = hashlib.sha256()

    def feed(x):
        if isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous().reshape(-1)
            h.update(f"{t.dtype}{tuple(x.shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                h.update(str(k).encode())
                feed(x[k])
        elif isinstance(x, (list, tuple)):
            h.update(b"[")
            for v in x:
                feed(v)
            h.update(b"]")
        else:
            h.update(repr(x).encode())

    feed(obj)
    return h.hexdigest()[:32]


def record_digest(label: str, inputs, outputs) -> None:
    DIGESTS[label] = {"inputs": tensor_digest(inputs),
                      "outputs": tensor_digest(outputs)}


def check_digests() -> None:
    """Write this run's digests to build/round_digests.json and hold the
    launches of ROUND_DIGESTS to it: the same inputs must give the same
    results."""
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with open(os.path.join(HERE, "build", "round_digests.json"), "w") as f:
        json.dump({"launches": DIGESTS}, f, indent=1, sort_keys=True)
    with open(ROUND_DIGESTS) as f:
        ref = json.load(f)["launches"]
    for label in DIGEST_LAUNCHES:
        want, got = ref.get(label), DIGESTS.get(label)
        if want is None or got is None:
            raise AssertionError(f"round digests: launch {label!r} missing "
                                 f"(recorded {want is not None}, this run "
                                 f"{got is not None})")
        if got["inputs"] != want["inputs"]:
            raise AssertionError(f"round digests: {label}: inputs differ "
                                 f"from the recorded launch's")
        if got["outputs"] != want["outputs"]:
            raise AssertionError(f"round digests: {label}: results differ "
                                 f"from the recorded launch's")
    log(f"round digests: {len(DIGEST_LAUNCHES)} launches ("
        + ", ".join(DIGEST_LAUNCHES) + ") reproduce the recorded inputs "
        f"and results word for word")


#: the round's ordering phases (kernels/batched.py PHASES names): the
#: chain the grid chain took off block 0
CHAIN_PHASES = ("order_jobs", "window", "waterfall", "accept_commit",
                "retry_accept_commit", "aff_serialize")


def chain_share(phase_ms: dict) -> str:
    """The chain phases' ms and share of a launch's phase timers."""
    chain = sum(phase_ms.get(k, 0.0) for k in CHAIN_PHASES)
    total = sum(phase_ms.values())
    return (f"chain phases {chain:.3f} ms, "
            f"{chain / total if total else 0.0:.4f} of it")


def grid_barrier_us(iters: int = 4000) -> dict:
    """csrc/chain_probe.cu's grid probe: us per grid.sync() of the round
    kernels' cooperative grid (one 512-thread block per SM), beside a
    block barrier's."""
    import ctypes

    import torch

    from kubebatch_tpu_torch.kernels import _build

    lib = _build.library("chain_probe.cu")
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    info = (ctypes.c_int * 2)()
    best = None
    for _ in range(3):
        err = lib.kb_grid_probe(iters, out.data_ptr(), info,
                                torch.cuda.current_stream().cuda_stream)
        _build.check_launch("grid_probe", err)
        torch.cuda.synchronize()
        ns = out.cpu().tolist()
        if best is None or ns[0] < best[0]:
            best = ns
    return {"grid": info[0], "threads": info[1], "iters": iters,
            "grid_sync_us": best[0] / iters / 1e3,
            "block_sync_us": best[1] / iters / 1e3}


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
    """Wraps a module's solve entry ``name`` to keep each solve's inputs
    and results (the main path's own tensors, for the plain comparison)."""

    def __init__(self, mod, name):
        self.mod = mod
        self.name = name
        self.inner = getattr(mod, name)
        self.calls = []

    def __call__(self, **kw):
        out = self.inner(**kw)
        self.calls.append((kw, out))
        return out

    def __enter__(self):
        setattr(self.mod, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.inner)


class PhaseRecorder(Recorder):
    """A Recorder that also keeps each launch's per-phase device ns
    (``last_launch["phase_ns"]`` of ``launch_mod``, a tensor on the card:
    no sync until they are summed)."""

    def __init__(self, mod, name, launch_mod=None):
        super().__init__(mod, name)
        self.launch_mod = launch_mod or mod
        self.phase_ns = []

    def __call__(self, **kw):
        out = super().__call__(**kw)
        ns = self.launch_mod.last_launch.get("phase_ns")
        if ns is not None:
            self.phase_ns.append(ns)
        return out

    def total_ms(self, names) -> dict:
        """Per-phase device ms summed over the recorded launches."""
        import torch

        if not self.phase_ns:
            return {n: 0.0 for n in names}
        tot = torch.stack(self.phase_ns).sum(0).cpu().tolist()
        return {n: v / 1e6 for n, v in zip(names, tot)}


def phase_ms(last_launch, names) -> dict:
    """The per-phase device ms of the latest launch of a kernel whose
    wrapper keeps ``last_launch["phase_ns"]``."""
    return {n: v / 1e6 for n, v in zip(
        names, last_launch["phase_ns"].cpu().tolist())}


def cluster_shape(last_launch) -> dict:
    """The scalar launch entries (grid, cluster, threads...) of a cluster
    kernel's last launch."""
    return {k: v for k, v in last_launch.items() if k != "phase_ns"}


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


def build_batched_inputs(cfg, device):
    """The port's host path for one config up to the batched solve's
    arguments."""
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import OpenSession
    from kubebatch_tpu_torch.kernels.batched import prepare_batched
    from kubebatch_tpu_torch.sim import baseline_cluster

    cache = SchedulerCache(async_writeback=False, device=device)
    baseline_cluster(cfg).populate(cache)
    ssn = OpenSession(cache, shipped_tiers())
    return prepare_batched(build_cycle_inputs(ssn))


def launch_info(last_launch) -> dict:
    """The scalar entries of kernels.batched.last_launch."""
    return {k: v for k, v in last_launch.items() if k != "phase_ns"}


def on_cpu(kw):
    return {k: v.cpu() if hasattr(v, "cpu") else v for k, v in kw.items()}


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


def batched_placed(packed, t_pad: int) -> int:
    state = packed[:t_pad]
    return int(((state >= 1) & (state <= 3)).sum())


#: the saturated cfg4 preempt cycle's counts (phase (c)), unchanged since
#: the victim path was ported: the kernels' results decide them, so a
#: kernel that changed a decision would change them
CFG4_COUNTS = {"full_waves": 9, "refreshes": 4191, "evictions": 4200,
               "pipelined": 4200, "pending": 0}


def victim_phases(dev, spec5, spec4, churn: int = 256):
    """The shipped four-action policy on ``dev``: (a) ``spec5`` cold +
    two skewed churn cycles of ``churn`` pods, (b) the victim kernels at
    full width at that state, (c) one cycle of ``spec4``. Returns the
    victim kernels' entries of the kernels line and (a)'s binds in
    order."""
    import numpy as np
    import torch

    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.api import TaskStatus
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import _build, telemetry, victims
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.sim import build_cluster

    if tuple(CONFIG_ACTIONS[5]) != SHIPPED_ACTIONS or \
            tuple(CONFIG_ACTIONS[4]) != SHIPPED_ACTIONS:
        raise AssertionError("cfg4/cfg5 no longer run the shipped actions")
    names = ("batched_allocate", "fused_allocate", "victim_wave",
             "victim_visit")

    # ---- (a) the shipped policy at cfg5: cold, then skewed churn ---------
    t0 = time.perf_counter()
    sim = build_cluster(spec5)
    evictor = CountingEvictor()
    binder_a = RecordingBinder()
    cache = SchedulerCache(device=dev, binder=binder_a, evictor=evictor)
    sim.populate(cache)
    n_cold = len(sim.pods)
    log(f"(a) cfg5, shipped actions {', '.join(SHIPPED_ACTIONS)}, "
        f"incremental cache (the default): populated in "
        f"{time.perf_counter() - t0:.1f} s")

    def kubelet_tick():
        for pod in sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)

    cycles = []
    dem0 = metrics.engine_demotions_total()
    with Recorder(victims, "victim_wave") as wrec:
        for arrival in (None, 0, 3):
            if arrival is not None:
                kubelet_tick()
                if sim.churn_tick(cache, churn,
                                  arrival_queue=arrival) != churn:
                    raise AssertionError(f"churn did not recycle {churn} "
                                         f"pods")
            b0 = binding_count(cache)
            ev0 = len(evictor.evicted)
            rb0 = metrics.blocking_readbacks()
            n_rec = len(wrec.calls)
            _build.reset_launch_counts()
            telemetry.victim_frames.clear()
            ms, _, _ = run_cycle(cache, shipped_tiers())
            launches = {n: _build.launch_count(n) for n in names}
            cycles.append({
                "arrival_queue": arrival, "ms": ms, "launches": launches,
                "engine": allocate_mod.last_cycle_engine,
                "syncs": metrics.blocking_readbacks() - rb0,
                "binds": binding_count(cache) - b0,
                "evictions": len(evictor.evicted) - ev0,
                "waves": [cluster_shape(victims.last_launch)]
                if len(wrec.calls) > n_rec else [],
                "frames": [{f: int(v) for f, v in zip(
                    telemetry.FIELDS, frame) if v}
                    for frame in telemetry.victim_frames]})
    #: the three cycles' binds in order, for phase (f)'s scheduler loop
    binds_a = list(binder_a.calls)
    for k, c in enumerate(cycles):
        label = ("cold" if k == 0 else
                 f"churn {churn} into queue {c['arrival_queue']}")
        log(f"(a) cycle {k} ({label}): engine {c['engine']}, binds "
            f"{c['binds']}, evictions {c['evictions']}, launches "
            f"{json.dumps(c['launches'])}, counted syncs {c['syncs']}, "
            f"victim launch {json.dumps(c['waves'])}, frames "
            f"{json.dumps(c['frames'])}, ms "
            + json.dumps({p: round(v, 3) for p, v in c["ms"].items()}))
    cold, churned = cycles[0], cycles[1:]
    if cold["engine"] != "batched" or cold["binds"] != n_cold:
        raise AssertionError(f"cold cycle: engine {cold['engine']}, "
                             f"{cold['binds']} binds")
    if cold["launches"]["victim_wave"] or cold["launches"]["victim_visit"]:
        raise AssertionError("the cold cycle launched a victim kernel")
    for c in churned:
        if c["launches"]["victim_wave"] != 1 or \
                c["launches"]["victim_visit"] != 0:
            raise AssertionError(f"churn cycle launches {c['launches']}, "
                                 f"expected one victim_wave (reclaim's "
                                 f"prefetch)")
        if c["binds"] != churn:
            raise AssertionError(f"churn cycle bound {c['binds']}, not "
                                 f"{churn}")
        if [f.get("engine") for f in c["frames"]] != [
                telemetry.ENGINE_VICTIM_WAVE]:
            raise AssertionError(f"churn cycle frames {c['frames']}")
    for c in cycles:
        if c["syncs"] != sum(c["launches"].values()):
            raise AssertionError(f"{c['syncs']} counted syncs for "
                                 f"{c['launches']}: not one per dispatch")
    if metrics.engine_demotions_total() != dem0:
        raise AssertionError("an engine demotion on the shipped path")
    bad = gang_all_or_nothing(cache)
    if bad:
        raise AssertionError(f"{bad} PodGroups partially placed")
    wave_err = 0.0
    for kw, got in wrec.calls:
        wave_err = max(wave_err, check_victim_call(kw, got, visit=False))
    main_kw, main_out = wrec.calls[-1]
    main_t, main_cfg = split_config(main_kw)
    log(f"(a) {len(wrec.calls)} victim_wave launches bitwise equal to the "
        f"plain version on CPU copies of their inputs")
    wave_main_ms = cuda_ms(lambda: victims.victim_wave(**main_kw), reps=20)
    wave_main_phase = phase_ms(victims.last_launch, victims.PHASES)
    wave_main_shape = cluster_shape(victims.last_launch)
    wave_main_plain_ms = cuda_ms(
        lambda: victims.wave_plain(**main_kw), reps=3)
    wb = victim_bounds(main_kw, main_out, visit=False)

    # ---- (b) full width at that state -----------------------------------
    kubelet_tick()
    sim.churn_tick(cache, churn, arrival_queue=0)
    ssn = OpenSession(cache, shipped_tiers())
    pending = [t for j in ssn.jobs.values()
               for t in j.task_status_index.get(TaskStatus.PENDING,
                                                {}).values()]
    t0 = time.perf_counter()
    pre = victims.build_victim_solver(ssn, pending, "preemptable_fns",
                                      "preemptable_disabled", True)
    build_ms = (time.perf_counter() - t0) * 1e3
    rcl = victims.build_victim_solver(ssn, pending, "reclaimable_fns",
                                      "reclaimable_disabled", False)
    width = min(256, len(pending))
    chunk = pending[:width]
    full = {}
    for solver, kinds in ((pre, ("inter_queue", "intra_job")),
                          (rcl, ("other_queue",))):
        kw = solver.kernel_args(chunk, width)
        for fk in kinds:
            cfg = solver.config(fk)
            out = victims.victim_wave(**kw, **cfg)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            err = check_victim_call({**kw, **cfg}, out, visit=False)
            cpu_ms = (time.perf_counter() - t0) * 1e3
            full[fk] = {
                "lanes": width, "ms": cuda_ms(
                    lambda: victims.victim_wave(**kw, **cfg), reps=5),
                "plain_ms": cuda_ms(
                    lambda: victims.wave_plain(**kw, **cfg), reps=2),
                "plain_cpu_ms": cpu_ms, "max_abs_err": err,
                "launch": cluster_shape(victims.last_launch),
                "phase_ms": phase_ms(victims.last_launch, victims.PHASES),
                **victim_bounds({**kw, **cfg}, out, visit=False)}
            wave_err = max(wave_err, err)
    visit_err, visit_calls = 0.0, []
    visited = np.zeros(pre.state.n_pad, bool)
    for t in chunk[:8]:
        kw = pre.kernel_args([t], 1, visited=visited)
        cfg = pre.config("inter_queue")
        out = victims.victim_visit(**kw, **cfg)
        torch.cuda.synchronize()
        visit_err = max(visit_err, check_victim_call({**kw, **cfg}, out,
                                                     visit=True))
        visit_calls.append((kw, cfg, out))
    kw, cfg, out = visit_calls[0]
    visit_ms = cuda_ms(lambda: victims.victim_visit(**kw, **cfg), reps=20)
    visit_phase = phase_ms(victims.last_launch, victims.PHASES)
    visit_shape = cluster_shape(victims.last_launch)
    visit_plain_ms = cuda_ms(lambda: victims.visit_plain(**kw, **cfg),
                             reps=3)
    vb = victim_bounds({**kw, **cfg}, out, visit=True)
    CloseSession(ssn)
    cache.stop()
    log(f"(b) cfg5 churn state: VictimState + solver build {build_ms:.1f} "
        f"ms (preempt's), V_pad {len(pre.state.v_node)}, "
        f"live rows {pre.state.victims.live}, N_pad {pre.state.n_pad}")
    for fk, r in full.items():
        log(f"(b) victim_wave {fk}, {r['lanes']} lanes: {r['ms']:.3f} ms (CUDA "
            f"events, 5 launches), plain {r['plain_ms']:.3f} ms on the card, "
            f"plain {r['plain_cpu_ms']:.0f} ms on CPU copies (bitwise "
            f"equal), bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"launch {json.dumps(r['launch'])}")
    log(f"(b) victim_visit, 8 lanes bitwise equal to plain; one visit "
        f"{visit_ms:.4f} ms (CUDA events, 20 launches), plain "
        f"{visit_plain_ms:.3f} ms on the card, bound {vb['bound_ms']:.6f} "
        f"ms ({vb['bound_by']}); launch {json.dumps(visit_shape)}, phases "
        f"ms {json.dumps(visit_phase)}")

    # ---- (c) saturated cfg4: preemption under contention ----------------
    t0 = time.perf_counter()
    sim4 = build_cluster(spec4)
    evictor4 = CountingEvictor()
    cache4 = SchedulerCache(device=dev, binder=NullBinder(),
                            evictor=evictor4)
    sim4.populate(cache4)
    log(f"(c) saturated cfg4, incremental cache (the default): "
        f"{len(cache4.nodes)} nodes, {len(sim4.pods)} pods populated in "
        f"{time.perf_counter() - t0:.1f} s")
    rb0 = metrics.blocking_readbacks()
    with PhaseRecorder(victims, "victim_wave") as crec, \
            Recorder(victims, "victim_visit") as vrec:
        _build.reset_launch_counts()
        ms4, statuses4, before4 = run_cycle(cache4, shipped_tiers())
        launches4 = {n: _build.launch_count(n) for n in names}
    syncs4 = metrics.blocking_readbacks() - rb0
    full4 = sum(1 for kw, _ in crec.calls if kw["p_job"].shape[0] >= 8)
    single4 = sum(1 for kw, _ in crec.calls if kw["p_job"].shape[0] == 1)
    preemptors = [k for k, st in before4.items() if st == "PENDING"]
    piped = sum(1 for k in preemptors if statuses4[k] == "PIPELINED")
    left = sum(1 for k in preemptors if statuses4[k] == "PENDING")
    evictions4 = len(evictor4.evicted)
    log(f"(c) cycle: engine {allocate_mod.last_cycle_engine}, launches "
        f"{json.dumps(launches4)} ({full4} full waves of >= 8 lanes, "
        f"{single4} single-lane refreshes), counted syncs {syncs4}, "
        f"{len(preemptors)} preemptors: {piped} pipelined, {left} left "
        f"pending; {evictions4} evictions; ms "
        + json.dumps({p: round(v, 3) for p, v in ms4.items()}))
    if evictions4 == 0 or piped == 0:
        raise AssertionError("the saturated cfg4 cycle did not preempt")
    counts4 = {"full_waves": full4, "refreshes": single4,
               "evictions": evictions4, "pipelined": piped, "pending": left}
    if counts4 != CFG4_COUNTS:
        raise AssertionError(f"cfg4 counts {counts4}, not {CFG4_COUNTS}")
    if piped + left != len(preemptors):
        raise AssertionError("a preemptor ended neither pipelined nor "
                             "pending")
    if syncs4 != sum(launches4.values()):
        raise AssertionError("cfg4: not one counted sync per dispatch")
    bad = gang_all_or_nothing(cache4)
    if bad:
        raise AssertionError(f"cfg4: {bad} PodGroups partially placed")
    calls = crec.calls
    n = len(calls)
    sample = sorted(set(range(min(64, n))) | set(range(0, n, 16))
                    | set(range(max(0, n - 64), n)))
    t0 = time.perf_counter()
    for i in sample:
        kw, got = calls[i]
        wave_err = max(wave_err, check_victim_call(kw, got, visit=False))
    for kw, got in vrec.calls:
        visit_err = max(visit_err, check_victim_call(kw, got, visit=True))
    log(f"(c) {len(sample)} of {n} victim_wave launches (the first 64, "
        f"every 16th, the last 64) and all {len(vrec.calls)} victim_visit "
        f"launches bitwise equal to plain on CPU copies "
        f"({time.perf_counter() - t0:.1f} s)")
    refresh_kw = next((kw for kw, _ in calls
                       if kw["p_job"].shape[0] == 1), None)
    refresh_ms = (cuda_ms(lambda: victims.victim_wave(**refresh_kw),
                          reps=20) if refresh_kw is not None else None)
    refresh_phase = refresh_shape = None
    if refresh_kw is not None:
        refresh_phase = phase_ms(victims.last_launch, victims.PHASES)
        refresh_shape = cluster_shape(victims.last_launch)
        log(f"(c) a single-lane refresh: V_pad {refresh_shape['v_pad']}, "
            f"N_pad {refresh_shape['n_pad']}, {refresh_shape['cluster']} "
            f"CTAs a lane ({refresh_shape['grid']} CTAs of "
            f"{refresh_shape['threads']} threads); {refresh_ms:.4f} ms a "
            f"launch (CUDA events, 20 back to back), phases ms "
            f"{json.dumps(refresh_phase)}")
    dev_ms = crec.total_ms(victims.PHASES)
    dev_total = sum(dev_ms.values())
    by_phase = {k: round(v, 3) for k, v in dev_ms.items()}
    log(f"(c) preempt span {ms4['preempt']:.1f} ms host; its {n} wave "
        f"launches' device total {dev_total:.1f} ms (their phase timers, "
        f"CTA 0's view: {json.dumps(by_phase)}), so the host holds "
        f"{100.0 * (1.0 - dev_total / ms4['preempt']):.1f}% of the span")
    cache4.stop()

    return [
        {"name": "victim_wave", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/victims.cu",
         "replaces": "kubebatch_tpu/kernels/victims.py:401",
         "launches": sum(c["launches"]["victim_wave"] for c in cycles),
         "max_abs_err": wave_err, "ms": wave_main_ms,
         "plain_ms": wave_main_plain_ms, "plain_device": "cuda",
         "bound_ms": wb["bound_ms"], "bound_by": wb["bound_by"],
         "library_ms": None, "lanes": wb["lanes"], "rows": wb["v_pad"],
         "nodes": wb["n_pad"], "filter_kind": main_cfg["filter_kind"],
         "full_width": full,
         "cfg4_launches": launches4["victim_wave"],
         "cfg4_full_waves": full4, "cfg4_refreshes": single4,
         "cfg4_refresh_ms": refresh_ms,
         "cfg4_refresh_phase_ms": refresh_phase,
         "cfg4_refresh_launch": refresh_shape,
         "cfg4_preempt_ms": ms4["preempt"],
         "cfg4_wave_device_ms": dev_total,
         "cfg4_checked": len(sample),
         "phase_ms": wave_main_phase, "cluster": wave_main_shape["cluster"],
         "launch": wave_main_shape},
        {"name": "victim_visit", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/victims.cu",
         "replaces": "kubebatch_tpu/kernels/victims.py:324",
         "launches": sum(c["launches"]["victim_visit"] for c in cycles),
         "max_abs_err": visit_err, "ms": visit_ms,
         "plain_ms": visit_plain_ms, "plain_device": "cuda",
         "bound_ms": vb["bound_ms"], "bound_by": vb["bound_by"],
         "library_ms": None, "lanes": 1, "rows": vb["v_pad"],
         "nodes": vb["n_pad"], "checked_lanes": len(visit_calls),
         "phase_ms": visit_phase, "cluster": visit_shape["cluster"],
         "launch": visit_shape,
         "cfg4_launches": launches4["victim_visit"],
         "note": "the shipped policy dispatches waves (the host chooses "
                 "nodes from the cached lanes), so the per-visit kernel "
                 "runs only for a solver built with wave=False"},
    ], binds_a


#: bytes the dirty-row scatter moves per row (csrc/scatter_rows.cu): the
#: 61 bytes of node values and the 4-byte row index read, the 61 bytes of
#: values written
SCATTER_READ_BYTES_PER_ROW = 65
SCATTER_WRITE_BYTES_PER_ROW = 61
FOLD_PHASES = ("snapshot", "audit", "open", "reclaim", "reclaim_victim_state",
               "allocate", "backfill", "preempt", "preempt_victim_state",
               "close", "wall")


class FoldSide:
    """One cfg5 cache of phase (d) with its own sim, binder and evictor."""

    def __init__(self, label, spec, dev, incremental: bool):
        from kubebatch_tpu_torch.cache import SchedulerCache
        from kubebatch_tpu_torch.sim import build_cluster

        self.label = label
        self.sim = build_cluster(spec)
        self.binder = RecordingBinder()
        self.evictor = CountingEvictor()
        self.cache = SchedulerCache(device=dev, binder=self.binder,
                                    evictor=self.evictor,
                                    incremental_snapshot=incremental)
        self.sim.populate(self.cache)

    def kubelet_tick(self):
        from kubebatch_tpu_torch.objects import PodPhase

        for pod in self.sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                self.cache.update_pod(pod, pod)


def fold_phase(dev, spec5, churn: int = 256, n_churn: int = 8) -> dict:
    """(d) the steady folded cfg5 cycle: an incremental CUDA cache and a
    snapshot-primary twin, fed the same events (a cold cycle, then
    ``n_churn`` churn cycles of ``churn`` pods alternating between queue
    0 and queue 3), through the four registered shipped actions. Every
    cycle: the folded snapshot passes the audit, both caches bind, evict
    and pipeline alike and end with the same PodGroup phases, every
    dirty-row scatter equals its plain version on CPU copies bitwise and
    leaves the DeviceSession equal to a fresh build of the same nodes,
    and every victim_wave launch equals its plain version. Returns the
    scatter_rows entry of the kernels line."""
    import torch

    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.framework.registry import get_action
    from kubebatch_tpu_torch.kernels import _build, solver, victims

    t0 = time.perf_counter()
    inc = FoldSide("incremental", spec5, dev, incremental=True)
    prim = FoldSide("snapshot-primary", spec5, dev, incremental=False)
    log(f"(d) cfg5 folded steady cycle: incremental and snapshot-primary "
        f"CUDA caches populated in {time.perf_counter() - t0:.1f} s")

    # ---- instrumentation: the checks run inline and their host time is
    #      kept out of the phase times -----------------------------------
    check = {"ms": 0.0, "scatters": 0, "refreshes": 0, "err": 0.0,
             "full_builds": 0, "vs_ms": 0.0, "vs_refreshed": [],
             "side": None, "rows": []}
    scatter_calls = []
    inner_scatter = solver.scatter_rows
    inner_update = solver.DeviceSession.update_rows
    inner_init = solver.DeviceSession.__init__
    inner_vs = victims.VictimState.__init__

    def rec_scatter(dst, block):
        t = time.perf_counter()
        before = tuple(a.clone() for a in dst)
        check["ms"] += (time.perf_counter() - t) * 1e3
        inner_scatter(dst, block)
        t = time.perf_counter()
        scatter_calls.append((before, block, tuple(a.clone() for a in dst)))
        check["rows"].append((check["side"], int(block.shape[0])))
        check["ms"] += (time.perf_counter() - t) * 1e3

    def checked_update(self, nodes, names):
        ok = inner_update(self, nodes, names)
        if ok and any(n in self.state.index for n in names):
            t = time.perf_counter()
            check["in_check"] = True
            fresh = solver.DeviceSession(nodes, min_bucket=self.n_padded,
                                         device=self.device)
            check["in_check"] = False
            for a, b in zip(self.arrays, fresh.arrays):
                if not torch.equal(a, b):
                    raise AssertionError("a refreshed DeviceSession differs "
                                         "from a fresh build of its nodes")
            check["refreshes"] += 1
            check["ms"] += (time.perf_counter() - t) * 1e3
        return ok

    def counted_init(self, *a, **k):
        if not check.get("in_check"):
            check["full_builds"] += 1
        inner_init(self, *a, **k)

    def timed_vs(self, *a, **k):
        t = time.perf_counter()
        inner_vs(self, *a, **k)
        check["vs_ms"] += (time.perf_counter() - t) * 1e3
        check["vs_refreshed"].append(self.refreshed)

    def verify_scatters():
        t = time.perf_counter()
        for before, block, after in scatter_calls:
            want = tuple(b.cpu() for b in before)
            solver.scatter_rows_plain(want, block.cpu())
            got = tuple(a.cpu() for a in after)
            assert_bitwise(want, got, "scatter_rows")
            check["err"] = max(check["err"], max_abs_err(want, got))
        check["scatters"] += len(scatter_calls)
        last = scatter_calls[-1] if scatter_calls else None
        scatter_calls.clear()
        check["ms"] += (time.perf_counter() - t) * 1e3
        return last

    def run(side):
        """One cycle of ``side``: host ms per phase (check time taken
        out), the session's pipelined tasks, its binds and evictions."""
        cache = side.cache
        check["side"] = side.label
        inner_snapshot = cache.snapshot
        snap_ms = {}

        def timed_snapshot():
            t = time.perf_counter()
            out = inner_snapshot()
            snap_ms["ms"] = (time.perf_counter() - t) * 1e3
            return out

        cache.snapshot = timed_snapshot
        b0, e0 = len(side.binder.calls), len(side.evictor.evicted)
        builds0 = check["full_builds"]
        ms = {}
        t0 = time.perf_counter()
        snap, diffs = cache.audited_snapshot()
        t1 = time.perf_counter()
        del cache.snapshot
        if diffs:
            raise AssertionError(f"{side.label}: audited snapshot differs "
                                 f"from the full clone: {diffs[:4]}")
        ms["snapshot"] = snap_ms["ms"]
        ms["audit"] = (t1 - t0) * 1e3 - snap_ms["ms"]
        ssn = OpenSession(cache, shipped_tiers(), snapshot=snap)
        ms["open"] = (time.perf_counter() - t1) * 1e3
        for name in SHIPPED_ACTIONS:
            c0, v0 = check["ms"], check["vs_ms"]
            t = time.perf_counter()
            get_action(name).execute(ssn)
            ms[name] = ((time.perf_counter() - t) * 1e3
                        - (check["ms"] - c0))
            if name in ("reclaim", "preempt"):
                ms[f"{name}_victim_state"] = check["vs_ms"] - v0
        pipelined = sorted(t.key for j in ssn.jobs.values()
                           for t in j.tasks.values()
                           if t.status.name == "PIPELINED")
        t = time.perf_counter()
        CloseSession(ssn)
        cache.drain(timeout=60.0)
        ms["close"] = (time.perf_counter() - t) * 1e3
        ms["wall"] = sum(ms[p] for p in SHIPPED_ACTIONS) + ms["snapshot"] \
            + ms["open"] + ms["close"]
        binds = dict(side.binder.calls[b0:])
        return {"ms": ms, "pipelined": pipelined, "binds": binds,
                "evictions": sorted(side.evictor.evicted[e0:]),
                "full_builds": check["full_builds"] - builds0,
                "phases": {g.name: g.status.phase.name
                           for g in side.sim.groups}}

    folded0 = metrics.events_folded_total()
    demoted0 = metrics.fold_demotions_total()
    solver.scatter_rows = rec_scatter
    solver.DeviceSession.update_rows = checked_update
    solver.DeviceSession.__init__ = counted_init
    victims.VictimState.__init__ = timed_vs
    rows_by_cycle, table, wave_err, n_waves = [], [], 0.0, 0
    last_scatter = None
    try:
        with Recorder(victims, "victim_wave") as wrec:
            _build.reset_launch_counts()
            for k in range(n_churn + 1):
                arrival = None if k == 0 else (0 if k % 2 else 3)
                for side in (inc, prim):
                    if arrival is not None:
                        side.kubelet_tick()
                        if side.sim.churn_tick(side.cache, churn,
                                               arrival_queue=arrival) \
                                != churn:
                            raise AssertionError("churn did not recycle "
                                                 f"{churn} pods")
                check["rows"] = []
                check["vs_refreshed"] = []
                r_inc = run(inc)
                vs_inc = list(check["vs_refreshed"])
                rows_inc = [r for s, r in check["rows"]]
                last_scatter = verify_scatters() or last_scatter
                r_prim = run(prim)
                verify_scatters()
                for what in ("binds", "evictions", "pipelined", "phases"):
                    if r_inc[what] != r_prim[what]:
                        raise AssertionError(
                            f"(d) cycle {k}: the incremental and the "
                            f"snapshot-primary caches differ in {what}")
                if k and r_inc["full_builds"]:
                    raise AssertionError(
                        f"(d) cycle {k}: the incremental cache built "
                        f"{r_inc['full_builds']} DeviceSession(s) from "
                        f"scratch with the node set unchanged")
                if k and not rows_inc:
                    raise AssertionError(f"(d) cycle {k}: no dirty-row "
                                         f"scatter on the incremental cache")
                for kw, got in wrec.calls:
                    wave_err = max(wave_err,
                                   check_victim_call(kw, got, visit=False))
                n_waves += len(wrec.calls)
                wrec.calls.clear()
                table.append((k, arrival, r_inc, r_prim))
                rows_by_cycle.append(rows_inc)
                label = ("cold" if k == 0 else
                         f"churn {churn} into queue {arrival}")
                log(f"(d) cycle {k} ({label}): binds {len(r_inc['binds'])}, "
                    f"evictions {len(r_inc['evictions'])}, pipelined "
                    f"{len(r_inc['pipelined'])}; same in both caches; "
                    f"incremental: scatter rows {rows_inc}, full "
                    f"DeviceSession builds {r_inc['full_builds']}, "
                    f"VictimState (nodes, jobs) refreshed {vs_inc}")
                for r, side in ((r_inc, inc), (r_prim, prim)):
                    log(f"(d) cycle {k} {side.label} ms "
                        + json.dumps({p: round(r['ms'][p], 3)
                                      for p in FOLD_PHASES
                                      if p in r["ms"]}))
            launches = _build.launch_count("scatter_rows")
            wave_launches = _build.launch_count("victim_wave")
    finally:
        solver.scatter_rows = inner_scatter
        solver.DeviceSession.update_rows = inner_update
        solver.DeviceSession.__init__ = inner_init
        victims.VictimState.__init__ = inner_vs
    demoted = metrics.fold_demotions_total()
    if demoted != demoted0:
        raise AssertionError(f"(d) fold demotions {demoted}")
    folded = {kd: v - folded0.get(kd, 0)
              for kd, v in metrics.events_folded_total().items()
              if v != folded0.get(kd, 0)}
    log(f"(d) {check['scatters']} scatter_rows launches bitwise equal to "
        f"plain on CPU copies; {check['refreshes']} refreshed "
        f"DeviceSessions equal to fresh builds; {n_waves} victim_wave "
        f"launches bitwise equal to plain; audits clean; fold demotions "
        f"{json.dumps(demoted)}; events folded "
        f"{json.dumps(folded)}; checks took {check['ms']:.0f} ms (kept out "
        f"of the phase times)")
    for side_k, side in ((2, inc), (3, prim)):
        med = {p: sorted(r[side_k]["ms"][p] for r in table[1:])[
            len(table[1:]) // 2] for p in FOLD_PHASES}
        log(f"(d) {side.label}, median of {len(table) - 1} churn cycles, "
            f"ms " + json.dumps({p: round(v, 3) for p, v in med.items()}))
    inc.cache.stop()
    prim.cache.stop()

    # ---- the scatter kernel at the steady cycle's shape ----------------
    before, block, _ = last_scatter
    k = int(block.shape[0])
    dst = tuple(b.clone() for b in before)
    event_ms = cuda_ms(lambda: solver.scatter_rows(dst, block), reps=50)
    prof_ms = profiled_ms(lambda: solver.scatter_rows(dst, block),
                          "scatter_rows_kernel", reps=50)
    ms = prof_ms if prof_ms is not None else event_ms
    plain_ms = cuda_ms(lambda: solver.scatter_rows_plain(dst, block),
                       reps=50)
    idx = block[:, 0].long()
    f = block[:, 1:14].contiguous().view(torch.float32)
    srcs = (f[:, 0:3].contiguous(), f[:, 3:6].contiguous(),
            f[:, 6:9].contiguous(), f[:, 9:11].contiguous(),
            f[:, 11:13].contiguous(), block[:, 14].contiguous(),
            block[:, 15].contiguous(), block[:, 16] != 0)

    def index_copies():
        for d, src in zip(dst, srcs):
            d.index_copy_(0, idx, src)

    library_ms = cuda_ms(index_copies, reps=50)
    host_block = block.cpu().numpy()
    h2d_ms = cuda_ms(lambda: torch.from_numpy(host_block).to(dev), reps=50)
    b_ms, b_by = bound(k * (SCATTER_READ_BYTES_PER_ROW
                            + SCATTER_WRITE_BYTES_PER_ROW), 0)
    log(f"(d) scatter_rows at the steady cycle's last refresh ({k} rows, "
        f"N_pad {before[0].shape[0]}): {prof_ms} ms device time "
        f"(profiler), {event_ms:.4f} ms per launch back to back (CUDA "
        f"events, 50 launches), plain {plain_ms:.4f} ms on the card, eight "
        f"index_copy_ "
        f"{library_ms:.4f} ms, the block's host-to-device copy "
        f"{h2d_ms:.4f} ms; bound {b_ms:.7f} ms ({b_by})")
    return {"name": "scatter_rows", "route": "cuda",
            "source": "kubebatch_tpu_torch/kernels/csrc/scatter_rows.cu",
            "replaces": "kubebatch_tpu/kernels/solver.py:231",
            "launches": launches, "max_abs_err": check["err"], "ms": ms,
            "plain_ms": plain_ms, "plain_device": "cuda",
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
            "library": "eight torch.Tensor.index_copy_", "h2d_ms": h2d_ms,
            "event_ms_50_reps": event_ms, "profiler_ms": prof_ms,
            "rows": k, "nodes": int(before[0].shape[0]),
            "rows_per_cycle_incremental": rows_by_cycle,
            "fold_victim_wave_launches": wave_launches}


def validate_affinity(cache) -> dict:
    """The final state of ``cache`` under the reference's predicate
    semantics (tests/test_affinity_device.py _validate_final_state): every
    required affinity has a companion in its domain (or the pod started
    its group), no required anti-affinity sees a companion in its domain,
    no host port is claimed twice on a node. Raises on a violation;
    returns the counts checked."""
    labels = {n.name: dict(n.node.labels) for n in cache.nodes.values()
              if n.node}
    placed = [(t.pod, t.node_name) for job in cache.jobs.values()
              for t in job.tasks.values() if t.node_name]
    by_selector = {}

    def matching(term, anchor):
        ns = tuple(sorted(term.namespaces)) or (anchor.namespace,)
        key = (tuple(sorted(term.match_labels.items())), ns)
        got = by_selector.get(key)
        if got is None:
            got = by_selector[key] = [
                (o, on) for o, on in placed
                if o.namespace in ns and term.selects(o)]
        return got

    def domain(node, topo):
        return labels.get(node, {}).get(topo)

    n_req = n_anti = 0
    for pod, node in placed:
        aff = pod.affinity
        if aff is None:
            continue
        for term in aff.pod_affinity_required:
            n_req += 1
            dom = domain(node, term.topology_key)
            members = [(o, on) for o, on in matching(term, pod)
                       if o is not pod]
            ok = any(dom is not None and domain(on, term.topology_key)
                     == dom for _, on in members)
            if not ok and (members or not term.selects(pod)):
                raise AssertionError(f"{pod.name} on {node}: required "
                                     f"affinity unsatisfied")
        for term in aff.pod_anti_affinity_required:
            n_anti += 1
            dom = domain(node, term.topology_key)
            if dom is None:
                continue
            for o, on in matching(term, pod):
                if o is not pod and domain(on, term.topology_key) == dom:
                    raise AssertionError(
                        f"{pod.name} on {node}: anti-affinity violated by "
                        f"{o.name} on {on}")
    ports = set()
    n_ports = 0
    for pod, node in placed:
        for port in pod.host_ports():
            n_ports += 1
            if (node, port) in ports:
                raise AssertionError(f"port {port} claimed twice on {node}")
            ports.add((node, port))
    return {"placed": len(placed), "required": n_req, "anti": n_anti,
            "ports": n_ports}


def affinity_bounds(kw, aff, out, stats, pipe: bool) -> dict:
    """The affinity solve's roofline: the batched solve's (batched_bounds,
    its task rows those that take part in a round) plus the affinity
    inputs and carry read once and written once; against, besides the
    batched solve's operations, the predicates'
    integer operations on every row-pass row and node (OPS_PER_CELL_AFF
    over PEAK_I32_PER_S) and the interpod score's float operations on
    the rows that can score (the preferred terms and group bits they
    carry, counted by the plain engine) over PEAK_F32_PER_S.
    ``reference_macs`` counts, for the same rows, the multiply-adds of
    the reference's dense products (three [.,A] x [A,N] boolean
    products, the port product and, with the interpod score, two more
    [.,A] x [A,N]): what that formulation would do, not the bound."""
    base = batched_bounds(kw, out[:5], stats, pipe)
    n_pad = kw["idle"].shape[0]
    n_pairs = aff["aff_grp_cnt0"].shape[0]
    pt = aff["task_ports"].shape[1] if "task_ports" in aff else 0
    ip = "aff_ip_weight" in aff
    rounds, rows = stats["rounds"], stats["rows"]
    ip_rows, ip_terms = stats.get("ip_rows", 0), stats.get("ip_terms", 0)
    nbytes = base["bytes"]
    nbytes += sum(t.numel() * t.element_size() for t in aff.values())
    nbytes += sum(t.numel() * t.element_size() for t in out[5].values()
                  if t is not None)
    int_ops = rows * n_pad * OPS_PER_CELL_AFF
    ip_ops = (ip_terms + ip_rows * OPS_PER_IP_CELL) * n_pad
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ((base["ops"] + ip_ops) / PEAK_F32_PER_S
             + int_ops / PEAK_I32_PER_S) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    macs = rows * n_pad * (3 * n_pairs + pt + (2 * n_pairs if ip else 0))
    return {"rounds_run": rounds, "rows": rows, "ip_rows": ip_rows,
            "bytes": nbytes, "ops": base["ops"] + ip_ops + int_ops,
            "int_ops": int_ops, "bytes_ms": t_bytes, "ops_ms": t_ops,
            "reference_macs": macs, "bound_ms": b_ms, "bound_by": b_by,
            "pairs": n_pairs, "ports": pt, "ip": ip}


def affinity_phase(dev, spec5p, spec3p, churn: int = 256) -> dict:
    """(e) the predicate-rich configurations through the shipped policy
    on incremental caches: 5p (cfg5's shape with 16 zones, selectors,
    taints, both affinity kinds, preferred scores, host ports) cold, then
    one churn cycle of ``churn`` pods into queue 0 (each runs the host
    loops over 5,000 nodes: ~25 s), then 3p cold and two skewed churn
    cycles. The
    cold cycles' allocate runs the batched kernel with the affinity
    carry (one launch, one counted sync, no affinity host fallback),
    checked bitwise against the plain engine on CPU copies, the final
    state validated and gangs all-or-nothing; a churn cycle's allocate
    takes the host loops (the reference's route: its fused engine refuses
    an affinity snapshot), with the ``dynamic_features`` reason asserted,
    while reclaim launches victim_wave with the affinity masks folded
    into the node choice, each launch bitwise equal to plain. Returns the
    kernels-line entry of the affinity solve, timed at 5p cold."""
    import torch

    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.actions import allocate_batched
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.framework.registry import get_action
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import victims
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.sim import build_cluster

    names = ("batched_allocate", "fused_allocate", "victim_wave",
             "victim_visit", "scatter_rows")

    def config_cycles(label, spec, n_churn=2):
        t0 = time.perf_counter()
        sim = build_cluster(spec)
        evictor = CountingEvictor()
        cache = SchedulerCache(device=dev, binder=NullBinder(),
                               evictor=evictor)
        sim.populate(cache)
        log(f"(e) {label}, shipped actions, incremental cache: "
            f"{len(cache.nodes)} nodes, {len(sim.pods)} pods populated in "
            f"{time.perf_counter() - t0:.1f} s")
        cycles = []
        with Recorder(batched_mod, "batched_allocate") as brec, \
                Recorder(victims, "victim_wave") as wrec:
            _build.reset_launch_counts()
            for k in range(1 + n_churn):       # cold, then the churn cycles
                if k:
                    for pod in sim.pods:
                        if pod.node_name and pod.phase == PodPhase.PENDING:
                            pod.phase = PodPhase.RUNNING
                            cache.update_pod(pod, pod)
                    queue = 0 if k % 2 else spec.n_queues - 1
                    if sim.churn_tick(cache, churn,
                                      arrival_queue=queue) != churn:
                        raise AssertionError(f"churn did not recycle "
                                             f"{churn} pods")
                b0 = binding_count(cache)
                ev0 = len(evictor.evicted)
                dem0 = metrics.engine_demotions_total()
                aff0 = metrics.affinity_host_fallback_total()
                n_w = len(wrec.calls)
                t0 = time.perf_counter()
                snap = cache.snapshot()
                ssn = OpenSession(cache, shipped_tiers(), snapshot=snap)
                ms = {"snapshot+open": (time.perf_counter() - t0) * 1e3}
                syncs = {}
                for name in SHIPPED_ACTIONS:
                    rb = metrics.blocking_readbacks()
                    t = time.perf_counter()
                    get_action(name).execute(ssn)
                    ms[name] = (time.perf_counter() - t) * 1e3
                    syncs[name] = metrics.blocking_readbacks() - rb
                t = time.perf_counter()
                CloseSession(ssn)
                cache.drain(timeout=60.0)
                ms["close"] = (time.perf_counter() - t) * 1e3
                ms["wall"] = (time.perf_counter() - t0) * 1e3
                engine = allocate_mod.last_cycle_engine
                c = {"cycle": k, "engine": engine, "ms": ms,
                     "syncs": syncs,
                     "reason": (allocate_mod.last_host_reason
                                if engine == "host-visit" else None),
                     "affinity": (allocate_batched.last_solve.get(
                         "affinity") if engine == "batched" else None),
                     "binds": binding_count(cache) - b0,
                     "evictions": len(evictor.evicted) - ev0,
                     "demotions": metrics.engine_demotions_total() - dem0,
                     "aff_fallbacks":
                         metrics.affinity_host_fallback_total() - aff0,
                     "waves": len(wrec.calls) - n_w,
                     "kernel_ms": (allocate_batched.last_phases.get(
                         "kernel") if engine == "batched" else None)}
                if k == 0:
                    c["phase_ns"] = batched_mod.last_launch["phase_ns"]
                    if len(brec.calls) == 1:
                        # the churn cycles refresh the DeviceSession's
                        # arrays in place: keep copies of the solve's
                        brec.calls[0] = copy_call(*brec.calls[0])
                cycles.append(c)
                log(f"(e) {label} cycle {k} "
                    f"({'cold' if k == 0 else f'churn {churn}'}): engine "
                    f"{engine}, binds {c['binds']}, evictions "
                    f"{c['evictions']}, victim waves {c['waves']}, counted "
                    f"syncs {json.dumps(syncs)}, demotions "
                    f"{c['demotions']}, affinity host fallbacks "
                    f"{c['aff_fallbacks']}, host ms "
                    + json.dumps({p: round(v, 3) for p, v in ms.items()}))
            launches = {n: _build.launch_count(n) for n in names}
        log(f"(e) {label}: launches {json.dumps(launches)}")
        cold = cycles[0]
        if cold["engine"] != "batched" or not cold["affinity"]:
            raise AssertionError(f"{label} cold: engine {cold['engine']}, "
                                 f"affinity {cold['affinity']}")
        if cold["aff_fallbacks"] or cold["demotions"]:
            raise AssertionError(f"{label} cold: a fallback or demotion")
        if cold["syncs"]["allocate"] != 1 or len(brec.calls) != 1 \
                or launches["batched_allocate"] != 1:
            raise AssertionError(f"{label} cold: {len(brec.calls)} batched "
                                 f"solves, {cold['syncs']['allocate']} "
                                 f"syncs, expected one each")
        for c in cycles[1:]:
            if c["engine"] != "host-visit" or not str(
                    c["reason"]).startswith("dynamic_features"):
                raise AssertionError(f"{label} churn cycle {c['cycle']}: "
                                     f"engine {c['engine']}, reason "
                                     f"{c['reason']!r}")
            if c["demotions"] != 1 or c["aff_fallbacks"]:
                raise AssertionError(f"{label} churn cycle {c['cycle']}: "
                                     f"{c['demotions']} demotions, "
                                     f"{c['aff_fallbacks']} fallbacks")
            if c["syncs"]["reclaim"] < 1 or c["waves"] < 1:
                raise AssertionError(f"{label} churn cycle {c['cycle']}: "
                                     f"reclaim launched no victim wave")
        bad = gang_all_or_nothing(cache)
        if bad:
            raise AssertionError(f"{label}: {bad} PodGroups partially "
                                 f"placed")
        t0 = time.perf_counter()
        counts = validate_affinity(cache)
        log(f"(e) {label}: final state valid under the affinity and "
            f"host-port predicates ({json.dumps(counts)}, "
            f"{time.perf_counter() - t0:.1f} s)")
        wave_err = 0.0
        for wkw, got in wrec.calls:
            wave_err = max(wave_err, check_victim_call(wkw, got,
                                                       visit=False))
        log(f"(e) {label}: {len(wrec.calls)} victim_wave launches (affinity "
            f"masks folded in) bitwise equal to plain on CPU copies")
        bkw, bgot = brec.calls[0]
        record_digest(f"{label} cold", bkw, bgot)
        aff = bkw["aff"]
        kw = {k: v for k, v in bkw.items() if k != "aff"}
        stats = {}
        t0 = time.perf_counter()
        want = batched_allocate_plain_aff(kw, aff, stats)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = [g.cpu() for g in bgot[:5]]
        assert_bitwise(want[:5], got, f"batched_allocate {label} cold")
        err = max_abs_err(want[:5], got)
        for name, w in want[5].items():
            g = bgot[5][name]
            if (w is None) != (g is None):
                raise AssertionError(f"{label}: carry {name} missing")
            if w is not None:
                assert_bitwise([w], [g.cpu()], f"{label} carry {name}")
                err = max(err, max_abs_err([w], [g.cpu()]))
        t_pad = kw["task_valid"].shape[0]
        expected = ready_allocs(want[0], on_cpu(kw), t_pad)
        if cold["binds"] != expected:
            raise AssertionError(f"{label} cold: {cold['binds']} binds, the "
                                 f"plain version dispatches {expected}")
        carried = ", ".join(k for k, v in want[5].items() if v is not None)
        log(f"(e) {label} cold: packed result, node carry and affinity "
            f"carry ({carried}) bitwise equal to plain on CPU copies "
            f"({plain_ms:.0f} ms on the host CPU); binds {cold['binds']} == "
            f"the plain result's allocations of gangs at quorum "
            f"({batched_placed(want[0], t_pad)} placed: killed gangs keep "
            f"their placements undispatched, as in the reference)")
        cache.stop()
        return {"cycles": cycles, "launches": launches, "kw": kw,
                "aff": aff, "out": bgot, "stats": stats, "err": err,
                "wave_err": wave_err, "plain_ms": plain_ms,
                "n_waves": len(wrec.calls)}

    r5 = config_cycles("5p", spec5p, n_churn=1)
    kw, aff = r5["kw"], r5["aff"]
    statics = {k: kw[k] for k in ("job_keys", "queue_keys", "prop_overused",
                                  "dyn_enabled", "pipe_enabled",
                                  "max_rounds", "compact_bucket",
                                  "gang_enabled", "narrow", "narrow_gate")}
    tensors = {k: v for k, v in kw.items() if k not in statics}

    def launch():
        return batched_mod.batched_allocate(**tensors, **statics, aff=aff)

    event_ms = cuda_ms(launch, reps=3)
    prof_ms = profiled_ms(launch, "batched_allocate_kernel", reps=2)
    ab = affinity_bounds(kw, aff, r5["out"], r5["stats"],
                         bool(kw["pipe_enabled"]))
    phase_ms = {k: v / 1e6 for k, v in zip(
        batched_mod.PHASES, r5["cycles"][0]["phase_ns"].cpu().tolist())}
    aff_ms = sum(phase_ms[k] for k in batched_mod.AFF_PHASES)
    total_ms = sum(phase_ms.values())
    cold_ms = r5["cycles"][0]["kernel_ms"]
    log(f"(e) batched_allocate 5p cold (affinity: A={ab['pairs']} pairs, "
        f"PT={ab['ports']} ports, interpod score {ab['ip']}; T "
        f"{kw['task_valid'].shape[0]}, N {kw['idle'].shape[0]}): "
        f"{r5['stats']['rounds']} rounds, kernel {cold_ms:.3f} ms (events, "
        f"main path), {event_ms:.3f} ms per launch (events, 3 launches), "
        f"{prof_ms} ms device time (profiler); plain {r5['plain_ms']:.0f} "
        f"ms on the host CPU; roofline bound {ab['bound_ms']:.6f} ms "
        f"({ab['bound_by']}; {ab['rows']} row-pass rows, {ab['ip_rows']} of "
        f"them scoring; {ab['bytes']} B: {ab['bytes_ms']:.6f} ms; "
        f"{ab['ops']:.4g} operations, {ab['int_ops']:.4g} of them the "
        f"predicates' integer ones: {ab['ops_ms']:.6f} ms); the "
        f"reference's dense products would take {ab['reference_macs']:.4g}"
        f" multiply-adds on the same rows")
    log(f"(e) batched_allocate 5p cold, main-path launch, device ms per "
        f"phase (sum {total_ms:.3f}; affinity phases {aff_ms:.3f}, "
        f"{aff_ms / total_ms:.4f} of it; the predicates and the score also "
        f"run inside rank_and_rows and retry_rows; "
        f"{chain_share(phase_ms)}): "
        + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    r3 = config_cycles("3p", spec3p)
    return {
        "name": "batched_allocate (affinity)", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/batched_allocate.cu",
        "replaces": "kubebatch_tpu/kernels/batched.py:200",
        "launches": r5["launches"]["batched_allocate"],
        "max_abs_err": max(r5["err"], r3["err"]), "ms": cold_ms,
        "plain_ms": r5["plain_ms"], "plain_device": "cpu",
        "bound_ms": ab["bound_ms"], "bound_by": ab["bound_by"],
        "library_ms": None, "pairs": ab["pairs"], "ports": ab["ports"],
        "interpod_score": ab["ip"], "rounds": r5["stats"]["rounds"],
        "plain_counts": {k: int(v) for k, v in r5["stats"].items()},
        "rows": ab["rows"], "ip_rows": ab["ip_rows"],
        "bound_bytes_ms": ab["bytes_ms"], "bound_ops_ms": ab["ops_ms"],
        "reference_macs": ab["reference_macs"],
        "t_pad": kw["task_valid"].shape[0], "n_pad": kw["idle"].shape[0],
        "event_ms_3_reps": event_ms, "profiler_ms": prof_ms,
        "phase_ms": phase_ms, "affinity_phase_ms": aff_ms,
        "victim_wave_launches": r5["launches"]["victim_wave"],
        "victim_wave_max_abs_err": max(r5["wave_err"], r3["wave_err"]),
        "churn_cycles": len(r5["cycles"]) - 1,
        "churn_host_ms": [c["ms"] for c in r5["cycles"][1:]],
        "cfg3p_launches": r3["launches"]["batched_allocate"]}


def ready_allocs(packed, kw, t_pad: int) -> int:
    """ALLOC decisions of jobs whose placements reach their quorum: what
    a cold cycle's replay dispatches (binds)."""
    import numpy as np

    state = packed[:t_pad].numpy()
    job = kw["task_job"].numpy()
    valid = kw["task_valid"].numpy() & (job >= 0)
    placed = valid & (state >= 1) & (state <= 3)
    n_jobs = kw["job_valid"].shape[0]
    cnt = np.bincount(job[placed], minlength=n_jobs)
    ready = cnt + kw["init_allocated"].numpy() \
        >= kw["order_min_available"].numpy()
    return int((valid & (state == 1) & ready[np.maximum(job, 0)]).sum())


def copy_call(kw, out):
    """Copies of a recorded solve's tensors (arguments and results)."""
    def cp(v):
        if isinstance(v, dict):
            return {k: cp(x) for k, x in v.items()}
        if isinstance(v, (tuple, list)):
            return type(v)(cp(x) for x in v)
        return v.clone() if hasattr(v, "clone") else v
    return cp(kw), cp(out)


def batched_allocate_plain_aff(kw, aff, stats):
    """The plain batched engine on CPU copies of a recorded affinity
    solve's arguments."""
    from kubebatch_tpu_torch.kernels.batched import batched_allocate_plain

    return batched_allocate_plain(**on_cpu(kw), aff=on_cpu(aff),
                                  stats=stats)


#: float32 operations per (task row, node) cell of the per-visit scan
#: (csrc/allocate_scan.cu): idle + backfilled, and + eps on it, on idle
#: and on releasing (12 adds), the three fit tests (9 compares), the
#: score add and the argmax compare; with the dynamic score its
#: operations (node_score.cuh) and the weighted sum
OPS_PER_CELL_SCAN = 23
#: bytes of node state the scan reads once (idle, releasing, backfilled:
#: 3 x f32; allocatable_cm, nz_req: 2 x f32; n_tasks, max_task_num: i32;
#: node_ok) and of the carry it writes (idle, releasing: 3 x f32,
#: n_tasks: i32, nz_req: 2 x f32), per node
SCAN_READ_BYTES_PER_NODE = 61
SCAN_WRITE_BYTES_PER_NODE = 36


class ScanRecorder:
    """Wraps kernels.solver.allocate_scan: keeps a copy of every launch's
    inputs (taken before the launch) and results (the session's node
    arrays are refreshed in place later), for the plain check after the
    run."""

    def __init__(self):
        from kubebatch_tpu_torch.kernels import solver

        self.mod = solver
        self.inner = solver.allocate_scan
        self.calls = []

    def __call__(self, *args, **kw):
        names = self.mod.SCAN_ARGS + ("dyn_enabled",)
        if len(args) > len(names):
            raise TypeError("allocate_scan: too many arguments")
        bound = dict(zip(names, args))
        bound.update(kw)
        copy = {k: v.clone() if hasattr(v, "clone") else v
                for k, v in bound.items()}
        out = self.inner(**bound)
        # the carry becomes the session's arrays, refreshed in place later
        self.calls.append((copy, [o.clone() for o in out]))
        return out

    def __enter__(self):
        self.mod.allocate_scan = self
        return self

    def __exit__(self, *exc):
        self.mod.allocate_scan = self.inner

    def check(self, what: str) -> float:
        """Every recorded launch bitwise against the plain scan on the
        card, on the copies; drops the records. Returns the max abs
        error (0)."""
        from kubebatch_tpu_torch.kernels.solver import allocate_scan_plain

        err = 0.0
        for kw, got in self.calls:
            want = allocate_scan_plain(**kw)
            assert_bitwise(want, got, f"allocate_scan {what}")
            err = max(err, max_abs_err(want, got))
        n = len(self.calls)
        self.calls = []
        log(f"(f) {what}: {n} allocate_scan launches bitwise equal to the "
            f"plain scan on the card")
        return err


def scan_bounds(kw, out) -> dict:
    """One visit's roofline: the node state and the [T, N] rows read
    once and the carry and packed block written once, over the memory
    rate, against OPS_PER_CELL_SCAN (plus the dynamic score's) per
    (task row, node) cell over the float32 rate."""
    n = kw["idle"].shape[0]
    t = kw["resreq"].shape[0]
    nbytes = (n * (SCAN_READ_BYTES_PER_NODE + SCAN_WRITE_BYTES_PER_NODE)
              + t * n * 5 + t * 36 + out[0].numel() * 4)
    per_cell = OPS_PER_CELL_SCAN + (OPS_PER_NODE_SCORE + 1
                                    if kw.get("dyn_enabled") else 0)
    b_ms, b_by = bound(nbytes, t * n * per_cell)
    return {"bytes": nbytes, "ops": t * n * per_cell, "bound_ms": b_ms,
            "bound_by": b_by, "t_pad": t, "n_pad": n}


class FifoOrder:
    """A custom job-order plugin (creation order): no whole-cycle engine
    expresses it, so allocate takes the per-visit route. The tests hold
    the same plugin (tests/test_torch_cuda.py); this script imports
    nothing of tests."""

    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self):
        return "fifo-order"

    def on_session_open(self, ssn):
        ssn.add_job_order_fn("fifo-order", lambda l, r: (
            (l.creation_timestamp > r.creation_timestamp)
            - (l.creation_timestamp < r.creation_timestamp)))

    def on_session_close(self, ssn):
        pass


def action_ms(root) -> dict:
    """Host ms per action of a finished cycle root (the action spans
    under its session span)."""
    sess = root.find("session") if root is not None else None
    return {c.name: round(c.dur * 1e3, 3)
            for c in (sess.children if sess else ()) if c.cat == "action"}


def scheduler_phase(dev, spec5, spec3, binds_a, churn: int = 256) -> dict:
    """(f) the scheduler loop on the card: a Scheduler on a cfg5
    incremental cache (the shipped conf, subcycle=True) runs guarded
    periods (cold batched, two skewed churn cycles fused: binds equal
    phase (a)'s ``binds_a``), a fault plan walks the degradation ladder
    down to level 2, where six failures leave it over the card, and the
    healthy cycles climb back through the subprocess
    CUDA probe, 64 latency-lane pods arrive through cache.add_pod and
    are placed by sub-cycles; then a solver="jax" cold cfg5 period (every
    visit one allocate_scan launch, decisions equal to a CPU cache's),
    and a custom job order on cfg3 (fused -> visit). Every allocate_scan
    launch is held bitwise against the plain scan on the card. Returns
    the kernels-line entry of allocate_scan."""
    import numpy as np
    import torch

    from kubebatch_tpu_torch import faults, metrics, obs
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.framework.registry import \
        register_plugin_builder
    from kubebatch_tpu_torch.kernels import _build, solver
    from kubebatch_tpu_torch.obs import ledger
    from kubebatch_tpu_torch.objects import (GROUP_NAME_ANNOTATION,
                                             Container, Pod, PodGroup,
                                             PodPhase, resource_list)
    from kubebatch_tpu_torch.runtime import Scheduler
    from kubebatch_tpu_torch.runtime.subcycle import (LANE_ANNOTATION,
                                                      LATENCY_LANE)
    from kubebatch_tpu_torch.sim import build_cluster

    conf = open(os.path.join(HERE, "config", "kube-batch-conf.yaml")).read()
    kernel_names = ("allocate_scan", "batched_allocate", "fused_allocate",
                    "victim_wave", "scatter_rows")
    faults.reset()
    ladder = faults.LADDER
    ladder.policy = faults.BackoffPolicy(cooldown=1.0)
    paths = {}

    def kubelet(sim, cache):
        for pod in sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)

    # ---- 1. guarded periods ---------------------------------------------
    t0 = time.perf_counter()
    sim = build_cluster(spec5)
    binder = RecordingBinder()
    cache = SchedulerCache(device=dev, binder=binder,
                           evictor=CountingEvictor())
    sim.populate(cache)
    sched = Scheduler(cache, conf, subcycle=True)
    probe_walls = []

    def timed_probe():
        t = time.perf_counter()
        ok = sched._recovery_probe()
        probe_walls.append((time.perf_counter() - t, ok))
        return ok

    ladder.probe = timed_probe
    log(f"(f) cfg5, Scheduler(shipped conf, subcycle=True) on an "
        f"incremental cache: populated in {time.perf_counter() - t0:.1f} s")
    fail0 = metrics.cycle_failures_by_reason()
    dem0 = metrics.engine_demotions_by_pair()
    _build.reset_launch_counts()
    periods = []
    with ScanRecorder() as srec:
        for arrival in (None, 0, 3):
            if arrival is not None:
                kubelet(sim, cache)
                if sim.churn_tick(cache, churn,
                                  arrival_queue=arrival) != churn:
                    raise AssertionError("churn did not recycle")
            t1 = time.perf_counter()
            ok = sched.run_cycle()
            cache.drain(timeout=60.0)
            periods.append({"ok": ok, "engine": allocate_mod.last_cycle_engine,
                            "wall_ms": (time.perf_counter() - t1) * 1e3,
                            "actions_ms": action_ms(obs.last_cycle())})
        paths["periods"] = {n: _build.launch_count(n) for n in kernel_names}
        if srec.calls:
            raise AssertionError("a shipped-policy period ran the visit scan")
    if (paths["periods"]["batched_allocate"],
            paths["periods"]["fused_allocate"]) != (1, 2):
        raise AssertionError(f"period launches {paths['periods']}")
    for k, p in enumerate(periods):
        log(f"(f) period {k}: healthy {p['ok']}, engine {p['engine']}, "
            f"wall {p['wall_ms']:.1f} ms, host ms per action (spans) "
            f"{json.dumps(p['actions_ms'])}")
    if [p["engine"] for p in periods] != ["batched", "fused", "fused"] \
            or not all(p["ok"] for p in periods):
        raise AssertionError(f"periods {periods}")
    if metrics.cycle_failures_by_reason() != fail0 or ladder.level != 0:
        raise AssertionError("a guarded period failed")
    # both caches write back on their thread pools: the binder sees each
    # cycle's binds in thread order, so the placements are compared
    if sorted(binder.calls) != sorted(binds_a):
        raise AssertionError("the scheduler's binds differ from phase (a)'s "
                             "for the same events")
    log(f"(f) the three periods bound {len(binder.calls)} pods, the same "
        f"pods on the same nodes as phase (a); launches "
        f"{json.dumps(paths['periods'])}")

    # ---- 2. the degradation ladder --------------------------------------
    # six failed cycles: two per level; over a CPU cache the last pair
    # would reach level 3 (the host loops), over the card it stays at 2
    faults.arm(faults.FaultPlan(counts={"device.dispatch": 6}))
    ladder_trace = []
    fail1 = metrics.cycle_failures_by_reason()
    dem1 = metrics.engine_demotions_by_pair()
    _build.reset_launch_counts()
    t_ladder = time.perf_counter()
    for _ in range(6):
        kubelet(sim, cache)
        sim.churn_tick(cache, churn)
        ok = sched.run_cycle()
        # a failed cycle's allocate raised before it ran an engine
        ladder_trace.append((ok, ladder.level,
                             allocate_mod.last_cycle_engine if ok else None))
    if [(ok, lvl) for ok, lvl, _ in ladder_trace] != [
            (False, 0), (False, 1), (False, 1), (False, 2), (False, 2),
            (False, 2)]:
        raise AssertionError(f"the ladder's walk over the card: "
                             f"{ladder_trace}")
    faults.disarm()
    d0 = metrics.engine_demotions_by_pair()
    ok = sched.run_cycle()
    cache.drain(timeout=60.0)
    at2 = (ok, ladder.level, allocate_mod.last_cycle_engine)
    cap_moves = {f"{a}->{b}": v - d0.get((a, b), 0)
                 for (a, b), v in metrics.engine_demotions_by_pair().items()
                 if v != d0.get((a, b), 0)}
    ladder_trace.append(at2)
    if at2 != (True, 2, "fused"):
        raise AssertionError(f"the level-2 cycle: {at2}")
    deadline = time.perf_counter() + 120.0
    while ladder.level > 0:
        if time.perf_counter() > deadline:
            raise AssertionError(f"no re-promotion: {ladder_trace}")
        ok = sched.run_cycle()
        ladder_trace.append((ok, ladder.level,
                             allocate_mod.last_cycle_engine))
        if not ok:
            raise AssertionError(f"a healthy cycle failed: {ladder_trace}")
        time.sleep(0.25)
    ladder_s = time.perf_counter() - t_ladder
    paths["ladder"] = {n: _build.launch_count(n) for n in kernel_names}
    fails = {k: v - fail1.get(k, 0)
             for k, v in metrics.cycle_failures_by_reason().items()
             if v != fail1.get(k, 0)}
    dems = {f"{a}->{b}": v - dem1.get((a, b), 0)
            for (a, b), v in metrics.engine_demotions_by_pair().items()
            if v != dem1.get((a, b), 0)}
    runs = []                       # the trace run-length encoded
    for step in ladder_trace:
        if runs and runs[-1][:3] == list(step):
            runs[-1][3] += 1
        else:
            runs.append(list(step) + [1])
    log(f"(f) ladder: (healthy, level, engine, cycles) "
        f"{json.dumps(runs)}; cycle_failures_total moves "
        f"{json.dumps(fails)}; engine_demotions_total moves {json.dumps(dems)}"
        f", of them at cap_engine on the level-2 cycle "
        f"{json.dumps(cap_moves)}; recovery probes (wall s, answer) "
        f"{json.dumps([(round(w, 3), a) for w, a in probe_walls])}; "
        f"{ladder_s:.1f} s down and back up")
    if fails != {"exception": 6} or len(probe_walls) < 2 \
            or not all(a for _, a in probe_walls):
        raise AssertionError(f"ladder: failures {fails}, probes "
                             f"{probe_walls}")
    if cap_moves != {"batched->fused": 1}:
        raise AssertionError(f"the level-2 cycle's cap moves {cap_moves}")

    # ---- 3. the schedule-on-arrival sub-cycle ---------------------------
    kubelet(sim, cache)
    sched.run_cycle()
    kubelet(sim, cache)
    req = resource_list(cpu=500, memory=1 << 30)
    lat_pods, lat_groups = [], []
    for i in range(32):
        lat_groups.append(PodGroup(name=f"lat-{i}", namespace="lat",
                                   min_member=1, queue=f"q{i % 4 + 1}"))
        lat_pods.append(Pod(uid=f"lat-{i}", name=f"lat-{i}", namespace="lat",
                            containers=[Container(requests=dict(req))],
                            annotations={GROUP_NAME_ANNOTATION: f"lat-{i}",
                                         LANE_ANNOTATION: LATENCY_LANE}))
    for g in range(4):
        lat_groups.append(PodGroup(name=f"latg-{g}", namespace="lat",
                                   min_member=8, queue=f"q{g + 1}"))
        for p in range(8):
            lat_pods.append(Pod(
                uid=f"latg-{g}-{p}", name=f"latg-{g}-{p}", namespace="lat",
                containers=[Container(requests=dict(req))],
                annotations={GROUP_NAME_ANNOTATION: f"latg-{g}",
                             LANE_ANNOTATION: LATENCY_LANE}))
    for g in lat_groups:
        cache.add_pod_group(g)
    n_bind = len(binder.calls)
    sub0 = metrics.subcycles_total()
    arrivals = ledger.window()
    rb0 = metrics.blocking_readbacks()
    _build.reset_launch_counts()
    with ScanRecorder() as srec:
        t1 = time.perf_counter()
        for pod in lat_pods:
            cache.add_pod(pod)
        sub_wall = time.perf_counter() - t1
        paths["subcycle"] = {n: _build.launch_count(n) for n in kernel_names}
        sub_syncs = metrics.blocking_readbacks() - rb0
        sub_calls = list(srec.calls)
        sub_err = srec.check("sub-cycle")
    cache.drain(timeout=60.0)
    lat_binds = [c for c in binder.calls[n_bind:] if c[0].startswith("lat")]
    n_dec = arrivals.subcycle_count()
    subs = metrics.subcycles_total() - sub0
    log(f"(f) sub-cycle: 64 latency-lane arrivals (32 lone pods, 4 gangs of "
        f"8), {subs} sub-cycles, {paths['subcycle']['allocate_scan']} "
        f"allocate_scan launches, {sub_syncs} counted syncs, "
        f"{len(lat_binds)} pods bound, {n_dec} decisions; arrival -> "
        f"decision ms p50 {arrivals.subcycle_percentile(50):.3f}, max "
        f"{arrivals.subcycle_max_ms():.3f} (the decision ledger's "
        f"buckets, 9% wide); {sub_wall * 1e3:.1f} ms for the 64 adds")
    # one sub-cycle per arrival; one visit (one launch, one sync) per lone
    # pod and per gang once its last member arrives (before that the
    # gang plugin holds the job out of the session, as the reference's
    # does), which decides that arrival
    if subs != 64 or paths["subcycle"]["allocate_scan"] != 36 \
            or sub_syncs != 36 or len(sub_calls) != 36:
        raise AssertionError("the sub-cycles did not run one launch and one "
                             "sync per visit")
    if len(lat_binds) != 64 or n_dec != 36:
        raise AssertionError(f"{len(lat_binds)} latency pods bound, "
                             f"{n_dec} decisions observed")
    n_bind = len(binder.calls)
    kubelet(sim, cache)
    if not sched.run_cycle():
        raise AssertionError("the full cycle after the arrivals failed")
    cache.drain(timeout=60.0)
    again = [c for c in binder.calls[n_bind:] if c[0].startswith("lat")]
    if again:
        raise AssertionError(f"the next full cycle re-placed {len(again)} "
                             f"latency pods")
    log("(f) the next full cycle re-placed none of the latency pods")
    cache.stop()

    # ---- 4. solver="jax": a cold cfg5 period on the per-visit scan ------
    def jax_period(device, spec, record: bool, tiers_conf=None,
                   solver_mode="jax"):
        sim = build_cluster(spec)
        binder = RecordingBinder()
        # write-back inline: the binder sees the binds in dispatch order
        cache = SchedulerCache(device=device, binder=binder,
                               async_writeback=False)
        sim.populate(cache)
        sched = Scheduler(cache, tiers_conf or conf, solver=solver_mode)
        visits = []
        inner = solver.DeviceSession.solve_job

        def counted(dev_s, *a, **k):
            visits.append(1)
            return inner(dev_s, *a, **k)

        solver.DeviceSession.solve_job = counted
        rb0 = metrics.blocking_readbacks()
        d0 = metrics.engine_demotions_by_pair()
        _build.reset_launch_counts()
        try:
            t1 = time.perf_counter()
            ok = sched.run_cycle()
            wall = (time.perf_counter() - t1) * 1e3
        finally:
            solver.DeviceSession.solve_job = inner
        launches = _build.launch_count("allocate_scan")
        cache.drain(timeout=60.0)
        states = sorted((f"{t.namespace}/{t.name}", t.status.name,
                         t.node_name)
                        for j in cache.jobs.values()
                        for t in j.tasks.values())
        dems = {f"{a}->{b}": v - d0.get((a, b), 0)
                for (a, b), v in metrics.engine_demotions_by_pair().items()
                if v != d0.get((a, b), 0)}
        out = {"ok": ok, "engine": allocate_mod.last_cycle_engine,
               "jobs": len(sim.groups),
               "wall_ms": wall, "visits": len(visits), "launches": launches,
               "syncs": metrics.blocking_readbacks() - rb0,
               "binds": binder.calls, "states": states, "demotions": dems,
               "actions_ms": action_ms(obs.last_cycle()),
               "kernel_s": None}
        cache.stop()
        return out

    k0 = metrics.solver_kernel_seconds()
    h0 = metrics.host_phase_seconds().get("visit_rows", 0.0)
    with ScanRecorder() as srec:
        card = jax_period(dev, spec5, True)
        jax_calls = srec.calls
        srec.calls = []
    card["kernel_s"] = metrics.solver_kernel_seconds() - k0
    rows_s = metrics.host_phase_seconds().get("visit_rows", 0.0) - h0
    paths["jax_cold"] = {"allocate_scan": card["launches"]}
    log(f"(f) solver='jax' cold cfg5 period: healthy {card['ok']}, engine "
        f"{card['engine']}, {card['visits']} visits, {card['launches']} "
        f"allocate_scan launches, {card['syncs']} counted syncs, "
        f"{len(card['binds'])} binds; wall {card['wall_ms']:.1f} ms, host ms "
        f"per action {json.dumps(card['actions_ms'])}, of allocate "
        f"{card['kernel_s'] * 1e3:.1f} ms in the visits' solve spans "
        f"(uploads, launch, sync) and {rows_s * 1e3:.1f} ms building the "
        f"[T, N] rows")
    if not card["ok"] or card["engine"] != "jax-visit" \
            or not (card["visits"] == card["launches"] == card["syncs"]
                    == card["jobs"]):
        raise AssertionError(f"jax period: {card['engine']}, visits "
                             f"{card['visits']}, launches {card['launches']}"
                             f", syncs {card['syncs']}")
    srec = ScanRecorder()
    srec.calls = jax_calls
    jax_err = srec.check("jax cold cfg5")
    main_kw, main_out = jax_calls[-1]
    t0 = time.perf_counter()
    cpu = jax_period("cpu", spec5, False)
    log(f"(f) the same events on a CPU cache: {cpu['visits']} visits, "
        f"{len(cpu['binds'])} binds in {(time.perf_counter() - t0):.1f} s")
    if cpu["binds"] != card["binds"] or cpu["states"] != card["states"] \
            or cpu["engine"] != card["engine"]:
        first = next((k for k, (a, b) in enumerate(zip(
            cpu["binds"], card["binds"])) if a != b), None)
        raise AssertionError(
            f"the card's jax period decides differently from the CPU "
            f"cache's: engines {card['engine']} / {cpu['engine']}, binds "
            f"{len(card['binds'])} / {len(cpu['binds'])}, first differing "
            f"bind {first}")
    log("(f) every task's status and node, and the bind order, equal the "
        "CPU cache's")

    # ---- 5. a custom job order on cfg3: fused -> visit ------------------
    register_plugin_builder("fifo-order", FifoOrder)
    fifo_conf = conf.replace("  - name: priority",
                             "  - name: fifo-order\n  - name: priority", 1)
    with ScanRecorder() as srec:
        c3 = jax_period(dev, spec3, True, tiers_conf=fifo_conf,
                        solver_mode="fused")
        c3_err = srec.check("custom order cfg3")
    paths["custom_order"] = {"allocate_scan": c3["launches"]}
    log(f"(f) cfg3 with a custom job order, solver='fused': engine "
        f"{c3['engine']}, demotions {json.dumps(c3['demotions'])}, "
        f"{c3['visits']} visits, {c3['launches']} launches, {c3['syncs']} "
        f"syncs, {len(c3['binds'])} binds, wall {c3['wall_ms']:.1f} ms")
    if c3["engine"] != "fused-visit" or c3["demotions"] != {
            "fused->visit": 1} or not (
            c3["visits"] == c3["launches"] == c3["syncs"] > 0):
        raise AssertionError(f"custom order cycle: {c3['engine']}, "
                             f"{c3['demotions']}")
    faults.reset()

    # ---- timings at the main path's shape (T_pad 8, N_pad 8,192) --------
    run_kw = {k: v for k, v in main_kw.items()}
    event_ms = cuda_ms(lambda: solver.allocate_scan(**run_kw), reps=200)
    prof_ms = profiled_ms(lambda: solver.allocate_scan(**run_kw),
                          "allocate_scan_kernel", reps=50)
    scan_phase = phase_ms(solver.last_launch, solver.SCAN_PHASES)
    scan_shape = cluster_shape(solver.last_launch)
    plain_ms = cuda_ms(lambda: solver.allocate_scan_plain(**run_kw), reps=5)
    sb = scan_bounds(run_kw, main_out)
    log(f"allocate_scan T_pad {sb['t_pad']}, N_pad {sb['n_pad']}: "
        f"{event_ms:.4f} ms per launch back to back (events, 200 launches), "
        f"{prof_ms} ms device time (profiler); plain {plain_ms:.3f} ms on "
        f"the card; bound {sb['bound_ms']:.6f} ms ({sb['bound_by']}: "
        f"{sb['bytes']} B, {sb['ops']} float32 operations); launch "
        f"{json.dumps(scan_shape)}, phases ms {json.dumps(scan_phase)}")
    launches = sum(p["allocate_scan"] for p in paths.values())
    return {"name": "allocate_scan", "route": "cuda",
            "source": "kubebatch_tpu_torch/kernels/csrc/allocate_scan.cu",
            "replaces": "kubebatch_tpu/kernels/solver.py:103",
            "launches": launches, "launches_per_path": paths,
            "max_abs_err": max(sub_err, jax_err, c3_err),
            "ms": prof_ms if prof_ms is not None else event_ms,
            "event_ms": event_ms, "profiler_ms": prof_ms,
            "plain_ms": plain_ms, "plain_device": "cuda",
            "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
            "library_ms": None, "library_call": "none",
            "t_pad": sb["t_pad"], "n_pad": sb["n_pad"],
            "phase_ms": scan_phase, "cluster": scan_shape["cluster"],
            "launch": scan_shape,
            "jax_cold_wall_ms": card["wall_ms"],
            "subcycle_arrival_ms_p50": arrivals.subcycle_percentile(50),
            "subcycle_arrival_ms_max": arrivals.subcycle_max_ms(),
            "probe_wall_s": [round(w, 3) for w, _ in probe_walls]}


#: float32 operations per task (or pair) x node cell of the coarse pass
#: (hier_allocate.cu coarse: three fit compares and the predicate / room
#: test; three more with pipelining)
OPS_PER_CELL_COARSE = 4


def scale_bounds(kw, out, counters, rounds: int, pipe: bool,
                 pool: int) -> dict:
    """A two-level or active-set launch's roofline: each input read once
    and each output written once over the memory rate, against the
    operations these inputs need over the float32 rate — the coarse
    passes' cells (per row and pool the nodes up to and including the
    first eligible one, or the whole pool: the pass stops there), the
    majority pair's [N] score per pass, the rounds' (task row x pool)
    cells and their [P,pool] pair scores. The counts are the kernel's
    own (hier.COUNTERS), held equal to the plain version's on every
    cfg6 launch."""
    n_pad = kw["idle"].shape[0]
    p_pad = kw["pair_sig"].shape[0]
    nbytes = sum(t.numel() * t.element_size() for t in kw.values()
                 if hasattr(t, "numel"))
    nbytes += sum(t.numel() * t.element_size() for t in out)
    per_cell = OPS_PER_CELL_BATCHED + (OPS_PER_CELL_PIPE if pipe else 0)
    ops = (counters["coarse_cells"] * (OPS_PER_CELL_COARSE
                                       + (OPS_PER_CELL_PIPE if pipe else 0))
           + counters["coarse_passes"] * n_pad * OPS_PER_PAIR_CELL
           + counters["rows"] * pool * per_cell
           + rounds * p_pad * pool * OPS_PER_PAIR_CELL)
    b_ms, b_by = bound(nbytes, ops)
    return {"bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by}


class FreshBinder:
    """Binds by flipping the pod's node_name; keeps the pods bound since
    the last kubelet tick and counts the binds."""

    def __init__(self):
        self.fresh = []
        self.count = 0

    def bind(self, pod, hostname):
        pod.node_name = hostname
        self.fresh.append(pod)
        self.count += 1

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def kubelet_tick(self, cache):
        from kubebatch_tpu_torch.objects import PodPhase

        for pod in self.fresh:
            pod.phase = PodPhase.RUNNING
            cache.update_pod(pod, pod)
        self.fresh = []


def capacity_violations(sim) -> int:
    """Nodes whose bound pods' requests (cpu, memory, pod count) exceed
    the node's allocatable, summed on the host from the sim's own
    objects (independent of the cache's bookkeeping)."""
    from kubebatch_tpu_torch.objects import CPU, MEMORY, PODS

    used = {}
    for pod in sim.pods:
        if not pod.node_name:
            continue
        u = used.setdefault(pod.node_name, [0.0, 0.0, 0])
        for c in pod.containers:
            u[0] += c.requests.get(CPU, 0.0)
            u[1] += c.requests.get(MEMORY, 0.0)
        u[2] += 1
    bad = 0
    for node in sim.nodes:
        u = used.get(node.name)
        if u is None:
            continue
        a = node.allocatable
        if u[0] > a.get(CPU, 0.0) or u[1] > a.get(MEMORY, 0.0) \
                or u[2] > a.get(PODS, 0.0):
            bad += 1
    return bad


class SolveRecorder:
    """Wraps the two-level and active-set dispatchers (kernels/hier.py
    hier_packed, kernels/activeset.py activeset_packed and
    activeset_audit_packed) to keep each launch's kind, arguments,
    results and work counters."""

    def __init__(self):
        from kubebatch_tpu_torch.kernels import activeset, hier

        self.sites = [(hier, "hier_packed", "hier"),
                      (activeset, "activeset_packed", "activeset"),
                      (activeset, "activeset_audit_packed", "audit")]
        self.inner = {}
        self.calls = []

    def wrap(self, mod, name, kind):
        from kubebatch_tpu_torch.kernels import hier

        inner = self.inner[(mod, name)]

        def call(*args, **kw):
            out = inner(*args, **kw)
            self.calls.append({"kind": kind, "args": args, "kw": kw,
                               "out": out,
                               "counters": hier.last_launch["counters"],
                               "route": hier.last_launch.get("route"),
                               "cluster": hier.last_launch.get("cluster")})
            return out
        return call

    def __enter__(self):
        for mod, name, kind in self.sites:
            self.inner[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self.wrap(mod, name, kind))
        return self

    def __exit__(self, *exc):
        for mod, name, _ in self.sites:
            setattr(mod, name, self.inner[(mod, name)])


class LedgerTimer:
    """Times the decision ledger's work on the main path: wraps
    obs.ledger.close_many (the bind funnel's closes), stage_mark (the
    apply stamp) and the ledger's span-exit hook, and sums their host
    seconds and the pods closed. A cycle's share is read as deltas."""

    def __init__(self):
        from kubebatch_tpu_torch.obs import ledger, spans

        self.ledger, self.spans = ledger, spans
        self.inner = {n: getattr(ledger, n)
                      for n in ("close_many", "stage_mark", "on_span_exit")}
        self.seconds = 0.0
        self.pods = 0

    def timed(self, fn, counts_pods=False):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
                if counts_pods:
                    self.pods += len(args[0])
        return call

    def __enter__(self):
        for n, fn in self.inner.items():
            setattr(self.ledger, n, self.timed(fn, n == "close_many"))
        hooks = self.spans.SPAN_HOOKS
        hooks[hooks.index(self.inner["on_span_exit"])] = \
            self.ledger.on_span_exit
        return self

    def __exit__(self, *exc):
        hooks = self.spans.SPAN_HOOKS
        hooks[hooks.index(self.ledger.on_span_exit)] = \
            self.inner["on_span_exit"]
        for n, fn in self.inner.items():
            setattr(self.ledger, n, fn)

    def mark(self):
        return self.seconds, self.pods


def check_scale_call(call) -> dict:
    """Hold one recorded two-level / active-set launch against its plain
    version on CPU copies of its inputs (the packed result with its
    frame, and the committed node carry), bitwise; returns the plain
    version's host ms, its work stats and the max abs error (0)."""
    from kubebatch_tpu_torch.kernels import activeset, hier

    kw, out, stats = call["kw"], call["out"], {}
    statics = {k: v for k, v in kw.items() if not hasattr(v, "cpu")}
    t0 = time.perf_counter()
    if call["kind"] == "audit":
        node, act, full = (on_cpu(a) for a in call["args"])
        want = activeset.activeset_audit_plain(node, act, full, **statics,
                                               stats=stats)
    else:
        arrays = on_cpu({k: v for k, v in kw.items() if hasattr(v, "cpu")})
        plain = (hier.hier_allocate_plain if call["kind"] == "hier"
                 else activeset.activeset_allocate_plain)
        want = plain(**arrays, **statics, stats=stats)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = [o.cpu() for o in out]
    assert_bitwise(want, got, f"{call['kind']} launch")
    return {"plain_ms": plain_ms, "stats": stats,
            "err": max_abs_err(want, got)}


def scale_phase(dev, spec6, spec7) -> list:
    """Phase (g): the scale engines at cfg6 and cfg7, in auto, on
    incremental caches with cfg6's allocate-only conf. A cold cfg6 cycle
    (50,000 pending) runs the two-level solve (csrc/hier_allocate.cu);
    six skewed churn cycles (256, 256, 1,024, 1,024, 4,096 and 4,096
    pods, into queue 0 then 3) run the active set at every grain, the
    audit on cycles 0 and 3 (``set_audit_every(3)``); a cold cfg7 cycle
    runs the two-level solve once more. Every cycle: the engine, one
    launch, one counted sync, every pod bound, gang all-or-nothing,
    every node within its capacity (on the host); every cfg6 launch
    bitwise equal to its plain version (packed result, frame, carry);
    the audits report no divergence and nothing demotes. cfg7's plain
    comparison is left out (its full-width plain coarse pass alone is
    ~1e10 cells a wave on the host). Returns the kernels line's entries
    for hier_allocate and activeset_allocate."""
    import torch

    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.actions import allocate_batched
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, shipped_tiers
    from kubebatch_tpu_torch.kernels import _build, activeset
    from kubebatch_tpu_torch.kernels import hier as hier_mod
    from kubebatch_tpu_torch.kernels.telemetry import FIELDS
    from kubebatch_tpu_torch.sim import build_cluster

    names = ("hier_allocate", "activeset_allocate")
    activeset.reset()
    activeset.set_audit_every(3)
    audits0 = metrics.activeset_audits_by_result()
    demotions0 = metrics.activeset_demotions_total()
    tiers = shipped_tiers()
    actions = CONFIG_ACTIONS[6]
    results = {"hier": [], "activeset": []}
    timing = {}

    def drive(label, cache, sim, binder, want_engine, want_kind,
              want_binds, check):
        _build.reset_launch_counts()
        rb0 = metrics.blocking_readbacks()
        b0 = binder.count
        n_rec = len(rec.calls)
        l0 = lt.mark()
        ms, _, _ = run_cycle(cache, tiers, actions)
        l_s, l_pods = (b - a for a, b in zip(l0, lt.mark()))
        syncs = metrics.blocking_readbacks() - rb0
        launches = {n: _build.launch_count(n) for n in names}
        engine = allocate_mod.last_cycle_engine
        calls = rec.calls[n_rec:]
        if engine != want_engine or len(calls) != 1 \
                or calls[0]["kind"] != want_kind or syncs != 1 \
                or sum(launches.values()) != 1:
            raise AssertionError(
                f"{label}: engine {engine}, launches {launches}, kinds "
                f"{[c['kind'] for c in calls]}, syncs {syncs}; expected "
                f"{want_engine}, one {want_kind} launch, one sync")
        binds = binder.count - b0
        bad_gangs = gang_all_or_nothing(cache)
        over = capacity_violations(sim)
        if binds != want_binds or bad_gangs or over:
            raise AssertionError(f"{label}: binds {binds} (expected "
                                 f"{want_binds}), gangs broken {bad_gangs}, "
                                 f"nodes over capacity {over}")
        call = calls[0]
        record_digest(label, {"args": call["args"], "kw": call["kw"]},
                      call["out"])
        counters = dict(zip(hier_mod.COUNTERS,
                            call["counters"].cpu().tolist()))
        t = (call["args"][2] if call["kind"] == "audit"
             else call["kw"])["task_valid"].shape[0]
        packed = call["out"][0].cpu()
        frame = dict(zip(FIELDS, packed[3 * t + 1:].tolist()))
        phases = dict(allocate_batched.last_phases)
        entry = {"label": label, "kind": call["kind"], "t_pad": t,
                 "rounds": int(packed[3 * t]), "frame": frame,
                 "counters": counters, "kernel_ms": phases["kernel"],
                 "launch_route": call["route"],
                 "cluster_ctas": call["cluster"],
                 "phase_ns": hier_mod.last_launch["phase_ns"],
                 "host_ms": {**{k: round(v, 3) for k, v in ms.items()},
                             **{k: round(v, 3) for k, v in phases.items()},
                             "ledger": l_s * 1e3},
                 "ledger_closes": l_pods, "launches": launches}
        if check:
            chk = check_scale_call(call)
            plain_counts = {k: chk["stats"].get(k, 0)
                            for k in hier_mod.COUNTERS}
            entry.update(plain_ms=chk["plain_ms"], err=chk["err"])
            if plain_counts != counters:
                raise AssertionError(
                    f"(g) {label}: the kernel's work counters {counters} "
                    f"differ from the plain version's {plain_counts}")
        results["hier" if call["kind"] == "hier"
                else "activeset"].append((entry, call))
        log(f"(g) {label}: engine {engine}, {entry['rounds']} rounds, "
            f"{call['route']} route"
            + (f" ({call['cluster']} CTAs)" if call['cluster'] else "")
            + f", kernel {entry['kernel_ms']:.3f} ms (events), "
            f"{'bitwise equal to plain (' + format(entry['plain_ms'], '.0f') + ' ms on the host CPU)' if check else 'plain comparison left out'}; "
            f"binds {binds}; frame "
            + json.dumps({k: frame[k] for k in (
                "waves", "bound", "failed", "pending", "pool_occ",
                "bucket_fill", "narrow", "narrow_gate", "retries",
                "stranded", "act_tasks", "act_nodes", "act_scatter",
                "act_demoted")})
            + f"; counters {json.dumps(counters)}; host ms "
            + json.dumps(entry["host_ms"]))
        return entry

    with SolveRecorder() as rec, LedgerTimer() as lt:
        # ---- cfg6: cold, then six skewed churn cycles ----------------
        t0 = time.perf_counter()
        sim = build_cluster(spec6)
        binder = FreshBinder()
        cache = SchedulerCache(binder=binder, async_writeback=False,
                               device=dev)
        sim.populate(cache)
        log(f"(g) cfg6: {len(sim.nodes)} nodes, {len(sim.pods)} pods built "
            f"and populated in {time.perf_counter() - t0:.1f} s")
        drive("cfg6 cold", cache, sim, binder, "hier", "hier",
              len(sim.pods), True)
        timing["cfg6"] = {k: (v.clone() if hasattr(v, "clone") else v)
                          for k, v in results["hier"][-1][1]["kw"].items()}
        for k, n in enumerate((256, 256, 1024, 1024, 4096, 4096)):
            t0 = time.perf_counter()
            binder.kubelet_tick(cache)
            if sim.churn_tick(cache, n, arrival_queue=(0, 3)[k % 2]) != n:
                raise AssertionError(f"(g) churn did not recycle {n} pods")
            tick_ms = (time.perf_counter() - t0) * 1e3
            e = drive(f"cfg6 churn {k} ({n} pods)", cache, sim, binder,
                      "activeset", "audit" if k % 3 == 0 else "activeset",
                      n, True)
            e["host_ms"]["kubelet_and_churn"] = round(tick_ms, 3)
            if e["kind"] == "activeset" and n not in timing:
                timing[n] = ({kk: (v.clone() if hasattr(v, "clone") else v)
                              for kk, v in results["activeset"][-1][1][
                                  "kw"].items()}, "activeset")
            if e["kind"] == "audit" and "audit" not in timing:
                c = results["activeset"][-1][1]
                timing["audit"] = (tuple({kk: v.clone() for kk, v in
                                          a.items()} for a in c["args"]),
                                   c["kw"])
        audits = {r: metrics.activeset_audits_by_result().get(r, 0)
                  - audits0.get(r, 0) for r in ("ok", "diff")}
        if audits != {"ok": 2, "diff": 0} or activeset.demoted() \
                or metrics.activeset_demotions_total() != demotions0:
            raise AssertionError(f"(g) audits {audits}, demoted "
                                 f"{activeset.demoted()}")
        log(f"(g) cfg6 churn: activeset_audits_total{{ok}} +2, "
            f"activeset_demotions_total flat, grains "
            + ", ".join(str(e["t_pad"]) for e, _ in results["activeset"]))
        cache.stop()
        del cache, sim
        # ---- cfg7: cold, once ---------------------------------------
        t0 = time.perf_counter()
        sim7 = build_cluster(spec7)
        binder7 = FreshBinder()
        cache7 = SchedulerCache(binder=binder7, async_writeback=False,
                                device=dev)
        sim7.populate(cache7)
        log(f"(g) cfg7: {len(sim7.nodes)} nodes, {len(sim7.pods)} pods "
            f"built and populated in {time.perf_counter() - t0:.1f} s")
        cold7 = drive("cfg7 cold", cache7, sim7, binder7, "hier", "hier",
                      len(sim7.pods), False)
        kw7 = results["hier"][-1][1]["kw"]

    # ---- timings (after the main-path counts were read) ----------------
    def time_launch(fn, kernel):
        ev = cuda_ms(fn, reps=1)
        prof = profiled_ms(fn, kernel, reps=1)
        return ev, prof

    hier_t = {}
    for label, kw in (("cfg6", timing["cfg6"]), ("cfg7", kw7)):
        hier_t[label] = time_launch(lambda kw=kw: hier_mod.hier_packed(**kw),
                                    "hier_allocate_kernel")
    act_t = {}
    for n in (256, 1024, 4096):
        if n in timing:
            kw, _ = timing[n]
            act_t[n] = time_launch(
                lambda kw=kw: activeset.activeset_packed(**kw),
                "hier_allocate_kernel")
    if "audit" in timing:
        (node, act, full), kw = timing["audit"]
        act_t["audit"] = time_launch(
            lambda: activeset.activeset_audit_packed(node, act, full, **kw),
            "hier_allocate_kernel")
    del cache7, sim7

    def entry_bounds(entry, call):
        kw = call["kw"]
        if call["kind"] == "audit":
            node, act, full = call["args"]
            kw = {**node, **full, **kw}
        pipe = bool(kw["pipe_enabled"])
        pool = hier_mod.hier_pool_size(kw["idle"].shape[0],
                                       kw.get("pool_size", 0))
        return scale_bounds({k: v for k, v in kw.items()
                             if hasattr(v, "numel")}, call["out"],
                            entry["counters"], entry["rounds"], pipe, pool)

    hb = {e["label"]: entry_bounds(e, c) for e, c in results["hier"]}
    ab = {e["label"]: entry_bounds(e, c) for e, c in results["activeset"]}
    for e, _ in results["hier"] + results["activeset"]:
        b = hb.get(e["label"]) or ab[e["label"]]
        log(f"(g) {e['label']}: bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}: {b['bytes']} B, {b['ops']} operations); "
            f"kernel {e['kernel_ms']:.3f} ms (events, main path)")
    ledger_cost = {}
    for e, _ in results["hier"] + results["activeset"]:
        h = e["host_ms"]
        ledger_cost[e["label"]] = {
            "ledger_ms": h["ledger"], "closes": e["ledger_closes"],
            "replay_ms": h["replay"],
            "share_of_replay": h["ledger"] / h["replay"]}
        log(f"(g) {e['label']}: the ledger's work {h['ledger']:.3f} ms "
            f"(close_many, stage_mark, its span hook) for "
            f"{e['ledger_closes']} closes, "
            f"{h['ledger'] / max(1, e['ledger_closes']) * 1e3:.3f} us a "
            f"pod; {100 * h['ledger'] / h['replay']:.2f}% of the replay's "
            f"{h['replay']:.1f} ms")
    for label, (ev, prof) in hier_t.items():
        log(f"(g) hier_allocate {label} cold re-run: {ev:.3f} ms (events), "
            f"{prof} ms device time (profiler)")
    for label, (ev, prof) in act_t.items():
        log(f"(g) activeset_allocate {label}: {ev:.3f} ms (events), "
            f"{prof} ms device time (profiler)")
    from kubebatch_tpu_torch.kernels.batched import PHASES

    # the cold launches and every active-set launch: phases and barriers
    keys = PHASES + hier_mod.HIER_PHASES
    for e, _ in results["hier"] + results["activeset"]:
        pn = e.pop("phase_ns").cpu().tolist()
        phase_ms = {k: v / 1e6 for k, v in zip(keys, pn) if v}
        e["phase_ms"] = phase_ms
        e["barriers"] = pn[len(keys)]
        log(f"(g) {e['label']}, main-path launch ({e['launch_route']} "
            f"route), device ms per phase (thread 0 between barriers; sum "
            f"{sum(phase_ms.values()):.3f}; {chain_share(phase_ms)}; "
            f"{e['barriers']} barriers): "
            + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))

    c6 = results["hier"][0][0]
    acts = [e for e, _ in results["activeset"]]
    steady = [e for e in acts if e["kind"] == "activeset"][0]
    ms256 = act_t[256][1] if act_t[256][1] is not None else act_t[256][0]
    hier_entry = {
        "name": "hier_allocate", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/hier_allocate.cu",
        "replaces": "kubebatch_tpu/kernels/hier.py:368",
        "launches": sum(e["launches"]["hier_allocate"]
                        for e, _ in results["hier"]),
        "max_abs_err": c6["err"],
        "ms": (hier_t["cfg6"][1] if hier_t["cfg6"][1] is not None
               else hier_t["cfg6"][0]),
        "main_path_event_ms": c6["kernel_ms"],
        "event_ms": hier_t["cfg6"][0], "profiler_ms": hier_t["cfg6"][1],
        "plain_ms": c6["plain_ms"], "plain_device": "cpu",
        "bound_ms": hb["cfg6 cold"]["bound_ms"],
        "bound_by": hb["cfg6 cold"]["bound_by"], "library_ms": None,
        "library_call": "none", "rounds": c6["rounds"],
        "cfg7_main_path_event_ms": cold7["kernel_ms"],
        "cfg7_event_ms": hier_t["cfg7"][0],
        "cfg7_profiler_ms": hier_t["cfg7"][1],
        "cfg7_bound_ms": hb["cfg7 cold"]["bound_ms"],
        "cfg7_bound_by": hb["cfg7 cold"]["bound_by"],
        "cfg7_rounds": cold7["rounds"], "phase_ms": c6["phase_ms"],
        "cfg7_phase_ms": cold7["phase_ms"], "ledger_cost": ledger_cost}
    act_entry = {
        "name": "activeset_allocate", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/hier_allocate.cu",
        "replaces": "kubebatch_tpu/kernels/activeset.py:453",
        "launches": sum(e["launches"]["activeset_allocate"] for e in acts),
        "max_abs_err": max(e["err"] for e in acts),
        "ms": ms256, "main_path_event_ms": steady["kernel_ms"],
        "plain_ms": steady["plain_ms"], "plain_device": "cpu",
        "bound_ms": ab[steady["label"]]["bound_ms"],
        "bound_by": ab[steady["label"]]["bound_by"],
        "library_ms": None, "library_call": "none",
        "per_cycle": [{"label": e["label"], "kind": e["kind"],
                       "t_pad": e["t_pad"], "rounds": e["rounds"],
                       "launch_route": e["launch_route"],
                       "cluster_ctas": e["cluster_ctas"],
                       "barriers": e["barriers"],
                       "event_ms": e["kernel_ms"], "plain_ms": e["plain_ms"],
                       "bound_ms": ab[e["label"]]["bound_ms"],
                       "bound_by": ab[e["label"]]["bound_by"]}
                      for e in acts],
        "rerun_ms": {str(k): v for k, v in act_t.items()},
        "launch_routes": sorted({
            f"{e['launch_route']}" + (f" ({e['cluster_ctas']} CTAs)"
                                         if e["cluster_ctas"] else "")
            for e in acts})}
    return [hier_entry, act_entry]


#: the least work of the explainer's counts (csrc/explain_counts.cu's
#: function, counted as the card would do it at the fewest instructions,
#: whatever the design). A count over candidates needs one bit a
#: candidate and one popcount and add a word of 32 of them, so only the
#: bits are counted per cell: per (real task x candidate node) cell the
#: three float32 request compares (FSETP chains their AND in its
#: predicate input) and one 32-bit operation, the predicated set of the
#: cell's bit in the row's result word; with ports two more, the port
#: words' AND with its zero test (one LOP3 with a predicate output) and
#: the set of the conflict bit. Per task row and word of 32 candidates:
#: the resources count (the result word's popcount and add) and the
#: eligible count (the result word ANDed with the signature's predicate
#: and slot word, its popcount and add), 5; with ports the conflict
#: word's popcount and add, 2 more (its complement joins the eligible
#: AND's LOP3). The predicate column depends only on (signature, node):
#: per signature and candidate its bit, per signature and word its
#: popcount and add and the AND with the slot word. The task-slots and
#: candidate columns depend only on the node: per node the candidate
#: test and the slot compare, per word of 32 nodes their popcounts and
#: adds; per task one read of its signature's count and of the totals.
OPS_PER_CELL_EXPLAIN_F32 = 3
OPS_PER_CELL_EXPLAIN_I32 = 1
OPS_PER_CELL_EXPLAIN_PORTS = 2
OPS_PER_ROW_WORD_EXPLAIN = 5
OPS_PER_ROW_WORD_EXPLAIN_PORTS = 2
OPS_PER_SIG_NODE_EXPLAIN = 1
OPS_PER_SIG_WORD_EXPLAIN = 3
OPS_PER_NODE_EXPLAIN = 2
OPS_PER_NODE_WORD_EXPLAIN = 4
OPS_PER_TASK_EXPLAIN = 2


def explain_bounds(kw, out, has_ports: bool, t_real: int,
                   n_cand: int) -> dict:
    """The explainer's roofline for one call: every input read once
    (the port arrays only with ``has_ports``) and the [T, 6] block
    written once, over the memory rate; the operations of the cells over
    real tasks x candidate nodes (one bit each; the port work only with
    ``has_ports``), of the rows' popcounts a word of 32 candidates, of
    the signatures' predicate columns over the signatures the real tasks
    use x candidate nodes, of the nodes and of the tasks, float32
    compares at the float32 rate and the rest at the 32-bit integer rate.
    ``distinct_rows`` counts the real task rows that differ in
    (signature, request, ports): a kernel folding equal rows would need
    only that many rows of cells."""
    import torch

    nbytes = sum(v.numel() * v.element_size() for k, v in kw.items()
                 if has_ports or k not in ("task_ports", "port_base"))
    nbytes += out.numel() * out.element_size()
    cells = t_real * n_cand
    n_pad = int(kw["idle"].shape[0])
    sigs = int(torch.unique(kw["task_sig"][:t_real].cpu()).numel())
    words = (n_cand + 31) // 32
    i32 = cells * (OPS_PER_CELL_EXPLAIN_I32 + (OPS_PER_CELL_EXPLAIN_PORTS
                                               if has_ports else 0)) \
        + t_real * words * (OPS_PER_ROW_WORD_EXPLAIN + (
            OPS_PER_ROW_WORD_EXPLAIN_PORTS if has_ports else 0)) \
        + sigs * (n_cand * OPS_PER_SIG_NODE_EXPLAIN
                  + words * OPS_PER_SIG_WORD_EXPLAIN) \
        + n_pad * OPS_PER_NODE_EXPLAIN \
        + (n_pad + 31) // 32 * OPS_PER_NODE_WORD_EXPLAIN \
        + t_real * OPS_PER_TASK_EXPLAIN
    f32 = cells * OPS_PER_CELL_EXPLAIN_F32
    t_ops = (f32 / PEAK_F32_PER_S + i32 / PEAK_I32_PER_S) * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    cols = [kw["task_sig"][:t_real, None].double(),
            kw["resreq"][:t_real].double()]
    if has_ports:
        cols.append(kw["task_ports"][:t_real].double())
    distinct = int(torch.unique(torch.cat(cols, 1).cpu(), dim=0).shape[0])
    return {"bytes": nbytes, "cells": cells, "ops": f32 + i32,
            "f32_ops": f32, "i32_ops": i32, "signatures": sigs,
            "distinct_rows": distinct, "bound_ms": b_ms, "bound_by": b_by}


class ExplainRecorder:
    """Wraps obs.explain.explain_counts: keeps a copy of each launch's
    inputs and result (the device carry is refreshed in place by later
    cycles) for the plain comparison on the card."""

    def __init__(self):
        from kubebatch_tpu_torch.obs import explain

        self.mod = explain
        self.inner = explain.explain_counts
        self.calls = []

    def __call__(self, **kw):
        out = self.inner(**kw)
        self.calls.append(({k: v.clone() if hasattr(v, "clone") else v
                            for k, v in kw.items()}, out.clone()))
        return out

    def __enter__(self):
        self.mod.explain_counts = self
        return self

    def __exit__(self, *exc):
        self.mod.explain_counts = self.inner

    def check(self, what: str) -> float:
        """Every recorded launch bitwise equal to the plain version on
        the card; returns the max abs error (0)."""
        import torch

        err = 0.0
        for kw, got in self.calls:
            want = self.mod.explain_counts_plain(**kw)
            torch.cuda.synchronize()
            err = max(err, max_abs_err([want], [got]))
            assert_bitwise([want], [got], what)
        return err


def http_get(base: str, path: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(base + path, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_phase(dev, spec4, spec5, spec5p, spec3p,
              churn: int = 256) -> dict:
    """Phase (h): the observability plane. (h1) a saturated cfg4 through
    ``Scheduler(explain_unschedulable=True, slo=True)`` on the default
    conf, with the flight recorder, timeline and trace export armed into
    build/chip_smoke_obs: a cold period and a churn-256 period, each one
    ``explain_counts`` launch bitwise equal to plain and one counted sync
    more than a twin loop without the explainer fed the same events;
    the reasons name ``resources``; the fresh-inputs launch equals the
    host oracle; the five debug endpoints answer and /debug/explain is
    the latest snapshot; the ledger closed one record per bind; an
    injected ``device.dispatch`` failure and the ``obs.slo`` seam each
    dump the ring. (h2) 5p and 3p cold periods through the shipped conf
    with the explainer on, then 5p after a kubelet tick and a churn of
    1,024 pods: one launch on a fresh session with ports claimed, a
    nonzero port-conflict column. (h3) the kernel at
    full width on fresh cold cfg5 and 5p sessions, timed beside its
    bound and the plain version. Returns the kernels line's entry."""
    import shutil

    import torch

    from kubebatch_tpu_torch import faults, metrics, obs
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.obs import (explain, export, flight, http,
                                         ledger, slo, timeline)
    from kubebatch_tpu_torch.runtime import Scheduler
    from kubebatch_tpu_torch.sim import build_cluster

    t_phase = time.perf_counter()
    shipped = open(os.path.join(HERE, "config", "kube-batch-conf.yaml")).read()
    out_dir = os.path.join(HERE, "build", "chip_smoke_obs")
    shutil.rmtree(out_dir, ignore_errors=True)
    flight_dir = os.path.join(out_dir, "flight")
    flight.arm(flight_dir)
    timeline.arm(os.path.join(out_dir, "timeline"), spill_every=1)
    trace_path = export.arm(os.path.join(out_dir, "trace"))
    ledger.reset()
    launches = {}

    def side(spec, explained: bool, conf: str = ""):
        sim = build_cluster(spec)
        binder = FreshBinder()
        cache = SchedulerCache(device=dev, binder=binder,
                               async_writeback=False)
        sim.populate(cache)
        sched = Scheduler(cache, conf, explain_unschedulable=explained,
                          slo=explained)
        return sim, cache, binder, sched

    def drive(label, sched, binder):
        _build.reset_launch_counts()
        rb0 = metrics.blocking_readbacks()
        b0 = binder.count
        t0 = time.perf_counter()
        ok = sched.run_cycle()
        wall = (time.perf_counter() - t0) * 1e3
        n = _build.launch_count("explain_counts")
        if not ok:
            raise AssertionError(f"(h) {label}: the cycle failed "
                                 f"({sched.last_cycle_failure})")
        return {"launches": n, "syncs": metrics.blocking_readbacks() - rb0,
                "binds": binder.count - b0, "wall_ms": wall}

    def quiet(fn):
        """Run ``fn`` with the ledger and the cycle hooks off (the twin
        loop's work stays out of the plane under test)."""
        ledger.set_enabled(False)
        obs.set_enabled(False)
        try:
            return fn()
        finally:
            obs.set_enabled(True)
            ledger.set_enabled(True)

    h3 = {}
    err = 0.0

    def fresh(label, cache):
        """explain_session on a freshly opened session of ``cache``: its
        one launch (counted) checked bitwise against plain on the card."""
        nonlocal err
        ssn = OpenSession(cache, shipped_tiers())
        inputs = build_cycle_inputs(ssn, allow_affinity=True)
        kw, has_ports = explain.explain_args(inputs)
        _build.reset_launch_counts()
        with ExplainRecorder() as rec:
            snap = explain.explain_session(ssn)
            n = _build.launch_count("explain_counts")
            err = max(err, rec.check(f"explain_counts {label}"))
        CloseSession(ssn)
        if n != 1 or len(rec.calls) != 1:
            raise AssertionError(f"(h) {label}: {n} explain_counts "
                                 f"launches, expected 1")
        return inputs, kw, has_ports, rec.calls[0][1], snap

    def full_width(label, cache):
        """``fresh`` on a cold cache (every pod pending), then the kernel
        timed beside its bound and the plain version on the card."""
        inputs, kw, has_ports, got, snap = fresh(f"{label} full width",
                                                 cache)
        t_real, n_cand = len(inputs.tasks), int(got[0, 5])
        b = explain_bounds(kw, got, has_ports, t_real, n_cand)
        for _ in range(10):             # clocks up after the host work
            explain.explain_counts(**kw, has_ports=has_ports)
        ev = cuda_ms(lambda: explain.explain_counts(**kw,
                                                    has_ports=has_ports), 50)
        prof = profiled_ms(lambda: explain.explain_counts(
            **kw, has_ports=has_ports), "explain_counts_kernel", reps=10)
        plain = cuda_ms(lambda: explain.explain_counts_plain(
            **kw, has_ports=has_ports), 3)
        launch = {}
        if kw["idle"].device.type == "cuda":
            launch = {"shape": explain.launch_shape(
                          *explain.last_launch["sizes"]),
                      "phase_ms": dict(zip(explain.PHASES, (
                          v / 1e6 for v in explain.last_launch[
                              "phase_ns"].cpu().tolist())))}
        h3[label] = {"t_pad": int(kw["task_valid"].shape[0]),
                     "n_pad": int(kw["idle"].shape[0]), "t_real": t_real,
                     "n_cand": n_cand, "pt": int(kw["task_ports"].shape[1]),
                     "has_ports": has_ports, "event_ms": ev,
                     "profiler_ms": prof, "plain_ms": plain, **b,
                     "launch": launch,
                     "unschedulable": snap["unschedulable_tasks"]}
        log(f"(h3) {label} fresh cold session: T_pad {h3[label]['t_pad']} x "
            f"N_pad {h3[label]['n_pad']} ({t_real} tasks x {n_cand} "
            f"candidates, PT {h3[label]['pt']}, ports {has_ports}): "
            f"{ev:.4f} ms a launch (events, 50), {prof} ms device time "
            f"(profiler); plain {plain:.3f} ms on the card; bound "
            f"{b['bound_ms']:.6f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['cells']} cells, {b['f32_ops']} float32 + {b['i32_ops']} "
            f"integer operations), {ev / b['bound_ms']:.2f}x (events); "
            f"{b['distinct_rows']} distinct task rows, {b['signatures']} "
            f"signatures; launch {json.dumps(launch)}")

    # ---- (h1) saturated cfg4 ----------------------------------------------
    t0 = time.perf_counter()
    sim4, cache4, bind4, sched4 = side(spec4, True)
    # the shipped ledger objectives (5 s arrival -> bind) assume pods that
    # arrive live; this backlog is stamped at populate, seconds before
    # the cold period binds it: those objectives are set to 10 minutes
    slo.arm([dataclasses.replace(o, threshold_ms=600_000.0)
             if o.kind == "ledger" else o for o in slo.DEFAULT_OBJECTIVES])
    tsim, tcache, tbind, tsched = quiet(lambda: side(spec4, False))
    log(f"(h1) saturated cfg4, two incremental caches (explainer on / a "
        f"twin without it): {len(cache4.nodes)} nodes, {len(sim4.pods)} "
        f"pods each, built in {time.perf_counter() - t0:.1f} s")
    periods = []
    with ExplainRecorder() as rec:
        for k in range(2):
            recycled = []
            if k:
                # only fully bound gangs finish: on the saturated cluster
                # the churn recycles what the cold period completed
                for sim, cache, binder in ((sim4, cache4, bind4),
                                           (tsim, tcache, tbind)):
                    def tick(sim=sim, cache=cache, binder=binder):
                        binder.kubelet_tick(cache)
                        return sim.churn_tick(cache, churn)
                    recycled.append(tick() if sim is sim4 else quiet(tick))
                if recycled[0] != recycled[1]:
                    raise AssertionError(f"(h1) churn recycled {recycled}")
            n_rec = len(rec.calls)
            on = drive(f"cfg4 period {k}", sched4, bind4)
            root = obs.last_cycle()
            snap = explain.latest()
            off = quiet(lambda: drive(f"cfg4 twin {k}", tsched, tbind))
            exp_sp = root.find("explain")
            tree = {c.name: round(c.dur * 1e3, 3)
                    for c in (exp_sp.children if exp_sp else ())}
            reasons = {}
            for rec_job in snap["jobs"]:
                for r, v in rec_job["reasons"].items():
                    reasons[r] = reasons.get(r, 0) + v
            p = {"period": k, "on": on, "off": off,
                 "recycled": recycled[0] if recycled else 0,
                 "unschedulable": snap["unschedulable_tasks"],
                 "pending": snap["pending_tasks"], "reasons": reasons,
                 "cycle_ms": root.dur * 1e3,
                 "explain_ms": exp_sp.dur * 1e3 if exp_sp else None}
            periods.append(p)
            log(f"(h1) cfg4 period {k} (churn recycled {p['recycled']} "
                f"pods): launches {on['launches']} (twin "
                f"{off['launches']}), counted syncs {on['syncs']} (twin "
                f"{off['syncs']}), binds {on['binds']} (twin "
                f"{off['binds']}); pending {p['pending']}, unschedulable "
                f"{p['unschedulable']}, reasons {json.dumps(reasons)}; "
                f"cycle {p['cycle_ms']:.1f} ms, explain span "
                f"{p['explain_ms']:.3f} ms (of it {json.dumps(tree)}), "
                f"actions {json.dumps(action_ms(root))}")
            if on["launches"] != 1 or off["launches"] != 0 \
                    or len(rec.calls) != n_rec + 1:
                raise AssertionError(f"(h1) period {k}: explain_counts "
                                     f"launches {on['launches']} / twin "
                                     f"{off['launches']}, expected 1 / 0")
            if on["syncs"] != off["syncs"] + 1:
                raise AssertionError(f"(h1) period {k}: {on['syncs']} "
                                     f"counted syncs, the twin "
                                     f"{off['syncs']}: not one more")
            if on["binds"] != off["binds"]:
                raise AssertionError(f"(h1) period {k}: the explained loop "
                                     f"bound differently from its twin")
            if p["unschedulable"] <= 0 or "resources" not in reasons:
                raise AssertionError(f"(h1) period {k}: no unschedulable "
                                     f"task with a resources reason")
        launches["h1"] = sum(p["on"]["launches"] for p in periods)
        err = max(err, rec.check("explain_counts cfg4 periods"))
        # fresh inputs: the device pass on a just-built session equals
        # the host oracle (the state the NodeState mirror holds)
        ssn = OpenSession(cache4, shipped_tiers())
        inputs = build_cycle_inputs(ssn, allow_affinity=True)
        dev_counts = explain.failure_counts_device(inputs)
        host_counts = explain.failure_counts_host(inputs)
        CloseSession(ssn)
        for a, b in zip(dev_counts, host_counts):
            if not (a == b if isinstance(a, int)
                    else bool((a == b).all())):
                raise AssertionError("(h1) fresh inputs: the device pass "
                                     "differs from the host oracle")
        err = max(err, rec.check("explain_counts cfg4 fresh inputs"))
    log(f"(h1) every launch ({len(rec.calls)}) bitwise equal to plain on "
        f"the card; on fresh inputs the device pass == the host oracle "
        f"({len(dev_counts[1])} tasks, {dev_counts[2]} candidates)")
    # ---- the debug server ---------------------------------------------
    srv = http.DebugHTTPServer("127.0.0.1", 0).start()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        got = {p: http_get(base, p) for p in (
            "/metrics", "/healthz", "/debug/vars", "/debug/explain",
            "/debug/slo")}
    finally:
        srv.stop()
    bad = {p: c for p, (c, _) in got.items() if c != 200}
    if bad:
        raise AssertionError(f"(h1) endpoints answered {bad}")
    docs = {p: json.loads(b) for p, (_, b) in got.items() if p != "/metrics"}
    metrics_text = got["/metrics"][1].decode()
    if not metrics_text.endswith("# EOF\n") \
            or "kube_batch_decisions_total" not in metrics_text:
        raise AssertionError("(h1) /metrics is not the OpenMetrics text")
    if docs["/debug/explain"] != json.loads(json.dumps(explain.latest())):
        raise AssertionError("(h1) /debug/explain differs from latest()")
    if not docs["/debug/slo"]["armed"]:
        raise AssertionError("(h1) /debug/slo: the plane is not armed")
    lstats = ledger.stats()
    binds = sum(p["on"]["binds"] for p in periods)
    log(f"(h1) endpoints: 5 x 200 ({len(metrics_text)} B of OpenMetrics, "
        f"healthz {docs['/healthz']['status']}); ledger closed "
        f"{lstats['closed_total']} == binds {binds}, unmatched "
        f"{lstats['unmatched_total']}, arrival->bind "
        f"{json.dumps(lstats.get('arrival_bind'))}")
    if lstats["closed_total"] != binds or lstats["unmatched_total"]:
        raise AssertionError("(h1) the ledger's closes differ from the "
                             "binds")
    # ---- an injected dispatch failure and the SLO seam both dump --------
    dumps0 = set(os.listdir(flight_dir))
    faults.arm(faults.FaultPlan(counts={"device.dispatch": 1}))
    try:
        if sched4.run_cycle() or sched4.last_cycle_failure != "exception":
            raise AssertionError("(h1) the injected failure did not fail "
                                 "the cycle")
    finally:
        faults.disarm()
    b0 = metrics.slo_breaches_by_objective()
    faults.arm(faults.FaultPlan(counts={"obs.slo": 1}))
    try:
        if not sched4.run_cycle():
            raise AssertionError("(h1) the SLO seam's cycle failed")
    finally:
        faults.disarm()
    moved = {k: v - b0.get(k, 0)
             for k, v in metrics.slo_breaches_by_objective().items()
             if v != b0.get(k, 0)}
    new = sorted(set(os.listdir(flight_dir)) - dumps0)
    reasons = [json.load(open(os.path.join(flight_dir, n)))["reason"]
               for n in new]
    log(f"(h1) dumps {new}: reasons {reasons}; SLO breaches moved "
        f"{json.dumps(moved)}")
    seen = [r for r in reasons if r in ("cycle_failure-exception",
                                        "slo_breach-injected")]
    if seen != ["cycle_failure-exception", "slo_breach-injected"] \
            or moved.get("injected/fast") != 1 \
            or moved.get("injected/slow") != 1:
        raise AssertionError("(h1) the failure and SLO dumps are not the "
                             "expected two")
    cache4.stop()
    tcache.stop()
    del sim4, cache4, tsim, tcache
    # ---- (h2) 5p and 3p cold, the shipped conf ----------------------------
    h2, ports = {}, None
    with ExplainRecorder() as rec:
        for label, spec in (("5p", spec5p), ("3p", spec3p)):
            t0 = time.perf_counter()
            sim, cache, binder, sched = side(spec, True, shipped)
            built = time.perf_counter() - t0
            if label == "5p":
                # (h3) at 5p: the full width before the period (cold)
                n_rec0 = len(rec.calls)
                full_width(label, cache)
                del rec.calls[n_rec0:]   # checked inside, not main path
            n_rec = len(rec.calls)
            c = drive(f"{label} cold", sched, binder)
            snap = explain.latest()
            kw = rec.calls[-1][0] if len(rec.calls) > n_rec else {}
            pt = int(kw["task_ports"].shape[1]) if kw else 0
            reasons = {}
            for rec_job in snap["jobs"]:
                for r, v in rec_job["reasons"].items():
                    reasons[r] = reasons.get(r, 0) + v
            h2[label] = dict(c, pt=pt, reasons=reasons,
                             pending=snap["pending_tasks"],
                             unschedulable=snap["unschedulable_tasks"])
            log(f"(h2) {label} cold (built in {built:.1f} s): launches "
                f"{c['launches']}, syncs {c['syncs']}, binds {c['binds']}, "
                f"PT {pt}; pending {snap['pending_tasks']}, unschedulable "
                f"{snap['unschedulable_tasks']}, reasons "
                f"{json.dumps(reasons)}; wall {c['wall_ms']:.1f} ms")
            # a period that leaves nothing pending publishes the empty
            # snapshot without a launch, as the reference's does
            want = 1 if snap["pending_tasks"] else 0
            if c["launches"] != want or c["syncs"] < want:
                raise AssertionError(f"(h2) {label}: {c['launches']} "
                                     f"explain_counts launches for "
                                     f"{snap['pending_tasks']} pending")
            if label == "5p":
                # the port branch with ports claimed: after a kubelet
                # tick and a churn of 1,024 pods (its fresh gangs include
                # one that asks for a port the cold period's binds hold),
                # the explainer on a fresh session over the bound cache
                binder.kubelet_tick(cache)
                recycled = sim.churn_tick(cache, 1024)
                _, kw, has_ports, got, snap = fresh("5p after churn", cache)
                cols = got[:, :5].sum(0).tolist()
                ports = {"recycled": recycled, "has_ports": has_ports,
                         "pt": int(kw["task_ports"].shape[1]),
                         "pending": snap["pending_tasks"],
                         "column_sums": cols,
                         "unschedulable": snap["unschedulable_tasks"]}
                log(f"(h2) 5p after a kubelet tick and churn 1,024 "
                    f"({recycled} recycled): one launch bitwise equal to "
                    f"plain, PT {ports['pt']}, ports {has_ports}, pending "
                    f"{ports['pending']}; column sums (predicate, "
                    f"resources, task-slots, port-conflict, eligible) "
                    f"{cols}")
                if not has_ports or cols[3] <= 0:
                    raise AssertionError("(h2) 5p after churn: no port "
                                         "conflict counted with ports "
                                         "claimed")
            cache.stop()
        err = max(err, rec.check("explain_counts 5p / 3p cold"))
    if not h3["5p"]["has_ports"]:
        raise AssertionError("(h3) 5p did not take the port branch")
    launches["h2"] = sum(v["launches"] for v in h2.values()) + 1
    # ---- flush the armed exporters ----------------------------------------
    if export.flush() != trace_path:
        raise AssertionError("(h) the trace export wrote nothing")
    events = json.load(open(trace_path))["traceEvents"]
    timeline.flush()
    digests = [json.loads(x) for x in open(os.path.join(
        out_dir, "timeline", "timeline.jsonl"))]
    log(f"(h) Chrome trace {len(events)} events over "
        f"{sum(1 for e in events if e['name'] == 'cycle')} cycle roots; "
        f"timeline {len(digests)} digests; "
        f"{len(os.listdir(flight_dir))} flight dumps")
    if not events or any(e["ph"] != "X" for e in events) or not digests:
        raise AssertionError("(h) the trace or the timeline is empty")
    for mod in (flight, export, timeline, slo):
        mod.disarm()
    # ---- (h3) full width: a fresh cold cfg5 session ----------------------
    sim = build_cluster(spec5)
    cache = SchedulerCache(device=dev, binder=FreshBinder())
    sim.populate(cache)
    full_width("cfg5", cache)
    cache.stop()
    del sim, cache
    c5 = h3["cfg5"]
    entry = {
        "name": "explain_counts", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/explain_counts.cu",
        "replaces": "kubebatch_tpu/obs/explain.py:57",
        "launches": launches["h1"] + launches["h2"],
        "launches_by_part": launches, "max_abs_err": err,
        "ms": c5["profiler_ms"] if c5["profiler_ms"] is not None
        else c5["event_ms"],
        "event_ms": c5["event_ms"], "profiler_ms": c5["profiler_ms"],
        "plain_ms": c5["plain_ms"], "plain_device": "cuda",
        "bound_ms": c5["bound_ms"], "bound_by": c5["bound_by"],
        "library_ms": None, "library_call": "none",
        "full_width": h3, "ports_claimed": ports,
        "h1_periods": [{k: p[k] for k in ("period", "cycle_ms",
                                          "explain_ms", "unschedulable")}
                       for p in periods]}
    log(f"(h) done in {time.perf_counter() - t_phase:.1f} s")
    return entry


def mega_bounds(args, out) -> dict:
    """The mega launch's roofline over all its lanes, counted as
    fused_bounds counts one solve: each stacked input read once and each
    output written once over the memory rate, against each lane's node
    solves (placed + failed, from its telemetry frame) x that lane's real
    nodes (``node_ok``) x the node pass's float32 operations over the
    float32 rate."""
    from kubebatch_tpu_torch.kernels.mega import ARG_NAMES

    frames = out[0][:, 0, -20:].tolist()
    n_pad = args[0].shape[1]
    n_real = args[ARG_NAMES.index("node_ok")].sum(dim=1).tolist()
    solves = [f[2] + f[3] for f in frames]
    nbytes = sum(a.numel() * a.element_size() for a in args)
    nbytes += sum(t.numel() * t.element_size() for t in out)
    ops = sum(k * n for k, n in zip(solves, n_real)) * OPS_PER_NODE_FUSED
    b_ms, b_by = bound(nbytes, ops)
    return {"lanes": len(frames), "n_pad": n_pad, "n_real": n_real,
            "n_solves": sum(solves), "iters": [f[1] for f in frames],
            "bytes": nbytes, "ops": ops, "bound_ms": b_ms, "bound_by": b_by}


class MegaRecorder:
    """Wraps the mega solve entry the tenant service calls
    (tenantsvc/megasolve.py ``mega_fused``) to keep each launch's
    stacked inputs and results."""

    def __init__(self):
        from kubebatch_tpu_torch.tenantsvc import megasolve

        self.mod = megasolve
        self.inner = megasolve.mega_fused
        self.calls = []

    def __call__(self, *args, **statics):
        out = self.inner(*args, **statics)
        self.calls.append((args, statics, out))
        return out

    def __enter__(self):
        self.mod.mega_fused = self
        return self

    def __exit__(self, *exc):
        self.mod.mega_fused = self.inner


def tenant_phase(dev, churn: int = 256, n_tenants: int = 8,
                 steady: int = 3, saturation_s: float = 2.0, config=5,
                 aff_config="3p") -> dict:
    """Phase (i): the tenant solve service on the card. (i1) eight cfg5
    tenants (seeds 0-7, uncut) through one ``TenantSolveService``, one
    thread each: a cold cycle (10,000 pending: a single, the batched
    kernel) then ``steady`` churn-256 cycles (fused lanes, coalesced as
    they come), every request and answer through the wire's bytes; the
    end states of tenants 0 and 1 equal dedicated in-process auto runs.
    (i2) each steady cycle's eight requests through ``solve_many``: one
    8-lane ``mega_fused`` launch, its results bitwise equal to
    ``mega_fused_plain`` and to eight single ``fused_allocate``
    launches, its decisions equal to ``solve_snapshot``'s; timed against
    the eight single launches back to back. (i3) a 3p tenant's cold
    request (affinity payload) through the service equals the
    in-process batched cycle. (i4) ``run_saturation`` on the last
    cycle's eight requests. (i5) ``run_multi_tenant`` on four "t"
    tenants. Returns the kernels line's entry."""
    import threading

    import torch

    from kubebatch_tpu_torch import faults, metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels import fused as fused_mod
    from kubebatch_tpu_torch.kernels.fused import fused_allocate
    from kubebatch_tpu_torch.kernels.mega import mega_fused, mega_fused_plain
    from kubebatch_tpu_torch.rpc.client import set_tenant
    from kubebatch_tpu_torch.rpc.server import (decode_snapshot,
                                                fused_lane_args,
                                                solve_snapshot)
    from kubebatch_tpu_torch.sim import tenants as sim_tenants
    from kubebatch_tpu_torch.tenantsvc import megasolve
    from kubebatch_tpu_torch.tenantsvc.service import TenantSolveService

    t_phase = time.perf_counter()

    class RecordingService(TenantSolveService):
        """Keeps every (tenant, request) the service was handed."""

        def __init__(self):
            super().__init__(device=dev)
            self.calls = []
            self._rec = threading.Lock()

        def solve(self, tenant, lane, req, timeout=120.0):
            with self._rec:
                self.calls.append((tenant, req))
            return super().solve(tenant, lane, req, timeout)

    def decisions(resp):
        return [(d.task_uid, d.kind, d.node_name, d.order)
                for d in resp.decisions]

    def service_cycle(sim, cache, binder, svc, n_churn):
        """One tenant cycle through the service on this thread (a
        kubelet tick and a churn of ``n_churn`` first when nonzero), host
        ms per part."""
        from kubebatch_tpu_torch.conf import shipped_tiers
        from kubebatch_tpu_torch.framework import CloseSession, OpenSession
        from kubebatch_tpu_torch.objects import PodPhase
        from kubebatch_tpu_torch.rpc.client import (apply_decisions,
                                                    build_snapshot)
        from kubebatch_tpu_torch.rpc.wire import (DecisionsResponse,
                                                  SnapshotRequest)

        if n_churn:
            for pod in binder.fresh:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)
            binder.fresh.clear()
            sim.churn_tick(cache, n_churn)
        t = [time.perf_counter()]
        ssn = OpenSession(cache, shipped_tiers())
        t.append(time.perf_counter())
        req, tasks = build_snapshot(ssn)
        t.append(time.perf_counter())
        sent = SnapshotRequest.FromString(req.SerializeToString())
        t.append(time.perf_counter())
        resp, _ = svc.solve("alone", "normal", sent)
        t.append(time.perf_counter())
        back = DecisionsResponse.FromString(resp.SerializeToString())
        t.append(time.perf_counter())
        apply_decisions(ssn, back, tasks)
        t.append(time.perf_counter())
        CloseSession(ssn)
        t.append(time.perf_counter())
        ms = [(b - a) * 1e3 for a, b in zip(t, t[1:])]
        return {"pending": len(tasks), "open": ms[0], "encode": ms[1],
                "wire": ms[2] + ms[4], "solve": ms[3], "replay": ms[5],
                "close": ms[6], "wall": sum(ms)}

    names = ("batched_allocate", "fused_allocate", "mega_fused")
    tenants = [f"cfg5-{i}" for i in range(n_tenants)]
    # ---- (i1) eight cfg5 tenants through one service ---------------------
    t0 = time.perf_counter()
    clusters = [sim_tenants._tenant_cluster(i, config, dev)
                for i in range(n_tenants)]
    log(f"(i1) {n_tenants} tenants of config {config} populated in "
        f"{time.perf_counter() - t0:.1f} s")
    svc = RecordingService()
    states, errors, walls = {}, [], {}
    dem0 = metrics.engine_demotions_total()
    mega0 = (metrics.mega_dispatches_total(), metrics.mega_lanes_total())
    tc0 = metrics.tenant_counters()

    def worker(i):
        set_tenant(tenants[i])
        try:
            w0 = time.perf_counter()
            states[i] = sim_tenants.drive_tenant_cycles(
                *clusters[i], 1 + steady, mode="rpc", svc=svc,
                tenant=tenants[i], churn=churn)
            walls[i] = time.perf_counter() - w0
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"{tenants[i]}: {type(e).__name__}: {e}")
        finally:
            set_tenant(None)

    _build.reset_launch_counts()
    with MegaRecorder() as rec:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        i1_wall = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"(i1) tenant errors: {errors}")
        i1_launches = {n: _build.launch_count(n) for n in names}
        i1_mega = (metrics.mega_dispatches_total() - mega0[0],
                   metrics.mega_lanes_total() - mega0[1])
        # ---- (i2) each steady cycle's eight requests, one launch ---------
        by_tenant = {t: [r for tt, r in svc.calls if tt == t]
                     for t in tenants}
        counts = {t: len(v) for t, v in by_tenant.items()}
        if any(n != 1 + steady for n in counts.values()):
            raise AssertionError("(i1) a tenant's cycle did not reach the "
                                 "service: " + json.dumps(counts))
        n_i1 = len(rec.calls)
        cycles = []
        for k in range(1, 1 + steady):
            reqs = [by_tenant[t][k] for t in tenants]
            lanes = [fused_lane_args(r) for r in reqs]
            if any(lane is None for lane in lanes):
                raise AssertionError(f"(i2) cycle {k}: a steady request "
                                     f"takes the batched route")
            keys = {megasolve.lane_key(*lane) for lane in lanes}
            if len(keys) != 1:
                raise AssertionError(
                    f"(i2) cycle {k}: the eight requests do not share one "
                    f"lane key: " + json.dumps([
                        {"shapes": [s for s, _ in key[0]],
                         "statics": [list(map(str, kv)) for kv in key[1]]}
                        for key in keys]))
            m0 = metrics.mega_dispatches_total()
            c0 = len(rec.calls)
            resps = svc.solve_many([(t, "normal", r)
                                    for t, r in zip(tenants, reqs)])
            if len(rec.calls) != c0 + 1 or \
                    metrics.mega_dispatches_total() != m0 + 1:
                raise AssertionError(f"(i2) cycle {k}: solve_many made "
                                     f"{len(rec.calls) - c0} launches")
            cycles.append((reqs, resps, rec.calls[-1]))
        launches = {n: _build.launch_count(n) for n in names}
    torch.cuda.synchronize()
    if metrics.engine_demotions_total() != dem0:
        raise AssertionError("(i1) a tenant cycle fell back in-process")
    cold_batched = sum(decode_snapshot(by_tenant[t][0]).use_batched
                       for t in tenants)
    if config == 5 and cold_batched != n_tenants:
        raise AssertionError("(i1) a cfg5 cold request did not take the "
                             "batched route")
    if launches["batched_allocate"] < cold_batched or \
            launches["mega_fused"] < steady:
        raise AssertionError(f"(i) launches {launches}: expected a batched "
                             f"launch per batched-sized cold cycle "
                             f"({cold_batched}) and a mega launch per steady "
                             f"cycle")
    tc = metrics.tenant_counters()
    solves = {t: tc[t].get("solves", 0) - tc0.get(t, {}).get("solves", 0)
              for t in tenants}
    if any(v != 1 + 2 * steady for v in solves.values()):
        raise AssertionError(f"(i) per-tenant solves {solves}")
    log(f"(i1) {n_tenants} tenants x (cold + {steady} churn-{churn}) "
        f"through one service in {i1_wall:.1f} s (per tenant "
        + ", ".join(f"{walls[i]:.1f}" for i in range(n_tenants))
        + f" s); launches {json.dumps(i1_launches)}; opportunistic mega "
        f"dispatches {i1_mega[0]} with {i1_mega[1]} lanes "
        f"({n_i1} recorded); engines ok, no fallback")
    # dedicated in-process runs of two tenants on the card
    for i in range(2):
        want = sim_tenants.drive_tenant_cycles(
            *sim_tenants._tenant_cluster(i, config, dev), 1 + steady,
            mode="auto", churn=churn)
        if want != states[i]:
            bad = [k for k in want if want[k] != states[i].get(k)]
            raise AssertionError(f"(i1) tenant {i}: {len(bad)} tasks differ "
                                 f"from the dedicated run, e.g. {bad[:3]}")
    log("(i1) tenants 0 and 1 end states == dedicated in-process auto runs "
        "on the card")
    for c in clusters:
        c[1].stop()
    del clusters
    # one more tenant alone: where a service cycle's host time goes
    sim, cache, binder = sim_tenants._tenant_cluster(n_tenants, config, dev)
    breakdown = {"cold": service_cycle(sim, cache, binder, svc, 0),
                 "steady": service_cycle(sim, cache, binder, svc, churn)}
    cache.stop()
    del sim, cache, binder
    log("(i1) one tenant alone through the service, host ms per part "
        "(open, encode = build_snapshot, wire = the request's and the "
        "answer's bytes both ways, solve = svc.solve: admission, decode, "
        "upload, launch, the counted sync, the answer; replay = "
        "apply_decisions; close): " + json.dumps(breakdown))
    # ---- (i2) checks: plain, singles, solve_snapshot ---------------------
    err = 0.0
    plain_ms = []
    for k, (reqs, resps, (args, statics, out)) in enumerate(cycles, 1):
        b = args[0].shape[0]
        if b != n_tenants:
            raise AssertionError(f"(i2) cycle {k}: {b} lanes")
        t0 = time.perf_counter()
        want = mega_fused_plain(*args, **statics)
        torch.cuda.synchronize()
        plain_ms.append((time.perf_counter() - t0) * 1e3)
        err = max(err, max_abs_err(want, out))
        assert_bitwise(want, out, f"mega_fused cycle {k}")
        for i in range(b):
            single = fused_allocate(*(a[i] for a in args), **statics)
            assert_bitwise(single, [o[i] for o in out],
                           f"mega_fused cycle {k} lane {i}")
        for t, req, resp in zip(tenants, reqs, resps):
            if decisions(solve_snapshot(req, device=dev)) != \
                    decisions(resp):
                raise AssertionError(f"(i2) cycle {k} {t}: solve_many's "
                                     f"decisions differ from solve_snapshot")
        placed = int(((out[0][:, 0, :-21] >= 1)
                      & (out[0][:, 0, :-21] <= 3)).sum())
        log(f"(i2) cycle {k}: one {b}-lane mega_fused launch (T_pad "
            f"{args[8].shape[1]}, N_pad {args[0].shape[1]}, {placed} "
            f"placed) bitwise equal to mega_fused_plain "
            f"({plain_ms[-1]:.0f} ms on the card) and to {b} single "
            f"fused_allocate launches; decisions == solve_snapshot's")
    # the opportunistic (i1) launches: plain and single launches too
    i1_lanes = 0
    for k, (args, statics, out) in enumerate(rec.calls[:n_i1], 1):
        want = mega_fused_plain(*args, **statics)
        err = max(err, max_abs_err(want, out))
        assert_bitwise(want, out, f"(i1) mega_fused launch {k}")
        for i in range(args[0].shape[0]):
            single = fused_allocate(*(a[i] for a in args), **statics)
            assert_bitwise(single, [o[i] for o in out],
                           f"(i1) mega_fused launch {k} lane {i}")
        i1_lanes += args[0].shape[0]
    log(f"(i1) the {n_i1} opportunistic mega_fused launches ({i1_lanes} "
        f"lanes) bitwise equal to mega_fused_plain and to single "
        f"fused_allocate launches")
    args, statics, out = cycles[-1][2]
    mb = mega_bounds(args, out)

    def singles():
        for i in range(args[0].shape[0]):
            fused_allocate(*(a[i] for a in args), **statics)

    mega_event_ms = cuda_ms(lambda: mega_fused(*args, **statics), reps=3)
    singles_event_ms = cuda_ms(singles, reps=3)
    mega_prof_ms = profiled_ms(lambda: mega_fused(*args, **statics),
                               "mega_fused_kernel", reps=2)
    mega_launch = launch_phases(dict(fused_mod.last_launch))
    # the largest opportunistic (i1) launch, timed on its own inputs
    timed = [("(i2)", mega_event_ms, mega_launch)]
    i1_event_ms, i1_launch = None, None
    if n_i1:
        i1_args, i1_statics, _ = max(rec.calls[:n_i1],
                                     key=lambda c: c[0][0].shape[0])
        i1_event_ms = cuda_ms(lambda: mega_fused(*i1_args, **i1_statics),
                              reps=3)
        i1_launch = launch_phases(dict(fused_mod.last_launch))
        timed.append(("(i1)", i1_event_ms, i1_launch))
    single_prof_ms = profiled_ms(singles, "fused_allocate_kernel", reps=1)
    mega_ms = mega_prof_ms if mega_prof_ms is not None else mega_event_ms
    # one lane alone: the lane launch (kb_mega_fused, b = 1) against the
    # single launch (kb_fused_allocate) on lane 0, timed single, mega,
    # mega, single
    lane0 = [a[:1] for a in args]
    one = [a[0] for a in args]
    assert_bitwise(fused_allocate(*one, **statics),
                   [o[0] for o in mega_fused(*lane0, **statics)],
                   "mega_fused b=1 vs fused_allocate")
    b1 = {"single": [], "mega": []}
    for kind in ("single", "mega", "mega", "single"):
        fn = ((lambda: fused_allocate(*one, **statics)) if kind == "single"
              else (lambda: mega_fused(*lane0, **statics)))
        b1[kind].append(cuda_ms(fn, reps=5))
    log(f"(i2) lane 0 alone, ms per launch (events, 5 launches each, "
        f"order single, mega, mega, single): fused_allocate "
        f"{b1['single']}, mega_fused b=1 {b1['mega']}; mega / single "
        f"{sum(b1['mega']) / sum(b1['single']):.4f}")
    log(f"(i2) mega_fused {mb['lanes']} lanes: {mega_event_ms:.3f} ms per "
        f"launch (events, 3 launches), {mega_prof_ms} ms device time "
        f"(profiler); the {mb['lanes']} single fused_allocate launches back "
        f"to back {singles_event_ms:.3f} ms (events), "
        f"{single_prof_ms} ms each (profiler); speedup "
        f"{singles_event_ms / mega_event_ms:.2f}x; bound "
        f"{mb['bound_ms']:.6f} ms ({mb['bound_by']}: {mb['bytes']} B, "
        f"{mb['n_solves']} node solves over each lane's real nodes "
        f"{mb['n_real']} (N_pad {mb['n_pad']}), {mb['ops']} float32 "
        f"operations); iterations per lane {mb['iters']}")
    for what, ms, launch in timed:
        log(f"{what} {launch['lanes']} lanes: {ms:.4f} ms per launch "
            f"(events, 3 launches); "
            f"clusters of {launch['cluster']} CTAs, "
            f"{launch['resident_clusters']} resident, {launch['waves']} "
            f"wave(s); in shared memory {json.dumps(launch['shared'])}; "
            f"lane 0's phases (device ms) "
            + json.dumps({k: round(v, 4) for k, v in
                          (launch.get("phase_ms") or {}).items()})
            + f", counts {json.dumps(launch.get('counts'))}")
    # ---- (i3) an affinity single: a 3p tenant's cold request -------------
    b0 = _build.launch_count("batched_allocate")
    n0 = len(svc.calls)
    got = sim_tenants.drive_tenant_cycles(
        *sim_tenants._tenant_cluster(0, aff_config, dev), 1, mode="rpc",
        svc=svc, tenant="aff")
    engine = allocate_mod.last_cycle_engine
    req = svc.calls[-1][1]
    w = decode_snapshot(req)
    if len(svc.calls) != n0 + 1 or engine != "rpc" or \
            len(req.affinity) != 13 or w.affinity is None or \
            _build.launch_count("batched_allocate") != b0 + 1:
        raise AssertionError(f"(i3) the 3p request did not take the "
                             f"service's affinity single (engine {engine})")
    want = sim_tenants.drive_tenant_cycles(
        *sim_tenants._tenant_cluster(0, aff_config, dev), 1, mode="batched")
    if want != got:
        raise AssertionError("(i3) 3p through the service differs from the "
                             "in-process batched cycle")
    bound3 = sum(1 for st, node in got.values() if node)
    log(f"(i3) 3p cold through the service: {w.t} pending, affinity payload "
        f"of {len(req.affinity)} tensors ({w.affinity.n_pairs} pairs), one "
        f"batched_allocate launch, {bound3} tasks on nodes == the in-process "
        f"batched cycle")
    # ---- (i4) saturation on the eight steady requests --------------------
    sat_launch0 = {n: _build.launch_count(n) for n in names}
    sat_mega0 = (metrics.mega_dispatches_total(), metrics.mega_lanes_total())
    sat = sim_tenants.run_saturation(
        duration_s=saturation_s, svc=TenantSolveService(device=dev),
        requests=cycles[-1][0], device=dev)
    sat_launches = {n: _build.launch_count(n) - sat_launch0[n]
                    for n in names}
    sat_mega = (metrics.mega_dispatches_total() - sat_mega0[0],
                metrics.mega_lanes_total() - sat_mega0[1])
    if sat.overload_errors:
        raise AssertionError(f"(i4) {sat.overload_errors} errors under "
                             f"overload")
    sat_d = dataclasses.asdict(sat)
    sat_d.update(launches=sat_launches, mega_dispatches=sat_mega[0],
                 mega_lanes=sat_mega[1], shed_level_after=faults.SHED.level)
    log("(i4) saturation (the last steady cycle's requests, batch lane, "
        "warm-up, closed loop, then open loop at 2x with each latency "
        "from its scheduled send): " + json.dumps(sat_d))
    # the ladder stays escalated for its cooldown: (i5) sends on the
    # normal lane, which reject-lowest would answer from the mirror
    faults.SHED.reset()
    # ---- (i5) the reference's own tenant check ---------------------------
    rep = sim_tenants.run_multi_tenant(n_tenants=4, cycles=2, device=dev)
    if not rep.bit_identical:
        raise AssertionError(f"(i5) {rep.mismatched} {rep.rpc_errors}")
    log(f"(i5) run_multi_tenant 4 x 2 on \"t\": bit-identical to dedicated "
        f"runs; solves {json.dumps(rep.solves_by_tenant)}; mega "
        f"dispatches {rep.mega_dispatches}, lanes {rep.mega_lanes}")
    snap = metrics.counters_snapshot(include_rpc=False)
    log(f"(i) counters: mega_dispatches_total "
        f"{snap['mega_dispatches_total']}, mega_lanes_total "
        f"{snap['mega_lanes_total']}, shed_level {snap['shed_level']}, "
        f"load_shed_total {json.dumps(snap['load_shed_total'])}; tenants "
        + json.dumps(snap.get("tenants", {})))
    log(f"(i) done in {time.perf_counter() - t_phase:.1f} s")
    return {
        "name": "mega_fused", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/mega_fused.cu",
        "replaces": "kubebatch_tpu/tenantsvc/megasolve.py:56",
        "launches": launches["mega_fused"], "max_abs_err": err,
        "ms": mega_ms, "event_ms_3_reps": mega_event_ms,
        "profiler_ms": mega_prof_ms, "plain_ms": plain_ms[-1],
        "plain_device": "cuda", "bound_ms": mb["bound_ms"],
        "bound_by": mb["bound_by"], "library_ms": None,
        "library_call": "none", "lanes": mb["lanes"],
        "lanes_padded": megasolve.lane_bucket(mb["lanes"]),
        "singles_event_ms": singles_event_ms,
        "single_profiler_ms": single_prof_ms,
        "lane0_single_ms": b1["single"], "lane0_mega_ms": b1["mega"],
        "cluster": mega_launch["cluster"],
        "resident_clusters": mega_launch["resident_clusters"],
        "waves": mega_launch["waves"], "shared": mega_launch["shared"],
        "phase_ms": mega_launch.get("phase_ms"),
        "counts": mega_launch.get("counts"),
        "i1_event_ms": i1_event_ms, "i1_launch": i1_launch,
        "n_real": mb["n_real"], "n_pad": mb["n_pad"],
        "phase_launches": launches, "i1_launches": i1_launches,
        "i1_mega_dispatches": i1_mega[0], "i1_mega_lanes": i1_mega[1],
        "i1_wall_s": i1_wall, "service_cycle_ms": breakdown,
        "saturation": sat_d}


class PipeBinder(FreshBinder):
    """FreshBinder that also keeps every bind, in commit order."""

    def __init__(self):
        super().__init__()
        self.events = []

    def bind(self, pod, hostname):
        self.events.append((f"{pod.namespace}/{pod.name}", hostname))
        super().bind(pod, hostname)


class SyncWatch:
    """Every synchronizing CUDA call torch reports under
    ``torch.cuda.set_sync_debug_mode("warn")``, with the innermost frame
    of this repository that made it and whether a pipelined solve was in
    flight then (``in_window``: from the in-place launch to its consume,
    set by InplaceRecorder)."""

    def __init__(self):
        self.in_window = False
        self.events = []

    def __enter__(self):
        import warnings

        import torch

        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        # the mode switch's own report is not the loop's
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode("warn")
        warnings.simplefilter("always")
        self._show = warnings.showwarning
        warnings.showwarning = self.show
        return self

    def show(self, message, category, filename, lineno, file=None,
             line=None):
        import traceback

        if "synchroniz" not in str(message):
            self._show(message, category, filename, lineno, file, line)
            return
        site = f"{os.path.relpath(filename, HERE)}:{lineno}"
        for fr in reversed(traceback.extract_stack()[:-1]):
            rel = os.path.relpath(fr.filename, HERE)
            if not rel.startswith(".."):
                site = f"{rel}:{fr.lineno} ({fr.name})"
                break
        self.events.append({"in_window": self.in_window, "site": site,
                            "message": str(message).strip()[:100]})

    def __exit__(self, *exc):
        import warnings

        import torch

        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = self._show
        self._cm.__exit__(*exc)

    def report(self) -> dict:
        out = {}
        for e in self.events:
            key = ("in flight: " if e["in_window"] else "") + e["site"]
            out[key] = out.get(key, 0) + 1
        return out


class InplaceRecorder:
    """Records each in-place active-set launch (kernels/activeset.py
    ``activeset_packed_inplace``) to hold it against the plain version
    later: its inputs cloned on the card when ``prepare_activeset`` made
    them (before the launch and its CUDA events: the kernel writes the
    carry it is given), its packed result, and its carry cloned when
    ``PendingSolve.consume`` starts (nothing writes the carry between
    the launch and the consume). The pre-dispatch carry so cloned is
    what ``PendingSolve.restore_carry`` must give back, checked at each
    restore. ``host_ms`` sums the recorder's own host time, which the
    pipelined cycles' walls include. Marks the SyncWatch window: open
    at the launch, closed at its consume."""

    def __init__(self, watch=None):
        self.watch = watch
        self.calls = []
        self.restores = []
        self.host_ms = 0.0
        self._prepared = None

    def __enter__(self):
        import torch

        from kubebatch_tpu_torch.kernels import activeset, hier

        self.mod = activeset
        self.inner = {n: getattr(activeset, n) for n in (
            "prepare_activeset", "activeset_packed_inplace")}
        self.inner_consume = activeset.PendingSolve.consume
        self.inner_restore = activeset.PendingSolve.restore_carry

        def prepare(*args, **kw):
            plan = self.inner["prepare_activeset"](*args, **kw)
            t0 = time.perf_counter()
            self._prepared = None if plan is None else {
                k: v.clone() for k, v in plan[0].items()}
            self.host_ms += (time.perf_counter() - t0) * 1e3
            return plan

        def launch(*args, **kw):
            if self.watch is not None:
                self.watch.in_window = True
            out = self.inner["activeset_packed_inplace"](*args, **kw)
            kin = {**kw, **{k: v for k, v in self._prepared.items()
                            if k in kw}}
            self.calls.append({"kind": "activeset", "args": args,
                               "kw": kin, "out": list(out),
                               "counters": hier.last_launch.get(
                                   "counters"),
                               "route": hier.last_launch.get("route"),
                               "cluster": hier.last_launch.get("cluster")})
            return out

        def consume(pend, *args, **kw):
            if self.watch is not None:
                self.watch.in_window = False
            t0 = time.perf_counter()
            call = self.calls[-1]
            call["out"] = call["out"][:1] + [o.clone()
                                              for o in call["out"][1:]]
            self.host_ms += (time.perf_counter() - t0) * 1e3
            return self.inner_consume(pend, *args, **kw)

        def restore_carry(pend):
            self.inner_restore(pend)
            d, kw = pend.device, self.calls[-1]["kw"]
            self.restores.append(all(
                torch.equal(a.view(torch.uint8), kw[k].view(torch.uint8))
                for a, k in zip((d.idle, d.releasing, d.n_tasks, d.nz_req),
                                ("idle", "releasing", "n_tasks", "nz_req"))))

        activeset.prepare_activeset = prepare
        activeset.activeset_packed_inplace = launch
        activeset.PendingSolve.consume = consume
        activeset.PendingSolve.restore_carry = restore_carry
        return self

    def __exit__(self, *exc):
        for n, fn in self.inner.items():
            setattr(self.mod, n, fn)
        self.mod.PendingSolve.consume = self.inner_consume
        self.mod.PendingSolve.restore_carry = self.inner_restore


#: the spans phase (j) breaks a cycle's host wall into
CYCLE_SPANS = ("fold", "open", "consume", "tensorize", "activeset_dispatch",
               "activeset_allocate", "readback", "replay", "close")


def span_ms(root) -> dict:
    """Host ms per span name (CYCLE_SPANS) summed over a cycle's tree."""
    out = {}

    def walk(sp):
        if sp.name in CYCLE_SPANS:
            out[sp.name] = out.get(sp.name, 0.0) + sp.dur * 1e3
        for c in sp.children:
            walk(c)
    walk(root)
    return {k: round(v, 3) for k, v in out.items()}


def time_inplace_against_cloning(kw, reps: int = 2) -> dict:
    """Device ms (CUDA events) of one active-set launch on ``kw``, in
    place against cloning, alternated (cloning, in place, in place,
    cloning per rep); the in-place launch's carry is put back before
    each of its launches, so both solve the same problem. Medians."""
    import torch

    from kubebatch_tpu_torch.kernels import activeset

    carry = ("idle", "releasing", "n_tasks", "nz_req")
    saved = {k: kw[k].clone() for k in carry}
    mine = dict(kw, **{k: kw[k].clone() for k in carry})

    def one(inplace):
        if inplace:
            for k in carry:
                mine[k].copy_(saved[k])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if inplace:
            activeset.activeset_packed_inplace(**mine)
        else:
            activeset.activeset_packed(**kw)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    one(False)
    one(True)
    times = {False: [], True: []}
    for _ in range(reps):
        for inplace in (False, True, True, False):
            times[inplace].append(one(inplace))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    return {"inplace_ms": med[True], "cloning_ms": med[False],
            "inplace_all_ms": times[True], "cloning_all_ms": times[False]}


def pipeline_timings(grain_kw, by_grain) -> dict:
    """Phase (j)'s timings: per grain the in-place launch against the
    cloning one (time_inplace_against_cloning), the roofline bound of
    that launch's work (scale_bounds with the kernel's counters) and,
    where the grain ran on the main path, the plain version's ms."""
    import torch

    from kubebatch_tpu_torch.kernels import activeset
    from kubebatch_tpu_torch.kernels import hier as hier_mod

    timing = {}
    for g in sorted(grain_kw):
        kw = grain_kw[g]
        tm = time_inplace_against_cloning(kw)
        out = activeset.activeset_packed(**kw)
        torch.cuda.synchronize()
        counters = dict(zip(hier_mod.COUNTERS,
                            hier_mod.last_launch["counters"].cpu().tolist()))
        rounds = int(out[0][3 * kw["task_valid"].shape[0]])
        pool = hier_mod.hier_pool_size(kw["idle"].shape[0],
                                       kw.get("pool_size", 0))
        b = scale_bounds({k: v for k, v in kw.items() if hasattr(v, "numel")},
                         out, counters, rounds, bool(kw["pipe_enabled"]),
                         pool)
        tm.update(bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                  bytes=b["bytes"], ops=b["ops"], rounds=rounds,
                  main_path=g in by_grain)
        if g in by_grain:
            tm["plain_ms"] = by_grain[g][1]["plain_ms"]
        timing[g] = tm
        log(f"(j) grain {g}: in place {tm['inplace_ms']:.3f} ms, cloning "
            f"{tm['cloning_ms']:.3f} ms (CUDA events, medians of "
            f"{len(tm['inplace_all_ms'])}: {tm['inplace_all_ms']} / "
            f"{tm['cloning_all_ms']}); bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}: {b['bytes']} B, {b['ops']} operations); "
            f"{rounds} rounds"
            + ("" if g in by_grain else "; grain forced on a churn "
               "cycle's inputs (off the main path)"))
    return timing


def pipeline_phase(dev, spec6, churns=(256,) * 8 + (1024,) * 2) -> dict:
    """Phase (j): pipelined cycles at cfg6, uncut, allocate-only, in auto.
    A sequential ``Scheduler`` runs first on its own incremental cache:
    the cold cycle (50,000 pending: the active set declines, the
    two-level solve runs) and one churn cycle per ``churns`` entry
    (kubelet tick, then that many pods recycled into queue 0 / 3). Then
    ``Scheduler(pipeline=True)`` on a second cache fed the same events:
    the cold cycle runs sequentially, each churn cycle dispatches the
    active-set solve in place (csrc/hier_allocate.cu, active-set mode,
    on the DeviceSession's own carry) and returns, and the next cycle
    consumes it through one deferred readback; a drain ends it. The
    binds and statuses of the two caches must be equal, each dispatch
    one in-place launch and one deferred readback with no blocking one,
    and the window from each launch to its consume runs under
    ``torch.cuda.set_sync_debug_mode("warn")``: every synchronizing call
    is reported with its site. On the pipelined cache then: a node the
    in-flight decisions bind to changes capacity (the consume must
    invalidate, swap the pre-dispatch carry back bit for bit, and
    re-solve the cycle sequentially, nothing bound twice), and a
    ``pipeline.conflict`` seam storm demotes the executor, the cycles
    after it binding sequentially. Every in-place launch is held bitwise
    against ``activeset_allocate_plain`` on CPU copies, and timed at the
    three grains against the cloning launch. The active set's audit is
    off here (phase (g) covers it). Returns the kernels line's entry."""
    import gc

    import torch

    from kubebatch_tpu_torch import faults, metrics, obs
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.actions import allocate_batched
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import CONFIG_ACTIONS, SHIPPED_CONF
    from kubebatch_tpu_torch.kernels import _build, activeset
    from kubebatch_tpu_torch.kernels import hier as hier_mod
    from kubebatch_tpu_torch.objects import PODS
    from kubebatch_tpu_torch.runtime import Scheduler
    from kubebatch_tpu_torch.runtime import pipeline as pipeline_mod
    from kubebatch_tpu_torch.sim import build_cluster

    t_phase = time.perf_counter()
    conf = SHIPPED_CONF.replace(
        SHIPPED_CONF.strip().splitlines()[0],
        'actions: "' + ", ".join(CONFIG_ACTIONS[6]) + '"')
    activeset.reset()
    pipeline_mod.reset()
    faults.disarm()

    def side(pipe):
        t0 = time.perf_counter()
        sim = build_cluster(spec6)
        binder = PipeBinder()
        cache = SchedulerCache(binder=binder, async_writeback=False,
                               device=dev)
        sim.populate(cache)
        sched = Scheduler(cache, scheduler_conf=conf, pipeline=pipe,
                          solve_audit_every=0)
        log(f"(j) cfg6 {'pipelined' if pipe else 'sequential'}: "
            f"{len(sim.nodes)} nodes, {len(sim.pods)} pods built and "
            f"populated in {time.perf_counter() - t0:.1f} s")
        return sim, cache, binder, sched

    def cycle(sched, label, want_engine):
        """One guarded cycle: its host wall ms and span_ms breakdown."""
        t0 = time.perf_counter()
        if not sched.run_cycle():
            raise AssertionError(f"(j) {label}: the cycle failed "
                                 f"({sched.last_cycle_failure})")
        wall = (time.perf_counter() - t0) * 1e3
        if allocate_mod.last_cycle_engine != want_engine:
            raise AssertionError(f"(j) {label}: engine "
                                 f"{allocate_mod.last_cycle_engine}, "
                                 f"expected {want_engine}")
        return wall, span_ms(obs.last_cycle())

    def churn(sim, cache, binder, k, n):
        binder.kubelet_tick(cache)
        if sim.churn_tick(cache, n, arrival_queue=(0, 3)[k % 2]) != n:
            raise AssertionError(f"(j) churn did not recycle {n} pods")

    def statuses(cache):
        return {t.key: (t.status.name, t.node_name)
                for j in cache.jobs.values() for t in j.tasks.values()}

    # ---- (j1) the sequential twin ----------------------------------------
    sim_s, cache_s, binder_s, sched_s = side(False)
    seq_cold, _ = cycle(sched_s, "sequential cold", "hier")
    gc.collect()
    if binder_s.count != len(sim_s.pods):
        raise AssertionError(f"(j) sequential cold bound {binder_s.count} "
                             f"of {len(sim_s.pods)}")
    seq = []
    for k, n in enumerate(churns):
        churn(sim_s, cache_s, binder_s, k, n)
        rb0 = metrics.blocking_readbacks()
        wall, spans = cycle(sched_s, f"sequential churn {k}", "activeset")
        ph = dict(allocate_batched.last_phases)
        seq.append({"n": n, "wall_ms": wall, "kernel_ms": ph["kernel"],
                    "sync_ms": ph["sync"], "spans": spans,
                    "syncs": metrics.blocking_readbacks() - rb0})
    # the last cycle's binds go Running too: the pipelined loop binds
    # a cycle later, so both compare after a final kubelet tick
    binder_s.kubelet_tick(cache_s)
    seq_statuses = statuses(cache_s)
    seq_binds = sorted(binder_s.events)
    cache_s.stop()
    del sim_s, cache_s, binder_s, sched_s
    # the twin's object graph is collected here, not inside a timed cycle
    gc.collect()

    # ---- (j2) the pipelined loop fed the same events ---------------------
    sim, cache, binder, sched = side(True)
    pipe_cold, _ = cycle(sched, "pipelined cold", "hier")
    gc.collect()
    if sched._pipeline.pending is not None:
        raise AssertionError("(j) the cold cycle dispatched asynchronously")
    watch = SyncWatch()
    rec = InplaceRecorder(watch)
    counts0 = (metrics.pipeline_cycles_total(), metrics.deferred_readbacks(),
               metrics.blocking_readbacks(),
               metrics.pipeline_conflicts_total())
    pipe = []
    with rec:
        _build.reset_launch_counts()
        with watch:
            for k, n in enumerate(churns):
                churn(sim, cache, binder, k, n)
                rec_ms = rec.host_ms
                wall, spans = cycle(sched, f"pipelined churn {k}",
                                    "activeset")
                if sched._pipeline.pending is None:
                    raise AssertionError(f"(j) pipelined churn {k} did not "
                                         f"dispatch")
                row = {"n": n, "wall_ms": wall, "spans": spans,
                       "recorder_ms": rec.host_ms - rec_ms,
                       "dispatch": dict(sched._pipeline.dispatch_phases)}
                if k:
                    pipe[-1]["consume"] = dict(
                        sched._pipeline.consume_phases)
                pipe.append(row)
            t0 = time.perf_counter()
            sched._pipeline.drain()
            drain_ms = (time.perf_counter() - t0) * 1e3
        pipe[-1]["consume"] = dict(sched._pipeline.consume_phases)
        binder.kubelet_tick(cache)
        launches = _build.launch_count("activeset_allocate_inplace")
        others = {n: _build.launch_count(n) for n in
                  ("activeset_allocate", "hier_allocate")}
        counts = [b - a for a, b in zip(counts0, (
            metrics.pipeline_cycles_total(), metrics.deferred_readbacks(),
            metrics.blocking_readbacks(),
            metrics.pipeline_conflicts_total()))]
        n_main = len(rec.calls)
        if sched._pipeline.pending is not None:
            raise AssertionError("(j) the drain left a solve in flight")
        if counts != [len(churns), len(churns), 0, 0] \
                or launches != len(churns) or n_main != len(churns) \
                or any(others.values()):
            raise AssertionError(
                f"(j) pipelined loop: pipeline cycles, deferred readbacks, "
                f"blocking readbacks, conflicts {counts}; in-place "
                f"launches {launches}, recorded {n_main}, other launches "
                f"{others}; expected one dispatch, one in-place launch and "
                f"one deferred readback a churn cycle, no blocking one")
        binds_equal = sorted(binder.events) == seq_binds
        if not binds_equal or statuses(cache) != seq_statuses:
            raise AssertionError("(j) the pipelined cache's binds or "
                                 "statuses differ from the sequential "
                                 "twin's")
        if len(binder.events) != len({p for p, _ in binder.events}):
            raise AssertionError("(j) a pod was bound twice")
        log(f"(j) pipelined loop: {len(churns)} churn cycles, each one "
            f"in-place launch ({launches}) and one deferred readback "
            f"({counts[1]}), blocking readbacks {counts[2]}, conflicts "
            f"{counts[3]}; binds ({len(binder.events)}) and statuses equal "
            f"to the sequential twin's")
        report = watch.report()
        in_flight = sum(1 for e in watch.events if e["in_window"])
        log(f"(j) sync-debug report (set_sync_debug_mode('warn')): "
            f"{len(watch.events)} synchronizing calls on the pipelined "
            f"loop, {in_flight} of them while a solve was in flight: "
            + json.dumps(report))

        # ---- (j3) a capacity change mid-flight ----------------------------
        c0 = metrics.pipeline_conflicts_by_outcome()
        churn(sim, cache, binder, 0, churns[0])
        cycle(sched, "conflict dispatch", "activeset")
        torch.cuda.synchronize()
        call = rec.calls[-1]
        t = call["kw"]["task_valid"].shape[0]
        packed = call["out"][0].cpu().numpy()
        placed = [int(packed[t + i]) for i in range(t)
                  if packed[i] in (1, 2, 3)]
        names = sched._pipeline.pending.inputs.device.state.names
        victim = cache.nodes[names[placed[0]]].node
        alloc = dict(victim.allocatable)
        alloc[PODS] = alloc.get(PODS, 0) + 1
        cache.update_node(victim, dataclasses.replace(
            victim, allocatable=alloc, capacity=dict(alloc)))
        binder.kubelet_tick(cache)
        n_bind = len(binder.events)
        cycle(sched, "conflict consume", "activeset")
        c1 = metrics.pipeline_conflicts_by_outcome()
        conflict = {k: v - c0.get(k, 0) for k, v in c1.items()
                    if v - c0.get(k, 0)}
        if conflict != {"conflict": 1} or rec.restores != [True]:
            raise AssertionError(f"(j) capacity change mid-flight: "
                                 f"conflicts {conflict}, carry restored "
                                 f"bit for bit {rec.restores}")
        if len(binder.events) - n_bind != churns[0] or len(
                binder.events) != len({p for p, _ in binder.events}):
            raise AssertionError("(j) the re-solve did not bind the churn "
                                 "once")
        log(f"(j) capacity change on {victim.name} mid-flight: consume "
            f"invalidated (conflicts {conflict}), the carry swapped back "
            f"bit for bit, the cycle re-solved sequentially "
            f"({len(binder.events) - n_bind} binds), no pod bound twice")

        # ---- (j4) a seam storm --------------------------------------------
        # a dispatch and a clean consume first, so the storm starts from
        # a streak of 0
        for k in range(2):
            churn(sim, cache, binder, k, churns[0])
            cycle(sched, f"before the storm {k}", "activeset")
        d0 = metrics.pipeline_demotions_total()
        storm = []
        faults.arm(faults.FaultPlan(counts={
            "pipeline.conflict": pipeline_mod.CONFLICT_STORM_LIMIT}))
        try:
            for k in range(4 * pipeline_mod.CONFLICT_STORM_LIMIT):
                if pipeline_mod.demoted():
                    break
                churn(sim, cache, binder, k, churns[0])
                cycle(sched, f"storm {k}", "activeset")
                storm.append(sched._pipeline.pending is not None)
        finally:
            faults.disarm()
        if not pipeline_mod.demoted() \
                or metrics.pipeline_demotions_total() - d0 != 1:
            raise AssertionError("(j) the seam storm did not demote the "
                                 "executor")
        n_bind = len(binder.events)
        rb0 = metrics.blocking_readbacks()
        for k in range(2):
            churn(sim, cache, binder, k, churns[0])
            cycle(sched, f"after the storm {k}", "activeset")
        if len(binder.events) - n_bind != 2 * churns[0] \
                or metrics.blocking_readbacks() - rb0 != 2:
            raise AssertionError("(j) the demoted loop did not bind "
                                 "sequentially")
        log(f"(j) seam storm: {len(storm)} cycles to demotion (dispatched "
            f"{storm}), pipeline_demotions_total +1; two more cycles ran "
            f"sequentially (one blocking readback each, "
            f"{2 * churns[0]} binds)")
    bad_gangs = gang_all_or_nothing(cache)
    over = capacity_violations(sim)
    if bad_gangs or over or not all(rec.restores) or len(
            binder.events) != len({p for p, _ in binder.events}):
        raise AssertionError(f"(j) gangs broken {bad_gangs}, nodes over "
                             f"capacity {over}, carries restored bit for "
                             f"bit {rec.restores}")
    pipeline_mod.reset()
    activeset.reset()
    activeset.set_audit_every(activeset.DEFAULT_AUDIT_EVERY)

    # ---- every in-place launch against the plain version ----------------
    checks = []
    for call in rec.calls:
        chk = check_scale_call(call)
        # a CPU launch (the plain version) keeps no work counters
        counters = (dict(zip(hier_mod.COUNTERS,
                             call["counters"].cpu().tolist()))
                    if call["counters"] is not None else None)
        plain_counts = {k: chk["stats"].get(k, 0) for k in hier_mod.COUNTERS}
        if counters is not None and plain_counts != counters:
            raise AssertionError(f"(j) in-place launch: work counters "
                                 f"{counters} differ from the plain "
                                 f"version's {plain_counts}")
        t = call["kw"]["task_valid"].shape[0]
        checks.append({"t_pad": t, "plain_ms": chk["plain_ms"],
                       "err": chk["err"], "counters": counters,
                       "rounds": int(call["out"][0][3 * t]),
                       "launch_route": call["route"],
                       "cluster_ctas": call["cluster"]})
    log(f"(j) {len(rec.calls)} in-place launches bitwise equal to "
        f"activeset_allocate_plain on CPU copies (packed result, frame, "
        f"carry) and their work counters to the plain version's; grains "
        + ", ".join(f"{c['t_pad']} ({c['launch_route']})" for c in checks))

    # ---- timings: in place against cloning at each grain ----------------
    by_grain = {}
    for call, chk in zip(rec.calls, checks):
        by_grain.setdefault(chk["t_pad"], (call, chk))
    last_inputs = None
    grain_kw = {g: dict(c["kw"]) for g, (c, _) in by_grain.items()}
    for g in activeset.ACT_GRAINS:
        if g not in grain_kw:
            if last_inputs is None:
                # a churn cycle's inputs, forced to the missing grain
                churn(sim, cache, binder, 0, churns[-1])
                from kubebatch_tpu_torch.actions.cycle_inputs import \
                    build_cycle_inputs
                from kubebatch_tpu_torch.framework import (CloseSession,
                                                           OpenSession)
                ssn = OpenSession(cache, sched.tiers)
                last_inputs = build_cycle_inputs(ssn)
            args, statics, _ = activeset.prepare_activeset(last_inputs,
                                                           grain=g)
            grain_kw[g] = {**{k: v.clone() for k, v in args.items()},
                           **statics}
    if last_inputs is not None:
        CloseSession(ssn)
    timing = pipeline_timings(grain_kw, by_grain)
    cache.stop()

    # ---- the per-cycle report -------------------------------------------
    rows = []
    for k, (s, p) in enumerate(zip(seq, pipe)):
        c = p.get("consume", {})
        rows.append({"n": s["n"], "seq_wall_ms": s["wall_ms"],
                     "pipe_wall_ms": p["wall_ms"],
                     "pipe_recorder_ms": p["recorder_ms"],
                     "seq_spans": s["spans"], "pipe_spans": p["spans"],
                     "seq_kernel_ms": s["kernel_ms"],
                     "seq_sync_ms": s["sync_ms"],
                     "consume_wait_ms": c.get("wait"),
                     "kernel_ms": c.get("kernel"),
                     "copy_ms": c.get("copy"),
                     "launch_ms": p["dispatch"].get("launch"),
                     "replay_ms": c.get("replay")})
        log(f"(j) churn {k} ({s['n']} pods): host wall pipelined "
            f"{p['wall_ms']:.1f} ms ({p['recorder_ms']:.1f} of it this "
            f"script's recorder) against sequential {s['wall_ms']:.1f} "
            f"(its kernel {s['kernel_ms']:.3f}, sync {s['sync_ms']:.3f}); "
            f"consumed in the next cycle: wait {c.get('wait', 0):.3f} ms, "
            f"kernel {c.get('kernel', float('nan')):.3f} ms, deferred "
            f"copy {c.get('copy', float('nan')):.4f} ms (events), replay "
            f"{c.get('replay', 0):.1f} ms; launch "
            f"{p['dispatch'].get('launch', 0):.3f} ms host; spans ms "
            f"pipelined {json.dumps(p['spans'])}, sequential "
            f"{json.dumps(s['spans'])}")
    log(f"(j) cold cycles {seq_cold:.1f} (sequential) / {pipe_cold:.1f} "
        f"(pipelined) ms; drain {drain_ms:.1f} ms; phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    med = lambda xs: sorted(xs)[len(xs) // 2]  # noqa: E731
    steady = [r for r in rows if r["n"] == churns[0]]
    t256 = timing[min(timing)]
    return {
        "name": "activeset_allocate_inplace", "route": "cuda",
        "source": "kubebatch_tpu_torch/kernels/csrc/hier_allocate.cu",
        "replaces": "kubebatch_tpu/kernels/activeset.py:463",
        "launches": launches, "max_abs_err": max(c["err"] for c in checks),
        "ms": t256["inplace_ms"], "cloning_ms": t256["cloning_ms"],
        "plain_ms": by_grain[min(by_grain)][1]["plain_ms"],
        "plain_device": "cpu", "bound_ms": t256["bound_ms"],
        "bound_by": t256["bound_by"], "library_ms": None,
        "library_call": "none",
        "per_grain": {str(g): v for g, v in timing.items()},
        "cycles": rows,
        "median_steady": {
            "seq_wall_ms": med([r["seq_wall_ms"] for r in steady]),
            "pipe_wall_ms": med([r["pipe_wall_ms"] for r in steady]),
            "pipe_wall_less_recorder_ms": med([
                r["pipe_wall_ms"] - r["pipe_recorder_ms"] for r in steady]),
            "consume_wait_ms": med([r["consume_wait_ms"] for r in steady]),
            "kernel_ms": med([r["kernel_ms"] for r in steady])},
        "syncs": report, "syncs_in_flight": in_flight,
        "checked_launches": len(checks),
        "launch_routes": sorted({
            f"{c['launch_route']}" + (f" ({c['cluster_ctas']} CTAs)"
                                         if c["cluster_ctas"] else "")
            for c in checks})}


def sharded_bounds(node, rep, packed, carry, stats, pipe: bool,
                   world: int) -> dict:
    """Rank 0's roofline in the sharded solve, beside rank 0's kernel ms:
    its node block's inputs, the replicated inputs, the packed result
    and its block of the carry, each moved once, over the memory rate,
    against the row-pass and pair-score cells over the block's real
    nodes (``node_ok``, not the padded bucket) for the task rows and
    rounds the one-card plain engine counted on the same inputs, over
    the float32 rate (the same cells as ``batched_bounds``)."""
    import numpy as np

    n_sh = node["idle"].shape[0]
    nb = n_sh // world
    block = {k: (v[:, :nb] if k in ("sig_scores", "sig_pred") else v[:nb])
             for k, v in node.items()}
    n_real = int(np.asarray(block["node_ok"]).sum())
    p_pad = rep["pair_sig"].shape[0]
    nbytes = sum(a.nbytes for a in block.values()) + sum(
        a.nbytes for a in rep.values())
    nbytes += packed.numel() * 4 + carry[:nb].numel() * 4
    per_cell = OPS_PER_CELL_BATCHED + (OPS_PER_CELL_PIPE if pipe else 0)
    ops = (stats["rows"] * n_real * per_cell
           + stats["rounds"] * p_pad * n_real * OPS_PER_PAIR_CELL)
    b_ms, b_by = bound(nbytes, ops)
    return {"bytes": nbytes, "ops": ops, "rows": stats["rows"],
            "block": nb, "block_real_nodes": n_real,
            "rounds_run": stats["rounds"], "bound_ms": b_ms, "bound_by": b_by}


def sharded_scan_bounds(args, out, world: int) -> dict:
    """Rank 0's roofline over the whole scan, beside rank 0's kernel ms
    over all its launches: its block of the node inputs and of the
    [T, N] rows, the replicated task inputs and its share of the
    outputs, each moved once, over the memory rate, against
    OPS_PER_NODE_SCAN per real node (``node_ok``) of its block per task
    step, over the float32 rate. And one launch's (``launch_*``, beside
    the lock-step ms a launch): a step that applies a winner and packs
    the next rows reads the gathered [world x block, 5] rows, the block's
    carry and static rows (SCAN_READ_BYTES_PER_NODE) and its column of
    the step's score and predicate rows, and writes the block's packed
    rows, the decision and the winner's carry; its operations are one
    compare a gathered row and OPS_PER_NODE_SCAN a real node of the
    block."""
    import numpy as np

    n = args["node_ok"].shape[0]
    nb = n // world
    t_steps = args["resreq"].shape[0]
    n_real = int(np.asarray(args["node_ok"][:nb]).sum())
    nbytes = 0
    for a in args.values():
        a = np.asarray(a)
        if a.ndim and n in a.shape:
            nbytes += a.nbytes // world
        else:
            nbytes += a.nbytes
    for o in out:
        size = o.numel() * o.element_size()
        nbytes += size // world if o.dim() and o.shape[0] == n else size
    b_ms, b_by = bound(nbytes, t_steps * n_real * OPS_PER_NODE_SCAN)
    launch_bytes = (n * 5 * 4 + nb * (SCAN_STEP_READ_BYTES_PER_NODE
                                      + SCAN_STEP_WRITE_BYTES_PER_NODE)
                    + SCAN_STEP_FIXED_BYTES)
    launch_ops = n + n_real * OPS_PER_NODE_SCAN
    l_ms, l_by = bound(launch_bytes, launch_ops)
    return {"bytes": nbytes, "block": nb, "block_real_nodes": n_real,
            "bound_ms": b_ms, "bound_by": b_by,
            "launch_bytes": launch_bytes, "launch_ops": launch_ops,
            "launch_bound_ms": l_ms, "launch_bound_by": l_by}


def same_frame(got, want) -> bool:
    """Two telemetry frames agree but for the engine id and the narrow
    words (the sharded engine sets those by the per-shard policy)."""
    return got[1:12] == want[1:12] and got[14:] == want[14:]


#: float32 compares and adds per node of one scan step (sharded_scan.cu:
#: idle + bf, three fit tests of three compares each, the score select)
OPS_PER_NODE_SCAN = 13
#: one scan step's bytes a node of the rank's block: read idle, releasing
#: and backfilled (36), max_task_num and n_tasks (8), node_ok (1) and the
#: step's score and predicate (5); write the packed row (20)
SCAN_STEP_READ_BYTES_PER_NODE = 50
SCAN_STEP_WRITE_BYTES_PER_NODE = 20
#: and a step's fixed bytes: the task's request and launch request (24),
#: its validity (1), eps (12), min_available (4), the state read and
#: written (16), the decision and node written (8), the winner's carry
#: read and written (56)
SCAN_STEP_FIXED_BYTES = 121


def scan_args(n: int, t: int, seed: int) -> dict:
    """The sharded scan's inputs (kernels/sharded.py INPUTS) at n nodes
    and t tasks, contended, from a seed."""
    import numpy as np

    rng = np.random.default_rng(seed)
    args = dict(
        idle=rng.uniform(20, 120, (n, 3)).astype(np.float32),
        releasing=np.where(rng.random((n, 1)) < 0.3,
                           rng.uniform(10, 80, (n, 3)), 0).astype(np.float32),
        backfilled=np.where(rng.random((n, 1)) < 0.2,
                            rng.uniform(5, 30, (n, 3)), 0).astype(np.float32),
        max_task_num=rng.integers(1, 4, n).astype(np.int32),
        n_tasks=rng.integers(0, 2, n).astype(np.int32),
        node_ok=rng.random(n) < 0.95,
        resreq=rng.uniform(10, 90, (t, 3)).astype(np.float32),
        task_valid=np.ones(t, bool),
        scores=np.round(rng.normal(size=(t, n)) * 4).astype(np.float32),
        pred_mask=rng.random((t, n)) < 0.7,
        min_available=np.int32(t // 2), init_allocated=np.int32(0))
    args["init_resreq"] = args["resreq"].copy()
    return args


def sharded_phase(dev, spec5, worlds=(2, 4), churn: int = 256,
                  scan_shape=(256, 8192), extra=None) -> list:
    """(k) the node-sharded engines: k ranks of a gloo group on the one
    card (rank 0 here, k - 1 spawned solver workers). For each k, cfg5
    cold through AllocateAction(mode="sharded", mesh=...) (binds and
    statuses equal to the one-card batched solve with compact_bucket=0),
    then the same cold inputs once more with every rank holding each
    launch bitwise against the plain version; at k = 2 Scheduler(mesh=...)
    in auto, cold and two churn cycles (sharded, fused, fused); at k = 4
    the scan at T x N_pad ``scan_shape`` on the mesh, then in lock step
    (checked, then timed unchecked). ``extra(k, mesh)``, when
    given, runs last in each k's group (phase (l) reuses the groups).
    Returns the kernels line's rows 10 and 11."""
    import tempfile

    import numpy as np
    import torch

    from kubebatch_tpu_torch import metrics
    from kubebatch_tpu_torch.actions import allocate as allocate_mod
    from kubebatch_tpu_torch.actions import allocate_batched
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.actions.cycle_inputs import build_cycle_inputs
    from kubebatch_tpu_torch.cache import SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels import batched_sharded as bs
    from kubebatch_tpu_torch.kernels import sharded as sh
    from kubebatch_tpu_torch.kernels.batched import (CYCLE_ARGS, NODE_ARGS,
                                                     arg_dtype,
                                                     batched_allocate_plain)
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.parallel import worker
    from kubebatch_tpu_torch.runtime.scheduler import Scheduler
    from kubebatch_tpu_torch.sim import build_cluster

    t_phase = time.perf_counter()

    def cold_cache():
        sim = build_cluster(spec5)
        binder = RecordingBinder()
        cache = SchedulerCache(device=dev, binder=binder,
                               async_writeback=False,
                               incremental_snapshot=False)
        sim.populate(cache)
        return sim, cache, binder

    def statuses(cache):
        return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
                for j in cache.jobs.values() for t in j.tasks.values()}

    # the one-card twin: the batched kernel with compact_bucket=0
    _, cache0, binder0 = cold_cache()
    inner = allocate_batched.solve_batched

    def no_compact(inputs, **kw):
        kw["compact_bucket"] = 0
        return inner(inputs, **kw)

    allocate_batched.solve_batched = no_compact
    try:
        ssn = OpenSession(cache0, shipped_tiers())
        AllocateAction(mode="batched").execute(ssn)
        CloseSession(ssn)
    finally:
        allocate_batched.solve_batched = inner
    twin_kernel_ms = allocate_batched.last_phases["kernel"]
    want_status, want_binds = statuses(cache0), list(binder0.calls)
    want_telem = allocate_batched.last_solve["telemetry"]
    cache0.stop()
    log(f"(k) twin: cfg5 cold batched, compact_bucket=0: "
        f"{len(want_binds)} binds, kernel {twin_kernel_ms:.3f} ms (events)")

    runs, scan = {}, None
    store_dir = tempfile.mkdtemp(prefix="kb_mesh_")
    for k in worlds:
        t0 = time.perf_counter()
        group = worker.launch(k, os.path.join(store_dir, f"store{k}"),
                              device=str(dev), timeout=300)
        with group:
            mesh = group.mesh
            spawn_s = time.perf_counter() - t0
            facts = worker.request_status(mesh)
            if any(f["jax"] or f["kubebatch_tpu"] for f in facts):
                raise AssertionError(f"(k) a rank imported the reference "
                                     f"side: {facts}")
            staged = dict(mesh.staged)
            # the main path: cfg5 cold through the sharded mode
            _, cache, binder = cold_cache()
            _build.reset_launch_counts()
            rb0 = metrics.blocking_readbacks()
            dem0 = metrics.engine_demotions_total()
            t0 = time.perf_counter()
            ssn = OpenSession(cache, shipped_tiers())
            AllocateAction(mode="sharded", mesh=mesh).execute(ssn)
            CloseSession(ssn)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches0 = _build.launch_count("sharded_round")
            batched_launches = _build.launch_count("batched_allocate")
            engine = allocate_mod.last_cycle_engine
            ranks = bs.last_solve["ranks"]
            solve_ms = bs.last_solve["wall_ms"]
            readbacks = metrics.blocking_readbacks() - rb0
            if engine != "sharded" or batched_launches or (
                    dev.type == "cuda" and not launches0):
                raise AssertionError(f"(k) k={k}: engine {engine}, "
                                     f"{batched_launches} batched launches")
            if metrics.engine_demotions_total() != dem0:
                raise AssertionError(f"(k) k={k}: an engine demotion")
            if launches0 != ranks[0]["launches"] or any(
                    r["launches"] != launches0 for r in ranks):
                raise AssertionError(f"(k) k={k}: launches "
                                     f"{[r['launches'] for r in ranks]}")
            got_telem = allocate_batched.last_solve["telemetry"]
            if statuses(cache) != want_status or binder.calls != want_binds:
                raise AssertionError(f"(k) k={k}: binds / statuses differ "
                                     f"from the one-card batched solve")
            if not same_frame(got_telem, want_telem) or got_telem[0] != 5:
                raise AssertionError(f"(k) k={k}: frame {got_telem} vs the "
                                     f"twin's {want_telem}")
            cache.stop()
            # the same cold inputs, every launch on every rank against
            # the plain version on that rank's inputs (raises on any
            # difference, after every rank has finished)
            _, cache_c, _ = cold_cache()
            inputs_c = build_cycle_inputs(OpenSession(cache_c,
                                                      shipped_tiers()))
            t0 = time.perf_counter()
            res_c = bs.solve_batched_sharded(mesh, inputs_c.device, inputs_c,
                                             check=True)
            check_s = time.perf_counter() - t0
            checked = bs.last_solve["ranks"]
            placed = int(np.isin(res_c[0], [1, 2, 3]).sum())
            if placed != len(want_binds) or not same_frame(
                    res_c[4].tolist(), want_telem):
                raise AssertionError(f"(k) k={k}: checked run placed "
                                     f"{placed}, frame {res_c[4].tolist()}")
            rounds = res_c[3]
            per_rank = [{
                "launches": r["launches"],
                "kernel_ms": round(sum(r["kernel_ms"].values()), 6),
                "kernel_ms_per_round": round(
                    sum(r["kernel_ms"].values()) / rounds, 6),
                "by_step": {s: round(v, 6) for s, v in r["kernel_ms"].items()},
                "collectives": r["collectives"], "stages": r["stages"],
                "collective_ms": round(r["collective_ms"], 6),
                "collective_ms_per_round": round(
                    r["collective_ms"] / rounds, 6),
                "wall_ms": round(r["wall_ms"], 6)} for r in ranks]
            runs[k] = {"wall_ms": wall_ms, "solve_ms": solve_ms,
                       "rounds": rounds, "readbacks": readbacks,
                       "launches": sum(r["launches"] for r in ranks),
                       "per_rank": per_rank, "staged": staged,
                       "spawn_s": spawn_s, "check_s": check_s,
                       "compared": [r["compared"] for r in checked]}
            cache_c.stop()
            log(f"(k) k={k}: cfg5 cold sharded == one-card batched "
                f"(compact_bucket=0): {len(want_binds)} binds, statuses "
                f"equal, {rounds} rounds; action wall {wall_ms:.1f} ms, "
                f"solve {solve_ms:.1f} ms; {readbacks} counted readbacks; "
                f"transport {staged}; spawn {spawn_s:.1f} s; every launch "
                f"on every rank bitwise the plain version "
                f"({runs[k]['compared']} checks, {check_s:.1f} s); per rank "
                + json.dumps(per_rank))
            if k == worlds[0]:
                sim_s, cache_s, _ = cold_cache()
                sched = Scheduler(cache_s, schedule_period=3600.0, mesh=mesh)
                engines, binds = [], []
                for cyc in range(3):
                    if cyc:
                        for pod in sim_s.pods:
                            if pod.node_name and \
                                    pod.phase == PodPhase.PENDING:
                                pod.phase = PodPhase.RUNNING
                                cache_s.update_pod(pod, pod)
                        if sim_s.churn_tick(cache_s, churn) != churn:
                            raise AssertionError("(k) churn short")
                    b0 = binding_count(cache_s)
                    t0 = time.perf_counter()
                    if not sched.run_cycle():
                        raise AssertionError(f"(k) scheduler cycle {cyc} "
                                             f"failed")
                    cache_s.drain(timeout=60.0)
                    engines.append((allocate_mod.last_cycle_engine,
                                    round((time.perf_counter() - t0) * 1e3,
                                          3)))
                    binds.append(binding_count(cache_s) - b0)
                if [e for e, _ in engines] != ["sharded", "fused", "fused"] \
                        or binds != [len(want_binds), churn, churn]:
                    raise AssertionError(f"(k) scheduler engines {engines}, "
                                         f"binds {binds}")
                runs[k]["scheduler"] = engines
                cache_s.stop()
                log(f"(k) Scheduler(mesh=k={k}) auto: engines and cycle ms "
                    f"{engines}, binds {binds}")
            if k == worlds[-1]:
                t_steps, n = scan_shape
                args = scan_args(n, t_steps, seed=0)
                run = sh.build_sharded_allocate(mesh)
                _build.reset_launch_counts()
                t0 = time.perf_counter()
                out = run(*(args[name] for name in sh.INPUTS))
                scan_wall = (time.perf_counter() - t0) * 1e3
                scan_ranks = sh.last_scan["ranks"]
                scan_launches = _build.launch_count("sharded_scan")
                if dev.type == "cuda" and any(
                        r["launches"] != t_steps + 1 for r in scan_ranks):
                    raise AssertionError(f"(k) scan launches "
                                         f"{[r['launches'] for r in scan_ranks]}")
                checked_run = sh.build_sharded_allocate(mesh, check=True)
                out_c = checked_run(*(args[name] for name in sh.INPUTS))
                for a, b in zip(out, out_c):
                    if not torch.equal(a.cpu(), b.cpu()):
                        raise AssertionError("(k) scan: checked run differs")
                t0 = time.perf_counter()
                want, _ = sh.scan_lockstep(args, k, "cpu")
                scan_plain_ms = (time.perf_counter() - t0) * 1e3
                for a, b in zip(out, want):
                    if not torch.equal(a.cpu(), b.cpu()):
                        raise AssertionError("(k) scan differs from plain")
                sb = sharded_scan_bounds(args, out, k)
                # the same scan in lock step (the k ranks in this process,
                # each launch alone on the card): every launch checked
                # against the plain version, then once unchecked, timed
                lock = {}
                for check in (True, False):
                    got, lranks = sh.scan_lockstep(args, k, dev.type,
                                                   check=check)
                    for a, b in zip(out, got):
                        if not torch.equal(a.cpu(), b.cpu()):
                            raise AssertionError(
                                f"(k) scan: the lock-step scan (check="
                                f"{check}) differs from the mesh's")
                if dev.type == "cuda":
                    lr0 = lranks[0]
                    lock = {"ms": lr0.kernel_ms(),
                            "ms_a_launch": lr0.kernel_ms() / lr0.launches,
                            "launches_a_rank": lr0.launches,
                            "phase_ms": lr0.phase_ms(),
                            "cluster": sh.scan_shape(k, sb["block"]),
                            "bound_ms_a_launch": sb["launch_bound_ms"],
                            "bound_by_a_launch": sb["launch_bound_by"]}
                scan = {"wall_ms": scan_wall,
                        "per_step_ms": scan_wall / t_steps,
                        "kernel_ms": scan_ranks[0]["kernel_ms"],
                        "kernel_ms_per_launch":
                            scan_ranks[0]["kernel_ms"] / (t_steps + 1),
                        "collective_ms_per_step":
                            scan_ranks[0]["collective_ms"] / t_steps,
                        "collectives": scan_ranks[0]["collectives"],
                        "stages": scan_ranks[0]["stages"],
                        "launches": sum(r["launches"] for r in scan_ranks),
                        "rank0_launches": scan_launches,
                        "plain_ms": scan_plain_ms,
                        "bound_ms": sb["bound_ms"],
                        "bound_by": sb["bound_by"], "bytes": sb["bytes"],
                        "block_real_nodes": sb["block_real_nodes"],
                        "placed": int((out[0] > 0).sum()),
                        "lockstep": lock}
                log(f"(k) scan k={k} T {t_steps} x N_pad {n}: "
                    + json.dumps({a: (round(b, 6) if isinstance(b, float)
                                      else b) for a, b in scan.items()})
                    + "; every launch bitwise the plain version, result "
                      "== the plain ranks'")
            if extra is not None:
                extra(k, mesh)
    # plain versions' times: the sharded plain ranks in lock step on the
    # host CPU at the first k, and the one-card plain's row counts (the
    # bound's work)
    _, cache_p, _ = cold_cache()
    inputs_p = build_cycle_inputs(OpenSession(cache_p, shipped_tiers()))
    k0 = worlds[0]
    node, rep, statics, n_sh = bs.prepare_sharded(k0, inputs_p.device,
                                                  inputs_p)
    t0 = time.perf_counter()
    packed_p, carry_p, _ = bs.solve_lockstep(node, rep, statics, n_sh, k0,
                                             "cpu")
    plain_ms = (time.perf_counter() - t0) * 1e3
    # the same inputs on the card in lock step (k0 ranks in this process,
    # each launch alone on the card: no time-slicing), every launch held
    # against the plain version (the ranks raise at the end)
    packed_l, carry_l, lranks = bs.solve_lockstep(node, rep, statics, n_sh,
                                                  k0, dev.type, check=True)
    # then once unchecked: the checked solve's event pairs also hold the
    # host's latency to each launch while the stream waits on the check
    packed_u, carry_u, uranks = bs.solve_lockstep(node, rep, statics, n_sh,
                                                  k0, dev.type)
    on_card = dev.type == "cuda"
    lock_steps = uranks[0].kernel_ms() if on_card else {}
    checked_steps = lranks[0].cuda.kernel_ms() if on_card else {}
    lockstep = {"ms": sum(lock_steps.values()),
                "by_step": {s: round(v, 6) for s, v in lock_steps.items()},
                "checked_ms": sum(checked_steps.values()),
                "launches": uranks[0].launches if on_card else 0,
                "compared": [r.compared for r in lranks] if on_card else []}
    for what, pk, cr in (("checked", packed_l, carry_l),
                         ("unchecked", packed_u, carry_u)):
        if not torch.equal(pk.cpu(), packed_p) or not torch.equal(
                cr.cpu(), carry_p):
            raise AssertionError(f"(k) the {what} lock-step solve differs "
                                 "from the plain ranks")
    tens = {name: torch.from_numpy(np.ascontiguousarray(v)).to(arg_dtype(name))
            for name, v in {**node, **rep}.items()}
    stats = {}
    one = batched_allocate_plain(**{name: tens[name]
                                    for name in NODE_ARGS + CYCLE_ARGS},
                                 compact_bucket=0, stats=stats, **statics)
    if not torch.equal(one[0][:3 * inputs_p.task_valid.shape[0] + 1],
                       packed_p[:3 * inputs_p.task_valid.shape[0] + 1]):
        raise AssertionError("(k) plain sharded != one-card plain at cfg5")
    cache_p.stop()
    sb = sharded_bounds(node, rep, packed_p, carry_p, stats,
                        bool(statics["pipe_enabled"]), k0)
    r0 = runs[k0]["per_rank"][0]
    log(f"(k) sharded_round cfg5 at k={k0}: rank 0's device ms "
        f"{r0['kernel_ms']:.3f} on the gloo mesh (time-sliced), "
        f"{lockstep['ms']:.3f} in lock step (events; by step "
        + json.dumps(lockstep["by_step"]) + "), "
        f"{lockstep['checked_ms']:.3f} in the checked lock-step solve "
        f"({lockstep['compared']} checks; host gaps inside its events)")
    log(f"(k) sharded_round cfg5: rank 0's bound at k={k0} "
        f"{sb['bound_ms']:.6f} ms ({sb['bound_by']}: {sb['bytes']} B, "
        f"{sb['ops']} operations, {sb['rows']} task rows over "
        f"{sb['block_real_nodes']} real nodes of its {sb['block']}, "
        f"{sb['rounds_run']} rounds); plain "
        f"ranks in lock step at k={k0} {plain_ms:.0f} ms on the host CPU; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    return [
        {"name": "sharded_round", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/sharded_round.cu",
         "replaces": "kubebatch_tpu/kernels/batched_sharded.py:130",
         "launches": runs[k0]["launches"], "max_abs_err": 0.0,
         "ms": r0["kernel_ms"], "plain_ms": plain_ms, "plain_device": "cpu",
         "plain_is": f"the {k0} plain ranks in lock step (the whole solve)",
         "bound_ms": sb["bound_ms"], "bound_by": sb["bound_by"],
         "library_ms": None, "ms_is": f"rank 0's device ms over its "
         f"launches of the main-path solve at k={k0} (the gloo mesh: the "
         f"ranks time-slice the card)",
         "lockstep_ms": lockstep["ms"],
         "lockstep_is": f"rank 0's device ms (events) over its launches of "
         f"one solve_lockstep at k={k0} on the same inputs (each launch "
         f"alone on the card), run after a checked one whose every launch "
         f"equalled the plain version (checked_ms: its events, which also "
         f"hold the host's latency to each launch)", "lockstep": lockstep,
         "bound_is": f"rank 0's work in that solve: its node block's real "
         f"nodes ({sb['block_real_nodes']} of {sb['block']})",
         "twin_batched_kernel_ms": twin_kernel_ms,
         "runs": {str(k): v for k, v in runs.items()}},
        {"name": "sharded_scan", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/sharded_scan.cu",
         "replaces": "kubebatch_tpu/kernels/sharded.py:113",
         "launches": scan["launches"], "max_abs_err": 0.0,
         "ms": scan["kernel_ms"], "plain_ms": scan["plain_ms"],
         "plain_device": "cpu", "bound_ms": scan["bound_ms"],
         "bound_by": scan["bound_by"], "library_ms": None,
         "ms_is": "rank 0's device ms over its launches of the whole scan",
         "bound_is": "rank 0's work over the whole scan: its node block's "
                     "real nodes, every task step",
         "lockstep_ms": scan["lockstep"].get("ms"),
         "lockstep_is": "rank 0's device ms (events) over its launches of "
                        "one unchecked scan_lockstep on the same inputs "
                        "(each launch alone on the card), run after a "
                        "checked one whose every launch equalled the plain "
                        "version; lockstep.bound_ms_a_launch is one "
                        "launch's bound beside lockstep.ms_a_launch",
         "scan": scan},
    ]


def rank_table(ranks) -> list:
    """Per rank of a mesh solve: launches, device ms (all and by step),
    collectives, stages and their host ms, the rank's wall and, for the
    two-level solve's checked ranks, the plain rank's work counts."""
    return [{"launches": r["launches"],
             "kernel_ms": round(sum(r["kernel_ms"].values()), 6),
             "by_step": {k: round(v, 6) for k, v in r["kernel_ms"].items()},
             "collectives": r["collectives"], "stages": r["stages"],
             "collective_ms": round(r["collective_ms"], 6),
             "wall_ms": round(r["wall_ms"], 6),
             **({"work": r["work"]} if "work" in r else {})}
            for r in ranks]


def sharded_aff_bounds(node, rep, packed, carry, stats, pipe: bool,
                       world: int) -> dict:
    """Rank 0's roofline in the sharded solve with the affinity
    vocabulary, beside rank 0's kernel ms: ``sharded_bounds``' bytes (its
    block's rows, the port rows among them, and the replicated arrays,
    the whole ``node_dom`` and the [T,P] terms and [P,D] carry among
    them, each read once; the packed result and its block of the carry
    written once) and cells, plus, over its block's real nodes, the
    predicates' integer operations on every row-pass row
    (OPS_PER_CELL_AFF over PEAK_I32_PER_S) and the interpod score's
    float operations on the rows that can score (``affinity_bounds``'
    counts). ``stats``: rank 0's plain rank's counts on the same
    inputs."""
    base = sharded_bounds(node, rep, packed, carry, stats, pipe, world)
    n_real = base["block_real_nodes"]
    int_ops = stats["rows"] * n_real * OPS_PER_CELL_AFF
    ip_ops = (stats.get("ip_terms", 0)
              + stats.get("ip_rows", 0) * OPS_PER_IP_CELL) * n_real
    t_bytes = base["bytes"] / PEAK_BYTES_PER_S * 1e3
    t_ops = ((base["ops"] + ip_ops) / PEAK_F32_PER_S
             + int_ops / PEAK_I32_PER_S) * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    return dict(base, ops=base["ops"] + ip_ops + int_ops, int_ops=int_ops,
                ip_rows=stats.get("ip_rows", 0), bound_ms=b_ms,
                bound_by=b_by)


def sharded_hier_bounds(node, rep, packed, carry, work, pipe: bool,
                        world: int) -> dict:
    """Rank 0's roofline in the two-level solve over the mesh, beside
    rank 0's kernel ms: its block's rows, the replicated arrays, the
    packed result and its block of the carry, each moved once, over the
    memory rate; against its own work, counted by its plain rank on the
    same inputs (HierPlainRank.stats): the coarse passes' cells
    (OPS_PER_CELL_COARSE, with pipelining its fit tests) and each
    pass's majority score over the block's real nodes, the rounds'
    (task row x real node) cells over its part of each pool and their
    (pair x real node) score cells, over the float32 rate (the cells of
    ``scale_bounds``, restricted to rank 0)."""
    import numpy as np

    n_sh = node["idle"].shape[0]
    nb = n_sh // world
    block = {k: (v[:, :nb] if k in ("sig_scores", "sig_pred") else v[:nb])
             for k, v in node.items()}
    n_real = int(np.asarray(block["node_ok"]).sum())
    nbytes = sum(a.nbytes for a in block.values()) + sum(
        a.nbytes for a in rep.values())
    nbytes += packed.numel() * 4 + carry[:nb].numel() * 4
    pipe_ops = OPS_PER_CELL_PIPE if pipe else 0
    ops = (work["coarse_cells"] * (OPS_PER_CELL_COARSE + pipe_ops)
           + work["coarse_passes"] * n_real * OPS_PER_PAIR_CELL
           + work["row_cells"] * (OPS_PER_CELL_BATCHED + pipe_ops)
           + work["pair_cells"] * OPS_PER_PAIR_CELL)
    b_ms, b_by = bound(nbytes, ops)
    return {"bytes": nbytes, "ops": ops, "block": nb,
            "block_real_nodes": n_real, "bound_ms": b_ms, "bound_by": b_by}


class MeshPhase:
    """Phase (l): the predicate-rich and two-level mesh, run in phase
    (k)'s k-rank groups (``sharded_phase(extra=...)``). At k = 2: (l1) 5p
    cold through ``Scheduler(mesh=...)`` in auto at full width (sharded,
    no ("sharded", "batched") demotion, binds and statuses equal to a
    one-card ``Scheduler`` whose batched solve has compact_bucket=0, the
    final state valid under the predicates; unchecked per launch: the
    plain 5p solve takes minutes on the host) and (l3) cfg6 cold through
    ``hier.solve_hier_sharded`` (equal to one launch of
    csrc/hier_allocate.cu with the same pool on the same bucket, then
    every launch on every rank checked against the plain version); at
    k = 2 and 4: (l2) 3p cold through ``solve_batched_sharded``, equal to
    the one-card kernel, then every launch on every rank checked. Each
    prints per rank launches, device ms by step, collectives and stages.
    ``entries()`` gives the kernels line's rows 10a and 8m."""

    def __init__(self, dev, spec5p, spec3p, spec6, counts_5p=None):
        self.dev = dev
        self.specs = {"5p": spec5p, "3p": spec3p, "cfg6": spec6}
        #: the plain engine's work counts of the 5p cold solve (phase
        #: (e), the same inputs): (l1)'s bound
        self.counts_5p = counts_5p
        self.out = {"l1": None, "l2": {}, "l3": {}}
        self.seconds = {}

    def __call__(self, k, mesh):
        t0 = time.perf_counter()
        if k == 2:
            self.l1(mesh)
        self.l2(k, mesh)
        if k == 2:
            self.l3(k, mesh)
        self.seconds[k] = time.perf_counter() - t0
        log(f"(l) k={k}: {self.seconds[k]:.1f} s")

    def _launched(self, what: str, ranks) -> None:
        """Every rank launched csrc/sharded_round.cu as often as this
        process counted since the reset (on the card: at least once)."""
        from kubebatch_tpu_torch.kernels import _build

        rank0 = _build.launch_count("sharded_round")
        if any(r["launches"] != rank0 for r in ranks) or (
                self.dev.type == "cuda" and not rank0):
            raise AssertionError(f"{what} launches {rank0} here, "
                                 f"{[r['launches'] for r in ranks]}")

    @staticmethod
    def _carry(device):
        return [getattr(device, f) for f in ("idle", "releasing",
                                             "n_tasks", "nz_req")]

    @staticmethod
    def _restore(device, carry):
        for f, v in zip(("idle", "releasing", "n_tasks", "nz_req"), carry):
            setattr(device, f, v)

    def _cache(self, spec_name, binder=None, incremental=True):
        from kubebatch_tpu_torch.cache import SchedulerCache
        from kubebatch_tpu_torch.sim import build_cluster

        sim = build_cluster(self.specs[spec_name])
        kw = {} if binder is None else {"binder": binder}
        cache = SchedulerCache(device=self.dev, async_writeback=False,
                               incremental_snapshot=incremental, **kw)
        sim.populate(cache)
        return sim, cache

    def l1(self, mesh):
        from kubebatch_tpu_torch import metrics
        from kubebatch_tpu_torch.actions import allocate as allocate_mod
        from kubebatch_tpu_torch.actions import allocate_batched
        from kubebatch_tpu_torch.kernels import _build
        from kubebatch_tpu_torch.kernels import batched_sharded as bs
        from kubebatch_tpu_torch.runtime.scheduler import Scheduler

        def statuses(cache):
            return {f"{t.namespace}/{t.name}": (t.status.name, t.node_name)
                    for j in cache.jobs.values() for t in j.tasks.values()}

        binder0 = RecordingBinder()
        _, cache0 = self._cache("5p", binder0)
        inner = allocate_batched.solve_batched

        def no_compact(inputs, **kw):
            kw["compact_bucket"] = 0
            return inner(inputs, **kw)

        allocate_batched.solve_batched = no_compact
        try:
            t0 = time.perf_counter()
            if not Scheduler(cache0, schedule_period=3600.0).run_cycle():
                raise AssertionError("(l1) the one-card 5p cycle failed")
            cache0.drain(timeout=120.0)
            twin_ms = (time.perf_counter() - t0) * 1e3
        finally:
            allocate_batched.solve_batched = inner
        if allocate_mod.last_cycle_engine != "batched":
            raise AssertionError(f"(l1) twin engine "
                                 f"{allocate_mod.last_cycle_engine}")
        twin_kernel_ms = allocate_batched.last_phases.get("kernel")
        want_status, want_binds = statuses(cache0), list(binder0.calls)
        cache0.stop()
        binder = RecordingBinder()
        _, cache = self._cache("5p", binder)
        pairs0 = dict(metrics.engine_demotions_by_pair())
        fb0 = metrics.affinity_host_fallback_total()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if not Scheduler(cache, schedule_period=3600.0,
                         mesh=mesh).run_cycle():
            raise AssertionError("(l1) the 5p cycle over the mesh failed")
        cache.drain(timeout=120.0)
        wall_ms = (time.perf_counter() - t0) * 1e3
        engine = allocate_mod.last_cycle_engine
        pairs = metrics.engine_demotions_by_pair()
        ranks = bs.last_solve["ranks"]
        if engine != "sharded" or pairs != pairs0 or \
                metrics.affinity_host_fallback_total() != fb0 or \
                _build.launch_count("batched_allocate"):
            raise AssertionError(f"(l1) engine {engine}, demotions "
                                 f"{pairs} (was {pairs0})")
        if statuses(cache) != want_status or binder.calls != want_binds:
            raise AssertionError("(l1) binds / statuses differ from the "
                                 "one-card batched 5p cycle")
        self._launched("(l1)", ranks)
        valid = validate_affinity(cache)
        bad = gang_all_or_nothing(cache)
        if bad:
            raise AssertionError(f"(l1) {bad} PodGroups partly placed")
        rounds = allocate_batched.last_solve["rounds"]
        bound5 = self._bound_5p() if self.counts_5p else None
        self.out["l1"] = {
            "binds": len(want_binds), "rounds": rounds,
            "cycle_wall_ms": wall_ms, "twin_cycle_wall_ms": twin_ms,
            "twin_kernel_ms": twin_kernel_ms,
            "solve_wall_ms": bs.last_solve["wall_ms"],
            "launches": sum(r["launches"] for r in ranks),
            "vocabulary": bs.last_solve["vocabulary"],
            "per_rank": rank_table(ranks), "validated": valid,
            "bound": bound5}
        cache.stop()
        if bound5:
            log(f"(l1) rank 0's bound on the 5p solve: "
                f"{bound5['bound_ms']:.6f} ms ({bound5['bound_by']}: "
                f"{bound5['rows']} row-pass rows, {bound5['ip_rows']} of them "
                f"scoring, {bound5['rounds_run']} rounds over its "
                f"{bound5['block_real_nodes']} real nodes; {bound5['bytes']} "
                f"B, {bound5['ops']:.4g} operations) beside its launches' "
                f"{self.out['l1']['per_rank'][0]['kernel_ms']:.3f} ms")
        log("(l1) 5p cold through Scheduler(mesh=k=2) in auto: sharded, no "
            "demotion, no host fallback; binds and statuses == the one-card "
            f"batched cycle (compact_bucket=0): {len(want_binds)} binds, "
            f"{rounds} rounds; cycle wall {wall_ms:.1f} ms (one-card twin "
            f"{twin_ms:.1f} ms, its kernel {twin_kernel_ms} ms); solve "
            f"{bs.last_solve['wall_ms']:.1f} ms; vocabulary "
            + json.dumps(bs.last_solve["vocabulary"]) + "; per rank "
            + json.dumps(self.out["l1"]["per_rank"]))

    def _bound_5p(self) -> dict:
        """Rank 0's roofline on the 5p cold solve at k = 2 (row 10a), from
        the plain engine's counts of the same solve (phase (e)): the
        sharded inputs of a fresh 5p cache, its packed result and its
        block's carry words by size."""
        import torch

        from kubebatch_tpu_torch.actions.cycle_inputs import \
            build_cycle_inputs
        from kubebatch_tpu_torch.conf import shipped_tiers
        from kubebatch_tpu_torch.framework import OpenSession
        from kubebatch_tpu_torch.kernels import batched_sharded as bs
        from kubebatch_tpu_torch.kernels.telemetry import TELEM_WIDTH

        _, cache = self._cache("5p", incremental=False)
        inputs = build_cycle_inputs(OpenSession(cache, shipped_tiers()),
                                    allow_affinity=True)
        node, rep, statics, n_sh = bs.prepare_sharded(2, inputs.device,
                                                      inputs)
        cache.stop()
        t_pad = inputs.task_valid.shape[0]
        ports = rep["task_ports"].shape[1] if "task_ports" in rep else 0
        packed = torch.empty(3 * t_pad + 1 + TELEM_WIDTH, dtype=torch.int32)
        carry = torch.empty((n_sh, bs.W_CARRY + ports), dtype=torch.int32)
        return sharded_aff_bounds(node, rep, packed, carry, self.counts_5p,
                                  bool(statics["pipe_enabled"]), 2)

    def l2(self, k, mesh):
        import numpy as np
        import torch

        from kubebatch_tpu_torch.actions.cycle_inputs import \
            build_cycle_inputs
        from kubebatch_tpu_torch.conf import shipped_tiers
        from kubebatch_tpu_torch.framework import OpenSession
        from kubebatch_tpu_torch.kernels import _build
        from kubebatch_tpu_torch.kernels import batched_sharded as bs
        from kubebatch_tpu_torch.kernels.batched import (
            AFF_ARGS, AFF_OUT, CYCLE_ARGS, IP_ARG, NODE_ARGS, arg_dtype,
            batched_allocate)

        _, cache = self._cache("3p", incremental=False)
        inputs = build_cycle_inputs(OpenSession(cache, shipped_tiers()),
                                    allow_affinity=True)
        device = inputs.device
        carry0 = self._carry(device)
        node, rep, statics, n_sh = bs.prepare_sharded(k, device, inputs)
        t = {n: torch.from_numpy(np.array(v, copy=True)).to(arg_dtype(n))
             .to(self.dev) for n, v in {**node, **rep}.items()}
        aff = {n: t[n] for n in AFF_ARGS}
        if "task_ports" in rep:
            aff.update(task_ports=t["task_ports"], port_base=t["port_base"])
        if IP_ARG in rep:
            aff[IP_ARG] = t[IP_ARG].reshape(())
        one = batched_allocate(**{n: t[n] for n in NODE_ARGS + CYCLE_ARGS},
                               compact_bucket=0, aff=aff, **statics)
        torch.cuda.synchronize()
        t_pad = inputs.task_valid.shape[0]
        one_p = one[0].cpu().numpy()
        runs = {}
        for check in (False, True):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = bs.solve_batched_sharded(mesh, device, inputs, check=check)
            wall = (time.perf_counter() - t0) * 1e3
            self._launched("(l2)", bs.last_solve["ranks"])
            for i in range(3):
                if not np.array_equal(one_p[i * t_pad:(i + 1) * t_pad],
                                      res[i]):
                    raise AssertionError(f"(l2) k={k} check={check}: "
                                         f"decisions differ from the "
                                         f"one-card kernel")
            carry = self._carry(device)
            n_pad = device.n_padded
            for w, g in zip(one[1:5], carry):
                if not torch.equal(w[:n_pad].cpu(), g.cpu()):
                    raise AssertionError(f"(l2) k={k}: node carry differs")
            got_aff = bs.last_solve["aff"]
            for name in AFF_OUT:
                if one[5][name] is not None and not np.array_equal(
                        one[5][name].cpu().numpy(), got_aff[name]):
                    raise AssertionError(f"(l2) k={k}: {name} differs")
            ranks = bs.last_solve["ranks"]
            runs["checked" if check else "unchecked"] = {
                "wall_ms": wall, "rounds": res[3],
                "launches": sum(r["launches"] for r in ranks),
                "compared": [r["compared"] for r in ranks],
                "per_rank": rank_table(ranks)}
            self._restore(device, carry0)
        entry = {"runs": runs, "n_sh": n_sh,
                 "placed": int(np.isin(one_p[:t_pad], [1, 2, 3]).sum()),
                 "vocabulary": bs.last_solve["vocabulary"]}
        if k == 2:
            t0 = time.perf_counter()
            packed_p, carry_p, pranks = bs.solve_lockstep(
                node, rep, statics, n_sh, k, "cpu")
            entry["plain_ms"] = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(packed_p.numpy()[:3 * t_pad + 1],
                                  one_p[:3 * t_pad + 1]):
                raise AssertionError("(l2) the plain ranks differ")
            entry["bound"] = sharded_aff_bounds(
                node, rep, packed_p, carry_p, pranks[0].stats,
                bool(statics["pipe_enabled"]), k)
            entry["rounds_plain"] = int(packed_p[3 * t_pad])
        self.out["l2"][k] = entry
        cache.stop()
        log(f"(l2) 3p cold over k={k}: the one-card kernel's decisions, "
            f"node carry, [P,D] carry and port claims; every launch on "
            f"every rank bitwise the plain version "
            f"({runs['checked']['compared']} checks); "
            + json.dumps({"unchecked": runs["unchecked"],
                          "checked_wall_ms": runs["checked"]["wall_ms"],
                          "plain_ms": entry.get("plain_ms"),
                          "bound": entry.get("bound")}))

    def l3(self, k, mesh):
        import numpy as np
        import torch

        from kubebatch_tpu_torch.actions.cycle_inputs import \
            build_cycle_inputs
        from kubebatch_tpu_torch.conf import shipped_tiers
        from kubebatch_tpu_torch.framework import OpenSession
        from kubebatch_tpu_torch.kernels import _build
        from kubebatch_tpu_torch.kernels import batched_sharded as bs
        from kubebatch_tpu_torch.kernels import hier as hier_mod
        from kubebatch_tpu_torch.kernels.batched import (CYCLE_ARGS,
                                                         NODE_ARGS,
                                                         arg_dtype)

        t_start = time.perf_counter()
        _, cache = self._cache("cfg6", incremental=False)
        inputs = build_cycle_inputs(OpenSession(cache, shipped_tiers()))
        device = inputs.device
        carry0 = self._carry(device)
        node, rep, _, n_sh = bs.prepare_sharded(k, device, inputs)
        t_pad = inputs.task_valid.shape[0]
        setup_s = time.perf_counter() - t_start
        runs = {}
        for check in (False, True):
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = hier_mod.solve_hier_sharded(mesh, device, inputs,
                                              check=check)
            wall = (time.perf_counter() - t0) * 1e3
            ranks = bs.last_solve["ranks"]
            self._launched("(l3)", ranks)
            statics = bs.last_solve["statics"]
            runs["checked" if check else "unchecked"] = {
                "wall_ms": wall, "rounds": res[3],
                "launches": sum(r["launches"] for r in ranks),
                "compared": [r["compared"] for r in ranks],
                "per_rank": rank_table(ranks), "result": res,
                "carry": self._carry(device)}
            self._restore(device, carry0)
        got, carry = runs["unchecked"].pop("result"), \
            runs["unchecked"].pop("carry")
        got_c = runs["checked"].pop("result")
        runs["checked"].pop("carry")
        for a, b in zip(got[:4], got_c[:4]):
            if not np.array_equal(a, b):
                raise AssertionError("(l3) the checked run differs")
        # one launch of csrc/hier_allocate.cu with the same pool
        t = {n: torch.from_numpy(np.array(v, copy=True)).to(arg_dtype(n))
             .to(self.dev) for n, v in {**node, **rep}.items()}
        one = hier_mod.hier_packed(
            **{n: t[n] for n in NODE_ARGS + CYCLE_ARGS},
            **{n: statics[n] for n in (
                "job_keys", "queue_keys", "prop_overused", "dyn_enabled",
                "pipe_enabled", "max_rounds", "pool_size", "max_waves",
                "gang_enabled", "narrow", "narrow_gate")})
        torch.cuda.synchronize()
        one_p = one[0].cpu().numpy()
        for i in range(3):
            if not np.array_equal(one_p[i * t_pad:(i + 1) * t_pad], got[i]):
                raise AssertionError("(l3) decisions differ from the "
                                     "one-card hier_allocate launch")
        if int(one_p[3 * t_pad]) != got[3] or not np.array_equal(
                one_p[3 * t_pad + 2:], got[4][1:]) or got[4][0] != 6:
            raise AssertionError(f"(l3) rounds / frame differ: "
                                 f"{got[4].tolist()}")
        n_pad = device.n_padded
        for w, g in zip(one[1:5], carry):
            if not torch.equal(w[:n_pad].cpu(), g.cpu()):
                raise AssertionError("(l3) node carry differs")
        work = runs["checked"]["per_rank"][0]["work"]
        t0 = time.perf_counter()
        packed_p, carry_p, _ = bs.solve_hier_lockstep(
            node, rep, statics, n_sh, k, "cpu")
        plain_ms = (time.perf_counter() - t0) * 1e3
        if not np.array_equal(packed_p.numpy()[:3 * t_pad + 1],
                              one_p[:3 * t_pad + 1]):
            raise AssertionError("(l3) the plain ranks differ")
        hb = sharded_hier_bounds(node, rep, packed_p, carry_p, work,
                                 bool(statics["pipe_enabled"]), k)
        self.out["l3"][k] = {
            "runs": runs, "n_sh": n_sh, "pool": statics["pool_size"],
            "pools": n_sh // statics["pool_size"], "rounds": got[3],
            "waves": work["waves"], "straddling": work["straddling"],
            "placed": int(np.isin(got[0], [1, 2, 3]).sum()),
            "plain_ms": plain_ms, "bound": hb, "setup_s": setup_s}
        cache.stop()
        log(f"(l3) cfg6 cold through solve_hier_sharded over k={k}: == one "
            f"hier_allocate launch with pool {statics['pool_size']} on the "
            f"{n_sh}-node bucket (decisions, nodes, seq, rounds, frame but "
            f"its engine {got[4][0]}, carry); every launch on every rank "
            f"bitwise the plain version ({runs['checked']['compared']} "
            f"checks); {got[3]} rounds, {work['waves']} waves, "
            f"{work['straddling']} straddling pools met; wall "
            f"{runs['unchecked']['wall_ms']:.1f} ms unchecked, "
            f"{runs['checked']['wall_ms']:.1f} ms checked; plain ranks in "
            f"lock step {plain_ms:.0f} ms; bound {hb['bound_ms']:.6f} ms "
            f"({hb['bound_by']}); per rank "
            + json.dumps(runs["unchecked"]["per_rank"]))

    def entries(self) -> list:
        l1, l2, l3 = self.out["l1"], self.out["l2"][2], self.out["l3"][2]
        r0 = l2["runs"]["unchecked"]["per_rank"][0]
        h0 = l3["runs"]["unchecked"]["per_rank"][0]
        return [
            {"name": "sharded_round_affinity", "row": "10a", "route": "cuda",
             "source": "kubebatch_tpu_torch/kernels/csrc/sharded_round.cu",
             "replaces": "kubebatch_tpu/kernels/batched_sharded.py:74",
             "launches": l1["launches"], "max_abs_err": 0.0,
             "ms": r0["kernel_ms"], "plain_ms": l2["plain_ms"],
             "plain_device": "cpu", "bound_ms": l2["bound"]["bound_ms"],
             "bound_by": l2["bound"]["bound_by"], "library_ms": None,
             "launches_is": "all ranks' launches in (l1), the 5p cold "
                            "Scheduler(mesh) cycle at k=2",
             "ms_is": "rank 0's device ms over its launches of the 3p "
                      "cold solve at k=2 (l2, unchecked)",
             "plain_is": "the 2 plain ranks in lock step on the host CPU, "
                         "the whole 3p solve",
             "bound_is": "rank 0's work in that 3p solve over its block's "
                         "real nodes",
             "ms_5p": l1["per_rank"][0]["kernel_ms"],
             "bound_ms_5p": (l1["bound"] or {}).get("bound_ms"),
             "bound_by_5p": (l1["bound"] or {}).get("bound_by"),
             "l1": l1,
             "l2": {str(k): v for k, v in self.out["l2"].items()}},
            {"name": "sharded_hier", "row": "8m", "route": "cuda",
             "source": "kubebatch_tpu_torch/kernels/csrc/sharded_round.cu",
             "replaces": "kubebatch_tpu/kernels/hier.py:504",
             "launches": l3["runs"]["unchecked"]["launches"],
             "max_abs_err": 0.0, "ms": h0["kernel_ms"],
             "plain_ms": l3["plain_ms"], "plain_device": "cpu",
             "bound_ms": l3["bound"]["bound_ms"],
             "bound_by": l3["bound"]["bound_by"], "library_ms": None,
             "ms_is": "rank 0's device ms over its launches of the cfg6 cold "
                      "solve at k=2 (l3, unchecked)",
             "plain_is": "the 2 plain ranks in lock step on the host CPU, "
                         "the whole solve",
             "bound_is": "rank 0's work in that solve over its block's real "
                         "nodes",
             "l3": {str(k): v for k, v in self.out["l3"].items()}},
        ]


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
    from kubebatch_tpu_torch.actions import allocate_batched, allocate_fused
    from kubebatch_tpu_torch.actions.allocate import AllocateAction
    from kubebatch_tpu_torch.cache import NullBinder, SchedulerCache
    from kubebatch_tpu_torch.conf import shipped_tiers
    from kubebatch_tpu_torch.framework import CloseSession, OpenSession
    from kubebatch_tpu_torch.kernels import _build
    from kubebatch_tpu_torch.kernels import batched as batched_mod
    from kubebatch_tpu_torch.kernels import fused as fused_mod
    from kubebatch_tpu_torch.kernels.batched import (batched_allocate,
                                                     batched_allocate_plain)
    from kubebatch_tpu_torch.kernels.fused import (fused_allocate,
                                                   fused_allocate_plain)
    from kubebatch_tpu_torch.kernels.solver import (dynamic_node_score,
                                                    dynamic_node_score_plain)
    from kubebatch_tpu_torch.objects import PodPhase
    from kubebatch_tpu_torch.sim import BASELINE_SPECS, baseline_cluster

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"device: {kind} ({torch.cuda.device_count()} visible), torch "
        f"{torch.__version__}, cuda {torch.version.cuda}; {card}")

    # ---- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    per_source = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s wall, per source "
        + ", ".join(f"{k} {v:.1f} s" for k, v in per_source.items()))
    for name, rec in _build.build_log.items():
        for line in rec["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    _build.library("fused_allocate.cu")     # loads every library now
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
        bargs, bstatics = build_batched_inputs(cfg, dev)
        got = batched_allocate(**bargs, **bstatics)
        torch.cuda.synchronize()
        want = batched_allocate_plain(**on_cpu(bargs), **bstatics)
        got = [g.cpu() for g in got]
        assert_bitwise(want, got, f"batched_allocate cfg{cfg}")
        t_pad = bargs["task_valid"].shape[0]
        log(f"batched_allocate cfg{cfg}: packed [{got[0].shape[0]}] and node "
            f"carries bitwise equal to plain on CPU copies "
            f"({batched_placed(got[0], t_pad)} placed, "
            f"{int(got[0][3 * t_pad])} rounds, compact bucket "
            f"{bstatics['compact_bucket']}, launch "
            f"{json.dumps(launch_info(batched_mod.last_launch))})")

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

    # ---- 3. the main path at cfg5, in auto ------------------------------
    t0 = time.perf_counter()
    sim = baseline_cluster(5)
    cache = SchedulerCache(device="cuda", binder=NullBinder(),
                           incremental_snapshot=False)
    sim.populate(cache)
    log(f"cfg5, snapshot-primary cache: {len(cache.nodes)} nodes, "
        f"{len(sim.pods)} pods, {len(cache.queues)} queues populated in "
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
        engine = allocate_mod.last_cycle_engine
        engine_phases = (allocate_batched.last_phases if engine == "batched"
                         else allocate_fused.last_phases)
        phases = {"snapshot": (t1 - t0) * 1e3, "open": (t2 - t1) * 1e3,
                  **engine_phases,
                  "allocate": (t3 - t2) * 1e3, "close": (t4 - t3) * 1e3}
        return {"engine": engine,
                "syncs": metrics.blocking_readbacks() - rb0,
                "binds": binding_count(cache) - b0, "phases": phases}

    def kubelet_tick():
        for pod in sim.pods:
            if pod.node_name and pod.phase == PodPhase.PENDING:
                pod.phase = PodPhase.RUNNING
                cache.update_pod(pod, pod)

    names = ("batched_allocate", "fused_allocate", "dynamic_node_score")
    dem0 = metrics.engine_demotions_total()
    with Recorder(batched_mod, "batched_allocate") as brec, \
            Recorder(allocate_fused, "fused_allocate") as frec:
        _build.reset_launch_counts()
        c1 = drive("auto")
        l1 = {n: _build.launch_count(n) for n in names}
        # the main-path launch's phase timers (read after the checks)
        main_phase_ns = batched_mod.last_launch["phase_ns"]
        rounds1 = allocate_batched.last_solve["rounds"]
        telem1 = allocate_batched.last_solve["telemetry"]
        kubelet_tick()
        recycled = sim.churn_tick(cache, 256)
        c2 = drive("auto")
        launches = {n: _build.launch_count(n) for n in names}
        # the main-path fused launch's shape and phase timers
        churn_launch = dict(fused_mod.last_launch)
    cycles = [c1, c2]
    for k, c in enumerate(cycles, 1):
        log(f"cycle {k}: engine {c['engine']}, binds {c['binds']}, counted "
            f"syncs {c['syncs']}, phases ms "
            + json.dumps({p: round(v, 3) for p, v in c["phases"].items()}))
    log(f"cycle 1 (batched): {l1['batched_allocate']} kernel launch(es) per "
        f"solve, {rounds1} rounds per solve (frame: retries {telem1[14]}, "
        f"stranded {telem1[15]}), grid "
        f"{json.dumps(launch_info(batched_mod.last_launch))}")
    if recycled != 256:
        raise AssertionError(f"churn recycled {recycled} pods, not 256")
    if c1["engine"] != "batched" or c2["engine"] != "fused":
        raise AssertionError(f"engines {c1['engine']} / {c2['engine']}, "
                             f"expected batched / fused")
    if l1 != {"batched_allocate": 1, "fused_allocate": 0,
              "dynamic_node_score": 0} or launches != {
                  "batched_allocate": 1, "fused_allocate": 1,
                  "dynamic_node_score": 0}:
        raise AssertionError(f"launches {l1} then {launches}, expected one "
                             f"batched solve then one fused solve")
    if any(c["syncs"] != 1 for c in cycles):
        raise AssertionError("a solve did not make exactly one counted "
                             "device->host copy")
    if metrics.engine_demotions_total() != dem0:
        raise AssertionError("an engine demotion happened on the main path")
    bad = gang_all_or_nothing(cache)
    if bad:
        raise AssertionError(f"{bad} PodGroups partially placed")
    if len(brec.calls) != 1 or len(frec.calls) != 1:
        raise AssertionError("expected one recorded solve per engine")

    # every main-path solve against the plain version on its own inputs
    bkw, bgot = brec.calls[0]
    record_digest("cfg5 cold", bkw, bgot)
    t_pad = bkw["task_valid"].shape[0]
    stats = {}
    t0 = time.perf_counter()
    bwant = batched_allocate_plain(**on_cpu(bkw), stats=stats)
    batched_plain_ms = (time.perf_counter() - t0) * 1e3
    bgot = [g.cpu() for g in bgot]
    batched_err = max_abs_err(bwant, bgot)
    assert_bitwise(bwant, bgot, "batched_allocate cfg5 cycle 1")
    expected = batched_placed(bwant[0], t_pad)
    if c1["binds"] != expected:
        raise AssertionError(f"cycle 1: {c1['binds']} binds, plain version "
                             f"placed {expected}")
    log(f"cfg5 cycle 1: batched kernel packed result and carries bitwise "
        f"equal to plain (CPU copies, {batched_plain_ms:.0f} ms on the "
        f"host CPU); binds {c1['binds']} == plain placements")
    fkw, fgot = frec.calls[0]
    t0 = time.perf_counter()
    fwant = fused_allocate_plain(**fkw)
    torch.cuda.synchronize()
    churn_plain_ms = (time.perf_counter() - t0) * 1e3
    assert_bitwise(fwant, fgot, "fused_allocate cfg5 cycle 2")
    if c2["binds"] != placed_count(fwant[0]):
        raise AssertionError(f"cycle 2: {c2['binds']} binds, plain version "
                             f"placed {placed_count(fwant[0])}")
    log(f"cfg5 cycle 2: fused kernel host block and carries bitwise equal "
        f"to plain; binds {c2['binds']} == plain placements")
    if c1["binds"] != len(sim.pods) or c2["binds"] != 256:
        raise AssertionError(f"binds {c1['binds']} / {c2['binds']}, "
                             f"expected {len(sim.pods)} / 256")

    # ---- 4. the fused kernel on a cfg5 cold solve (no longer the path) --
    kw1, statics1 = build_session_inputs(5, dev)
    out1 = fused_allocate(**kw1, **statics1)
    torch.cuda.synchronize()
    cold_launch = dict(fused_mod.last_launch)
    t0 = time.perf_counter()
    want1 = fused_allocate_plain(**kw1, **statics1)
    torch.cuda.synchronize()
    fused_plain_ms = (time.perf_counter() - t0) * 1e3
    fused_err = max_abs_err(want1, out1)
    assert_bitwise(want1, out1, "fused_allocate cfg5 cold")
    log(f"fused_allocate cfg5 cold: host block and carries bitwise equal to "
        f"plain ({placed_count(out1[0])} placed)")

    # ---- 5. timings at the main path's shapes ---------------------------
    kw1 = dict(kw1, **statics1)
    fused_event_ms = cuda_ms(lambda: fused_allocate(**kw1), reps=3)
    fused_prof_ms = profiled_ms(lambda: fused_allocate(**kw1),
                                "fused_allocate_kernel", reps=2)
    fused_ms = fused_prof_ms if fused_prof_ms is not None else fused_event_ms
    fb = [fused_bounds(kw1, out1), fused_bounds(*frec.calls[0])]
    shapes = [launch_phases(cold_launch), launch_phases(churn_launch)]
    for b, shape in zip(fb, shapes):
        b.update(fused_floor(b, shape))
    n_pad = fb[0]["n_pad"]

    batched_event_ms = cuda_ms(lambda: batched_allocate(**bkw), reps=3)
    batched_prof_ms = profiled_ms(lambda: batched_allocate(**bkw),
                                  "batched_allocate_kernel", reps=2)
    bb = batched_bounds(bkw, bgot, stats, bool(bkw["pipe_enabled"]))
    phase_ms = {k: v / 1e6 for k, v in zip(
        batched_mod.PHASES, main_phase_ns.cpu().tolist())}

    dev_session_args = (fkw["nz_req0"], fkw["task_nz"][0],
                        fkw["allocatable_cm"], fkw["dyn_weights"])
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
        {"name": "batched_allocate", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/batched_allocate.cu",
         "replaces": "kubebatch_tpu/kernels/batched.py:1184",
         "launches": launches["batched_allocate"],
         "max_abs_err": batched_err, "ms": c1["phases"]["kernel"],
         "plain_ms": batched_plain_ms, "plain_device": "cpu",
         "bound_ms": bb["bound_ms"], "bound_by": bb["bound_by"],
         "library_ms": None, "rounds": rounds1,
         "launches_per_solve": l1["batched_allocate"],
         "event_ms_3_reps": batched_event_ms,
         "profiler_ms": batched_prof_ms, "phase_ms": phase_ms},
        {"name": "fused_allocate", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/fused_allocate.cu",
         "replaces": "kubebatch_tpu/kernels/fused.py:112",
         "launches": launches["fused_allocate"], "max_abs_err": fused_err,
         "ms": fused_ms, "plain_ms": fused_plain_ms,
         "bound_ms": fb[0]["bound_ms"], "bound_by": fb[0]["bound_by"],
         "library_ms": None, "floor_ms": fb[0]["floor_ms"],
         "churn_ms": c2["phases"]["kernel"],
         "churn_plain_ms": churn_plain_ms,
         "churn_bound_ms": fb[1]["bound_ms"],
         "churn_floor_ms": fb[1]["floor_ms"],
         "cluster": shapes[1]["cluster"], "threads": shapes[1]["threads"],
         "nodes_per_cta": shapes[1]["nodes_per_cta"],
         "shared": shapes[1]["shared"],
         "phase_ms": shapes[1].get("phase_ms"),
         "counts": shapes[1].get("counts"),
         "cold_launch": shapes[0], "cluster_probe": fb[0]["probe"]},
        {"name": "dynamic_node_score", "route": "cuda",
         "source": "kubebatch_tpu_torch/kernels/csrc/node_score.cu",
         "replaces": "kubebatch_tpu/kernels/solver.py:67",
         "launches": launches["dynamic_node_score"],
         "max_abs_err": score_err, "ms": score_ms,
         "plain_ms": score_plain_ms, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None,
         "runs_inside": "batched_allocate, fused_allocate"},
    ]
    log(f"batched_allocate cfg5 cold: {rounds1} rounds ({bb['rounds_run']} "
        f"round passes, {bb['rows']} task rows over both row passes), "
        f"kernel {c1['phases']['kernel']:.3f} ms (events, main path), "
        f"{batched_event_ms:.3f} ms per launch (events, 3 launches), "
        f"{batched_prof_ms} ms device time (profiler); plain "
        f"{batched_plain_ms:.0f} ms on the host CPU; roofline bound "
        f"{bb['bound_ms']:.6f} ms ({bb['bound_by']}: {bb['bytes']} B, "
        f"{bb['ops']} float32 operations)")
    log(f"batched_allocate cfg5 cold, main-path launch, device ms per phase "
        f"(thread 0 between grid barriers; sum "
        f"{sum(phase_ms.values()):.3f}; {chain_share(phase_ms)}): "
        + json.dumps({k: round(v, 3) for k, v in phase_ms.items()}))
    log(f"fused_allocate cfg5 cold: kernel {fused_event_ms:.3f} ms per "
        f"launch (CUDA events, 3 launches), {fused_prof_ms} ms device time "
        f"(profiler); plain {fused_plain_ms:.1f} ms; churn cycle plain "
        f"{churn_plain_ms:.1f} ms")
    for name, b, shape in zip(("cold solve", "cycle 2 (churn, main path)"),
                              fb, shapes):
        log(f"fused_allocate {name}: {b['iters']} iterations, "
            f"{b['n_solves']} node solves over {b['n_real']} real nodes "
            f"(N_pad {b['n_pad']}); roofline bound {b['bound_ms']:.6f} ms "
            f"({b['bound_by']}); cluster of {shape['cluster']} CTAs x "
            f"{shape['threads']} threads, {shape['nodes_per_cta']} nodes a "
            f"CTA, in shared memory {json.dumps(shape['shared'])}; phases "
            f"(CTA 0's thread 0, device ms) "
            + json.dumps({k: round(v, 4) for k, v in
                          (shape.get("phase_ms") or {}).items()})
            + f", counts {json.dumps(shape.get('counts'))}; the design's "
            f"floor (chain_probe.cu cluster probe: "
            f"{b['probe']['cluster_sync_us']:.4f} us a cluster barrier, "
            f"{b['probe']['block_sync_us']:.4f} us a block barrier) "
            f"{b['n_solves']} solves x (one cluster barrier + "
            f"{BLOCK_BARRIERS_PER_SOLVE} block barrier) "
            f"{b['floor_ms']:.3f} ms")
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
        f"arithmetic (node_score.cuh) runs inside every batched_allocate "
        f"and fused_allocate launch; the standalone kernel is timed at "
        f"N={n_pad}")
    cache.stop()

    victim_entries, binds_a = victim_phases(
        dev, BASELINE_SPECS[5],
        dataclasses.replace(BASELINE_SPECS[4], running_fill=0.95))
    kernels += victim_entries
    kernels.append(fold_phase(dev, BASELINE_SPECS[5]))
    aff_entry = affinity_phase(dev, BASELINE_SPECS["5p"],
                               BASELINE_SPECS["3p"])
    kernels.append(aff_entry)
    kernels.insert(3, scheduler_phase(dev, BASELINE_SPECS[5],
                                      BASELINE_SPECS[3], binds_a))
    kernels += scale_phase(dev, BASELINE_SPECS[6], BASELINE_SPECS[7])
    kernels.append(obs_phase(
        dev, dataclasses.replace(BASELINE_SPECS[4], running_fill=0.95),
        BASELINE_SPECS[5], BASELINE_SPECS["5p"], BASELINE_SPECS["3p"]))
    kernels.append(tenant_phase(dev))
    kernels.append(pipeline_phase(dev, BASELINE_SPECS[6]))
    mesh_l = MeshPhase(dev, BASELINE_SPECS["5p"], BASELINE_SPECS["3p"],
                       BASELINE_SPECS[6],
                       counts_5p=aff_entry["plain_counts"])
    kernels += sharded_phase(dev, BASELINE_SPECS[5], extra=mesh_l)
    kernels += mesh_l.entries()
    gp = grid_barrier_us()
    log(f"grid barrier (csrc/chain_probe.cu): {gp['grid_sync_us']:.4f} us "
        f"per grid.sync() on {gp['grid']} x {gp['threads']} threads, "
        f"{gp['block_sync_us']:.4f} us per block barrier ({gp['iters']} "
        f"back to back, best of 3)")
    check_digests()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
