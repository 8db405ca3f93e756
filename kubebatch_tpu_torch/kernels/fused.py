"""Fused allocate cycle — the whole allocate action as one device solve.

Runs the allocate control flow of actions/allocate/allocate.go as a loop
that places one task per iteration: queue selection (proportion shares +
overused drops), job selection (priority / gang ready-last / DRF dominant
share, lexicographic per the configured tier order), task order, the node
predicate/score/fit solve, and all fairness-state updates. One upload of
the cycle's tensors, one download of the decisions.

Two implementations of one function, chosen by the tensors' device:

- :func:`fused_allocate_plain` — plain PyTorch, a Python loop of tensor
  ops (reads its scalars with ``.item()``; these reads are not counted as
  readbacks). The CPU path, and the yardstick for the kernel.
- the CUDA kernel ``csrc/fused_allocate.cu`` — one thread-block cluster
  runs the whole loop on the card (``csrc/fused_body.cuh``: the nodes
  spread over the cluster's CTAs, the selection replicated in each, one
  cluster barrier a node solve).

:func:`fused_allocate` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; it never falls back from one to the other.
Both return ``(host_block, idle, releasing, n_tasks, nz_req)`` with the
reference package's layout (kubebatch_tpu/kernels/fused.py): host_block is
int32 [3, T + 1 + TELEM_WIDTH] — rows task_state, task_node, task_seq, then
the iteration count and the telemetry frame in trailing columns.

Faithfulness contract (equivalence-tested against the reference package
and the host oracle):
- queue entries: one per job; an overused or job-less queue pop consumes
  an entry (allocate.go:69-87); visits re-push implicitly.
- one job per visit; tasks in task-order until a task fails (job dropped),
  tasks exhaust (job dropped), or the job crosses gang readiness (job
  stays queued; one task per visit thereafter) — allocate.go:110-196.
- every assignment kind fires the fairness updates, but only plain
  Allocated and Pipelined advance gang readiness.
- shares: proportion share = max_r allocated/deserved; DRF share =
  max_r allocated/total; 0/0 -> 0, x/0 -> 1.
- order keys are recomputed from live shares at every pop; argmin/argmax
  ties go to the lowest index; when every node is masked out the argmax
  is node 0, which is not eligible, so the task fails.
"""
from __future__ import annotations

from typing import Tuple

import ctypes

import numpy as np
import torch

from . import _build
from .solver import dynamic_node_score_plain
from .telemetry import ENGINE_FUSED, TELEM_WIDTH, decision_frame
from .tensorize import VEC_EPS

SKIP, ALLOC, ALLOC_OB, PIPELINE, FAIL = 0, 1, 2, 3, 4

# job-order key ids
K_PRIORITY = "priority"        # static job priority, desc
K_GANG_READY = "gang_ready"    # not-ready before ready
K_DRF_SHARE = "drf_share"      # lower dominant share first
# queue-order key ids
K_PROP_SHARE = "prop_share"    # lower proportion share first

#: key codes shared with csrc/fused_allocate.cu
JOB_KEY_CODES = {K_PRIORITY: 0, K_GANG_READY: 1, K_DRF_SHARE: 2}

_BIG = 3.0e38
_INT32_MAX = int(np.iinfo(np.int32).max)

#: argument order of fused_allocate (node arrays, then the cycle arrays)
NODE_ARGS = ("idle", "releasing", "backfilled", "allocatable_cm", "nz_req0",
             "max_task_num", "n_tasks", "node_ok")
CYCLE_ARGS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
              "task_sig", "task_valid", "sig_scores", "sig_pred",
              "min_available", "order_min_available", "init_allocated",
              "job_queue", "job_priority", "job_create_rank", "job_valid",
              "q_weight", "q_entries", "q_create_rank", "q_deserved",
              "q_alloc0", "j_alloc0", "cluster_total", "dyn_weights")


def _share(alloc: torch.Tensor, denom: torch.Tensor) -> torch.Tensor:
    """max over the resource axis of alloc/denom with 0/0->0, x/0->1."""
    f32 = torch.float32
    tiny = torch.tensor(1e-30, dtype=f32, device=alloc.device)
    frac = torch.where(denom == 0,
                       torch.where(alloc == 0, 0.0, 1.0).to(f32),
                       alloc / torch.maximum(denom, tiny))
    return torch.amax(frac, dim=-1)


def _lex_argmin(keys, valid: torch.Tensor) -> int:
    """Index of the lexicographically-smallest row among valid ones; -1 if
    none. keys: list of [M] float32 tensors, most-significant first."""
    mask = valid
    for k in keys:
        kmin = torch.where(mask, k, _BIG).amin()
        mask = mask & (k == kmin)
    if not bool(mask.any()):
        return -1
    return int(mask.to(torch.uint8).argmax())


def unpack_host_block(host_block):
    """Decode the packed host block into (task_state, task_node, task_seq,
    iters, telemetry[TELEM_WIDTH]) — works on numpy arrays and tensors."""
    core = host_block[:, :-TELEM_WIDTH]
    task_state, task_node, task_seq = core[:, :-1]
    return (task_state, task_node, task_seq, core[0, -1],
            host_block[0, -TELEM_WIDTH:])


def fused_allocate_plain(
        idle, releasing, backfilled, allocatable_cm, nz_req0, max_task_num,
        n_tasks, node_ok,
        resreq, init_resreq, task_nz, task_job, task_rank, task_sig,
        task_valid, sig_scores, sig_pred,
        min_available, order_min_available, init_allocated, job_queue,
        job_priority, job_create_rank, job_valid,
        q_weight, q_entries, q_create_rank, q_deserved, q_alloc0,
        j_alloc0, cluster_total, dyn_weights=None, *,
        job_keys: Tuple[str, ...] = (K_PRIORITY, K_GANG_READY, K_DRF_SHARE),
        queue_keys: Tuple[str, ...] = (K_PROP_SHARE,),
        gang_enabled: bool = True, prop_overused: bool = True,
        dyn_enabled: bool = False, max_iters: int = 0,
        narrow: bool = False, narrow_gate: bool = False):
    """The fused allocate loop in plain PyTorch, on the inputs' device.
    ``narrow`` and ``narrow_gate`` set only the telemetry words
    (kernels/narrow.py); the score matrix is read at float32."""
    dev = idle.device
    f32, i32 = torch.float32, torch.int32
    if dyn_weights is None:
        dyn_weights = torch.zeros(2, dtype=f32, device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    idle = idle.clone()
    releasing = releasing.clone()
    n_tasks = n_tasks.clone()
    nz = nz_req0.clone()
    entries = q_entries.to(i32).clone()
    q_alloc = q_alloc0.clone()
    j_alloc = j_alloc0.clone()
    alloc_cnt = init_allocated.to(i32).clone()
    job_in_pq = job_valid.clone()
    t = task_valid.shape[0]
    task_state = torch.full((t,), SKIP, dtype=i32, device=dev)
    task_node = torch.full((t,), -1, dtype=i32, device=dev)
    task_seq = torch.full((t,), _INT32_MAX, dtype=i32, device=dev)
    q_rank_f = q_create_rank.to(f32)
    j_rank_f = job_create_rank.to(f32)
    t_rank_f = task_rank.to(f32)
    neg_prio = -job_priority.to(f32)
    current, seq, it = -1, 0, 0

    while it < max_iters and (current >= 0 or bool((entries > 0).any())):
        # ---- queue + job selection (only when no visit is resumed) -------
        if current >= 0:
            j_star = current
        else:
            qkeys = [_share(q_alloc, q_deserved) for k in queue_keys
                     if k == K_PROP_SHARE]
            q_star = _lex_argmin(qkeys + [q_rank_f], entries > 0)
            have_q = q_star >= 0
            qi = max(q_star, 0)
            overused = prop_overused and bool(
                (q_deserved[qi] < q_alloc[qi] + eps).all())
            j_sel = -1
            if have_q and not overused:
                jkeys = []
                for k in job_keys:
                    if k == K_PRIORITY:
                        jkeys.append(neg_prio)
                    elif k == K_GANG_READY:
                        jkeys.append((alloc_cnt >= order_min_available)
                                     .to(f32))
                    elif k == K_DRF_SHARE:
                        jkeys.append(_share(j_alloc, cluster_total[None, :]))
                jkeys.append(j_rank_f)
                j_sel = _lex_argmin(
                    jkeys, job_valid & job_in_pq & (job_queue == qi))
            # the popped queue is overused or has no job: entry consumed
            if have_q and (overused or j_sel < 0):
                entries[qi] -= 1
            j_star = j_sel

        # ---- task selection ---------------------------------------------
        t_star = -1
        if j_star >= 0:
            t_star = _lex_argmin(
                [t_rank_f],
                task_valid & (task_state == SKIP) & (task_job == j_star))
        if t_star < 0:
            # no job, or a job with no pending task left (dropped)
            if j_star >= 0:
                job_in_pq[j_star] = False
            current = -1
            it += 1
            continue

        # ---- node solve for t* ------------------------------------------
        ti, ji = t_star, j_star
        t_req = resreq[ti]
        t_init = init_resreq[ti]
        sig = int(task_sig[ti])
        accessible = idle + backfilled
        room = n_tasks < max_task_num
        pred = node_ok & room & sig_pred[sig]
        fit_alloc = (t_init <= accessible + eps).all(dim=-1)
        fit_idle = (t_init <= idle + eps).all(dim=-1)
        fit_pipe = (t_init <= releasing + eps).all(dim=-1)
        eligible = pred & (fit_alloc | fit_pipe)
        score = sig_scores[sig]
        if dyn_enabled:
            score = score + dynamic_node_score_plain(
                nz, task_nz[ti], allocatable_cm, dyn_weights)
        masked = torch.where(eligible, score, -torch.inf)
        best = int(masked.argmax())

        if bool(eligible[best]):
            is_alloc = bool(fit_alloc[best])
            over_backfill = is_alloc and not bool(fit_idle[best])
            task_state[ti] = (PIPELINE if not is_alloc
                              else ALLOC_OB if over_backfill else ALLOC)
            task_node[ti] = best
            task_seq[ti] = seq
            if is_alloc:
                idle[best] = idle[best] - t_req
            else:
                releasing[best] = releasing[best] - t_req
            n_tasks[best] += 1
            nz[best] = nz[best] + task_nz[ti]
            jqi = int(job_queue[ji])
            q_alloc[jqi] = q_alloc[jqi] + t_req
            j_alloc[ji] = j_alloc[ji] + t_req
            if not over_backfill:
                alloc_cnt[ji] += 1
            ready_after = (not gang_enabled
                           or bool(alloc_cnt[ji] >= min_available[ji]))
            current = -1 if ready_after else ji
        else:
            task_state[ti] = FAIL
            task_seq[ti] = seq
            job_in_pq[ji] = False       # job dropped this cycle
            current = -1
        seq += 1
        it += 1

    frame = decision_frame(ENGINE_FUSED, task_state, task_seq, task_valid,
                           waves=it, stride=max(int(max_iters), 1),
                           narrow=narrow, narrow_gate=narrow_gate)
    host_block = torch.cat([
        torch.stack([task_state, task_node, task_seq]),
        torch.full((3, 1), it, dtype=i32, device=dev),
        frame[None, :].expand(3, TELEM_WIDTH)], dim=1)
    return host_block, idle, releasing, n_tasks, nz


_BOOL_ARGS = {"node_ok", "task_valid", "sig_pred", "job_valid"}
_I32_ARGS = {"max_task_num", "n_tasks", "task_job", "task_rank", "task_sig",
             "min_available", "order_min_available", "init_allocated",
             "job_queue", "job_create_rank", "q_entries", "q_create_rank"}


def arg_dtype(name: str) -> torch.dtype:
    """The dtype fused_allocate takes for argument ``name``."""
    return (torch.bool if name in _BOOL_ARGS
            else torch.int32 if name in _I32_ARGS else torch.float32)


def fused_allocate(*args, **kwargs):
    """The fused allocate solve on the inputs' device: the CUDA kernel for
    CUDA tensors, :func:`fused_allocate_plain` for CPU tensors. Same
    arguments and results as :func:`fused_allocate_plain`."""
    names = NODE_ARGS + CYCLE_ARGS
    statics = {k: kwargs.pop(k) for k in list(kwargs) if k not in names}
    bound = dict(zip(names, args))
    bound.update(kwargs)
    if bound.get("dyn_weights") is None:
        bound["dyn_weights"] = torch.zeros(2, dtype=torch.float32,
                                           device=bound["idle"].device)
    missing = [n for n in names if n not in bound]
    if missing:
        raise TypeError(f"fused_allocate: missing arguments {missing}")
    devs = {bound[n].device.type for n in names}
    if devs == {"cpu"}:
        return fused_allocate_plain(*(bound[n] for n in names), **statics)
    if devs != {"cuda"}:
        raise ValueError(f"fused_allocate: inputs on mixed devices {devs}")
    return _fused_allocate_cuda(bound, **statics)


def check_args(a, lead: Tuple[int, ...] = ()):
    """Validate the bound arguments ``a`` (name -> tensor) of a kernel
    launch: each with the dtype fused_allocate takes and its shape behind
    the leading dimensions ``lead`` (the lane axis of a stacked mega
    solve). Returns (n, t, j, q, s)."""
    k = len(lead)
    for name, t in a.items():
        want = arg_dtype(name)
        if t.dtype != want:
            raise ValueError(f"fused_allocate: {name} must be {want}, got "
                             f"{t.dtype}")
    n = a["idle"].shape[k]
    t = a["task_valid"].shape[k]
    j = a["job_valid"].shape[k]
    q = a["q_entries"].shape[k]
    s = a["sig_scores"].shape[k]
    shapes = {"idle": (n, 3), "releasing": (n, 3), "backfilled": (n, 3),
              "allocatable_cm": (n, 2), "nz_req0": (n, 2),
              "max_task_num": (n,), "n_tasks": (n,), "node_ok": (n,),
              "resreq": (t, 3), "init_resreq": (t, 3), "task_nz": (t, 2),
              "task_job": (t,), "task_rank": (t,), "task_sig": (t,),
              "task_valid": (t,), "sig_scores": (s, n), "sig_pred": (s, n),
              "min_available": (j,), "order_min_available": (j,),
              "init_allocated": (j,), "job_queue": (j,),
              "job_priority": (j,), "job_create_rank": (j,),
              "job_valid": (j,), "q_entries": (q,),
              "q_create_rank": (q,), "q_deserved": (q, 3),
              "q_alloc0": (q, 3), "j_alloc0": (j, 3),
              "cluster_total": (3,), "dyn_weights": (2,)}
    for name, shape in shapes.items():
        if tuple(a[name].shape) != tuple(lead) + shape:
            raise ValueError(f"fused_allocate: {name} must have shape "
                             f"{tuple(lead) + shape}, got "
                             f"{tuple(a[name].shape)}")
    return n, t, j, q, s


def key_codes(job_keys, queue_keys):
    """The kernel's job-key codes (padded to three) for these order keys;
    raises for keys it does not carry."""
    if len(job_keys) > 3 or any(k not in JOB_KEY_CODES for k in job_keys):
        raise ValueError(f"fused_allocate: unsupported job keys {job_keys}")
    if len(queue_keys) > 1 or any(k != K_PROP_SHARE for k in queue_keys):
        raise ValueError(f"fused_allocate: unsupported queue keys "
                         f"{queue_keys}")
    return [JOB_KEY_CODES[k] for k in job_keys] + [0] * (3 - len(job_keys))


#: phases timed by CTA 0's thread 0 of the (first) problem on the global
#: timer (csrc/fused_body.cuh), then its counters: loop passes, node
#: solves, job-less runs and the iterations they consumed
FUSED_PHASES = ("prologue", "top", "job_pick", "task_pick", "node_pass",
                "exchange", "update", "epilogue")
FUSED_COUNTS = ("passes", "solves", "runs", "run_iters")
#: the kernels' state groups, each in shared memory when it fits
FUSED_GROUPS = ("node_carries", "node_inputs", "queues", "job_pick",
                "job_updates")
#: CTAs a problem; 0 lets the kernel choose (fused_allocate by the node
#: count, mega_fused by the lane count and the clusters the card keeps
#: resident)
CLUSTER = 0
#: threads a CTA (csrc/fused_body.cuh NT)
FUSED_THREADS = 512
#: the phase timers run when True (the main path keeps them on)
PHASE_TIMERS = True
#: the last launch's shape and phase timers (``phase_ns``: an int64 tensor
#: on the card, FUSED_PHASES then FUSED_COUNTS)
last_launch: dict = {}
_shapes: dict = {}


def launch_shape(n: int, t: int, j: int, q: int, lanes=None) -> dict:
    """The cluster shape the kernel takes for ``lanes`` problems (None:
    ``fused_allocate``'s one) of n nodes, t tasks, j jobs and q queues."""
    key = (n, t, j, q, lanes, CLUSTER)
    if key not in _shapes:
        info = (ctypes.c_int * 11)()
        if lanes is None:
            err = _build.library("fused_allocate.cu").kb_fused_shape(
                n, t, j, q, CLUSTER, info)
        else:
            err = _build.library("mega_fused.cu").kb_mega_shape(
                n, t, j, q, lanes, CLUSTER, info)
        _build.check_launch("fused shape", err)
        _shapes[key] = {
            "cluster": info[0], "nodes_per_cta": info[1],
            "shared": {g: bool(info[2 + k])
                       for k, g in enumerate(FUSED_GROUPS)},
            "smem_bytes": info[7], "ws_bytes": info[8],
            "resident_clusters": info[9], "waves": info[10]}
    return _shapes[key]


#: the pointer arguments of kb_fused_allocate / kb_mega_fused after the
#: four node carries, in order
KERNEL_INPUTS = (
    "backfilled", "allocatable_cm", "max_task_num", "node_ok",
    "resreq", "init_resreq", "task_nz", "task_job", "task_rank",
    "task_sig", "task_valid", "sig_scores", "sig_pred",
    "min_available", "order_min_available", "init_allocated",
    "job_queue", "job_priority", "job_create_rank", "job_valid",
    "q_entries", "q_create_rank", "q_deserved", "q_alloc0",
    "j_alloc0", "cluster_total", "dyn_weights")


def _fused_allocate_cuda(a, *, job_keys=(K_PRIORITY, K_GANG_READY,
                                         K_DRF_SHARE),
                         queue_keys=(K_PROP_SHARE,), gang_enabled=True,
                         prop_overused=True, dyn_enabled=False, max_iters=0,
                         narrow=False, narrow_gate=False, lanes=None):
    """One launch of the fused loop on the bound CUDA arguments ``a``:
    ``csrc/fused_allocate.cu`` on one problem (``lanes`` None), or
    ``csrc/mega_fused.cu`` on ``lanes`` problems stacked over a leading
    axis, one cluster each. Results as fused_allocate's, stacked over the
    lanes when there are lanes."""
    lead = () if lanes is None else (lanes,)
    if lead and lanes < 1:
        raise ValueError("mega_fused: no lanes")
    n, t, j, q, s = check_args(a, lead)
    codes = key_codes(job_keys, queue_keys)
    dev = a["idle"].device
    c = {k: v.contiguous() for k, v in a.items()}
    # node carries live in the outputs (the JAX kernel returns new arrays)
    idle = c["idle"].clone()
    releasing = c["releasing"].clone()
    n_tasks = c["n_tasks"].clone()
    nz = c["nz_req0"].clone()
    b = lanes or 1
    shape = launch_shape(n, t, j, q, lanes)
    host_block = torch.empty(lead + (3, t + 1 + TELEM_WIDTH),
                             dtype=torch.int32, device=dev)
    ws = torch.empty(b * shape["ws_bytes"], dtype=torch.uint8, device=dev)
    phase_ns = torch.empty(len(FUSED_PHASES) + len(FUSED_COUNTS),
                           dtype=torch.int64, device=dev)
    eps = torch.from_numpy(VEC_EPS).to(dev)
    args = (idle.data_ptr(), releasing.data_ptr(), n_tasks.data_ptr(),
            nz.data_ptr(), *(c[k].data_ptr() for k in KERNEL_INPUTS),
            eps.data_ptr(), ws.data_ptr(),
            phase_ns.data_ptr() if PHASE_TIMERS else None,
            host_block.data_ptr(),
            n, t, j, q, codes[0], codes[1], codes[2], len(job_keys),
            len(queue_keys), int(bool(gang_enabled)),
            int(bool(prop_overused)), int(bool(dyn_enabled)),
            int(max_iters), int(bool(narrow)), int(bool(narrow_gate)),
            shape["cluster"])
    stream = torch.cuda.current_stream(dev).cuda_stream
    if lead:
        name = "mega_fused"
        err = _build.library("mega_fused.cu").kb_mega_fused(
            *args, b, s, stream)
    else:
        name = "fused_allocate"
        err = _build.library("fused_allocate.cu").kb_fused_allocate(
            *args, stream)
    _build.check_launch(name, err)
    _build.count_launch(name)
    last_launch.clear()
    last_launch.update(kernel=name, lanes=b, n_pad=n, t_pad=t, j_pad=j,
                       q_pad=q, threads=FUSED_THREADS, **shape,
                       phase_ns=phase_ns if PHASE_TIMERS else None)
    return host_block, idle, releasing, n_tasks, nz
