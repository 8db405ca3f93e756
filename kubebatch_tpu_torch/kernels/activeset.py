"""Active-set allocate — the steady cycle solved at churn width, with the
full-width two-level solve as a periodic audit (reference package,
kubebatch_tpu/kernels/activeset.py).

1. **Active set**: the steady cycle's pending tasks pack into the
   smallest task grain (``ACT_GRAINS``: 256 / 1,024 / 4,096) that holds
   them; a larger set declines (cold cycles run the two-level solve).
2. **Pair-level coarse pass**: tasks of one exact (sig, request) pair
   are interchangeable to the eligibility test when every member's
   ``init_resreq`` row is its pair's (a host gate checks this each
   cycle; octave-bucketed pairs decline). The pool oracle then folds
   eligibility over pairs and gathers through ``task_pair``: per-task
   results, pool choices and therefore decisions equal the two-level
   engine's (task_seq differs by the static round stride only, compared
   as (seq // stride, seq % stride)).
3. **Scatter-back**: every wave's pool folds into the persistent node
   carry, as the two-level solve's does; one launch and one counted copy
   a cycle, the frame carrying the act_* words.
4. **Audit**: every ``audit_every()``-th engaged cycle runs the combined
   solve — the active-set solve on a scratch copy of the carry and the
   full-width two-level solve on the carry, compared in the kernel —
   commits the full-width result and returns the divergence count in
   the frame's act_demoted word. A divergence, or a fired
   ``solve.activeset`` fault seam, demotes the engine for the rest of
   the process (:func:`demote`, counted; cycles run the full-width
   solve).

5. **Asynchronous twin** (runtime/pipeline.py is its only caller):
   :func:`solve_cycle_async` has :func:`solve_cycle`'s gates, seam,
   cadence and counters, but returns a :class:`PendingSolve` with the
   result still on the device; the next cycle's ``consume`` pays the one
   deferred readback. Its steady launch is :func:`activeset_packed_inplace`
   (the reference's donated ``_activeset_packed_donated``): the kernel
   writes the next carry into the DeviceSession's own arrays, after
   :func:`carry_shadow` copied them into a second slot the session keeps
   (allocated once), which ``restore_carry`` swaps back when the consume
   invalidates the result. The audit's launch stays the cloning one, as
   in the reference.

The wave loop is kernels/hier.py's (:func:`activeset_allocate` names it
with the pair fold); the CUDA kernel is csrc/hier_allocate.cu in its
active-set and audit modes.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..faults import armed as _faults_armed
from ..faults import should_fail as _should_fail
from ..metrics import (count_activeset_audit, count_activeset_cycle,
                       count_activeset_demotion)
from .batched import (CYCLE_ARGS, NODE_ARGS, _PACK_BOOL, _PACK_F32,
                      _PACK_I32, CycleArrays, RoundState)
from .fused import (ALLOC, ALLOC_OB, K_DRF_SHARE, K_GANG_READY,
                    K_PRIORITY, K_PROP_SHARE, PIPELINE)
from .hier import (MODE_ACT, MODE_AUDIT, _coarse_pass, bind_args,
                   check_plain_args, consume_solve, device_of,
                   dispatch_solve, hier_allocate, hier_pool_size, launch,
                   pack_result, prepare_hier, run_solve, solve_opts,
                   state_arrays)
from .telemetry import ENGINE_ACTIVESET, F_ACT_DEMOTED, decision_frame

log = logging.getLogger("kubebatch.activeset")

#: the task grains: the active set pads to the smallest that holds it
ACT_GRAINS = (256, 1024, 4096)

#: the task-axis CycleInputs attributes sliced / padded to the grain
_TASK_AXIS = ("resreq", "init_resreq", "task_nz", "task_job", "task_rank",
              "task_sig", "task_valid")

#: the active-set float pack adds the per-pair request representatives
_ACT_PACK_F32 = _PACK_F32 + ("pair_init_resreq",)

#: the active-set solve's arguments: the batched solve's and pair_init
ACT_ARGS = NODE_ARGS + CYCLE_ARGS + ("pair_init",)

DEFAULT_AUDIT_EVERY = 16

_JOB_KEYS = (K_PRIORITY, K_GANG_READY, K_DRF_SHARE)
_QUEUE_KEYS = (K_PROP_SHARE,)


def activeset_grain(n_real: int) -> int:
    """The smallest grain holding ``n_real`` active tasks; 0 when the set
    outgrows the largest (the engine declines)."""
    for g in ACT_GRAINS:
        if n_real <= g:
            return g
    return 0


# ---- engine state: the audit cadence and the demotion rung (process-wide,
#      like the event fold's; restart or reset() to re-enable) -------------

_audit_every = DEFAULT_AUDIT_EVERY
_cycle_idx = 0
_demoted = False


def audit_every() -> int:
    return _audit_every


def set_audit_every(n: int) -> None:
    """The audit cadence: every n-th engaged cycle runs the combined
    full-width comparison (0 disables audits). The scheduler loop's
    ``solve_audit_every`` (the reference's KUBEBATCH_SOLVE_AUDIT_EVERY)
    lands here."""
    global _audit_every
    _audit_every = max(0, int(n))


def demoted() -> bool:
    return _demoted


def demote(reason: str) -> None:
    """Disable the active-set engine for the rest of the process (an
    audit divergence or a fired ``solve.activeset`` seam): counted and
    logged and dumped by an armed flight recorder, never raised into the
    loop. Idempotent."""
    global _demoted
    if _demoted:
        return
    _demoted = True
    count_activeset_demotion(reason)
    log.error("active-set solve DEMOTED to full-width (reason=%s): steady "
              "cycles fall back to the two-level engine", reason)
    from ..obs import flight
    flight.dump(f"activeset_demotion-{reason}")


def reset() -> None:
    """Forget the demotion and restart the cadence (its period stays)."""
    global _cycle_idx, _demoted
    _cycle_idx = 0
    _demoted = False


# ---- the pair-level wave loop, plain --------------------------------------

def _pair_coarse(state: RoundState, a: CycleArrays, pair_init, pool: int,
                 pipe_enabled: bool, dyn_enabled: bool, stats=None):
    """The two-level pool oracle folded over pairs (reference
    ``_pair_coarse``): (task_pool_elig [T,B], pool_best [B])."""
    return _coarse_pass(state, a, pool, pipe_enabled, dyn_enabled,
                        pair_init, stats)


def activeset_allocate(state: RoundState, a: CycleArrays, pair_init, opts,
                       max_rounds: int, pool: int, max_waves: int = 0,
                       gang_enabled: bool = True, stats=None):
    """The whole active-set cycle (reference ``activeset_allocate``): the
    two-level wave loop at grain width with the pair fold. Returns
    hier_allocate's tuple, ``blocks`` (pool solves folded back) last."""
    return hier_allocate(state, a, opts, max_rounds, pool, max_waves,
                         gang_enabled, pair_init=pair_init, stats=stats)


def _act_frame(final, rounds, retries, stranded, occ, fill, task_valid,
               stride, narrow, narrow_gate, act_valid, act_occ, act_blocks,
               pool, demoted_words):
    return decision_frame(
        ENGINE_ACTIVESET, final.task_state, final.task_seq, task_valid,
        waves=rounds, stride=stride, narrow=narrow, narrow_gate=narrow_gate,
        retries=retries, stranded=stranded, pool_occ=occ, bucket_fill=fill,
        act_tasks=int(act_valid.sum()), act_nodes=act_occ * pool,
        act_scatter=act_blocks * pool, act_demoted=demoted_words)


def activeset_allocate_plain(*args, job_keys=_JOB_KEYS,
                             queue_keys=_QUEUE_KEYS,
                             prop_overused=True, dyn_enabled=False,
                             pipe_enabled=True, max_rounds=64, pool_size=0,
                             max_waves=0, gang_enabled=True, narrow=False,
                             narrow_gate=False, stats=None, **kwargs):
    """The active-set cycle in plain PyTorch on CPU tensors (the
    reference's ``_activeset_packed``): :func:`hier_allocate_plain`'s
    arguments (at grain width) and ``pair_init`` [P,R]; the same
    results, the frame's engine and act_* words the active set's."""
    bound, _ = bind_args("activeset_allocate_plain", args, kwargs, ACT_ARGS)
    check_plain_args("activeset_allocate_plain", bound)
    opts = solve_opts(job_keys, queue_keys, prop_overused, dyn_enabled,
                      pipe_enabled)
    state, a = state_arrays(bound)
    pool = hier_pool_size(bound["idle"].shape[0], pool_size)
    final, rounds, retries, stranded, occ, fill, blocks = activeset_allocate(
        state, a, bound["pair_init"], opts, int(max_rounds), pool,
        int(max_waves), bool(gang_enabled), stats)
    valid = bound["task_valid"]
    frame = _act_frame(final, rounds, retries, stranded, occ, fill, valid,
                       valid.shape[0], narrow, narrow_gate, valid, occ,
                       blocks, pool, 0)
    return (pack_result(final, rounds, frame), final.idle, final.releasing,
            final.n_tasks, final.nz_req)


def _divergence(afinal: RoundState, grain: int, ffinal: RoundState,
                t_full: int, valid) -> int:
    """Decision comparison over the rows both solves carry (every real
    task lives below both widths); task_seq is round * stride + rank with
    each solve's own stride, so equality is on (round, rank)."""
    m = min(grain, t_full)
    sa, na, qa = (afinal.task_state[:m], afinal.task_node[:m],
                  afinal.task_seq[:m])
    sf, nf, qf = (ffinal.task_state[:m], ffinal.task_node[:m],
                  ffinal.task_seq[:m])
    div = sa != sf
    placed = (sf == ALLOC) | (sf == ALLOC_OB) | (sf == PIPELINE)
    both = placed & (sa == sf)
    div |= both & (na != nf)
    div |= both & (torch.div(qa, grain, rounding_mode="floor")
                   != torch.div(qf, t_full, rounding_mode="floor"))
    div |= both & (qa % grain != qf % t_full)
    return int((valid[:m] & div).sum())


def activeset_audit_plain(node: Dict[str, torch.Tensor],
                          act: Dict[str, torch.Tensor],
                          full: Dict[str, torch.Tensor], *,
                          job_keys=_JOB_KEYS, queue_keys=_QUEUE_KEYS,
                          prop_overused=True,
                          dyn_enabled=False, pipe_enabled=True,
                          amax_rounds=64, max_rounds=64, pool_size=0,
                          max_waves=0, gang_enabled=True, narrow=False,
                          narrow_gate=False, stats=None):
    """The audit cycle in plain PyTorch on CPU tensors (the reference's
    ``_activeset_audit_packed``): the active-set solve of ``act``
    (CYCLE_ARGS at grain width and ``pair_init``) and the two-level solve
    of ``full`` (CYCLE_ARGS) from the same node carry ``node``
    (NODE_ARGS). Returns the full-width solve's (packed, idle, releasing,
    n_tasks, nz_req); the frame's act_demoted word is the divergence."""
    check_plain_args("activeset_audit_plain", {**node, **act, **full})
    opts = solve_opts(job_keys, queue_keys, prop_overused, dyn_enabled,
                      pipe_enabled)
    pool = hier_pool_size(node["idle"].shape[0], pool_size)
    astate, aa = state_arrays({**node, **act})
    afinal, _, _, _, aocc, _, ablocks = activeset_allocate(
        astate, aa, act["pair_init"], opts, int(amax_rounds), pool,
        int(max_waves), bool(gang_enabled), stats)
    fstate, fa = state_arrays({**node, **full})
    ffinal, rounds, retries, stranded, occ, fill, _ = hier_allocate(
        fstate, fa, opts, int(max_rounds), pool, int(max_waves),
        bool(gang_enabled), stats=stats)
    grain = act["task_valid"].shape[0]
    t_full = full["task_valid"].shape[0]
    div = _divergence(afinal, grain, ffinal, t_full, act["task_valid"])
    frame = _act_frame(ffinal, rounds, retries, stranded, occ, fill,
                       full["task_valid"], t_full, narrow, narrow_gate,
                       act["task_valid"], aocc, ablocks, pool, div)
    return (pack_result(ffinal, rounds, frame), ffinal.idle,
            ffinal.releasing, ffinal.n_tasks, ffinal.nz_req)


# ---- dispatchers ---------------------------------------------------------------

def activeset_packed(*args, **kwargs):
    """The active-set cycle on the inputs' device: the CUDA kernel
    (csrc/hier_allocate.cu, active-set mode) for CUDA tensors,
    :func:`activeset_allocate_plain` for CPU tensors."""
    bound, statics = bind_args("activeset_packed", args, kwargs, ACT_ARGS)
    if device_of("activeset_packed", bound) == "cpu":
        return activeset_allocate_plain(**bound, **statics)
    statics.pop("stats", None)
    return launch(MODE_ACT, {k: bound[k] for k in NODE_ARGS},
                  {k: bound[k] for k in CYCLE_ARGS}, None,
                  bound["pair_init"], **statics)


def activeset_packed_inplace(*args, **kwargs):
    """:func:`activeset_packed` writing the committed node carry into the
    carry tensors it was given (the reference's donated twin
    ``_activeset_packed_donated``): the CUDA kernel in place for CUDA
    tensors (``launch(in_place=True)``, which raises rather than clone);
    for CPU tensors :func:`activeset_allocate_plain`, its carry copied
    into the given tensors. Returns activeset_packed's tuple, the carry
    being the given tensors."""
    bound, statics = bind_args("activeset_packed_inplace", args, kwargs,
                               ACT_ARGS)
    if device_of("activeset_packed_inplace", bound) == "cpu":
        packed, *carry = activeset_allocate_plain(**bound, **statics)
        for k, v in zip(NODE_ARGS[:4], carry):
            bound[k].copy_(v)
        return (packed, *(bound[k] for k in NODE_ARGS[:4]))
    statics.pop("stats", None)
    return launch(MODE_ACT, {k: bound[k] for k in NODE_ARGS},
                  {k: bound[k] for k in CYCLE_ARGS}, None,
                  bound["pair_init"], in_place=True, **statics)


def activeset_audit_packed(node, act, full, **statics):
    """The audit cycle on the inputs' device: the CUDA kernel (audit
    mode) for CUDA tensors, :func:`activeset_audit_plain` for CPU
    tensors. Same arguments and results as the plain version."""
    if device_of("activeset_audit_packed", node, act, full) == "cpu":
        return activeset_audit_plain(node, act, full, **statics)
    statics.pop("stats", None)
    act = dict(act)
    pair_init = act.pop("pair_init")
    return launch(MODE_AUDIT, node, full, act, pair_init, **statics)


# ---- the host side -----------------------------------------------------------

def _regrain(arr, grain: int) -> np.ndarray:
    arr = np.asarray(arr)
    t = arr.shape[0]
    if t == grain:
        return arr
    if t > grain:
        # real tasks occupy rows [:n_real]; the slice drops padding only
        return arr[:grain]
    return np.pad(arr, [(0, grain - t)] + [(0, 0)] * (arr.ndim - 1))


def _pair_init_rows(inputs, task_pair, pair_sig) -> Optional[np.ndarray]:
    """Per-pair init_resreq representatives [P_pad, R], or None when some
    pair's members differ bit for bit (the pair fold would not equal the
    per-task test: the engine declines). Padding pairs keep zero rows."""
    n_real = inputs.n_tasks_real
    init = np.asarray(inputs.init_resreq)[:n_real]
    p_pad = int(np.asarray(pair_sig).shape[0])
    out = np.zeros((p_pad, init.shape[1] if init.ndim == 2 else 0),
                   init.dtype if init.size else np.float32)
    if n_real == 0:
        return out
    tp = np.asarray(task_pair)[:n_real]
    uniq, first = np.unique(tp, return_index=True)
    rep = init[first]
    if not np.array_equal(rep[np.searchsorted(uniq, tp)], init):
        return None
    out[uniq] = rep
    return out


def _upload(inputs, get, f32_names) -> Dict[str, torch.Tensor]:
    from .pack import pack_inputs, unpack

    bufs = pack_inputs(get, f32_names, _PACK_I32, _PACK_BOOL)
    out: Dict[str, torch.Tensor] = {}
    for buf, lay in zip(bufs[0::2], bufs[1::2]):
        out.update(unpack(torch.from_numpy(buf).to(inputs.device.device),
                          lay))
    return out


def prepare_activeset(inputs, grain: int = 0, pool_size: int = 0):
    """The (args, statics, grain) of the active-set solve for these
    CycleInputs, or None when the engine declines: an affinity cycle, an
    active set past the largest grain, inexact (octave-bucketed) pairs,
    or a pair whose members' init_resreq rows differ. ``grain`` forces a
    grain."""
    from .narrow import narrow_enabled

    if inputs.affinity is not None:
        return None
    n_real = inputs.n_tasks_real
    g = grain if grain > 0 else activeset_grain(n_real)
    if g <= 0 or n_real > g:
        return None
    task_pair, pair_sig, pair_nz, exact = inputs.pair_terms()
    if not exact:
        return None
    pair_init = _pair_init_rows(inputs, task_pair, pair_sig)
    if pair_init is None:
        return None
    override = {n: _regrain(getattr(inputs, n), g) for n in _TASK_AXIS}
    override.update(task_pair=_regrain(task_pair, g), pair_sig=pair_sig,
                    pair_nz=pair_nz, pair_init_resreq=pair_init)
    device = inputs.device
    args = {k: getattr(device, k) for k in NODE_ARGS}
    args.update(_upload(inputs, lambda n: override[n] if n in override
                        else getattr(inputs, n), _ACT_PACK_F32))
    args["pair_init"] = args.pop("pair_init_resreq")
    t_full = inputs.task_valid.shape[0]
    n_pad = int(device.node_ok.shape[0])
    # narrow by the full [T, N] problem, as the full-width twin does
    narrow = narrow_enabled(
        n_pad, t_full, static_scores=inputs.sig_scores,
        dyn_weights=(inputs.dyn_weights if inputs.dyn_enabled else None))
    statics = dict(
        job_keys=inputs.job_keys, queue_keys=inputs.queue_keys,
        prop_overused=inputs.prop_overused,
        dyn_enabled=inputs.dyn_enabled, pipe_enabled=inputs.pipe_enabled,
        max_rounds=min(g + 8, 4096),
        pool_size=hier_pool_size(n_pad, pool_size),
        gang_enabled=inputs.gang_enabled, narrow=narrow,
        narrow_gate=(not narrow and narrow_enabled(n_pad, t_full)))
    return args, statics, g


def prepare_activeset_audit(inputs, grain: int = 0, pool_size: int = 0):
    """(node, act, full, statics, grain) of the audit: the active-set
    plan joined with prepare_hier's full-width plan (the node arrays
    shared); None whenever the active-set plan is."""
    plan = prepare_activeset(inputs, grain=grain, pool_size=pool_size)
    if plan is None:
        return None
    aargs, astatics, g = plan
    fargs, fstatics = prepare_hier(inputs, pool_size=astatics["pool_size"])
    node = {k: fargs[k] for k in NODE_ARGS}
    act = {k: aargs[k] for k in CYCLE_ARGS + ("pair_init",)}
    full = {k: fargs[k] for k in CYCLE_ARGS}
    statics = dict(fstatics, amax_rounds=astatics["max_rounds"])
    return node, act, full, statics, g


def solve_activeset(inputs, plan=None, phases=None):
    """The steady active-set cycle: (task_state, task_node, task_seq,
    rounds, telemetry) at grain width (every real task row lives below
    the grain), or None when the engine declines. One counted copy; the
    node carry committed."""
    if plan is None:
        plan = prepare_activeset(inputs)
    if plan is None:
        return None
    args, statics, g = plan
    return run_solve(inputs.device, g,
                     lambda: activeset_packed(**args, **statics), phases,
                     name="activeset_allocate")


def solve_activeset_audit(inputs, plan=None, phases=None):
    """The audit cycle: the full-width solve's (task_state, task_node,
    task_seq, rounds, telemetry) and the divergence (the frame's
    act_demoted word), or None when the engine declines."""
    if plan is None:
        plan = prepare_activeset_audit(inputs)
    if plan is None:
        return None
    node, act, full, statics, _ = plan
    res = run_solve(inputs.device, inputs.task_valid.shape[0],
                    lambda: activeset_audit_packed(node, act, full,
                                                   **statics), phases,
                    name="activeset_audit")
    return res + (int(res[4][F_ACT_DEMOTED]),)


def solve_cycle(inputs, phases=None):
    """The action layer's entry: None when the engine declines (demoted,
    an oversize active set, inexact pairs, affinity) or its fault seam
    fires (which demotes) — the caller runs the full-width solve — else
    the cycle's (task_state, task_node, task_seq, rounds, telemetry),
    with the audit on its cadence."""
    global _cycle_idx
    if _demoted:
        return None
    t0 = time.perf_counter()
    plan = prepare_activeset(inputs)
    if plan is None:
        return None
    if _faults_armed() and _should_fail("solve.activeset"):
        # demote, not raise: this cycle runs on the full-width engine,
        # and so does every later one
        demote("fault")
        return None
    idx = _cycle_idx
    _cycle_idx += 1
    n = audit_every()
    audit = n > 0 and idx % n == 0
    count_activeset_cycle(audit)
    if not audit:
        if phases is not None:
            phases["upload"] = (time.perf_counter() - t0) * 1e3
        return solve_activeset(inputs, plan=plan, phases=phases)
    aplan = prepare_activeset_audit(inputs)
    if phases is not None:
        phases["upload"] = (time.perf_counter() - t0) * 1e3
    *res, div = solve_activeset_audit(inputs, plan=aplan, phases=phases)
    count_activeset_audit(div == 0)
    if div:
        demote("audit")
    return tuple(res)


# ---- the asynchronous twin (runtime/pipeline.py) -----------------------------

def carry_shadow(device):
    """Copy the node carry into the DeviceSession's second slot before a
    pipelined dispatch writes it (the slot is allocated once and reused;
    on the card a device-to-device copy on the stream) and return the
    slot: the pre-dispatch carry that ``PendingSolve.restore_carry``
    swaps back."""
    carry = (device.idle, device.releasing, device.n_tasks, device.nz_req)
    slot = device.carry_slot
    if slot is None or any(
            s.shape != c.shape or s.dtype != c.dtype or s.device != c.device
            for s, c in zip(slot, carry)):
        slot = device.carry_slot = tuple(torch.empty_like(c) for c in carry)
    for s, c in zip(slot, carry):
        s.copy_(c)
    return slot


class PendingSolve:
    """A dispatched, unread active-set solve. Its carry was committed at
    dispatch (the next cycle's inputs chain on it on the stream);
    :meth:`consume` pays the one deferred readback and returns the
    decisions, :meth:`restore_carry` puts the pre-dispatch carry back
    when the consume-time check invalidates them."""

    __slots__ = ("solve", "audit", "shadow", "device")

    def __init__(self, solve, audit: bool, shadow, device):
        self.solve = solve
        self.audit = audit
        self.shadow = shadow
        self.device = device

    def consume(self, sp=None, phases=None):
        """Wait for the result (usually landed: the host ran a whole
        cycle meanwhile) and decode it: solve_cycle's tuple, the frame
        recorded on ``sp``. An audit's comparison is read here: the
        committed result is the full-width solve's, so it replays
        either way; a divergence demotes."""
        res = consume_solve(self.solve, sp, phases)
        if self.audit:
            div = int(res[4][F_ACT_DEMOTED])
            count_activeset_audit(div == 0)
            if div:
                demote("audit")
        return res

    def restore_carry(self) -> None:
        """Swap the pre-dispatch carry back in; the dispatched one
        becomes the session's second slot."""
        d = self.device
        dispatched = (d.idle, d.releasing, d.n_tasks, d.nz_req)
        d.idle, d.releasing, d.n_tasks, d.nz_req = self.shadow
        d.carry_slot = dispatched


def solve_cycle_async(inputs, phases=None) -> Optional[PendingSolve]:
    """:func:`solve_cycle`'s asynchronous twin: the same decline gates,
    fault seam, audit cadence and counters, but the dispatch returns a
    :class:`PendingSolve` without reading the result back. None when the
    engine declines (the caller runs the cycle sequentially).
    ``phases`` receives the host ms of the upload and the launch."""
    global _cycle_idx
    if _demoted:
        return None
    t0 = time.perf_counter()
    plan = prepare_activeset(inputs)
    if plan is None:
        return None
    if _faults_armed() and _should_fail("solve.activeset"):
        demote("fault")
        return None
    idx = _cycle_idx
    _cycle_idx += 1
    n = audit_every()
    audit = n > 0 and idx % n == 0
    count_activeset_cycle(audit)
    device = inputs.device
    if audit:
        # the audit stays the cloning launch, as the reference's does
        node, act, full, statics, _ = prepare_activeset_audit(inputs)
        t = inputs.task_valid.shape[0]
        name = "activeset_audit_dispatch"

        def solve():
            return activeset_audit_packed(node, act, full, **statics)
    else:
        args, statics, t = plan
        name = "activeset_dispatch"

        def solve():
            return activeset_packed_inplace(**args, **statics)
    shadow = carry_shadow(device)
    if phases is not None:
        phases["upload"] = (time.perf_counter() - t0) * 1e3
    dispatched = dispatch_solve(device, t, solve, name=name)
    if phases is not None:
        phases["launch"] = dispatched.launch_ms
    return PendingSolve(dispatched, audit, shadow, device)
