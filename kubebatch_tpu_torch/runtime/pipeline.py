"""Pipelined scheduling cycles: the solve's readback off the critical
path (ref: kubebatch_tpu/runtime/pipeline.py).

The sequential cycle is fold -> tensorize -> one launch -> one blocking
readback -> replay. The pipelined executor lets cycle N+1's host work
overlap cycle N's solve:

cycle N:   consume N-1's in-flight result (conflict check, replay), run
           the actions; allocate tensorizes and DISPATCHES the
           active-set solve for N's pending set and returns without
           reading it back; close the session.
cycle N+1: the solve runs while N's close, the events between cycles
           and N+1's snapshot and open run on the host; the consume
           then pays one DEFERRED readback (device.DeferredCopy, started
           at dispatch) and replays N's decisions into N+1's session.

Why a late replay is sound: session N closed without the in-flight
decisions, so cache truth never saw them and session N+1 still carries
every placed task as pending. The inputs hold session N's clones, so
the consume first rebases them onto session N+1's objects by uid
(actions/cycle_inputs.py ``rebase_inputs``); the replay then performs
what session N would have, one cycle later, and the binds reach cache
truth once. A placed uid that no longer resolves as pending is
staleness the conflict check missed: the rebase fails and the cycle
invalidates.

While a solve is in flight, cache events keep folding. The event fold
tags every mark into its flight window (``EventFold.begin_flight`` /
``end_flight``); the consume checks whether a flight-marked job or node
meets the decisions' footprint. Our own binds echo back through the
kubelet (a Running flip re-marks the job and node just bound), so the
footprints of the last ``ECHO_WINDOW`` commits are subtracted, except
from capacity/shape marks (``flight_caps``), which always conflict. A
conflict, or the armed ``pipeline.conflict`` seam, invalidates: the
decisions are dropped untouched (nothing was replayed), the device carry
is swapped back to its pre-dispatch copy (``PendingSolve.restore_carry``)
and the current cycle runs sequentially; its session still carries the
conflicted tasks as pending, so the ordinary solve is the re-solve.
``CONFLICT_STORM_LIMIT`` invalidations in a row demote the executor to
the sequential loop for the rest of the process (counted, flight
dumped, never raised).

Only the active-set / two-level family is pipelined (the engines with a
persistent device carry and a packed result); every other mode, a
ladder-degraded process, affinity cycles and declined solves run the
ordinary ``AllocateAction.execute``. On a CUDA cache nothing here moves
work to the CPU: a dispatch that fails raises into the guarded cycle.
"""
from __future__ import annotations

import logging
import time
from collections import deque
from typing import Dict, Optional

import numpy as np

from .. import obs as _obs
from ..faults import armed as _faults_armed
from ..faults import should_fail as _should_fail
from ..framework import CloseSession, OpenSession
from ..metrics import (count_pipeline_conflict, count_pipeline_cycle,
                       count_pipeline_demotion)

log = logging.getLogger("kubebatch.pipeline")

#: consecutive consume-time conflicts that demote the executor: at this
#: rate the overlap re-solves more cycles than it saves
CONFLICT_STORM_LIMIT = 3

#: past commits whose footprints the echo window remembers: the kubelet's
#: Running flip for a bind normally echoes within one cycle, two covers a
#: slow tick without letting real staleness hide long
ECHO_WINDOW = 2

_demoted = False


def demoted() -> bool:
    return _demoted


def demote(reason: str) -> None:
    """The sticky rung back to the sequential loop (counted, logged, an
    armed flight recorder dumps), never an exception into the loop.
    Idempotent; :func:`reset` re-enables."""
    global _demoted
    if _demoted:
        return
    _demoted = True
    count_pipeline_demotion(reason)
    log.error("pipelined executor DEMOTED to the sequential loop "
              "(reason=%s): cycles run fold -> dispatch -> blocking "
              "readback -> apply again", reason)
    try:
        from ..obs import flight as _flight
        _flight.dump(f"pipeline_demotion-{reason}")
    except Exception:             # pragma: no cover — observer bug
        log.exception("pipeline demotion flight dump failed")


def reset() -> None:
    """Forget the demotion."""
    global _demoted
    _demoted = False


class PendingCycle:
    """One in-flight solve (kernels/activeset.py ``PendingSolve``) with
    what the next cycle needs to consume it: the inputs it replays
    through and the launching cycle's epoch."""

    __slots__ = ("solve", "inputs", "epoch")

    def __init__(self, solve, inputs, epoch):
        self.solve = solve
        self.inputs = inputs
        self.epoch = epoch


class PipelinedExecutor:
    """Drives one scheduler's cycles in pipelined form; the Scheduler
    builds it for ``pipeline=True`` and hands it the session block while
    it is active. Its state is per scheduler but the demotion flag,
    which is process-wide.

    ``dispatch_phases``: host ms of the last dispatch (``tensorize``,
    ``upload``, ``launch``); ``consume_phases``: of the last consume
    (``wait``: host ms blocked on the deferred copy, ``kernel`` and
    ``copy``: device ms from CUDA events, NaN on the CPU, ``replay``)."""

    def __init__(self, scheduler):
        self.sched = scheduler
        self._pending: Optional[PendingCycle] = None
        #: (jobs, nodes) footprints of the last ECHO_WINDOW commits
        self._echo: deque = deque(maxlen=ECHO_WINDOW)
        self._streak = 0
        self.dispatch_phases: Dict[str, float] = {}
        self.consume_phases: Dict[str, float] = {}

    def active(self) -> bool:
        return not _demoted

    @property
    def pending(self) -> Optional[PendingCycle]:
        return self._pending

    def reset(self) -> None:
        """Drop in-flight state and the process-wide demotion."""
        self._pending = None
        self._echo.clear()
        self._streak = 0
        reset()

    # ------------------------------------------------------------------
    def run_once(self, snapshot=None) -> None:
        """Scheduler.run_once's session block with the previous cycle's
        in-flight result consumed first, before any action sees the
        session, and the allocate action through the asynchronous
        dispatch."""
        sched = self.sched
        jobs = nodes = None
        session_span = None
        try:
            with _obs.span("session", cat="e2e") as session_span:
                ssn = OpenSession(sched.cache, sched.tiers,
                                  sched.enable_preemption,
                                  snapshot=snapshot)
                jobs, nodes = len(ssn.jobs), len(ssn.nodes)
                try:
                    sequential = self._consume(ssn)
                    for action in sched.actions:
                        action.initialize()
                        with _obs.span(action.name, cat="action") as asp:
                            if action.name == "allocate":
                                self._allocate(ssn, action, sequential)
                            else:
                                action.execute(ssn)
                        log.debug("action %s took %.2fms", action.name,
                                  1e3 * asp.dur)
                        action.uninitialize()
                    if sched.explain_unschedulable:
                        from ..obs import explain as _explain
                        try:
                            with _obs.span("explain", cat="host"):
                                _explain.explain_session(ssn)
                        except Exception:
                            log.exception("unschedulability explainer "
                                          "failed; cycle unaffected")
                finally:
                    CloseSession(ssn)
        finally:
            if jobs is not None:
                log.info("scheduling cycle: %d jobs / %d nodes in %.2fms "
                         "(pipelined)", jobs, nodes,
                         1e3 * session_span.dur)

    def drain(self, max_cycles: int = 3) -> None:
        """Run whole cycles until nothing is in flight (an empty pending
        set dispatches nothing, so one cycle normally does), so every
        dispatched decision is applied before a caller compares state."""
        n = 0
        while self._pending is not None and n < max_cycles:
            self.sched.run_cycle()
            n += 1

    # ------------------------------------------------------------------
    # consume side
    # ------------------------------------------------------------------
    def _consume(self, ssn) -> bool:
        """Consume the previous cycle's in-flight result into ``ssn``.
        True when it was invalidated: the caller then runs this cycle
        sequentially."""
        from ..actions.cycle_inputs import rebase_inputs, replay_decisions

        pend, self._pending = self._pending, None
        if pend is None:
            return False
        fold = getattr(self.sched.cache, "fold", None)
        flight = (fold.end_flight() if fold is not None
                  else (set(), set(), set()))
        phases: Dict[str, float] = {}
        with _obs.span("consume", cat="host", epoch=pend.epoch) as sp:
            task_state, task_node, task_seq, _, _ = pend.solve.consume(
                sp, phases)
        fp_jobs, fp_nodes = self._footprint(pend.inputs, task_state,
                                            task_node)
        outcome = None
        if _faults_armed() and _should_fail("pipeline.conflict"):
            outcome = "fault"
        elif self._is_conflict(fp_jobs, fp_nodes, flight):
            outcome = "conflict"
        elif not rebase_inputs(ssn, pend.inputs, task_state):
            # a placed task no longer resolves as pending here: staleness
            # the footprint check missed (echo-masked)
            outcome = "conflict"
        if outcome is None:
            count_pipeline_cycle()
            # the ledger: binds replayed here close epoch k's records
            # inside cycle k+1, attributed to the launching epoch
            from ..obs import ledger as _ledger
            t0 = time.perf_counter()
            with _ledger.attribute(pend.epoch, deferred=True):
                replay_decisions(ssn, pend.inputs, task_state, task_node,
                                 task_seq)
            phases["replay"] = (time.perf_counter() - t0) * 1e3
            self.consume_phases = phases
            self._echo.append((fp_jobs, fp_nodes))
            self._streak = 0
            return False
        # stale: drop the decisions untouched, swap the pre-dispatch
        # carry back, and let this cycle solve sequentially
        self.consume_phases = phases
        count_pipeline_conflict(outcome)
        pend.solve.restore_carry()
        self._echo.clear()
        self._streak += 1
        log.warning("pipelined result invalidated at consume (%s; streak "
                    "%d/%d): %d jobs / %d nodes in the flight window "
                    "touched the decision footprint; re-solving this "
                    "cycle sequentially", outcome, self._streak,
                    CONFLICT_STORM_LIMIT, len(flight[0]), len(flight[1]))
        if self._streak >= CONFLICT_STORM_LIMIT:
            demote("storm")
        return True

    @staticmethod
    def _footprint(inputs, task_state, task_node):
        """(job uids, node names) the in-flight decisions bind against."""
        from ..kernels.fused import ALLOC, ALLOC_OB, PIPELINE

        n = len(inputs.tasks)
        state = np.asarray(task_state)[:n]
        placed = np.nonzero((state == ALLOC) | (state == ALLOC_OB)
                            | (state == PIPELINE))[0]
        names = inputs.device.state.names
        node_cols = np.asarray(task_node)[:n][placed]
        fp_jobs = {inputs.tasks[int(i)].job for i in placed.tolist()}
        fp_nodes = {names[int(c)] for c in node_cols.tolist()
                    if 0 <= int(c) < len(names)}
        return fp_jobs, fp_nodes

    def _is_conflict(self, fp_jobs, fp_nodes, flight) -> bool:
        """Did an event folded while the solve was in flight touch an
        entity the decisions bind against? Capacity marks always count;
        job and node marks less the echo of our own recent commits."""
        flight_jobs, flight_nodes, flight_caps = flight
        if flight_caps & fp_nodes:
            return True
        echo_jobs: set = set()
        echo_nodes: set = set()
        for ej, en in self._echo:
            echo_jobs |= ej
            echo_nodes |= en
        return bool(((flight_jobs - echo_jobs) & fp_jobs)
                    or ((flight_nodes - echo_nodes) & fp_nodes))

    # ------------------------------------------------------------------
    # dispatch side
    # ------------------------------------------------------------------
    def _allocate(self, ssn, action, sequential: bool) -> None:
        """The allocate action with the asynchronous dispatch: when the
        active-set engine may claim this cycle, tensorize, dispatch and
        return with the result in flight; otherwise (other engines, a
        degraded ladder, a declined solve, or a conflict this cycle) the
        ordinary execute."""
        from ..actions import allocate as _alloc
        from ..actions.allocate_batched import batched_supported
        from ..actions.cycle_inputs import EMPTY_CYCLE, build_cycle_inputs
        from ..faults import check as _fault_check
        from ..kernels import activeset as _activeset

        mode = action.mode
        eff = action._auto_mode(ssn) if mode == "auto" else mode
        pipelinable = (not sequential
                       and eff in ("hier", "activeset")
                       and (eff == "activeset" or mode == "auto")
                       and self.sched.ladder.level == 0
                       and not _activeset.demoted()
                       and batched_supported(ssn))
        if not pipelinable:
            action.execute(ssn)
            return
        t0 = time.perf_counter()
        inputs = build_cycle_inputs(ssn, allow_affinity=True)
        tensorize_ms = (time.perf_counter() - t0) * 1e3
        if inputs is EMPTY_CYCLE:
            _alloc.last_cycle_engine = "hier"
            return
        if inputs is None or inputs.affinity is not None:
            self._sequential(ssn, action, eff, inputs)
            return
        # the seam the sequential path crosses before its dispatch
        _fault_check("device.dispatch")
        phases = {"tensorize": tensorize_ms}
        pend = _activeset.solve_cycle_async(inputs, phases)
        if pend is None:
            # declined (a cold-sized set, inexact pairs, demoted): the
            # full-width path, with the inputs already built
            self._sequential(ssn, action, eff, inputs)
            return
        self.dispatch_phases = phases
        _alloc.last_cycle_engine = "activeset"
        fold = getattr(self.sched.cache, "fold", None)
        if fold is not None:
            fold.begin_flight()
        self._pending = PendingCycle(pend, inputs, _obs.current_epoch())

    @staticmethod
    def _sequential(ssn, action, eff: str, inputs) -> None:
        """The sequential path after the inputs were built: building
        them consumed the cache's one-shot active rows, so this goes
        through execute_batched with the prebuilt inputs, then the
        execute's fallbacks past it."""
        from ..actions import allocate as _alloc
        from ..actions.allocate_batched import execute_batched
        from ..metrics import count_engine_demotion

        ran = execute_batched(ssn, hier=True, activeset=True,
                              inputs=inputs)
        if ran:
            _alloc.last_cycle_engine = ran
            return
        count_engine_demotion(eff, "visit")
        action._execute_queued(ssn, "batched")
