"""Scheduler loop (ref: kubebatch_tpu/runtime/scheduler.py,
pkg/scheduler/scheduler.go + util.go).

Every ``schedule_period`` the loop opens a Session against the cache,
executes the configured actions in order, and closes the session
(status write-back). Each cycle is guarded: a raising cycle or one over
its deadline is counted (``cycle_failures_total{reason}``) and feeds the
degradation ladder (faults.py), whose cap the allocate action consults;
healthy cycles, the ladder's cooldown and a subprocess CUDA probe
re-promote it. Over a CUDA cache the ladder stops at its "fused" level:
the card's work never moves to the host loops. With ``subcycle=True`` latency-lane pod arrivals are
placed between periods by a schedule-on-arrival sub-cycle
(runtime/subcycle.py).

The reference's KUBEBATCH_* settings are keyword arguments here:
``solver=`` (KUBEBATCH_SOLVER: the allocate action's mode),
``cycle_deadline=`` (KUBEBATCH_CYCLE_DEADLINE), ``audit_every=``
(KUBEBATCH_AUDIT_EVERY), ``solve_audit_every=``
(KUBEBATCH_SOLVE_AUDIT_EVERY: the active-set engine's audit cadence,
process-wide as in the reference), ``subcycle=`` (KUBEBATCH_SUBCYCLE),
``slo=`` (KUBEBATCH_SLO: arms the SLO plane, obs/slo.py) and
``timeline_dir=`` (KUBEBATCH_TIMELINE_DIR: arms the timeline's spill,
obs/timeline.py), ``mesh=`` (the node mesh, parallel/mesh.py, its
allocate action shards over; the reference sees its devices); the
ladder's recovery probe is skipped on a CPU cache
(the reference's KUBEBATCH_NO_BACKEND_PROBE).
``explain_unschedulable=True`` runs the unschedulability explainer
(obs/explain.py) after the actions, inside the session span: one
``csrc/explain_counts.cu`` launch and one counted copy back a cycle on a
CUDA cache, published at /debug/explain; an explainer failure is logged
and never fails the cycle. An armed flight recorder (obs/flight.py)
dumps on every counted cycle failure and failed fold audit.
``pipeline=True`` (KUBEBATCH_PIPELINE) builds the pipelined executor
(runtime/pipeline.py), which runs the session block while it is active:
a steady active-set cycle dispatches its solve and returns, and the next
cycle consumes the result through one deferred readback; a conflict
storm demotes it to the sequential block for the rest of the process.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from .. import actions as _actions  # noqa: F401  (self-registration)
from .. import faults as _faults
from .. import obs
from ..obs import explain, flight
from .. import plugins as _plugins  # noqa: F401  (self-registration)
from ..conf import SchedulerConfiguration, Tier, parse_scheduler_conf
from ..device import on_card
from ..framework import Action, CloseSession, OpenSession, get_action
from ..metrics import count_audit_cycle, count_cycle_failure

log = logging.getLogger("kubebatch")

DEFAULT_SCHEDULER_CONF = """
actions: "allocate, backfill"
tiers:
- plugins:
  - name: priority
  - name: gang
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def load_scheduler_conf(conf_str: str) -> Tuple[List[Action], List[Tier]]:
    """ref: util.go:148-169 — an unknown action name is an error."""
    conf: SchedulerConfiguration = parse_scheduler_conf(conf_str)
    actions: List[Action] = []
    for name in conf.actions.split(","):
        name = name.strip()
        if not name:
            continue
        action = get_action(name)
        if action is None:
            raise ValueError(f"failed to find Action {name}, ignore it")
        actions.append(action)
    return actions, conf.tiers


class Scheduler:
    """ref: scheduler.go:33-105."""

    def __init__(self, cache, scheduler_conf: str = "",
                 schedule_period: float = 1.0,
                 enable_preemption: bool = False,
                 cycle_deadline: Optional[float] = None,
                 explain_unschedulable: bool = False,
                 audit_every: Optional[int] = None,
                 solve_audit_every: Optional[int] = None,
                 subcycle: Optional[bool] = None,
                 pipeline: Optional[bool] = None,
                 slo: Optional[bool] = None,
                 solver: Optional[str] = None,
                 timeline_dir: Optional[str] = None,
                 mesh=None):
        if solve_audit_every is not None:
            # the active-set engine's audit cadence (process-wide, as in
            # the reference; kernels/activeset.py owns the counter)
            from ..kernels import activeset as _activeset
            _activeset.set_audit_every(solve_audit_every)
        self.cache = cache
        self.schedule_period = schedule_period
        self.enable_preemption = enable_preemption
        self.actions, self.tiers = self._load_conf(scheduler_conf)
        if solver is not None or mesh is not None:
            # the reference reads KUBEBATCH_SOLVER at every execute; here
            # the loop owns its allocate action. ``mesh``: the node mesh
            # its allocate action runs the sharded engine over
            # (parallel/mesh.py; the reference sees its devices)
            from ..actions.allocate import AllocateAction
            self.actions = [
                AllocateAction(mode=solver or getattr(a, "mode", None),
                               mesh=mesh)
                if a.name == "allocate" else a for a in self.actions]
        self.mesh = mesh
        self._stop = threading.Event()
        #: per-cycle wall budget (seconds); an overrun counts as a cycle
        #: failure for the degradation ladder. None = no budget.
        self.cycle_deadline = cycle_deadline
        #: lazy-audit cadence: every Nth cycle opens from
        #: cache.audited_snapshot() (folded state deep-compared with a
        #: fresh full clone; a divergence demotes the fold). 0/None = off.
        self.audit_every = int(audit_every or 0)
        self.subcycle_enabled = bool(subcycle)
        #: full cycles and sub-cycles never overlap: both run under this
        #: lock (arrival hooks block on it for at most one cycle)
        self._cycle_lock = threading.Lock()
        self._arrival_lock = threading.Lock()
        self._pending_arrivals: list = []
        self._subcycle_seq = -1
        if self.subcycle_enabled and hasattr(cache, "arrival_hooks"):
            cache.arrival_hooks.append(self._on_pod_arrival)
        #: the process-wide degradation ladder: run_cycle feeds it,
        #: AllocateAction consults its cap. Its recovery probe reads this
        #: loop's cache, so every Scheduler installs its own (the newest
        #: loop's cache decides); a caller's own probe goes in after
        #: construction.
        self.ladder = _faults.LADDER
        self.ladder.probe = self._recovery_probe
        #: why the last run_cycle returned False (None / "exception" /
        #: "deadline")
        self.last_cycle_failure: Optional[str] = None
        self._cycle_seq = -1
        #: opt-in unschedulability explainer: one extra launch and copy
        #: a cycle, the snapshot at /debug/explain
        self.explain_unschedulable = bool(explain_unschedulable)
        #: the SLO burn-rate plane, armed per scheduler (fresh objective
        #: state); disarmed it costs nothing
        self.slo_enabled = bool(slo)
        if self.slo_enabled:
            from ..obs import slo as _slo
            _slo.arm()
        if timeline_dir:
            from ..obs import timeline as _timeline
            _timeline.arm(timeline_dir)
        #: the pipelined executor; run_once hands it the session block
        #: while it is active (not demoted)
        self.pipeline_enabled = bool(pipeline)
        self._pipeline = None
        if self.pipeline_enabled:
            from .pipeline import PipelinedExecutor
            self._pipeline = PipelinedExecutor(self)

    @staticmethod
    def _load_conf(conf_str: str):
        """A conf that parses wrong or names an unknown action is fatal,
        like the reference's panic (scheduler.go:80-83)."""
        return load_scheduler_conf(conf_str or DEFAULT_SCHEDULER_CONF)

    def run(self, stop: Optional[threading.Event] = None) -> None:
        """Blocking loop: cache workers (where the cache has them) and a
        guarded cycle every period (ref: scheduler.go:63-86). Automatic
        garbage collection is off inside the loop and runs between
        cycles, off the latency path."""
        import gc

        stop = stop or self._stop
        for name in ("run", "wait_for_cache_sync"):
            fn = getattr(self.cache, name, None)
            if fn is not None:
                fn()
        gc.freeze()
        gc_was_enabled = gc.isenabled()
        gc.disable()
        try:
            while not stop.is_set():
                with obs.span("loop_tick", cat="host") as tick:
                    self.run_cycle()
                    gc.collect()
                stop.wait(max(0.0, self.schedule_period - tick.dur))
        finally:
            if gc_was_enabled:
                gc.enable()
            gc.unfreeze()

    def stop(self) -> None:
        self._stop.set()

    def _recovery_probe(self) -> bool:
        """Health probe gating ladder re-promotion: one CUDA operation
        in an abandonable subprocess; a CPU cache answers True."""
        from .watchdog import midrun_probe
        return midrun_probe(getattr(self.cache, "device", "cpu"))

    # ------------------------------------------------------------------
    # schedule-on-arrival (runtime/subcycle.py)
    # ------------------------------------------------------------------
    def _on_pod_arrival(self, pod) -> None:
        """Cache arrival hook (outside the cache lock, on the thread that
        delivered the event): queue latency-lane pods and drain them
        through a sub-cycle."""
        from .subcycle import is_latency_pod
        if not is_latency_pod(pod):
            return
        with self._arrival_lock:
            self._pending_arrivals.append((pod, time.perf_counter()))
        self._drain_arrivals()

    def _drain_arrivals(self) -> None:
        """One sub-cycle over every queued arrival, under the cycle lock.
        A failing sub-cycle is counted and logged, never raised into the
        event delivery."""
        from . import subcycle as _subcycle

        with self._cycle_lock:
            with self._arrival_lock:
                arrivals, self._pending_arrivals = \
                    self._pending_arrivals, []
            if not arrivals:
                return
            try:
                _subcycle.run_subcycle(self, arrivals)
            except Exception:
                log.exception("schedule-on-arrival sub-cycle failed; "
                              "pods wait for the next full cycle")
                count_cycle_failure("subcycle")

    def run_cycle(self) -> bool:
        """One GUARDED cycle: never raises. A raising cycle is counted as
        cycle_failures_total{reason=exception}, one over the deadline as
        {reason=deadline}; both feed the degradation ladder, and a
        healthy cycle feeds its recovery side. Returns True iff
        healthy; ``last_cycle_failure`` says why not."""
        self.last_cycle_failure = None
        self._cycle_seq += 1
        root = obs.begin_cycle(self._cycle_seq, ladder=self.ladder.level)
        try:
            with self._cycle_lock:
                self.run_once()
        except Exception:
            obs.end_cycle(root, failed="exception")
            log.exception("scheduling cycle failed; loop continues "
                          "(ladder level %d)", self.ladder.level)
            count_cycle_failure("exception")
            self.last_cycle_failure = "exception"
            self.ladder.record_failure(on_card(self.cache))
            # the failing cycle's tree is in the ring the dump writes:
            # end_cycle ran first
            flight.maybe_dump_on_failure("exception")
            return False
        obs.end_cycle(root)
        if self.cycle_deadline is not None \
                and root.dur > self.cycle_deadline:
            log.warning("scheduling cycle took %.3fs, over the %.3fs "
                        "deadline budget (ladder level %d)", root.dur,
                        self.cycle_deadline, self.ladder.level)
            count_cycle_failure("deadline")
            self.last_cycle_failure = "deadline"
            self.ladder.record_failure(on_card(self.cache))
            flight.maybe_dump_on_failure("deadline")
            return False
        self.ladder.record_success()
        return True

    def run_once(self) -> None:
        """One scheduling cycle (ref: scheduler.go:88-105). CloseSession
        runs even when an action throws, so status write-back happens and
        the loop survives. The session span feeds the end-to-end time,
        each action span its action's."""
        jobs = nodes = None
        session_span = None
        snapshot = None
        if (self.audit_every
                and self._cycle_seq % self.audit_every == 0
                and hasattr(self.cache, "audited_snapshot")):
            with obs.span("audit", cat="phase"):
                snapshot, diffs = self.cache.audited_snapshot()
            count_audit_cycle(ok=not diffs)
            if diffs:
                log.error("fold audit FAILED (%d diffs; fold demoted to "
                          "snapshot-primary): %s", len(diffs), diffs[:4])
                flight.maybe_dump_on_failure("fold-audit")
        if self._pipeline is not None and self._pipeline.active():
            # the previous cycle's in-flight solve is consumed first and
            # the allocate action dispatches without reading back
            self._pipeline.run_once(snapshot)
            return
        try:
            with obs.span("session", cat="e2e") as session_span:
                ssn = OpenSession(self.cache, self.tiers,
                                  self.enable_preemption,
                                  snapshot=snapshot)
                jobs, nodes = len(ssn.jobs), len(ssn.nodes)
                try:
                    for action in self.actions:
                        action.initialize()
                        with obs.span(action.name, cat="action") as asp:
                            action.execute(ssn)
                        log.debug("action %s took %.2fms", action.name,
                                  1e3 * asp.dur)
                        action.uninitialize()
                    if self.explain_unschedulable:
                        # opt-in debug pass: a diagnostic must not fail
                        # the cycle (its decisions are applied) or feed
                        # the degradation ladder
                        try:
                            with obs.span("explain", cat="host"):
                                explain.explain_session(ssn)
                        except Exception:
                            log.exception("unschedulability explainer "
                                          "failed; cycle unaffected")
                finally:
                    CloseSession(ssn)
        finally:
            if jobs is not None:
                log.info("scheduling cycle: %d jobs / %d nodes in %.2fms",
                         jobs, nodes, 1e3 * session_span.dur)
