"""Process-lifetime counters (ref: kubebatch_tpu/metrics.py).

Plain integers and small host histograms: consumers read a counter
before and after a window and diff. :func:`counters_snapshot` gathers
every one into the JSON document that ``/debug/vars`` serves, that
``/metrics`` renders as OpenMetrics (obs/http.py) and that each flight
recorder entry embeds (obs/flight.py). This package keeps no Prometheus
client registry: the counters here are the only source.

Counted: the blocking device->host copies (``device.to_host``, one per
solve or victim dispatch) and the decisions the device solves bound (from
each solve's telemetry frame, obs/telemetry.py), engine demotions (a
requested engine that could not run and handed the cycle to another),
affinity host fallbacks, the preemption victims and attempts,
backfill-over-reserved's reclaims, double binds and lost reservations,
the event fold's folded events (per kind) and demotions (per reason),
the active-set engine's cycles (per kind), audits (per result) and
demotions (per reason), the scheduler loop's robustness and timing
accounting (cycle failures per reason, injected faults per seam, the
degradation ladder's level, lazy audits, schedule-on-arrival sub-cycles
and their arrival -> decision latencies, the host seconds the span
tracer feeds per phase, action, kernel and session), the observability
plane's SLO breaches and timeline drift, and the tenant solve
service's per-tenant events, mega dispatches and lanes, shed level and
shed requests, and the pipelined executor's overlapped cycles,
consume-time conflicts (per outcome), demotions (per reason) and
deferred readbacks. The keys of the compile service, not ported yet,
keep their zero values.
The remaining functions are the hooks the framework and the gang
plugin call; they record nothing.
"""
from __future__ import annotations

import threading

#: plugin-span phase labels (the reference's session hook names)
ON_SESSION_OPEN = "OnSessionOpen"
ON_SESSION_CLOSE = "OnSessionClose"

_blocking_readbacks = 0
_engine_demotions = 0
_engine_demotion_pairs: dict = {}
_preemption_victims = 0
_preemption_attempts = 0
_backfill_reclaims = 0
_backfill_tenants_evicted = 0
_backfill_double_binds = 0
_lost_reservations = 0
_affinity_host_fallbacks: dict = {}
#: the fold counters are hit from any thread that delivers cache events
_fold_lock = threading.Lock()
_events_folded: dict = {}
_fold_demotions: dict = {}


def count_blocking_readback(n: int = 1) -> None:
    """Record n blocking device->host copies. Called only by
    ``device.to_host``, before the copy, so an interrupted cycle still
    counts the attempt."""
    global _blocking_readbacks
    _blocking_readbacks += n


def blocking_readbacks() -> int:
    return _blocking_readbacks


_deferred_readbacks = 0


def count_deferred_readback(n: int = 1) -> None:
    """Record n DEFERRED device->host copies: the pipelined consume's
    read of a result dispatched a cycle earlier (``device.DeferredCopy``).
    Counted apart from the blocking ones, so a window can tell "read
    later" from "never read"."""
    global _deferred_readbacks
    _deferred_readbacks += n


def deferred_readbacks() -> int:
    return _deferred_readbacks


def count_engine_demotion(from_engine: str, to_engine: str) -> None:
    """Record one cycle whose requested engine could not run and passed
    the cycle to another (fused -> host on an unsupported snapshot)."""
    global _engine_demotions
    _engine_demotions += 1
    key = (from_engine, to_engine)
    _engine_demotion_pairs[key] = _engine_demotion_pairs.get(key, 0) + 1


def engine_demotions_total() -> int:
    return _engine_demotions


def engine_demotions_by_pair() -> dict:
    """Process-lifetime demotions per (from, to) engine pair (a copy)."""
    return dict(_engine_demotion_pairs)


def count_affinity_host_fallback(site: str) -> None:
    """Record one action whose affinity/port features pushed it off the
    device vocabulary onto the host path, per ``site`` as the reference's
    label: "allocate-raw-window" (raw collection window exceeded),
    "allocate-compact-cap" (over-cap vocabulary after compaction),
    "victim-masks" (the victim solvers' mask refusal)."""
    _affinity_host_fallbacks[site] = _affinity_host_fallbacks.get(site, 0) + 1


def affinity_host_fallback_total() -> int:
    """Process-lifetime affinity-fallback count over every site;
    consumers diff across a window."""
    return sum(_affinity_host_fallbacks.values())


def affinity_host_fallbacks_by_site() -> dict:
    """Process-lifetime affinity-fallback counts per site."""
    return dict(_affinity_host_fallbacks)


def count_backfill_over_placement(n: int = 1) -> None:
    """An AllocatedOverBackfill placement (session.py)."""


def update_task_schedule_duration(seconds: float) -> None:
    """Task creation -> bind latency (ref: framework/session.go:319)."""


def update_pod_schedule_status(result: str, count: int) -> None:
    """Per-cycle scheduled / unschedulable pod counts."""


def update_unschedule_task_count(job_id: str, count: int) -> None:
    """Unready tasks of a gang after a cycle (gang plugin)."""


def update_unschedule_job_count(count: int) -> None:
    """Unschedulable gangs after a cycle (gang plugin)."""


def register_job_retries(job_id: str) -> None:
    """A gang that stayed unready this cycle (gang plugin)."""


def update_preemption_victims_count(count: int) -> None:
    """The victim count of the last node a preemptor visited (a gauge)."""
    global _preemption_victims
    _preemption_victims = count


def preemption_victims() -> int:
    return _preemption_victims


def register_preemption_attempts() -> None:
    """One eviction walk on a validating node (preempt)."""
    global _preemption_attempts
    _preemption_attempts += 1


def preemption_attempts_total() -> int:
    return _preemption_attempts


def count_backfill_reclaim(tenants_evicted: int) -> None:
    """Record one gang promoted Ready by reclaiming its lent capacity
    (``tenants_evicted`` backfill tasks evicted in the statement)."""
    global _backfill_reclaims, _backfill_tenants_evicted
    _backfill_reclaims += 1
    _backfill_tenants_evicted += tenants_evicted


def backfill_reclaims_total() -> int:
    return _backfill_reclaims


def backfill_tenants_evicted_total() -> int:
    return _backfill_tenants_evicted


def count_backfill_double_bind() -> None:
    """A task reached dispatch in a state other than Allocated, or a
    promotion target was no longer over-backfill (normally never)."""
    global _backfill_double_binds
    _backfill_double_binds += 1


def backfill_double_binds_total() -> int:
    return _backfill_double_binds


def count_lost_reservation(n: int = 1) -> None:
    """An over-backfill placement survived the end-of-action release
    sweep (normally never)."""
    global _lost_reservations
    _lost_reservations += n


def lost_reservations_total() -> int:
    return _lost_reservations


def count_event_folded(kind: str, n: int = 1) -> None:
    """Record n cache events of one kind folded into the incremental
    snapshot state (cache/eventfold.py ``EventFold.record``)."""
    with _fold_lock:
        _events_folded[kind] = _events_folded.get(kind, 0) + n


def events_folded_total() -> dict:
    """Folded events per kind (a copy)."""
    with _fold_lock:
        return dict(_events_folded)


def count_fold_demotion(reason: str) -> None:
    """Record one demotion of the event fold to snapshot-primary
    (``EventFold.demote``: "audit" on a snapshot divergence)."""
    with _fold_lock:
        _fold_demotions[reason] = _fold_demotions.get(reason, 0) + 1


def fold_demotions_total() -> dict:
    """Fold demotions per reason (a copy)."""
    with _fold_lock:
        return dict(_fold_demotions)


# ---------------------------------------------------------------------------
# the active-set engine (kernels/activeset.py): the reference's
# activeset_cycles_total{kind}, activeset_audits_total{result} and
# activeset_demotions_total{reason}
# ---------------------------------------------------------------------------

_act_lock = threading.Lock()
_activeset_cycles: dict = {}
_activeset_audits: dict = {}
_activeset_demotions: dict = {}


def count_activeset_cycle(audit: bool) -> None:
    """Record one cycle the active-set engine solved, by kind: "audit"
    for the cadence's combined full-width comparison, else "steady"."""
    kind = "audit" if audit else "steady"
    with _act_lock:
        _activeset_cycles[kind] = _activeset_cycles.get(kind, 0) + 1


def activeset_cycles_total() -> int:
    with _act_lock:
        return sum(_activeset_cycles.values())


def activeset_cycles_by_kind() -> dict:
    with _act_lock:
        return dict(_activeset_cycles)


def count_activeset_audit(ok: bool) -> None:
    """Record one audit comparison, by result: "ok", or "diff" when the
    active-set decisions diverged from the full-width solve's."""
    result = "ok" if ok else "diff"
    with _act_lock:
        _activeset_audits[result] = _activeset_audits.get(result, 0) + 1


def activeset_audits_total() -> int:
    with _act_lock:
        return sum(_activeset_audits.values())


def activeset_audits_by_result() -> dict:
    with _act_lock:
        return dict(_activeset_audits)


def activeset_divergences_total() -> int:
    with _act_lock:
        return _activeset_audits.get("diff", 0)


def count_activeset_demotion(reason: str) -> None:
    """Record one demotion of the active-set engine to the full-width
    solve: "audit" (a divergence) or "fault" (the solve.activeset
    seam)."""
    with _act_lock:
        _activeset_demotions[reason] = _activeset_demotions.get(reason,
                                                                0) + 1


def activeset_demotions_total() -> int:
    with _act_lock:
        return sum(_activeset_demotions.values())


def activeset_demotions_by_reason() -> dict:
    with _act_lock:
        return dict(_activeset_demotions)


# ---------------------------------------------------------------------------
# the pipelined executor (runtime/pipeline.py): the reference's
# pipeline_cycles_total, pipeline_conflicts_total{outcome} and
# pipeline_demotions_total{reason}
# ---------------------------------------------------------------------------

_pipeline_cycles = 0
_pipeline_conflicts: dict = {}
_pipeline_demotions: dict = {}


def count_pipeline_cycle() -> None:
    """Record one overlapped cycle: a cycle that committed the in-flight
    solve the previous cycle dispatched."""
    global _pipeline_cycles
    with _act_lock:
        _pipeline_cycles += 1


def pipeline_cycles_total() -> int:
    with _act_lock:
        return _pipeline_cycles


def count_pipeline_conflict(outcome: str) -> None:
    """Record one consume that discarded the in-flight decisions:
    "conflict" (a folded event touched their job / node footprint, or a
    placed task no longer resolves) or "fault" (the armed
    ``pipeline.conflict`` seam)."""
    with _act_lock:
        _pipeline_conflicts[outcome] = \
            _pipeline_conflicts.get(outcome, 0) + 1


def pipeline_conflicts_total() -> int:
    with _act_lock:
        return sum(_pipeline_conflicts.values())


def pipeline_conflicts_by_outcome() -> dict:
    with _act_lock:
        return dict(_pipeline_conflicts)


def count_pipeline_demotion(reason: str) -> None:
    """Record one demotion of the pipelined executor to the sequential
    loop ("storm": consecutive consume-time conflicts)."""
    with _act_lock:
        _pipeline_demotions[reason] = \
            _pipeline_demotions.get(reason, 0) + 1


def pipeline_demotions_total() -> int:
    with _act_lock:
        return sum(_pipeline_demotions.values())


# ---------------------------------------------------------------------------
# the scheduler loop: cycle failures, injected faults, the degradation
# ladder, audits and sub-cycles. These are hit from the event-delivery
# and write-back threads as well as the loop, so they take a lock.
# ---------------------------------------------------------------------------

_robust_lock = threading.Lock()
_cycle_failures: dict = {}
_fault_injected: dict = {}
_degradation_level = 0
_audit_cycles = 0
_audit_failures = 0
_subcycles = 0
_arrivals_observed = 0


def count_cycle_failure(reason: str = "exception") -> None:
    """Record one scheduling cycle that raised ("exception"), exceeded
    its deadline budget ("deadline"), or one failed sub-cycle
    ("subcycle"). The loop survives all of them."""
    with _robust_lock:
        _cycle_failures[reason] = _cycle_failures.get(reason, 0) + 1


def cycle_failures_total() -> int:
    with _robust_lock:
        return sum(_cycle_failures.values())


def cycle_failures_by_reason() -> dict:
    with _robust_lock:
        return dict(_cycle_failures)


def count_fault_injected(seam: str) -> None:
    """Record one injected fault at ``seam`` (faults.py, armed plans)."""
    with _robust_lock:
        _fault_injected[seam] = _fault_injected.get(seam, 0) + 1


def fault_injected_total() -> dict:
    """Injected faults per seam (a copy)."""
    with _robust_lock:
        return dict(_fault_injected)


def set_degradation_level(level: int) -> None:
    global _degradation_level
    _degradation_level = level


def degradation_level() -> int:
    """The degradation ladder's level (0 = full engine)."""
    return _degradation_level


def count_audit_cycle(ok: bool) -> None:
    """Record one lazy audit (folded snapshot vs a fresh full clone);
    ``ok=False``: the two diverged and the fold demoted."""
    global _audit_cycles, _audit_failures
    with _robust_lock:
        _audit_cycles += 1
        if not ok:
            _audit_failures += 1


def audit_cycles_total() -> int:
    with _robust_lock:
        return _audit_cycles


def audit_failures_total() -> int:
    with _robust_lock:
        return _audit_failures


def count_subcycle() -> None:
    """Record one schedule-on-arrival sub-cycle."""
    global _subcycles
    with _robust_lock:
        _subcycles += 1


def subcycles_total() -> int:
    with _robust_lock:
        return _subcycles


def observe_arrival_latency(seconds: float) -> None:
    """Record one latency-lane arrival -> decision duration: the exact
    count here, the latency in the decision ledger's histogram
    (obs/ledger.py), which :func:`arrival_latency_percentiles` and a
    ledger window read."""
    global _arrivals_observed
    with _robust_lock:
        _arrivals_observed += 1
    from .obs import ledger as _ledger      # lazy: obs imports metrics
    _ledger.observe_subcycle_arrival(seconds)


def arrivals_observed_total() -> int:
    with _robust_lock:
        return _arrivals_observed


# ---------------------------------------------------------------------------
# host seconds per span category (the span tracer's metric views)
# ---------------------------------------------------------------------------

_host_phase_seconds: dict = {}
_action_seconds: dict = {}
_kernel_seconds: dict = {}
_e2e_seconds = [0.0, 0]


def update_host_phase(phase: str, seconds: float) -> None:
    _host_phase_seconds[phase] = _host_phase_seconds.get(phase, 0.0) + seconds


def host_phase_seconds() -> dict:
    """Host seconds per phase span (a copy); consumers diff a window."""
    return dict(_host_phase_seconds)


def update_action_duration(action: str, seconds: float) -> None:
    _action_seconds[action] = _action_seconds.get(action, 0.0) + seconds


def action_seconds() -> dict:
    """Host seconds per action span (a copy); consumers diff a window."""
    return dict(_action_seconds)


def update_solver_kernel_duration(kernel: str, seconds: float) -> None:
    _kernel_seconds[kernel] = _kernel_seconds.get(kernel, 0.0) + seconds


def solver_kernel_seconds() -> float:
    """Host seconds over every kernel span, dispatch to readback."""
    return sum(_kernel_seconds.values())


def update_e2e_duration(seconds: float) -> None:
    _e2e_seconds[0] += seconds
    _e2e_seconds[1] += 1


def e2e_seconds() -> tuple:
    """(total seconds, sessions) over every session span."""
    return tuple(_e2e_seconds)


def update_plugin_duration(plugin: str, phase: str, seconds: float) -> None:
    """A plugin's session open / close hook (the "plugin" span view)."""


def update_tensorize_duration(seconds: float) -> None:
    """A device snapshot build or refresh (the "tensorize" span view)."""


#: per-entity Python-loop fallback work: a per-item slow path in
#: tensorize or replay counts its items here (0 on a fully bulk cycle)
_slow_path_items: dict = {}


def count_slow_path_items(phase: str, n: int) -> None:
    if n:
        _slow_path_items[phase] = _slow_path_items.get(phase, 0) + n


def slow_path_items() -> dict:
    """Per-item fallback counts per phase (a copy)."""
    return dict(_slow_path_items)


# ---------------------------------------------------------------------------
# decisions and readbacks per decision (fed by obs/telemetry.py)
# ---------------------------------------------------------------------------

_decisions = 0


def count_decisions(n: int) -> None:
    """Record n scheduling decisions (tasks a device solve bound)."""
    global _decisions
    if n:
        _decisions += int(n)


def decisions_total() -> int:
    return _decisions


def readback_accounting(since: "dict | None" = None) -> dict:
    """{readbacks, deferred_readbacks, decisions, readbacks_per_decision,
    total_readbacks_per_decision}, process-lifetime or since an earlier
    readback_accounting() snapshot. The ratios are None for a window that
    bound nothing. ``readbacks_per_decision`` counts the blocking copies
    only (0 on a pipelined window); ``total_readbacks_per_decision`` adds
    the deferred ones (the pipelined consume's)."""
    rb = _blocking_readbacks
    dfr = _deferred_readbacks
    dec = _decisions
    if since is not None:
        rb -= int(since.get("readbacks", 0))
        dfr -= int(since.get("deferred_readbacks", 0))
        dec -= int(since.get("decisions", 0))
    return {"readbacks": rb, "deferred_readbacks": dfr,
            "decisions": dec,
            "readbacks_per_decision": (round(rb / dec, 6) if dec
                                       else None),
            "total_readbacks_per_decision":
                (round((rb + dfr) / dec, 6) if dec else None)}


def _buckets(start: float, factor: float, count: int) -> list:
    out, v = [], start
    for _ in range(count):
        out.append(v)
        v *= factor
    return out


class _BoundedHist:
    """A host histogram with fixed bucket uppers and an overflow slot,
    rendered as an OpenMetrics histogram by obs/http.py."""

    __slots__ = ("uppers", "counts", "sum", "count")

    def __init__(self, uppers):
        self.uppers = tuple(uppers)
        self.counts = [0] * (len(self.uppers) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v) -> None:
        v = float(v)
        for i, ub in enumerate(self.uppers):
            if v <= ub:
                break
        else:
            i = len(self.uppers)
        self.counts[i] += 1
        self.sum += v
        self.count += 1

    def snapshot(self) -> dict:
        cum, buckets = 0, {}
        for ub, c in zip(self.uppers, self.counts):
            cum += c
            buckets[repr(float(ub))] = cum
        return {"buckets": buckets, "sum": round(self.sum, 6),
                "count": self.count}


_telemetry_last: dict = {}          # engine -> last decoded frame
_telemetry_tenant_last: dict = {}   # tenant -> last decoded frame
_telemetry_hists = {
    "telemetry_waves": _BoundedHist(_buckets(1, 2, 12)),
    "telemetry_bound": _BoundedHist(_buckets(1, 4, 10)),
    "cycle_latency_ms": _BoundedHist(_buckets(1, 2, 14)),
}


def observe_telemetry(engine: str, frame: dict, tenant=None) -> None:
    """Fold one decoded telemetry frame into the per-engine last frames
    and the histograms (obs/telemetry.record is the only caller); the
    frame's bound count is the dispatch's decision count."""
    count_decisions(frame.get("bound", 0))
    _telemetry_last[engine] = frame
    if tenant:
        _telemetry_tenant_last[tenant] = frame
    _telemetry_hists["telemetry_waves"].observe(frame.get("waves", 0))
    _telemetry_hists["telemetry_bound"].observe(frame.get("bound", 0))


def observe_cycle_latency_ms(ms: float) -> None:
    """Cycle wall time into its histogram (the obs cycle hook)."""
    _telemetry_hists["cycle_latency_ms"].observe(ms)


def telemetry_snapshot() -> dict:
    """Last decoded frame per engine (and per tenant when attributed)
    plus the histograms: counters_snapshot's "telemetry" section."""
    out = {"last": dict(_telemetry_last),
           "histograms": {k: h.snapshot()
                          for k, h in _telemetry_hists.items()}}
    if _telemetry_tenant_last:
        out["tenant_last"] = dict(_telemetry_tenant_last)
    return out


def arrival_latency_percentiles() -> dict:
    """p50/p99 ms of the sub-cycle arrival -> decision latencies from the
    decision ledger's histogram (bucket resolution, ~9% relative), with
    the exact count; {} when no sub-cycle decided anything."""
    with _robust_lock:
        n = _arrivals_observed
    if not n:
        return {}
    from .obs import ledger as _ledger      # lazy: obs imports metrics
    pct = _ledger.subcycle_percentiles()
    if not pct:
        return {}
    return {"arrivals": n,
            "arrival_ms_p50": pct["p50_ms"],
            "arrival_ms_p99": pct["p99_ms"]}


# ---------------------------------------------------------------------------
# SLO breaches and timeline drift (obs/slo.py, obs/timeline.py)
# ---------------------------------------------------------------------------

_slo_breaches: dict = {}
_timeline_drift: dict = {}


def count_slo_breach(objective: str, window: str) -> None:
    """One burn-rate breach of ``objective`` in ``window`` ("fast" /
    "slow"; a breach fires both, once per episode)."""
    with _robust_lock:
        key = f"{objective}/{window}"
        _slo_breaches[key] = _slo_breaches.get(key, 0) + 1


def slo_breaches_total() -> int:
    with _robust_lock:
        return sum(_slo_breaches.values())


def slo_breaches_by_objective() -> dict:
    """Breach counts keyed "objective/window"."""
    with _robust_lock:
        return dict(_slo_breaches)


def count_timeline_drift(kind: str) -> None:
    """One timeline EWMA drift firing ("cycle_ms" / "rss_mb")."""
    with _robust_lock:
        _timeline_drift[kind] = _timeline_drift.get(kind, 0) + 1


def timeline_drift_total() -> int:
    with _robust_lock:
        return sum(_timeline_drift.values())


def timeline_drift_by_kind() -> dict:
    with _robust_lock:
        return dict(_timeline_drift)


# ---------------------------------------------------------------------------
# the tenant solve service (tenantsvc/)
# ---------------------------------------------------------------------------

_tenant_counters: dict = {}
_mega_dispatches = 0
_mega_lanes = 0
_shed_level = 0
_load_shed: dict = {}


def count_tenant(tenant: str, result: str, n: int = 1) -> None:
    """Record n tenant solve-service events ("solves", "mega_solves",
    "rejected", "stale_served", "queue_full", "quarantined")."""
    with _robust_lock:
        per = _tenant_counters.setdefault(tenant, {})
        per[result] = per.get(result, 0) + n


def tenant_counters() -> dict:
    """Per-tenant event counts, {tenant: {result: n}} (a deep copy)."""
    with _robust_lock:
        return {t: dict(per) for t, per in _tenant_counters.items()}


def count_mega_dispatch(lanes: int) -> None:
    """Record one coalesced mega-solve dispatch serving ``lanes`` real
    tenant lanes."""
    global _mega_dispatches, _mega_lanes
    with _robust_lock:
        _mega_dispatches += 1
        _mega_lanes += lanes


def mega_dispatches_total() -> int:
    with _robust_lock:
        return _mega_dispatches


def mega_lanes_total() -> int:
    """Total real lanes served by mega dispatches; divide by
    mega_dispatches_total() for the mean coalescing factor."""
    with _robust_lock:
        return _mega_lanes


def set_shed_level(level: int) -> None:
    global _shed_level
    _shed_level = level


def shed_level() -> int:
    """Current shed-ladder level (0 = no shedding)."""
    return _shed_level


def count_load_shed(mode: str) -> None:
    """Record one request degraded by the shed ladder ("serve-stale" /
    "reject-lowest")."""
    with _robust_lock:
        _load_shed[mode] = _load_shed.get(mode, 0) + 1


def load_shed_total() -> dict:
    with _robust_lock:
        return dict(_load_shed)


# ---------------------------------------------------------------------------
# the one-call snapshot: /debug/vars, /metrics, the flight recorder
# ---------------------------------------------------------------------------

def counters_snapshot(include_rpc: bool = True) -> dict:
    """Every process-lifetime counter as one JSON-able dict, with the
    reference's keys. ``include_rpc`` is the reference's switch for its
    rpc dispatch percentiles; the grpc transport is not ported, so that
    section never appears, nor do the fleet's ``fleet_routes`` /
    ``failovers*``. The ``tenants`` section appears once a tenant event
    was counted. Keys whose modules are not ported yet hold their zero
    values: ``compile_ms_total`` and ``recompiles_*`` (the compile
    service)."""
    snap = {
        "engine_demotions_total": engine_demotions_total(),
        "affinity_host_fallback_total": affinity_host_fallback_total(),
        "cycle_failures_total": cycle_failures_total(),
        "cycle_failures_by_reason": cycle_failures_by_reason(),
        "fault_injected_total": fault_injected_total(),
        "degradation_level": degradation_level(),
        "compile_ms_total": 0.0,
        "recompiles_total": 0,
        "recompiles_by_reason": {},
        "solver_kernel_seconds": round(solver_kernel_seconds(), 6),
        "host_phase_seconds": {k: round(v, 6) for k, v
                               in host_phase_seconds().items()},
        "slow_path_items": slow_path_items(),
        "blocking_readbacks": blocking_readbacks(),
        "decisions_total": decisions_total(),
        "shed_level": shed_level(),
        "load_shed_total": load_shed_total(),
        "mega_dispatches_total": mega_dispatches_total(),
        "mega_lanes_total": mega_lanes_total(),
        "events_folded_total": events_folded_total(),
        "subcycles_total": subcycles_total(),
        "audit_cycles_total": audit_cycles_total(),
        "audit_failures_total": audit_failures_total(),
        "fold_demotions_total": fold_demotions_total(),
        "activeset_cycles_total": activeset_cycles_total(),
        "activeset_audits_total": activeset_audits_total(),
        "activeset_divergences_total": activeset_divergences_total(),
        "activeset_demotions_total": activeset_demotions_total(),
        "deferred_readbacks": deferred_readbacks(),
        "pipeline_cycles_total": pipeline_cycles_total(),
        "pipeline_conflicts_total": pipeline_conflicts_total(),
        "pipeline_conflicts_by_outcome": pipeline_conflicts_by_outcome(),
        "pipeline_demotions_total": pipeline_demotions_total(),
        "slo_breaches_total": slo_breaches_total(),
        "slo_breaches_by_objective": slo_breaches_by_objective(),
        "timeline_drift_total": timeline_drift_total(),
        "timeline_drift_by_kind": timeline_drift_by_kind(),
        "telemetry": telemetry_snapshot(),
    }
    snap["readback_accounting"] = readback_accounting()
    arrival = arrival_latency_percentiles()
    if arrival:
        snap["subcycle_arrival"] = arrival
    tenants = tenant_counters()
    if tenants:
        snap["tenants"] = tenants
    from .obs import ledger as _ledger, slo as _slo, spans as _spans
    from .obs import timeline as _timeline  # lazy: obs imports metrics
    snap["tracer"] = _spans.tracer_stats()
    lstats = _ledger.stats()
    if lstats.get("closed_total"):
        snap["ledger"] = lstats
    slo_section = _slo.metrics_section()
    if slo_section:
        snap["slo"] = slo_section
    if _timeline.armed():
        snap["timeline"] = _timeline.stats()
    return snap
