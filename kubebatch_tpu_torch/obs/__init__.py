"""kubebatch_tpu_torch.obs — tracing, flight recording, and explainability
(ref: kubebatch_tpu/obs).

- :mod:`.spans`    — the span tracer: the per-cycle span tree (cycle ->
  session -> action -> phase -> kernel dispatch -> readback), the metric
  views fired at span exit, the cycle and span hooks, the armed
  ``torch.profiler`` capture;
- :mod:`.export`   — Chrome trace-event JSON of span trees;
- :mod:`.flight`   — the bounded flight-recorder ring, dumped on cycle
  failures, ladder and active-set demotions, SLO breaches and drift;
- :mod:`.explain`  — the opt-in unschedulability explainer (one launch of
  ``csrc/explain_counts.cu``, one counted copy back);
- :mod:`.telemetry` — host decode of the solve telemetry frame;
- :mod:`.ledger`   — the per-pod decision-latency ledger (arrival -> fold
  -> pack -> solve -> apply -> bind) in log-bucketed histograms keyed
  (lane, tenant, engine);
- :mod:`.slo`      — latency objectives over the ledger as multi-window
  burn rates;
- :mod:`.timeline` — per-cycle digests with JSONL spill and an EWMA drift
  rung;
- :mod:`.http`     — /metrics, /healthz, /debug/vars, /debug/explain,
  /debug/slo.

The rpc sidecar's span grafting comes with the sidecar (ROADMAP A8).
Import discipline: this package imports metrics and kernels.telemetry (a
leaf); the actions, kernels and cache import obs, never the reverse at
module scope. The ledger's stage stamps are registered on SPAN_HOOKS
here, not at ledger import, so a reader importing the ledger alone does
not arm the hook twice.
"""
from .spans import (CYCLE_HOOKS, SPAN_HOOKS, Span, add_event, arm_profile,
                    begin_cycle, current_cycle, current_epoch, cycle,
                    enabled, end_cycle, last_cycle, now, set_enabled, span,
                    span_overhead_estimate, spans_total, tracer_stats)
from . import ledger, slo, telemetry, timeline  # noqa: E402

if ledger.on_span_exit not in SPAN_HOOKS:
    SPAN_HOOKS.append(ledger.on_span_exit)

__all__ = ["CYCLE_HOOKS", "SPAN_HOOKS", "Span", "add_event", "arm_profile",
           "begin_cycle", "current_cycle", "current_epoch", "cycle",
           "enabled", "end_cycle", "last_cycle", "ledger", "now",
           "set_enabled", "slo", "span", "span_overhead_estimate",
           "spans_total", "telemetry", "timeline", "tracer_stats"]
