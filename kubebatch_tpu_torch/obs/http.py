"""Debug/metrics HTTP endpoint (ref: kubebatch_tpu/obs/http.py).

kube-batch serves /metrics through promhttp and nothing else; a
production scheduler needs liveness and debug surfaces too. One small
stdlib ThreadingHTTPServer serves:

- ``/metrics``       — an OpenMetrics exposition of the counters in
  metrics.py (typed ``# HELP``/``# TYPE`` lines, histogram buckets,
  ``# EOF``); this package keeps no Prometheus client registry;
- ``/healthz``       — liveness JSON: status "ok" at the full engine,
  "degraded" under any ladder demotion, "failing" when the ladder is
  pinned at its floor; plus ladder level, cycle failure count,
  spans/cycle;
- ``/debug/vars``    — every process-lifetime mirror counter
  (metrics.counters_snapshot) as one JSON document: demotions, faults,
  host phases, readbacks, decisions, tracer stats, the ledger;
- ``/debug/explain`` — the latest unschedulability-explainer snapshot
  (obs/explain.py), or ``{"enabled": false}`` when it never ran;
- ``/debug/slo``     — the SLO plane's burn rates and the ledger
  counters its objectives read.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

from .. import metrics

__all__ = ["DebugHTTPServer", "start"]


#: leaf keys that are monotone accumulators despite lacking the
#: ``_total`` suffix (the suffix rule covers everything else)
_COUNTER_LEAVES = {"blocking_readbacks", "readbacks", "decisions",
                   "dispatches", "count"}

#: OpenMetrics media type (the ``# EOF`` terminator below is part of it)
OPENMETRICS_CTYPE = ("application/openmetrics-text; version=1.0.0; "
                     "charset=utf-8")


def _render_openmetrics(snapshot: dict) -> str:
    """OpenMetrics exposition of the counters. Typing derives from the
    snapshot's structure: ``*_total`` names (and the readback/decision
    accumulators) are counters, dicts shaped like
    metrics._BoundedHist.snapshot() render as full histograms
    (``_bucket{le=...}``/``_sum``/``_count``), every other numeric leaf
    is a gauge. Nested dict keys flatten into the metric name, so the
    exposition covers exactly what /debug/vars covers."""
    out = []

    def emit(name: str, mtype: str, help_: str, lines) -> None:
        out.append(f"# HELP {name} {help_}")
        out.append(f"# TYPE {name} {mtype}")
        out.extend(lines)

    def is_hist(v) -> bool:
        return (isinstance(v, dict) and isinstance(v.get("buckets"), dict)
                and "sum" in v and "count" in v)

    def clean(k: str) -> str:
        return (str(k).replace("-", "_").replace(".", "_")
                .replace("/", "_").replace(" ", "_"))

    def walk(prefix: str, value, leaf_key: str = "") -> None:
        name = f"kube_batch_{prefix}"
        if is_hist(value):
            lines = []
            for ub, cum in value["buckets"].items():
                lines.append(f'{name}_bucket{{le="{float(ub)}"}} {cum}')
            lines.append(f'{name}_bucket{{le="+Inf"}} {value["count"]}')
            lines.append(f"{name}_sum {value['sum']}")
            lines.append(f"{name}_count {value['count']}")
            emit(name, "histogram", f"{leaf_key} (bounded histogram)",
                 lines)
            return
        if isinstance(value, dict):
            for k, v in sorted(value.items()):
                key = clean(k)
                walk(f"{prefix}_{key}" if prefix else key, v, str(k))
            return
        if isinstance(value, bool):
            value = int(value)
        if isinstance(value, (int, float)):
            mtype = ("counter" if (name.endswith("_total")
                                   or leaf_key in _COUNTER_LEAVES)
                     else "gauge")
            emit(name, mtype, leaf_key or prefix, [f"{name} {value}"])

    walk("", snapshot)
    out.append("# EOF")
    return "\n".join(out) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "kubebatch-obs/1"

    def log_message(self, *args) -> None:   # quiet; the scheduler logs
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, obj, code: int = 200) -> None:
        self._send(code, json.dumps(obj, indent=1, default=str).encode(),
                   "application/json")

    def do_GET(self) -> None:  # noqa: N802 — BaseHTTPRequestHandler API
        path = self.path.split("?", 1)[0]
        try:
            if path == "/healthz":
                from ..faults import LADDER_LEVELS
                snap = metrics.counters_snapshot()
                level = snap.get("degradation_level", 0)
                # "ok" only at the full engine; any demotion is
                # "degraded", and a ladder pinned at its floor (every
                # engine tier exhausted) is the failing state
                at_floor = level >= len(LADDER_LEVELS) - 1
                from .. import __version__
                self._send_json({
                    "status": ("failing" if at_floor
                               else "degraded" if level else "ok"),
                    "version": __version__,
                    "degradation_level": level,
                    "cycle_failures_total":
                        snap.get("cycle_failures_total", 0),
                    "blocking_readbacks":
                        snap.get("blocking_readbacks", 0),
                    "tracer": snap.get("tracer", {}),
                })
            elif path == "/debug/vars":
                self._send_json(metrics.counters_snapshot())
            elif path == "/debug/explain":
                from . import explain
                snap = explain.latest()
                if snap is None:
                    self._send_json({
                        "enabled": False,
                        "hint": "run Scheduler(explain_unschedulable="
                                "True) (or call obs.explain."
                                "explain_session) to populate this "
                                "snapshot",
                    })
                else:
                    self._send_json(snap)
            elif path == "/debug/slo":
                from . import ledger as _ledger
                from . import slo as _slo
                # the SLO plane's live burn rates plus the ledger
                # counters the objectives evaluate over
                payload = _slo.snapshot()
                payload["ledger"] = _ledger.stats()
                self._send_json(payload)
            elif path == "/metrics":
                self._send(200, _render_openmetrics(
                    metrics.counters_snapshot()).encode(),
                    OPENMETRICS_CTYPE)
            else:
                self._send_json({"error": "not found", "endpoints": [
                    "/metrics", "/healthz", "/debug/vars",
                    "/debug/explain", "/debug/slo"]}, code=404)
        except BrokenPipeError:            # pragma: no cover — client gone
            pass
        except Exception as e:             # a debug surface never crashes
            try:
                self._send_json({"error": f"{type(e).__name__}: {e}"},
                                code=500)
            except Exception:              # pragma: no cover
                pass


class DebugHTTPServer:
    """Owns the ThreadingHTTPServer + its daemon thread."""

    def __init__(self, addr: str = "0.0.0.0", port: int = 8080):
        self._httpd = ThreadingHTTPServer((addr, port), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DebugHTTPServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="kb-obs-http", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)


def start(listen_address: str) -> Optional[DebugHTTPServer]:
    """':8080' / 'host:port' -> a started server, or None on bind
    failure (the daemon must schedule even when the port is taken)."""
    host, _, port = listen_address.rpartition(":")
    try:
        return DebugHTTPServer(host or "0.0.0.0", int(port)).start()
    except Exception:
        return None
