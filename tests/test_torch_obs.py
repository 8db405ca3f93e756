"""The port's observability plane against the reference's, on the CPU.

Each module of ``kubebatch_tpu_torch.obs`` and the rest of its
``metrics.py`` is held against ``kubebatch_tpu``'s on the same inputs; no
test asserts a duration:

- the decision ledger: the streaming histogram's buckets and percentiles
  on the same samples, the closed counts per (lane, tenant, engine) and
  the stage keys after the same scheduler cycles, the cache's stamps;
- the SLO plane's burn rates and breaches against a synthetic clock
  (``t=``), the ``obs.slo`` seam counting one breach and dumping;
- the timeline's digests and its drift rung;
- the flight recorder's dumps (a fault-failed cycle, a ladder demotion);
- the Chrome trace export;
- the five HTTP endpoints;
- the telemetry decode of every engine's frame, and the frames and
  decision counts a fused and a batched cycle record;
- ``counters_snapshot``'s key set.
"""
from __future__ import annotations

import json
import os
import threading
import urllib.error
import urllib.request

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import kubebatch_tpu.actions  # noqa: E402,F401
import kubebatch_tpu.plugins  # noqa: E402,F401
import kubebatch_tpu_torch.actions  # noqa: E402,F401
import kubebatch_tpu_torch.plugins  # noqa: E402,F401
from kubebatch_tpu import faults as j_faults  # noqa: E402
from kubebatch_tpu import metrics as j_metrics  # noqa: E402
from kubebatch_tpu import obs as j_obs  # noqa: E402
from kubebatch_tpu import objects as j_objects  # noqa: E402
from kubebatch_tpu.actions import allocate as j_allocate_mod  # noqa: E402
from kubebatch_tpu.actions.allocate import AllocateAction as JAllocate  # noqa: E402
from kubebatch_tpu.cache import SchedulerCache as JCache  # noqa: E402
from kubebatch_tpu.conf import shipped_tiers as j_tiers  # noqa: E402
from kubebatch_tpu.framework import CloseSession as JClose  # noqa: E402
from kubebatch_tpu.framework import OpenSession as JOpen  # noqa: E402
from kubebatch_tpu.kernels.telemetry import ENGINE_NAMES as J_ENGINES  # noqa: E402
from kubebatch_tpu.obs import explain as j_explain  # noqa: E402
from kubebatch_tpu.obs import export as j_export  # noqa: E402
from kubebatch_tpu.obs import flight as j_flight  # noqa: E402
from kubebatch_tpu.obs import http as j_http  # noqa: E402
from kubebatch_tpu.obs import ledger as j_ledger  # noqa: E402
from kubebatch_tpu.obs import slo as j_slo  # noqa: E402
from kubebatch_tpu.obs import telemetry as j_telemetry  # noqa: E402
from kubebatch_tpu.obs import timeline as j_timeline  # noqa: E402
from kubebatch_tpu.runtime.scheduler import Scheduler as JScheduler  # noqa: E402
from kubebatch_tpu.sim import BASELINE_SPECS as J_SPECS  # noqa: E402
from kubebatch_tpu.sim import build_cluster as j_build  # noqa: E402
from kubebatch_tpu_torch import faults as t_faults  # noqa: E402
from kubebatch_tpu_torch import metrics as t_metrics  # noqa: E402
from kubebatch_tpu_torch import obs as t_obs  # noqa: E402
from kubebatch_tpu_torch import objects as t_objects  # noqa: E402
from kubebatch_tpu_torch.actions import allocate as t_allocate_mod  # noqa: E402
from kubebatch_tpu_torch.actions.allocate import AllocateAction as TAllocate  # noqa: E402
from kubebatch_tpu_torch.cache import SchedulerCache as TCache  # noqa: E402
from kubebatch_tpu_torch.conf import shipped_tiers as t_tiers  # noqa: E402
from kubebatch_tpu_torch.framework import CloseSession as TClose  # noqa: E402
from kubebatch_tpu_torch.framework import OpenSession as TOpen  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import ENGINE_NAMES as T_ENGINES  # noqa: E402
from kubebatch_tpu_torch.kernels.telemetry import TELEM_WIDTH  # noqa: E402
from kubebatch_tpu_torch.obs import explain as t_explain  # noqa: E402
from kubebatch_tpu_torch.obs import export as t_export  # noqa: E402
from kubebatch_tpu_torch.obs import flight as t_flight  # noqa: E402
from kubebatch_tpu_torch.obs import http as t_http  # noqa: E402
from kubebatch_tpu_torch.obs import ledger as t_ledger  # noqa: E402
from kubebatch_tpu_torch.obs import slo as t_slo  # noqa: E402
from kubebatch_tpu_torch.obs import telemetry as t_telemetry  # noqa: E402
from kubebatch_tpu_torch.obs import timeline as t_timeline  # noqa: E402
from kubebatch_tpu_torch.runtime import Scheduler as TScheduler  # noqa: E402
from kubebatch_tpu_torch.sim import BASELINE_SPECS as T_SPECS  # noqa: E402
from kubebatch_tpu_torch.sim import build_cluster as t_build  # noqa: E402

J = dict(faults=j_faults, metrics=j_metrics, obs=j_obs, objects=j_objects,
         allocate=j_allocate_mod,
         ledger=j_ledger, slo=j_slo, timeline=j_timeline, flight=j_flight,
         export=j_export, http=j_http, telemetry=j_telemetry,
         explain=j_explain, Scheduler=JScheduler)
T = dict(faults=t_faults, metrics=t_metrics, obs=t_obs, objects=t_objects,
         allocate=t_allocate_mod,
         ledger=t_ledger, slo=t_slo, timeline=t_timeline, flight=t_flight,
         export=t_export, http=t_http, telemetry=t_telemetry,
         explain=t_explain, Scheduler=TScheduler)
SIDES = (J, T)
_SETTINGS = ("KUBEBATCH_SOLVER", "KUBEBATCH_CYCLE_DEADLINE",
             "KUBEBATCH_AUDIT_EVERY", "KUBEBATCH_SUBCYCLE",
             "KUBEBATCH_PIPELINE", "KUBEBATCH_SLO", "KUBEBATCH_TIMELINE_DIR",
             "KUBEBATCH_FAULTS")
#: counters_snapshot sections of modules the port has not got (the rpc
#: sidecar, the tenant service's fleet), which other tests of this
#: process may have filled on the reference's side
_UNPORTED_SECTIONS = {"rpc_dispatch", "tenants", "fleet_routes",
                      "failovers_total", "failovers"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Both planes start and end disarmed with empty ledgers, injection
    off, the ladders reset, retention on."""
    for name in _SETTINGS:
        monkeypatch.delenv(name, raising=False)

    def reset():
        for s in SIDES:
            s["faults"].reset()
            s["ledger"].reset()
            s["ledger"].set_enabled(True)
            s["slo"].disarm()
            s["timeline"].disarm()
            s["flight"].disarm()
            s["export"].disarm()
            s["explain"].set_latest(None)
            s["obs"].set_enabled(True)
    reset()
    for s in SIDES:
        monkeypatch.setattr(s["faults"].LADDER, "probe", lambda: True)
        # process state other tests leave behind and these compare: the
        # engine a close is keyed by (the previous cycle's, in both
        # packages, until allocate returns) and the last frame per engine
        monkeypatch.setattr(s["allocate"], "last_cycle_engine", "")
        monkeypatch.setattr(s["telemetry"], "_last", {})
    yield
    reset()


class _Binder:
    def __init__(self):
        self.calls = []

    def bind(self, pod, hostname):
        self.calls.append((f"{pod.namespace}/{pod.name}", hostname))
        pod.node_name = hostname

    def bind_many(self, pairs):
        for pod, hostname in pairs:
            self.bind(pod, hostname)

    def evict(self, pod):
        pod.deletion_timestamp = 1.0


def _cache(side, config=2):
    binder = _Binder()
    if side is T:
        sim = t_build(T_SPECS[config])
        cache = TCache(binder=binder, evictor=binder, async_writeback=False,
                       device="cpu")
    else:
        sim = j_build(J_SPECS[config])
        cache = JCache(binder=binder, evictor=binder, async_writeback=False)
    sim.populate(cache)
    return sim, cache, binder


def _kubelet(sim, cache):
    for pod in list(sim.pods):
        if pod.node_name and pod.phase.name != "RUNNING":
            pod.phase = type(pod.phase).RUNNING
            cache.update_pod(pod, pod)


# ---- the decision ledger --------------------------------------------------

def test_stream_hist_buckets_and_percentiles_match_reference():
    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.lognormal(-4.0, 1.5, 4000), [0.0, -1.0,
                                                             1e-9, 3600.0]])
    out = []
    for s in SIDES:
        h = s["ledger"].StreamHist()
        for v in samples:
            h.observe(float(v))
        n, total, buckets = h.snapshot()
        led = s["ledger"]
        out.append((n, total, buckets,
                    [led._pct_from_counts(buckets, p) for p in (50, 90, 99)],
                    led._max_from_counts(buckets),
                    led.count_over_threshold(buckets, 0.05)))
    assert out[0] == out[1]


def test_ledger_closes_match_reference_over_scheduler_cycles():
    """Two periods of the default conf (cold, then kubelet + churn 64) in
    each package from a reset ledger with retention on: the closed count
    per (lane, tenant, engine), the stage keys, the open and unmatched
    counts equal the reference's; every retained record is monotone."""
    out = []
    for s in SIDES:
        s["ledger"].retain()
        sim, cache, _ = _cache(s)
        sched = s["Scheduler"](cache)
        for period in range(2):
            if period:
                _kubelet(sim, cache)
                assert sim.churn_tick(cache, 64) > 0
            assert sched.run_cycle() is True
        led = s["ledger"]
        stats = led.stats()
        for rec in led.retained():
            ts = [rec["arrival"]] + [v for _, v in rec["stages"]] \
                + [rec["bind"]]
            assert ts == sorted(ts)
        out.append(({k: h.count for k, h in led._hists.items()},
                    sorted(led._stage_hists),
                    {k: stats[k] for k in ("closed_total", "open",
                                           "unmatched_total", "keys",
                                           "evicted_total")},
                    sorted((r["engine"], r["epoch"] is not None,
                            tuple(st for st, _ in r["stages"]))
                           for r in led.retained())))
    assert out[0] == out[1]
    assert out[1][2]["closed_total"] > 0


def test_ledger_discard_and_first_stamp_win_like_reference():
    out = []
    for s in SIDES:
        m, led = s["objects"], s["ledger"]
        pods = [m.Pod(uid=f"u{i}", name=f"p{i}", namespace="ns")
                for i in range(3)]
        for p in pods:
            led.stamp_arrival(p)
        led.stamp_arrival(pods[0])
        led.discard("u1")
        led.close(pods[0], engine="fused")
        led.close(pods[1], engine="fused")
        out.append({k: v for k, v in led.stats().items()
                    if k != "arrival_bind"})
    assert out[0] == out[1]
    assert out[1]["closed_total"] == 1 and out[1]["unmatched_total"] == 1


def test_batched_closes_equal_the_reference_closes(monkeypatch):
    """The port's bind_many closes a batch in one close_many; against a
    synthetic clock its records, histograms and counters equal the
    reference's per-pod closes at the same bind time, for arrivals
    before, between and after the epoch's fold / pack / solve / apply
    stamps, on two lanes and two tenants, with an unmatched pod."""
    out = []
    for s in SIDES:
        led, o, m = s["ledger"], s["obs"], s["objects"]
        clock = {"t": 0.0}
        monkeypatch.setattr(led, "_perf_now", lambda: clock["t"])
        led.retain()
        pods = [m.Pod(uid=f"c{i}", name=f"c{i}", namespace="ab"[i % 2],
                      annotations=({led.LANE_ANNOTATION: led.LATENCY_LANE}
                                   if i % 3 == 0 else {}))
                for i in range(10)]
        root = o.begin_cycle(None)
        epoch = root.args["epoch"]
        events = [(0.0, 0), (0.5, 1), (1.0, "fold"), (1.5, 2), (2.0, "pack"),
                  (2.0, 3), (2.5, 4), (3.0, "solve"), (3.5, 5), (3.5, 6),
                  (4.0, "apply"), (4.5, 7), (5.0, 8)]
        for t, what in events:
            clock["t"] = t
            if isinstance(what, str):
                led.stage_mark(what, epoch=epoch)
            else:
                led.stamp_arrival(pods[what])
        clock["t"] = 9.25
        if s is T:
            led.close_many(pods, engine="batched")
        else:
            for pod in pods:
                led.close(pod, engine="batched")
        o.end_cycle(root)
        # epochs are each package's process-wide count: relative here
        recs = [dict(r, epoch=r["epoch"] - epoch) for r in led.retained()]
        out.append((recs, led.stats(),
                    {k: h.snapshot() for k, h in led._hists.items()},
                    {k: h.snapshot() for k, h in led._stage_hists.items()}))
    assert out[0] == out[1]
    assert out[1][1]["closed_total"] == 9 and out[1][1]["unmatched_total"] == 1


# ---- the SLO plane ----------------------------------------------------------

def _cycle_objective(s, **kw):
    return s["slo"].Objective(name="cyc", kind="cycle", threshold_ms=10.0,
                              target=0.9, fast_s=60.0, slow_s=600.0,
                              min_count=4, **kw)


def test_slo_burn_and_breach_match_reference():
    """A synthetic clock: healthy cycles, a slow spell (both windows
    burn: one breach), recovery, a second episode; the snapshots and the
    breach counters move as the reference's."""
    trace = []
    for s in SIDES:
        clock = [0.0]
        plane = s["slo"].SLOPlane((_cycle_objective(s),),
                                  now=lambda: clock[0])
        b0 = s["metrics"].slo_breaches_by_objective().get("cyc/fast", 0)
        rows = []
        for k in range(120):
            clock[0] = 10.0 * k
            slow = 30 <= k < 45 or 90 <= k < 100
            plane.tick(0.05 if slow else 0.001, t=clock[0])
            if k % 10 == 9:
                snap = plane.snapshot()
                o = snap["objectives"][0]
                rows.append((o["breached"], o["breaches_total"],
                             o["windows"], snap["injected_total"]))
        rows.append(plane.metrics_section())
        rows.append(s["metrics"].slo_breaches_by_objective().get(
            "cyc/fast", 0) - b0)
        trace.append(rows)
    assert trace[0] == trace[1]
    assert trace[1][-1] == 2


def test_slo_seam_counts_one_breach_and_dumps(tmp_path):
    """The obs.slo seam through the armed module plane with an armed
    flight recorder holding a cycle: one "injected" breach per window
    and one dump that parses. (The reference's tick fires the dump under
    its plane's lock, which counters_snapshot then takes again: the port
    fires after releasing it, so this returns.)"""
    t_flight.arm(str(tmp_path))
    with t_obs.cycle(0):
        pass
    plane = t_slo.arm()
    b0 = t_metrics.slo_breaches_by_objective()
    t_faults.arm(t_faults.FaultPlan(counts={"obs.slo": 1}))
    th = threading.Thread(target=plane.tick, kwargs={"cycle_dur_s": 0.01,
                                                     "t": 0.0}, daemon=True)
    th.start()
    th.join(30)
    assert not th.is_alive()
    moved = {k: v - b0.get(k, 0)
             for k, v in t_metrics.slo_breaches_by_objective().items()
             if v != b0.get(k, 0)}
    assert moved == {"injected/fast": 1, "injected/slow": 1}
    dumps = [p for p in os.listdir(tmp_path) if "slo_breach-injected" in p]
    assert len(dumps) == 1
    doc = json.load(open(tmp_path / dumps[0]))
    assert doc["reason"] == "slo_breach-injected" and doc["cycles"]
    assert plane.snapshot()["injected_total"] == 1


# ---- the timeline -----------------------------------------------------------

class _Root:
    def __init__(self, dur, epoch):
        self.dur = dur
        self.name = "cycle"
        self.args = {"epoch": epoch}

    def count(self):
        return 3


def test_timeline_digests_and_drift_match_reference(tmp_path):
    """The same synthetic cycle roots: the digests' fields (the counter
    deltas and RSS aside, which are each process state's), the spill
    file and the drift rung's single firing per episode."""
    out = []
    for s in SIDES:
        d = tmp_path / ("t" if s is T else "j")
        tl = s["timeline"].Timeline(now=lambda: 1.0).arm(str(d), capacity=64,
                                                          spill_every=16)
        d0 = s["metrics"].timeline_drift_by_kind().get("cycle_ms", 0)
        for k in range(200):
            tl.tick(_Root(0.002 if k < 120 else 0.020, k))
        tl.flush()
        lines = [json.loads(x) for x in open(d / "timeline.jsonl")]
        digests = [{k: v for k, v in x.items() if k not in ("rss_mb",
                                                             "deltas")}
                   for x in lines]
        st = tl.stats()
        out.append((digests, sorted(lines[0]["deltas"]),
                    {k: st[k] for k in ("ticks", "ring", "ring_capacity",
                                        "spilled", "cycle_ms_fast",
                                        "cycle_ms_slow")},
                    s["metrics"].timeline_drift_by_kind().get("cycle_ms", 0)
                    - d0))
    assert out[0] == out[1]
    assert len(out[1][0]) == 200 and out[1][3] == 1


# ---- the flight recorder ----------------------------------------------------

def _dump_shape(doc):
    cyc = doc["cycles"][-1]
    return (sorted(doc), doc["reason"], sorted(doc["ladder"]),
            sorted(cyc), sorted(cyc["spans"]), cyc["spans"]["name"],
            sorted(c["name"] for c in cyc["spans"].get("children", ())))


def test_flight_dumps_match_reference(tmp_path):
    """A cycle failed by the device.dispatch seam dumps
    "cycle_failure-exception"; two more failures demote the ladder and
    dump "ladder_demotion-level1"; the dumps' structure and the failing
    cycle's span tree equal the reference's."""
    out = []
    for s in SIDES:
        d = tmp_path / ("t" if s is T else "j")
        s["flight"].arm(str(d))
        sim, cache, _ = _cache(s)
        sched = s["Scheduler"](cache)
        s["faults"].LADDER.probe = lambda: True
        s["faults"].arm(s["faults"].FaultPlan(
            counts={"device.dispatch": 2}))
        assert sched.run_cycle() is False
        assert sched.run_cycle() is False
        names = sorted(os.listdir(d))
        docs = [json.load(open(d / n)) for n in names]
        out.append(([n.split("-", 2)[2] for n in names],
                    [_dump_shape(doc) for doc in docs],
                    sorted(docs[0]["counters"]),
                    docs[-1]["ladder"]["level"]))
    assert out[0][0] == out[1][0] == ["cycle_failure-exception.json",
                                      "ladder_demotion-level1.json",
                                      "cycle_failure-exception.json"]
    assert out[0][1] == out[1][1]
    assert set(out[0][2]) - _UNPORTED_SECTIONS \
        == set(out[1][2]) - _UNPORTED_SECTIONS
    assert out[0][3] == out[1][3] == 1


def test_unarmed_recorder_is_free():
    assert t_flight._on_cycle not in t_obs.CYCLE_HOOKS
    assert t_flight.dump("manual") is None


# ---- the Chrome trace export -------------------------------------------------

def test_chrome_trace_matches_reference(tmp_path):
    out = []
    for s in SIDES:
        d = str(tmp_path / ("t" if s is T else "j"))
        path = s["export"].arm(d)
        sim, cache, _ = _cache(s)
        sched = s["Scheduler"](cache)
        assert sched.run_cycle() and sched.run_cycle()
        assert s["export"].flush() == path
        doc = json.load(open(path))
        evs = doc["traceEvents"]
        assert all(e["ph"] == "X" and e["dur"] >= 0 for e in evs)
        # every event nests inside the cycle event that precedes it
        roots = [e for e in evs if e["name"] == "cycle"]
        for e in evs:
            r = max((r for r in roots if r["ts"] <= e["ts"]),
                    key=lambda r: r["ts"])
            assert e["ts"] + e["dur"] <= r["ts"] + r["dur"] + 1.0
        out.append((sorted(doc), doc["displayTimeUnit"], len(roots),
                    sorted({e["name"] for e in evs}
                           & {"cycle", "session", "open", "close",
                              "allocate", "backfill", "tensorize",
                              "replay", "fold", "apply"}),
                    sorted({k for e in evs for k in e})))
    assert out[0] == out[1]
    assert out[1][2] == 2


# ---- the HTTP endpoints -------------------------------------------------------

def _get(base, path):
    try:
        r = urllib.request.urlopen(base + path, timeout=10)
        return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def test_http_endpoints_match_reference():
    """After one explained, SLO-armed cycle in each package: every
    endpoint answers 200 and parses, /debug/explain serves the latest
    snapshot, /debug/vars and /debug/slo carry the reference's keys,
    /metrics is OpenMetrics; an unknown path is a 404 listing the five."""
    out = []
    for s in SIDES:
        sim, cache, _ = _cache(s)
        sched = s["Scheduler"](cache, explain_unschedulable=True, slo=True)
        assert sched.run_cycle()
        srv = s["http"].DebugHTTPServer("127.0.0.1", 0).start()
        base = f"http://127.0.0.1:{srv.port}"
        try:
            got = {p: _get(base, p) for p in (
                "/healthz", "/debug/vars", "/debug/explain", "/debug/slo",
                "/metrics", "/nope")}
        finally:
            srv.stop()
        assert all(got[p][0] == 200 for p in got if p != "/nope")
        health = json.loads(got["/healthz"][2])
        varz = json.loads(got["/debug/vars"][2])
        exp = json.loads(got["/debug/explain"][2])
        slo_doc = json.loads(got["/debug/slo"][2])
        latest = dict(s["explain"].latest())
        assert exp.pop("ts") == pytest.approx(latest.pop("ts"))
        assert exp == latest
        text = s["http"]._render_openmetrics(json.loads(
            json.dumps(s["metrics"].counters_snapshot())))
        exp.pop("jobs")
        out.append((health["status"], sorted(health),
                    set(varz) - _UNPORTED_SECTIONS, exp,
                    sorted(slo_doc), slo_doc["armed"],
                    [o["name"] for o in slo_doc["objectives"]],
                    sorted(slo_doc["ledger"]),
                    got["/metrics"][2].decode().endswith("# EOF\n"),
                    text.endswith("# EOF\n"),
                    got["/nope"][0],
                    json.loads(got["/nope"][2])["endpoints"]))
    j, t = out
    assert j[0] == t[0] == "ok" and j[1] == t[1]
    assert j[2] == t[2] and j[3:8] == t[3:8]
    assert t[8] and j[9] and t[9] and t[10] == 404 and j[11] == t[11]


def test_openmetrics_rendering_matches_reference():
    snap = {"a_total": 3, "gauge": 1.5, "flag": True, "nested": {
        "x": 2, "count": 4}, "h": {"buckets": {"1.0": 1, "2.0": 3},
                                   "sum": 2.5, "count": 3}}
    assert t_http._render_openmetrics(snap) == j_http._render_openmetrics(
        snap)


# ---- telemetry ----------------------------------------------------------------

def test_telemetry_decode_matches_reference_for_every_engine():
    assert T_ENGINES == {k: v for k, v in J_ENGINES.items()
                         if k in T_ENGINES}
    rng = np.random.default_rng(0)
    for engine in sorted(T_ENGINES) + [99]:
        words = rng.integers(0, 1000, TELEM_WIDTH + 3).astype(np.int32)
        words[0] = engine
        assert t_telemetry.decode(words) == j_telemetry.decode(words)


@pytest.mark.parametrize("mode", ["fused", "batched"])
def test_cycle_frames_and_decisions_match_reference(mode):
    """One cfg2 allocate cycle in each package: the recorded frame (last
    frame of the engine, the kernel span's arguments) and the decisions
    and readback accounting it moves equal the reference's."""
    out = []
    for s, Alloc, opn, close, tiers in (
            (J, JAllocate, JOpen, JClose, j_tiers),
            (T, TAllocate, TOpen, TClose, t_tiers)):
        met = s["metrics"]
        sim, cache, _ = _cache(s)
        acct0 = met.readback_accounting()
        root = s["obs"].begin_cycle(None)
        ssn = opn(cache, tiers())
        Alloc(mode=mode).execute(ssn)
        close(ssn)
        s["obs"].end_cycle(root)
        acct = met.readback_accounting(since=acct0)
        kernel = root.find(f"{mode}_allocate")
        frame = s["telemetry"].last_frame(mode)
        out.append((frame, kernel.args["telemetry"],
                    {k: acct[k] for k in ("readbacks", "decisions",
                                          "readbacks_per_decision")},
                    met.telemetry_snapshot()["last"][mode]))
    assert out[0] == out[1]
    assert out[1][0]["bound"] == out[1][2]["decisions"] > 0


# ---- counters_snapshot ----------------------------------------------------------

def test_counters_snapshot_keys_match_reference(tmp_path):
    """With a cycle run in each package under an armed SLO plane and
    timeline: the same top-level keys (the unported modules' sections
    aside), the same zero-valued keys of unported modules, the same
    ledger, slo, timeline, tracer and telemetry sections' keys."""
    out = []
    for s in SIDES:
        s["timeline"].arm(str(tmp_path / ("t" if s is T else "j")))
        sim, cache, _ = _cache(s)
        sched = s["Scheduler"](cache, slo=True)
        assert sched.run_cycle()
        snap = s["metrics"].counters_snapshot()
        json.dumps(snap)
        snap["telemetry"].pop("tenant_last", None)   # tenant service
        out.append((set(snap) - _UNPORTED_SECTIONS,
                    {k: sorted(snap[k]) for k in (
                        "ledger", "slo", "timeline", "tracer", "telemetry",
                        "readback_accounting")},
                    sorted(snap["telemetry"]["histograms"])))
    assert out[0] == out[1]
    zeros = {"compile_ms_total": 0.0, "recompiles_total": 0,
             "recompiles_by_reason": {}, "shed_level": 0,
             "load_shed_total": {}, "mega_dispatches_total": 0,
             "mega_lanes_total": 0, "deferred_readbacks": 0,
             "pipeline_cycles_total": 0, "pipeline_conflicts_total": 0,
             "pipeline_conflicts_by_outcome": {},
             "pipeline_demotions_total": 0}
    snap = t_metrics.counters_snapshot()
    assert {k: snap[k] for k in zeros} == zeros


def test_spans_hooks_and_epochs_match_reference():
    """cycle(), current_epoch, add_event, spans_total and tracer_stats:
    the same tree, counts and hook calls in both tracers."""
    out = []
    for s in SIDES:
        o = s["obs"]
        seen = []
        hook = seen.append
        o.SPAN_HOOKS.append(hook)
        try:
            n0 = o.spans_total()
            with o.cycle(7) as root:
                e = o.current_epoch()
                with o.span("tensorize", cat="phase"):
                    o.add_event("compile", 0.001)
                with o.span("k", cat="kernel"):
                    pass
            n = o.spans_total() - n0
        finally:
            o.SPAN_HOOKS.remove(hook)
        d = root.to_dict()
        out.append((e == root.args["epoch"], o.current_epoch(), n,
                    [sp.name for sp in seen], root.count(),
                    [c["name"] for c in d["children"]],
                    [c["name"] for c in d["children"][0]["children"]],
                    sorted(o.tracer_stats()), o.last_cycle() is root,
                    o.Span.from_dict(d).to_dict() == d))
    assert out[0] == out[1]
