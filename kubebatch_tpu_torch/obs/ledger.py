"""The per-pod decision-latency ledger (ref: kubebatch_tpu/obs/ledger.py).

Every pod that the scheduler binds gets ONE closed ledger record telling
the full latency story of its decision:

    arrival -> fold -> pack -> solve -> apply -> bind

- **arrival** is stamped by the cache the moment a PENDING pod enters
  (``cache/cache.py _fire_arrival_hooks``, the funnel the
  schedule-on-arrival sub-cycle rides, so the stamp exists whether or
  not any hook is registered);
- **fold / pack / solve** are stamped from span exits (``SPAN_HOOKS`` in
  obs/spans.py): the "fold" phase span, the "tensorize" phase span and
  any ``cat="kernel"`` dispatch span mark their cycle epoch's stage
  completion times — keyed by EPOCH, not wall order, because with the
  pipelined executor cycle k's solve can be consumed inside cycle k+1;
- **apply** is stamped directly by ``cache.bind``/``bind_many`` at
  entry (the decision-apply funnel all three bind paths share);
- **bind** closes the record: the cache calls :func:`close` per pod at
  the state flip, the moment the decision is durably applied.

The reference's deferred attribution (``attribute``: a pipelined
consume closing cycle k's records inside cycle k+1) waits for the
pipelined executor (ROADMAP A4): every close here is in its own cycle's
epoch, so ``deferred_closed_total`` stays 0 and a record's ``deferred``
is False.

Closed records land in lock-free-read, log-bucketed **streaming
histograms** keyed ``(lane, tenant, engine)`` — 8 buckets per octave
(~9% relative resolution), sparse dict storage, O(1) memory per key —
plus per-(lane, stage) stage-duration histograms, the sub-cycle
arrival histogram that ``metrics.arrival_latency_percentiles`` reads,
and per-(tenant, lane) admission-wait histograms (fed by the tenant
service's admission, ROADMAP A8).

Consumers read percentiles over a WINDOW (:func:`window` captures a
snapshot; the window object diffs live state against it).

Bounded by construction: the open-record map evicts its oldest entry
past ``MAX_OPEN`` (counted, never silent), per-epoch stage maps keep the
last ``EPOCH_KEEP`` epochs, histogram key cardinality caps at
``MAX_KEYS`` (overflow keys aggregate into ``("other","other","other")``),
and closed-record retention (an audit mode) is OFF by default.
"""
from __future__ import annotations

import math
import threading
from bisect import bisect_left
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["LANE_ANNOTATION", "LATENCY_LANE", "DEFAULT_LANE", "STAGES",
           "StreamHist", "LedgerWindow", "set_enabled", "enabled",
           "reset", "stamp_arrival", "discard", "stage_mark", "close",
           "close_many", "on_span_exit", "observe_subcycle_arrival",
           "subcycle_percentiles", "observe_admission", "window",
           "percentile", "stats", "retain", "stop_retention", "retained",
           "MAX_OPEN", "MAX_KEYS"]

#: the lane annotation vocabulary (single source of truth: runtime/
#: subcycle.py re-exports these)
LANE_ANNOTATION = "scheduling.k8s.io/kube-batch/lane"
LATENCY_LANE = "latency"
DEFAULT_LANE = "normal"

#: stage order between arrival and bind; close() drops stamps that
#: precede the pod's arrival (a pod that arrived mid-cycle honestly has
#: no fold/pack story for that cycle) and clamps the rest monotone
STAGES = ("fold", "pack", "solve", "apply")

#: open-arrival map bound: past this the OLDEST open record is evicted
#: (counted in stats()["evicted_total"]) so deleted-while-pending pods
#: can never leak the map unbounded even if discard() is missed
MAX_OPEN = 65536

#: histogram key-cardinality bound; excess (lane, tenant, engine) keys
#: aggregate into the overflow key instead of growing without bound
MAX_KEYS = 256
_OVERFLOW_KEY = ("other", "other", "other")

#: per-epoch stage maps kept (the pipelined executor defers by exactly
#: one cycle; 64 epochs is deep slack for nested subcycle roots)
EPOCH_KEEP = 64

_perf_now = None  # bound lazily to spans.now so both share one clock


def _now() -> float:
    global _perf_now
    if _perf_now is None:
        from . import spans as _spans
        _perf_now = _spans.now
    return _perf_now()


# ---------------------------------------------------------------------
# log-bucketed streaming histogram
# ---------------------------------------------------------------------

#: sub-buckets per octave: bucket index = floor(log2(v) * FINE); the
#: relative bucket width is 2**(1/8)-1 ~ 9%, so a bucket-midpoint
#: percentile answer is within ~4.5% of the true order statistic
FINE = 8
_MIN_V = 1e-7                      # 0.1us floor; <=0 clamps here
_LOG2 = math.log(2.0)


def _bucket_idx(v: float) -> int:
    if v < _MIN_V:
        v = _MIN_V
    return int(math.floor(math.log(v) / _LOG2 * FINE))


def _bucket_mid(idx: int) -> float:
    return 2.0 ** ((idx + 0.5) / FINE)


def _bucket_upper(idx: int) -> float:
    return 2.0 ** ((idx + 1.0) / FINE)


class StreamHist:
    """A sparse log-bucketed streaming histogram of SECONDS.

    Single-writer increments are GIL-atomic per bucket; the ledger
    serializes writers under its module lock anyway. ``snapshot()``
    copies are what window consumers diff — reads never block writes.
    """

    __slots__ = ("count", "sum", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.sum = 0.0
        self.buckets: Dict[int, int] = {}

    def observe(self, seconds: float) -> None:
        self.add(_bucket_idx(seconds), seconds)

    def add(self, idx: int, seconds: float) -> None:
        """One observation already bucketed at ``idx``."""
        self.buckets[idx] = self.buckets.get(idx, 0) + 1
        self.count += 1
        self.sum += seconds

    def snapshot(self) -> Tuple[int, float, Dict[int, int]]:
        return self.count, self.sum, dict(self.buckets)


def _pct_from_counts(counts: Dict[int, int], p: float) -> Optional[float]:
    """Percentile (seconds) from merged bucket counts: the geometric
    midpoint of the bucket holding the ceil-rank order statistic."""
    total = sum(counts.values())
    if total <= 0:
        return None
    rank = max(1, int(math.ceil(p / 100.0 * total)))
    acc = 0
    for idx in sorted(counts):
        acc += counts[idx]
        if acc >= rank:
            return _bucket_mid(idx)
    return _bucket_mid(max(counts))    # pragma: no cover — rank <= total


def _max_from_counts(counts: Dict[int, int]) -> Optional[float]:
    live = [i for i, n in counts.items() if n > 0]
    return _bucket_upper(max(live)) if live else None


def count_over_threshold(buckets: Dict[int, int], threshold_s: float) -> int:
    """Observations whose bucket midpoint exceeds ``threshold_s`` (the
    SLO plane's bad-event count: bucket-resolution exact)."""
    return sum(n for idx, n in buckets.items()
               if _bucket_mid(idx) > threshold_s)


# ---------------------------------------------------------------------
# ledger state
# ---------------------------------------------------------------------

_lock = threading.Lock()
_enabled = True

#: uid -> arrival perf ts, oldest first: an OrderedDict, whose
#: popitem(last=False) evicts in O(1) where a dict's next(iter()) rescans
#: the deleted slots at its front on every eviction
_open: "OrderedDict[str, float]" = OrderedDict()
_epoch_stages: Dict[int, Dict[str, float]] = {}
_hists: Dict[Tuple[str, str, str], StreamHist] = {}
_stage_hists: Dict[Tuple[str, str], StreamHist] = {}
_sub_hist = StreamHist()                       # sub-cycle arrival->decision
_admission_hists: Dict[Tuple[str, str], StreamHist] = {}

_closed_total = 0
_unmatched_total = 0
_evicted_total = 0

_retained: Optional[deque] = None              # audit mode


def set_enabled(on: bool) -> None:
    """The A/B toggle: OFF stops stamping and closing entirely (the
    dryrun proves readback accounting is identical either way)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def reset() -> None:
    """Clear all ledger state (tests / soak isolation). Histograms are
    process-lifetime accumulators otherwise, like everything in
    metrics.py."""
    global _sub_hist, _closed_total
    global _unmatched_total, _evicted_total, _retained
    with _lock:
        _open.clear()
        _epoch_stages.clear()
        _hists.clear()
        _stage_hists.clear()
        _admission_hists.clear()
        _sub_hist = StreamHist()
        _closed_total = 0
        _unmatched_total = 0
        _evicted_total = 0
        _retained = None


# ---------------------------------------------------------------------
# stamps
# ---------------------------------------------------------------------

def stamp_arrival(pod) -> None:
    """Stamp a PENDING pod's arrival (first stamp wins — a pod can
    re-enter via update_pod without resetting its clock)."""
    if not _enabled:
        return
    global _evicted_total
    t = _now()
    uid = pod.uid
    with _lock:
        if uid in _open:
            return
        if len(_open) >= MAX_OPEN:
            _open.popitem(last=False)
            _evicted_total += 1
        _open[uid] = t


def discard(uid: str) -> None:
    """Drop an open record (pod deleted while pending — no decision will
    ever close it)."""
    with _lock:
        _open.pop(uid, None)


def _epoch_map(epoch: int) -> Dict[str, float]:
    st = _epoch_stages.get(epoch)
    if st is None:
        st = _epoch_stages[epoch] = {}
        while len(_epoch_stages) > EPOCH_KEEP:
            _epoch_stages.pop(min(_epoch_stages))
    return st


def stage_mark(stage: str, epoch: Optional[int] = None) -> None:
    """Stamp a stage completion/entry time into a cycle epoch's map
    (``cache.bind_many`` marks "apply" at entry; span exits mark the
    rest via :func:`on_span_exit`)."""
    if not _enabled:
        return
    if epoch is None:
        from . import spans as _spans
        epoch = _spans.current_epoch()
    if epoch is None:
        return
    t = _now()
    with _lock:
        _epoch_map(epoch)[stage] = t


#: span-exit -> stage mapping: the fold phase, the tensorize (pack)
#: phase and any kernel dispatch mark their epoch's stage completion
_PHASE_STAGES = {"fold": "fold", "tensorize": "pack"}


def on_span_exit(sp) -> None:
    """Registered in spans.SPAN_HOOKS at obs import. Must stay cheap —
    it runs at EVERY span exit (the test_obs per-span budget covers it):
    two attribute reads and a dict probe on the miss path."""
    if not _enabled:
        return
    cat = sp.cat
    if cat == "kernel":
        stage = "solve"
    elif cat == "phase":
        stage = _PHASE_STAGES.get(sp.name)
        if stage is None:
            return
    else:
        return
    from . import spans as _spans
    epoch = _spans.current_epoch()
    if epoch is None:
        return
    with _lock:
        _epoch_map(epoch)[stage] = sp.t0 + sp.dur


# ---------------------------------------------------------------------
# close (the bind funnel)
# ---------------------------------------------------------------------

def _hist_for(key: Tuple[str, str, str]) -> StreamHist:
    h = _hists.get(key)
    if h is None:
        if len(_hists) >= MAX_KEYS:
            key = _OVERFLOW_KEY
            h = _hists.get(key)
            if h is None:
                h = _hists[key] = StreamHist()
        else:
            h = _hists[key] = StreamHist()
    return h


def _stage_hist_for(lane: str, stage: str) -> StreamHist:
    key = (lane, stage)
    h = _stage_hists.get(key)
    if h is None:
        if len(_stage_hists) >= MAX_KEYS:
            key = ("other", stage)
            h = _stage_hists.get(key)
            if h is None:
                h = _stage_hists[key] = StreamHist()
        else:
            h = _stage_hists[key] = StreamHist()
    return h


def _current_engine() -> str:
    try:       # lazy + guarded: obs must not hard-depend on actions
        from ..actions import allocate as _alloc
        return getattr(_alloc, "last_cycle_engine", "") or "none"
    except Exception:                      # pragma: no cover
        return "none"


def close(pod, engine: Optional[str] = None) -> None:
    """Close a pod's record at its decision apply (the cache bind
    funnel: ``bind``/``bind_many`` state flip — full cycle, sub-cycle
    and pipelined replay all pass through there). Unmatched closes (no
    arrival stamp — the ledger was enabled mid-flight) are counted, not
    invented."""
    close_many((pod,), engine)


def close_many(pods, engine: Optional[str] = None) -> None:
    """:func:`close` for the pods of one decision batch (``bind_many``'s
    state flip): the clock, the epochs, the engine and the stage chain
    are read once and the lock is taken once. Each pod's record is the
    one close() gives it at the batch's bind time: its stages are the
    suffix of the batch's monotone stage chain at or after its arrival
    (stamps older than the arrival drop, no stage precedes the one
    before it), so the intervals between chain stages, shared by every
    pod that keeps them, are bucketed once per batch. O(1) a pod."""
    if not _enabled:
        return
    global _closed_total, _unmatched_total
    t = _now()
    from . import spans as _spans
    epoch = _spans.current_epoch()
    eng = engine or _current_engine()
    with _lock:
        src = _epoch_stages.get(epoch, {}) if epoch else {}
        chain: List[Tuple[str, float]] = []
        for stage in STAGES:
            v = src.get(stage)
            if v is not None and (not chain or v >= chain[-1][1]):
                chain.append((stage, v))
        values = [v for _, v in chain]
        n = len(values)
        bind_ts = max(t, values[-1]) if n else t
        # (stage, seconds, bucket) of each shared interval: chain stage j
        # after stage j - 1, and the bind after the last stage
        shared = [(chain[j][0], values[j] - values[j - 1],
                   _bucket_idx(values[j] - values[j - 1]))
                  for j in range(1, n)]
        if n:
            last = bind_ts - values[-1]
            shared.append(("bind", last, _bucket_idx(last)))
        for pod in pods:
            arrival = _open.pop(pod.uid, None)
            if arrival is None:
                _unmatched_total += 1
                continue
            lane = (pod.annotations or {}).get(LANE_ANNOTATION,
                                               DEFAULT_LANE)
            tenant = pod.namespace or "default"
            k = bisect_left(values, arrival)
            pod_bind = bind_ts if k < n else max(t, arrival)
            total = pod_bind - arrival
            _hist_for((lane, tenant, eng)).observe(total)
            if k < n:
                _stage_hist_for(lane, chain[k][0]).observe(
                    values[k] - arrival)
                for stage, secs, idx in shared[k:]:
                    _stage_hist_for(lane, stage).add(idx, secs)
            else:
                _stage_hist_for(lane, "bind").observe(total)
            _closed_total += 1
            if _retained is not None:
                _retained.append({
                    "uid": pod.uid, "name": getattr(pod, "name", ""),
                    "lane": lane, "tenant": tenant, "engine": eng,
                    "epoch": epoch, "deferred": False,
                    "arrival": arrival, "stages": chain[k:],
                    "bind": pod_bind, "total_ms": round(total * 1e3, 6),
                })


# ---------------------------------------------------------------------
# sub-cycle arrival + admission feeds
# ---------------------------------------------------------------------

def observe_subcycle_arrival(seconds: float) -> None:
    """The sub-cycle arrival->decision feed: metrics.observe_arrival_
    latency routes here; the exact arrival COUNT stays in metrics (the
    ledger histogram carries the shape)."""
    if not _enabled:
        return
    with _lock:
        _sub_hist.observe(seconds)


def subcycle_percentiles() -> Optional[dict]:
    """p50/p99 ms of the sub-cycle arrival latencies, or None before the
    first observation — what arrival_latency_percentiles() serves."""
    with _lock:
        if not _sub_hist.count:
            return None
        counts = dict(_sub_hist.buckets)
        n = _sub_hist.count
    p50 = _pct_from_counts(counts, 50.0)
    p99 = _pct_from_counts(counts, 99.0)
    return {"count": n,
            "p50_ms": round((p50 or 0.0) * 1e3, 3),
            "p99_ms": round((p99 or 0.0) * 1e3, 3)}


def observe_admission(tenant: str, lane: str, wait_seconds: float) -> None:
    """Per-(tenant, lane) admission-queue wait (the tenant service's
    queue, ROADMAP A8)."""
    if not _enabled:
        return
    with _lock:
        key = (tenant, lane)
        h = _admission_hists.get(key)
        if h is None:
            if len(_admission_hists) >= MAX_KEYS:
                key = ("other", lane)
                h = _admission_hists.setdefault(key, StreamHist())
            else:
                h = _admission_hists[key] = StreamHist()
        h.observe(wait_seconds)


# ---------------------------------------------------------------------
# reads
# ---------------------------------------------------------------------

def _merge(snaps: Iterable[Tuple[int, float, Dict[int, int]]]
           ) -> Tuple[int, float, Dict[int, int]]:
    total, s, merged = 0, 0.0, {}
    for n, hsum, buckets in snaps:
        total += n
        s += hsum
        for idx, c in buckets.items():
            merged[idx] = merged.get(idx, 0) + c
    return total, s, merged


def _select(base: Dict[Tuple[str, str, str],
                       Tuple[int, float, Dict[int, int]]],
            lane: Optional[str], tenant: Optional[str],
            engine: Optional[str]):
    for (ln, tn, en), snap in base.items():
        if lane is not None and ln != lane:
            continue
        if tenant is not None and tn != tenant:
            continue
        if engine is not None and en != engine:
            continue
        yield snap


class LedgerWindow:
    """A point-in-time baseline; reads diff LIVE ledger state against
    it, so a reader measures exactly its window."""

    def __init__(self) -> None:
        with _lock:
            self._base = {k: h.snapshot() for k, h in _hists.items()}
            self._sub_base = _sub_hist.snapshot()
            self._closed0 = _closed_total

    def _diffs(self, lane=None, tenant=None, engine=None
               ) -> Tuple[int, float, Dict[int, int]]:
        with _lock:
            live = {k: h.snapshot() for k, h in _hists.items()}
        out = []
        for key, (n, s, buckets) in live.items():
            bn, bs, bb = self._base.get(key, (0, 0.0, {}))
            d = {i: c - bb.get(i, 0) for i, c in buckets.items()
                 if c - bb.get(i, 0) > 0}
            out.append((n - bn, s - bs, d))
        return _merge(_select(
            {k: v for k, v in zip(live.keys(), out)},
            lane, tenant, engine))

    def count(self, lane=None, tenant=None, engine=None) -> int:
        return self._diffs(lane, tenant, engine)[0]

    def percentile(self, p: float, lane=None, tenant=None, engine=None
                   ) -> Optional[float]:
        """Window percentile in MILLISECONDS, or None on an empty
        window."""
        _, _, merged = self._diffs(lane, tenant, engine)
        v = _pct_from_counts(merged, p)
        return None if v is None else v * 1e3

    def mean_ms(self, lane=None, tenant=None, engine=None
                ) -> Optional[float]:
        n, s, _ = self._diffs(lane, tenant, engine)
        return (s / n * 1e3) if n else None

    def max_ms(self, lane=None, tenant=None, engine=None
               ) -> Optional[float]:
        _, _, merged = self._diffs(lane, tenant, engine)
        v = _max_from_counts(merged)
        return None if v is None else v * 1e3

    # -- sub-cycle arrival window ----------------------------------------
    def _sub_diff(self) -> Tuple[int, Dict[int, int]]:
        with _lock:
            n, _, buckets = _sub_hist.snapshot()
        bn, _, bb = self._sub_base
        return (n - bn, {i: c - bb.get(i, 0) for i, c in buckets.items()
                         if c - bb.get(i, 0) > 0})

    def subcycle_count(self) -> int:
        return self._sub_diff()[0]

    def subcycle_percentile(self, p: float) -> Optional[float]:
        v = _pct_from_counts(self._sub_diff()[1], p)
        return None if v is None else v * 1e3

    def subcycle_max_ms(self) -> Optional[float]:
        v = _max_from_counts(self._sub_diff()[1])
        return None if v is None else v * 1e3

    def closed(self) -> int:
        return _closed_total - self._closed0


def window() -> LedgerWindow:
    return LedgerWindow()


def percentile(p: float, lane=None, tenant=None, engine=None
               ) -> Optional[float]:
    """Process-lifetime percentile in ms (no window) — /debug surfaces."""
    with _lock:
        snaps = list(_select({k: h.snapshot() for k, h in _hists.items()},
                             lane, tenant, engine))
    _, _, merged = _merge(snaps)
    v = _pct_from_counts(merged, p)
    return None if v is None else v * 1e3


def stats() -> dict:
    """The ledger section of metrics.counters_snapshot() — counters plus
    compact per-lane arrival->bind percentiles."""
    with _lock:
        lanes: Dict[str, List] = {}
        for (lane, _, _), h in _hists.items():
            lanes.setdefault(lane, []).append(h.snapshot())
        open_n = len(_open)
        closed = _closed_total
        unmatched = _unmatched_total
        evicted = _evicted_total
        keys = len(_hists)
    per_lane = {}
    for lane, snaps in sorted(lanes.items()):
        n, _, merged = _merge(snaps)
        if not n:
            continue
        per_lane[lane] = {
            "count": n,
            "p50_ms": round((_pct_from_counts(merged, 50.0) or 0.0) * 1e3,
                            3),
            "p99_ms": round((_pct_from_counts(merged, 99.0) or 0.0) * 1e3,
                            3),
        }
    out = {
        "enabled": _enabled,
        "closed_total": closed,
        "deferred_closed_total": 0,
        "unmatched_total": unmatched,
        "evicted_total": evicted,
        "open": open_n,
        "keys": keys,
    }
    if per_lane:
        out["arrival_bind"] = per_lane
    sub = subcycle_percentiles()
    if sub:
        out["subcycle_arrival"] = sub
    with _lock:
        adm = {f"{t}/{ln}": h.snapshot()
               for (t, ln), h in _admission_hists.items()}
    if adm:
        out["admission_wait"] = {
            k: {"count": n,
                "p99_ms": round((_pct_from_counts(b, 99.0) or 0.0) * 1e3,
                                3)}
            for k, (n, _, b) in sorted(adm.items())}
    return out


# ---------------------------------------------------------------------
# closed-record retention (an audit mode)
# ---------------------------------------------------------------------

def retain(capacity: int = 65536) -> None:
    """Keep the last ``capacity`` CLOSED records for audit (a soak
    asserts every bound pod closed with monotone stamps). OFF by
    default: production closes into histograms only."""
    global _retained
    with _lock:
        _retained = deque(maxlen=int(capacity))


def stop_retention() -> None:
    global _retained
    with _lock:
        _retained = None


def retained() -> List[dict]:
    with _lock:
        return list(_retained) if _retained is not None else []
