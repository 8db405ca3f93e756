"""Fault injection, the backoff policy, and the degradation ladder
(ref: kubebatch_tpu/faults.py).

- **Injection seams** (``check`` / ``should_fail``): named crossing
  points in the failure-prone layers — ``device.dispatch`` before every
  allocate solve (per-visit scan, fused, batched), ``cache.bind`` (per
  bind and per ``bind_many`` chunk), ``cache.evict``, ``cache.resync``,
  and ``cache.fold`` in the event fold (a fired fold seam demotes the
  fold to snapshot-primary instead of raising). Disarmed, a crossing is
  one module-global read and a ``None`` compare. Armed with ``arm()``;
  this package reads no process-wide settings, so the reference's
  KUBEBATCH_FAULTS / KUBEBATCH_QUARANTINE_S become arguments (a plan,
  ``DegradationLadder(policy=BackoffPolicy(cooldown=...))`` or the
  process-wide ``LADDER.policy``).
- **BackoffPolicy**: the ladder's recovery timing in one object.
- **DegradationLadder**: cycle-level engine degradation driven by the
  scheduler loop (runtime/scheduler.py). Repeated cycle failures demote
  the allocate engine one tier at a time — full -> batched -> fused ->
  host — through ``cap_engine``, counted in ``engine_demotions_total``;
  sustained healthy cycles, the policy's cooldown and an optional health
  probe re-promote one level at a time. On a CUDA cache the ladder stops
  at "fused" (``CARD_MAX_LEVEL``): the card's work stays on the card, so
  the "host" level is a CPU cache's only (the reference demotes any
  backend to its host loops).

Not here yet: the reference's ``Quarantine`` / ``ShedLadder`` (the rpc
breaker and the tenant service's shedding, ROADMAP A8) and arming from
the daemon's settings (the CLI, A9).
"""
from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from .metrics import (count_engine_demotion, count_fault_injected,
                      set_degradation_level)

log = logging.getLogger("kubebatch.faults")

class FaultInjected(RuntimeError):
    """Raised at an armed seam: a plain RuntimeError subclass, so the
    injected fault runs the handler a real failure would."""


class FaultPlan:
    """A seeded, thread-safe fault schedule.

    ``rates`` maps seam (or "family.*" / "*") to a per-crossing failure
    probability; ``counts`` maps an exact seam to "fail the first N
    crossings, then pass". A seam with a count entry is governed by the
    count alone. The same seed gives the same schedule for the same
    crossing sequence."""

    def __init__(self, rates: Optional[Dict[str, float]] = None,
                 counts: Optional[Dict[str, int]] = None, seed: int = 0):
        self.rates = dict(rates or {})
        self.counts = dict(counts or {})
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        #: injected crossings per seam
        self.injected: Dict[str, int] = {}

    def _rate_for(self, seam: str) -> float:
        rate = self.rates.get(seam)
        if rate is not None:
            return rate
        rate = self.rates.get(seam.split(".", 1)[0] + ".*")
        if rate is not None:
            return rate
        return self.rates.get("*", 0.0)

    def should_fail(self, seam: str) -> bool:
        with self._lock:
            n = self.counts.get(seam)
            if n is not None:
                if n <= 0:
                    return False
                self.counts[seam] = n - 1
            else:
                rate = self._rate_for(seam)
                if rate <= 0.0 or self._rng.random() >= rate:
                    return False
            self.injected[seam] = self.injected.get(seam, 0) + 1
            return True


#: the armed plan; None = disarmed
_PLAN: Optional[FaultPlan] = None


def arm(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide and return it."""
    global _PLAN
    _PLAN = plan
    log.warning("fault injection ARMED (seed=%d rates=%s counts=%s)",
                plan.seed, plan.rates, plan.counts)
    return plan


def disarm() -> None:
    global _PLAN
    if _PLAN is not None:
        log.warning("fault injection disarmed (injected=%s)",
                    _PLAN.injected)
    _PLAN = None


def active_plan() -> Optional[FaultPlan]:
    return _PLAN


def armed() -> bool:
    return _PLAN is not None


def should_fail(seam: str) -> bool:
    """True when the armed plan fires at ``seam`` (counted)."""
    plan = _PLAN
    if plan is None:
        return False
    if plan.should_fail(seam):
        count_fault_injected(seam)
        return True
    return False


def check(seam: str) -> None:
    """Raise FaultInjected when the armed plan fires at ``seam``."""
    if _PLAN is not None and should_fail(seam):
        raise FaultInjected(f"injected fault at seam <{seam}>")


def check_raise(seam: str, exc_factory: Callable[[str], BaseException]
                ) -> None:
    """Typed variant for seams whose handlers dispatch on the exception
    class."""
    if _PLAN is not None and should_fail(seam):
        raise exc_factory(f"injected fault at seam <{seam}>")


def parse_fault_spec(spec: str, seed: int = 0) -> FaultPlan:
    """Parse "seam:rate,seam:nN,..." — ``rate`` a probability, ``nN`` a
    fail-first-N count; a bare seam means rate 1.0."""
    rates: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        seam, _, val = part.partition(":")
        seam = seam.strip()
        val = val.strip() or "1"
        if val.startswith("n"):
            counts[seam] = int(val[1:])
        else:
            rates[seam] = float(val)
    return FaultPlan(rates=rates, counts=counts, seed=seed)


@dataclass(frozen=True)
class BackoffPolicy:
    """The ladder's recovery timing: ``cooldown`` seconds before the
    first recovery probe after a demotion, escalated by
    ``probe_backoff`` per level up to ``max_cooldown``. (The reference's
    policy also carries the cache retry queue's delays and a jittered
    breaker schedule, for its Quarantine: not ported, ROADMAP A8.)"""

    cooldown: float = 60.0
    probe_backoff: float = 2.0
    max_cooldown: float = 480.0

    def quarantine_for(self, strikes: int) -> float:
        return min(self.cooldown * (self.probe_backoff
                                    ** max(0, strikes - 1)),
                   self.max_cooldown)


DEFAULT_BACKOFF = BackoffPolicy()


# ---------------------------------------------------------------------
# the cycle degradation ladder
# ---------------------------------------------------------------------

#: ladder levels in demotion order; level 0 imposes no cap
LADDER_LEVELS = ("full", "batched", "fused", "host")

#: the deepest level over a CUDA cache: "fused" (with "jax", the per-visit
#: scan) is the card's last engine tier, and a failing kernel keeps
#: failing its cycles there, counted, instead of moving to the host loops
CARD_MAX_LEVEL = LADDER_LEVELS.index("fused")

#: observers notified (with the new level) after a ladder demotion; they
#: run outside the ladder lock and must never raise into the loop
_DEMOTION_HOOKS: list = []


def on_ladder_demotion(cb: Callable[[int], None]) -> None:
    if cb not in _DEMOTION_HOOKS:
        _DEMOTION_HOOKS.append(cb)


def remove_ladder_demotion_hook(cb: Callable[[int], None]) -> None:
    while cb in _DEMOTION_HOOKS:
        _DEMOTION_HOOKS.remove(cb)


def _notify_demotion(level: int) -> None:
    for cb in list(_DEMOTION_HOOKS):
        try:
            cb(level)
        except Exception:                  # pragma: no cover — observer bug
            log.exception("ladder demotion hook failed")


#: engine tier ranks: an engine at rank >= the ladder level is already
#: at or below the cap and passes through unchanged
_ENGINE_RANK = {"rpc": 0, "sharded": 0, "hier": 0, "activeset": 0,
                "batched": 1, "native": 1, "fused": 2, "jax": 2, "host": 3}


class DegradationLadder:
    """Engine degradation driven by guarded scheduler cycles.

    ``record_failure`` after ``demote_after`` consecutive failed cycles
    demotes one level; ``record_success`` after ``promote_after``
    consecutive healthy cycles — once the policy cooldown since the
    demotion has elapsed and the optional health ``probe`` has answered
    True on its own thread — re-promotes one level. AllocateAction
    consults ``cap_engine`` once per cycle. ``on_card`` (the cycle's
    cache lives on a CUDA device) holds both at ``CARD_MAX_LEVEL``."""

    def __init__(self, policy: Optional[BackoffPolicy] = None,
                 demote_after: int = 2, promote_after: int = 3,
                 probe: Optional[Callable[[], bool]] = None):
        self.demote_after = demote_after
        self.promote_after = promote_after
        self.policy = policy
        self.probe = probe
        self._lock = threading.Lock()
        self.level = 0
        self._fail_streak = 0
        self._ok_streak = 0
        self._next_probe_at = 0.0
        #: the probe (a subprocess device query) never blocks the
        #: scheduling thread: record_success consults the LAST result and
        #: starts a fresh probe on a daemon thread when one is due
        self._probe_running = False
        self._probe_result: Optional[bool] = None

    def _pol(self) -> BackoffPolicy:
        return self.policy or DEFAULT_BACKOFF

    def record_failure(self, on_card: bool = False) -> None:
        deepest = CARD_MAX_LEVEL if on_card else len(LADDER_LEVELS) - 1
        with self._lock:
            self._fail_streak += 1
            self._ok_streak = 0
            if (self._fail_streak < self.demote_after
                    or self.level >= deepest):
                return
            self.level += 1
            level = self.level
            self._fail_streak = 0
            self._next_probe_at = (time.monotonic()
                                   + self._pol().quarantine_for(self.level))
            set_degradation_level(self.level)
            log.warning("degradation ladder DEMOTED to level %d (%s)",
                        self.level, LADDER_LEVELS[self.level])
        _notify_demotion(level)

    def _run_probe_async(self, probe: Callable[[], bool]) -> None:
        def _worker():
            try:
                ok = bool(probe())
            except Exception:
                ok = False
            with self._lock:
                self._probe_running = False
                self._probe_result = ok
                if not ok:
                    self._next_probe_at = (
                        time.monotonic()
                        + self._pol().quarantine_for(self.level))
            if not ok:
                log.warning("degradation ladder: recovery probe failed "
                            "at level %d; staying", self.level)

        threading.Thread(target=_worker, daemon=True,
                         name="kb-ladder-probe").start()

    def record_success(self) -> None:
        with self._lock:
            self._ok_streak += 1
            self._fail_streak = 0
            if self.level == 0 or self._ok_streak < self.promote_after:
                return
            if time.monotonic() < self._next_probe_at:
                return
            probe = self.probe
            do_probe = False
            if probe is not None:
                if self._probe_running:
                    return                     # answer pending; stay put
                if self._probe_result is None:
                    self._probe_running = True
                    do_probe = True
                else:
                    passed = self._probe_result
                    self._probe_result = None   # consumed
                    if not passed:
                        return
            if not do_probe:
                self.level -= 1
                self._ok_streak = 0
                set_degradation_level(self.level)
                log.warning("degradation ladder promoted to level %d (%s)",
                            self.level, LADDER_LEVELS[self.level])
                return
        self._run_probe_async(probe)

    def cap_engine(self, mode: str, on_card: bool = False) -> str:
        """The engine the current level allows: modes already at or
        below the cap pass through; higher tiers demote to the level's
        engine (counted in engine_demotions_total). ``on_card`` reads
        a deeper level as ``CARD_MAX_LEVEL`` (a ladder another loop
        walked past it)."""
        level = min(self.level, CARD_MAX_LEVEL) if on_card else self.level
        if level == 0:
            return mode
        if _ENGINE_RANK.get(mode, len(LADDER_LEVELS)) >= level:
            return mode
        capped = LADDER_LEVELS[level]
        count_engine_demotion(mode, capped)
        return capped

    def reset(self) -> None:
        with self._lock:
            self.level = 0
            self._fail_streak = 0
            self._ok_streak = 0
            self._next_probe_at = 0.0
            self._probe_running = False
            self._probe_result = None
        set_degradation_level(0)


#: the process-wide ladder: the scheduler loop drives it, the allocate
#: action consults it
LADDER = DegradationLadder()


def reset() -> None:
    """Disarm and clear every piece of process-wide robustness state,
    the ladder's probe and policy included."""
    global _PLAN
    _PLAN = None
    LADDER.reset()
    LADDER.probe = None
    LADDER.policy = None
