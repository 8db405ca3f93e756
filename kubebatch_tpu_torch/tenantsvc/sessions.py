"""Per-tenant server-side state (ref: kubebatch_tpu/tenantsvc/sessions.py).

Immutable state ships once, mutable mirrors re-ship only when the
client's version moved, and an out-of-sync read is refused rather than
silently served from stale arrays. Per tenant, for every kind of
uploaded state:

- **independent versioning**: each tenant's mirrors (the last decisions,
  and whatever else a client uploads) carry their own monotonic version
  per kind; tenants never share a version sequence;
- **validation**: a version that does not strictly advance is a
  rollback — two schedulers claiming one tenant id, or a replayed
  upload — and is REJECTED (StaleMirrorError), never applied;
- **quarantine**: a tenant that keeps uploading stale versions is
  quarantined through faults.Quarantine (``TENANT_QUARANTINE``);
  admission refuses it until the cooldown's recovery probe.

Not here yet: the reference's per-tenant victim registry
(``TenantSession.victims``, rpc/victims_wire.VictimRegistry). It comes
with the victim wire (ROADMAP A8), after the transport.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..faults import Quarantine

__all__ = ["MirrorStore", "StaleMirrorError", "TenantSession",
           "TenantRegistry", "TENANT_QUARANTINE", "on_mirror_upload",
           "remove_mirror_upload_hook"]

log = logging.getLogger("kubebatch.tenantsvc")

#: observers notified (session, kind, version, payload) after a CLEAN
#: mirror upload commits (the reference's warm-standby replication plane
#: registers here). Hooks run outside the store lock and must never
#: raise into the upload path.
_UPLOAD_HOOKS: List[Callable] = []


def on_mirror_upload(cb: Callable) -> None:
    if cb not in _UPLOAD_HOOKS:
        _UPLOAD_HOOKS.append(cb)


def remove_mirror_upload_hook(cb: Callable) -> None:
    try:
        _UPLOAD_HOOKS.remove(cb)
    except ValueError:
        pass


def _notify_upload(session: "TenantSession", kind: str, version: int,
                   payload) -> None:
    for cb in list(_UPLOAD_HOOKS):
        try:
            cb(session, kind, version, payload)
        except Exception:          # pragma: no cover — observer bug
            log.exception("mirror upload hook failed")

#: quarantine for misbehaving tenants (repeated stale/rollback uploads):
#: backoff-gated recovery probes, escalating cooldown, clear() on a
#: clean upload
TENANT_QUARANTINE = Quarantine()

#: consecutive stale uploads before the tenant trips its quarantine —
#: one stale upload is a benign race (a retried rpc, a slow pipe), a
#: streak is split-brain
STALE_STRIKES_BEFORE_QUARANTINE = 2


class StaleMirrorError(ValueError):
    """An upload whose version does not strictly advance the tenant's
    mirror for that kind — rejected, never applied."""


class MirrorStore:
    """Versioned per-kind mirrors for one tenant.

    ``upload(kind, version, payload)`` requires ``version`` to strictly
    exceed the stored version for ``kind`` (first upload: any version).
    ``get(kind, version)`` returns the payload only when the stored
    version matches — the out-of-sync refusal the victim wire pioneered.
    ``latest(kind)`` returns (version, payload) regardless, for the
    serve-stale-mirror shed mode, which by definition wants the last
    good state."""

    def __init__(self):
        self._lock = threading.Lock()
        self._mirrors: Dict[str, Tuple[int, object]] = {}

    def upload(self, kind: str, version: int, payload) -> None:
        with self._lock:
            have = self._mirrors.get(kind)
            if have is not None and version <= have[0]:
                raise StaleMirrorError(
                    f"stale {kind} mirror upload: version {version} does "
                    f"not advance stored version {have[0]}")
            self._mirrors[kind] = (int(version), payload)

    def get(self, kind: str, version: int):
        with self._lock:
            have = self._mirrors.get(kind)
            if have is None or have[0] != version:
                raise StaleMirrorError(
                    f"{kind} mirror out of sync (have "
                    f"{have[0] if have else None}, asked {version}); "
                    "resend mirrors")
            return have[1]

    def latest(self, kind: str) -> Optional[Tuple[int, object]]:
        with self._lock:
            return self._mirrors.get(kind)

    def version(self, kind: str) -> int:
        with self._lock:
            have = self._mirrors.get(kind)
            return have[0] if have is not None else -1

    def kinds(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._mirrors))


class TenantSession:
    """Everything the service holds for one tenant. Built lazily on the
    tenant's first request; its mirrors live here, so there is no shared
    namespace to bleed across. (The reference's session also owns a
    victim registry; see the module docstring.)"""

    def __init__(self, tenant: str, origin: str = ""):
        self.tenant = tenant
        #: the service address this session lives on ("" for a
        #: standalone registry)
        self.origin = origin
        self.created = time.monotonic()
        self.mirrors = MirrorStore()
        #: scheduling weight for the weighted-fair dequeue (last writer
        #: wins; the reference's solve handler sets it from each
        #: request's ``kb-weight`` metadata)
        self.weight = 1.0
        self._stale_streak = 0
        self._lock = threading.Lock()

    # -- mirror uploads with the quarantine discipline -------------------
    def upload_mirror(self, kind: str, version: int, payload) -> None:
        """Versioned upload; a stale version raises AND counts toward
        the tenant's quarantine strike streak (cleared by any clean
        upload)."""
        try:
            self.mirrors.upload(kind, version, payload)
        except StaleMirrorError:
            with self._lock:
                self._stale_streak += 1
                streak = self._stale_streak
            if streak >= STALE_STRIKES_BEFORE_QUARANTINE:
                TENANT_QUARANTINE.trip(self.tenant)
                from ..metrics import count_tenant
                count_tenant(self.tenant, "quarantined")
            raise
        with self._lock:
            self._stale_streak = 0
        TENANT_QUARANTINE.clear(self.tenant)
        _notify_upload(self, kind, version, payload)

    def quarantined(self) -> bool:
        return TENANT_QUARANTINE.blocked(self.tenant)


class TenantRegistry:
    """Thread-safe tenant-session store. Bounded: the service serves a
    configured pool of clusters — when the cap is hit, UNKNOWN tenants
    are refused at admission instead of silently evicting a live
    tenant's state (evicting mirrors mid-run would force a re-upload
    storm, the overload amplifier admission control exists to
    prevent)."""

    MAX_TENANTS = 64

    def __init__(self, max_tenants: Optional[int] = None,
                 origin: str = ""):
        self.max_tenants = max_tenants or self.MAX_TENANTS
        #: service address this registry serves; every session created
        #: here inherits it
        self.origin = origin
        self._sessions: Dict[str, TenantSession] = {}
        self._lock = threading.Lock()

    def get(self, tenant: str, create: bool = True
            ) -> Optional[TenantSession]:
        with self._lock:
            ssn = self._sessions.get(tenant)
            if ssn is None and create:
                if len(self._sessions) >= self.max_tenants:
                    # an AdmissionError subclass: the over-cap tenant
                    # gets a clean refusal, not a generic failure
                    from .admission import RegistryFullError

                    raise RegistryFullError(
                        f"tenant registry full ({self.max_tenants}); "
                        f"refusing new tenant {tenant!r}")
                ssn = self._sessions[tenant] = TenantSession(
                    tenant, origin=self.origin)
            return ssn

    def tenants(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._sessions))

    def drop(self, tenant: str) -> None:
        with self._lock:
            self._sessions.pop(tenant, None)

    def reset(self) -> None:
        with self._lock:
            self._sessions.clear()
