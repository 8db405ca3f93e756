"""tenantsvc — the solver as a multi-tenant solve service on one card
(ref: kubebatch_tpu/tenantsvc).

Many clusters share one solver. Three parts:

- **Tenant sessions** (sessions.py): per-tenant server-side state — a
  :class:`MirrorStore` of independently versioned mirrors (stale uploads
  REJECTED, repeat offenders quarantined through faults.Quarantine).
- **Cross-tenant dispatch batching** (megasolve.py): concurrent solve
  requests whose fused shapes and static configuration coincide
  coalesce into ONE launch of ``csrc/mega_fused.cu`` (one block per
  lane), one counted copy back, the per-tenant host blocks scattered
  back.
- **Admission control** (admission.py + service.py): a bounded
  per-tenant queue with priority lanes ("latency" drains strictly
  first) and weighted-fair dequeue across tenants, riding the shed
  ladder in faults.py (``SHED_LEVELS``): under sustained overload the
  service first serves the lowest lane from the tenant's stale
  decision mirror, then rejects the lowest lane outright — both counted
  per tenant (``metrics.tenant_counters``).

Requests are the wire's SnapshotRequest messages (rpc/wire.py) handed in
process to ``TenantSolveService.solve`` / ``solve_many``. Not here yet:
the grpc transport that tags them with a tenant from its metadata, the
victim registries, and the fleet (``TenantRouter``, ``ReplicationPlane``)
— ROADMAP A8.
"""
from __future__ import annotations

from .sessions import (MirrorStore, StaleMirrorError,  # noqa: F401
                       TenantRegistry, TenantSession, TENANT_QUARANTINE)

__all__ = ["MirrorStore", "StaleMirrorError", "TenantRegistry",
           "TenantSession", "TENANT_QUARANTINE"]
