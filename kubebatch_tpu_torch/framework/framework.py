"""Session lifecycle orchestration (ref: pkg/scheduler/framework/framework.go).

Divergence note: the reference runs its JobValid drop inside openSession
BEFORE tiers/plugins are installed (framework.go:33-40 + session.go:92-111),
which makes the filter a no-op — jobValidFns is always empty at that point.
We run validation after OnSessionOpen, which is the evidently intended
behavior (gang's JobValidFn actually fires); end-state parity holds because
invalid jobs could never dispatch anyway.
"""
from __future__ import annotations

from typing import List

from ..conf import Tier
from .registry import get_plugin_builder
from .session import Session, close_session, open_session, validate_jobs


def open_session_with_tiers(cache, tiers: List[Tier],
                            enable_preemption: bool = False,
                            snapshot=None) -> Session:
    """ref: framework.go:29-50 (OpenSession)."""
    ssn = open_session(cache, enable_preemption, snapshot=snapshot)
    ssn.tiers = tiers
    for tier in tiers:
        for opt in tier.plugins:
            builder = get_plugin_builder(opt.name)
            if builder is None:
                continue
            plugin = builder(opt.arguments)
            ssn.plugins[plugin.name] = plugin
    for plugin in ssn.plugins.values():
        plugin.on_session_open(ssn)
    validate_jobs(ssn)
    return ssn


# keep the reference's exported names as aliases
OpenSession = open_session_with_tiers


def CloseSession(ssn: Session) -> None:
    """ref: framework.go:53-61. Before anything else, roll back any
    statement a mid-action fault left open — plugin close hooks and the
    status write-back must observe the pre-transaction state, never a
    half-applied eviction batch."""
    for st in list(getattr(ssn, "open_statements", ()) or ()):
        st.discard()
    for plugin in ssn.plugins.values():
        plugin.on_session_close(ssn)
    close_session(ssn)


close_session_with_plugins = CloseSession
