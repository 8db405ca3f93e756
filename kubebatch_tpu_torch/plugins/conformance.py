"""conformance — never evict cluster-critical pods.

ref: pkg/scheduler/plugins/conformance/conformance.go:444-475.
"""
from __future__ import annotations

from typing import List

from ..api import TaskInfo
from ..framework import Plugin, Session

NAME = "conformance"

SYSTEM_CLUSTER_CRITICAL = "system-cluster-critical"
SYSTEM_NODE_CRITICAL = "system-node-critical"
NAMESPACE_SYSTEM = "kube-system"


class ConformancePlugin(Plugin):
    def __init__(self, arguments=None):
        self.arguments = arguments or {}

    @property
    def name(self) -> str:
        return NAME

    def on_session_open(self, ssn: Session) -> None:
        def evictable(evictor: TaskInfo,
                      evictees: List[TaskInfo]) -> List[TaskInfo]:
            victims = []
            for evictee in evictees:
                cls = evictee.pod.priority_class_name
                if (cls in (SYSTEM_CLUSTER_CRITICAL, SYSTEM_NODE_CRITICAL)
                        or evictee.namespace == NAMESPACE_SYSTEM):
                    continue
                victims.append(evictee)
            return victims

        ssn.add_preemptable_fn(NAME, evictable)
        ssn.add_reclaimable_fn(NAME, evictable)
        # also a hard veto: critical pods stay protected even when an empty
        # tier intersection falls through to a tier conformance isn't in
        # (see Session.victim_veto_fns)
        ssn.add_victim_veto_fn(NAME, evictable)


def new(arguments=None) -> ConformancePlugin:
    return ConformancePlugin(arguments)
