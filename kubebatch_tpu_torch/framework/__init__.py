"""Session / plugin registry / tiered dispatch / Statement
(ref: pkg/scheduler/framework)."""
from .event import Event, EventHandler
from .framework import CloseSession, OpenSession
from .interface import Action, Plugin
from .registry import (cleanup_plugin_builders, get_action,
                       get_plugin_builder, list_actions, register_action,
                       register_plugin_builder)
from .session import (PredicateError, Session, VolumeAllocationError,
                      close_session, job_status,
                      open_session, validate_jobs)
from .statement import Statement

__all__ = [
    "Event", "EventHandler", "CloseSession", "OpenSession", "Action",
    "Plugin", "cleanup_plugin_builders", "get_action", "get_plugin_builder",
    "list_actions", "register_action", "register_plugin_builder",
    "PredicateError", "Session", "VolumeAllocationError",
    "close_session", "job_status",
    "open_session", "validate_jobs", "Statement",
]
