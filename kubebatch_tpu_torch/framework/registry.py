"""Global plugin-builder and action registries
(ref: pkg/scheduler/framework/plugins.go)."""
from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple

from .interface import Action, Plugin

PluginBuilder = Callable[[Dict[str, str]], Plugin]

_mutex = threading.Lock()
_plugin_builders: Dict[str, PluginBuilder] = {}
_actions: Dict[str, Action] = {}


def register_plugin_builder(name: str, builder: PluginBuilder) -> None:
    with _mutex:
        _plugin_builders[name] = builder


def get_plugin_builder(name: str) -> Optional[PluginBuilder]:
    with _mutex:
        return _plugin_builders.get(name)


def cleanup_plugin_builders() -> None:
    with _mutex:
        _plugin_builders.clear()


def register_action(action: Action) -> None:
    with _mutex:
        _actions[action.name] = action


def get_action(name: str) -> Optional[Action]:
    with _mutex:
        return _actions.get(name)


def list_actions() -> Tuple[str, ...]:
    with _mutex:
        return tuple(_actions)
