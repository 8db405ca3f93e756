"""Policy plugins (ref: pkg/scheduler/plugins).

Importing this package registers all built-in plugin builders, mirroring
the reference's blank-import self-registration (plugins/factory.go:253-263).
"""
from ..framework import register_plugin_builder
from . import (conformance, drf, gang, nodeorder, predicates, priority,
               proportion)

register_plugin_builder(gang.NAME, gang.new)
register_plugin_builder(priority.NAME, priority.new)
register_plugin_builder(drf.NAME, drf.new)
register_plugin_builder(proportion.NAME, proportion.new)
register_plugin_builder(predicates.NAME, predicates.new)
register_plugin_builder(nodeorder.NAME, nodeorder.new)
register_plugin_builder(conformance.NAME, conformance.new)

__all__ = ["conformance", "drf", "gang", "nodeorder", "predicates",
           "priority", "proportion"]
