"""Scheduler policy configuration schema.

ref: pkg/scheduler/conf/scheduler_conf.go. YAML layout is identical to the
reference's (`actions` string + `tiers` of plugins with per-plugin disable
flags and free-form string arguments) so existing kube-batch config files
parse unchanged.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List


@dataclass
class PluginOption:
    """ref: scheduler_conf.go:210-231."""
    name: str
    job_order_disabled: bool = False
    job_ready_disabled: bool = False
    task_order_disabled: bool = False
    preemptable_disabled: bool = False
    reclaimable_disabled: bool = False
    queue_order_disabled: bool = False
    predicate_disabled: bool = False
    node_order_disabled: bool = False
    arguments: Dict[str, str] = field(default_factory=dict)


@dataclass
class Tier:
    plugins: List[PluginOption] = field(default_factory=list)


@dataclass
class SchedulerConfiguration:
    actions: str = ""
    tiers: List[Tier] = field(default_factory=list)


_YAML_FLAG_KEYS = {
    "disableJobOrder": "job_order_disabled",
    "disableJobReady": "job_ready_disabled",
    "disableTaskOrder": "task_order_disabled",
    "disablePreemptable": "preemptable_disabled",
    "disableReclaimable": "reclaimable_disabled",
    "disableQueueOrder": "queue_order_disabled",
    "disablePredicate": "predicate_disabled",
    "disableNodeOrder": "node_order_disabled",
}


def parse_scheduler_conf(conf_str: str) -> SchedulerConfiguration:
    """Parse the reference-compatible YAML policy file."""
    import yaml

    raw = yaml.safe_load(conf_str) or {}
    tiers: List[Tier] = []
    for tier_raw in raw.get("tiers") or []:
        plugins: List[PluginOption] = []
        for p in tier_raw.get("plugins") or []:
            opt = PluginOption(name=p["name"])
            for yaml_key, attr in _YAML_FLAG_KEYS.items():
                if yaml_key in p:
                    setattr(opt, attr, bool(p[yaml_key]))
            opt.arguments = {str(k): str(v)
                             for k, v in (p.get("arguments") or {}).items()}
            plugins.append(opt)
        tiers.append(Tier(plugins=plugins))
    return SchedulerConfiguration(actions=raw.get("actions", ""), tiers=tiers)


#: the shipped policy (config/kube-batch-conf.yaml, mirroring the
#: reference's config file): actions + the two-tier plugin stack
SHIPPED_CONF = """
actions: "reclaim, allocate, backfill, preempt"
tiers:
- plugins:
  - name: priority
  - name: gang
  - name: conformance
- plugins:
  - name: drf
  - name: predicates
  - name: proportion
  - name: nodeorder
"""


def shipped_tiers() -> List[Tier]:
    """The shipped two-tier plugin stack as parsed Tier objects — the
    single construction point benches, the multichip dryrun, and the
    equivalence suites share."""
    return parse_scheduler_conf(SHIPPED_CONF).tiers


#: per-config action order (BASELINE.md scenarios; cfg4/cfg5 use the
#: shipped config/kube-batch-conf.yaml order). "2p"/"3p"/"5p" are the
#: predicate-rich variants. ONE definition shared by bench.py and
#: compilesvc/profile.py — the registered compile surface must describe
#: the same cycles the bench drives.
CONFIG_ACTIONS = {
    1: ("allocate",),
    2: ("allocate",),
    3: ("allocate", "backfill"),
    4: ("reclaim", "allocate", "backfill", "preempt"),
    5: ("reclaim", "allocate", "backfill", "preempt"),
    # cfg6/cfg7 (50k / 100k nodes, ROADMAP item 2): allocate-only — the
    # scale axis pins the SOLVER (two-level hier engine); the 4-action
    # stack at this scale rides the scenario item (ROADMAP item 5)
    6: ("allocate",),
    7: ("allocate",),
    "2p": ("allocate",),
    "3p": ("allocate", "backfill"),
    "5p": ("reclaim", "allocate", "backfill", "preempt"),
    # "t": the per-tenant cluster of the multi-tenant sidecar mix —
    # sized so its steady cycles stay BELOW the batched threshold, i.e.
    # the fused engine's regime
    "t": ("allocate",),
}
