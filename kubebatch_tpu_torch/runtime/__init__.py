"""The scheduler loop (ref: kubebatch_tpu/runtime, pkg/scheduler)."""
from .scheduler import (DEFAULT_SCHEDULER_CONF, Scheduler,
                        load_scheduler_conf)

__all__ = ["DEFAULT_SCHEDULER_CONF", "Scheduler", "load_scheduler_conf"]
