"""Cluster-state cache + event ingestion + writeback seams
(ref: pkg/scheduler/cache)."""
from .cache import (RetryQueue, SchedulerCache, create_shadow_pod_group,
                    shadow_pod_group)
from .interface import (Binder, Cache, EventRecorder, Evictor, ListRecorder,
                        NullBinder, NullEvictor, NullStatusUpdater,
                        NullVolumeBinder, StatusUpdater, VolumeBinder)

__all__ = [
    "SchedulerCache", "RetryQueue", "create_shadow_pod_group",
    "shadow_pod_group", "Binder", "Cache", "EventRecorder", "Evictor",
    "ListRecorder", "NullBinder", "NullEvictor", "NullStatusUpdater",
    "NullVolumeBinder", "StatusUpdater", "VolumeBinder",
]
