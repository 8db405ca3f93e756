"""In-memory scheduling domain model (ref: pkg/scheduler/api)."""
from .cluster import ClusterInfo, QueueInfo
from .job import (JobInfo, TaskInfo, get_job_id, get_pod_resource_request,
                  get_pod_resource_without_init_containers, get_task_status,
                  job_terminated, pod_key)
from .node import NodeInfo
from .resource import (MIN_MEMORY, MIN_MILLI_CPU, MIN_MILLI_GPU, RESOURCE_DIM,
                       RESOURCE_NAMES, Resource, res_min, resource_names,
                       dominant_share, share, vecs)
from .types import (JobReadiness, TaskStatus, ValidateResult,
                    allocated_status, allocated_statuses, ready_statuses,
                    validate_status_update)

__all__ = [
    "ClusterInfo", "QueueInfo", "JobInfo", "TaskInfo", "NodeInfo", "Resource",
    "TaskStatus", "JobReadiness", "ValidateResult",
    "MIN_MEMORY", "MIN_MILLI_CPU", "MIN_MILLI_GPU",
    "RESOURCE_DIM", "RESOURCE_NAMES",
    "allocated_status", "allocated_statuses", "ready_statuses",
    "validate_status_update",
    "get_job_id", "get_pod_resource_request",
    "get_pod_resource_without_init_containers", "get_task_status",
    "dominant_share", "job_terminated", "pod_key", "res_min", "resource_names", "share", "vecs",
]
