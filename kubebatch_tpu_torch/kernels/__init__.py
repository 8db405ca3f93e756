"""Device solvers: host tensorization, the device session, and the fused
and batched allocate solves with their hand-written CUDA kernels
(csrc/)."""
from .solver import ALLOC, ALLOC_OB, FAIL, PIPELINE, SKIP, DeviceSession
from .tensorize import NodeState, TaskBatch, pad_to_bucket

__all__ = ["ALLOC", "ALLOC_OB", "FAIL", "PIPELINE", "SKIP", "DeviceSession",
           "NodeState", "TaskBatch", "pad_to_bucket"]
