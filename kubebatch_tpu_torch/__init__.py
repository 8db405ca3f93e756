"""kubebatch_tpu_torch — the PyTorch/CUDA port of kubebatch_tpu.

A batch/gang scheduler with kube-batch semantics whose allocate cycle runs
as one solve on an NVIDIA GPU, through hand-written CUDA kernels
(kernels/csrc/). The package stands alone: it imports torch and numpy,
never jax and nothing of ``kubebatch_tpu``, which stays in the repository
as the reference the port is tested against.

Layering (mirrors the reference package):

- ``objects``   — cluster API objects (Pod/Node/PodGroup/Queue/...).
- ``api``       — in-memory domain model (Resource/TaskInfo/JobInfo/
                  NodeInfo/QueueInfo/ClusterInfo), ref pkg/scheduler/api.
- ``cache``     — cluster-state mirror + event ingestion + writeback seams
                  (snapshot-primary), ref pkg/scheduler/cache.
- ``framework`` — Session / plugin registry / tiered dispatch / Statement.
- ``plugins``   — gang, drf, proportion, priority, predicates, nodeorder,
                  conformance.
- ``actions``   — allocate (fused device solve, host oracle).
- ``kernels``   — tensorization, the device session, the fused allocate
                  solve and its CUDA kernels.
- ``sim``       — synthetic clusters.
- ``device``    — device choice (the card unless the caller asks for the
                  CPU) and the one counted device->host copy.
- ``interop``   — the reference package's cycle arrays as this package's
                  tensors, for parity tests.
"""

__version__ = "0.4.1"
