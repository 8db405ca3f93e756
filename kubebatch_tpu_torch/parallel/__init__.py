"""The node mesh and its solver workers (the node-sharded engines' means:
kernels/batched_sharded.py, kernels/sharded.py)."""
from .mesh import NodeMesh, node_mesh, shard_bucket, world_size

__all__ = ["NodeMesh", "node_mesh", "shard_bucket", "world_size"]
