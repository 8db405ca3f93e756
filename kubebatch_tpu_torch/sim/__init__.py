"""Synthetic cluster generation (the same clusters as the reference
package's sim from the same spec and seed)."""
from .cluster import (BASELINE_SPECS, ClusterSpec, SimCluster,
                      baseline_cluster, build_cluster)

__all__ = ["BASELINE_SPECS", "ClusterSpec", "SimCluster", "baseline_cluster",
           "build_cluster"]
