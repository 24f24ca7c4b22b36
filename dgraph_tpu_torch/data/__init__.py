"""Graph data: synthetic generators and the partitioned DistributedGraph."""

from dgraph_tpu_torch.data import synthetic
from dgraph_tpu_torch.data.graph import DistributedGraph, symmetric_norm_weights

__all__ = ["synthetic", "DistributedGraph", "symmetric_norm_weights"]
