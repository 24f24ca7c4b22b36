"""GraphCast on the port: the multimesh, its three bipartite plans and the
model (counterpart of ``dgraph_tpu/models/graphcast``)."""

from dgraph_tpu_torch.models.graphcast.mesh import build_multimesh, icosahedron, MultiMesh
from dgraph_tpu_torch.models.graphcast.graph import GraphCastGraphs, build_graphcast_graphs
from dgraph_tpu_torch.models.graphcast.model import (
    GraphCast,
    MeshEdgeBlock,
    MeshNodeBlock,
    rollout,
)

__all__ = [
    "MultiMesh",
    "icosahedron",
    "build_multimesh",
    "GraphCastGraphs",
    "build_graphcast_graphs",
    "GraphCast",
    "MeshEdgeBlock",
    "MeshNodeBlock",
    "rollout",
]
