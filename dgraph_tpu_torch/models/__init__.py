"""GNN models as ``nn.Module``s, written against the communicator API."""

from dgraph_tpu_torch.models.gcn import GCN, GraphConvLayer
from dgraph_tpu_torch.models.sage import GraphSAGE, SAGEConv

__all__ = ["GCN", "GraphConvLayer", "GraphSAGE", "SAGEConv"]
