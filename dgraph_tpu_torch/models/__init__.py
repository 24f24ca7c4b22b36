"""Models as ``nn.Module``s, written against the communicator API."""

from dgraph_tpu_torch.models.gat import GAT, GATConv
from dgraph_tpu_torch.models.gcn import GCN, GraphConvLayer
from dgraph_tpu_torch.models.graph_transformer import GPSLayer, GraphTransformer
from dgraph_tpu_torch.models.mlp import MLP
from dgraph_tpu_torch.models.sage import GraphSAGE, SAGEConv
from dgraph_tpu_torch.models.transformer import SeqTransformerLM, TransformerBlock

__all__ = ["GAT", "GATConv", "GCN", "GPSLayer", "GraphConvLayer", "GraphSAGE",
           "GraphTransformer", "MLP", "SAGEConv", "SeqTransformerLM", "TransformerBlock"]
