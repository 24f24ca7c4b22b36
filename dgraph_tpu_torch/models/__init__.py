"""Models as ``nn.Module``s, written against the communicator API."""

from dgraph_tpu_torch.models.gcn import GCN, GraphConvLayer
from dgraph_tpu_torch.models.sage import GraphSAGE, SAGEConv
from dgraph_tpu_torch.models.transformer import SeqTransformerLM, TransformerBlock

__all__ = ["GCN", "GraphConvLayer", "GraphSAGE", "SAGEConv", "SeqTransformerLM",
           "TransformerBlock"]
