"""GraphSAGE (mean aggregator) — counterpart of ``dgraph_tpu/models/sage.py``.

SAGEConv: ``h_v = act(W_self x_v + W_nbr mean_{u->v} x_u)``. The neighbour
sum is a src-side gather plus the owner-side sorted segment sum (the sorted
segment-sum kernel on a card), feature-chunked like the GCN; the degree is
one more sorted segment sum of width 1.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.comm.collectives import map_feature_chunks
from dgraph_tpu_torch.models.gcn import dense
from dgraph_tpu_torch.plan import EdgePlan


class SAGEConv(nn.Module):
    """``Dense_0`` projects the vertex itself (with bias), ``Dense_1`` the
    neighbour mean (no bias) — flax's auto-names for the two Dense calls."""

    def __init__(self, in_features: int, out_features: int, comm,
                 activation: Callable = torch.relu, dtype=None):
        super().__init__()
        self.comm = comm
        self.activation = activation
        self.dtype = dtype
        self.Dense_0 = nn.Linear(in_features, out_features)
        self.Dense_1 = nn.Linear(in_features, out_features, bias=False)

    def forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        comm = self.comm
        width = x.shape[-1]
        # cast BEFORE the edge pipeline: every [e_pad, F] take and scatter
        # runs in the compute dtype
        xa = x.to(dt) if dt is not None else x
        if plan.halo_side != "dst":
            x_ext = comm.halo_extend(xa, plan, side="src")
            agg = map_feature_chunks(
                lambda sl: comm.scatter_sum(
                    comm.local_take(x_ext[:, sl], plan, side="src"), plan, side="dst"
                ),
                width,
            )
        else:
            agg = comm.scatter_sum(comm.gather(xa, plan, side="src"), plan, side="dst")
        ones = plan.edge_mask[:, None]
        deg = comm.scatter_sum(ones, plan, side="dst")  # [n_pad, 1]
        # divide in agg's dtype: a f32 degree would promote the mean to f32
        mean_nbr = agg / deg.clamp_min(1.0).to(agg.dtype)
        out = dense(self.Dense_0, x, dt) + dense(self.Dense_1, mean_nbr, dt)
        return self.activation(out)


class GraphSAGE(nn.Module):
    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 comm, num_layers: int = 2, dtype=None):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        width = in_features
        for i in range(num_layers):
            self.add_module(f"SAGEConv_{i}", SAGEConv(width, hidden_features, comm,
                                                      dtype=dtype))
            width = hidden_features
        self.Dense_0 = nn.Linear(width, out_features)

    def forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"SAGEConv_{i}")(x, plan)
        head_dt = _cfg.resolve_compute_dtype(self.dtype)
        return dense(self.Dense_0, x, head_dt).float()
