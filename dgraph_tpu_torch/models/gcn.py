"""Graph convolution (GCN) as ``nn.Module``s — counterpart of
``dgraph_tpu/models/gcn.py``.

Each layer projects at the vertex level (``Dense(concat(h_src, h_dst)) ==
Dense_s(h_src) + Dense_d(h_dst)``) and aggregates per edge, along one of the
reference's three routes (gcn.py:97-175):

- **fused** (relu, homogeneous plan, owner-side aggregation): the owner
  projection rides into the fused scatter kernel as a per-vertex bias, so
  the ``[E, F]`` message tensor never exists — ``halo_extend`` once per
  layer, then per <=128-wide feature chunk ``local_take`` ->
  ``scatter_bias_relu``;
- **chunked composed** (relu, owner-side, non-homogeneous plan): both sides
  taken per chunk, relu, edge weight, ``scatter_sum``;
- **full-width fallback** (any other activation, or halo-side aggregation).

Parameter names follow flax's (``GraphConvLayer_0.src_proj``, ``dst_proj``,
``Dense_0``), so :func:`dgraph_tpu_torch.weights.params_from_jax` maps a
flax tree onto ``state_dict`` keys one to one.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.comm.collectives import map_feature_chunks
from dgraph_tpu_torch.plan import EdgePlan

RELUS = (torch.relu, F.relu)


def dense(lin: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)`` semantics: input, weight and bias cast to
    the compute dtype (None = the promoted type of input and weight; params
    stay f32)."""
    dt = dtype if dtype is not None else torch.promote_types(x.dtype, lin.weight.dtype)
    bias = lin.bias.to(dt) if lin.bias is not None else None
    return F.linear(x.to(dt), lin.weight.to(dt), bias)


class GraphConvLayer(nn.Module):
    """concat(src, dst) -> Dense -> activation -> scatter-sum to ``aggregate_to``."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        comm,
        aggregate_to: str = "dst",
        activation: Callable = torch.relu,
        dtype=None,  # compute dtype (e.g. torch.bfloat16); params stay f32
    ):
        super().__init__()
        self.out_features = out_features
        self.comm = comm
        self.aggregate_to = aggregate_to
        self.activation = activation
        self.dtype = dtype
        self.src_proj = nn.Linear(in_features, out_features)
        self.dst_proj = nn.Linear(in_features, out_features, bias=False)

    def forward(
        self,
        x: torch.Tensor,  # [n_pad, F] per-rank vertex features
        plan: EdgePlan,  # per-rank plan
        edge_weight: Optional[torch.Tensor] = None,  # [e_pad]
    ) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        h_s = dense(self.src_proj, x, dt)
        h_d = dense(self.dst_proj, x, dt)
        comm = self.comm
        D = self.out_features
        relu = self.activation in RELUS
        if relu and plan.homogeneous and self.aggregate_to != plan.halo_side:
            owner = self.aggregate_to
            stream = "src" if owner == "dst" else "dst"
            h_bias = h_d if owner == "dst" else h_s
            h_stream = h_s if owner == "dst" else h_d
            h_ext = comm.halo_extend(h_stream, plan, side=stream)
            return map_feature_chunks(
                lambda sl: comm.scatter_bias_relu(
                    comm.local_take(h_ext[:, sl], plan, side=stream),
                    h_bias[:, sl], plan, side=owner, edge_weight=edge_weight,
                ),
                D,
            )

        if relu and self.aggregate_to != plan.halo_side:
            hs_ext = comm.halo_extend(h_s, plan, side="src")
            hd_ext = comm.halo_extend(h_d, plan, side="dst")

            def chunked(sl):
                m = comm.local_take(hs_ext[:, sl], plan, side="src") + comm.local_take(
                    hd_ext[:, sl], plan, side="dst")
                m = self.activation(m)
                if edge_weight is not None:
                    m = m * edge_weight[:, None]
                return comm.scatter_sum(m, plan, side=self.aggregate_to)

            return map_feature_chunks(chunked, D)

        # full-width fallback: non-separable activation or halo-side aggregation
        m = comm.gather(h_s, plan, side="src") + comm.gather(h_d, plan, side="dst")
        m = self.activation(m)
        if edge_weight is not None:
            m = m * edge_weight[:, None]
        return comm.scatter_sum(m, plan, side=self.aggregate_to)


class GCN(nn.Module):
    """``num_layers`` GraphConv layers + linear head (logits in f32)."""

    def __init__(
        self,
        in_features: int,
        hidden_features: int,
        out_features: int,
        comm,
        num_layers: int = 2,
        aggregate_to: str = "dst",
        dtype=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.dtype = dtype
        width = in_features
        for i in range(num_layers):
            self.add_module(f"GraphConvLayer_{i}", GraphConvLayer(
                width, hidden_features, comm, aggregate_to=aggregate_to, dtype=dtype,
            ))
            width = hidden_features
        self.Dense_0 = nn.Linear(width, out_features)

    def forward(self, x: torch.Tensor, plan: EdgePlan,
                edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"GraphConvLayer_{i}")(x, plan, edge_weight)
        head_dt = _cfg.resolve_compute_dtype(self.dtype)
        return dense(self.Dense_0, x, head_dt).float()
