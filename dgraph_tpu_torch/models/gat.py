"""Graph attention (GAT) — counterpart of ``dgraph_tpu/models/gat.py``.

With dst-owned edges the attention softmax over a vertex's incoming edges
is a rank-local segment operation (:func:`~dgraph_tpu_torch.models.
message_passing.head_chunked_attention`): only the src-side take crosses
ranks. Each :class:`GATConv` projects (``proj``, no bias), attends per head
with the raw ``[H, D]`` parameters ``att_src`` and ``att_dst``, and takes
the mean over heads, plus with ``residual`` a bias-free Dense of its input
(``res``, the reference's option, ``gat.py:29``, ``:54-55``, which no model
sets); :class:`GAT` puts elu after each conv and a Dense head on top. Names
follow flax's auto-names (``GATConv_{i}.proj``, ``GATConv_{i}.att_src``,
``GATConv_{i}.att_dst``, ``GATConv_{i}.res``, ``Dense_0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.models.gcn import dense
from dgraph_tpu_torch.models.message_passing import head_chunked_attention
from dgraph_tpu_torch.plan import EdgePlan


class GATConv(nn.Module):
    def __init__(self, in_features: int, out_features: int, comm, num_heads: int = 1,
                 negative_slope: float = 0.2, residual: bool = False, dtype=None):
        super().__init__()
        H, D = num_heads, out_features
        self.comm, self.num_heads, self.out_features = comm, H, D
        self.negative_slope, self.dtype = negative_slope, dtype
        self.proj = nn.Linear(in_features, H * D, bias=False)
        self.att_src = nn.Parameter(torch.empty(H, D))
        self.att_dst = nn.Parameter(torch.empty(H, D))
        self.res = nn.Linear(in_features, D, bias=False) if residual else None

    def forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        hx = dense(self.proj, x, dt)  # [n_pad, H*D]
        # the attention parameters in the compute dtype: f32 ones would
        # promote the [e_pad, H, D] tensors back to f32 (reference :44-49)
        a_src, a_dst = self.att_src.to(hx.dtype), self.att_dst.to(hx.dtype)
        out = head_chunked_attention(self.comm, hx, hx, a_src, a_dst, plan,
                                     self.negative_slope)
        out = out.mean(dim=1)  # head mean
        if self.res is not None:
            out = out + dense(self.res, x, dt)
        return out


class GAT(nn.Module):
    """``num_layers`` x (:class:`GATConv`, elu) -> ``Dense_0`` (logits in f32)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int, comm,
                 num_layers: int = 2, num_heads: int = 4, dtype=None):
        super().__init__()
        self.num_layers, self.dtype = num_layers, dtype
        width = in_features
        for i in range(num_layers):
            self.add_module(f"GATConv_{i}", GATConv(width, hidden_features, comm,
                                                    num_heads=num_heads, dtype=dtype))
            width = hidden_features
        self.Dense_0 = nn.Linear(width, out_features)

    def forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        for i in range(self.num_layers):
            x = F.elu(getattr(self, f"GATConv_{i}")(x, plan))
        return dense(self.Dense_0, x, _cfg.resolve_compute_dtype(self.dtype)).float()
