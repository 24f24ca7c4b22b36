"""Plain MLP building block — counterpart of ``dgraph_tpu/models/mlp.py``:
Dense layers with ``activation`` (silu) between them and an optional
LayerNorm on the output. Parameter names follow flax's auto-names
(``Dense_0``, ``Dense_1``, ..., ``LayerNorm_0``)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.models.gcn import dense
from dgraph_tpu_torch.models.transformer import LN_EPS, layer_norm


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int],
                 activation: Callable = F.silu, use_layer_norm: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.activation, self.dtype = activation, dtype
        self.num_dense = len(features)
        width = in_features
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", nn.Linear(width, f))
            width = f
        self.LayerNorm_0 = nn.LayerNorm(width, eps=LN_EPS) if use_layer_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        for i in range(self.num_dense):
            x = dense(getattr(self, f"Dense_{i}"), x, dt)
            if i < self.num_dense - 1:
                x = self.activation(x)
        if self.LayerNorm_0 is not None:
            x = layer_norm(self.LayerNorm_0, x, dt)
        return x
