"""Graph transformer (the GraphGPS recipe) — counterpart of
``dgraph_tpu/models/graph_transformer.py`` at one rank.

Each :class:`GPSLayer` is three residual branches, pre-LN:

- **local**: the split-projection message passing of the GCN
  (``silu(src_proj(y)[src] + dst_proj(y)[dst])`` summed into the dst
  vertices). With dst-owned edges it is feature-chunked: one
  ``halo_extend``, then per <=128-wide chunk the two ``local_take``\\ s, silu
  and the owner-side ``scatter_sum`` (the sorted segment-sum kernel on a
  card, which is also the backward of the sorted dst take); otherwise the
  full-width gather and scatter;
- **global**: attention over the whole vertex set,
  ``comm.seq_attention(q, k, v, kv_mask=vmask)`` on ``[n_pad, H, L/H]``
  with q, k and v column slices of the one ``qkv`` output, which the flash
  kernels read in place; padded keys are masked and padded query rows come
  out zero;
- **FFN**: an :class:`~dgraph_tpu_torch.models.mlp.MLP` ``[2L, L]``.

The layer's output is multiplied by ``vmask``, so padded vertex slots stay
exactly zero. Names follow flax's (``embed``, ``gps_{i}`` with
``ln_local``, ``src_proj``, ``dst_proj``, ``local_out``, ``ln_attn``,
``qkv``, ``attn_out``, ``ln_ffn``, ``ffn.Dense_{0,1}``, then ``head``), so
:func:`dgraph_tpu_torch.weights.params_from_jax` maps a flax tree one to
one. LayerNorms use flax's epsilon and f32 statistics
(:func:`~dgraph_tpu_torch.models.transformer.layer_norm`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.comm.collectives import map_feature_chunks
from dgraph_tpu_torch.models.gcn import dense
from dgraph_tpu_torch.models.mlp import MLP
from dgraph_tpu_torch.models.transformer import LN_EPS, layer_norm
from dgraph_tpu_torch.plan import EdgePlan


class GPSLayer(nn.Module):
    """One [local MPNN + global attention + FFN] block, all residual."""

    def __init__(self, latent: int, comm, num_heads: int = 4, dtype=None):
        super().__init__()
        if latent % num_heads:
            raise ValueError(f"latent {latent} not divisible by heads {num_heads}")
        self.latent, self.num_heads, self.comm, self.dtype = latent, num_heads, comm, dtype
        L = latent
        self.ln_local = nn.LayerNorm(L, eps=LN_EPS)
        self.src_proj = nn.Linear(L, L, bias=False)
        self.dst_proj = nn.Linear(L, L)
        self.local_out = nn.Linear(L, L)
        self.ln_attn = nn.LayerNorm(L, eps=LN_EPS)
        self.qkv = nn.Linear(L, 3 * L)
        self.attn_out = nn.Linear(L, L)
        self.ln_ffn = nn.LayerNorm(L, eps=LN_EPS)
        self.ffn = MLP(L, [2 * L, L], dtype=dtype)

    def local_branch(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        """The local branch's residual term: gather -> message -> scatter
        (dst-owned), then ``local_out``."""
        dt = _cfg.resolve_compute_dtype(self.dtype)
        comm = self.comm
        y = layer_norm(self.ln_local, x, dt)
        h_s = dense(self.src_proj, y, dt)
        h_d = dense(self.dst_proj, y, dt)
        if plan.halo_side != "dst":
            hs_ext = comm.halo_extend(h_s, plan, side="src")
            local = map_feature_chunks(
                lambda sl: comm.scatter_sum(
                    F.silu(comm.local_take(hs_ext[:, sl], plan, side="src")
                           + comm.local_take(h_d[:, sl], plan, side="dst")),
                    plan, side="dst"),
                self.latent,
            )
        else:
            m = F.silu(comm.gather(h_s, plan, side="src") + comm.gather(h_d, plan, side="dst"))
            local = comm.scatter_sum(m, plan, side="dst")
        return dense(self.local_out, local, dt)

    def attention_inputs(self, x: torch.Tensor) -> tuple:
        """(q, k, v), each ``[n, H, L/H]``: column slices of the one ``qkv``
        output, which the flash kernels read in place."""
        dt = _cfg.resolve_compute_dtype(self.dtype)
        n, L = x.shape[0], self.latent
        qkv = dense(self.qkv, layer_norm(self.ln_attn, x, dt), dt)
        return tuple(t.reshape(n, self.num_heads, L // self.num_heads)
                     for t in qkv.split(L, dim=-1))

    def forward(self, x: torch.Tensor, plan: EdgePlan, vmask: torch.Tensor) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        x = x + self.local_branch(x, plan)
        # global branch: attention over every vertex, padded keys masked
        attn = self.comm.seq_attention(*self.attention_inputs(x), kv_mask=vmask)
        x = x + dense(self.attn_out, attn.reshape(x.shape[0], self.latent), dt)
        x = x + self.ffn(layer_norm(self.ln_ffn, x, dt))
        # padded slots stay exactly zero (reference :97-102)
        return x * vmask[:, None].to(x.dtype)


class GraphTransformer(nn.Module):
    """``embed`` -> ``num_layers`` x :class:`GPSLayer` -> ``head`` (logits
    in f32). Arguments ``(x, plan, vmask)``: ``vmask`` ``[n_pad]`` is 1.0
    for real vertices (the batches' ``"vmask"``, ``DistributedGraph.
    vertex_mask``); without it every row counts as real, which only one
    rank may assume."""

    def __init__(self, in_features: int, latent: int, out_features: int, comm,
                 num_layers: int = 3, num_heads: int = 4, dtype=None):
        super().__init__()
        self.num_layers, self.comm, self.dtype = num_layers, comm, dtype
        self.embed = nn.Linear(in_features, latent)
        for i in range(num_layers):
            self.add_module(f"gps_{i}", GPSLayer(latent, comm, num_heads=num_heads, dtype=dtype))
        self.head = nn.Linear(latent, out_features)

    def forward(self, x: torch.Tensor, plan: EdgePlan,
                vmask: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = _cfg.resolve_compute_dtype(self.dtype)
        if vmask is None:
            if self.comm.get_world_size() > 1:
                # shards always hold padded slots: an all-ones mask would
                # let every real vertex attend to padding (reference :136-144)
                raise ValueError("GraphTransformer requires vmask (DistributedGraph."
                                 "vertex_mask) above one rank")
            vmask = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
        h = dense(self.embed, x, dt)
        h = h * vmask[:, None].to(h.dtype)
        for i in range(self.num_layers):
            h = getattr(self, f"gps_{i}")(h, plan, vmask)
        return dense(self.head, h, dt).float()
