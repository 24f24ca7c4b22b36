"""Sequence transformer LM — counterpart of ``dgraph_tpu/models/transformer.py``
at one rank.

Every attention layer is one exact causal attention over the full sequence
through the communicator's ``seq_attention`` (the flash kernels on a card).
Submodule names follow flax's (``tok_embed``, ``pos_embed``, ``block_{i}``
with ``ln_attn``, ``qkv``, ``attn_out``, ``ln_ffn``, ``ffn_up``,
``ffn_down``, then ``ln_out`` and ``head``), so a flax parameter path maps to
a ``state_dict`` key by joining with dots. LayerNorms use flax's epsilon,
1e-6. As in flax, the block's layers compute in the compute dtype and
``ln_out`` and ``head`` in the promoted dtype (f32). The expert-parallel FFN
(``moe_k > 0``) needs a sharded communicator and comes with the multi-rank
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.models.gcn import dense

LN_EPS = 1e-6  # flax.linen.LayerNorm's default


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``LayerNorm(dtype=...)``: statistics and scale in f32 (the
    params' dtype), the result cast to ``dtype`` (None = f32)."""
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    return y.to(dtype) if dtype is not None else y


class TransformerBlock(nn.Module):
    def __init__(self, latent: int, num_heads: int, comm, dtype=None, causal: bool = True,
                 attn_impl: str = "ring", moe_k: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        if latent % num_heads:
            raise ValueError(f"latent {latent} not divisible by heads {num_heads}")
        if moe_k > 0 and comm.get_world_size() == 1:
            # a silent dense fallback would be a different architecture
            # masquerading as the same config (transformer.py:59-67)
            raise ValueError(
                "moe_k > 0 needs a sharded communicator (graph_axis); "
                "SingleComm has no expert axis. Run with world_size > 1 "
                "or set moe_k=0."
            )
        self.latent, self.num_heads, self.comm = latent, num_heads, comm
        self.dtype, self.causal, self.attn_impl = dtype, causal, attn_impl
        self.ln_attn = nn.LayerNorm(latent, eps=LN_EPS)
        self.qkv = nn.Linear(latent, 3 * latent)
        self.attn_out = nn.Linear(latent, latent)
        self.ln_ffn = nn.LayerNorm(latent, eps=LN_EPS)
        self.ffn_up = nn.Linear(latent, 4 * latent)
        self.ffn_down = nn.Linear(4 * latent, latent)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [T, L]
        dt = _cfg.resolve_compute_dtype(self.dtype)
        L, Hh = self.latent, self.num_heads
        n = x.shape[0]
        qkv = dense(self.qkv, layer_norm(self.ln_attn, x, dt), dt)
        # column slices of qkv: the attention kernels read them in place
        q, k, v = (t.reshape(n, Hh, L // Hh) for t in qkv.split(L, dim=-1))
        attn = self.comm.seq_attention(q, k, v, causal=self.causal, impl=self.attn_impl)
        x = x + dense(self.attn_out, attn.reshape(n, L), dt)
        y = layer_norm(self.ln_ffn, x, dt)
        h = F.silu(dense(self.ffn_up, y, dt))
        return x + dense(self.ffn_down, h, dt)


class SeqTransformerLM(nn.Module):
    """Token-in, next-token-logits-out causal LM: ``[T]`` token ids and
    ``[T]`` positions to ``[T, vocab]`` f32 logits."""

    def __init__(self, vocab: int, latent: int, num_layers: int = 2, num_heads: int = 4,
                 max_len: int = 4096, comm=None, dtype=None, attn_impl: str = "ring",
                 moe_k: int = 0, moe_capacity_factor: float = 2.0):
        super().__init__()
        self.num_layers = num_layers
        self.tok_embed = nn.Embedding(vocab, latent)
        self.pos_embed = nn.Embedding(max_len, latent)
        for i in range(num_layers):
            self.add_module(f"block_{i}", TransformerBlock(
                latent, num_heads, comm, dtype=dtype, attn_impl=attn_impl, moe_k=moe_k,
                moe_capacity_factor=moe_capacity_factor))
        self.ln_out = nn.LayerNorm(latent, eps=LN_EPS)
        self.head = nn.Linear(latent, vocab)

    def forward(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = self.tok_embed(tokens.long()) + self.pos_embed(positions.long())
        for i in range(self.num_layers):
            h = getattr(self, f"block_{i}")(h)
        h = layer_norm(self.ln_out, h, None)
        return dense(self.head, h, None).float()
