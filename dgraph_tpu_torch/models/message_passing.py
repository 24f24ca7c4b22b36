"""Message passing over the halo exchange — counterpart of
``dgraph_tpu/models/message_passing.py``: GAT's attention edge pipeline
(``head_chunked_attention``, :21-74) and the ``MessagePassing`` wrapper
(:77-106), halo exchange, then a user layer over ``[local ; halo]``.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.comm.collectives import (
    map_feature_chunks,
    resolve_plan_impl,
    resolve_plan_wire_format,
)
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.plan import EdgePlan


def head_chunked_attention(comm, hs: torch.Tensor, hd: torch.Tensor, a_src: torch.Tensor,
                           a_dst: torch.Tensor, plan: EdgePlan,
                           negative_slope: float) -> torch.Tensor:
    """GAT-style per-dst-vertex softmax attention, chunked by head groups.

    Per-head logits ``a_src·h_src + a_dst·h_dst``, leaky relu, the
    rank-local segment softmax over each dst vertex's edges, and the
    weighted scatter, with heads processed in groups of
    ``gather_col_block // D`` so every ``[e_pad, *]`` intermediate stays at
    most one chunk wide (the softmax couples features within a head, never
    across heads, so grouping is exact). Needs dst-owned edges
    (``halo_side == 'src'``).

    Args:
      hs/hd: ``[n_pad, H*D]`` src-/dst-side projections.
      a_src/a_dst: ``[H, D]`` attention parameters, in the compute dtype.
    Returns ``[n_dst_pad, H, D]`` attended sums.
    """
    if plan.halo_side != "src":
        raise ValueError(
            "head_chunked_attention requires dst-owned edges "
            "(halo_side='src'): with src-owned plans the dst index uses "
            "halo-slot numbering, so a rank-local softmax over n_dst_pad "
            "segments would silently drop remote contributions from the "
            "normalizer"
        )
    H, D = a_src.shape
    gh = max(1, (_cfg.gather_col_block or H * D) // D)  # heads per chunk
    hs_ext = comm.halo_extend(hs, plan, side="src")
    ids_sorted = plan.ids_sorted("dst")

    def group(sl):
        h0, h1 = sl.start // D, sl.stop // D
        hs_c = comm.local_take(hs_ext[:, sl], plan, side="src").reshape(-1, h1 - h0, D)
        hd_c = comm.local_take(hd[:, sl], plan, side="dst").reshape(-1, h1 - h0, D)
        logits = (hs_c * a_src[h0:h1]).sum(-1) + (hd_c * a_dst[h0:h1]).sum(-1)
        # flax's leaky_relu: x where x >= 0
        logits = torch.where(logits >= 0, logits, negative_slope * logits)
        alpha = local_ops.segment_softmax(logits, plan.dst_index, plan.n_dst_pad,
                                          plan.edge_mask, indices_are_sorted=ids_sorted)
        msg = (alpha[..., None] * hs_c).reshape(-1, (h1 - h0) * D)
        return comm.scatter_sum(msg, plan, side="dst")

    return map_feature_chunks(group, H * D, chunk=gh * D).reshape(-1, H, D)


class MessagePassing(nn.Module):
    """halo exchange -> ``[local ; halo]`` -> ``layer(full, plan)`` (the
    reference's ``DGraphMessagePassing`` shape): ``layer`` indexes the
    concatenated buffer with the plan's halo-slot numbering. The lowering
    (env pin > heuristic, the split's 'overlap' included) and the wire
    format (``message_passing.py:97-103``) are resolved once from the plan
    and given to the exchange, whose buffer this wrapper reads at once."""

    def __init__(self, layer: Callable, comm):
        super().__init__()
        self.layer = layer
        self.comm = comm

    def forward(self, x: torch.Tensor, plan: EdgePlan) -> torch.Tensor:
        impl = resolve_plan_impl(plan, self.comm.group)
        halo = self.comm.halo_exchange(
            x, plan.halo, deltas=plan.halo_deltas, impl=impl,
            wire_format=resolve_plan_wire_format(plan, self.comm.group))
        return self.layer(torch.cat([x, halo], dim=0), plan)
