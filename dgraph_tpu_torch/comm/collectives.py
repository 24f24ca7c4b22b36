"""Graph primitives on one rank — the single-rank subset of
``dgraph_tpu/comm/collectives.py``.

Every function takes the PER-RANK plan (:meth:`EdgePlan.shard`). With one
rank there is no collective: the halo exchange only reads the (all-masked)
send lists, exactly as the reference's ``axis_name=None`` path does, and
autograd differentiates it as written. The multi-rank exchange
(``torch.distributed``) is a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.plan import EdgePlan, HaloSpec


def _side_index(plan: EdgePlan, side: str) -> torch.Tensor:
    return plan.src_index if side == "src" else plan.dst_index


def _side_npad(plan: EdgePlan, side: str) -> int:
    return plan.n_src_pad if side == "src" else plan.n_dst_pad


def split_active(plan: EdgePlan) -> bool:
    """The interior/boundary split lowerings need more than one rank."""
    return False


def halo_exchange(x: torch.Tensor, halo: HaloSpec) -> torch.Tensor:
    """The halo buffer ``[W*S, F]`` of one rank (world size 1: the send
    lists are all masked, so the buffer is zeros of the plan's shape). The
    mask is cast to x's dtype so a bf16 stream stays bf16."""
    F = x.shape[-1]
    idx = halo.send_idx.reshape(-1).long()
    send = x.index_select(0, idx) * halo.send_mask.reshape(-1, 1).to(x.dtype)
    return send.reshape(-1, F)


def halo_scatter_sum(h: torch.Tensor, halo: HaloSpec, n_pad: int) -> torch.Tensor:
    """Transpose of :func:`halo_exchange`: halo-slot values summed back into
    their owners' local rows."""
    F = h.shape[-1]
    back = h.reshape(-1, F) * halo.send_mask.reshape(-1, 1).to(h.dtype)
    return local_ops.segment_sum(back, halo.send_idx.reshape(-1), n_pad)


def map_feature_chunks(fn, width: int, chunk: Optional[int] = None):
    """Apply ``fn(slice)`` over <=chunk-wide feature slices and concat the
    results on the last axis (``chunk`` defaults to
    ``config.gather_col_block``): every per-edge intermediate of the edge
    pipeline stays at most one chunk wide."""
    cb = chunk or _cfg.gather_col_block or width
    outs = [fn(slice(j, min(j + cb, width))) for j in range(0, width, cb)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def halo_extend(x: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """The extended vertex table ``local_take`` indexes into: ``[n_pad +
    W*S, F]`` on the halo side (the halo rows appended even when nothing
    crosses ranks), ``x`` unchanged on the other side."""
    if side != plan.halo_side:
        return x
    return torch.cat([x, halo_exchange(x, plan.halo)], dim=0)


def local_take(full: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Per-edge rows from the (halo-extended) vertex table; masked edges
    are zero and take no gradient (the reference's ``taken * edge_mask``,
    collectives.py:954-987), with no ``[e_pad, F]`` multiply pass:

    - halo side: the edge mask is folded into the ids (a masked edge takes
      an out-of-range id, which the gather fills with a zero row); the
      backward runs through the plan's sorting permutation when it has one;
    - owner side of an owner-sorted plan: the plan's ids as they are, which
      keeps them sorted — masked edges already carry the out-of-range
      ``n_owner_pad`` (``plan.check_owner_padding``) — so the backward is
      the sorted segment sum and, with ``config.use_pallas_gather``, the
      forward the sorted-row-gather kernel."""
    idx = _side_index(plan, side)
    if side != plan.halo_side and plan.ids_sorted(side):
        return local_ops.take_rows(full, idx, indices_are_sorted=True,
                                   gather_mv=plan.gather_mv)
    idx = torch.where(plan.edge_mask > 0, idx, full.shape[0])
    if side == plan.halo_side and plan.halo_sort_perm is not None:
        return local_ops.take_rows_sort_route(
            full, idx, plan.halo_sort_perm, plan.halo_sorted_ids)
    return local_ops.take_rows(full, idx)


def gather(x: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Per-edge features gathered from one endpoint side: ``[e_pad, F]``."""
    return local_take(halo_extend(x, plan, side), plan, side)


def scatter_sum(edata: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Sum per-edge values into that side's vertices: ``[n_pad, F]``."""
    edata = edata * plan.edge_mask[:, None].to(edata.dtype)
    idx = _side_index(plan, side)
    n_pad = _side_npad(plan, side)
    if side != plan.halo_side:
        if plan.ids_sorted(side):
            return local_ops.sorted_segment_sum_any(edata, idx, n_pad,
                                                    gather_mv=plan.gather_mv)
        return local_ops.segment_sum(edata, idx, n_pad)
    n_full = n_pad + plan.world_size * plan.halo.s_pad
    if plan.halo_sort_perm is not None:
        full = local_ops.segment_sum_sort_route(
            edata, idx, plan.halo_sort_perm, plan.halo_sorted_ids, n_full)
    else:
        full = local_ops.segment_sum(edata, idx, n_full)
    return full[:n_pad] + halo_scatter_sum(full[n_pad:], plan.halo, n_pad)


def scatter_bias_relu(
    edata: torch.Tensor,  # [e_pad, F] per-edge stream (e.g. gathered src proj)
    bias: torch.Tensor,  # [n_pad, F] owner-side vertex operand
    plan: EdgePlan,
    side: str,
    edge_weight: Optional[torch.Tensor] = None,  # [e_pad]
) -> torch.Tensor:
    """Fused owner-side aggregation ``out[v] = Σ_e w_e·relu(edata_e + bias_v)``:
    the fused kernel on the owner side, composed ops elsewhere."""
    idx = _side_index(plan, side)
    n_pad = _side_npad(plan, side)
    bias = bias.to(edata.dtype)
    if plan.ids_sorted(side):
        return local_ops.sorted_segment_sum_bias_relu_any(
            edata, idx, bias, n_pad, edge_weight=edge_weight, gather_mv=plan.gather_mv)
    m = torch.relu(edata + gather(bias, plan, side))
    if edge_weight is not None:
        m = m * edge_weight[:, None].to(m.dtype)
    return scatter_sum(m, plan, side)
