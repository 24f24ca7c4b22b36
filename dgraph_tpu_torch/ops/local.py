"""Rank-local gather/scatter primitives and their backward routing — the
subset of ``dgraph_tpu/ops/local.py`` the GCN, GraphSAGE, GAT and graph
transformer paths use.

This module is the single dispatch point of the sorted reductions:
:func:`sorted_segment_sum_any` and :func:`sorted_segment_sum_bias_relu_any`
route every owner-side aggregation to the kernel wrappers of
:mod:`dgraph_tpu_torch.ops.segment` (a CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor), and the precision rule "bias cast to the
data dtype" lives here, as it does in the reference (local.py:197-200).

The reference's row gathers are XLA gathers (here ``index_select``) unless
``config.use_pallas_gather`` is on, when a take by sorted ids runs the
sorted-row-gather kernel. Each take and unsorted sum is an
``autograd.Function`` whose backward is pinned the way the reference's
custom VJPs pin it (local.py:73-305): a take by sorted ids transposes to
the sorted segment-sum kernel, a take through the plan's sorting
permutation to the permutation take plus that kernel, and a sum to the row
take by the original ids. The reference's column split of wide takes is a
TPU layout fix with no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.ops import segment as _seg


def row_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` row gather, zero rows for ids outside ``[0, N)`` (the
    padding convention; the reference's ``oob="fill"``). Negative ids count
    from the end first, as in numpy and ``jnp.take``. Out-of-range ids read
    one appended zero row, so the fill costs a copy of the ``[N, F]`` table,
    not a second pass over the ``[E, F]`` result."""
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    x_ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    valid = (idx >= 0) & (idx < n)
    return x_ext.index_select(0, torch.where(valid, idx, n).long())


def _acc_segment_sum(data: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """Sum rows by any-order ids (out-of-range ids dropped); bf16/f16
    accumulate in f32 and round once at the end, like the kernels
    (local.py:308-324)."""
    valid = (ids >= 0) & (ids < num_segments)
    d = data[valid]
    acc_dtype = torch.float32 if data.dtype in (torch.bfloat16, torch.float16) else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc_dtype,
                      device=data.device)
    return out.index_add(0, ids[valid].long(), d.to(acc_dtype)).to(data.dtype)


class _TakeRows(torch.autograd.Function):
    """``x[idx]`` (OOB -> 0) whose backward is the sorted segment-sum kernel
    for sorted ids, the any-order sum otherwise (local.py:73-128)."""

    @staticmethod
    def forward(ctx, x, idx, indices_are_sorted):
        ctx.save_for_backward(idx)
        ctx.num_rows, ctx.sorted = x.shape[0], indices_are_sorted
        return row_take(x, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        if ctx.sorted:
            dx = _seg.sorted_segment_sum(_seg.unit_cols(g), idx, ctx.num_rows)
        else:
            dx = _acc_segment_sum(g, idx, ctx.num_rows)
        return dx, None, None


def take_rows(
    x: torch.Tensor, idx: torch.Tensor, *, indices_are_sorted: bool = False,
    gather_mv: int = 0,
) -> torch.Tensor:
    """``x[idx]`` with out-of-range ids giving zero rows. For sorted ids the
    backward is the sorted segment-sum kernel, and with
    ``config.use_pallas_gather`` on and ``gather_mv > 0`` the forward is the
    sorted-row-gather kernel (whose backward is that same sum)."""
    if indices_are_sorted and gather_mv > 0 and _cfg.pallas_gather_enabled():
        return _seg.sorted_row_gather(x, idx)
    return _TakeRows.apply(x, idx, indices_are_sorted)


class _TakeRowsSortRoute(torch.autograd.Function):
    """``x[idx]`` (OOB -> 0) for unsorted ids whose backward still runs the
    sorted kernel: the plan's permutation puts ``idx`` in sorted order, so
    the transpose is the permutation take plus the sorted segment sum
    (local.py:233-269). Positions whose id is out of range (a masked edge
    whose id the caller folded out) take no cotangent: they are folded out
    of the permutation take the same way, as the reference's ``* edge_mask``
    zeroes them."""

    @staticmethod
    def forward(ctx, x, idx, perm, sorted_ids):
        ctx.save_for_backward(idx, perm, sorted_ids)
        ctx.num_rows = x.shape[0]
        return row_take(x, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        idx, perm, sorted_ids = ctx.saved_tensors
        n = ctx.num_rows
        taken = idx.index_select(0, perm.long())
        perm_live = torch.where((taken >= 0) & (taken < n), perm, g.shape[0])
        gp = row_take(g, perm_live)
        return sorted_segment_sum_any(gp, sorted_ids, n), None, None, None


def take_rows_sort_route(x: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                         sorted_ids: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (OOB -> 0) for the plan's unsorted halo-side ids, with the
    backward routed through the plan's sorting permutation."""
    return _TakeRowsSortRoute.apply(x, idx, perm, sorted_ids)


class _SegmentSum(torch.autograd.Function):
    """Any-order segment sum whose backward is the row take by the ids."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _acc_segment_sum(data, segment_ids, num_segments)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return row_take(g, ids), None, None


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets by ``segment_ids``
    (any order; out-of-range ids dropped). bf16/f16 accumulate in f32 and
    round once at the end, like the kernels (local.py:308-324). The
    backward is the row take ``g[ids]`` (local.py:327-345)."""
    return _SegmentSum.apply(data, segment_ids, num_segments)


class _SegmentSumSortRoute(torch.autograd.Function):
    """Segment sum of unsorted ids through the plan's sorting permutation:
    the permutation take, then the sorted sum; the backward is the row take
    by the original ids, the composite's exact transpose (local.py:272-305)."""

    @staticmethod
    def forward(ctx, data, ids, perm, sorted_ids, n_rows):
        ctx.save_for_backward(ids)
        return sorted_segment_sum_any(data.index_select(0, perm.long()), sorted_ids, n_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return row_take(g, ids), None, None, None, None


def segment_sum_sort_route(data: torch.Tensor, ids: torch.Tensor, perm: torch.Tensor,
                           sorted_ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Segment sum of rows with unsorted ``ids`` through the plan's sorting
    permutation: gather by ``perm``, then the sorted reduction."""
    return _SegmentSumSortRoute.apply(data, ids, perm, sorted_ids, n_rows)


def sorted_segment_sum_any(data: torch.Tensor, sorted_ids: torch.Tensor,
                           n_rows: int, gather_mv: int = 0) -> torch.Tensor:
    """The single dispatch point of every sorted reduction: the sorted
    segment-sum kernel (CUDA) or its plain version (CPU)."""
    return _seg.sorted_segment_sum(data, sorted_ids, n_rows, gather_mv=gather_mv)


def sorted_segment_sum_bias_relu_any(
    edata: torch.Tensor, sorted_ids: torch.Tensor, bias: torch.Tensor, n_rows: int,
    edge_weight: Optional[torch.Tensor] = None, gather_mv: int = 0,
) -> torch.Tensor:
    """Fused ``Σ w·relu(edata + bias[id])`` for sorted ids: the fused kernel
    (CUDA) or its plain version (CPU). The bias is cast to the data dtype
    HERE, once for both paths."""
    bias = bias.to(edata.dtype)
    return _seg.sorted_segment_sum_bias_relu(
        edata, sorted_ids, bias, n_rows, edge_weight=edge_weight, gather_mv=gather_mv,
    )


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Per-segment max (local.py:426-433): ``scatter_reduce`` ``amax`` into
    a ``-inf`` buffer, so empty segments give ``-inf`` (callers mask them);
    ids outside ``[0, num_segments)`` are dropped. The reference's
    ``indices_are_sorted`` hint has nothing to select here."""
    n = num_segments
    ids = torch.where((segment_ids >= 0) & (segment_ids < n), segment_ids, n).long()
    idx = ids.view((-1,) + (1,) * (data.dim() - 1)).expand_as(data)
    out = data.new_full((n + 1,) + tuple(data.shape[1:]), -torch.inf)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False)[:n]


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                 eps: float = 1e-12) -> torch.Tensor:
    """Per-segment mean, empty segments 0 (local.py:436-442): the any-order
    sums of the rows and of their counts, the count clamped at ``eps``."""
    sums = segment_sum(data, segment_ids, num_segments)
    ones = torch.ones((data.shape[0], 1), dtype=data.dtype, device=data.device)
    return sums / segment_sum(ones, segment_ids, num_segments).clamp_min(eps)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor, num_segments: int,
                    mask: torch.Tensor, indices_are_sorted: bool = False) -> torch.Tensor:
    """Numerically stable softmax of ``[E, H]`` logits over the edges of
    each segment (local.py:445-467); masked edges (``mask`` ``[E]`` <= 0)
    get weight 0 and the denominator is clamped at 1e-12. With sorted ids
    the sum is the sorted segment-sum kernel and the row lookups
    ``seg_max[ids]``, ``denom[ids]`` are sorted takes, whose backward is
    that kernel too. The gradient runs through ``seg_max`` as in the
    reference (zero up to rounding: the softmax does not depend on the
    shift)."""
    live = (mask > 0)[..., None]

    def rows(t):
        return take_rows(t, segment_ids, indices_are_sorted=indices_are_sorted)

    logits = torch.where(live, logits, -torch.inf)
    seg_max = segment_max(logits, segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    shifted = torch.where(live, logits - rows(seg_max), -torch.inf)
    expd = torch.where(live, torch.exp(shifted), 0.0)
    if indices_are_sorted:
        denom = sorted_segment_sum_any(expd, segment_ids, num_segments)
    else:
        denom = segment_sum(expd, segment_ids, num_segments)
    return expd / rows(denom).clamp_min(1e-12)
