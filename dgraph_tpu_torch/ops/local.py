"""Rank-local gather/scatter primitives — the forward subset of
``dgraph_tpu/ops/local.py``.

This module is the single dispatch point of the sorted reductions:
:func:`sorted_segment_sum_any` and :func:`sorted_segment_sum_bias_relu_any`
route every owner-side aggregation to the kernel wrappers of
:mod:`dgraph_tpu_torch.ops.segment` (a CUDA kernel on a CUDA tensor, the
plain version on a CPU tensor), and the precision rule "bias cast to the
data dtype" lives here, as it does in the reference (local.py:197-200).

The reference's row gathers are XLA gathers, not Pallas kernels; here they
are ``index_select``. Its column-split gather and the custom VJPs that pin
TPU fast paths have no counterpart in this forward-only slice: on the CPU,
autograd differentiates these functions as written.
"""

from __future__ import annotations

from typing import Optional

import torch

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


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with out-of-range ids giving zero rows (the reference's
    sortedness hints only route its VJP, so the forward takes none)."""
    return row_take(x, idx)


def take_rows_sort_route(x: torch.Tensor, idx: torch.Tensor, perm: torch.Tensor,
                         sorted_ids: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` (OOB -> 0) for the plan's unsorted halo-side ids. The
    plan's sorting permutation only matters to the backward (training
    slice); the forward is a plain gather."""
    return row_take(x, idx)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum rows of ``data`` into ``num_segments`` buckets by ``segment_ids``
    (any order; out-of-range ids dropped). bf16/f16 accumulate in f32 and
    round once at the end, like the kernels (local.py:308-324)."""
    valid = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = segment_ids[valid].long()
    d = data[valid]
    acc_dtype = torch.float32 if data.dtype in (torch.bfloat16, torch.float16) else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc_dtype,
                      device=data.device)
    return out.index_add(0, ids, d.to(acc_dtype)).to(data.dtype)


def segment_sum_sort_route(data: torch.Tensor, ids: torch.Tensor, perm: torch.Tensor,
                           sorted_ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Segment sum of rows with unsorted ``ids`` through the plan's sorting
    permutation: gather by ``perm``, then the sorted reduction."""
    return sorted_segment_sum_any(data.index_select(0, perm.long()), sorted_ids, n_rows)


def sorted_segment_sum_any(data: torch.Tensor, sorted_ids: torch.Tensor,
                           n_rows: int) -> torch.Tensor:
    """The single dispatch point of every sorted reduction: the sorted
    segment-sum kernel (CUDA) or its plain version (CPU)."""
    return _seg.sorted_segment_sum(data, sorted_ids, n_rows)


def sorted_segment_sum_bias_relu_any(
    edata: torch.Tensor, sorted_ids: torch.Tensor, bias: torch.Tensor, n_rows: int,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``Σ w·relu(edata + bias[id])`` for sorted ids: the fused kernel
    (CUDA) or its plain version (CPU). The bias is cast to the data dtype
    HERE, once for both paths."""
    bias = bias.to(edata.dtype)
    return _seg.sorted_segment_sum_bias_relu(
        edata, sorted_ids, bias, n_rows, edge_weight=edge_weight
    )
