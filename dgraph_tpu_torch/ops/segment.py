"""Sorted-segment reductions: the two CUDA kernels' wrappers and plain versions.

Counterpart of ``dgraph_tpu/ops/pallas_segment.py``:

- :func:`sorted_segment_sum` replaces ``_kernel`` (pallas_segment.py:39,
  public ``sorted_segment_sum`` :225): ``out[v] = Σ_{e: ids[e]=v} op(data[e])``;
- :func:`sorted_segment_sum_bias_relu` replaces ``_kernel_bias_relu``
  (pallas_segment.py:259, public ``sorted_segment_sum_bias_relu`` :479):
  ``out[v] = Σ_{e: ids[e]=v} w[e]·relu(data[e] + bias[v])`` with no ``[E, F]``
  message tensor in device memory.

Both take MONOTONE (sorted) segment ids; ids outside ``[0, N)`` are dropped
(the plan pads owner ids with ``n_pad``). The CUDA sources are
``csrc/sorted_segment.cu``, a CSR segment reduction (the design note is
there): ``row_ptr = searchsorted(ids, arange(N+1))`` plays the part of the
TPU kernel's chunk schedule and drops out-of-range ids by construction.

Device rule: on a CPU tensor a wrapper runs its plain PyTorch version
(``*_plain``, which autograd differentiates); on a CUDA tensor it launches
its kernel or raises — there is no fallback. Each wrapper counts its
launches in ``<wrapper>.launches`` (set to 0 with :func:`reset_launch_counts`).

This slice is forward only: on a CUDA tensor that requires grad, with grad
mode on, a wrapper raises ``NotImplementedError``; the backward kernels come
with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --- plain versions (the CPU path and the kernels' oracle) -----------------


def _valid_range(ids: torch.Tensor, n: int) -> tuple[int, int]:
    """[lo, hi) of the sorted ids that fall inside [0, n)."""
    bounds = torch.tensor([0, n], dtype=ids.dtype, device=ids.device)
    lo, hi = torch.searchsorted(ids, bounds).tolist()
    return lo, hi


def sorted_segment_sum_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
    input_op: str = "none",
) -> torch.Tensor:
    """Plain version of :func:`sorted_segment_sum`: ``index_add`` over the
    valid ids. ``input_op="relu"`` applies relu in the data dtype; the sum
    is f32 and the result is cast back to the data dtype."""
    if input_op not in ("none", "relu"):
        raise ValueError(f"input_op must be 'none' or 'relu', got {input_op!r}")
    lo, hi = _valid_range(segment_ids, num_segments)
    d = data[lo:hi]
    if input_op == "relu":
        d = torch.relu(d)
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    out = out.index_add(0, segment_ids[lo:hi].long(), d.float())
    return out.to(data.dtype)


def sorted_segment_sum_bias_relu_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, bias: torch.Tensor,
    num_segments: int, *, edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`sorted_segment_sum_bias_relu`, in the TPU
    kernel's rounding order: bias rounded to the data dtype; ``pre =
    f32(data) + f32(bias)``; relu in f32; times ``f32(w)``; the message
    rounded to the data dtype; f32 sum; output cast to the data dtype."""
    lo, hi = _valid_range(segment_ids, num_segments)
    ids = segment_ids[lo:hi].long()
    bias_rows = bias.to(data.dtype).index_select(0, ids).float()
    m = torch.relu(data[lo:hi].float() + bias_rows)
    if edge_weight is not None:
        m = m * edge_weight[lo:hi, None].float()
    m = m.to(data.dtype).float()
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add(0, ids, m).to(data.dtype)


# --- kernel wrappers -------------------------------------------------------


def _forward_only(*tensors) -> None:
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise NotImplementedError(
            "the CUDA segment kernels are forward only; their backward "
            "kernels come with the training slice of the port (run under "
            "torch.inference_mode() or torch.no_grad())"
        )


def _check_rows(name: str, t: torch.Tensor, dtype, cols: int) -> None:
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name} must be [rows, {cols}], got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} dtype {t.dtype} != data dtype {dtype}")
    if t.shape[1] > 1 and t.stride(1) != 1:
        raise ValueError(f"{name} needs unit column stride, got {t.stride()}")


def _row_stride(t: torch.Tensor) -> int:
    return t.stride(0) if t.shape[0] > 1 else t.shape[1]


def _vec_ok(*tensors) -> bool:
    """Every row start is 16-byte aligned: a lane's feature group (4 f32 or
    8 bf16) is then one vector load or store."""
    for t in tensors:
        if t.data_ptr() % 16 or (_row_stride(t) * t.element_size()) % 16:
            return False
    return True


def _check_cuda_inputs(data, segment_ids):
    if data.dtype not in _KERNEL_DTYPES:
        raise TypeError(
            f"CUDA segment kernels take float32 or bfloat16 data, got {data.dtype}"
        )
    if data.dim() != 2:
        raise ValueError(f"data must be [E, F], got {tuple(data.shape)}")
    _check_rows("data", data, data.dtype, data.shape[1])
    if segment_ids.dim() != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"segment_ids must be [{data.shape[0]}], got {tuple(segment_ids.shape)}"
        )
    if segment_ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"segment_ids must be int32 or int64, got {segment_ids.dtype}")
    if segment_ids.device != data.device:
        raise ValueError("segment_ids and data must be on one device")


def _row_ptr(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR offsets [N+1] (int64) of sorted ids; ids outside [0, N) fall
    before row_ptr[0] or after row_ptr[N], so no row sees them."""
    ids = segment_ids.contiguous()
    rows = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, rows)


def _stream() -> int:
    """PyTorch's current CUDA stream, as the handle the C interface takes."""
    return torch.cuda.current_stream().cuda_stream


def sorted_segment_sum(
    data: torch.Tensor,  # [E, F], unit column stride
    segment_ids: torch.Tensor,  # [E] int32/int64, MONOTONE non-decreasing
    num_segments: int,
    *,
    input_op: str = "none",  # "none" | "relu" (fused input epilogue)
) -> torch.Tensor:
    """Segment sum for sorted ids; rows with ids outside [0, num_segments)
    are dropped. Returns ``[num_segments, F]`` in the data dtype (f32 sum)."""
    if input_op not in ("none", "relu"):
        raise ValueError(f"input_op must be 'none' or 'relu', got {input_op!r}")
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, segment_ids, num_segments,
                                        input_op=input_op)
    if data.device.type != "cuda":
        raise RuntimeError(f"no segment kernel for device {data.device}")
    _check_cuda_inputs(data, segment_ids)
    _forward_only(data)
    E, F = data.shape
    out = torch.empty((num_segments, F), dtype=data.dtype, device=data.device)
    if num_segments == 0 or F == 0:
        return out
    if E == 0:
        return out.zero_()
    row_ptr = _row_ptr(segment_ids, num_segments)
    from dgraph_tpu_torch.ops import _build

    lib = _build.load("sorted_segment")
    rc = lib.dg_sorted_segment_sum(
        data.data_ptr(), _row_stride(data), row_ptr.data_ptr(), out.data_ptr(),
        num_segments, F, _KERNEL_DTYPES[data.dtype], int(input_op == "relu"),
        int(_vec_ok(data, out)), _stream(),
    )
    _build.check(rc, "dg_sorted_segment_sum")
    sorted_segment_sum.launches += 1
    return out


def sorted_segment_sum_bias_relu(
    data: torch.Tensor,  # [E, F] per-edge stream, unit column stride
    segment_ids: torch.Tensor,  # [E] MONOTONE owner-side ids
    bias: torch.Tensor,  # [num_segments, F] owner-side operand, data dtype
    num_segments: int,
    *,
    edge_weight: Optional[torch.Tensor] = None,  # [E] post-activation scale
) -> torch.Tensor:
    """``out[v] = Σ_{e: ids[e]=v} w[e]·relu(data[e] + bias[v])`` for sorted
    ids, without an ``[E, F]`` message tensor. ``bias`` must already be in
    the data dtype (the dispatch point, ``ops.local``, casts it)."""
    if data.device.type == "cpu":
        return sorted_segment_sum_bias_relu_plain(
            data, segment_ids, bias, num_segments, edge_weight=edge_weight)
    if data.device.type != "cuda":
        raise RuntimeError(f"no segment kernel for device {data.device}")
    _check_cuda_inputs(data, segment_ids)
    E, F = data.shape
    _check_rows("bias", bias, data.dtype, F)
    if bias.shape[0] != num_segments or bias.device != data.device:
        raise ValueError(
            f"bias must be [{num_segments}, {F}] on {data.device}, got "
            f"{tuple(bias.shape)} on {bias.device}"
        )
    w = None
    if edge_weight is not None:
        if edge_weight.shape != (E,) or edge_weight.device != data.device:
            raise ValueError(f"edge_weight must be [{E}] on {data.device}")
        w = edge_weight.to(torch.float32).contiguous()
    _forward_only(data, bias, edge_weight)
    out = torch.empty((num_segments, F), dtype=data.dtype, device=data.device)
    if num_segments == 0 or F == 0:
        return out
    if E == 0:
        return out.zero_()
    row_ptr = _row_ptr(segment_ids, num_segments)
    from dgraph_tpu_torch.ops import _build

    lib = _build.load("sorted_segment")
    rc = lib.dg_sorted_segment_sum_bias_relu(
        data.data_ptr(), _row_stride(data), bias.data_ptr(), _row_stride(bias),
        None if w is None else w.data_ptr(), row_ptr.data_ptr(), out.data_ptr(),
        num_segments, F, _KERNEL_DTYPES[data.dtype],
        int(_vec_ok(data, bias, out)), _stream(),
    )
    _build.check(rc, "dg_sorted_segment_sum_bias_relu")
    sorted_segment_sum_bias_relu.launches += 1
    return out


sorted_segment_sum.launches = 0
sorted_segment_sum_bias_relu.launches = 0

# every kernel wrapper of this module, with the TPU kernel it replaces
KERNELS = {
    "sorted_segment_sum": (sorted_segment_sum, sorted_segment_sum_plain,
                           "dgraph_tpu/ops/pallas_segment.py:39"),
    "sorted_segment_sum_bias_relu": (sorted_segment_sum_bias_relu,
                                     sorted_segment_sum_bias_relu_plain,
                                     "dgraph_tpu/ops/pallas_segment.py:259"),
}


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {name: wrapper.launches for name, (wrapper, _, _) in KERNELS.items()}
