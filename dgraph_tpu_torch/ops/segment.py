"""Sorted-id kernels: their wrappers, plain versions and autograd.

Counterpart of ``dgraph_tpu/ops/pallas_segment.py``:

- :func:`sorted_segment_sum` replaces ``_kernel`` (pallas_segment.py:39,
  public ``sorted_segment_sum`` :225): ``out[v] = Σ_{e: ids[e]=v} op(data[e])``.
  Its backward is the row take ``g[ids]`` (times ``1[data > 0]`` for
  ``input_op="relu"``), as in ``_make_sss`` (:209-219);
- :func:`sorted_segment_sum_bias_relu` replaces ``_kernel_bias_relu``
  (pallas_segment.py:259, public ``sorted_segment_sum_bias_relu`` :479):
  ``out[v] = Σ_{e: ids[e]=v} w[e]·relu(data[e] + bias[v])`` with no ``[E, F]``
  message tensor in device memory. Its backward takes the reference's two
  routes (``_make_ssbr``, :399-473): unweighted with ``gather_mv > 0``, the
  kernel pair :func:`fused_bwd_gd` + :func:`sorted_segment_sum_act`;
  otherwise the composed route (two row takes, a mask and a sorted sum);
- :func:`sorted_segment_sum_act` replaces the ``epilogue="act"`` form of
  ``_kernel_bias_relu`` (:306-307, :384-388): ``out[v] = Σ w[e]·1[data[e] +
  bias[v] > 0]`` in f32, the backward's ``d_bias`` reduction;
- :func:`fused_bwd_gd` replaces ``_fused_bwd_kernel`` (:671, built by
  ``_make_fused_bwd`` :732): ``gd[e] = g[ids[e]]·1[data[e] + bias[ids[e]] > 0]``;
- :func:`sorted_row_gather` replaces ``_gather_kernel`` (:595, public
  ``sorted_row_gather`` :773): ``x[ids]``; its backward is the sorted sum
  (:657-665).

All take MONOTONE (sorted) ids; ids outside ``[0, N)`` are dropped by the
reductions and give zero rows in the gathers (the plan pads owner ids with
``n_pad``). The CUDA sources are ``csrc/sorted_segment.cu`` (the CSR
reductions: ``row_ptr = searchsorted(ids, arange(N+1))`` plays the part of
the TPU kernel's chunk schedule and drops out-of-range ids by construction;
:func:`csr_offsets` computes it once per ids tensor)
and ``csrc/sorted_gather.cu`` (the row gathers); the design notes are there.

Device rule: on a CPU tensor a wrapper runs its plain PyTorch version
(``*_plain``); on a CUDA tensor it launches its kernel or raises — there is
no fallback. The autograd Functions are the same on both devices, so the
CPU tests run the backward routes the card runs. Each wrapper counts its
launches in ``<wrapper>.launches`` (set to 0 with :func:`reset_launch_counts`);
a launch inside a backward counts for the kernel it launches.
"""

from __future__ import annotations

import weakref
from typing import NamedTuple, Optional

import torch
from torch.autograd.function import once_differentiable

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.ops import _build

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The hub route of kernels 1, 1a and 2 (csrc/sorted_segment.cu): a row of
# more than HUB_DEGREE edges is cut into chunks of at most HUB_CHUNK edges,
# each summed by a warp of its own into an f32 partial row, and the partials
# are then added in a fixed order. Both chosen by the sweep in the .cu's
# note: level with the best pair at F = 128 (GCN's feature chunks) on the
# skewed arxiv graph, faster at F = 16 and F = 1.
HUB_DEGREE = 256
HUB_CHUNK = 256


# --- plain versions (the CPU path and the kernels' oracle) -----------------


def _valid_range(ids: torch.Tensor, n: int) -> tuple[int, int]:
    """[lo, hi) of the sorted ids that fall inside [0, n)."""
    bounds = torch.tensor([0, n], dtype=ids.dtype, device=ids.device)
    lo, hi = torch.searchsorted(ids, bounds).tolist()
    return lo, hi


def _take_zero(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` with zero rows for ids outside ``[0, N)`` (negative ids
    too: the sorted kernels' convention)."""
    n = x.shape[0]
    ids = ids.long()
    x_ext = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return x_ext.index_select(0, torch.where((ids >= 0) & (ids < n), ids, n))


def sorted_segment_sum_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
    input_op: str = "none",
) -> torch.Tensor:
    """Plain version of :func:`sorted_segment_sum`: ``index_add`` over the
    valid ids. ``input_op="relu"`` applies relu in the data dtype; the sum
    is f32 and the result is cast back to the data dtype."""
    _check_input_op(input_op)
    lo, hi = _valid_range(segment_ids, num_segments)
    d = data[lo:hi]
    if input_op == "relu":
        d = torch.relu(d)
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    out = out.index_add(0, segment_ids[lo:hi].long(), d.float())
    return out.to(data.dtype)


def _bias_messages(data, segment_ids, bias, num_segments, edge_weight, act):
    """(first valid edge, the valid edges' ids, their f32 messages) in the
    fused kernel's rounding order: bias rounded to the data dtype; ``pre =
    f32(data) + f32(bias)``; relu (or the 0/1 mask for ``act``) in f32;
    times ``f32(w)``; the message rounded to the data dtype."""
    lo, hi = _valid_range(segment_ids, num_segments)
    ids = segment_ids[lo:hi].long()
    pre = data[lo:hi].float() + bias.to(data.dtype).index_select(0, ids).float()
    m = (pre > 0).float() if act else torch.relu(pre)
    if edge_weight is not None:
        m = m * edge_weight[lo:hi, None].float()
    return lo, ids, m.to(data.dtype).float()


def _bias_epilogue_plain(data, segment_ids, bias, num_segments, edge_weight, act):
    """:func:`_bias_messages` summed in f32."""
    _, ids, m = _bias_messages(data, segment_ids, bias, num_segments, edge_weight, act)
    out = torch.zeros((num_segments, data.shape[1]), dtype=torch.float32,
                      device=data.device)
    return out.index_add(0, ids, m)


def sorted_segment_sum_bias_relu_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, bias: torch.Tensor,
    num_segments: int, *, edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`sorted_segment_sum_bias_relu`, in the TPU
    kernel's rounding order; the output is cast to the data dtype."""
    return _bias_epilogue_plain(data, segment_ids, bias, num_segments,
                                edge_weight, act=False).to(data.dtype)


def sorted_segment_sum_act_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, bias: torch.Tensor,
    num_segments: int, *, edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain version of :func:`sorted_segment_sum_act`: ``Σ w·1[pre > 0]``
    in the same rounding order; the output stays f32."""
    return _bias_epilogue_plain(data, segment_ids, bias, num_segments,
                                edge_weight, act=True)


def fused_bwd_gd_plain(data: torch.Tensor, g: torch.Tensor, bias: torch.Tensor,
                       segment_ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_bwd_gd`: ``g[ids] * 1[f32(data) +
    f32(bias[ids]) > 0]`` with g and bias rounded to the data dtype, zero
    rows for ids outside ``[0, N)``, output in the data dtype."""
    g_rows = _take_zero(g.to(data.dtype), segment_ids)
    bias_rows = _take_zero(bias.to(data.dtype), segment_ids)
    act = (data.float() + bias_rows.float() > 0).float()
    return (g_rows.float() * act).to(data.dtype)


def sorted_row_gather_plain(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`sorted_row_gather`: ``x[ids]``, zero rows for
    ids outside ``[0, N)``."""
    return _take_zero(x, ids)


def hub_split_sum_plain(
    data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int, *,
    input_op: str = "none", bias: Optional[torch.Tensor] = None,
    edge_weight: Optional[torch.Tensor] = None, act: bool = False,
    degree: int = HUB_DEGREE, chunk: int = HUB_CHUNK,
) -> torch.Tensor:
    """The hub route's arithmetic in plain PyTorch, for the tests (no entry
    point calls it): kernel 2 (``bias`` None), kernel 1 or its act form
    (``act``), with every row of more than ``degree`` edges taken from its
    :func:`hub_plan` chunks, each summed in f32 into a partial row, the
    partials then added in chunk order; the other rows from the plain
    version. Equal to the plain version exactly when every chunk covers its
    own edges and each hub edge lies in one chunk."""
    if bias is None:
        _check_input_op(input_op)
        out = sorted_segment_sum_plain(data, segment_ids, num_segments, input_op=input_op)
        lo, _ = _valid_range(segment_ids, num_segments)
        m = (torch.relu(data) if input_op == "relu" else data).float()[lo:]
    else:
        plain = sorted_segment_sum_act_plain if act else sorted_segment_sum_bias_relu_plain
        out = plain(data, segment_ids, bias, num_segments, edge_weight=edge_weight)
        lo, _, m = _bias_messages(data, segment_ids, bias, num_segments, edge_weight, act)
    hub = hub_plan(_row_ptr(segment_ids, num_segments), degree, chunk)
    if hub is None:
        return out
    _, start, end = hub.chunks.tolist()
    partial = torch.stack([m[s - lo:e - lo].sum(0) for s, e in zip(start, end)])
    hub_of = torch.repeat_interleave(torch.arange(hub.n_hubs), hub.first.diff())
    rows = hub.chunks[0, hub.first[:-1]]
    combined = torch.zeros((hub.n_hubs, data.shape[1])).index_add_(0, hub_of, partial)
    out = out.clone()
    out[rows] = combined.to(out.dtype)
    return out


# --- argument checks -------------------------------------------------------


def _check_input_op(input_op: str) -> None:
    if input_op not in ("none", "relu"):
        raise ValueError(f"input_op must be 'none' or 'relu', got {input_op!r}")


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
    """Every row starts 16-byte aligned and is a whole number of 16-byte
    vectors wide: every lane's feature group (4 f32 or 8 bf16) is then one
    full vector load or store, and the kernel takes its vector path with no
    per-lane test."""
    for t in tensors:
        b = t.element_size()
        if t.data_ptr() % 16 or (_row_stride(t) * b) % 16 or (t.shape[1] * b) % 16:
            return False
    return True


def unit_cols(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its columns are contiguous (what the kernels take),
    else a contiguous copy: cotangents reach a backward in any layout."""
    return t if t.dim() != 2 or t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version runs); True for a CUDA
    tensor (the kernel launches); raises for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for device {t.device}")
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


def _check_vertex_operand(name, t, data, num_rows):
    _check_rows(name, t, data.dtype, data.shape[1])
    if t.shape[0] != num_rows or t.device != data.device:
        raise ValueError(
            f"{name} must be [{num_rows}, {data.shape[1]}] on {data.device}, got "
            f"{tuple(t.shape)} on {t.device}"
        )


def _row_ptr(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """CSR offsets [N+1] (int64) of sorted ids; ids outside [0, N) fall
    before row_ptr[0] or after row_ptr[N], so no row sees them."""
    ids = segment_ids.contiguous()
    rows = torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device)
    return torch.searchsorted(ids, rows)


class HubPlan(NamedTuple):
    """The hub rows of one ids tensor, as the kernels take them."""

    chunks: torch.Tensor  # [3, n_chunks] int64: each chunk's row, first edge, end edge
    first: torch.Tensor  # [n_hubs + 1] int64: each hub's first chunk, then n_chunks
    n_chunks: int
    n_hubs: int
    degree: int  # a row of more edges is a hub


class SegmentPlan(NamedTuple):
    row_ptr: torch.Tensor  # [N + 1] int64 CSR offsets
    hub: Optional[HubPlan]  # None: no row has more than HUB_DEGREE edges


def hub_plan(row_ptr: torch.Tensor, degree: int = HUB_DEGREE,
             chunk: int = HUB_CHUNK) -> Optional[HubPlan]:
    """The rows of more than ``degree`` edges of the CSR offsets
    ``row_ptr``, in row order, each cut into chunks of ``chunk`` edges (its
    last one shorter), on ``row_ptr``'s device; None without such rows.
    The counts are read to the host here, once per ids tensor, so a kernel
    call never waits on the card. The chunk bounds follow from the offsets
    and the two constants alone."""
    deg = row_ptr[1:] - row_ptr[:-1]
    rows = torch.nonzero(deg > degree).flatten()
    n_hubs = rows.numel()
    if n_hubs == 0:
        return None
    per = (deg[rows] + chunk - 1) // chunk
    first = torch.cat([per.new_zeros(1), per.cumsum(0)])
    n_chunks = int(first[-1])
    hub_of = torch.repeat_interleave(torch.arange(n_hubs, device=rows.device), per,
                                     output_size=n_chunks)
    row = rows[hub_of]
    k = torch.arange(n_chunks, device=rows.device) - first[hub_of]
    start = row_ptr[row] + k * chunk
    end = torch.minimum(start + chunk, row_ptr[row + 1])
    return HubPlan(torch.stack([row, start, end]), first, n_chunks, n_hubs, degree)


def _segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    row_ptr = _row_ptr(segment_ids, num_segments)
    return SegmentPlan(row_ptr, hub_plan(row_ptr))


# id(ids) -> (weak reference to ids, {num_segments: (ids._version, SegmentPlan)})
_offsets: dict = {}


def _forget(ref, key) -> None:
    if _offsets.get(key, (None,))[0] is ref:
        del _offsets[key]


def segment_plan(segment_ids: torch.Tensor, num_segments: int) -> SegmentPlan:
    """The CSR offsets (:func:`_row_ptr`) and the hub plan
    (:func:`hub_plan`) of sorted ids, computed once per ids tensor and
    reused by every later call of kernels 1, 1a and 2 on it: the plan's ids
    do not change within a run. The cache is keyed by the ids tensor
    OBJECT, through a weak reference (its entry dies with the tensor, and a
    new tensor never sees it, even with the same values or at a reused
    address), by its version counter (an in-place edit, of it or of a view
    sharing its storage, computes both again) and by N. Inference tensors
    have no version counter and are never cached. Writes that bypass
    PyTorch (a raw pointer, ``.numpy()``) are not seen: the ids must not
    change that way. ``csr_offsets.computed`` counts the computations."""
    if segment_ids.is_inference():
        csr_offsets.computed += 1
        return _segment_plan(segment_ids, num_segments)
    key = id(segment_ids)
    entry = _offsets.get(key)
    if entry is None or entry[0]() is not segment_ids:
        entry = (weakref.ref(segment_ids, lambda r, k=key: _forget(r, k)), {})
        _offsets[key] = entry
    hit = entry[1].get(num_segments)
    if hit is not None and hit[0] == segment_ids._version:
        return hit[1]
    plan = _segment_plan(segment_ids, num_segments)
    entry[1][num_segments] = (segment_ids._version, plan)
    csr_offsets.computed += 1
    return plan


def csr_offsets(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The cached CSR offsets of :func:`segment_plan`."""
    return segment_plan(segment_ids, num_segments).row_ptr


csr_offsets.computed = 0


def hub_args(hub: Optional[HubPlan], F: int, device) -> tuple:
    """(the trailing hub arguments of a sorted-segment C entry point, the
    f32 workspace they point into, which must live until the launch is
    queued); no hubs: null pointers and zeros."""
    if hub is None:
        return (None, None, 0, 0, 0, None), None
    ws = torch.empty((hub.n_chunks, F), dtype=torch.float32, device=device)
    return (hub.chunks.data_ptr(), hub.first.data_ptr(), hub.n_chunks, hub.n_hubs,
            hub.degree, ws.data_ptr()), ws


def _ids32(ids: torch.Tensor, num_rows: int) -> torch.Tensor:
    """The gathers' int32 ids; int64 ids are clamped to [-1, N] first, which
    keeps every out-of-range id out of range."""
    if ids.dtype == torch.int64:
        ids = ids.clamp(-1, num_rows).to(torch.int32)
    return ids.contiguous()


def _stream() -> int:
    """PyTorch's current CUDA stream, as the handle the C interface takes."""
    return torch.cuda.current_stream().cuda_stream


# --- launches (kernel on a CUDA tensor, plain version on a CPU tensor) -----


def _segment_sum(data, segment_ids, num_segments, input_op):
    if not _on_card(data):
        return sorted_segment_sum_plain(data, segment_ids, num_segments,
                                        input_op=input_op)
    _check_cuda_inputs(data, segment_ids)
    E, F = data.shape
    out = torch.empty((num_segments, F), dtype=data.dtype, device=data.device)
    if num_segments == 0 or F == 0:
        return out
    if E == 0:
        return out.zero_()
    plan = segment_plan(segment_ids, num_segments)
    hub, ws = hub_args(plan.hub, F, data.device)
    lib = _build.load("sorted_segment")
    rc = lib.dg_sorted_segment_sum(
        data.data_ptr(), _row_stride(data), plan.row_ptr.data_ptr(), out.data_ptr(),
        num_segments, F, _KERNEL_DTYPES[data.dtype], int(input_op == "relu"),
        int(_vec_ok(data, out)), _stream(), *hub,
    )
    del ws
    _build.check(rc, "dg_sorted_segment_sum")
    sorted_segment_sum.launches += 1
    sorted_segment_sum.hub_calls += plan.hub is not None
    return out


def _bias_epilogue(data, segment_ids, bias, num_segments, edge_weight, act):
    """The fused kernel in its relu form (output in the data dtype) or its
    act form (f32 output)."""
    if not _on_card(data):
        plain = sorted_segment_sum_act_plain if act else sorted_segment_sum_bias_relu_plain
        return plain(data, segment_ids, bias, num_segments, edge_weight=edge_weight)
    _check_cuda_inputs(data, segment_ids)
    E, F = data.shape
    _check_vertex_operand("bias", bias, data, num_segments)
    w = None
    if edge_weight is not None:
        if edge_weight.shape != (E,) or edge_weight.device != data.device:
            raise ValueError(f"edge_weight must be [{E}] on {data.device}")
        w = edge_weight.to(torch.float32).contiguous()
    out_dtype = torch.float32 if act else data.dtype
    out = torch.empty((num_segments, F), dtype=out_dtype, device=data.device)
    if num_segments == 0 or F == 0:
        return out
    if E == 0:
        return out.zero_()
    plan = segment_plan(segment_ids, num_segments)
    hub, ws = hub_args(plan.hub, F, data.device)
    lib = _build.load("sorted_segment")
    fn = lib.dg_sorted_segment_sum_act if act else lib.dg_sorted_segment_sum_bias_relu
    rc = fn(
        data.data_ptr(), _row_stride(data), bias.data_ptr(), _row_stride(bias),
        None if w is None else w.data_ptr(), plan.row_ptr.data_ptr(), out.data_ptr(),
        num_segments, F, _KERNEL_DTYPES[data.dtype],
        int(_vec_ok(data, bias, out)), _stream(), *hub,
    )
    del ws
    wrapper = sorted_segment_sum_act if act else sorted_segment_sum_bias_relu
    _build.check(rc, f"dg_{wrapper.__name__}")
    wrapper.launches += 1
    wrapper.hub_calls += plan.hub is not None
    return out


def _row_gather(x, ids):
    if not _on_card(x):
        return sorted_row_gather_plain(x, ids)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA row gather takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, F], got {tuple(x.shape)}")
    _check_rows("x", x, x.dtype, x.shape[1])
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64) or ids.device != x.device:
        raise ValueError(f"ids must be int32/int64 [E] on {x.device}")
    N, F = x.shape
    E = ids.shape[0]
    out = torch.empty((E, F), dtype=x.dtype, device=x.device)
    if E == 0 or F == 0:
        return out
    if N == 0:
        return out.zero_()
    ids = _ids32(ids, N)
    lib = _build.load("sorted_gather")
    rc = lib.dg_sorted_row_gather(
        x.data_ptr(), _row_stride(x), ids.data_ptr(), out.data_ptr(), E, N, F,
        _KERNEL_DTYPES[x.dtype], int(_vec_ok(x, out)), _stream(),
    )
    _build.check(rc, "dg_sorted_row_gather")
    sorted_row_gather.launches += 1
    return out


# --- the non-differentiable kernel wrappers (backward-internal) -----------


def sorted_segment_sum_act(
    data: torch.Tensor,  # [E, F] per-edge stream, unit column stride
    segment_ids: torch.Tensor,  # [E] MONOTONE owner-side ids
    bias: torch.Tensor,  # [num_segments, F], data dtype
    num_segments: int,
    *,
    edge_weight: Optional[torch.Tensor] = None,  # [E]
) -> torch.Tensor:
    """``out[v] = Σ_{e: ids[e]=v} w[e]·1[data[e] + bias[v] > 0]`` for sorted
    ids, ``[num_segments, F]`` float32 (a degree-sized count saturates in
    bf16). Decides the mask exactly as the forward kernel does."""
    return _bias_epilogue(data, segment_ids, bias, num_segments, edge_weight, act=True)


def fused_bwd_gd(
    data: torch.Tensor,  # [E, F]
    g: torch.Tensor,  # [N, F] output cotangent, data dtype
    bias: torch.Tensor,  # [N, F], data dtype
    segment_ids: torch.Tensor,  # [E] MONOTONE owner-side ids
) -> torch.Tensor:
    """``gd[e] = g[ids[e]]·1[data[e] + bias[ids[e]] > 0]``, ``[E, F]`` in the
    data dtype, zero rows for ids outside ``[0, N)``: the fused scatter's
    data gradient in one pass, with no ``[E, F]`` intermediate."""
    if not _on_card(data):
        return fused_bwd_gd_plain(data, g, bias, segment_ids)
    _check_cuda_inputs(data, segment_ids)
    N = g.shape[0]
    _check_vertex_operand("g", g, data, N)
    _check_vertex_operand("bias", bias, data, N)
    E, F = data.shape
    out = torch.empty((E, F), dtype=data.dtype, device=data.device)
    if E == 0 or F == 0:
        return out
    if N == 0:
        return out.zero_()
    ids = _ids32(segment_ids, N)
    lib = _build.load("sorted_gather")
    rc = lib.dg_fused_bwd_gd(
        data.data_ptr(), _row_stride(data), g.data_ptr(), _row_stride(g),
        bias.data_ptr(), _row_stride(bias), ids.data_ptr(), out.data_ptr(), E, N, F,
        _KERNEL_DTYPES[data.dtype], int(_vec_ok(data, g, bias, out)), _stream(),
    )
    _build.check(rc, "dg_fused_bwd_gd")
    fused_bwd_gd.launches += 1
    return out


def take_sorted(g: torch.Tensor, ids: torch.Tensor, gather_mv: int) -> torch.Tensor:
    """Backward-side row take by PLAN-SORTED ids (the reference's
    ``_take_sorted``, pallas_segment.py:327-340): the sorted-row-gather
    kernel when ``config.use_pallas_gather`` is on and the plan carried a
    span hint (``gather_mv > 0``), else ``ops.local.row_take`` (an
    ``index_select``; out-of-range ids give zero rows either way)."""
    if gather_mv > 0 and _cfg.pallas_gather_enabled():
        return _row_gather(g, ids)
    from dgraph_tpu_torch.ops.local import row_take

    return row_take(g, ids)


# --- autograd --------------------------------------------------------------


class _SortedSegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, num_segments, input_op, gather_mv):
        relu = input_op == "relu"
        ctx.save_for_backward(segment_ids, data if relu else None)
        ctx.relu, ctx.gather_mv = relu, gather_mv
        return _segment_sum(data, segment_ids, num_segments, input_op)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        segment_ids, data = ctx.saved_tensors
        gd = take_sorted(unit_cols(g), segment_ids, ctx.gather_mv)
        if ctx.relu:
            gd = gd * (data > 0).to(gd.dtype)
        return gd, None, None, None, None


class _SortedSegmentSumBiasRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, segment_ids, bias, edge_weight, num_segments, gather_mv):
        # remat-style: the only per-edge tensor kept is the input stream
        ctx.save_for_backward(data, segment_ids, bias, edge_weight)
        ctx.num_segments, ctx.gather_mv = num_segments, gather_mv
        return _bias_epilogue(data, segment_ids, bias, num_segments, edge_weight, act=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, ids, bias, w = ctx.saved_tensors
        n, mv = ctx.num_segments, ctx.gather_mv
        cdt = data.dtype
        g = unit_cols(g)
        if w is None and mv > 0:
            # the kernel pair: gd from one pass over data, d_bias's Σact
            # from one more; no [E, F] intermediate in device memory
            gd = fused_bwd_gd(data, g.to(cdt), bias.to(cdt), ids)
            d_bias = sorted_segment_sum_act(data, ids, bias, n) * g.float()
            return gd, None, d_bias.to(bias.dtype), None, None, None
        # composed route: recompute the mask from the two row takes. Every
        # [E, F] tensor stays in the compute dtype; the mask is decided in
        # f32 on the bias rounded as the forward rounded it
        bias_rows = take_sorted(bias.to(cdt), ids, mv)
        pre = data.float() + bias_rows.float()
        act = (pre > 0).to(cdt)
        g_rows = take_sorted(g.to(cdt), ids, mv)
        wc = w[:, None].to(cdt) if w is not None else None
        gd = g_rows * act if wc is None else g_rows * act * wc
        d_bias = _segment_sum(act if wc is None else act * wc, ids, n, "none")
        d_bias = d_bias.float() * g.float()
        d_w = None
        if w is not None and ctx.needs_input_grad[3]:
            d_w = (g_rows * pre.clamp_min(0)).sum(-1).to(w.dtype)
        return gd.to(data.dtype), None, d_bias.to(bias.dtype), d_w, None, None


class _SortedRowGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ids):
        ctx.save_for_backward(ids)
        ctx.num_rows = x.shape[0]
        return _row_gather(x, ids)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        # the exact transpose: the sorted segment sum of the cotangent rows
        return _segment_sum(unit_cols(g), ids, ctx.num_rows, "none"), None


# --- the differentiable kernel wrappers ------------------------------------


def sorted_segment_sum(
    data: torch.Tensor,  # [E, F], unit column stride
    segment_ids: torch.Tensor,  # [E] int32/int64, MONOTONE non-decreasing
    num_segments: int,
    *,
    input_op: str = "none",  # "none" | "relu" (fused input epilogue)
    gather_mv: int = 0,  # the plan's span hint: > 0 lets the backward's row
    # take use sorted_row_gather when config.use_pallas_gather is on
) -> torch.Tensor:
    """Segment sum for sorted ids; rows with ids outside [0, num_segments)
    are dropped. Returns ``[num_segments, F]`` in the data dtype (f32 sum).
    Differentiable: the backward is ``g[ids]`` (zero for dropped rows).
    Where no gradient can flow (grad mode off, or data not requiring one:
    serving, SAGE's degree count) the autograd Function is skipped, which
    saves its host time (a third of the wrapper's at F = 1, PERF.md §6)."""
    _check_input_op(input_op)
    if not (torch.is_grad_enabled() and data.requires_grad):
        return _segment_sum(data, segment_ids, num_segments, input_op)
    return _SortedSegmentSum.apply(data, segment_ids, num_segments, input_op, gather_mv)


def sorted_segment_sum_bias_relu(
    data: torch.Tensor,  # [E, F] per-edge stream, unit column stride
    segment_ids: torch.Tensor,  # [E] MONOTONE owner-side ids
    bias: torch.Tensor,  # [num_segments, F] owner-side operand, data dtype
    num_segments: int,
    *,
    edge_weight: Optional[torch.Tensor] = None,  # [E] post-activation scale
    gather_mv: int = 0,  # the plan's span hint: > 0 selects the unweighted
    # op's backward kernel pair, and lets the composed backward's row takes
    # use sorted_row_gather when config.use_pallas_gather is on
) -> torch.Tensor:
    """``out[v] = Σ_{e: ids[e]=v} w[e]·relu(data[e] + bias[v])`` for sorted
    ids, without an ``[E, F]`` message tensor. ``bias`` must already be in
    the data dtype (the dispatch point, ``ops.local``, casts it).
    Differentiable in data, bias and edge_weight (remat-style backward)."""
    return _SortedSegmentSumBiasRelu.apply(data, segment_ids, bias, edge_weight,
                                           num_segments, gather_mv)


def sorted_row_gather(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``x[ids]`` for sorted ids, ``[E, F]`` in x's dtype, zero rows for ids
    outside ``[0, N)``. Differentiable: the backward is the sorted segment
    sum of the cotangent rows."""
    return _SortedRowGather.apply(x, ids)


sorted_segment_sum.launches = sorted_segment_sum.hub_calls = 0
sorted_segment_sum_bias_relu.launches = sorted_segment_sum_bias_relu.hub_calls = 0
sorted_segment_sum_act.launches = sorted_segment_sum_act.hub_calls = 0
fused_bwd_gd.launches = 0
sorted_row_gather.launches = 0


class Kernel(NamedTuple):
    wrapper: object
    plain: object
    replaces: str  # the TPU kernel, file:line
    source: str  # the CUDA source, path in the repo


_SEG_CU = "dgraph_tpu_torch/csrc/sorted_segment.cu"
_GATHER_CU = "dgraph_tpu_torch/csrc/sorted_gather.cu"
_PALLAS = "dgraph_tpu/ops/pallas_segment.py"

# every kernel wrapper of this module, with the TPU kernel it replaces
KERNELS = {
    "sorted_segment_sum": Kernel(sorted_segment_sum, sorted_segment_sum_plain,
                                 f"{_PALLAS}:39", _SEG_CU),
    "sorted_segment_sum_bias_relu": Kernel(
        sorted_segment_sum_bias_relu, sorted_segment_sum_bias_relu_plain,
        f"{_PALLAS}:259", _SEG_CU),
    "sorted_segment_sum_act": Kernel(sorted_segment_sum_act, sorted_segment_sum_act_plain,
                                     f"{_PALLAS}:306", _SEG_CU),
    "fused_bwd_gd": Kernel(fused_bwd_gd, fused_bwd_gd_plain, f"{_PALLAS}:671", _GATHER_CU),
    "sorted_row_gather": Kernel(sorted_row_gather, sorted_row_gather_plain,
                                f"{_PALLAS}:595", _GATHER_CU),
}


# the wrappers that can take the hub route; each counts the calls that did
# in ``<wrapper>.hub_calls``
HUB_ROUTE = ("sorted_segment_sum", "sorted_segment_sum_bias_relu", "sorted_segment_sum_act")


def hub_calls() -> dict:
    """{"<wrapper>.hub_calls": calls that ran the hub route}."""
    return {f"{name}.hub_calls": KERNELS[name].wrapper.hub_calls for name in HUB_ROUTE}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.wrapper.launches = 0
    for name in HUB_ROUTE:
        KERNELS[name].wrapper.hub_calls = 0


def launch_counts() -> dict:
    """Each wrapper's launches, then the hub-route calls (:func:`hub_calls`)."""
    return {**{name: k.wrapper.launches for name, k in KERNELS.items()}, **hub_calls()}
