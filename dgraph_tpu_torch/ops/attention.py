"""Full-sequence attention: the flash-attention kernels, their plain versions
and the autograd Function.

Counterpart of ``_flash_dense`` (``dgraph_tpu/parallel/sequence.py:284-310``)
and of the library kernel it calls, ``jax.experimental.pallas.ops.tpu.
flash_attention``, whose three ``pl.pallas_call``s become three CUDA kernels
(``csrc/flash_attention.cu``, design notes there; all three run on the
tensor cores, bf16 in bf16 and f32 in split TF32 at f32 accuracy):

- :func:`flash_attention_fwd` replaces ``_flash_attention_kernel``
  (flash_attention.py:331): ``O = softmax(scale·QKᵀ + mask)·V`` and the
  per-row logsumexp ``lse`` ``[H, T]`` f32 (the reference saves ``m`` and
  ``l``; ``lse = m + log l`` carries the same);
- :func:`flash_attention_bwd_dkv` replaces ``_flash_attention_dkv_kernel``
  (:796): ``dK``, ``dV`` from ``Q, K, V, dO, lse, di``;
- :func:`flash_attention_bwd_dq` replaces ``_flash_attention_dq_kernel``
  (:1146): ``dQ``.

:func:`flash_attention` is the public entry on the reference's ``[T, H, D]``
layout. On a CUDA tensor it is :class:`_FlashAttention`: the forward kernel,
then in the backward ``di = Σ_d O·dO`` (a plain pass, as in the reference,
flash_attention.py:273-275), the dK/dV kernel and the dQ kernel. On a CPU
tensor it is :func:`dense_attention`, the plain version, with autograd
through it.

Masking follows ``dense_attention`` (``parallel/sequence.py:169-195``):
``kv_mask`` (``[T]``, > 0 = real position) masks keys, and padded query rows
come out zero. The reference's flash path instead gives padded positions a
second segment id (``SegmentIds``); after zeroing the padded rows the two
agree. The kernels read ``kv_mask`` as a key and query mask at once, so a
padded query row is an empty row there: output zero, no gradient.

Device rule: each kernel wrapper runs its plain version (``*_plain``) on a
CPU tensor and launches its kernel on a CUDA tensor, or raises. Each counts
its launches in ``<wrapper>.launches`` (``ops.kernels`` resets and reads
every kernel's count).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.autograd.function import once_differentiable

from dgraph_tpu_torch.ops import _build
from dgraph_tpu_torch.ops.segment import _KERNEL_DTYPES, Kernel, _on_card, _stream

# finite -inf stand-in of the dense oracle (parallel/sequence.py:38)
NEG_BIG = -0.7 * float(torch.finfo(torch.float32).max)

HEAD_DIMS = (32, 64, 128)  # head widths the CUDA kernels are built for


def _scale(scale: Optional[float], d: int) -> float:
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


# --- the plain version of the public function ---------------------------------


def _zero_padded_rows(out: torch.Tensor, kv_mask: torch.Tensor) -> torch.Tensor:
    """Padded query rows are zero (``parallel/sequence.py:161-166``): ``out``
    is ``[T, H, D]``, ``kv_mask`` the ``[T]`` query-position mask."""
    return out * (kv_mask > 0).to(out.dtype)[:, None, None]


def _key_allowed(T: int, causal: bool, kv_mask, device) -> torch.Tensor:
    """[T, T] bool: query i may attend key j (key mask and causal order)."""
    allowed = torch.ones((T, T), dtype=torch.bool, device=device)
    if kv_mask is not None:
        allowed = allowed & (kv_mask[None, :] > 0)
    if causal:
        allowed = allowed & torch.ones((T, T), dtype=torch.bool, device=device).tril()
    return allowed


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dense oracle, ``dgraph_tpu/parallel/sequence.py:169-195``:
    ``softmax(scale·q kᵀ)·v`` over the full sequence of ``[T, H, D]`` inputs,
    masked logits set to ``NEG_BIG``, masked probabilities re-zeroed, padded
    query rows zero; f32 math, output in ``q.dtype``."""
    T, H, D = q.shape
    scale = _scale(scale, D)
    logits = torch.einsum("thd,shd->ths", q.float(), k.float()) * scale
    allowed = _key_allowed(T, causal, kv_mask, q.device)[:, None, :]
    logits = torch.where(allowed, logits, NEG_BIG)
    p = torch.softmax(logits, dim=-1) * allowed
    out = torch.einsum("ths,shd->thd", p, v.float())
    if kv_mask is not None:
        out = _zero_padded_rows(out, kv_mask)
    return out.to(q.dtype)


# --- the kernels' plain versions ------------------------------------------------


def _allowed(T: int, causal: bool, kv_mask, device) -> torch.Tensor:
    """[1, T, T] bool as the kernels read the mask: ``kv_mask`` masks the
    query rows too, so a padded query row has no allowed key."""
    allowed = _key_allowed(T, causal, kv_mask, device)
    if kv_mask is not None:
        allowed = allowed & (kv_mask[:, None] > 0)
    return allowed[None]


def _probs(q, k, lse, scale, causal, kv_mask) -> torch.Tensor:
    """P = exp(scale·QKᵀ - lse) on the allowed entries, 0 elsewhere: [H, T, T]."""
    s = torch.einsum("thd,shd->hts", q.float(), k.float()) * scale
    allowed = _allowed(q.shape[0], causal, kv_mask, q.device)
    return torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)


def _rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` (f32) rounded to ``dtype`` and back: where the Pallas kernels
    feed a product in the input dtype (``P`` before ``P·V``,
    flash_attention.py:471; ``Pᵀ`` and ``dSᵀ`` before dV and dK, :900,
    :918; ``dS`` before dQ, :1258). In f32 it is ``x`` itself."""
    return x.to(dtype).float()


def flash_attention_fwd_plain(q, k, v, *, causal: bool = False,
                              scale: Optional[float] = None, kv_mask=None):
    """Plain version of :func:`flash_attention_fwd`: ``(O [T, H, D] in
    q.dtype, lse [H, T] f32)``; a row with no allowed key has O = 0 and
    lse = 0. P is rounded to v's dtype before ``P·V``, as the kernels (and
    the Pallas kernel) round it."""
    T, H, D = q.shape
    s = torch.einsum("thd,shd->hts", q.float(), k.float()) * _scale(scale, D)
    allowed = _allowed(T, causal, kv_mask, q.device)
    s = s.masked_fill(~allowed, -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    empty = torch.isneginf(lse)
    lse = torch.where(empty, 0.0, lse)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    out = torch.einsum("hts,shd->thd", _rounded(p, v.dtype), v.float())
    return out.to(q.dtype), lse


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, *, causal: bool = False,
                                  scale: Optional[float] = None, kv_mask=None):
    """Plain version of :func:`flash_attention_bwd_dkv`: ``P`` from ``lse``,
    ``dS = (dO Vᵀ - di)·P·scale``, ``dK = dSᵀ Q``, ``dV = Pᵀ dO`` in f32,
    returned in the input dtype; ``Pᵀ`` and ``dSᵀ`` are rounded to dO's
    dtype before their products, as the kernels round them."""
    scale = _scale(scale, q.shape[-1])
    p = _probs(q, k, lse, scale, causal, kv_mask)
    dof = do.float()
    dv = torch.einsum("hts,thd->shd", _rounded(p, do.dtype), dof)
    dp = torch.einsum("thd,shd->hts", dof, v.float())
    ds = (dp - di[..., None]) * p * scale
    dk = torch.einsum("hts,thd->shd", _rounded(ds, do.dtype), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq_plain(q, k, v, do, lse, di, *, causal: bool = False,
                                 scale: Optional[float] = None, kv_mask=None):
    """Plain version of :func:`flash_attention_bwd_dq`: ``dQ = dS K`` in
    f32, returned in the input dtype; ``dS`` is rounded to k's dtype before
    the product, as the kernel (and the Pallas kernel, flash_attention.py:1258)
    rounds it."""
    scale = _scale(scale, q.shape[-1])
    p = _probs(q, k, lse, scale, causal, kv_mask)
    dp = torch.einsum("thd,shd->hts", do.float(), v.float())
    ds = (dp - di[..., None]) * p * scale
    return torch.einsum("hts,shd->thd", _rounded(ds, k.dtype), k.float()).to(q.dtype)


def row_dot(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = Σ_d O·dO`` in f32, ``[H, T]``: the backward's row term."""
    return (o.float() * do.float()).sum(-1).t().contiguous()


# --- launches ---------------------------------------------------------------------


def _operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it in place, else a contiguous
    copy. In place: unit stride over D, row and head strides in whole
    16-byte groups (4 f32 or 8 bf16 elements) and a 16-byte aligned base.
    In bf16 that is what TMA asks of a tensor map (the tensor-core kernels);
    in f32 the kernels' split pre-passes and fragment loads read the
    operands element by element, and the rule is kept. The LM's q, k and v
    (column slices of one ``[T, 3L]`` tensor) and its cotangents pass as
    they are."""
    group = 16 // t.element_size()
    if (t.stride(2) != 1 or t.stride(0) % group or t.stride(1) % group
            or t.data_ptr() % 16):
        return t.contiguous()
    return t


def _strided(t: torch.Tensor) -> tuple:
    return t.data_ptr(), t.stride(0), t.stride(1)


def _check_cuda(q, k, v, *rest):
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"the CUDA attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3:
        raise ValueError(f"q must be [T, H, D], got {tuple(q.shape)}")
    T, H, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention kernels take head width D in {HEAD_DIMS}, got {D}")
    if T == 0 or H == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)) + tuple(("do", t) for t in rest):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _mask32(kv_mask, T: int, device):
    """The kernels' [T] int32 mask (nonzero = real position), or None."""
    if kv_mask is None:
        return None
    if kv_mask.shape != (T,) or kv_mask.device != device:
        raise ValueError(f"kv_mask must be [{T}] on {device}, got {tuple(kv_mask.shape)} "
                         f"on {kv_mask.device}")
    return (kv_mask > 0).to(torch.int32).contiguous()


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _split_scratch(T: int, H: int, D: int, dtype, device) -> Optional[torch.Tensor]:
    """The f32 forward's scratch, where its first kernel writes K and V
    split into TF32 (``dg_flash_attention_fwd``): ``4·H·T_pad·D`` floats,
    ``T_pad`` = T rounded up to 32; None in bf16, whose kernel reads K and V
    in place."""
    if dtype != torch.float32:
        return None
    t_pad = -(-T // 32) * 32
    return torch.empty(4 * H * t_pad * D, dtype=torch.float32, device=device)


# parts of the f32 backward's scratch: Q and dO (dK/dV) or K and V (dQ)
# split into TF32 hi and lo as rows, and transposed (Q and dO; K)
BWD_SCRATCH_PARTS = {"dkv": 8, "dq": 6}


def _bwd_scratch(kernel: str, T: int, H: int, D: int, dtype, device) -> Optional[torch.Tensor]:
    """The f32 backward kernel's scratch, where its pre-pass writes the
    operands it streams split into TF32 (``dg_flash_attention_bwd_dkv``,
    ``_dq``): ``BWD_SCRATCH_PARTS[kernel]·H·T_pad·D`` floats, ``T_pad`` = T
    rounded up to 32; None in bf16, whose kernels read the operands in
    place."""
    if dtype != torch.float32:
        return None
    t_pad = -(-T // 32) * 32
    return torch.empty(BWD_SCRATCH_PARTS[kernel] * H * t_pad * D, dtype=torch.float32,
                       device=device)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = False, scale: Optional[float] = None,
                        kv_mask: Optional[torch.Tensor] = None):
    """``(O, lse)`` for ``[T, H, D]`` inputs: O contiguous in the input
    dtype, lse ``[H, T]`` f32."""
    if not _on_card(q):
        return flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
    _check_cuda(q, k, v)
    T, H, D = q.shape
    q, k, v = _operand(q), _operand(k), _operand(v)
    mask = _mask32(kv_mask, T, q.device)
    out = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((H, T), dtype=torch.float32, device=q.device)
    scratch = _split_scratch(T, H, D, q.dtype, q.device)
    lib = _build.load("flash_attention")
    rc = lib.dg_flash_attention_fwd(
        *_strided(q), *_strided(k), *_strided(v), _ptr(mask), out.data_ptr(), lse.data_ptr(),
        T, H, D, _scale(scale, D), int(causal), _KERNEL_DTYPES[q.dtype], _stream(),
        _ptr(scratch),
    )
    _build.check(rc, "dg_flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _check_rows(lse, di, T, H, device):
    for name, t in (("lse", lse), ("di", di)):
        if t.shape != (H, T) or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"{name} must be [{H}, {T}] float32 on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def flash_attention_bwd_dkv(q, k, v, do, lse, di, *, causal: bool = False,
                            scale: Optional[float] = None, kv_mask=None):
    """``(dK, dV)``, contiguous ``[T, H, D]`` in the input dtype, from the
    forward's inputs, the output cotangent ``do``, ``lse`` and ``di``."""
    if not _on_card(q):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, causal=causal,
                                             scale=scale, kv_mask=kv_mask)
    _check_cuda(q, k, v, do)
    T, H, D = q.shape
    _check_rows(lse, di, T, H, q.device)
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.contiguous()
    mask = _mask32(kv_mask, T, q.device)
    dk = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    scratch = _bwd_scratch("dkv", T, H, D, q.dtype, q.device)
    lib = _build.load("flash_attention")
    rc = lib.dg_flash_attention_bwd_dkv(
        *_strided(q), *_strided(k), *_strided(v), *_strided(do), lse.data_ptr(),
        di.data_ptr(), _ptr(mask), dk.data_ptr(), dv.data_ptr(), T, H, D, _scale(scale, D),
        int(causal), _KERNEL_DTYPES[q.dtype], _stream(), _ptr(scratch),
    )
    _build.check(rc, "dg_flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, di, *, causal: bool = False,
                           scale: Optional[float] = None, kv_mask=None):
    """``dQ``, contiguous ``[T, H, D]`` in the input dtype."""
    if not _on_card(q):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, causal=causal,
                                            scale=scale, kv_mask=kv_mask)
    _check_cuda(q, k, v, do)
    T, H, D = q.shape
    _check_rows(lse, di, T, H, q.device)
    q, k, v, do = (_operand(t) for t in (q, k, v, do))
    lse, di = lse.contiguous(), di.contiguous()
    mask = _mask32(kv_mask, T, q.device)
    dq = torch.empty((T, H, D), dtype=q.dtype, device=q.device)
    scratch = _bwd_scratch("dq", T, H, D, q.dtype, q.device)
    lib = _build.load("flash_attention")
    rc = lib.dg_flash_attention_bwd_dq(
        *_strided(q), *_strided(k), *_strided(v), *_strided(do), lse.data_ptr(),
        di.data_ptr(), _ptr(mask), dq.data_ptr(), T, H, D, _scale(scale, D), int(causal),
        _KERNEL_DTYPES[q.dtype], _stream(), _ptr(scratch),
    )
    _build.check(rc, "dg_flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq


# --- autograd ---------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward kernel, saving O and lse; backward ``di``, the dK/dV kernel,
    the dQ kernel (``flash_attention.py:254-315``). On CPU tensors the
    wrappers run their plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        kw = dict(causal=ctx.causal, scale=ctx.scale, kv_mask=kv_mask)
        di = row_dot(out, do)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, di, **kw)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact attention over the full sequence of ``[T, H, D]`` inputs,
    ``[T, H, D]`` in ``q.dtype``: the flash kernels on a CUDA tensor (forward
    and backward), :func:`dense_attention` on a CPU tensor."""
    if not _on_card(q):
        return dense_attention(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask)
    return _FlashAttention.apply(q, k, v, kv_mask, causal, scale)


flash_attention_fwd.launches = 0
flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dq.launches = 0

_CU = "dgraph_tpu_torch/csrc/flash_attention.cu"
_PALLAS = "jax/experimental/pallas/ops/tpu/flash_attention.py"

# every kernel wrapper of this module, with the TPU kernel it replaces
KERNELS = {
    "flash_attention_fwd": Kernel(flash_attention_fwd, flash_attention_fwd_plain,
                                  f"{_PALLAS}:331", _CU),
    "flash_attention_bwd_dkv": Kernel(flash_attention_bwd_dkv, flash_attention_bwd_dkv_plain,
                                      f"{_PALLAS}:796", _CU),
    "flash_attention_bwd_dq": Kernel(flash_attention_bwd_dq, flash_attention_bwd_dq_plain,
                                     f"{_PALLAS}:1146", _CU),
}
