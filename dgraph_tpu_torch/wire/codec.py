"""Torch wire codecs: the raw ``(encode, decode)`` pair of each (format,
activation dtype) — counterpart of ``dgraph_tpu/wire/codec.py``
(``make_wire_transform``, :84-112; ``encode_compensated``, :195-212).

The bytes are :func:`dgraph_tpu_torch.wire.spec.np_encode`'s (the
reference's) on the CPU and on the card:

- bf16: each f32 value rounded to nearest even, a NaN to the quiet NaN with
  its sign (``0x7fc0``, as ``ml_dtypes`` and XLA cast; torch's own cast
  gives another NaN pattern);
- fp8 (``codec.py:62-81`` as the reference's lowerings run it): per row
  the scale ``max|x| / 448`` in f32, computed as ``max|x| * f32(1/448)``
  (an all-zero row, or one holding a NaN, gets 1.0), the payload ``(x /
  scale)`` cast to ``torch.float8_e4m3fn`` and
  viewed as ``uint8`` (a value past 464, an infinity or a NaN to the NaN
  code ``0x7f`` with its sign, where torch's cast saturates), then the
  scale's 4 little-endian bytes: one ``[.., F+4]`` uint8 row. An all-zero
  wire row (the buffer rows no put or round reaches) decodes to +0.0.

Decode widens exactly to f32 and casts to the activation dtype there.

The scale's multiply: every reference lowering runs its codec compiled,
and XLA's algebraic simplifier compiles a division by a constant, ``amax /
448``, as a multiply by the constant's f32 reciprocal, which differs from
the division in the scale's last bit on about half of the rows (measured on
normal rows). The reference's numpy codec (``np_encode``) and an eager ``jnp``
call divide. The port follows the compiled reference, so each lowering's
bits are the reference lowering's under the same format;
:func:`dgraph_tpu_torch.wire.spec.np_encode` keeps the reference's numpy
bytes, and with ``compiled=True`` computes this codec's.

No ``torch.autograd.Function`` wraps a codec: the lowerings'
``_Exchange`` / ``_Unexchange`` (:mod:`dgraph_tpu_torch.comm.collectives`)
are already opaque to autograd and call the pair inside their forward and
backward, so autograd never meets a ``uint8`` tensor. The reference's
custom-VJP wrappers (``make_wire_codec``, ``make_a2a_codec``,
``make_ppermute_codec``) exist for JAX's autodiff and have no counterpart.

Every encode and decode adds one to :data:`CALLS` (the fp32 identity
makes none). The codecs are plain PyTorch ops, as the reference's are
XLA-fused ``jnp`` outside any Pallas kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from dgraph_tpu_torch.wire.spec import E4M3_MAX, FP8_SCALE_BYTES, fp8_available, get_format

# encode and decode calls since the last reset_calls()
CALLS = {"encode": 0, "decode": 0}

# |v| above this rounds past e4m3fn's largest finite value, 448
_E4M3_OVERFLOW = 464.0
# f32(1 / 448): the scale's multiplier in the reference's compiled codec
INV_E4M3_MAX = float(np.float32(1.0) / np.float32(E4M3_MAX))


def reset_calls() -> None:
    CALLS.update(encode=0, decode=0)


def _sign_nan(x: torch.Tensor, nan_bits: int, shift: int) -> torch.Tensor:
    """The NaN pattern ``nan_bits`` with the sign of each f32 of ``x``
    moved down ``shift`` bits (int32)."""
    return ((x.view(torch.int32) >> shift) & (0x80000000 >> shift)) | nan_bits


def to_bf16(x32: torch.Tensor) -> torch.Tensor:
    """f32 -> bfloat16, round to nearest even, a NaN to ``0x7fc0`` with its
    sign: the reference's bits."""
    y = x32.to(torch.bfloat16).view(torch.int16)
    fix = _sign_nan(x32, 0x7FC0, 16).to(torch.int16)
    return torch.where(x32.isnan(), fix, y).view(torch.bfloat16)


def _e4m3_encode(v: torch.Tensor) -> torch.Tensor:
    """f32 -> e4m3fn codes (uint8): torch's cast, with a value past 464, an
    infinity or a NaN given the NaN code ``0x7f`` and its sign."""
    q = v.to(torch.float8_e4m3fn).view(torch.uint8)
    bad = ~(v.abs() <= _E4M3_OVERFLOW)
    return torch.where(bad, _sign_nan(v, 0x7F, 24).to(torch.uint8), q)


def _e4m3_decode(codes: torch.Tensor) -> torch.Tensor:
    """e4m3fn codes -> f32 (the NaN codes to ``0x7fc00000`` with their
    sign)."""
    v = codes.view(torch.float8_e4m3fn).to(torch.float32)
    nan = (codes & 0x7F) == 0x7F
    nan_bits = torch.where(codes >= 0x80, -0x400000, 0x7FC00000).to(torch.int32)
    return torch.where(nan, nan_bits.view(torch.float32), v)


def _cast(x32: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.float32:
        return x32
    return to_bf16(x32) if dtype == torch.bfloat16 else x32.to(dtype)


def _fp8_encode(x: torch.Tensor) -> torch.Tensor:
    CALLS["encode"] += 1
    x32 = x.to(torch.float32)
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax * INV_E4M3_MAX, torch.ones_like(amax))
    payload = _e4m3_encode(x32 / scale)
    lanes = scale.contiguous().view(torch.uint8)  # [.., 1] f32 -> [.., 4] bytes
    return torch.cat([payload, lanes], dim=-1)


def _fp8_decode(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    CALLS["decode"] += 1
    F = y.shape[-1] - FP8_SCALE_BYTES
    scale = y[..., F:].clone(memory_format=torch.contiguous_format).view(torch.float32)
    return _cast(_e4m3_decode(y[..., :F]) * scale, dtype)


def _bf16_encode(x: torch.Tensor) -> torch.Tensor:
    CALLS["encode"] += 1
    return to_bf16(x.to(torch.float32))


def _bf16_decode(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    CALLS["decode"] += 1
    return _cast(y.to(torch.float32), dtype)


@functools.lru_cache(maxsize=None)
def make_wire_transform(fmt_name: str, dtype: torch.dtype):
    """Raw ``(encode, decode)`` for activation ``dtype``, or ``(None,
    None)`` when the format is the identity (fp32, and bf16 on bf16
    activations), so the caller's path without a codec is unchanged."""
    fmt = get_format(fmt_name)
    if fmt.payload_itemsize is None:
        return None, None
    if fmt.name == "bf16":
        if dtype == torch.bfloat16:
            return None, None
        return _bf16_encode, functools.partial(_bf16_decode, dtype=dtype)
    if fmt.name == "fp8":
        if not fp8_available():
            raise RuntimeError(
                "wire format 'fp8' requires torch.float8_e4m3fn; resolve_wire_format "
                "should have degraded before the exchange")
        return _fp8_encode, functools.partial(_fp8_decode, dtype=dtype)
    raise ValueError(f"no torch codec for wire format {fmt_name!r}")


def encode_compensated(x: torch.Tensor, resid, fmt_name: str) -> tuple:
    """Error-feedback encode (the reference's ``encode_compensated``):
    quantize ``x + resid`` and return ``(wire_payload, new_resid)`` with the
    residual carried at f32. Thread ``new_resid`` into the next step;
    ``resid=None`` starts at zero. With the identity format the payload is
    ``x`` at f32 and the residual stays zero."""
    enc, dec = make_wire_transform(fmt_name, torch.float32)
    x32 = x.to(torch.float32)
    carried = x32 if resid is None else x32 + resid.to(torch.float32)
    if enc is None:
        return carried, torch.zeros_like(carried)
    y = enc(carried)
    return y, carried - dec(y).to(torch.float32)


def wire_operand(fmt_name: str, feat_dim: int, dtype: torch.dtype) -> tuple:
    """``(last-axis length, torch dtype)`` of the wire operand of ``[..,
    feat_dim]`` rows of activation ``dtype`` under the format: a receive
    buffer's shape before any payload arrives (the identity: the rows as
    they are)."""
    enc, _ = make_wire_transform(fmt_name, dtype)
    if enc is None:
        return int(feat_dim), dtype
    fmt = get_format(fmt_name)
    return fmt.wire_feat_dim(feat_dim), getattr(torch, fmt.wire_dtype)
