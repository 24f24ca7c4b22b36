"""Wire-format specs: WHAT encoding halo payloads ride the wire in —
counterpart of ``dgraph_tpu/wire/spec.py``.

The registry, the ``format_id`` values, byte pricing, the resolution ladder,
:func:`np_roundtrip_bound`, :func:`np_encode_compensated` and
:func:`delta_skip_rows` are the reference's, so a format prices the same
bytes and carries the same id in both packages. Three things differ:

- :func:`resolve_wire_format` reads the port's
  :mod:`dgraph_tpu_torch.config`;
- :func:`fp8_available` asks whether torch has ``torch.float8_e4m3fn``;
- the numpy reference codecs use no ``ml_dtypes`` (the card's machine has
  none): bf16 and float8 e4m3 are written with numpy bit arithmetic,
  rounding to nearest even, an overflow or NaN to the format's NaN with
  the input's sign, as ``ml_dtypes`` casts them. Numpy has no bfloat16, so
  a bf16 wire operand is held as its ``uint16`` bit patterns; its bytes
  and the fp8 operand's are the reference's ``np_encode`` bytes.

Formats:

- ``fp32`` — the identity default: the payload rides the activation dtype,
  exactly the path without a codec (a bf16-compute program ships bf16).
- ``bf16`` — payload cast to bfloat16 on send, widened back exactly on
  receive. Halves the wire bytes of an f32 program; lossless when the
  activations are already bf16.
- ``fp8``  — scaled float8 e4m3 with a per-row max-abs scale: each ``[F]``
  row is divided by ``max|x| / 448`` and cast to e4m3; the f32 scale's 4
  bytes follow the payload in the SAME row, so the wire operand is one
  ``[.., F+4]`` uint8 array.

Error compensation (opt-in): :func:`np_encode_compensated` carries the
encode residual forward so a receiver's accumulation over many steps stays
within a pinned tolerance of fp32.

This module imports numpy and the port's config only; the torch codecs are
:mod:`dgraph_tpu_torch.wire.codec`.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging

import numpy as np

_logger = logging.getLogger("dgraph_tpu_torch.wire")

# Bump when a serialized field changes meaning (additive fields do not).
WIRE_FORMAT_VERSION = 1

# Largest finite float8 e4m3fn magnitude: per-row scales normalize the
# row's max-abs to exactly this, so the quantizer never saturates.
E4M3_MAX = 448.0

# f32 bytes of the per-row scale the fp8 codec bitcasts into trailing
# uint8 payload lanes (the "+4" of its priced row width).
FP8_SCALE_BYTES = 4


@dataclasses.dataclass(frozen=True)
class WireFormat:
    """One wire encoding for halo payload rows.

    ``payload_itemsize`` is the encoded per-feature byte width
    (``None`` = identity: the payload rides the activation dtype);
    ``row_overhead_bytes`` is packed INTO the payload row (the fp8
    scale lanes), so a format's whole wire cost is one operand.
    """

    name: str
    wire_dtype: str  # numpy-style dtype name of the wire operand
    payload_itemsize: "int | None"  # None = activation dtype (identity)
    row_overhead_bytes: int = 0
    scaled: bool = False  # per-row max-abs scale carried in the payload
    lossless_from: tuple = ()  # activation dtypes round-tripped exactly
    description: str = ""

    def wire_row_bytes(self, feat_dim: int, activation_itemsize: int) -> int:
        """Bytes ONE encoded feature row occupies on the wire — the
        number every pricer (footprint, tuner) and every pin (trace,
        HLO) must agree on."""
        if self.payload_itemsize is None:
            return int(feat_dim) * int(activation_itemsize)
        return int(feat_dim) * self.payload_itemsize + self.row_overhead_bytes

    def wire_feat_dim(self, feat_dim: int) -> int:
        """Last-axis length of the encoded operand (the fp8 payload
        widens by its packed scale lanes)."""
        if self.payload_itemsize is None:
            return int(feat_dim)
        return int(feat_dim) + self.row_overhead_bytes // max(
            self.payload_itemsize, 1
        )

    def compression_ratio(self, feat_dim: int, activation_itemsize: int) -> float:
        """activation-row bytes / wire-row bytes (1.0 = identity)."""
        raw = int(feat_dim) * int(activation_itemsize)
        wire = self.wire_row_bytes(feat_dim, activation_itemsize)
        return raw / wire if wire else 1.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["lossless_from"] = list(self.lossless_from)
        d["version"] = WIRE_FORMAT_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "WireFormat":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in fields}
        kw["lossless_from"] = tuple(kw.get("lossless_from", ()))
        return cls(**kw)

    @property
    def format_id(self) -> str:
        """Content hash of the canonical serialization (the
        ``schedule_id`` convention): equal ids imply equal pricing."""
        key = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha1(key.encode()).hexdigest()[:12]


WIRE_FORMATS = {
    "fp32": WireFormat(
        name="fp32", wire_dtype="", payload_itemsize=None,
        lossless_from=("float32", "bfloat16", "float16"),
        description="identity: payload rides the activation dtype "
        "(bit-identical to the pre-codec wire)",
    ),
    "bf16": WireFormat(
        name="bf16", wire_dtype="bfloat16", payload_itemsize=2,
        lossless_from=("bfloat16",),
        description="bfloat16 payload, f32-exact widening on receive",
    ),
    "fp8": WireFormat(
        name="fp8", wire_dtype="uint8", payload_itemsize=1,
        row_overhead_bytes=FP8_SCALE_BYTES, scaled=True,
        description="float8 e4m3 payload with a per-row max-abs f32 "
        "scale packed into 4 trailing uint8 lanes",
    ),
}

WIRE_FORMAT_NAMES = tuple(WIRE_FORMATS)


def get_format(name: str) -> WireFormat:
    try:
        return WIRE_FORMATS[name]
    except KeyError:
        raise ValueError(
            f"unknown wire format {name!r}; known: {WIRE_FORMAT_NAMES}"
        ) from None


def fp8_available() -> bool:
    """Can the fp8 codec encode here? True when torch has the
    ``float8_e4m3fn`` dtype; a build without it degrades with one warning
    (:func:`resolve_wire_format`), never a crash at the exchange."""
    try:
        import torch

        return isinstance(getattr(torch, "float8_e4m3fn", None), torch.dtype)
    except Exception:  # noqa: BLE001 — any import/dtype wedge = absent
        return False


_degrade_warned: set = set()


def _warn_degrade(name: str, source: str, why: str) -> None:
    key = (name, source, why)
    if key in _degrade_warned:
        return
    _degrade_warned.add(key)
    _logger.warning(
        "wire_format=%r requested by %s but %s; the next resolution "
        "tier decides the format instead", name, source, why,
    )


def resolve_wire_format(
    world_size: int,
    halo_deltas: tuple,
    *,
    plan_format: str = "fp32",
    fp8_ok: "bool | None" = None,
) -> tuple:
    """The wire format a run will actually encode with, plus who decided.

    The ladder of the reference (``dgraph_tpu/wire/spec.py``):

    - ``'env'``     — ``DGRAPH_TPU_WIRE_FORMAT`` / ``config.set_flags``
      pins the format ('auto' defers).
    - ``'record'``  — an adopted TuningRecord chose it
      (``config.tuned_wire_format``; nothing sets it until the tuner is
      ported).
    - ``'plan'``    — the format attached to the plan at build time
      (``EdgePlan.wire_format`` — itself the build-time resolution, so
      a cache round-trip keeps the adopted format).
    - ``'default'`` — nothing chose: the fp32 identity format (a lossy
      codec never engages on its own — the un-A/B'd-kernel discipline).

    A tier naming a format whose preconditions fail (``fp8`` without the
    e4m3 dtype, an unknown name) degrades with ONE warning to the next
    tier — never a silent wrong answer. Plans with no cross-rank traffic
    resolve ``('fp32', 'plan')``: there is no wire to encode.
    """
    from dgraph_tpu_torch import config as _cfg

    if not halo_deltas:
        return "fp32", "plan"

    def _ok(name: str, source: str) -> bool:
        if name not in WIRE_FORMATS:
            _warn_degrade(name, source, f"it is not a registered format "
                          f"(known: {WIRE_FORMAT_NAMES})")
            return False
        if name == "fp8":
            avail = fp8_ok if fp8_ok is not None else fp8_available()
            if not avail:
                _warn_degrade(name, source,
                              "the float8 e4m3 dtype is unavailable here")
                return False
        return True

    env = getattr(_cfg, "wire_format", "auto")
    tuned = getattr(_cfg, "tuned_wire_format", None)
    for name, source in ((env, "env"), (tuned, "record"),
                         (plan_format, "plan")):
        if name in (None, "", "auto"):
            continue
        if name == "fp32" and source == "plan":
            # the attached default is not an adoption — fall through so
            # the source reports 'default' (nothing chose)
            break
        if _ok(name, source):
            return name, source
    return "fp32", "default"


# ---------------------------------------------------------------------------
# numpy reference codecs — ground truth for the torch pair, and what the
# selftest (wire/__main__.py) runs its vacuity mutants on
# ---------------------------------------------------------------------------


def np_bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 ``x`` rounded to bfloat16, as ``uint16`` bit patterns: round to
    nearest even on the bits, a NaN to the quiet NaN with its sign
    (``0x7fc0``), as ``ml_dtypes`` and XLA cast."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    mag = b & np.uint32(0x7FFFFFFF)
    rounded = (mag + np.uint32(0x7FFF) + ((mag >> 16) & np.uint32(1))) >> 16
    out = np.where(mag > np.uint32(0x7F800000), np.uint32(0x7FC0), rounded)
    return (out | ((b >> 16) & np.uint32(0x8000))).astype(np.uint16)


def np_bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns widened exactly to f32."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


# |v| above this rounds past e4m3fn's largest finite value (448, which 464
# rounds down to as the even neighbour): ml_dtypes gives NaN there
_E4M3_OVERFLOW = 464.0


def np_e4m3_bits(x: np.ndarray) -> np.ndarray:
    """f32 ``x`` rounded to float8 e4m3fn (bias 7, 3 mantissa bits, no
    infinity), as ``uint8`` codes: round to nearest even, subnormals in
    steps of 2**-9, an overflow (``|x| > 464``), an infinity or a NaN to
    the NaN code ``0x7f`` with the input's sign, as ``ml_dtypes`` casts."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    b = x.view(np.uint32)
    sign = ((b >> 24) & np.uint32(0x80)).astype(np.uint8)
    a = np.abs(x)
    with np.errstate(invalid="ignore"):
        nan = ~(a <= np.float32(_E4M3_OVERFLOW))
        sub = a < np.float32(2.0 ** -6)
    # subnormal range: multiples of 2**-9, the scaling exact; rint is
    # round-half-even, and 8 * 2**-9 is the smallest normal's code 0x08
    q_sub = np.rint(np.where(sub, a, 0) * np.float32(512.0)).astype(np.uint32)
    mag = b & np.uint32(0x7FFFFFFF)
    e = (mag >> 23).astype(np.int64) - 127
    m = mag & np.uint32(0x7FFFFF)
    m3 = (m + np.uint32((1 << 19) - 1) + ((m >> 20) & np.uint32(1))) >> 20
    carry = m3 >> 3
    q_norm = (((e + 7 + carry.astype(np.int64)) << 3) | (m3 & np.uint32(7))).clip(0, 0x7F)
    q = np.where(sub, q_sub, q_norm.astype(np.uint32))
    q = np.where(nan, np.uint32(0x7F), q).astype(np.uint8)
    return q | sign


def np_e4m3_to_f32(codes: np.ndarray) -> np.ndarray:
    """float8 e4m3fn codes widened exactly to f32 (the NaN codes to the
    quiet NaN with their sign, ``0x7fc00000``, as ``ml_dtypes`` widens)."""
    c = np.asarray(codes, np.uint8).astype(np.int64)
    e, m = (c >> 3) & 0xF, c & 7
    mant = np.where(e == 0, m.astype(np.float64), (8 + m).astype(np.float64))
    val = np.ldexp(mant, np.where(e == 0, -9, e - 10)).astype(np.float32)
    val = np.where(c & 0x80, -val, val)
    nan_bits = np.where(c & 0x80, np.uint32(0xFFC00000), np.uint32(0x7FC00000))
    return np.where((c & 0x7F) == 0x7F, nan_bits.view(np.float32), val).astype(np.float32)


def np_encode(x: np.ndarray, fmt: "WireFormat | str",
              *, compiled: bool = False, _scale_gain: float = 1.0) -> np.ndarray:
    """Reference encode of ``[.., F]`` rows to the wire operand: the
    reference's bytes (a bf16 operand as ``uint16`` bit patterns). With
    ``compiled`` the fp8 scale is ``max|x| * f32(1/448)``, as the
    reference's compiled lowerings and the torch codec compute it (XLA
    turns the division by the constant into that multiply; see
    :mod:`dgraph_tpu_torch.wire.codec`). ``_scale_gain`` exists ONLY for
    the selftest's wrong-scale vacuity mutant (a codec whose decode
    disagrees with its encode scale must blow the round-trip bound, proving
    the bound can go RED)."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    x = np.asarray(x)
    if fmt.payload_itemsize is None:  # fp32 identity
        return x
    if fmt.name == "bf16":
        return np_bf16_bits(x)
    if fmt.name == "fp8":
        x32 = np.ascontiguousarray(x, dtype=np.float32)
        amax = np.max(np.abs(x32), axis=-1, keepdims=True)
        scaled = (amax * (np.float32(1.0) / np.float32(E4M3_MAX)) if compiled
                  else amax / E4M3_MAX)
        scale = np.where(amax > 0, scaled, np.float32(1.0))
        scale = scale.astype(np.float32)
        with np.errstate(invalid="ignore", divide="ignore"):
            payload = np_e4m3_bits(x32 / (scale * _scale_gain))
        scale_lanes = np.ascontiguousarray(scale).view(np.uint8)
        return np.concatenate(
            [payload, scale_lanes.reshape(scale.shape[:-1] + (4,))], axis=-1
        )
    raise ValueError(f"no reference encoder for format {fmt.name!r}")


def np_decode(y: np.ndarray, fmt: "WireFormat | str",
              out_dtype=np.float32) -> np.ndarray:
    """Reference decode back to ``out_dtype`` (accumulation happens at
    f32: both lossy payloads widen exactly into f32 before any cast).
    ``out_dtype`` is a numpy float type: numpy has no bfloat16."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    y = np.asarray(y)
    if fmt.payload_itemsize is None:
        return y.astype(out_dtype) if y.dtype != out_dtype else y
    if fmt.name == "bf16":
        return np_bf16_to_f32(y).astype(out_dtype)
    if fmt.name == "fp8":
        F = y.shape[-1] - FP8_SCALE_BYTES
        payload = np_e4m3_to_f32(y[..., :F])
        scale = np.ascontiguousarray(y[..., F:]).view(np.float32)
        with np.errstate(invalid="ignore"):
            return (payload * scale).astype(out_dtype)
    raise ValueError(f"no reference decoder for format {fmt.name!r}")


def np_roundtrip_bound(fmt: "WireFormat | str") -> float:
    """Pinned max relative row-wise error of one encode/decode trip:
    0 for identity, one ulp of the payload mantissa for the casts
    (bf16: 8 mantissa bits; e4m3: 3 bits, plus per-row scale rounding)."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    return {"fp32": 0.0, "bf16": 2.0 ** -8, "fp8": 2.0 ** -3.5}[fmt.name]


def np_encode_compensated(
    x: np.ndarray, resid: "np.ndarray | None", fmt: "WireFormat | str",
    *, _drop_residual: bool = False,
) -> tuple:
    """Error-feedback encode: quantize ``x + resid`` and carry what the
    wire lost forward, so the RECEIVER'S ACCUMULATION over steps tracks
    the fp32 sum within a pinned bound instead of drifting with step
    count. Returns ``(wire_payload, new_resid)``; thread ``new_resid``
    into the next step's call (``resid=None`` starts at zero).
    ``_drop_residual`` is the selftest's dropped-residual vacuity mutant
    (compensation that doesn't carry must drift past the pinned bound)."""
    fmt = get_format(fmt) if isinstance(fmt, str) else fmt
    x32 = np.asarray(x, dtype=np.float32)
    carried = x32 if resid is None else x32 + np.asarray(resid, np.float32)
    y = np_encode(carried, fmt)
    if _drop_residual:
        return y, np.zeros_like(x32)
    return y, carried - np_decode(y, fmt, np.float32)


# ---------------------------------------------------------------------------
# delta-skip accounting: what the n_deltas-aware schedules save
# ---------------------------------------------------------------------------


def delta_skip_rows(pair_rows, world_size: int, s_pad: int) -> dict:
    """Row accounting of shipping ONLY live rows (the compiled
    schedule's per-pair heights) versus the dense lowerings' padded
    operands — the delta-skip generalization, as numbers: the ``sched``
    lowering already ships ~``live_rows`` per shard where ``all_to_all``
    ships ``(W-1) * s_pad`` and a ppermute ring ``n_deltas * s_pad``."""
    rows = tuple(tuple(int(v) for v in r) for r in pair_rows)
    live = sum(v for r in rows for v in r)
    deltas = sorted({
        (d - s) % world_size
        for s, r in enumerate(rows) for d, v in enumerate(r) if v and s != d
    })
    return {
        "live_rows_total": live,
        "a2a_rows_per_shard": (world_size - 1) * int(s_pad),
        "ppermute_rows_per_shard": len(deltas) * int(s_pad),
        "live_rows_max_shard": max(
            (sum(r) for r in rows), default=0
        ),
        "num_halo_deltas": len(deltas),
    }
