"""Wire codec layer: compressed halo payloads — counterpart of
``dgraph_tpu/wire/``.

Separates *what rows cross the wire* (the plan's send tables, the schedule
compiler's rounds) from *how they are encoded*: a registry of serializable
:class:`~dgraph_tpu_torch.wire.spec.WireFormat` specs (fp32 identity /
bf16 / scaled fp8-e4m3) with the reference's format ids, the
resolution ladder, hub-row dedup with a delivery-simulation verifier
(``dedup.py``, the reference's file), and torch codecs
(:mod:`dgraph_tpu_torch.wire.codec`) that the halo lowerings call in both
directions of every exchange.

``spec`` and ``dedup`` need numpy only (``spec`` reads the port's config);
the torch codecs are re-exported lazily below (PEP 562).
"""

from dgraph_tpu_torch.wire.dedup import (
    DedupPlan,
    HubRow,
    RelayTransfer,
    build_dedup_plan,
    dedup_stats,
    detect_hub_rows,
    pair_live_rows,
    verify_dedup_coverage,
)
from dgraph_tpu_torch.wire.spec import (
    E4M3_MAX,
    FP8_SCALE_BYTES,
    WIRE_FORMAT_NAMES,
    WIRE_FORMAT_VERSION,
    WIRE_FORMATS,
    WireFormat,
    delta_skip_rows,
    fp8_available,
    get_format,
    np_decode,
    np_encode,
    np_encode_compensated,
    np_roundtrip_bound,
    resolve_wire_format,
)

_CODEC_EXPORTS = (
    "encode_compensated",
    "make_wire_transform",
)


def __getattr__(name):  # PEP 562: the codecs load when asked for
    if name in _CODEC_EXPORTS:
        from dgraph_tpu_torch.wire import codec

        return getattr(codec, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "DedupPlan",
    "E4M3_MAX",
    "FP8_SCALE_BYTES",
    "HubRow",
    "RelayTransfer",
    "WIRE_FORMATS",
    "WIRE_FORMAT_NAMES",
    "WIRE_FORMAT_VERSION",
    "WireFormat",
    "build_dedup_plan",
    "dedup_stats",
    "delta_skip_rows",
    "detect_hub_rows",
    "fp8_available",
    "get_format",
    "np_decode",
    "np_encode",
    "np_encode_compensated",
    "np_roundtrip_bound",
    "pair_live_rows",
    "resolve_wire_format",
    "verify_dedup_coverage",
    *_CODEC_EXPORTS,
]
