"""Framework flags and the device rule — one place, env-overridable.

Counterpart of ``dgraph_tpu/config.py``. The Pallas kill switches have no
counterpart: on a CUDA tensor a kernel wrapper launches its kernel or
raises, and on a CPU tensor it runs its plain version, so there is nothing
to switch. The one opt-in flag the reference keeps for a kernel that is off
by default, ``use_pallas_gather`` (the sorted-row-gather kernel), is here
with its name and semantics, and so are the halo-lowering pins
(``halo_impl``, ``use_pallas_p2p``), so one environment drives both
packages, and so is the wire-codec ladder (``wire_format``, read from
``DGRAPH_TPU_WIRE_FORMAT``, and ``tuned_wire_format``, the record tier,
which nothing sets until the tuner is ported). The reference's
adopted-record tier of the lowering (``tuned_halo_impl``) is not here: the
port has no tuner. Interior chunking (``DGRAPH_TPU_OVERLAP_CHUNKS``) is.

By the same rule the reference's ``use_flash_attention`` tri-state
(``DGRAPH_TPU_FLASH_ATTN``) and its ``flash_attention_selfcheck`` latch
(``parallel/sequence.py:313-350``, run by ``long_context_lm.py:79-82``)
have no counterpart: every full-sequence attention on a card runs the flash
kernels, and ``chip_smoke.py`` is their check on the card against the plain
version.
"""

from __future__ import annotations

import os

import torch


def _env_flag(name: str, default=False):
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")

# Compute dtype for model matmuls (params stay float32). Models resolve
# dtype=None through resolve_compute_dtype(), so
# DGRAPH_TPU_COMPUTE_DTYPE=bfloat16 flips every model at once — the same
# variable the JAX package reads.
default_compute_dtype: str = os.environ.get("DGRAPH_TPU_COMPUTE_DTYPE", "float32")

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16, "float16": torch.float16}


def resolve_compute_dtype(dtype):
    """None -> the configured default ('float32' stays None: each op then
    computes in the promoted type of its inputs, as flax's Dense does); an
    explicit dtype wins. Unknown config strings raise (a typo like 'bf61'
    silently running in f32 would misattribute every measurement)."""
    if dtype is not None:
        return dtype
    name = default_compute_dtype
    if name in ("float32", "f32"):
        return None
    if name not in _DTYPES:
        raise ValueError(
            f"DGRAPH_TPU_COMPUTE_DTYPE={name!r} not understood; expected "
            "float32, bfloat16, or float16"
        )
    return _DTYPES[name]


# Feature-chunk width of the edge pipeline (comm.collectives.map_feature_chunks):
# every per-edge intermediate is at most this many columns wide. 0 disables
# chunking.
gather_col_block: int = int(os.environ.get("DGRAPH_TPU_GATHER_COL_BLOCK", "128"))


# The sorted-row-gather kernel (ops.segment.sorted_row_gather) for the row
# takes by sorted owner ids: owner-side take_rows and the backward's
# cotangent and bias-row takes. Tri-state as in the reference, whose auto
# state is OFF: it engages only on an explicit DGRAPH_TPU_PALLAS_GATHER=1
# (or by setting this attribute to True). Off, those takes are index_select.
use_pallas_gather = _env_flag("DGRAPH_TPU_PALLAS_GATHER", None)


def pallas_gather_enabled() -> bool:
    return use_pallas_gather is True


# Halo-exchange lowering, the reference's names and env pin: 'auto' (one
# padded all_to_all; the split lowering 'overlap' when the plan carries its
# interior/boundary split), 'all_to_all', 'ppermute' (one round a live rank
# offset), 'overlap' (those rounds over the interior/boundary split, the
# interior sums queued while they fly), 'pallas_p2p' (the one-sided put
# kernel; needs the split and pallas_p2p_available()) or 'sched' (the
# plan's compiled halo schedule, replayed round by round; runs when the plan
# carries a schedule, as every plan with cross-rank traffic does).
# Resolution order: this pin > the heuristic (plan.resolve_halo_impl); the
# heuristic never picks 'pallas_p2p' or 'sched'. A pin the plan cannot lower
# warns and the heuristic decides.
halo_impl: str = os.environ.get("DGRAPH_TPU_HALO_IMPL", "auto")

# Edge-axis chunk count of the split lowerings' interior sum
# (comm.collectives.interior_chunks): 1 = one sorted segment sum (the
# default: the bits of the serial path); > 1 splits it so the pieces can
# interleave with the rounds in flight (capped at the live-delta count;
# the partial sums regroup the float adds).
overlap_interior_chunks: int = int(os.environ.get("DGRAPH_TPU_OVERLAP_CHUNKS", "1"))

# The one-sided transport kernel (ops.p2p). Tri-state as in the reference:
# None = available where the rank's device is CUDA; True also on the CPU
# (the transport's plain version, an all_to_all: how the CPU tests run the
# route); False vetoes it everywhere.
use_pallas_p2p = _env_flag("DGRAPH_TPU_PALLAS_P2P", None)


def pallas_p2p_available(device=None) -> bool:
    """Can halo_impl='pallas_p2p' lower for a rank on ``device`` (default:
    this process's card, if any)? One of resolve_halo_impl's two gates; the
    other is the plan carrying the interior/boundary split."""
    if use_pallas_p2p is not None:
        return use_pallas_p2p
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# Wire codec for halo payloads (dgraph_tpu_torch.wire): 'auto' (defer to the
# adopted tuning record, then the plan-attached format, then the fp32
# identity — a lossy codec never engages on its own), or an explicit
# 'fp32' / 'bf16' / 'fp8' pin. Resolution order lives in
# wire.spec.resolve_wire_format: this pin > tuned_wire_format (below) >
# EdgePlan.wire_format > 'fp32'; a pinned format whose preconditions fail
# (fp8 without torch.float8_e4m3fn, an unknown name) degrades with one
# warning to the next tier.
wire_format: str = os.environ.get("DGRAPH_TPU_WIRE_FORMAT", "auto")

# Wire format chosen by an adopted tuning record, consulted AFTER the pin.
# None: no record adopted (the port has no tuner yet, so nothing sets it).
tuned_wire_format: "str | None" = None


def set_flags(**kw) -> None:
    """Set module flags by name (the reference's ``config.set_flags``); an
    unknown name raises."""
    g = globals()
    for k, v in kw.items():
        if k not in g:
            raise KeyError(f"unknown dgraph_tpu_torch.config flag: {k}")
        g[k] = v


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else ``cuda``. Raises when no card is present and the caller did
    not ask for the CPU — an entry point never quietly carries on there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return torch.device("cuda")
