"""Framework flags and the device rule — one place, env-overridable.

Counterpart of ``dgraph_tpu/config.py``. The Pallas kill switches have no
counterpart: on a CUDA tensor a kernel wrapper launches its kernel or
raises, and on a CPU tensor it runs its plain version, so there is nothing
to switch.
"""

from __future__ import annotations

import os

import torch

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
