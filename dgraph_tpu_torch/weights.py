"""Parameters: flax trees to ``state_dict``s, and seeded initialisation.

Module names follow flax's auto-names (``GraphConvLayer_0/src_proj``,
``SAGEConv_1/Dense_0``, ``Dense_0``), so a flax path maps to a state_dict key
by joining with dots. A flax ``Dense.kernel`` is ``[in, out]``; a torch
``Linear.weight`` is ``[out, in]``.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
from torch import nn


def params_from_jax(tree: Mapping) -> dict:
    """Flax parameter tree (nested dicts of numpy-convertible arrays; the
    ``{'params': ...}`` variables wrapper is accepted) -> ``state_dict``."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}

    def walk(node, prefix):
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, prefix + (name,))
                continue
            arr = np.asarray(val, dtype=np.float32)
            if name == "kernel":
                key, arr = "weight", arr.T
            elif name == "bias":
                key = "bias"
            else:
                raise KeyError(f"unknown flax leaf {'/'.join(prefix + (name,))}")
            out[".".join(prefix + (key,))] = torch.tensor(arr)

    walk(tree, ())
    return out


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation with flax ``Dense``'s defaults: kernels from a
    truncated normal of variance 1/fan_in (lecun_normal), biases zero. The
    generator is explicit, so one seed gives one model on any device
    (torch and JAX draw different numbers from the same seed; tests carry
    flax weights across with :func:`params_from_jax` instead)."""
    g = torch.Generator().manual_seed(seed)
    # stddev of a unit normal truncated to [-2, 2], as flax's initializer corrects for
    trunc_std = 0.87962566103423978
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            if name.endswith("weight") and p.dim() == 2:
                std = math.sqrt(1.0 / p.shape[1]) / trunc_std
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
                p.copy_(w)
            elif name.endswith("bias"):
                p.zero_()
    return module
