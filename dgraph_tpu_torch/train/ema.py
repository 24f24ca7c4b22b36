"""Exponential moving average of parameters (Polyak averaging) —
counterpart of ``dgraph_tpu/train/ema.py``.

GraphCast evaluates with EMA weights. The state is a dict of tensors keyed
like the model's parameters (``dict(model.named_parameters())``)::

    ema = ema_init(dict(model.named_parameters()))
    for ...:
        train_step(...)
        ema = ema_update(ema, dict(model.named_parameters()), decay=0.999)
    torch.func.functional_call(model, ema, args)  # evaluate with the EMA
"""

from __future__ import annotations

from typing import Mapping

import torch


def ema_init(params: Mapping[str, torch.Tensor]) -> dict:
    """EMA state: a real copy of the parameters (never aliases them: the
    optimizer updates those in place)."""
    return {k: p.detach().clone() for k, p in params.items()}


def ema_update(ema: Mapping[str, torch.Tensor], params: Mapping[str, torch.Tensor],
               decay: float = 0.999) -> dict:
    """``decay * e + (1 - decay) * p`` for every leaf, the reference's
    expression: two products and a sum, each rounded (no ``lerp`` and no
    fused multiply-add, which round differently)."""
    keys = list(ema)
    with torch.no_grad():
        out = torch._foreach_mul([ema[k] for k in keys], decay)
        torch._foreach_add_(out, torch._foreach_mul([params[k].detach() for k in keys],
                                                    1.0 - decay))
    return dict(zip(keys, out))
