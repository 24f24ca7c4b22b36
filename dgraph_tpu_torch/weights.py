"""Parameters: flax trees to ``state_dict``s, and seeded initialisation.

Module names follow flax's (auto-names like ``GraphConvLayer_0/src_proj``,
``SAGEConv_1/Dense_0``, ``Dense_0``, or explicit ones like ``block_0/qkv``),
so a flax path maps to a state_dict key by joining with dots. The leaves:

- ``Dense.kernel`` ``[in, out]`` <-> ``Linear.weight`` ``[out, in]``
  (transposed; GAT's residual ``GATConv_{i}/res/kernel`` <->
  ``GATConv_{i}.res.weight`` among them);
- ``LayerNorm.scale`` <-> ``LayerNorm.weight``, ``Embed.embedding``
  ``[num, features]`` <-> ``Embedding.weight``, both as they are;
- ``bias`` <-> ``bias``;
- the raw ``self.param`` leaves of ``RAW_LEAVES`` (GAT's ``att_src``,
  ``att_dst``) <-> the ``nn.Parameter`` of that name, as it is.

Any other leaf raises ``KeyError``, both ways.

:func:`adamw_state_from_optax` carries the reference's ``optax.adamw``
state (a checkpoint's ``opt_state``, as numpy leaves) into the
``state_dict()``s of a ``torch.optim.AdamW`` and its ``LambdaLR``, so the
port can resume from a reference checkpoint.
"""

from __future__ import annotations

import copy
import math
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

# flax leaf name -> (torch leaf name, transposed)
_FROM_FLAX = {"kernel": ("weight", True), "scale": ("weight", False),
              "embedding": ("weight", False), "bias": ("bias", False)}
# raw ``self.param`` leaves: carried under their own names, untransposed
RAW_LEAVES = frozenset({"att_src", "att_dst"})


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
            if name in RAW_LEAVES:
                key, transposed = name, False
            elif name in _FROM_FLAX:
                key, transposed = _FROM_FLAX[name]
            else:
                raise KeyError(f"unknown flax leaf {'/'.join(prefix + (name,))}")
            arr = np.asarray(val, dtype=np.float32)
            out[".".join(prefix + (key,))] = torch.tensor(arr.T if transposed else arr)

    walk(tree, ())
    return out


def adamw_state_from_optax(opt_state, model: nn.Module, optimizer: torch.optim.Optimizer,
                           scheduler=None) -> dict:
    """The reference's ``optax.adamw(schedule)`` state -> ``{"opt_state":
    ..., "sched": ...}``, the ``state_dict()``s that ``optimizer`` (an
    ``AdamW`` over ``model``'s parameters) and ``scheduler`` (its
    ``LambdaLR``, or None) load. ``opt_state`` is the optax chain's state as
    a checkpoint hands it back: a sequence of ``ScaleByAdamState`` (or the
    dict ``{'count', 'mu', 'nu'}`` of a raw restore), the weight decay's
    empty state and ``ScaleByScheduleState`` (``{'count'}``), leaves
    numpy-convertible. ``mu`` and ``nu`` become each parameter's
    ``exp_avg`` and ``exp_avg_sq`` (through :func:`params_from_jax`, in
    the optimizer's parameter order), the Adam ``count`` its ``step``, and
    the schedule's ``count`` the scheduler's ``last_epoch`` (each group's
    ``lr`` the schedule's value there, as ``LambdaLR`` sets it)."""
    adam, sched_count = None, None
    for part in opt_state:
        d = part._asdict() if hasattr(part, "_asdict") else part
        if isinstance(d, Mapping) and "mu" in d:
            adam = d
        elif isinstance(d, Mapping) and "count" in d:
            sched_count = int(np.asarray(d["count"]))
    if adam is None:
        raise KeyError("no Adam state (count, mu, nu) in the optax state")
    count = int(np.asarray(adam["count"]))
    mu, nu = params_from_jax(adam["mu"]), params_from_jax(adam["nu"])
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    step = torch.tensor(float(count), dtype=torch.get_default_dtype())
    sd = optimizer.state_dict()
    state = {i: {"step": step.clone(), "exp_avg": mu[names[id(p)]],
                 "exp_avg_sq": nu[names[id(p)]]} for i, p in enumerate(params)}
    groups = copy.deepcopy(sd["param_groups"])
    out = {"opt_state": {"state": state, "param_groups": groups}, "sched": None}
    if scheduler is not None:
        epoch = count if sched_count is None else sched_count
        lrs = [base * lam(epoch) for base, lam in zip(scheduler.base_lrs, scheduler.lr_lambdas)]
        for g, lr in zip(groups, lrs):
            g["lr"] = lr
        out["sched"] = dict(scheduler.state_dict(), last_epoch=epoch, _step_count=epoch + 1,
                            _last_lr=lrs)
    return out


def param_kinds(module: nn.Module) -> dict:
    """{state_dict key: flax leaf name} of ``module``'s parameters: each
    ``weight`` named by the kind of module that holds it; a raw leaf
    (``RAW_LEAVES``) by its own name."""
    kinds = {}
    for mname, mod in module.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if pname in ("bias", *RAW_LEAVES):
                kinds[key] = pname
            elif isinstance(mod, nn.Embedding):
                kinds[key] = "embedding"
            elif isinstance(mod, nn.LayerNorm):
                kinds[key] = "scale"
            else:
                kinds[key] = "kernel" if p.dim() == 2 else "scale"
    return kinds


def params_to_jax(state_dict: Mapping, module: Optional[nn.Module] = None) -> dict:
    """``state_dict`` -> flax variables ``{'params': tree}`` of float32
    numpy arrays: the inverse of :func:`params_from_jax`. A ``weight`` leaf
    alone does not say what it was: with ``module`` each key takes the kind
    of the module holding it (:func:`param_kinds`); without, a 2-D weight is
    a Dense kernel and a 1-D one a LayerNorm scale (an Embedding needs the
    module). A raw leaf (``RAW_LEAVES``) keeps its name and layout; any
    other leaf raises ``KeyError``."""
    kinds = param_kinds(module) if module is not None else {}
    tree: dict = {}
    for key, val in state_dict.items():
        *path, leaf = key.split(".")
        arr = val.detach().cpu().numpy().astype(np.float32)
        if leaf == "weight":
            leaf = kinds.get(key, "kernel" if arr.ndim == 2 else "scale")
            if leaf == "kernel":
                arr = arr.T
        elif leaf != "bias" and leaf not in RAW_LEAVES:
            raise KeyError(f"unknown state_dict leaf {key}")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def init_params(module: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded initialisation with flax's defaults: Dense kernels from a
    truncated normal of variance 1/fan_in (lecun_normal), Embed tables from a
    normal of variance 1/features (``variance_scaling(1, 'fan_in', 'normal',
    out_axis=0)``), LayerNorm scales one, biases zero, and the raw
    leaves (GAT's ``[H, D]`` ``att_src`` and ``att_dst``) from flax's
    ``glorot_uniform``, uniform in ``±sqrt(6 / (H + D))``. The generator is
    explicit, so one seed gives one model on any device (torch and JAX draw
    different numbers from the same seed; tests carry flax weights across
    with :func:`params_from_jax` instead)."""
    g = torch.Generator().manual_seed(seed)
    # stddev of a unit normal truncated to [-2, 2], as flax's initializer corrects for
    trunc_std = 0.87962566103423978
    kinds = param_kinds(module)
    with torch.no_grad():
        for name, p in sorted(module.named_parameters()):
            kind = kinds[name]
            if kind == "kernel":
                std = math.sqrt(1.0 / p.shape[1]) / trunc_std
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
                p.copy_(w)
            elif kind == "embedding":
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.normal_(w, std=math.sqrt(1.0 / p.shape[1]), generator=g)
                p.copy_(w)
            elif kind == "scale":
                p.fill_(1.0)
            elif kind == "bias":
                p.zero_()
            elif kind in RAW_LEAVES:
                limit = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                w = torch.empty(p.shape, dtype=torch.float32)
                nn.init.uniform_(w, -limit, limit, generator=g)
                p.copy_(w)
    return module
