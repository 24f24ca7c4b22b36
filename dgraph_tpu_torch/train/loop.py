"""Full-graph training loop for node-level tasks — counterpart of
``dgraph_tpu/train/loop.py`` at world size 1.

The reference jits one SPMD step (model, loss, backward and gradient psum
under ``shard_map``, then an optax update). Here a step is eager PyTorch on
one rank: the forward, the loss, ``backward()`` through the port's autograd
Functions (whose backward kernels are the CUDA kernels on a card), then a
``torch.optim`` update of the module's parameters in place. The loss is
normalised by the global mask count, as in the reference
(``train/loop.py:64-72``).

Batches are dicts whose leaves lead with the ``[W]`` rank axis, as
``DistributedGraph.batch`` returns them (plus ``"y"``); the parameters live
in the module. ``per_replica_batch`` and world sizes above 1 belong to
the multi-rank slice of the port and raise here.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from dgraph_tpu_torch.config import default_device
from dgraph_tpu_torch.obs.metrics import StepMetrics
from dgraph_tpu_torch.plan import EdgePlan, check_owner_padding
from dgraph_tpu_torch.weights import init_params

__all__ = [
    "fit", "init_params", "make_eval_step", "make_train_step",
    "masked_bce_multilabel", "masked_cross_entropy", "model_apply",
]

_MULTI_RANK = "the multi-rank slice of the port"


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Sum of per-vertex CE over the mask / mask count (f32)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels[:, None].long())[:, 0]
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def masked_bce_multilabel(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid BCE for ``[n, C]`` multi-label float targets."""
    logits = logits.float()
    labels = labels.float()
    per = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    count = mask.sum() * logits.shape[-1]
    return (per.sum(dim=-1) * mask).sum() / count.clamp_min(1.0)


def _batch_args(b: dict, plan) -> list:
    """Default model arguments: (x, plan, [edge_weight]) — the GCN-family
    signature."""
    args = [b["x"], plan]
    if "edge_weight" in b:
        args.append(b["edge_weight"])
    return args


def model_apply(model, b: dict, plan, batch_args: Optional[Callable] = None):
    """THE per-rank forward call of train, eval and serve: which batch keys
    feed which model arguments cannot drift between the three."""
    return model(*(batch_args or _batch_args)(b, plan))


def _correct(logits, y, mask):
    if y.dim() == logits.dim():
        # multi-label float targets: per-label binary accuracy
        hits = ((logits > 0) == (y > 0.5)).float().mean(dim=-1)
        return (hits * mask).sum()
    return ((logits.argmax(dim=-1) == y.long()).float() * mask).sum()


def _rank_plan(plan: EdgePlan) -> EdgePlan:
    """The one rank's plan view; raises above world size 1."""
    if plan.world_size != 1:
        raise NotImplementedError(
            f"world size {plan.world_size}: training above one rank is {_MULTI_RANK}")
    return plan if plan.per_rank else plan.shard(0)


def _rank_batch(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        if v.shape[0] != 1:
            raise NotImplementedError(
                f"batch[{k!r}] has {v.shape[0]} ranks: training above one rank is {_MULTI_RANK}")
        out[k] = v[0]
    return out


def _global_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    plan: EdgePlan,
    *,
    loss_fn: Callable = masked_cross_entropy,
    per_replica_batch: bool = False,
    batch_args: Optional[Callable] = None,
    step_metrics: bool = False,
    nonfinite_guard: bool = False,
):
    """A train step ``(batch) -> metrics`` that updates ``model`` and
    ``optimizer`` in place. ``plan`` is the stacked plan (world size 1) or
    its per-rank view, on the model's device.

    ``step_metrics=True`` returns a :class:`StepMetrics` (loss, accuracy,
    grad_norm, mask_count) instead of the ``{"loss", "accuracy"}`` dict.
    ``nonfinite_guard=True`` skips the update when the global gradient norm
    is not finite and reports ``nonfinite_skipped`` (0.0/1.0); the decision
    reads the norm on the host, one device sync a step (the reference
    selects inside its traced step instead). Metrics stay device tensors.
    """
    if per_replica_batch:
        raise NotImplementedError(f"per_replica_batch is {_MULTI_RANK}")
    plan = _rank_plan(plan)
    check_owner_padding(plan)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict):
        b = _rank_batch(batch)
        optimizer.zero_grad(set_to_none=True)
        logits = model_apply(model, b, plan, batch_args)
        loss = loss_fn(logits, b["y"], b["mask"])
        loss.backward()
        with torch.no_grad():
            mask_count = b["mask"].sum()
            acc = _correct(logits, b["y"], b["mask"]) / mask_count.clamp_min(1.0)
            gnorm = _global_norm(params) if (step_metrics or nonfinite_guard) else None
            skipped = None
            if nonfinite_guard:
                ok = bool(torch.isfinite(gnorm))
                if ok:
                    optimizer.step()
                skipped = loss.new_tensor(0.0 if ok else 1.0)
            else:
                optimizer.step()
        loss = loss.detach()
        if step_metrics:
            return StepMetrics(loss=loss, accuracy=acc, grad_norm=gnorm,
                               mask_count=mask_count, nonfinite_skipped=skipped)
        out = {"loss": loss, "accuracy": acc}
        if nonfinite_guard:
            out["nonfinite_skipped"] = skipped
        return out

    return step


def make_eval_step(model: torch.nn.Module, plan: EdgePlan, *,
                   loss_fn: Callable = masked_cross_entropy,
                   batch_args: Optional[Callable] = None):
    """Eval ``(batch) -> {"loss", "accuracy"}`` without gradients."""
    plan = _rank_plan(plan)

    def step(batch: dict) -> dict:
        b = _rank_batch(batch)
        with torch.no_grad():
            logits = model_apply(model, b, plan, batch_args)
            loss = loss_fn(logits, b["y"], b["mask"])
            acc = _correct(logits, b["y"], b["mask"]) / b["mask"].sum().clamp_min(1.0)
        return {"loss": loss, "accuracy": acc}

    return step


def _adam_1e2(params):
    return torch.optim.Adam(params, lr=1e-2)


def fit(
    model: torch.nn.Module,
    graph,
    *,
    optimizer: Optional[Callable] = None,
    num_epochs: int = 50,
    seed: int = 0,
    log_every: int = 0,
    loss_fn: Callable = masked_cross_entropy,
    batch_args: Optional[Callable] = None,
    nonfinite_guard: bool = False,
    device=None,
):
    """Full-graph training loop (the reference's ``fit``, the
    ``_run_experiment`` loop as a function) at world size 1: seeded
    initialisation, ``num_epochs`` train steps, an eval every ``log_every``.
    ``optimizer`` builds the optimizer from the parameters (default Adam at
    1e-2, optax.adam(1e-2)'s settings); the model runs on ``device``
    (default ``cuda``; raises with no card). Returns (model, history).
    The reference's chaos hook comes with the resilience slice."""
    dev = default_device(device)
    init_params(model, seed).to(dev)
    opt = (optimizer or _adam_1e2)(model.parameters())

    def batch(split):
        b = dict(graph.batch(split), y=graph.labels, vmask=graph.vertex_mask)
        return {k: v.to(dev) for k, v in b.items()}

    batch_tr, batch_va = batch("train"), batch("val")
    plan = graph.plan.to(dev)
    train_step = make_train_step(model, opt, plan, loss_fn=loss_fn,
                                 batch_args=batch_args, nonfinite_guard=nonfinite_guard)
    eval_step = make_eval_step(model, plan, loss_fn=loss_fn, batch_args=batch_args)
    history = []
    for epoch in range(num_epochs):
        m = train_step(batch_tr)
        rec = {"epoch": epoch, "loss": float(m["loss"]), "acc": float(m["accuracy"])}
        if log_every and epoch % log_every == 0:
            ev = eval_step(batch_va)
            rec["val_loss"] = float(ev["loss"])
            rec["val_acc"] = float(ev["accuracy"])
            print(rec)
        history.append(rec)
    return model, history
