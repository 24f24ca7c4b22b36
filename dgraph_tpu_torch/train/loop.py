"""Full-graph training loop for node-level tasks — counterpart of
``dgraph_tpu/train/loop.py``.

The reference jits one SPMD step (model, loss, backward and gradient psum
under ``shard_map``, then an optax update). Here a step is eager PyTorch on
each rank: the forward on the rank's plan and batch, the loss, ``backward()``
through the port's autograd Functions (whose backward kernels are the CUDA
kernels on a card), the gradients summed over the ranks (``grad_sync``),
then a ``torch.optim`` update of the module's parameters in place. The loss
is normalised by the global mask count, summed over the ranks, as in the
reference (``train/loop.py:64-72``), so the summed gradients are those of
one loss over the whole graph.

Batches are dicts whose leaves lead with the ``[W]`` rank axis, as
``DistributedGraph.batch`` returns them (plus ``"y"``); each rank takes its
row. Ranks come from the model's communicator (``comm``: a ``DistComm`` at
W > 1). On R replica groups of W graph ranks (``comm.dist.launch(...,
num_replicas=R)``) the loss is also divided by R before the backward and
the gradients are summed over all R * W ranks: the DDP mean over the
replicas of each group's summed gradient, as the reference's step does
(``train/loop.py:162-166``, ``:194``, ``:206-211``). With ``per_replica_batch=True`` the leaves lead
with ``[R, W]`` (``train.sampler.ReplicaSampler.stacked``), each replica
group trains on its own sample, and the metrics are the replica means.
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
    "masked_bce_multilabel", "masked_cross_entropy", "model_apply", "vmask_batch_args",
]


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor, count=None) -> torch.Tensor:
    """Sum of per-vertex CE over the mask / mask count (f32). ``count`` is
    the mask count to divide by (the global one across ranks; default this
    rank's)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, labels[:, None].long())[:, 0]
    count = mask.sum() if count is None else count
    return -(ll * mask).sum() / count.clamp_min(1.0)


def masked_bce_multilabel(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean sigmoid BCE for ``[n, C]`` multi-label float targets; ``count``
    as in :func:`masked_cross_entropy` (vertices, not labels)."""
    logits = logits.float()
    labels = labels.float()
    per = logits.clamp_min(0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    count = (mask.sum() if count is None else count) * logits.shape[-1]
    return (per.sum(dim=-1) * mask).sum() / count.clamp_min(1.0)


def _batch_args(b: dict, plan) -> list:
    """Default model arguments: (x, plan, [edge_weight]) — the GCN-family
    signature."""
    args = [b["x"], plan]
    if "edge_weight" in b:
        args.append(b["edge_weight"])
    return args


def vmask_batch_args(b: dict, plan) -> list:
    """(x, plan, vmask) — the GraphTransformer signature: global attention
    needs the vertex padding mask, not edge weights."""
    return [b["x"], plan, b["vmask"]]


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


def _rank_of(plan: EdgePlan, comm) -> tuple:
    """(rank, group) of this process for a plan of ``plan.world_size``
    ranks; raises when the communicator does not match it."""
    group = getattr(comm, "group", None)
    W = plan.world_size
    if W == 1 and group is None:
        return 0, None
    if group is None or group.world_size != W:
        raise ValueError(
            f"a plan of {W} ranks needs a DistComm of {W} ranks (launch the ranks with "
            "dgraph_tpu_torch.comm.dist.launch); got "
            f"{'one rank' if group is None else f'{group.world_size} ranks'}")
    return group.rank, group


def _rank_plan(plan: EdgePlan, rank: int) -> EdgePlan:
    return plan if plan.per_rank else plan.shard(rank)


def _rank_batch(batch: dict, rank: int, world_size: int, replica=None,
                num_replicas: int = 1) -> dict:
    """This rank's leaves: ``v[rank]`` of ``[W, ...]`` leaves, or
    ``v[replica][rank]`` of ``[R, W, ...]`` leaves when ``replica`` is
    given (a per-replica batch)."""
    out = {}
    for k, v in batch.items():
        if replica is not None:
            if v.shape[0] != num_replicas:
                raise ValueError(f"batch[{k!r}] leads with {v.shape[0]} replicas, the run "
                                 f"has {num_replicas}")
            v = v[replica]
        if v.shape[0] != world_size:
            raise ValueError(f"batch[{k!r}] leads with {v.shape[0]} ranks, the plan has "
                             f"{world_size}")
        out[k] = v[rank]
    return out


def _loss(loss_fn, logits, b: dict, group):
    """This rank's share of the global loss: ``loss_fn`` normalised by the
    mask count summed over the ranks (the reference's psum'd count)."""
    if group is None:
        return loss_fn(logits, b["y"], b["mask"])
    from dgraph_tpu_torch.comm.collectives import all_reduce_sum

    return loss_fn(logits, b["y"], b["mask"], count=all_reduce_sum(b["mask"].sum(), group))


def _global_metrics(loss, correct, count, group, replica_mean: bool = False) -> tuple:
    """(loss, accuracy, count): loss, correct and count summed over the
    graph group in one collective, the accuracy their quotient; with
    ``replica_mean`` the three then averaged over the replicas in one
    more (distinct samples a replica group, ``train/loop.py:212-220``)."""
    if group is not None:
        from dgraph_tpu_torch.comm.collectives import all_reduce_sum

        tot = all_reduce_sum(
            torch.stack([loss.detach().float(), correct.float(), count.float()]), group)
        loss, correct, count = tot[0], tot[1], tot[2]
    acc = correct / count.clamp_min(1.0)
    if replica_mean and group is not None and group.num_replicas > 1:
        from dgraph_tpu_torch.comm.collectives import replica_mean as mean

        loss, acc, count = mean(torch.stack([loss, acc, count]), group)
    return loss, acc, count


def _global_norm(params) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    grads = [p.grad for p in params if p.grad is not None]
    return torch.sqrt(sum((g.float() ** 2).sum() for g in grads))


def make_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    plan: EdgePlan,
    *,
    comm=None,
    loss_fn: Callable = masked_cross_entropy,
    per_replica_batch: bool = False,
    batch_args: Optional[Callable] = None,
    step_metrics: bool = False,
    nonfinite_guard: bool = False,
):
    """A train step ``(batch) -> metrics`` that updates ``model`` and
    ``optimizer`` in place. ``plan`` is the stacked plan or this rank's
    view, on the model's device; ``comm`` is the model's communicator
    (None: one rank). Above one rank ``loss_fn`` is called with
    ``count=`` the graph group's mask count, the gradients are summed over
    the ranks before the update, and the metrics are the global ones. On R
    replica groups the loss is divided by R before the backward and the
    gradients are summed over all R * W ranks (the DDP mean).

    ``per_replica_batch=True``: the batch's leaves lead with ``[R, W]`` and
    each replica group trains on its own sample (``train.sampler.
    ReplicaSampler``); loss, accuracy and mask count are the replica means
    of the graph groups' sums. With False every replica takes the same
    ``[W]`` batch, and the gradient is the sum over the replicas / R.

    ``step_metrics=True`` returns a :class:`StepMetrics` (loss, accuracy,
    grad_norm, mask_count) instead of the ``{"loss", "accuracy"}`` dict.
    ``nonfinite_guard=True`` skips the update when the global gradient norm
    is not finite and reports ``nonfinite_skipped`` (0.0/1.0); the decision
    reads the norm on the host, one device sync a step (the reference
    selects inside its traced step instead). Metrics stay device tensors.
    """
    rank, group = _rank_of(plan, comm)
    W = plan.world_size
    R = group.num_replicas if group is not None else 1
    replica = (group.replica if group is not None else 0) if per_replica_batch else None
    plan = _rank_plan(plan, rank)
    check_owner_padding(plan)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch: dict):
        b = _rank_batch(batch, rank, W, replica, R)
        optimizer.zero_grad(set_to_none=True)
        logits = model_apply(model, b, plan, batch_args)
        loss = _loss(loss_fn, logits, b, group)
        (loss / R if R > 1 else loss).backward()
        with torch.no_grad():
            if group is not None:
                from dgraph_tpu_torch.comm.collectives import grad_sync

                grad_sync(params, group, prescaled=True)
            loss, acc, mask_count = _global_metrics(
                loss, _correct(logits, b["y"], b["mask"]), b["mask"].sum(), group,
                replica_mean=per_replica_batch)
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


def make_eval_step(model: torch.nn.Module, plan: EdgePlan, *, comm=None,
                   loss_fn: Callable = masked_cross_entropy,
                   batch_args: Optional[Callable] = None):
    """Eval ``(batch) -> {"loss", "accuracy"}`` without gradients (global
    metrics above one rank)."""
    rank, group = _rank_of(plan, comm)
    W = plan.world_size
    plan = _rank_plan(plan, rank)

    def step(batch: dict) -> dict:
        b = _rank_batch(batch, rank, W)
        with torch.no_grad():
            logits = model_apply(model, b, plan, batch_args)
            loss, acc, _ = _global_metrics(
                _loss(loss_fn, logits, b, group), _correct(logits, b["y"], b["mask"]),
                b["mask"].sum(), group)
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
    comm=None,
):
    """Full-graph training loop (the reference's ``fit``, the
    ``_run_experiment`` loop as a function) on this rank (``comm``, None
    for one rank): seeded initialisation, ``num_epochs`` train steps, an
    eval every ``log_every``.
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
    train_step = make_train_step(model, opt, plan, comm=comm, loss_fn=loss_fn,
                                 batch_args=batch_args, nonfinite_guard=nonfinite_guard)
    eval_step = make_eval_step(model, plan, comm=comm, loss_fn=loss_fn, batch_args=batch_args)
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
