"""``python -m dgraph_tpu_torch.dryrun [N] [--device cpu]`` — the multi-rank
dry run: the counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``
(:63-95) for the model families the port runs over replicas.

One training step a family on N ranks at tiny shapes, over the two axes of
the port's process groups: 'graph' (each rank holds a vertex shard: a halo
exchange a layer, its transpose in the backward) and 'replica' (data
parallelism, each replica group on its own sample, the gradients averaged
over the replicas). N = 2k >= 4 gives R = 2 replica groups of N / 2 ranks
(R = 4 from N = 32 when 4 divides it), as the reference chooses:

- GCN (``_dryrun_gcn``, :98-129): the reference's 64-vertex SBM graph
  partitioned at random for W ranks, hidden 16, 4 classes, Adam at 1e-3,
  every replica group on the same batch;
- GraphCast (``_dryrun_graphcast``, :154-267): the level-1 multimesh on a
  10 x 18 grid, 3 channels, 4 samples, latent 8, one processor layer, Adam
  at 1e-3, each replica group on its sample of
  ``ReplicaSampler(4, R, seed=0).indices(0)``.

Each prints the reference's ``dryrun <family> OK: mesh=(RxW) ... loss=...
param_delta=...`` line after checking that the loss is finite and the
parameters moved. The reference's RGAT, graph-transformer, MoE-LM and
composed-TP families wait for slice 10 of the port; a last line names them.
Runs on the card (a rank a card, or ranks sharing it) unless ``device="cpu"``.
"""

from __future__ import annotations

import importlib
import math
import time
from typing import Optional

# the families of the reference's dry run that wait for slice 10
LATER_FAMILIES = ("RGAT", "GraphTransformer", "MoE-LM", "composed-TP")


def mesh_shape(n_devices: int) -> tuple:
    """``(num_replicas, ranks_per_graph)`` for N ranks, the reference's
    choice (:79-85)."""
    if n_devices >= 32 and n_devices % 4 == 0:
        R = 4
    elif n_devices >= 4 and n_devices % 2 == 0:
        R = 2
    else:
        R = 1
    return R, n_devices // R


def _param_delta(before: dict, model) -> float:
    return float(sum((p.detach().cpu() - before[k]).abs().sum()
                     for k, p in model.named_parameters()))


def _snapshot(model) -> dict:
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters()}


def _dryrun_gcn(group) -> dict:
    """One GCN step on this rank; every replica group on the same batch."""
    import torch

    from dgraph_tpu_torch.comm import DistComm
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.train.loop import make_train_step
    from dgraph_tpu_torch.weights import init_params

    W, dev = group.world_size, group.device
    data = synthetic.sbm_classification_graph(num_nodes=64, num_classes=4, feat_dim=8,
                                              avg_degree=6.0, seed=0)
    g = DistributedGraph.from_global(data["edge_index"], data["features"], data["labels"],
                                     data["masks"], W, partition_method="random",
                                     add_symmetric_norm=True)
    comm = DistComm(group)
    model = init_params(GCN(g.features.shape[-1], 16, 4, comm), seed=0).to(dev)
    before = _snapshot(model)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                           g.plan.to(dev), comm=comm)
    batch = {k: v.to(dev) for k, v in dict(g.batch("train"), y=g.labels).items()}
    t0 = time.perf_counter()
    loss = float(step(batch)["loss"])
    return {"loss": loss, "param_delta": _param_delta(before, model),
            "step_ms": (time.perf_counter() - t0) * 1e3}


def _dryrun_graphcast(group) -> dict:
    """One GraphCast step on this rank, each replica group on its own
    weather sample."""
    import torch

    from dgraph_tpu_torch.comm import DistComm
    from dgraph_tpu_torch.comm import collectives as coll
    from dgraph_tpu_torch.data.weather import SyntheticWeatherDataset
    from dgraph_tpu_torch.models.graphcast import GraphCast, build_graphcast_graphs
    from dgraph_tpu_torch.models.graphcast.graph import rank_inputs
    from dgraph_tpu_torch.train.graphcast import replica_loss_backward
    from dgraph_tpu_torch.train.sampler import ReplicaSampler
    from dgraph_tpu_torch.weights import init_params

    nlat, nlon, ch = 10, 18, 3
    W, dev = group.world_size, group.device
    graphs = build_graphcast_graphs(1, nlat, nlon, W)
    ds = SyntheticWeatherDataset(graphs, nlat, nlon, ch, num_samples=4)
    statics, plans, gmask = rank_inputs(graphs, group.rank, dev)
    comm = DistComm(group)
    model = init_params(GraphCast(latent=8, processor_layers=1, out_channels=ch, comm=comm),
                        seed=0).to(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    opt = torch.optim.Adam(params, lr=1e-3)
    sampler = ReplicaSampler(len(ds), group.num_replicas, seed=0)
    samples = sampler.indices(0)
    x, y = ds.get_sharded(samples[group.replica])
    x = torch.from_numpy(x[group.rank]).to(dev)
    y = torch.from_numpy(y[group.rank]).to(dev)
    before = _snapshot(model)
    t0 = time.perf_counter()
    count = coll.all_reduce_sum(gmask.sum(), group)
    loss = coll.replica_mean(
        replica_loss_backward(model, params, x, y, statics, plans, gmask, count, group), group)
    opt.step()
    return {"loss": float(loss), "param_delta": _param_delta(before, model),
            "step_ms": (time.perf_counter() - t0) * 1e3, "samples": samples}


def _dryrun_rank(group) -> dict:
    return {"gcn": _dryrun_gcn(group), "graphcast": _dryrun_graphcast(group),
            "replica": group.replica, "rank": group.rank}


def _ok_line(name: str, R: int, W: int, res: dict, extra: str = "") -> str:
    loss, delta = res["loss"], res["param_delta"]
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite {name} dryrun loss: {loss}")
    if not delta > 0:
        raise AssertionError(f"{name} step did not update parameters")
    return (f"dryrun {name} OK: mesh=({R}x{W}){extra} loss={loss:.4f} "
            f"param_delta={delta:.3e} step_ms={res['step_ms']:.1f}")


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout: Optional[float] = 600.0) -> list:
    """One training step of GCN and of GraphCast on ``n_devices`` ranks
    (R replica groups of W graph ranks, :func:`mesh_shape`), on the card
    unless ``device="cpu"`` (no card raises before any rank starts).
    Prints and returns the lines: a family's OK line, then the families
    that wait for slice 10. Raises when a loss is not finite, a step moved
    no parameter, or the ranks of one run disagree on the parameters'
    change."""
    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.config import default_device

    dev = default_device(device)
    R, W = mesh_shape(n_devices)
    # by the module's name, not __main__'s: a started rank imports it
    rank_fn = importlib.import_module("dgraph_tpu_torch.dryrun")._dryrun_rank
    ranks = launch(rank_fn, W, num_replicas=R, device=dev.type, timeout=timeout,
                   threads=1 if dev.type == "cpu" else 0)
    lines = []
    for name, key in (("GCN", "gcn"), ("GraphCast", "graphcast")):
        deltas = {r[key]["param_delta"] for r in ranks}
        if len(deltas) != 1:
            raise AssertionError(f"{name}: the ranks' parameters moved apart: {deltas}")
        extra = (f" distinct-replica-samples={ranks[0][key]['samples']}"
                 if key == "graphcast" else "")
        lines.append(_ok_line(name, R, W, ranks[0][key], extra))
    lines.append(f"dryrun families not run here (slice 10 of the port): "
                 f"{', '.join(LATER_FAMILIES)}")
    for line in lines:
        print(line, flush=True)
    return lines


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default=None, help="cpu, or the card by default")
    args = ap.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
