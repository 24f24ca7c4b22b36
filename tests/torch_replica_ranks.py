"""Rank functions of the replica-axis CPU tests (``test_torch_replica.py``,
``test_torch_multihost.py``).

Each runs in a process that ``dgraph_tpu_torch.comm.dist.launch`` (or a
torchrun-style launcher) starts, so this module imports torch and the port
only, never JAX: the test process computes the JAX side and hands the
inputs over as numpy arrays in a pickle. Every function returns numpy
arrays.

:func:`run_cases` runs every case of one launch. On R = 2 replica groups of
W = 2 ranks (``mode="replica"``) replica r takes input r of each case; on
one replica group (``mode="single"``) every input runs in turn, so the test
holds each replica group to an R = 1 run of its own inputs.
"""

from __future__ import annotations

import pickle

import torch
import torch.distributed as dist

from dgraph_tpu_torch import config
from dgraph_tpu_torch.comm import DistComm
from dgraph_tpu_torch.comm import collectives as coll
from dgraph_tpu_torch.data import DistributedGraph
from dgraph_tpu_torch.models import GCN
from dgraph_tpu_torch.plan import build_edge_plan
from dgraph_tpu_torch.train import loop

IMPLS = ("all_to_all", "pallas_p2p", "ppermute", "overlap", "sched")


class _PeerLog:
    """Every ``P2POp`` posted while it is installed, as (op, peer)."""

    def __init__(self):
        self.peers, self.saved = [], None

    def __enter__(self):
        self.saved = dist.P2POp

        def record(op, tensor, peer=None, group=None, tag=0, **kw):
            self.peers.append(("send" if op is dist.isend else "recv", peer))
            return self.saved(op, tensor, peer, group, tag, **kw)

        dist.P2POp = record
        return self

    def __exit__(self, *exc):
        dist.P2POp = self.saved


def _halo_legs(group, case: dict, i: int) -> dict:
    """Every lowering's halo buffer, halo_scatter_sum and both VJPs on this
    rank for input ``i`` of the halo case ('sched' on its own halo-side
    inputs), and the peers its rounds posted."""
    r = group.rank
    plan, _ = build_edge_plan(case["edges"], case["part"], world_size=group.world_size,
                              overlap=True)
    plan = plan.shard(r)
    inp = case["inputs"][i]
    out = {}
    config.use_pallas_p2p = True
    try:
        with _PeerLog() as peers:
            for impl in IMPLS:
                own = "_sched" if impl == "sched" else ""
                x = torch.from_numpy(inp["x"][r]).requires_grad_()
                buf = coll.halo_exchange(x, plan.halo, group, plan.halo_deltas, impl,
                                         plan.halo_schedule)
                (buf * torch.from_numpy(inp["ct_halo" + own][r])).sum().backward()
                h = torch.from_numpy(inp["h" + own][r]).requires_grad_()
                back = coll.halo_scatter_sum(h, plan.halo, plan.n_src_pad, group,
                                             plan.halo_deltas, impl, plan.halo_schedule)
                (back * torch.from_numpy(inp["ct_owner"][r])).sum().backward()
                out[impl] = [a.detach().numpy() for a in (buf, x.grad, back, h.grad)]
    finally:
        config.use_pallas_p2p = None
    out["peers"] = peers.peers
    return out


def _gcn(group, g: dict):
    """A GCN on this rank's communicator with ``g``'s parameters, and its
    graph."""
    comm = DistComm(group)
    graph = DistributedGraph.from_global(g["edges"], g["features"], g["labels"], g["masks"],
                                         group.world_size, partition_method="random",
                                         add_symmetric_norm=True)
    model = GCN(g["features"].shape[1], g["hidden"], g["classes"], comm)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in g["params"].items()})
    return model, graph


def _gcn_step(group, g: dict, batch: dict, per_replica_batch: bool) -> dict:
    """One SGD(1.0) step of the GCN from ``g``'s parameters: the step's
    loss and accuracy and the parameters after it."""
    model, graph = _gcn(group, g)
    step = loop.make_train_step(model, torch.optim.SGD(model.parameters(), lr=1.0),
                                graph.plan, comm=DistComm(group),
                                per_replica_batch=per_replica_batch, step_metrics=True)
    m = step({k: torch.from_numpy(v) for k, v in batch.items()})
    return {"loss": float(m.loss), "accuracy": float(m.accuracy),
            "mask_count": float(m.mask_count),
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def _graphcast_step(group, gc: dict) -> dict:
    """One step of the reference's dry-run GraphCast on this rank: replica
    r on sample ``ReplicaSampler(len(ds), R, seed=0).indices(0)[r]``, the
    masked MSE over the graph group's count divided by R, the gradients
    summed over every rank, SGD at ``gc["lr"]``: the loss, the synced
    gradients and the parameters after the step."""
    from dgraph_tpu_torch.data.weather import SyntheticWeatherDataset
    from dgraph_tpu_torch.models.graphcast import GraphCast, build_graphcast_graphs
    from dgraph_tpu_torch.models.graphcast.graph import rank_inputs
    from dgraph_tpu_torch.train.graphcast import replica_loss_backward
    from dgraph_tpu_torch.train.sampler import ReplicaSampler

    W = group.world_size
    level, nlat, nlon, ch = gc["graph"]
    graphs = build_graphcast_graphs(level, nlat, nlon, W)
    ds = SyntheticWeatherDataset(graphs, nlat, nlon, ch, num_samples=gc["num_samples"])
    statics, plans, gmask = rank_inputs(graphs, group.rank, "cpu")
    model = GraphCast(comm=DistComm(group), **gc["model"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in gc["params"].items()})
    params = list(model.parameters())
    sample = ReplicaSampler(len(ds), group.num_replicas, seed=0).indices(0)[group.replica]
    x, y = ds.get_sharded(sample)
    count = coll.all_reduce_sum(gmask.sum(), group)
    loss = coll.replica_mean(replica_loss_backward(
        model, params, torch.from_numpy(x[group.rank]), torch.from_numpy(y[group.rank]),
        statics, plans, gmask, count, group), group)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    with torch.no_grad():
        torch.optim.SGD(params, lr=gc["lr"]).step()
    return {"loss": float(loss), "sample": sample, "grads": grads,
            "params": {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}}


def run_cases(group, path: str, mode: str) -> dict:
    """Every case of one launch (see the module docstring)."""
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {"replica": group.replica, "rank": group.rank, "global_rank": group.global_rank}
    gcn = inputs["gcn"]
    if mode == "replica":
        out["halo"] = _halo_legs(group, inputs["halo"], group.replica)
        out["gcn_per_replica"] = _gcn_step(group, gcn, gcn["stacked"], True)
        out["gcn_shared"] = _gcn_step(group, gcn, gcn["batches"][0], False)
        out["graphcast"] = _graphcast_step(group, inputs["graphcast"])
        out["replica_mean"] = coll.replica_mean(
            torch.tensor([float(group.global_rank)]), group).numpy()
    else:
        out["halo"] = [_halo_legs(group, inputs["halo"], i)
                       for i in range(len(inputs["halo"]["inputs"]))]
        out["gcn"] = [_gcn_step(group, gcn, b, False) for b in gcn["batches"]]
    return out


def gcn_step_loss(group, path: str) -> float:
    """The loss of one per-replica GCN step (``test_torch_multihost.py``:
    the same step under a torchrun-style launch and under ``launch``)."""
    with open(path, "rb") as f:
        gcn = pickle.load(f)["gcn"]
    return _gcn_step(group, gcn, gcn["stacked"], True)["loss"]
