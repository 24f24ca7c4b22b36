"""``python -m dgraph_tpu_torch.train`` — full-graph node classification.

Counterpart of ``experiments/ogb_gcn.py`` (``main``, :117-227): trains GCN
(symmetric-norm edge weights), GraphSAGE, GAT (4 heads) or the graph
transformer (``--model gt``: local message passing plus attention over the
whole vertex set, 4 heads) on a synthetic SBM graph, on an ``.npz`` with
edge_index/features/labels/<split>_mask (``--data.path``), or on an OGB
node-prediction dataset (``--data.ogb_name``: its raw download layout under
``--data.root``, or with ``--data.path`` an ``ogbn.export_npz`` file or
memmap directory), with Adam at ``--lr``, over ``--world_size`` ranks. Writes one ``step_record`` JSON
line per step (an eval every 10 steps and at the last), the test accuracy,
and a final ``avg_epoch_ms_excl_first`` line, to stdout and appended to
``--log_path`` (rank 0 only). Runs on ``cuda`` unless ``--device cpu``;
with no card it raises.

    python -m dgraph_tpu_torch.train --model gcn --epochs 100
    python -m dgraph_tpu_torch.train --device cpu --epochs 3 --data.num_nodes 500
    python -m dgraph_tpu_torch.train --device cpu --model gt --epochs 2 --data.num_nodes 500
    DGRAPH_TPU_HALO_IMPL=pallas_p2p python -m dgraph_tpu_torch.train --world_size 4
    DGRAPH_TPU_HALO_IMPL=sched python -m dgraph_tpu_torch.train --world_size 4
    python -m dgraph_tpu_torch.train --device cpu --world_size 2 --epochs 2
    python -m dgraph_tpu_torch.train --data.ogb_name ogbn-arxiv --data.root dataset

``--world_size 0`` means every visible card (one rank with ``--device
cpu``), as the reference's 0 means every device. Above one rank the run
spawns one process a rank (``comm.dist.launch``;
under ``torchrun`` it joins that group instead): ranks on cards of their
own talk over NCCL, ranks that share a card (or run on the CPU) over gloo.
Every rank builds the same graph from the same seed and trains its shard;
gradients are summed over the ranks (``DGRAPH_TPU_HALO_IMPL`` pins the halo
lowering: all_to_all, ppermute, overlap, pallas_p2p or sched). The graph
transformer trains on one rank only (more raise before any work). The default partition is
``multilevel``, as the reference's: the native host library
(``dgraph_tpu_torch.native``, built with ``g++`` at first use) partitions,
and where it cannot build the run falls back to greedy BFS with a warning.
``--data.ogb_name`` never downloads: with no raw layout under
``--data.root`` it raises. Not ported yet: the reference's start-up,
plan-footprint and timing records.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import types
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    path: Optional[str] = None  # npz with edge_index [2,E], features, labels, masks
    ogb_name: Optional[str] = None  # e.g. 'ogbn-arxiv': the raw layout under root,
    # or with path an ogbn.export_npz() file / memmap directory
    root: str = "dataset"  # where raw downloads live
    num_nodes: int = 5000  # synthetic SBM size when path is None
    num_classes: int = 8
    feat_dim: int = 64
    avg_degree: float = 10.0
    partition: str = "multilevel"  # any of partition.METHODS


@dataclasses.dataclass
class Config:
    """Full-graph GCN / GraphSAGE / GAT / graph transformer training, one card
    (or CPU process) a rank."""

    model: str = "gcn"  # gcn | sage | gat | gt (alias graph_transformer)
    hidden: int = 128
    num_layers: int = 2
    lr: float = 5e-3
    epochs: int = 100
    world_size: int = 1  # ranks; 0 = every visible card (1 with --device cpu); > 1 spawns
    log_path: str = "logs/ogb_gcn_torch.jsonl"
    step_metrics: bool = False  # grad norm and mask count in each record
    device: str = ""  # "" = cuda (raises with no card); "cpu" for the plain path
    data: DataConfig = dataclasses.field(default_factory=DataConfig)


def _num_classes(labels: np.ndarray) -> int:
    # multi-label float targets ([V, C]): C is the width
    if labels.ndim > 1:
        return int(labels.shape[1])
    return int(labels.max()) + 1


def _normalize_split_names(masks: dict) -> dict:
    """OGB says "valid"; the training loop's split name is "val"
    (``DistributedGraph.batch`` falls back to every vertex on an unknown
    split)."""
    if "valid" in masks and "val" not in masks:
        masks["val"] = masks.pop("valid")
    return masks


def load_data(cfg: DataConfig) -> dict:
    """The graph to train on: an OGB dataset (``cfg.ogb_name``: the export at
    ``cfg.path``, else the raw layout under ``cfg.root``), the npz at
    ``cfg.path``, or a synthetic SBM."""
    if cfg.ogb_name:
        from dgraph_tpu_torch.data import ogbn

        arrs = (ogbn.from_npz(cfg.path) if cfg.path
                else ogbn.load_ogb_arrays(cfg.ogb_name, root=cfg.root))
        labels = np.asarray(arrs["labels"])
        masks = {k.removesuffix("_mask"): np.asarray(v) for k, v in arrs.items()
                 if k.endswith("_mask")}
        return {
            "edge_index": np.asarray(arrs["edge_index"]), "features": np.asarray(arrs["features"]),
            "labels": labels, "masks": _normalize_split_names(masks),
            "num_classes": _num_classes(labels),
        }
    if cfg.path:
        z = np.load(cfg.path)
        masks = _normalize_split_names(
            {k.removesuffix("_mask"): z[k] for k in z.files if k.endswith("_mask")})
        return {
            "edge_index": z["edge_index"], "features": z["features"],
            "labels": z["labels"], "masks": masks,
            "num_classes": _num_classes(np.asarray(z["labels"])),
        }
    from dgraph_tpu_torch.data import synthetic

    return synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes,
        feat_dim=cfg.feat_dim, avg_degree=cfg.avg_degree,
    )


# models that train on one rank only, with the port's slice that brings
# them over ranks (ROADMAP Queue A)
ONE_RANK_MODELS = {
    "gt": "sequence attention over ranks (slice 10)",
    "graph_transformer": "sequence attention over ranks (slice 10)",
}


def check_model(model: str, world_size: int) -> None:
    """Raise before any work for a model this CLI cannot train at
    ``world_size`` ranks."""
    if model not in ("gcn", "sage", "gat", *ONE_RANK_MODELS):
        raise SystemExit(f"unknown model {model}")
    if world_size > 1 and model in ONE_RANK_MODELS:
        raise NotImplementedError(
            f"--model {model} trains on one rank; above one rank it comes with "
            f"{ONE_RANK_MODELS[model]} of the port")


def build_training(cfg: Config, device=None, comm=None) -> types.SimpleNamespace:
    """Graph, seeded model, Adam and the train/eval steps of one rank (``comm``,
    None for one rank), on ``device`` (default the rank's device, else
    ``cfg.device``, else ``cuda``; raises with no card before any work).
    ``graph`` (every rank's shard) stays on the CPU; ``batches`` and
    ``plan`` (this rank's view) are on the device."""
    import torch

    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.models import GAT, GCN, GraphSAGE, GraphTransformer
    from dgraph_tpu_torch.train.loop import (
        init_params, make_eval_step, make_train_step, masked_bce_multilabel,
        masked_cross_entropy, vmask_batch_args,
    )

    comm = comm or SingleComm()
    if device is None and comm.group is not None:
        device = comm.group.device
    dev = default_device(device if device is not None else (cfg.device or None))
    W, rank = comm.get_world_size(), comm.get_rank()
    if resolve_world_size(cfg.world_size, cfg.device) != W:
        raise ValueError(f"world_size={cfg.world_size} but the communicator has {W} ranks; "
                         "main() launches the ranks")
    check_model(cfg.model, W)
    data = load_data(cfg.data)
    graph = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"],
        world_size=W, partition_method=cfg.data.partition,
        add_symmetric_norm=cfg.model == "gcn",
    )
    F, C = graph.features.shape[-1], data["num_classes"]
    if cfg.model == "gcn":
        model = GCN(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    elif cfg.model == "sage":
        model = GraphSAGE(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    elif cfg.model == "gat":
        model = GAT(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    else:
        model = GraphTransformer(F, cfg.hidden, C, comm, num_layers=cfg.num_layers,
                                 num_heads=4)
    bargs = vmask_batch_args if cfg.model in ("gt", "graph_transformer") else None
    init_params(model, seed=0).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    loss_fn = (masked_bce_multilabel if graph.labels.dim() > 2 else masked_cross_entropy)
    plan = graph.plan.shard(rank).to(dev)

    def batch(split):
        b = dict(graph.batch(split), y=graph.labels, vmask=graph.vertex_mask)
        return {k: v.to(dev) for k, v in b.items()}

    splits = ["train", "val"] + (["test"] if "test" in graph.masks else [])
    return types.SimpleNamespace(
        device=dev, graph=graph, model=model, optimizer=optimizer, plan=plan, comm=comm,
        rank=rank, loss_fn=loss_fn, batches={s: batch(s) for s in splits},
        train_step=make_train_step(model, optimizer, plan, comm=comm, loss_fn=loss_fn,
                                   batch_args=bargs, step_metrics=cfg.step_metrics),
        eval_step=make_eval_step(model, plan, comm=comm, loss_fn=loss_fn, batch_args=bargs),
    )


class _Log:
    """JSON lines to stdout and appended to ``path`` (none when empty)."""

    def __init__(self, path: str):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def write(self, rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


def _train(cfg: Config, on_step: Optional[Callable], comm=None) -> dict:
    """One rank's run: ``cfg.epochs`` train steps, the evals and the log
    (rank 0 writes it). ``on_step(epoch, training)`` runs after each step
    (the step's gradients are still on the parameters); its return values
    come back in ``"on_step"``."""
    import torch

    from dgraph_tpu_torch.obs.metrics import step_record

    t = build_training(cfg, comm=comm)
    log = _Log(cfg.log_path) if t.rank == 0 else None
    records, epoch_times, probes = [], [], []

    def sync():
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def write(rec):
        if log is not None:
            log.write(rec)

    for epoch in range(cfg.epochs):
        sync()
        t0 = time.perf_counter()
        m = t.train_step(t.batches["train"])
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        epoch_times.append(dt)
        rec = step_record(m, step=epoch, wall_ms=dt)
        rec["epoch"] = epoch  # legacy key, kept for plot scripts
        if epoch % 10 == 0 or epoch == cfg.epochs - 1:
            ev = t.eval_step(t.batches["val"])
            rec["val_acc"] = float(ev["accuracy"])
            rec["val_loss"] = float(ev["loss"])
        write(rec)
        records.append(rec)
        if on_step is not None:
            probes.append(on_step(epoch, t))
    if "test" in t.batches:
        te = t.eval_step(t.batches["test"])
        write({"test_acc": float(te["accuracy"]), "test_loss": float(te["loss"])})
    # the mean excludes the first step, the reference's convention
    avg = round(float(np.mean(epoch_times[1:])), 2) if len(epoch_times) > 1 else None
    write({"avg_epoch_ms_excl_first": avg})
    return {"records": records, "avg_epoch_ms_excl_first": avg, "on_step": probes,
            "training": t}


def _train_rank(group, cfg: dict, on_step: Optional[Callable]) -> dict:
    """A spawned rank: train on its shard (``cfg`` as a dict: the parent's
    Config class may live in its ``__main__``) and hand back what pickles."""
    from dgraph_tpu_torch.comm import DistComm

    cfg = Config(**dict(cfg, data=DataConfig(**cfg["data"])))
    out = _train(cfg, on_step, comm=DistComm(group))
    out.pop("training")
    return out


def resolve_world_size(world_size: int, device: str = "") -> int:
    """The ranks a run has: ``world_size`` when positive; 0 means every
    visible card (``torch.cuda.device_count()``), as the reference's 0 means
    every device (``experiments/ogb_gcn.py:137``), and one rank with
    ``--device cpu``."""
    import torch

    if world_size > 0:
        return world_size
    if (device or "cuda") == "cpu":
        return 1
    return max(torch.cuda.device_count(), 1)


def main(cfg: Config, *, on_step: Optional[Callable] = None) -> dict:
    """Train ``cfg.epochs`` steps on ``cfg.world_size`` ranks. Returns
    {"records", "avg_epoch_ms_excl_first", "on_step", "training"} (rank 0's;
    ``training`` is None above one rank) and ``"ranks"``, every rank's
    result. Above one rank ``on_step`` runs in each rank's process, so it
    must pickle (a module-level function or an instance of a module-level
    class)."""
    import importlib

    from dgraph_tpu_torch.comm.dist import launch

    W = resolve_world_size(cfg.world_size, cfg.device)
    check_model(cfg.model, W)
    if W == 1 and "WORLD_SIZE" not in os.environ:
        out = _train(cfg, on_step)
        return dict(out, ranks=[out])
    device = cfg.device or "cuda"
    if device == "cuda":
        from dgraph_tpu_torch.config import default_device

        default_device()  # raises with no card, before any rank starts
    # by its module's name, not __main__'s: a spawned rank imports it
    rank_fn = importlib.import_module("dgraph_tpu_torch.train.__main__")._train_rank
    ranks = launch(rank_fn, W, dataclasses.asdict(cfg), on_step, device=device,
                   threads=max(1, (os.cpu_count() or 1) // W) if device == "cpu" else 0)
    return dict(ranks[0], training=None, ranks=ranks)


def parse_config(argv=None, config_cls=Config):
    """``config_cls()`` (this CLI's :class:`Config` by default) with the
    command line's overrides (:func:`dgraph_tpu_torch.utils.cli.parse_config`)."""
    from dgraph_tpu_torch.utils import cli

    return cli.parse_config(config_cls, argv)


if __name__ == "__main__":
    main(parse_config())
