"""``python -m dgraph_tpu_torch.serve`` — online GNN inference serving CLI.

Counterpart of ``python -m dgraph_tpu.serve``: builds a serving stack over a
synthetic SBM graph (or an npz), warms every bucket, runs mixed-size
closed-loop traffic through the micro-batcher and prints one ``serve_health``
JSON record. ``--selftest`` adds hard checks: served logits equal the
full-graph forward's bit-for-bit (over W ranks: the gathered
``full_logits()``), and an over-ladder request is rejected with the
structured ``too_large`` error. Runs on ``cuda`` unless ``--device cpu``;
with no card it raises.

    python -m dgraph_tpu_torch.serve --num_nodes 169343 --feat_dim 128 \\
        --hidden 256 --num_classes 40 --avg_degree 13.77 --max_bucket 1024
    python -m dgraph_tpu_torch.serve --device cpu --world_size 2 --selftest
    DGRAPH_TPU_HALO_IMPL=pallas_p2p python -m dgraph_tpu_torch.serve --world_size 4

``--world_size 0`` (the default) means every visible card, one rank with
``--device cpu``, as the reference's 0 means every device. Above one rank
the run spawns a process a rank (``comm.dist.launch``; under ``torchrun``
it joins that group): every rank builds the same graph from the same seed
and serves its shard; rank 0 holds the batcher and the traffic, the others
follow its dispatches (``ServeEngine.follow``). ``DGRAPH_TPU_HALO_IMPL``
pins the halo lowering as for training; the record names the world size and
the lowering resolved. ``request_timeout_s`` is also the ranks' group
timeout: a rank lost mid-forward fails the request within it (at once when
the rank's process exits), never after the launcher's default 600 s.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import typing
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Config:
    """Online GNN inference serving (``--selftest`` for the end-to-end check)."""

    selftest: bool = False
    device: str = ""  # "" = cuda (raises with no card); "cpu" for the plain path
    # graph (synthetic SBM unless data_path points at an npz)
    data_path: Optional[str] = None
    num_nodes: int = 400
    num_classes: int = 4
    feat_dim: int = 16
    avg_degree: float = 6.0
    partition: str = "random"
    world_size: int = 0  # ranks; 0 = every visible card (1 with --device cpu); > 1 spawns
    # model
    model: str = "gcn"  # gcn | sage
    hidden: int = 16
    num_layers: int = 2
    seed: int = 0
    # bucket ladder
    min_bucket: int = 8
    max_bucket: int = 64
    growth: float = 2.0
    # micro-batcher
    max_batch_size: int = 8
    max_delay_ms: float = 2.0
    max_queue_depth: int = 64
    request_timeout_s: float = 30.0  # a request's deadline; over ranks the group timeout
    # traffic
    requests: int = 32


def load_data(cfg: Config) -> dict:
    """The graph to serve: the npz at ``cfg.data_path`` or a synthetic SBM."""
    from dgraph_tpu_torch.data import synthetic

    if not cfg.data_path:
        return synthetic.sbm_classification_graph(
            num_nodes=cfg.num_nodes, num_classes=cfg.num_classes,
            feat_dim=cfg.feat_dim, avg_degree=cfg.avg_degree, seed=cfg.seed,
        )
    z = np.load(cfg.data_path)
    masks = {k.removesuffix("_mask"): z[k] for k in z.files if k.endswith("_mask")}
    if "valid" in masks and "val" not in masks:
        masks["val"] = masks.pop("valid")
    return {
        "edge_index": z["edge_index"],
        "features": z["features"],
        "labels": z["labels"],
        "masks": masks,
        "num_classes": int(np.asarray(z["labels"]).max()) + 1,
    }


def build_serving(cfg: Optional[Config] = None, *, device=None, comm=None):
    """Graph -> seeded model -> engine + batcher of one rank (``comm``: a
    :class:`~dgraph_tpu_torch.comm.DistComm` of W ranks, None for one), on
    ``device`` (default: the rank's card, else ``cfg.device``, else
    ``cuda``; raises with no card before any work). Every rank builds the
    W-rank graph and its engine holds its shard; ranks 1..W-1 get no
    batcher (they run ``engine.follow()``). Returns (engine, batcher,
    graph)."""
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.models import GCN, GraphSAGE
    from dgraph_tpu_torch.obs.metrics import Metrics
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.bucketing import BucketLadder
    from dgraph_tpu_torch.serve.engine import ServeEngine
    from dgraph_tpu_torch.train.__main__ import resolve_world_size
    from dgraph_tpu_torch.weights import init_params

    cfg = cfg or Config()
    comm = comm or SingleComm()
    if device is None and comm.group is not None:
        device = comm.group.device
    dev = default_device(device if device is not None else (cfg.device or None))
    W = comm.get_world_size()
    if resolve_world_size(cfg.world_size, dev.type) != W:
        raise ValueError(f"world_size={cfg.world_size} but the communicator has {W} ranks; "
                         "main() launches the ranks")
    if cfg.model not in ("gcn", "sage"):
        raise SystemExit(f"unknown model {cfg.model}")
    data = load_data(cfg)
    g = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"],
        world_size=W, partition_method=cfg.partition,
        add_symmetric_norm=cfg.model == "gcn",
    )
    F, C = g.features.shape[-1], data["num_classes"]
    if cfg.model == "gcn":
        model = GCN(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    else:
        model = GraphSAGE(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    init_params(model, cfg.seed)
    registry = Metrics()
    engine = ServeEngine.from_distributed_graph(
        model, g, device=dev, registry=registry,
        ladder=BucketLadder.geometric(cfg.min_bucket, cfg.max_bucket, cfg.growth),
    )
    if engine.rank != 0:
        return engine, None, g
    batcher = MicroBatcher(
        engine,
        max_batch_size=cfg.max_batch_size,
        max_delay_ms=cfg.max_delay_ms,
        max_queue_depth=cfg.max_queue_depth,
        default_timeout_s=cfg.request_timeout_s,
        registry=registry,
    )
    return engine, batcher, g


def serve(cfg: Config, comm=None) -> dict:
    """One rank's run. Rank 0: warm every bucket, drive ``cfg.requests``
    mixed-size requests through the batcher (with ``cfg.selftest`` each
    checked against ``full_logits()`` bit for bit, then an over-ladder
    request rejected), stop the followers and return the ``serve_health``
    record. Ranks 1..W-1 follow and return what they ran."""
    from dgraph_tpu_torch.serve.errors import RequestTooLarge

    engine, batcher, _ = build_serving(cfg, comm=comm)
    if batcher is None:
        dispatches = engine.follow()
        return {"kind": "serve_follower", "rank": engine.rank, "dispatches": dispatches,
                "forwards": engine.forwards}
    failures = []
    try:
        try:
            warm = engine.warmup()
            rng = np.random.default_rng(cfg.seed)
            expected = engine.full_logits() if cfg.selftest else None
            max_req = min(engine.ladder.max_size, engine.num_nodes)
            for _ in range(cfg.requests):
                n = int(rng.integers(1, max_req + 1))
                ids = rng.choice(engine.num_nodes, size=n, replace=False)
                out = batcher.infer(ids)
                if expected is not None:
                    r, s = engine.rank_slot(ids)
                    if not np.array_equal(out, expected[r, s]):
                        failures.append(
                            "served logits diverge from the full forward (max abs "
                            f"diff {np.abs(out - expected[r, s]).max()})"
                        )
                        break
        finally:
            batcher.stop()
        if cfg.selftest:
            try:
                engine.infer(np.zeros(engine.ladder.max_size + 1, np.int64))
                failures.append("over-ladder request was not rejected")
            except RequestTooLarge:
                pass
    finally:
        engine.stop()
    rec = {
        "kind": "serve_health",
        "device": str(engine.device),
        "world_size": engine.world_size,
        "halo_impl": engine.halo_impl,
        "warmup": warm,
        "forwards": engine.forwards,
        "metrics": engine.registry.snapshot(),
    }
    if failures:
        rec["error"] = "; ".join(failures)
    return rec


def _serve_rank(group, cfg: dict) -> dict:
    """A spawned rank: :func:`serve` on ``DistComm(group)`` (``cfg`` as a
    dict: the parent's Config class may live in its ``__main__``)."""
    from dgraph_tpu_torch.comm import DistComm

    return serve(Config(**cfg), comm=DistComm(group))


def main(cfg: Config) -> dict:
    """Serve on ``cfg.world_size`` ranks; print and return rank 0's
    ``serve_health`` record (raises SystemExit when a selftest check
    failed)."""
    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.train.__main__ import resolve_world_size

    W = resolve_world_size(cfg.world_size, cfg.device)
    if W == 1 and "WORLD_SIZE" not in os.environ:
        rec = serve(cfg)
    else:
        device = cfg.device or "cuda"
        if device == "cuda":
            from dgraph_tpu_torch.config import default_device

            default_device()  # raises with no card, before any rank starts
        # by its module's name, not __main__'s: a spawned rank imports it
        rank_fn = importlib.import_module("dgraph_tpu_torch.serve.__main__")._serve_rank
        rec = launch(rank_fn, W, dataclasses.asdict(cfg), device=device,
                     group_timeout=cfg.request_timeout_s,
                     threads=max(1, (os.cpu_count() or 1) // W) if device == "cpu" else 0)[0]
        if rec["kind"] != "serve_health":  # a follower under torchrun
            return rec
    print(json.dumps(rec, default=str))
    if "error" in rec:
        raise SystemExit("selftest FAILED: " + rec["error"])
    return rec


def parse_config(argv=None) -> Config:
    """``--field value`` overrides of :class:`Config`, typed by its fields."""
    parser = argparse.ArgumentParser(description=Config.__doc__)
    hints = typing.get_type_hints(Config)
    for f in dataclasses.fields(Config):
        ann = hints[f.name]
        if ann is bool:
            parser.add_argument(f"--{f.name}", nargs="?", const=True, default=f.default,
                                type=lambda s: s.strip().lower() in ("1", "true", "yes", "on"))
        else:
            base = next((a for a in typing.get_args(ann) if a is not type(None)), ann)
            parser.add_argument(f"--{f.name}", type=base, default=f.default)
    return Config(**vars(parser.parse_args(argv)))


if __name__ == "__main__":
    main(parse_config())
