"""``python -m dgraph_tpu_torch.serve`` — online GNN inference serving CLI.

Counterpart of ``python -m dgraph_tpu.serve``: builds a serving stack over a
synthetic SBM graph (or an npz), warms every bucket, runs mixed-size
closed-loop traffic through the micro-batcher and prints one ``serve_health``
JSON record. ``--selftest`` adds hard checks: served logits equal the
full-graph forward's bit-for-bit, and an over-ladder request is rejected
with the structured ``too_large`` error. Runs on ``cuda`` unless
``--device cpu``; with no card it raises.

    python -m dgraph_tpu_torch.serve --num_nodes 169343 --feat_dim 128 \\
        --hidden 256 --num_classes 40 --avg_degree 13.77 --max_bucket 1024
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    request_timeout_s: float = 30.0
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


def build_serving(cfg: Optional[Config] = None, *, device=None):
    """Graph -> seeded model -> engine + batcher, on ``device`` (default:
    ``cfg.device``, else ``cuda``; raises with no card before any work).
    Returns (engine, batcher, graph)."""
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.models import GCN, GraphSAGE
    from dgraph_tpu_torch.obs.metrics import Metrics
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.bucketing import BucketLadder
    from dgraph_tpu_torch.serve.engine import ServeEngine
    from dgraph_tpu_torch.weights import init_params

    cfg = cfg or Config()
    dev = default_device(device if device is not None else (cfg.device or None))
    if cfg.model not in ("gcn", "sage"):
        raise SystemExit(f"unknown model {cfg.model}")
    data = load_data(cfg)
    g = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"],
        world_size=1, partition_method=cfg.partition,
        add_symmetric_norm=cfg.model == "gcn",
    )
    F, C, comm = g.features.shape[-1], data["num_classes"], SingleComm()
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
    batcher = MicroBatcher(
        engine,
        max_batch_size=cfg.max_batch_size,
        max_delay_ms=cfg.max_delay_ms,
        max_queue_depth=cfg.max_queue_depth,
        default_timeout_s=cfg.request_timeout_s,
        registry=registry,
    )
    return engine, batcher, g


def main(cfg: Config) -> dict:
    from dgraph_tpu_torch.serve.errors import RequestTooLarge

    engine, batcher, _ = build_serving(cfg)
    failures = []
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
    rec = {
        "kind": "serve_health",
        "device": str(engine.device),
        "warmup": warm,
        "forwards": engine.forwards,
        "metrics": engine.registry.snapshot(),
    }
    if failures:
        rec["error"] = "; ".join(failures)
    print(json.dumps(rec, default=str))
    if failures:
        raise SystemExit("selftest FAILED: " + "; ".join(failures))
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
