"""``python -m dgraph_tpu_torch.serve`` — online GNN inference serving CLI.

Counterpart of ``python -m dgraph_tpu.serve``: builds a serving stack over a
synthetic SBM graph (or an npz), warms every bucket, runs mixed-size
closed-loop traffic through the micro-batcher and prints one ``serve_health``
JSON record. ``--selftest`` adds hard checks: served logits equal the
full-graph forward's bit-for-bit (over W ranks: the gathered
``full_logits()``), an over-ladder request is rejected with the structured
``too_large`` error, and the reference's swap leg runs: a step 1 of the
served params scaled by 1.0625 (written by global rank 0 into a temporary
``swap/`` directory, never into ``--ckpt_dir``) is hot-swapped in
(``ServeEngine.swap_params``; over W ranks on every rank) and every bucket
then serves the new ``full_logits()``'s bits, unlike the old; a swap back to
the restored step whose ``pre_swap`` fault point raises (over W ranks on the
last rank only) rolls back on every rank, the rows still step 1's bits. The
``serve_health`` record's ``lineage`` holds both attempts. Runs on ``cuda``
unless ``--device cpu``; with no card it raises.

``--ckpt_dir`` serves from a checkpoint directory (``train.checkpoint``),
never from in-process state: an empty directory is first seeded with the
seeded parameters as step 0 (by global rank 0 alone), a directory that
holds steps is never written to, and every rank restores the newest
readable step (``ServeEngine.from_checkpoint``; the record's
``restored_step``). ``--plan_cache`` names the plan cache
(``train.checkpoint.cached_edge_plan``, the reference's artifact): over
ranks global rank 0 alone loads, repairs or builds the plan and writes
there, and every other rank loads what it resolved, verified. A selftest
without ``--ckpt_dir`` or ``--plan_cache`` uses temporary ``ckpt/`` and
``plans/`` directories, so the save -> restore round trip and the cache
always run.

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
import contextlib
import dataclasses
import importlib
import itertools
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
    # checkpoint ("" = the seeded params; an empty dir is seeded with them at
    # step 0; the selftest uses a temporary dir so the restore always runs)
    ckpt_dir: str = ""
    # plan cache ("" = build the plan on every rank, no cache; the selftest
    # uses a temporary dir so the cache path always runs)
    plan_cache: str = ""
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
    batcher (they run ``engine.follow()``). With ``cfg.ckpt_dir`` the
    parameters come from that directory (seeded with the seeded ones at
    step 0 when it holds no step). With ``cfg.plan_cache`` the plan comes
    from that cache in its agreed form (global rank 0 resolves and writes,
    the others load what it resolved). Returns (engine, batcher, graph)."""
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.models import GCN, GraphSAGE
    from dgraph_tpu_torch.obs.metrics import Metrics
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.bucketing import BucketLadder
    from dgraph_tpu_torch.serve.engine import ServeEngine
    from dgraph_tpu_torch.train import checkpoint
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
        add_symmetric_norm=cfg.model == "gcn", plan_cache_dir=cfg.plan_cache,
        group=comm.group,
    )
    F, C = g.features.shape[-1], data["num_classes"]
    if cfg.model == "gcn":
        model = GCN(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    else:
        model = GraphSAGE(F, cfg.hidden, C, comm, num_layers=cfg.num_layers)
    init_params(model, cfg.seed)
    registry = Metrics()
    kw = dict(device=dev, registry=registry,
              ladder=BucketLadder.geometric(cfg.min_bucket, cfg.max_bucket, cfg.growth))
    if cfg.ckpt_dir:
        # an EMPTY dir is seeded with the seeded params so the save ->
        # restore round trip runs; one that holds steps is a real training
        # artifact, never written to
        def seed():
            if checkpoint.latest_step(cfg.ckpt_dir) is None:
                checkpoint.save_checkpoint(cfg.ckpt_dir,
                                           {"params": model.state_dict(), "step": 0}, 0)

        checkpoint.on_rank0(comm.group, seed)
        engine = ServeEngine.from_checkpoint(model, g, cfg.ckpt_dir, **kw)
    else:
        engine = ServeEngine.from_distributed_graph(model, g, **kw)
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
    request rejected and the swap leg), stop the followers and return the
    ``serve_health`` record. Ranks 1..W-1 follow and return what they ran.
    ``cfg.selftest`` runs in a temporary directory that global rank 0 makes
    (its path agreed over the ranks; one host's): the swap leg's ``swap/``,
    and ``ckpt/`` and ``plans/`` unless ``cfg.ckpt_dir`` and
    ``cfg.plan_cache`` name others."""
    import tempfile

    from dgraph_tpu_torch.train.checkpoint import on_rank0

    with contextlib.ExitStack() as stack:
        tmp = None
        if cfg.selftest:
            tmp = on_rank0(comm.group if comm is not None else None, lambda: stack.enter_context(
                tempfile.TemporaryDirectory(prefix="dgraph_serve_selftest_")))
            cfg = dataclasses.replace(cfg, ckpt_dir=cfg.ckpt_dir or os.path.join(tmp, "ckpt"),
                                      plan_cache=cfg.plan_cache or os.path.join(tmp, "plans"))
        return _serve(cfg, comm, tmp)


def _raise_at_call(n: int):
    """A ``pre_swap`` hook that raises at its call ``n`` (from 0), only then."""
    calls = itertools.count()

    def hook():
        if next(calls) == n:
            raise RuntimeError("fault injected mid-swap (the selftest's pre_swap)")

    return hook


def _scale_float_leaves(params: dict, factor: float) -> dict:
    """Every floating tensor of a state dict times ``factor`` (an exact
    power-of-two-ish factor keeps the perturbation bit-stable)."""
    return {k: v * factor if v.is_floating_point() else v for k, v in params.items()}


def _selftest_swap(cfg: Config, engine, scratch: str) -> list:
    """The reference's swap leg (``_selftest_swap``) on rank 0: adopt a step
    1 of the served params scaled by 1.0625, saved under ``scratch/swap``;
    every bucket then serves the new ``full_logits()``'s bits, not the old
    ones; then a swap back to the restored step whose ``pre_swap`` raises
    (at W > 1 the last rank's, armed when it was built) must roll back with
    the rows still step 1's bits."""
    from dgraph_tpu_torch.serve.errors import SwapRejected
    from dgraph_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint

    failures = []
    old = engine.full_logits()
    state = restore_checkpoint(cfg.ckpt_dir, step=engine.restored_step)
    params = state["params"] if "params" in state else state
    swap_dir = os.path.join(scratch, "swap")
    save_checkpoint(swap_dir, {"params": _scale_float_leaves(params, 1.0625), "step": 1}, 1)
    try:
        engine.swap_params(swap_dir, step=1)
    except SwapRejected as e:
        return [f"hot swap not adopted: {e.record()}"]
    new = engine.full_logits()

    def served_rows_are(want) -> bool:
        for b in engine.ladder.sizes:
            ids = np.arange(min(b, engine.num_nodes))
            r, s = engine.rank_slot(ids)
            if not np.array_equal(engine.infer(ids), want[r, s]):
                return False
        return True

    if not served_rows_are(new):
        failures.append("post-swap served logits diverge from the new full_logits()")
    if np.array_equal(new, old):
        failures.append("the adopted step 1 serves step 0's logits")
    if engine.world_size == 1:
        engine.pre_swap = _raise_at_call(0)
    try:
        engine.swap_params(cfg.ckpt_dir, step=engine.restored_step)
        failures.append("a swap faulted at pre_swap was adopted, not rolled back")
    except SwapRejected as e:
        if not (e.context.get("rolled_back") and e.context.get("reason") == "fault"):
            failures.append(f"the faulted swap's rejection: {e.record()}")
    finally:
        engine.pre_swap = None
    if not served_rows_are(new) or not np.array_equal(engine.full_logits(), new):
        failures.append("the rollback disturbed the serving params")
    return failures


def _serve(cfg: Config, comm=None, scratch: Optional[str] = None) -> dict:
    from dgraph_tpu_torch.serve.errors import RequestTooLarge

    engine, batcher, _ = build_serving(cfg, comm=comm)
    if batcher is None:
        if cfg.selftest and engine.rank == engine.world_size - 1:
            engine.pre_swap = _raise_at_call(1)  # the swap leg's second swap
        dispatches = engine.follow()
        return {"kind": "serve_follower", "rank": engine.rank, "dispatches": dispatches,
                "forwards": engine.forwards, "restored_step": engine.restored_step,
                "serving_step": engine.serving_step}
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
            failures += _selftest_swap(cfg, engine, scratch)
    finally:
        engine.stop()
    rec = {
        "kind": "serve_health",
        "device": str(engine.device),
        "world_size": engine.world_size,
        "halo_impl": engine.halo_impl,
        "ckpt_dir": engine.ckpt_dir,
        "plan_cache": cfg.plan_cache,
        "restored_step": engine.restored_step,
        "serving_step": engine.serving_step,
        "generation": engine.generation,
        "lineage": engine.lineage,
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
    failed). Over ranks the record's ``restored_steps`` and
    ``serving_steps`` list every rank's."""
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
        recs = launch(rank_fn, W, dataclasses.asdict(cfg), device=device,
                      group_timeout=cfg.request_timeout_s,
                      threads=max(1, (os.cpu_count() or 1) // W) if device == "cpu" else 0)
        rec = recs[0]
        if rec["kind"] != "serve_health":  # a follower under torchrun
            return rec
        rec["restored_steps"] = [r["restored_step"] for r in recs]
        rec["serving_steps"] = [r["serving_step"] for r in recs]
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
