"""``python -m dgraph_tpu_torch.train.graphcast`` — distributed GraphCast
training on synthetic weather.

Counterpart of ``experiments/graphcast_train.py`` (``main``, :49-285; the
same ``Config`` fields and defaults): builds the multimesh, the grid and
their three plans (``models.graphcast.build_graphcast_graphs``), the
synthetic ERA5-like dataset, and :class:`~dgraph_tpu_torch.models.GraphCast`
(seeded, ``weights.init_params``), then trains ``--steps`` updates of the
masked MSE (the squared error summed over channels, over the global count
of grid points) with ``torch.optim.AdamW(weight_decay=0.1)`` under the
three-phase schedule (``train.schedules``; update k runs at
``schedule(k)``, so the first at lr 0), and an EMA track of the parameters
(``train.ema``) when ``--ema_decay > 0``. Writes one step record (the
reference's ``StepMetrics`` schema with ``step``, ``step_ms`` and ``lr =
schedule(step)``, after the increment; ``grad_norm`` under
``--step_metrics``) every 10 steps and at the last, to stdout and appended
to ``--log_path`` (rank 0). ``--eval_rollout N`` then rolls the raw and the
EMA weights out N steps, forward only, against the dataset's true
trajectory and logs the RMSE a step. ``--microbenchmark`` times the mesh
plan's src-side gather (the halo exchange and the take) against its
dst-side one (the take alone) and trains nothing.

    python -m dgraph_tpu_torch.train.graphcast --mesh_level 6 --num_lat 721 \\
        --num_lon 1440 --latent 256 --processor_layers 16
    python -m dgraph_tpu_torch.train.graphcast --device cpu --mesh_level 1 \\
        --num_lat 10 --num_lon 18 --channels 4 --latent 16 --steps 3
    python -m dgraph_tpu_torch.train.graphcast --world_size 4

``--world_size 0`` means every visible card (one rank with ``--device
cpu``). Above one rank the run spawns one process a rank
(``comm.dist.launch``): every rank builds the same graphs and dataset and
feeds its own shard, the loss's count and value are summed over the ranks,
and so are the gradients (``DGRAPH_TPU_HALO_IMPL`` pins the halo lowering).
Each step lays its sample out and moves it to the device, as the
reference does. Runs on ``cuda`` unless ``--device
cpu``; with no card it raises. Not ported yet: ``--ckpt_dir`` (checkpoints,
slice 9) and ``--step_deadline_s`` with the SIGTERM preemption guard (the
elastic pieces, slice 12) raise; the reference's start-up and timing
records are not written.
"""

from __future__ import annotations

import dataclasses
import os
import time
import types
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Config:
    """Distributed GraphCast training on synthetic weather."""

    mesh_level: int = 4
    num_lat: int = 181  # 1-degree grid default; 721 = ERA5 0.25-degree
    num_lon: int = 360
    channels: int = 73
    latent: int = 128
    processor_layers: int = 4
    peak_lr: float = 1e-3
    warmup_steps: int = 100
    decay_steps: int = 10_000
    steps: int = 200
    world_size: int = 0  # ranks; 0 = every visible card (1 with --device cpu)
    ckpt_dir: str = ""  # checkpoints: slice 9 of the port (raises)
    save_freq: int = 100
    microbenchmark: bool = False
    ema_decay: float = 0.999  # 0 disables the EMA track
    eval_rollout: int = 0  # > 0: RMSE a step of an N-step rollout, raw and EMA
    log_path: str = "logs/graphcast_torch.jsonl"
    step_deadline_s: float = 0.0  # > 0: the step watchdog, slice 12 of the port (raises)
    step_metrics: bool = False  # grad norm in each record
    device: str = ""  # "" = cuda (raises with no card); "cpu" for the plain path


def check_ported(cfg: Config) -> None:
    """Raise before any work for an option whose module the port lacks."""
    if cfg.ckpt_dir:
        raise NotImplementedError(
            "--ckpt_dir: checkpoints (train/checkpoint.py) come with slice 9 of the port")
    if cfg.step_deadline_s > 0:
        raise NotImplementedError(
            "--step_deadline_s: the step watchdog and the preemption guard "
            "(train/elastic.py) come with slice 12 of the port")


def masked_mse(pred, y, mask, count):
    """The squared error summed over channels and over this rank's real grid
    points, over the global count of grid points (at least 1)."""
    se = ((pred - y) ** 2).sum(-1) * mask
    return se.sum() / count.clamp_min(1.0)


def build_graphcast(cfg: Config, device=None, comm=None) -> types.SimpleNamespace:
    """Graphs, dataset, seeded model, AdamW, schedule, EMA and the train
    step of one rank (``comm``, None for one rank), on ``device`` (default
    the rank's device, else ``cfg.device``, else ``cuda``; raises with no
    card before any work). ``batch(i)`` is sample ``i``'s ``(x, y)`` shard
    on the device; ``train_step(x, y)`` returns a ``StepMetrics`` of the
    global loss (and the gradient norm under ``cfg.step_metrics``);
    ``restart()`` starts over from the seeded weights."""
    import torch

    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.comm import collectives as coll
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.data.weather import SyntheticWeatherDataset
    from dgraph_tpu_torch.models.graphcast import GraphCast, build_graphcast_graphs
    from dgraph_tpu_torch.models.graphcast.graph import rank_inputs
    from dgraph_tpu_torch.obs.metrics import StepMetrics
    from dgraph_tpu_torch.plan import check_owner_padding
    from dgraph_tpu_torch.train.ema import ema_init, ema_update
    from dgraph_tpu_torch.train.loop import _global_norm
    from dgraph_tpu_torch.train.schedules import graphcast_three_phase
    from dgraph_tpu_torch.weights import init_params

    check_ported(cfg)
    comm = comm or SingleComm()
    group = comm.group
    if device is None and group is not None:
        device = group.device
    dev = default_device(device if device is not None else (cfg.device or None))
    W, rank = comm.get_world_size(), comm.get_rank()

    t0 = time.perf_counter()
    graphs = build_graphcast_graphs(cfg.mesh_level, cfg.num_lat, cfg.num_lon, W)
    graph_build_s = time.perf_counter() - t0
    ds = SyntheticWeatherDataset(graphs, cfg.num_lat, cfg.num_lon, cfg.channels)
    dataset_s = time.perf_counter() - t0 - graph_build_s
    statics, plans, gmask = rank_inputs(graphs, rank, dev)
    for p in plans.values():
        check_owner_padding(p)
    count = coll.all_reduce_sum(gmask.sum(), group)

    model = GraphCast(latent=cfg.latent, processor_layers=cfg.processor_layers,
                      out_channels=cfg.channels, comm=comm).to(dev)
    params = [p for p in model.parameters() if p.requires_grad]
    schedule = graphcast_three_phase(cfg.peak_lr, cfg.warmup_steps, cfg.decay_steps)
    t = types.SimpleNamespace(
        device=dev, comm=comm, rank=rank, world_size=W, graphs=graphs, dataset=ds,
        graph_build_s=graph_build_s, dataset_s=dataset_s, statics=statics, plans=plans,
        grid_mask=gmask, count=count, model=model, schedule=schedule)

    def restart():
        """Start the run over on the same graphs and data: the seeded
        weights, a fresh AdamW under the schedule (update 0 first), a fresh
        EMA track."""
        init_params(model, seed=0)
        t.optimizer = torch.optim.AdamW(model.parameters(), lr=1.0, weight_decay=0.1)
        t.scheduler = torch.optim.lr_scheduler.LambdaLR(t.optimizer, schedule)
        t.ema = ema_init(dict(model.named_parameters())) if cfg.ema_decay > 0 else None

    def batch(i: int):
        """Sample ``i``'s (input, target) shard of this rank on the device."""
        x, y = ds.get_sharded(i % len(ds))
        return torch.from_numpy(x[rank]).to(dev), torch.from_numpy(y[rank]).to(dev)

    def train_step(x, y) -> StepMetrics:
        t.optimizer.zero_grad(set_to_none=True)
        loss = masked_mse(model(x, statics, plans), y, gmask, count)
        loss.backward()
        with torch.no_grad():
            coll.grad_sync(params, group)
            gn = _global_norm(params) if cfg.step_metrics else None
            t.optimizer.step()
            t.scheduler.step()
            if t.ema is not None:
                t.ema = ema_update(t.ema, dict(model.named_parameters()), cfg.ema_decay)
        return StepMetrics(loss=coll.all_reduce_sum(loss.detach(), group), grad_norm=gn)

    restart()
    t.batch, t.train_step, t.restart = batch, train_step, restart
    return t


def eval_rollout(t, num_steps: int) -> list:
    """GraphCast's eval protocol: roll the raw parameters (and the EMA
    track) out ``num_steps`` steps from sample 0, forward only, and the
    RMSE a step against the dataset's true trajectory, over every rank's
    real grid points and every channel. Returns one record a track."""
    import torch

    from dgraph_tpu_torch.comm import collectives as coll
    from dgraph_tpu_torch.models.graphcast import rollout

    x0, truth = t.dataset.trajectory_sharded(0, num_steps)
    x0 = torch.from_numpy(x0[t.rank]).to(t.device)
    truth = torch.from_numpy(truth[:, t.rank]).to(t.device)
    m = t.grid_mask[None, :, None]
    denom = float(t.count) * x0.shape[-1]
    tracks = [("raw", None)] + ([("ema", t.ema)] if t.ema is not None else [])
    recs = []
    for label, params in tracks:
        traj = rollout(t.model, x0, t.statics, t.plans, num_steps, params=params)
        se = coll.all_reduce_sum(((traj - truth) ** 2 * m).sum(dim=(1, 2)), t.comm.group)
        rmse = torch.sqrt(se / denom).tolist()
        recs.append({"rollout_eval": label, "steps": num_steps,
                     "rmse_per_step": [round(float(r), 5) for r in rmse]})
    return recs


MICRO_REPS = 20  # timed calls a gather in the microbenchmark, as the reference's


def microbenchmark(t) -> dict:
    """The reference's comm-against-compute split (``_microbenchmark``,
    :288-342): on the mesh plan, a zero ``[n_mesh_pad, latent]`` table
    gathered from the src side (the halo exchange plus the take) and from
    the dst side (the take alone, no communication), MICRO_REPS calls each
    after one warm-up, host clock around each synchronized call."""
    import torch

    from dgraph_tpu_torch.comm import collectives as coll

    plan = t.plans["mesh"]
    h = torch.zeros((plan.n_src_pad, t.model.latent), device=t.device)
    out = {}
    for name, side in (("comm_gather", "src"), ("local_gather", "dst")):
        times = []
        for i in range(MICRO_REPS + 1):
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            t0 = time.perf_counter()
            coll.gather(h, plan, side, t.comm.group)
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_ms_mean"] = float(np.mean(times))
        out[f"{name}_ms_std"] = float(np.std(times))
    return out


def _train(cfg: Config, on_step: Optional[Callable], comm=None) -> dict:
    """One rank's run. ``on_step(step, training, metrics)`` runs after each
    step (its gradients are still on the parameters); its return values
    come back in ``"on_step"``. Returns {"records", "step_ms", "losses",
    "rollout", "microbenchmark", "on_step", "graph_build_s", "training"}."""
    import torch

    from dgraph_tpu_torch.train.__main__ import _Log

    t = build_graphcast(cfg, comm=comm)
    log = _Log(cfg.log_path) if t.rank == 0 else None

    def write(rec):
        if log is not None:
            log.write(rec)

    def sync():
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    out = {"records": [], "step_ms": [], "losses": [], "rollout": [], "microbenchmark": None,
           "on_step": [], "graph_build_s": t.graph_build_s, "training": t}
    if cfg.microbenchmark:
        out["microbenchmark"] = micro = microbenchmark(t)
        for name in ("comm_gather", "local_gather"):  # a record each, as the reference's
            write({k: v for k, v in micro.items() if k.startswith(name)})
        return out
    for step_idx in range(cfg.steps):
        x, y = t.batch(step_idx)
        sync()
        t0 = time.perf_counter()
        sm = t.train_step(x, y)
        sync()
        dt = (time.perf_counter() - t0) * 1e3
        out["step_ms"].append(dt)
        out["losses"].append(float(sm.loss))
        done = step_idx + 1
        if done % 10 == 0 or done == cfg.steps:
            rec = sm.record(step=done, step_ms=round(dt, 2), lr=float(t.schedule(done)))
            write(rec)
            out["records"].append(rec)
        if on_step is not None:
            out["on_step"].append(on_step(step_idx, t, sm))
    if cfg.eval_rollout > 0:
        out["rollout"] = eval_rollout(t, cfg.eval_rollout)
        for rec in out["rollout"]:
            write(rec)
    return out


def _train_rank(group, cfg: dict, on_step: Optional[Callable]) -> dict:
    """A spawned rank: train on its shard (``cfg`` as a dict) and hand back
    what pickles."""
    from dgraph_tpu_torch.comm import DistComm

    out = _train(Config(**cfg), on_step, comm=DistComm(group))
    out.pop("training")
    return out


def main(cfg: Config, *, on_step: Optional[Callable] = None) -> dict:
    """Train on ``cfg.world_size`` ranks (or run the microbenchmark).
    Returns rank 0's result (:func:`_train`; ``training`` is None above one
    rank) with ``"ranks"``, every rank's. Above one rank ``on_step`` runs in
    each rank's process, so it must pickle."""
    import importlib

    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.train.__main__ import resolve_world_size

    check_ported(cfg)
    W = resolve_world_size(cfg.world_size, cfg.device)
    if W == 1 and "WORLD_SIZE" not in os.environ:
        out = _train(cfg, on_step)
        return dict(out, ranks=[out])
    device = cfg.device or "cuda"
    if device == "cuda":
        from dgraph_tpu_torch.config import default_device

        default_device()  # raises with no card, before any rank starts
    # by its module's name, not __main__'s: a spawned rank imports it
    rank_fn = importlib.import_module("dgraph_tpu_torch.train.graphcast")._train_rank
    ranks = launch(rank_fn, W, dataclasses.asdict(cfg), on_step, device=device,
                   threads=max(1, (os.cpu_count() or 1) // W) if device == "cpu" else 0)
    return dict(ranks[0], training=None, ranks=ranks)


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
