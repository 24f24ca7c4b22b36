"""Where a training step spends its device time, by op.

    python -m dgraph_tpu_torch.train.profile
        [--config bench_gcn|ogb_gcn|lm_flash|gt_arxiv|gat_arxiv] [--steps 5] [--gather]
        [--out DIR]

Builds one of five training configurations on the card, runs two warm-up
steps, then records ``--steps`` train steps under ``torch.profiler`` (CPU
and CUDA activities):

- ``bench_gcn``: ``bench.py``'s ``bench_gcn`` (bench.py:428-534) on the port
  — ``random_edges(169343, 1166243, seed=0)``, one rank, dst-owned edges,
  ``pad_multiple=128``, GCN F=128 H=256 C=40 with 2 layers, no edge weight,
  random features and labels from seed 0, Adam 1e-3;
- ``ogb_gcn``: ``python -m dgraph_tpu_torch.train``'s model and graph at
  arxiv width (SBM, V=169,343, F=128, C=40, average degree 13.77,
  symmetric-norm edge weights, H=256, Adam 5e-3);
- ``lm_flash``: ``python -m dgraph_tpu_torch.train.lm``'s sequence-transformer
  LM at head width 128 — ``experiments/long_context_lm.py --seq_len 8192
  --latent 512 --num_heads 4 --num_layers 2 --vocab 64 --attn_impl ulysses
  --world_size 1``, Adam 3e-3, causal; every attention runs the three
  flash-attention kernels;
- ``gt_arxiv``, ``gat_arxiv``: ``python -m dgraph_tpu_torch.train --model
  gt`` and ``--model gat`` on ``ogb_gcn``'s graph at the CLI's defaults
  (``experiments/ogb_gcn.py``: hidden 128, 2 layers, 4 heads, Adam 5e-3, no
  edge weights). The graph transformer attends over all 169,344 vertex
  slots at head width 32 (the flash kernels, non-causal, the padded slot
  masked); GAT runs kernel 2 in every head group's softmax and sum.

``--gather`` switches the sorted-row-gather kernel on
(``config.use_pallas_gather``). Prints the card (``nvidia-smi``), the wall
time per step, the device-busy share and the device kernels and copies by
time; writes the same as JSON to ``DIR/train_profile_<config>.json``
(default ``chiprun_out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def bench_gcn_setup(device, edges=None):
    """(model, optimizer step, batch on ``device``, stacked plan on the
    CPU, CPU batch, CPU copy of the initial model) for bench_gcn; ``edges``
    (``[2, E]`` over ``ARXIV_NODES`` vertices) replaces its graph, as
    ``chip_smoke.py`` phase 12 gives it the skewed arxiv graph."""
    import copy

    import numpy as np
    import torch

    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.data.synthetic import ARXIV_EDGES, ARXIV_NODES, random_edges
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.plan import build_edge_plan, validate_plan
    from dgraph_tpu_torch.train.loop import make_train_step
    from dgraph_tpu_torch.weights import init_params

    V, F, C, H = ARXIV_NODES, 128, 40, 256
    if edges is None:
        edges = random_edges(V, ARXIV_EDGES, seed=0)
    plan, _ = build_edge_plan(edges, np.zeros(V, np.int32), world_size=1, edge_owner="dst",
                              pad_multiple=128)
    validate_plan(plan)
    n = plan.n_src_pad
    gen = torch.Generator().manual_seed(0)
    batch = {"x": torch.randn(1, n, F, generator=gen),
             "y": torch.randint(0, C, (1, n), generator=gen, dtype=torch.int32),
             "mask": (torch.arange(n) < V).float()[None]}
    model = init_params(GCN(F, H, C, SingleComm(), num_layers=2), seed=2)
    model_cpu = copy.deepcopy(model)
    model.to(device)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3),
                           plan.to(device))
    batch_d = {k: v.to(device) for k, v in batch.items()}
    return model, step, batch_d, plan, batch, model_cpu


def ogb_gcn_config(world_size: int = 1, partition: str | None = None):
    """The CLI's Config for ogb_gcn at arxiv width; ``world_size=4`` is the
    multi-rank configuration (dst-owned; with
    ``DGRAPH_TPU_HALO_IMPL=pallas_p2p`` it runs the one-sided transport)
    under ``partition``, by default the CLI's (at one rank every partition
    gives the same plan)."""
    from dgraph_tpu_torch.data.synthetic import ARXIV_AVG_DEGREE, ARXIV_NODES
    from dgraph_tpu_torch.train.__main__ import Config, DataConfig

    return Config(model="gcn", hidden=256, num_layers=2, lr=5e-3, device="cuda",
                  world_size=world_size,
                  data=DataConfig(num_nodes=ARXIV_NODES, num_classes=40, feat_dim=128,
                                  avg_degree=ARXIV_AVG_DEGREE,
                                  partition=partition or DataConfig().partition))


def gt_arxiv_config():
    """The CLI's Config for ``--model gt`` on ogb_gcn's arxiv-width graph
    (hidden 128, 4 heads: head width 32)."""
    import dataclasses

    return dataclasses.replace(ogb_gcn_config(), model="gt", hidden=128)


def gat_arxiv_config():
    """The CLI's Config for ``--model gat`` on ogb_gcn's arxiv-width graph
    (hidden 128 a head, 4 heads: four head groups of one)."""
    import dataclasses

    return dataclasses.replace(ogb_gcn_config(), model="gat", hidden=128)


CLI_CONFIGS = {"ogb_gcn": ogb_gcn_config, "gt_arxiv": gt_arxiv_config,
               "gat_arxiv": gat_arxiv_config}


def lm_flash_config():
    """train.lm's Config for lm_flash (T = 8192, H = 4, D = 128)."""
    from dgraph_tpu_torch.train.lm import Config

    return Config(seq_len=8192, latent=512, num_heads=4, num_layers=2, vocab=64,
                  attn_impl="ulysses", world_size=1, lr=3e-3, device="cuda")


def device_ops(prof, steps: int) -> list:
    """Device kernels and copies by self time per step, largest first. The
    device-side spans of user annotations (``Optimizer.step#Adam.step``)
    cover kernels listed on their own and are left out."""
    from torch.autograd import DeviceType

    spans = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    ops = []
    for evt in prof.key_averages():
        if (evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0
                and evt.key not in spans):
            ops.append({"name": evt.key, "count": evt.count,
                        "device_ms_per_step": evt.self_device_time_total / 1e3 / steps})
    return sorted(ops, key=lambda o: -o["device_ms_per_step"])


def profile_steps(step, steps: int) -> dict:
    """``steps`` calls of ``step()`` under torch.profiler, timed on the host
    clock to a final synchronize: wall and device ms per step, the
    device-busy share and the device ops."""
    import torch
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    ops = device_ops(prof, steps)
    busy = sum(o["device_ms_per_step"] for o in ops)
    return {"steps": steps, "wall_ms_per_step": wall_ms, "device_ms_per_step": busy,
            "device_busy_share": busy / wall_ms, "ops": ops}


def profile(config: str = "bench_gcn", steps: int = 5, gather: bool = False,
            out_dir: str = "chiprun_out") -> dict:
    import torch

    from dgraph_tpu_torch import config as _cfg

    if not torch.cuda.is_available():
        raise SystemExit("train.profile measures the card: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    old = _cfg.use_pallas_gather
    _cfg.use_pallas_gather = True if gather else old
    try:
        if config == "bench_gcn":
            _, step, batch, *_ = bench_gcn_setup(dev)
        elif config in CLI_CONFIGS:
            from dgraph_tpu_torch.train.__main__ import build_training

            t = build_training(CLI_CONFIGS[config]())
            step, batch = t.train_step, t.batches["train"]
        elif config == "lm_flash":
            from dgraph_tpu_torch.train.lm import build_lm

            t = build_lm(lm_flash_config())
            step, batch = t.train_step, t.next_batch()
        else:
            raise SystemExit(f"unknown config {config}")
        for _ in range(2):
            step(batch)
        rec = profile_steps(lambda: step(batch), steps)
    finally:
        _cfg.use_pallas_gather = old
    rec.update(nvidia_smi=smi, config=config, gather_kernel=gather)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"train_profile_{config}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="bench_gcn",
                   choices=("bench_gcn", "lm_flash", *CLI_CONFIGS))
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--gather", action="store_true")
    p.add_argument("--out", default="chiprun_out")
    a = p.parse_args(argv)
    rec = profile(a.config, a.steps, a.gather, a.out)
    print(rec["nvidia_smi"])
    print(f"{a.config} (gather kernel {'on' if a.gather else 'off'}): wall "
          f"{rec['wall_ms_per_step']:.3f} ms/step, device busy {rec['device_ms_per_step']:.3f} ms "
          f"({rec['device_busy_share']:.1%})")
    for o in rec["ops"][:25]:
        print(f"  {o['device_ms_per_step']:9.4f} ms  x{o['count']:<5d} {o['name'][:90]}")


if __name__ == "__main__":
    main()
