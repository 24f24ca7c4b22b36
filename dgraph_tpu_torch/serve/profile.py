"""Where a served forward spends its device time, by op.

    python -m dgraph_tpu_torch.serve.profile [--model gcn|sage] [--forwards 5] [--out DIR]

Builds the arxiv-width serving engine on the card (the configuration
``chip_smoke.py`` serves), warms it, then records ``--forwards`` requests
of the largest bucket (``ServeEngine.infer``: one full-graph forward and
the row gather each) under ``torch.profiler`` (CPU and CUDA activities).
Prints the card (``nvidia-smi``), the wall time per request, the device-busy
share and the device kernels and copies by time; writes the same as JSON
to ``DIR/serve_profile_<model>.json`` (default ``chiprun_out``). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time


def profile(model: str = "gcn", forwards: int = 5, out_dir: str = "chiprun_out") -> dict:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from dgraph_tpu_torch.data.synthetic import ARXIV_AVG_DEGREE, ARXIV_NODES
    from dgraph_tpu_torch.serve.__main__ import Config, build_serving

    if not torch.cuda.is_available():
        raise SystemExit("serve.profile measures the card: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    cfg = Config(model=model, num_nodes=ARXIV_NODES, feat_dim=128, hidden=256,
                 num_classes=40, avg_degree=ARXIV_AVG_DEGREE, max_bucket=1024, world_size=1)
    engine, batcher, _ = build_serving(cfg, device="cuda")
    batcher.stop()
    engine.warmup()
    torch.cuda.synchronize()
    ids = np.random.default_rng(0).choice(engine.num_nodes, engine.ladder.max_size,
                                          replace=False)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(forwards):
            engine.infer(ids)
        wall_ms = (time.perf_counter() - t0) * 1e3 / forwards
    ops = []  # device-side events only: kernels and copies
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            ops.append({"name": evt.key, "count": evt.count,
                        "device_ms_per_request": evt.self_device_time_total / 1e3 / forwards})
    ops.sort(key=lambda o: -o["device_ms_per_request"])
    busy = sum(o["device_ms_per_request"] for o in ops)
    rec = {"nvidia_smi": smi, "model": model, "forwards": forwards,
           "wall_ms_per_request": wall_ms, "device_ms_per_request": busy,
           "device_busy_share": busy / wall_ms if wall_ms else None, "ops": ops}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"serve_profile_{model}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="gcn", choices=("gcn", "sage"))
    p.add_argument("--forwards", type=int, default=5)
    p.add_argument("--out", default="chiprun_out")
    a = p.parse_args(argv)
    rec = profile(a.model, a.forwards, a.out)
    print(rec["nvidia_smi"])
    print(f"{a.model}: wall {rec['wall_ms_per_request']:.3f} ms/request, device busy "
          f"{rec['device_ms_per_request']:.3f} ms ({rec['device_busy_share']:.1%})")
    for o in rec["ops"][:25]:
        print(f"  {o['device_ms_per_request']:9.4f} ms  x{o['count']:<5d} {o['name'][:90]}")


if __name__ == "__main__":
    main()
