"""Time training steps (or requests) of two checkouts in turns on one card.

    python -m dgraph_tpu_torch.train.step_ab OLD_ROOT [--new NEW_ROOT]
        [--config lm_flash|gat_arxiv|sage_arxiv|bench_gcn|bench_gcn_skewed] [--rounds 1]
        [--dtypes float32 bfloat16] [--out DIR]

Runs one configuration from each checkout's root (NEW defaults to this
checkout), in the order old, new, new, old (``--rounds`` times), once for
each dtype of ``--dtypes`` (``DGRAPH_TPU_COMPUTE_DTYPE``):

- ``lm_flash`` (default; f32 and bf16): ``python -m
  dgraph_tpu_torch.train.lm``'s ``main`` at ``train.profile.lm_flash_config``
  (T = 8192, latent 512, 4 heads, 2 layers, vocab 64, Adam 3e-3, causal),
  12 steps; a step's time is ``lm.main``'s ``step_ms``;
- ``gat_arxiv`` (f32): ``python -m dgraph_tpu_torch.train``'s ``main`` at
  ``train.profile.gat_arxiv_config`` (GAT, hidden 128, 4 heads, 2 layers, on
  the arxiv-width SBM graph), 12 steps; a step's time is the CLI's
  ``wall_ms``;
- ``sage_arxiv`` (f32): the arxiv-width GraphSAGE server of ``chip_smoke.py``
  phase 5 (``serve.build_serving``: V = 169,343, F = 128, H = 256, C = 40, 2
  layers), warmed, then 42 requests of sizes drawn from a seed over
  8..1024 ids through ``ServeEngine.infer`` (one full-graph forward and the
  row gather, ending in a host copy);
- ``bench_gcn``, ``bench_gcn_skewed`` (f32): ``chip_smoke.py`` phase 6's
  bench_gcn step (GCN F=128 H=256 C=40, unweighted, Adam 1e-3) on its
  random arxiv-shaped graph, or on the skewed arxiv graph of phase 12
  (``power_law_graph(169,343, 1,166,243 / 169,343, 0)`` symmetrized,
  largest in-degree 15,001), 12 steps, each ended by a synchronize.

Each run is a process of its own that builds its checkout's kernels. The
times are the host clock, ended by a device synchronize; the report is the
p50 and p99 over the steps or requests after the first two, per run. Prints
one line a run and writes the same as JSON to ``DIR/step_ab_<config>.json``
(default ``chiprun_out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

STEPS = 12  # as chip_smoke.py's runs: 2 warm-up, 10 timed

# run in the checkout under test: its own modules, its own kernels; each
# prints one line "STEP_MS [ms, ...]"
_RUN = {
    "lm_flash": """
import dataclasses, json
from dgraph_tpu_torch.train import lm
from dgraph_tpu_torch.train.profile import lm_flash_config
cfg = dataclasses.replace(lm_flash_config(), steps={steps}, log_every={steps},
                          log_path={log!r})
res = lm.main(cfg)
print("STEP_MS " + json.dumps(res["step_ms"]), flush=True)
""",
    "gat_arxiv": """
import contextlib, dataclasses, json, sys
from dgraph_tpu_torch.train import __main__ as cli
from dgraph_tpu_torch.train.profile import gat_arxiv_config
cfg = dataclasses.replace(gat_arxiv_config(), epochs={steps}, log_path={log!r})
with contextlib.redirect_stdout(sys.stderr):
    res = cli.main(cfg)
print("STEP_MS " + json.dumps([r["wall_ms"] for r in res["records"]]), flush=True)
""",
    "sage_arxiv": """
import contextlib, json, sys, time
import numpy as np, torch
from dgraph_tpu_torch.data.synthetic import ARXIV_AVG_DEGREE, ARXIV_NODES
from dgraph_tpu_torch.serve.__main__ import Config, build_serving
cfg = Config(model="sage", num_nodes=ARXIV_NODES, feat_dim=128, hidden=256, num_classes=40,
             avg_degree=ARXIV_AVG_DEGREE, max_bucket=1024)
with contextlib.redirect_stdout(sys.stderr):
    engine, batcher, _ = build_serving(cfg, device="cuda")
batcher.stop()
engine.warmup()
rng = np.random.default_rng(0)
ms = []
for size in rng.integers(8, 1025, {steps} * 3 + 6):
    ids = rng.choice(engine.num_nodes, size, replace=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.infer(ids)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print("STEP_MS " + json.dumps(ms), flush=True)
""",
}
# bench_gcn's step: 12 steps, each ended by a synchronize
_STEPS = """
ms = []
for _ in range({steps}):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(b)
    torch.cuda.synchronize()
    ms.append((time.perf_counter() - t0) * 1e3)
print("STEP_MS " + json.dumps(ms), flush=True)
"""
_RUN["bench_gcn"] = """
import json, time
import torch
from dgraph_tpu_torch.train.profile import bench_gcn_setup
_, step, b, *_ = bench_gcn_setup(torch.device("cuda"))
""" + _STEPS
# on the skewed arxiv graph: bench_gcn_setup's body and
# synthetic.skewed_arxiv_edges written out, because a checkout whose
# bench_gcn_setup takes no ``edges`` must run it too; once both trees take
# it, this becomes bench_gcn_setup(torch.device("cuda"), skewed_arxiv_edges())
_RUN["bench_gcn_skewed"] = """
import json, time
import numpy as np, torch
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data.synthetic import ARXIV_EDGES, ARXIV_NODES, power_law_graph
from dgraph_tpu_torch.models import GCN
from dgraph_tpu_torch.plan import build_edge_plan
from dgraph_tpu_torch.train.loop import make_train_step
from dgraph_tpu_torch.weights import init_params
V = ARXIV_NODES
src, dst = power_law_graph(V, ARXIV_EDGES / V, 0)
edges = np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
plan, _ = build_edge_plan(edges, np.zeros(V, np.int32), world_size=1, edge_owner="dst",
                          pad_multiple=128)
n = plan.n_src_pad
gen = torch.Generator().manual_seed(0)
batch = {{"x": torch.randn(1, n, 128, generator=gen),
         "y": torch.randint(0, 40, (1, n), generator=gen, dtype=torch.int32),
         "mask": (torch.arange(n) < V).float()[None]}}
model = init_params(GCN(128, 256, 40, SingleComm(), num_layers=2), seed=2).to("cuda")
step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3), plan.to("cuda"))
b = {{k: v.to("cuda") for k, v in batch.items()}}
""" + _STEPS
DEFAULT_DTYPES = {"lm_flash": ["float32", "bfloat16"], "gat_arxiv": ["float32"],
                  "sage_arxiv": ["float32"], "bench_gcn": ["float32"],
                  "bench_gcn_skewed": ["float32"]}


def run_steps(root: Path, config: str, dtype: str, log: str) -> list:
    """Step (or request) times (ms) of one run of ``config`` in the
    checkout at ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root), DGRAPH_TPU_COMPUTE_DTYPE=dtype)
    code = _RUN[config].format(steps=STEPS, log=log)
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, check=True).stdout
    line = next(x for x in out.splitlines() if x.startswith("STEP_MS "))
    return json.loads(line.removeprefix("STEP_MS "))


def percentile(xs: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(xs, q))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--config", default="lm_flash", choices=sorted(_RUN))
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--dtypes", nargs="+", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = Path(a.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for dtype in a.dtypes or DEFAULT_DTYPES[a.config]:
        for i, tag in enumerate(("old", "new", "new", "old") * a.rounds):
            root = (a.old if tag == "old" else a.new).resolve()
            ms = run_steps(root, a.config, dtype,
                           str(out / f"step_ab_{a.config}_{dtype}_{i}_{tag}.jsonl"))
            timed = ms[2:]
            row = {"tree": tag, "root": str(root), "config": a.config, "dtype": dtype,
                   "step_ms": ms, "p50": percentile(timed, 50), "p99": percentile(timed, 99)}
            rows.append(row)
            print(f"{a.config} {dtype:9s} {tag}: ms p50 {row['p50']:.3f} p99 {row['p99']:.3f} "
                  f"(steps 2-{len(ms) - 1})", flush=True)
    with open(out / f"step_ab_{a.config}.json", "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
