"""Time lm_flash training steps of two checkouts in turns on one card.

    python -m dgraph_tpu_torch.train.step_ab OLD_ROOT [--new NEW_ROOT] [--rounds 1]
        [--dtypes float32 bfloat16] [--out DIR]

Runs ``python -m dgraph_tpu_torch.train.lm``'s ``main`` at lm_flash's width
(``train.profile.lm_flash_config``: T = 8192, latent 512, 4 heads, 2 layers,
vocab 64, Adam 3e-3, causal) from each checkout's root (NEW defaults to this
checkout), in the order old, new, new, old (``--rounds`` times): first in
f32, then with ``DGRAPH_TPU_COMPUTE_DTYPE=bfloat16`` (``--dtypes`` picks).
Each run is a process of its own that builds its checkout's kernels. A
step's time is the host clock around it, ended by a device synchronize
(``lm.main``'s ``step_ms``); the report is the p50 and p99 over the steps
after the first two, per run. Prints one line a
run and writes the same as JSON to ``DIR/step_ab.json`` (default
``chiprun_out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

STEPS = 12  # lm_flash's run in chip_smoke.py phase 8: 2 warm-up, 10 timed

# run in the checkout under test: its own lm.main, its own kernels
_RUN = """
import dataclasses, json
from dgraph_tpu_torch.train import lm
from dgraph_tpu_torch.train.profile import lm_flash_config
cfg = dataclasses.replace(lm_flash_config(), steps={steps}, log_every={steps},
                          log_path={log!r})
res = lm.main(cfg)
print("STEP_MS " + json.dumps(res["step_ms"]), flush=True)
"""


def run_steps(root: Path, dtype: str, log: str) -> list:
    """Step times (ms) of one lm_flash run of the checkout at ``root``."""
    env = dict(os.environ, PYTHONPATH=str(root), DGRAPH_TPU_COMPUTE_DTYPE=dtype)
    out = subprocess.run([sys.executable, "-c", _RUN.format(steps=STEPS, log=log)], cwd=root,
                         env=env, capture_output=True, text=True, check=True).stdout
    line = next(x for x in out.splitlines() if x.startswith("STEP_MS "))
    return json.loads(line.removeprefix("STEP_MS "))


def percentile(xs: list, q: float) -> float:
    import numpy as np

    return float(np.percentile(xs, q))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--dtypes", nargs="+", default=["float32", "bfloat16"],
                    choices=["float32", "bfloat16"])
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    out = Path(a.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    rows = []
    for dtype in a.dtypes:
        for i, tag in enumerate(("old", "new", "new", "old") * a.rounds):
            root = (a.old if tag == "old" else a.new).resolve()
            ms = run_steps(root, dtype, str(out / f"step_ab_{dtype}_{i}_{tag}.jsonl"))
            timed = ms[2:]
            row = {"tree": tag, "root": str(root), "dtype": dtype, "step_ms": ms,
                   "p50": percentile(timed, 50), "p99": percentile(timed, 99)}
            rows.append(row)
            print(f"{dtype:9s} {tag}: step ms p50 {row['p50']:.3f} p99 {row['p99']:.3f} "
                  f"(steps 2-{len(ms) - 1})", flush=True)
    with open(out / "step_ab.json", "w") as f:
        json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
