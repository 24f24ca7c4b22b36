"""Time the CUDA kernels of two source trees in turns on one card.

    python -m dgraph_tpu_torch.ops.kernel_ab OLD_CSRC [--new NEW_CSRC] [--out DIR]

Builds every source of ``ops/_build.SOURCES`` found in each directory (NEW
defaults to this checkout's ``csrc/``) with the same nvcc flags, under
``dgraph_tpu_torch/_build/ab/`` (git-ignored), then times each exported
entry point at the training shape — E = 2,332,672 sorted ids drawn
uniformly over N = 169,344 rows, F = 128, f32 and bf16 — in the order old,
new, new, old, with CUDA events around back-to-back launches into
preallocated outputs (kernel time only). It checks that the two trees give
equal bits. An entry point the old tree lacks is timed for the new tree
only. Prints one line per entry and dtype; writes the same as JSON to
``DIR/kernel_ab.json`` (default ``chiprun_out``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from pathlib import Path

N_ROWS, N_EDGES, F = 169_344, 2_332_672, 128


def build_tree(csrc: Path, tag: str) -> dict:
    """{source name: bound CDLL} for every source of SOURCES in ``csrc``."""
    from dgraph_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name, src in _build.SOURCES.items():
        if not (csrc / src).exists():
            continue
        out = out_dir / f"lib{name}-{tag}.so"
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / src)],
                       check=True, capture_output=True)
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.SIGNATURES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
        libs[name] = lib
    return libs


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def entry_calls(dtype):
    """(tensors to keep alive, {label: (source, entry point, output, arguments
    before the stream)}) at the training shape."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(0, N_ROWS, N_EDGES)).astype(np.int32)).to(dev)
    row_ptr = seg._row_ptr(ids, N_ROWS)
    code = seg._KERNEL_DTYPES[dtype]
    data = torch.randn(N_EDGES, F, generator=gen, device=dev).to(dtype)
    x = torch.randn(N_ROWS, F, generator=gen, device=dev).to(dtype)
    w = torch.rand(N_EDGES, generator=gen, device=dev)
    out_e = torch.empty(N_EDGES, F, device=dev, dtype=dtype)
    out_n = torch.empty(N_ROWS, F, device=dev, dtype=dtype)
    out_f = torch.empty(N_ROWS, F, device=dev)
    p = lambda t: t.data_ptr()  # noqa: E731
    keep = (ids, row_ptr, data, x, w)  # the calls hold raw pointers into these
    return keep, {
        "segment_sum": ("sorted_segment", "dg_sorted_segment_sum", out_n,
                        (p(data), F, p(row_ptr), p(out_n), N_ROWS, F, code, 0, 1)),
        "segment_sum F=1": ("sorted_segment", "dg_sorted_segment_sum", out_n,
                            (p(data), F, p(row_ptr), p(out_n), N_ROWS, 1, code, 0, 0)),
        "bias_relu weighted": ("sorted_segment", "dg_sorted_segment_sum_bias_relu", out_n,
                               (p(data), F, p(x), F, p(w), p(row_ptr), p(out_n), N_ROWS, F,
                                code, 1)),
        "act unweighted": ("sorted_segment", "dg_sorted_segment_sum_act", out_f,
                           (p(data), F, p(x), F, None, p(row_ptr), p(out_f), N_ROWS, F, code, 1)),
        "fused_bwd_gd": ("sorted_gather", "dg_fused_bwd_gd", out_e,
                         (p(data), F, p(x), F, p(x), F, p(ids), p(out_e), N_EDGES, N_ROWS, F,
                          code, 1)),
        "sorted_row_gather": ("sorted_gather", "dg_sorted_row_gather", out_e,
                              (p(x), F, p(ids), p(out_e), N_EDGES, N_ROWS, F, code, 1)),
    }


def compare(old: Path, new: Path) -> list:
    import torch

    libs = {"old": build_tree(old, "old"), "new": build_tree(new, "new")}
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        keep, calls = entry_calls(dtype)
        for label, (src, entry, out, args) in calls.items():
            fns = {}
            for tag, tree in libs.items():
                lib = tree.get(src)
                if lib is not None and hasattr(lib, entry):
                    fns[tag] = lambda f=getattr(lib, entry), a=args: f(*a, stream)
            times, outs = {}, {}
            for tag in ("old", "new", "new", "old"):
                if tag in fns:
                    times.setdefault(tag, []).append(time_ms(fns[tag]))
            for tag, fn in fns.items():
                out.zero_()
                if fn() != 0:
                    raise RuntimeError(f"{tag} {entry}: launch failed")
                torch.cuda.synchronize()
                outs[tag] = out.clone()
            rows.append({"entry": label, "dtype": str(dtype).removeprefix("torch."),
                         "old_ms": times.get("old"), "new_ms": times["new"],
                         "equal_bits": torch.equal(outs["old"], outs["new"]) if "old" in outs
                         else None})
        del keep
    return rows


def main(argv=None) -> None:
    from dgraph_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=_build.CSRC_DIR)
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    rows = compare(a.old, a.new)
    for r in rows:
        fmt = lambda v: "-" if v is None else "/".join(f"{t:.4f}" for t in v)  # noqa: E731
        print(f"{r['dtype']:9s} {r['entry']:20s} old {fmt(r['old_ms'])} ms  new "
              f"{fmt(r['new_ms'])} ms  equal bits {r['equal_bits']}")
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "kernel_ab.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "old": str(a.old), "new": str(a.new), "rows": rows}, f,
                  indent=1)


if __name__ == "__main__":
    main()
