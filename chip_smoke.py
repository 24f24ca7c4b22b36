#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (``dgraph_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero and prints no result):

1. device — require CUDA; print the card's name and power limit (nvidia-smi);
2. build — compile every CUDA source of the port with nvcc (sm_90a), timed;
3. kernel parity — each kernel against its plain PyTorch version on the card,
   at the serving shapes (the arxiv-width GCN plan: E ~ 2.33 M edges,
   F = 128 per feature chunk, N = 169,344 rows) and at edge cases (padded
   out-of-range ids, empty segments, a hub vertex, F in {1, 33, 128}, a
   strided column slice), f32 and bf16; timed with CUDA events (mean over
   back-to-back calls after warmup) beside the plain version, the one-call
   PyTorch equivalent where there is one, and the memory-bound floor;
4. serve GCN — ``build_serving`` at ogbn-arxiv width (V = 169,343, F = 128,
   H = 256, C = 40, 2 layers, ladder 8..1024), every bucket warmed, 32
   mixed-size requests through the MicroBatcher; served rows must equal
   ``full_logits()`` bit for bit, the fused kernel must launch 4 times per
   forward, and ``full_logits()`` must match the same model and graph run on
   the CPU (plain path) within 1e-4; request latency p50/p99 per bucket;
5. serve SAGE — same width, a few requests, the segment-sum kernel's
   launches checked per forward;
6. the kernels line (one JSON object), then the device line (last line).

Everything but the two JSON lines and the nvidia-smi line goes out as
``[chip_smoke]`` progress lines; details land in
``chiprun_out/chip_smoke.json``. Weights and data are random, made from
seeds. Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import os
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and the
# non-tensor-core float32 rate the kernels' adds and multiplies run at
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
SERVE_TOL = 1e-4
OUT_DIR = "chiprun_out"


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


# --- phase 1 ---------------------------------------------------------------


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check runs on a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    # float32 matmuls in full f32 on the card (the CPU reference is full f32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    return smi[0]


# --- phase 2 ---------------------------------------------------------------


def phase_build() -> dict:
    from dgraph_tpu_torch.ops import _build

    t0 = time.perf_counter()
    times = _build.build()
    total = time.perf_counter() - t0
    for name in times:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"build: {total:.2f} s ({times})")
    return {"build_s": total, "per_source_s": times}


# --- phase 3 ---------------------------------------------------------------


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``reps`` back-to-back
    calls after warmup, divided by ``reps`` (the host enqueues ahead of
    the card, so launch gaps are amortised)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(e_valid: int, n: int, f: int, elem: int, *, bias: bool, weighted: bool,
          ops_per_elem: int) -> tuple:
    """Least time for one call: each input read once, each output written
    once, over HBM bandwidth; against the elementwise ops over the f32 peak."""
    nbytes = e_valid * f * elem + 4 * e_valid + n * f * elem  # data, ids, out
    if bias:
        nbytes += n * f * elem
    if weighted:
        nbytes += 4 * e_valid
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = e_valid * f * ops_per_elem / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) if got.numel() else 0.0


def check_close(name, got, want, dtype_name) -> float:
    import torch

    tol = TOL[dtype_name]
    if got.shape != want.shape or got.dtype != want.dtype:
        fail(f"{name}: kernel gave {tuple(got.shape)} {got.dtype}, plain "
             f"{tuple(want.shape)} {want.dtype}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite kernel output")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        fail(f"{name}: kernel disagrees with plain (max abs err {max_err(got, want)}, tol {tol})")
    return max_err(got, want)


def edge_case_ids(n: int, seed: int = 0):
    """Sorted ids with empty segments, a hub of degree 3000 and padded
    out-of-range ids (the plan's n_owner_pad)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    real = rng.choice(np.arange(0, n, 2), 20000)
    hub = np.full(3000, 8)
    pad = np.full(700, n)
    return np.concatenate([np.sort(np.concatenate([real, hub])), pad]).astype(np.int32)


def phase_kernels(graph) -> dict:
    """Parity of both kernels with their plain versions, and their times."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = graph.plan.shard(0).to(dev)
    ids = plan.dst_index  # owner-side, sorted, padded with n_pad
    n = plan.n_dst_pad
    w = graph.edge_weight[0].to(dev)
    e_pad = ids.shape[0]
    e_valid = int((ids < n).sum())
    F = 128
    records = []
    worst = {}

    def note(kernel, dtype_name, err):
        key = (kernel, dtype_name)
        worst[key] = max(worst.get(key, 0.0), err)

    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        data = torch.randn(e_pad, F, generator=gen, device=dev).to(dtype)
        bias = torch.randn(n, F, generator=gen, device=dev).to(dtype)
        elem = data.element_size()
        # kernel 1: the GCN path's fused aggregation (weighted) and unweighted
        for weighted in (True, False):
            ew = w if weighted else None
            name = f"sorted_segment_sum_bias_relu {dtype_name} {'w' if weighted else 'unw'} F={F}"
            got = seg.sorted_segment_sum_bias_relu(data, ids, bias, n, edge_weight=ew)
            want = seg.sorted_segment_sum_bias_relu_plain(data, ids, bias, n, edge_weight=ew)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dtype_name)
            note("sorted_segment_sum_bias_relu", dtype_name, err)
            again = seg.sorted_segment_sum_bias_relu(data, ids, bias, n, edge_weight=ew)
            if not torch.equal(got, again):
                fail(f"{name}: two launches differ (kernel must be deterministic)")
            b_ms, b_by = bound(e_valid, n, F, elem, bias=True, weighted=weighted,
                               ops_per_elem=4 if weighted else 3)
            rec = {
                "kernel": "sorted_segment_sum_bias_relu", "case": name,
                "dtype": dtype_name, "weighted": weighted, "E": e_pad,
                "E_valid": e_valid, "N": n, "F": F, "max_abs_err": err,
                "ms": time_ms(lambda: seg.sorted_segment_sum_bias_relu(
                    data, ids, bias, n, edge_weight=ew)),
                "plain_ms": time_ms(lambda: seg.sorted_segment_sum_bias_relu_plain(
                    data, ids, bias, n, edge_weight=ew), reps=5, warmup=1),
                "row_ptr_ms": time_ms(lambda: seg._row_ptr(ids, n)),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            }
            records.append(rec)
            log(f"{name}: err {err:.3g} kernel {rec['ms']:.4f} ms plain "
                f"{rec['plain_ms']:.4f} ms bound {b_ms:.4f} ms ({b_by})")
        # kernel 2: the SAGE neighbour sum (and relu input op)
        for op in ("none", "relu"):
            name = f"sorted_segment_sum {dtype_name} {op} F={F}"
            got = seg.sorted_segment_sum(data, ids, n, input_op=op)
            want = seg.sorted_segment_sum_plain(data, ids, n, input_op=op)
            torch.cuda.synchronize()
            err = check_close(name, got, want, dtype_name)
            note("sorted_segment_sum", dtype_name, err)
            again = seg.sorted_segment_sum(data, ids, n, input_op=op)
            if not torch.equal(got, again):
                fail(f"{name}: two launches differ (kernel must be deterministic)")
            b_ms, b_by = bound(e_valid, n, F, elem, bias=False, weighted=False,
                               ops_per_elem=2 if op == "relu" else 1)
            lib_ms = None
            if op == "none" and dtype == torch.float32:
                # index_add_ is the same function only in f32 (in bf16 it
                # accumulates in bf16), so it is the yardstick only there
                ids_v, data_v = ids[:e_valid].long(), data[:e_valid]
                lib = torch.zeros(n, F, dtype=dtype, device=dev).index_add_(0, ids_v, data_v)
                if not torch.allclose(lib.float(), want.float(), rtol=TOL[dtype_name],
                                      atol=TOL[dtype_name]):
                    fail(f"{name}: index_add_ yardstick disagrees with plain")
                lib_ms = time_ms(lambda: torch.zeros(n, F, dtype=dtype, device=dev)
                                 .index_add_(0, ids_v, data_v))
            rec = {
                "kernel": "sorted_segment_sum", "case": name, "dtype": dtype_name,
                "input_op": op, "E": e_pad, "E_valid": e_valid, "N": n, "F": F,
                "max_abs_err": err,
                "ms": time_ms(lambda: seg.sorted_segment_sum(data, ids, n, input_op=op)),
                "plain_ms": time_ms(lambda: seg.sorted_segment_sum_plain(
                    data, ids, n, input_op=op), reps=5, warmup=1),
                "row_ptr_ms": time_ms(lambda: seg._row_ptr(ids, n)),
                "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
            }
            records.append(rec)
            log(f"{name}: err {err:.3g} kernel {rec['ms']:.4f} ms plain "
                f"{rec['plain_ms']:.4f} ms library {lib_ms} ms bound {b_ms:.4f} ms")
        del data, bias

    # edge cases: empty segments, hub, padded ids, F in {1, 33, 128}, strided
    # column slices (the GCN's bias chunk), an unaligned slice (scalar path).
    # Values are multiples of 1/4 (weights too): exact in bf16, and their
    # sums exact in f32 in any order, so the hub's 3000-term sums compare
    # free of summation-order noise
    def quarters(*shape, lo=-8, hi=9):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float() / 4

    n_small = 5000
    ids_small = torch.from_numpy(edge_case_ids(n_small)).to(dev)
    e_small = ids_small.shape[0]
    w_small = quarters(e_small, lo=0, hi=5)
    for dtype_name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        for F_ in (1, 33, 128, 256):
            wide = quarters(e_small, F_ + 5).to(dtype)
            bias_wide = quarters(n_small, 2 * F_).to(dtype)
            views = {"contiguous": (wide[:, :F_].contiguous(), bias_wide[:, :F_].contiguous()),
                     "strided": (wide[:, :F_], bias_wide[:, F_:]),
                     "unaligned": (wide[:, 1:F_ + 1], bias_wide[:, 1:F_ + 1])}
            for layout, (d, b) in views.items():
                for ew in (None, w_small):
                    name = f"bias_relu edge {dtype_name} F={F_} {layout} w={ew is not None}"
                    got = seg.sorted_segment_sum_bias_relu(d, ids_small, b, n_small, edge_weight=ew)
                    want = seg.sorted_segment_sum_bias_relu_plain(d, ids_small, b, n_small,
                                                                  edge_weight=ew)
                    note("sorted_segment_sum_bias_relu", dtype_name,
                         check_close(name, got, want, dtype_name))
                for op in ("none", "relu"):
                    name = f"sum edge {dtype_name} F={F_} {layout} {op}"
                    got = seg.sorted_segment_sum(d, ids_small, n_small, input_op=op)
                    want = seg.sorted_segment_sum_plain(d, ids_small, n_small, input_op=op)
                    note("sorted_segment_sum", dtype_name,
                         check_close(name, got, want, dtype_name))
    torch.cuda.synchronize()
    log(f"edge cases passed; worst abs err {worst}")
    return {"records": records,
            "worst_abs_err": {f"{k}/{d}": v for (k, d), v in worst.items()}}


# --- phases 4 and 5 --------------------------------------------------------


def arxiv_config(model: str):
    from dgraph_tpu_torch.data.synthetic import ARXIV_AVG_DEGREE, ARXIV_NODES
    from dgraph_tpu_torch.serve.__main__ import Config

    return Config(
        model=model, num_nodes=ARXIV_NODES, feat_dim=128, hidden=256,
        num_classes=40, avg_degree=ARXIV_AVG_DEGREE, num_layers=2,
        min_bucket=8, max_bucket=1024, growth=2.0, seed=0,
    )


def request_sizes(n_requests: int, ladder, seed: int):
    """Request sizes spread evenly over the ladder's buckets (each size
    uniform within its bucket), in random order."""
    import numpy as np

    rng = np.random.default_rng(seed)
    lows = (0,) + ladder.sizes[:-1]
    sizes = [int(rng.integers(lows[i % len(lows)] + 1, ladder.sizes[i % len(lows)] + 1))
             for i in range(n_requests)]
    return rng, [sizes[i] for i in rng.permutation(n_requests)]


def cpu_reference(engine, graph):
    """The engine's model and graph on the CPU (plain PyTorch path)."""
    import torch

    from dgraph_tpu_torch.serve.engine import default_batch_args

    model = copy.deepcopy(engine.model).cpu()
    batch = {"x": graph.features[0]}
    if graph.edge_weight is not None:
        batch["edge_weight"] = graph.edge_weight[0]
    with torch.inference_mode():
        return model(*default_batch_args(batch, graph.plan.shard(0))).numpy()


def serve_path(model: str, kernel: str, per_forward, n_requests: int) -> dict:
    """Build, warm, drive ``n_requests`` through the batcher with the launch
    counts reset just before, and check the results."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg
    from dgraph_tpu_torch.serve.__main__ import build_serving

    cfg = arxiv_config(model)
    t0 = time.perf_counter()
    engine, batcher, graph = build_serving(cfg, device="cuda")
    build_s = time.perf_counter() - t0
    try:
        warm = engine.warmup()
        log(f"{model}: graph+engine {build_s:.1f} s, warmup {warm['warmup_s']} s "
            f"(E={graph.num_edges}, e_pad={graph.plan.e_pad}, n_pad={graph.plan.n_src_pad})")
        rng, sizes = request_sizes(n_requests, engine.ladder, seed=1)
        seg.reset_launch_counts()
        forwards0 = engine.forwards
        served, lat = [], {}
        for n in sizes:
            ids = rng.choice(engine.num_nodes, size=n, replace=False)
            t = time.perf_counter()
            out = batcher.infer(ids)
            lat.setdefault(engine.ladder.bucket_for(n), []).append(
                (time.perf_counter() - t) * 1e3)
            served.append((ids, out))
        launches = seg.launch_counts()
        forwards = engine.forwards - forwards0
    finally:
        batcher.stop()
    if launches[kernel] != per_forward * forwards or forwards == 0:
        fail(f"{model}: {kernel} launched {launches[kernel]} times over "
             f"{forwards} forwards (want {per_forward} per forward)")
    full = engine.full_logits()
    if not np.isfinite(full).all() or full.shape != (1, graph.plan.n_src_pad, cfg.num_classes):
        fail(f"{model}: full logits non-finite or shape {full.shape}")
    for ids, out in served:
        r, s = engine.rank_slot(ids)
        if out.shape != (len(ids), cfg.num_classes) or not np.array_equal(out, full[r, s]):
            fail(f"{model}: served rows differ from full_logits()")
    t = time.perf_counter()
    ref = cpu_reference(engine, graph)
    cpu_s = time.perf_counter() - t
    err = float(np.abs(full[0] - ref).max())
    if not np.allclose(full[0], ref, rtol=SERVE_TOL, atol=SERVE_TOL):
        fail(f"{model}: card logits differ from the CPU plain path (max abs err {err})")
    buckets = {
        str(b): {"count": len(v), "p50_ms": float(np.percentile(v, 50)),
                 "p99_ms": float(np.percentile(v, 99))}
        for b, v in sorted(lat.items())
    }
    log(f"{model}: {len(served)} requests, {forwards} forwards, launches {launches}; "
        f"served == full_logits bitwise; vs CPU max abs err {err:.3g} "
        f"(CPU forward {cpu_s:.1f} s)")
    for b, rec in buckets.items():
        log(f"{model}: bucket {b}: n={rec['count']} p50 {rec['p50_ms']:.3f} ms "
            f"p99 {rec['p99_ms']:.3f} ms")
    del engine
    torch.cuda.empty_cache()
    return {"model": model, "requests": len(served), "forwards": forwards,
            "launches": launches, "cpu_max_abs_err": err, "buckets": buckets,
            "warmup_s": warm["warmup_s"], "build_s": build_s}


def sage_launches_per_forward(cfg) -> int:
    """Sorted segment sums per GraphSAGE forward: each layer's feature
    chunks plus its degree count."""
    from dgraph_tpu_torch import config

    widths = [cfg.feat_dim] + [cfg.hidden] * (cfg.num_layers - 1)
    return sum(math.ceil(w / config.gather_col_block) + 1 for w in widths)


# --- main --------------------------------------------------------------------


def main() -> None:
    t_start = time.perf_counter()
    log("phase 1: device")
    smi = phase_device()
    import torch

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.serve.__main__ import load_data

    log("phase 2: build")
    build = phase_build()

    log("phase 3: kernel parity and times")
    cfg = arxiv_config("gcn")
    data = load_data(cfg)
    graph = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"],
        world_size=1, partition_method=cfg.partition, add_symmetric_norm=True,
    )
    del data
    kernels = phase_kernels(graph)
    del graph
    torch.cuda.empty_cache()

    log("phase 4: serve GCN")
    gcn_chunks = cfg.num_layers * math.ceil(cfg.hidden / config.gather_col_block)
    gcn = serve_path("gcn", "sorted_segment_sum_bias_relu", gcn_chunks, 32)

    log("phase 5: serve SAGE")
    sage = serve_path("sage", "sorted_segment_sum",
                      sage_launches_per_forward(arxiv_config("sage")), 8)

    log("phase 6: kernels line")
    main_case = {
        "sorted_segment_sum_bias_relu": "sorted_segment_sum_bias_relu float32 w F=128",
        "sorted_segment_sum": "sorted_segment_sum float32 none F=128",
    }
    launches = {"sorted_segment_sum_bias_relu": gcn["launches"]["sorted_segment_sum_bias_relu"],
                "sorted_segment_sum": sage["launches"]["sorted_segment_sum"]}
    from dgraph_tpu_torch.ops.segment import KERNELS

    line = []
    for name, (_, _, replaces) in KERNELS.items():
        rec = next(r for r in kernels["records"] if r["case"] == main_case[name])
        line.append({
            "name": name, "route": "cuda",
            "source": "dgraph_tpu_torch/csrc/sorted_segment.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": rec["max_abs_err"], "ms": rec["ms"], "kernel_ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "case": rec["case"],
        })
    for name in launches:
        if launches[name] <= 0:
            fail(f"{name} was never launched on its path")
    os.makedirs(OUT_DIR, exist_ok=True)
    detail = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "build": build, "kernels": kernels, "serve": [gcn, sage],
              "total_s": time.perf_counter() - t_start}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    log(f"done in {detail['total_s']:.1f} s; details in {OUT_DIR}/chip_smoke.json")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
