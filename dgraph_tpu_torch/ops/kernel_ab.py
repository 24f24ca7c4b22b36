"""Time the CUDA kernels of two source trees in turns on one card.

    python -m dgraph_tpu_torch.ops.kernel_ab OLD_CSRC [--new NEW_CSRC] [--hub-sweep]
        [--out DIR]

Builds every source of ``ops/_build.SOURCES`` found in each directory (NEW
defaults to this checkout's ``csrc/``) with the same nvcc flags, under
``dgraph_tpu_torch/_build/ab/`` (git-ignored), then times each exported
entry point in the order old, new, new, old, with CUDA events around
back-to-back launches into preallocated outputs (kernel time only):

- the sorted-id kernels at the training shape — E = 2,332,672 sorted ids
  drawn uniformly over N = 169,344 rows, F = 128; kernel 2 also at F = 1 as
  one column of that tensor (row stride 128, "strided");
- the width sweep of kernel 2 on contiguous ``[E, F]`` rows (GAT's and
  SAGE's layout) at F in SWEEP_F;
- kernels 1 (weighted), 1a (unweighted) and 2 on skewed ids: power-law ids
  (:func:`power_law_ids`, a row of about 46,000 edges) at F in SKEW_F, and
  the owner ids of the skewed arxiv graph's plan
  (``synthetic.skewed_arxiv_edges``, bench_gcn's plan) at F = 128; the new
  tree with its hub plan (``ops.segment.hub_plan``), and the two trees'
  bits compared on the rows of at most HUB_DEGREE edges; and kernel 2 at
  F = 128 on the src-side ids of the CLI's one-rank SBM plan, whose src row
  0 holds the plan's padded edges (zero rows, as the path gives them), bits
  compared on every row. With ``--hub-sweep`` the new tree also runs at
  each (degree, chunk) of HUB_SWEEP, the sweep that chose HUB_DEGREE and
  HUB_CHUNK;
- the three flash-attention entry points at the lm_flash shape — T = 8192,
  H = 4, D = 128, causal, q, k and v as column slices of one [T, 3L] tensor
  as the LM passes them, lse and di from the plain forward;

each in f32 and bf16. It reports whether the two trees give equal bits and
the largest absolute difference between them. An entry point the old tree
lacks is timed for the new tree only; one whose trailing arguments (the
attention scratch, the hub plan) the old tree lacks is called without them. Then it times, on the host, one call
of this checkout's kernel-2 wrapper at F = 1 and each of its parts
(:func:`wrapper_host_parts`). Prints one line per entry and dtype; writes
the same as JSON to ``DIR/kernel_ab.json`` (default ``chiprun_out``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
from pathlib import Path
from typing import NamedTuple

N_ROWS, N_EDGES, F = 169_344, 2_332_672, 128
SWEEP_F = (1, 2, 4, 8, 16, 32, 64)
SKEW_F = (1, 16, 128)
# (HUB_DEGREE, HUB_CHUNK) pairs of --hub-sweep
HUB_SWEEP = tuple((d, c) for d in (64, 128, 256, 512, 1024) for c in (64, 128, 256, 512) if c <= d)
LM_T, LM_H, LM_D = 8192, 4, 128  # lm_flash: seq_len 8192, latent 512, 4 heads
# the trailing arguments (after the stream) a tree's entry points may take,
# by the text that marks them in its signature, and how many there are
TAILS = {"flash_attention": ("void* scratch", 1), "sorted_segment": ("hub_chunks", 6)}


class Call(NamedTuple):
    src: str  # the source (library) name
    entry: str  # the C entry point
    out: object  # the output tensor, or a tuple of them
    args: tuple  # the arguments before the stream
    tail: tuple = ()  # after the stream, where the tree's entry point takes them
    rows: object = None  # the output rows whose bits the trees must share (None: all)
    new_only: bool = False  # a variant of the new tree's call (the hub sweep)


def build_tree(csrc: Path, tag: str) -> dict:
    """{source name: bound CDLL} for every source of SOURCES in ``csrc``,
    one nvcc a source, all started together."""
    from dgraph_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in _build.SOURCES.items():
        if not (csrc / src).exists():
            continue
        out = out_dir / f"lib{name}-{tag}.so"
        procs[name] = (out, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {csrc / _build.SOURCES[name]}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in _build.SIGNATURES[name].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
        lib.tail_entries = set()
        if name in TAILS:
            # a tree from before an entry point's trailing arguments
            mark, count = TAILS[name]
            text = (csrc / _build.SOURCES[name]).read_text()
            lib.tail_entries = {fn for fn in _build.SIGNATURES[name]
                                if hasattr(lib, fn) and takes_tail(text, fn, mark)}
            for fn in set(_build.SIGNATURES[name]) - lib.tail_entries:
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = getattr(lib, fn).argtypes[:-count]
        libs[name] = lib
    return libs


def takes_tail(text: str, entry: str, mark: str) -> bool:
    """Whether C entry point ``entry`` of source ``text`` takes the trailing
    arguments that ``mark`` names (the f32 split-TF32 kernels' scratch, the
    sorted-segment hub plan)."""
    sig = text[text.index(f"int {entry}("):]
    return mark in sig[:sig.index(")")]


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
    before the stream[, the forward's scratch after it])}) at the training
    shape."""
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
    seg_call = functools.partial(Call, "sorted_segment", tail=NO_HUBS)
    return keep, {
        "segment_sum": seg_call("dg_sorted_segment_sum", out_n,
                                (p(data), F, p(row_ptr), p(out_n), N_ROWS, F, code, 0, 1)),
        "segment_sum F=1 strided": seg_call(
            "dg_sorted_segment_sum", out_n,
            (p(data), F, p(row_ptr), p(out_n), N_ROWS, 1, code, 0, 0)),
        "bias_relu weighted": seg_call(
            "dg_sorted_segment_sum_bias_relu", out_n,
            (p(data), F, p(x), F, p(w), p(row_ptr), p(out_n), N_ROWS, F, code, 1)),
        "act unweighted": seg_call(
            "dg_sorted_segment_sum_act", out_f,
            (p(data), F, p(x), F, None, p(row_ptr), p(out_f), N_ROWS, F, code, 1)),
        "fused_bwd_gd": Call("sorted_gather", "dg_fused_bwd_gd", out_e,
                             (p(data), F, p(x), F, p(x), F, p(ids), p(out_e), N_EDGES, N_ROWS,
                              F, code, 1)),
        "sorted_row_gather": Call("sorted_gather", "dg_sorted_row_gather", out_e,
                                  (p(x), F, p(ids), p(out_e), N_EDGES, N_ROWS, F, code, 1)),
    }


# the hub arguments of a call without hubs
NO_HUBS = (None, None, 0, 0, 0, None)


def power_law_ids(n: int, e_valid: int, e_pad: int, exponent: float = 0.8, seed: int = 7):
    """Sorted int32 ids of ``e_valid`` edges over ``n`` rows, each row's
    share of the edges proportional to rank^-exponent (the ranks shuffled
    over the rows), padded with ``n`` to ``e_pad`` slots: at the arxiv shape
    the largest row holds about 46,000 edges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    p = np.arange(1, n + 1, dtype=np.float64) ** -exponent
    rows = rng.permutation(n)[rng.choice(n, e_valid, p=p / p.sum())]
    return np.concatenate([np.sort(rows), np.full(e_pad - e_valid, n)]).astype(np.int32)


def hub_edge_case_ids(n: int, degree: int, chunk: int, pad: int = 300, seed: int = 0):
    """Sorted int32 ids over ``n`` (>= 64) rows with the hub route's edge
    cases for a hub degree and chunk: row 0, the first, with ``degree + 1``
    edges; row 3 with exactly ``degree`` (not a hub); rows 40, 41 and 47,
    which share a narrow block at every width, with ``m`` (the least
    multiple of ``chunk`` above ``degree``), ``degree + 1`` and ``m + 7``
    edges; row ``n - 1``, the last real row, with ``2 * degree``; every
    other row 0-6 edges drawn from the seed; then ``pad`` ids equal to
    ``n`` (out of range, as the plan pads)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, n)
    m = (degree // chunk + 1) * chunk
    deg[[0, 3, 40, 41, 47, n - 1]] = (degree + 1, degree, m, degree + 1, m + 7, 2 * degree)
    ids = np.repeat(np.arange(n), deg)
    return np.concatenate([ids, np.full(pad, n)]).astype(np.int32)


def sweep_calls(dtype):
    """As :func:`entry_calls` for kernel 2's width sweep: contiguous
    ``[E, F]`` data at each F of SWEEP_F."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(0, N_ROWS, N_EDGES)).astype(np.int32)).to(dev)
    row_ptr = seg._row_ptr(ids, N_ROWS)
    code = seg._KERNEL_DTYPES[dtype]
    keep, calls = [ids, row_ptr], {}
    for f in SWEEP_F:
        data = torch.randn(N_EDGES, f, generator=gen, device=dev).to(dtype)
        out = torch.empty(N_ROWS, f, device=dev, dtype=dtype)
        keep += [data, out]
        calls[f"segment_sum F={f}"] = Call(
            "sorted_segment", "dg_sorted_segment_sum", out,
            (data.data_ptr(), f, row_ptr.data_ptr(), out.data_ptr(), N_ROWS, f, code, 0,
             int(seg._vec_ok(data, out))), NO_HUBS)
    return keep, calls


@functools.lru_cache(maxsize=1)
def skewed_plan_ids():
    """(owner ids, rows) of bench_gcn's plan (one rank, dst-owned, padded
    to 128) of the skewed arxiv graph (``synthetic.skewed_arxiv_edges``):
    sorted, padded with the row count."""
    import numpy as np

    from dgraph_tpu_torch.data.synthetic import ARXIV_NODES, skewed_arxiv_edges
    from dgraph_tpu_torch.plan import build_edge_plan

    plan, _ = build_edge_plan(skewed_arxiv_edges(), np.zeros(ARXIV_NODES, np.int32),
                              world_size=1, edge_owner="dst", pad_multiple=128)
    shard = plan.shard(0)
    return shard.dst_index.numpy(), int(shard.n_dst_pad)


@functools.lru_cache(maxsize=1)
def sbm_plan_src_ids():
    """(src-side sorted ids, rows, which of them are padded edges) of the
    CLI's one-rank plan of its arxiv-width SBM graph
    (``train.profile.ogb_gcn_config``): the ids kernel 2 sums by as the VJP
    of the src-side take (the halo sort route), in which every padded edge
    has src id 0, so row 0 holds the plan's 820 padded edges."""
    import numpy as np

    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.train.__main__ import load_data
    from dgraph_tpu_torch.train.profile import ogb_gcn_config

    cfg = ogb_gcn_config()
    data = load_data(cfg.data)
    graph = DistributedGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"], world_size=1,
        partition_method=cfg.data.partition, add_symmetric_norm=True)
    plan = graph.plan.shard(0)
    perm = plan.halo_sort_perm.numpy()
    padded = plan.edge_mask.numpy()[perm] == 0
    return (plan.halo_sorted_ids.numpy(), plan.n_src_pad + plan.world_size * plan.halo.s_pad,
            padded)


def skewed_calls(dtype, sweep=()):
    """As :func:`entry_calls` for kernels 1 (weighted), 1a (unweighted) and
    2 on skewed ids: power-law ids at F in SKEW_F, the skewed graph's plan
    ids at F = 128. The new tree gets the hub plan at HUB_DEGREE and
    HUB_CHUNK, and its bits are compared with the old tree's on the rows of
    at most HUB_DEGREE edges; each (degree, chunk) of ``sweep`` adds a call
    of the new tree alone with that plan. Then kernel 2 at F = 128 on the
    SBM plan's src-side ids (:func:`sbm_plan_src_ids`), whose one hub is
    src row 0 of padded edges, their rows zero as the path gives them:
    there the bits are compared on every row."""
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    code = seg._KERNEL_DTYPES[dtype]
    plan_ids, plan_n = skewed_plan_ids()
    src_ids, src_n, padded = sbm_plan_src_ids()
    keep, calls = [], {}
    for tag, ids_np, n, widths, zero in (
            ("power-law", power_law_ids(N_ROWS, N_EDGES, N_EDGES), N_ROWS, SKEW_F, None),
            ("skewed graph", plan_ids, plan_n, (F,), None),
            ("SBM plan src", src_ids, src_n, (F,), padded)):
        ids = torch.from_numpy(ids_np).to(dev)
        row_ptr = seg._row_ptr(ids, n)
        rows = None if zero is not None else (row_ptr[1:] - row_ptr[:-1]) <= seg.HUB_DEGREE
        plans = {(seg.HUB_DEGREE, seg.HUB_CHUNK): seg.hub_plan(row_ptr)}
        plans.update({dc: seg.hub_plan(row_ptr, *dc) for dc in sweep})
        keep += [ids, row_ptr, rows]
        E = ids.shape[0]
        for f in widths:
            data = torch.randn(E, f, generator=gen, device=dev).to(dtype)
            if zero is not None:
                data[torch.from_numpy(zero).to(dev)] = 0
            x = torch.randn(n, f, generator=gen, device=dev).to(dtype)
            w = torch.rand(E, generator=gen, device=dev)
            out = torch.empty(n, f, device=dev, dtype=dtype)
            out_f = torch.empty(n, f, device=dev)
            keep += [data, x, w, out, out_f]
            p = lambda t: t.data_ptr()  # noqa: E731
            vec = int(seg._vec_ok(data, x, out))
            entries = {
                "segment_sum": ("dg_sorted_segment_sum", out,
                                (p(data), f, p(row_ptr), p(out), n, f, code, 0, vec)),
                "bias_relu weighted": ("dg_sorted_segment_sum_bias_relu", out,
                                       (p(data), f, p(x), f, p(w), p(row_ptr), p(out), n, f,
                                        code, vec)),
                "act unweighted": ("dg_sorted_segment_sum_act", out_f,
                                   (p(data), f, p(x), f, None, p(row_ptr), p(out_f), n, f, code,
                                    vec)),
            }
            if zero is not None:  # the src side runs kernel 2 alone
                entries = {"segment_sum": entries["segment_sum"]}
            for (degree, chunk), hub in plans.items():
                tail, ws = seg.hub_args(hub, f, dev)
                keep += [hub, ws]
                variant = (degree, chunk) != (seg.HUB_DEGREE, seg.HUB_CHUNK)
                for label, (entry, o, args) in entries.items():
                    name = f"{label} F={f} {tag}" + (f" hub {degree}/{chunk}" if variant else "")
                    calls[name] = Call("sorted_segment", entry, o, args, tail,
                                       None if variant else rows, variant)
    return keep, calls


def attention_calls(dtype):
    """As :func:`entry_calls` for the three flash-attention entry points at
    the lm_flash shape (causal); an output may be a tuple of tensors, and
    each entry's scratch (None in bf16) follows the stream where the tree's
    entry point takes one."""
    import math

    import torch

    from dgraph_tpu_torch.ops import attention as att
    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    T, H, D = LM_T, LM_H, LM_D
    L = H * D
    qkv = torch.randn(T, 3 * L, generator=gen, device=dev).to(dtype)
    q, k, v = (qkv[:, i * L:(i + 1) * L].view(T, H, D) for i in range(3))
    do = torch.randn(T, H, D, generator=gen, device=dev).to(dtype)
    out_p, lse = att.flash_attention_fwd_plain(q, k, v, causal=True)
    di = att.row_dot(out_p, do)
    del out_p
    out, dq, dk, dv = (torch.empty(T, H, D, device=dev, dtype=dtype) for _ in range(4))
    lse_o = torch.empty(H, T, device=dev)
    scratch = att._split_scratch(T, H, D, dtype, dev)
    dkv_scratch, dq_scratch = (att._bwd_scratch(kind, T, H, D, dtype, dev)
                               for kind in ("dkv", "dq"))
    code, scale = seg._KERNEL_DTYPES[dtype], 1.0 / math.sqrt(D)
    s = lambda t: (t.data_ptr(), t.stride(0), t.stride(1))  # noqa: E731
    qkv_args = (*s(q), *s(k), *s(v))
    rest = (*s(do), lse.data_ptr(), di.data_ptr(), None)
    keep = (qkv, do, lse, di, scratch, dkv_scratch, dq_scratch)
    return keep, {
        "flash_attention_fwd": Call("flash_attention", "dg_flash_attention_fwd", (out, lse_o),
                                    (*qkv_args, None, out.data_ptr(), lse_o.data_ptr(), T, H, D,
                                     scale, 1, code), (att._ptr(scratch),)),
        "flash_attention_bwd_dkv": Call("flash_attention", "dg_flash_attention_bwd_dkv",
                                        (dk, dv), (*qkv_args, *rest, dk.data_ptr(),
                                                   dv.data_ptr(), T, H, D, scale, 1, code),
                                        (att._ptr(dkv_scratch),)),
        "flash_attention_bwd_dq": Call("flash_attention", "dg_flash_attention_bwd_dq", (dq,),
                                       (*qkv_args, *rest, dq.data_ptr(), T, H, D, scale, 1,
                                        code), (att._ptr(dq_scratch),)),
    }


def host_ms(fn, reps: int = 200) -> float:
    """Host time of one call: the host clock around ``reps`` back-to-back
    calls that are not waited for, divided by ``reps``."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def wrapper_host_parts() -> dict:
    """Host time a call (:func:`host_ms`) of kernel 2's wrapper
    (``ops.segment.sorted_segment_sum``, this checkout's) at F = 1, f32, at
    the training shape, and of its parts, beside ``index_add_``: where the
    wrapper's back-to-back time exceeds its kernel's, these say what the
    host spends. The wrapper skips its autograd Function when no gradient
    can flow; with data that requires one it goes through it."""
    import numpy as np
    import torch

    from dgraph_tpu_torch.ops import _build
    from dgraph_tpu_torch.ops import segment as seg

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(np.sort(rng.integers(0, N_ROWS, N_EDGES)).astype(np.int32)).to(dev)
    data = torch.randn(N_EDGES, 1, device=dev)
    data_rg = data.detach().requires_grad_()
    row_ptr = seg.csr_offsets(ids, N_ROWS)
    out = torch.empty(N_ROWS, 1, device=dev)
    lib = _build.load("sorted_segment")
    args = (data.data_ptr(), 1, row_ptr.data_ptr(), out.data_ptr(), N_ROWS, 1,
            seg._KERNEL_DTYPES[torch.float32], 0, 0, seg._stream(), *NO_HUBS)
    ids_long = ids.long()
    parts = {
        "wrapper": lambda: seg.sorted_segment_sum(data, ids, N_ROWS),
        "wrapper, data requiring a gradient": lambda: seg.sorted_segment_sum(data_rg, ids,
                                                                             N_ROWS),
        "input checks": lambda: seg._check_cuda_inputs(data, ids),
        "offsets (cached)": lambda: seg.csr_offsets(ids, N_ROWS),
        "output allocation": lambda: torch.empty((N_ROWS, 1), device=dev),
        "stream handle": seg._stream,
        "C entry point": lambda: lib.dg_sorted_segment_sum(*args),
        "index_add_": lambda: torch.zeros(N_ROWS, 1, device=dev).index_add_(0, ids_long, data),
    }
    return {k: host_ms(f) for k, f in parts.items()}


def compare(old: Path, new: Path, hub_sweep: bool = False) -> list:
    import torch

    from dgraph_tpu_torch.ops import segment as seg

    libs = {"old": build_tree(old, "old"), "new": build_tree(new, "new")}
    stream = torch.cuda.current_stream().cuda_stream
    skewed = functools.partial(skewed_calls, sweep=HUB_SWEEP if hub_sweep else ())
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for make in (entry_calls, sweep_calls, skewed, attention_calls):
            keep, calls = make(dtype)
            for label, c in calls.items():
                outs = c.out if isinstance(c.out, tuple) else (c.out,)
                fns = {}
                for tag, tree in libs.items():
                    lib = tree.get(c.src)
                    if lib is None or not hasattr(lib, c.entry) or (c.new_only and tag == "old"):
                        continue
                    t = c.tail if c.entry in lib.tail_entries else ()
                    fns[tag] = lambda f=getattr(lib, c.entry), a=c.args, t=t: f(*a, stream, *t)
                if "new" not in fns:
                    continue
                times, got = {}, {}
                for tag in ("old", "new", "new", "old"):
                    if tag in fns:
                        times.setdefault(tag, []).append(time_ms(fns[tag]))
                for tag, fn in fns.items():
                    for o in outs:
                        o.zero_()
                    rc = fn()
                    if rc != 0:
                        raise RuntimeError(f"{tag} {c.entry} {dtype}: CUDA error {rc} at launch")
                    torch.cuda.synchronize()
                    got[tag] = [o.clone() for o in outs]
                row = {"entry": label, "dtype": str(dtype).removeprefix("torch."),
                       "old_ms": times.get("old"), "new_ms": times["new"], "equal_bits": None}
                if "old" in got:
                    sel = slice(None) if c.rows is None else c.rows
                    row["equal_bits"] = all(torch.equal(a[sel], b[sel])
                                            for a, b in zip(got["old"], got["new"]))
                    row["bits_compared_on"] = "all rows" if c.rows is None else (
                        f"the {int(c.rows.sum())} rows of <= {seg.HUB_DEGREE} edges")
                    row["max_abs_diff"] = max(float((a.float() - b.float()).abs().max())
                                              for a, b in zip(got["old"], got["new"]))
                rows.append(row)
            del keep, calls
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> None:
    from dgraph_tpu_torch.ops import _build

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path)
    ap.add_argument("--new", type=Path, default=_build.CSRC_DIR)
    ap.add_argument("--hub-sweep", action="store_true",
                    help="also time the new tree at each (degree, chunk) of HUB_SWEEP")
    ap.add_argument("--out", default="chiprun_out")
    a = ap.parse_args(argv)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    rows = compare(a.old, a.new, a.hub_sweep)
    for r in rows:
        fmt = lambda v: "-" if v is None else "/".join(f"{t:.4f}" for t in v)  # noqa: E731
        diff = f"  max abs diff {r['max_abs_diff']:.3g}" if "max_abs_diff" in r else ""
        on = f" ({r['bits_compared_on']})" if "bits_compared_on" in r else ""
        print(f"{r['dtype']:9s} {r['entry']:40s} old {fmt(r['old_ms'])} ms  new "
              f"{fmt(r['new_ms'])} ms  equal bits {r['equal_bits']}{on}{diff}", flush=True)
    host = wrapper_host_parts()
    print("kernel 2's wrapper at F = 1, f32, host ms a call: "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, "kernel_ab.json"), "w") as f:
        json.dump({"nvidia_smi": smi, "old": str(a.old), "new": str(a.new), "rows": rows,
                   "wrapper_host_ms": host}, f, indent=1)


if __name__ == "__main__":
    main()
