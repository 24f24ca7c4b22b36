"""Rank functions of the multi-rank serving tests (``test_torch_serve_dist.py``).

Each runs in a process that ``dgraph_tpu_torch.comm.dist.launch`` spawns, so
this module imports torch and the port only, never JAX: the test process
builds the reference's side and hands the weights over as numpy arrays in
a pickle. Rank 0 returns what it served; ranks 1..W-1 what they followed.
"""

from __future__ import annotations

import os
import pickle
import sys
import threading
import time

import numpy as np
import torch

from dgraph_tpu_torch import config
from dgraph_tpu_torch.comm import DistComm
from dgraph_tpu_torch.serve.__main__ import Config, build_serving
from dgraph_tpu_torch.serve.engine import RankLost
from dgraph_tpu_torch.serve.errors import QueueFull

IMPLS = ("all_to_all", "ppermute", "overlap", "pallas_p2p", "sched")
MODELS = ("gcn", "sage")
# requests a case serves one at a time: every bucket's edges and one past
# the smallest (the ladder is 8, 16, 32, 64)
SIZES = (1, 7, 8, 9, 15, 16, 17, 31, 32, 33, 63, 64)
BATCHED = (3, 20, 5, 40, 1, 11)  # submitted together through the batcher
# the stress case: more threads than cores dispatch on rank 0 at once
STRESS_THREADS, STRESS_CALLS = 16, 3
# the fault case: rank 1's pre-forward check fails at these bucket attempts
# (one retried request, then degrade_after requests of three attempts each)
FAULTY_ATTEMPTS = frozenset({0} | set(range(2, 11)))


def _engine(group, model: str, params: dict, **kw):
    cfg = Config(model=model, world_size=group.world_size)
    engine, batcher, _ = build_serving(cfg, comm=DistComm(group), device="cpu")
    engine.model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    for k, v in kw.items():
        setattr(engine, k, v)
    return engine, batcher


def _serve_case(group, model: str, params: dict) -> dict:
    """One engine under the pinned lowering: rank 0 warms every bucket,
    takes ``full_logits()``, serves SIZES one at a time and BATCHED through
    the batcher, and stops the followers."""
    engine, batcher = _engine(group, model, params)
    out = {"halo_impl": engine.halo_impl}
    if batcher is None:
        out["dispatches"] = engine.follow()
        out["forwards"] = engine.forwards
        return out
    rng = np.random.default_rng(7)
    try:
        engine.warmup()
        out["full"] = engine.full_logits()
        out["rank_slot"] = engine.rank_slot(np.arange(engine.num_nodes))
        served = []
        for n in SIZES:
            ids = rng.choice(engine.num_nodes, size=n, replace=False)
            served.append((ids, engine.infer(ids)))
        reqs = [rng.choice(engine.num_nodes, size=n, replace=False) for n in BATCHED]
        futures = [batcher.submit(ids) for ids in reqs]
        served += [(ids, f.result(timeout=60)) for ids, f in zip(reqs, futures)]
        out["served"] = served
        out["batches"] = engine.registry.snapshot()["counters"]["serve.batches"]
    finally:
        batcher.stop()
        engine.stop()
    out["forwards"] = engine.forwards
    return out


def _fault_case(group, params: dict) -> dict:
    """Rank 1's pre-forward check fails at FAULTY_ATTEMPTS: the first
    request is retried on every rank and served; the next degrade_after
    requests exhaust their retries and degrade rank 0's engine, which then
    sheds; reset_degraded re-admits."""
    engine, batcher = _engine(group, "gcn", params, retry_backoff_s=0.0)
    out = {}
    if group.rank == 1:
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] - 1 in FAULTY_ATTEMPTS:
                raise RuntimeError("injected fault before the forward")

        engine.pre_forward = flaky
        out["attempts"] = calls
    if batcher is None:
        out["dispatches"] = engine.follow()
        out["forwards"] = engine.forwards
        out["attempts"] = out.get("attempts", {}).get("n")
        return out
    batcher.stop()
    ids = np.arange(5)
    try:
        out["served"] = engine.infer(ids)
        out["retries"] = engine.registry.snapshot()["counters"]["serve.infer_retries"]
        errors = []
        for _ in range(engine.degrade_after):
            try:
                engine.infer(ids)
            except RuntimeError as e:
                errors.append(str(e))
        out["errors"], out["degraded"] = errors, engine.degraded
        try:
            engine.infer(ids)
        except QueueFull as e:
            out["shed"] = e.context["degraded"]
        engine.reset_degraded()
        out["after_reset"] = engine.infer(ids)
        out["full"] = engine.full_logits()
        out["rank_slot"] = engine.rank_slot(ids)
    finally:
        engine.stop()
    out["forwards"] = engine.forwards
    return out


def _stress_case(group, params: dict) -> dict:
    """STRESS_THREADS threads on rank 0 each dispatch STRESS_CALLS requests
    and a full logits at once, the interpreter switching threads every
    microsecond: the dispatch lock must keep every dispatch's collectives
    whole (interleaved ones deadlock or mix rows)."""
    engine, batcher = _engine(group, "sage", params)
    if batcher is None:
        return {"dispatches": engine.follow(), "forwards": engine.forwards}
    batcher.stop()
    results, errors = [], []

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(STRESS_CALLS):
                ids = rng.choice(engine.num_nodes, size=int(rng.integers(1, 65)), replace=False)
                results.append((ids, engine.infer(ids)))
            results.append((None, engine.full_logits()))
        except Exception as e:  # noqa: BLE001 — reported to the test
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(STRESS_THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        alive = sum(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    full = engine.full_logits()
    engine.stop()
    return {"results": results, "errors": errors, "alive": alive, "full": full,
            "rank_slot": engine.rank_slot(np.arange(engine.num_nodes)),
            "forwards": engine.forwards}


def run_cases(group, path: str) -> dict:
    """Every model under every pinned lowering (``pallas_p2p`` through the
    transport's plain version on the CPU), then the fault and the stress
    cases."""
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {}
    try:
        config.use_pallas_p2p = True
        for model in MODELS:
            for impl in IMPLS:
                config.halo_impl = impl
                out[(model, impl)] = _serve_case(group, model, inputs[model])
    finally:
        config.halo_impl, config.use_pallas_p2p = "auto", None
    out["fault"] = _fault_case(group, inputs["gcn"])
    out["stress"] = _stress_case(group, inputs["sage"])
    return out


def lost_rank(group, path: str, record: str) -> dict:
    """Rank 1 exits mid-forward (before its second layer) in the first
    request after the warmup; rank 0 writes to ``record`` how long that
    request and the next ones took to fail and what they raised, then
    returns (the launch then fails: rank 1 left the group)."""
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    engine, batcher = _engine(group, "gcn", inputs["gcn"], retry_backoff_s=0.0)
    if batcher is None:
        warm = len(engine.ladder.sizes) + 1  # the warmup's forwards

        def exit_in_forward(*_):
            if engine.forwards == warm:
                os._exit(0)

        engine.model.GraphConvLayer_1.register_forward_pre_hook(exit_in_forward)
        engine.follow()
        return {}
    batcher.stop()
    engine.warmup()
    rec = {"failures": []}
    for _ in range(engine.degrade_after + 1):
        t = time.perf_counter()
        try:
            engine.infer(np.arange(5))
            kind = "served"
        except (RankLost, QueueFull) as e:
            kind = type(e).__name__
        rec["failures"].append((kind, time.perf_counter() - t))
    rec["degraded"] = engine.degraded
    engine.stop()  # the followers are gone: announces nothing
    with open(record, "wb") as f:
        pickle.dump(rec, f)
    return rec


def landing_after_inference(group) -> bool:
    """Kernel 5 first under ``inference_mode`` (a serving forward maps its
    landing buffer there), then outside it (training, a timed call): both
    calls equal the transport's plain version. Needs the card."""
    from dgraph_tpu_torch.ops import p2p

    W, S, F = group.world_size, 8, 16
    gen = torch.Generator().manual_seed(group.rank)
    blocks = torch.randn(1, S, F, generator=gen).to(group.device)
    with torch.inference_mode():
        first = p2p.p2p_transport(blocks, (1,), W, S, group=group)
    second = p2p.p2p_transport(blocks, (1,), W, S, group=group)
    want = p2p.p2p_transport_plain(blocks, (1,), W, S, group=group)
    return bool(torch.equal(first, want) and torch.equal(second, want))
