"""Rank functions of the multi-rank serving tests (``test_torch_serve_dist.py``).

Each runs in a process that ``dgraph_tpu_torch.comm.dist.launch`` spawns, so
this module imports torch and the port only, never JAX: the test process
builds the reference's side and hands the weights over as numpy arrays in
a pickle. Rank 0 returns what it served; ranks 1..W-1 what they followed.
"""

from __future__ import annotations

import contextlib
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
    engine, batcher, _ = _built(group, model, params, **kw)
    return engine, batcher


def _built(group, model: str, params: dict, plan_cache: str = "", **kw):
    cfg = Config(model=model, world_size=group.world_size, plan_cache=plan_cache)
    engine, batcher, graph = build_serving(cfg, comm=DistComm(group), device="cpu")
    engine.model.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    for k, v in kw.items():
        setattr(engine, k, v)
    return engine, batcher, graph


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


# requests a checkpoint case serves one at a time
CKPT_SIZES = (1, 9, 33, 64)


def ckpt_cases(group, dirs: dict) -> dict:
    """Each model served through ``--ckpt_dir`` (``dirs[model]``): every
    rank builds its engine from the directory (``ServeEngine.
    from_checkpoint``: global rank 0 resolves the step, every rank restores
    it), reports the step and its parameters; rank 0 takes ``full_logits()``
    and serves CKPT_SIZES."""
    out = {}
    for model, ckpt in dirs.items():
        cfg = Config(model=model, world_size=group.world_size, ckpt_dir=ckpt)
        engine, batcher, _ = build_serving(cfg, comm=DistComm(group), device="cpu")
        case = {"restored_step": engine.restored_step, "lineage": engine.lineage,
                "params": {k: v.numpy().copy() for k, v in engine.model.state_dict().items()}}
        if batcher is None:
            case["dispatches"] = engine.follow()
        else:
            rng = np.random.default_rng(11)
            try:
                case["full"] = engine.full_logits()
                case["rank_slot"] = engine.rank_slot(np.arange(engine.num_nodes))
                case["served"] = [(ids, batcher.infer(ids)) for ids in (
                    rng.choice(engine.num_nodes, size=n, replace=False) for n in CKPT_SIZES)]
            finally:
                batcher.stop()
                engine.stop()
        out[model] = case
    return out


# --- serving from a plan cache --------------------------------------------------


@contextlib.contextmanager
def watch_writes(root: str):
    """The paths under ``root`` this process writes, renames, deletes or
    makes a directory at while the block runs (``open`` for writing and the
    ``os`` calls that change a tree; a directory that exists already is not
    made), in order."""
    import builtins

    root = os.path.abspath(root)
    seen = []

    def under(path) -> bool:
        return isinstance(path, (str, os.PathLike)) and os.path.abspath(
            os.fspath(path)).startswith(root)

    def wrap(mod, name, writes=lambda *a, **k: True):
        real = getattr(mod, name)

        def watched(*args, **kw):
            for a in args[:2]:
                if under(a) and writes(*args, **kw):
                    seen.append((name, os.path.relpath(os.fspath(a), root)))
            return real(*args, **kw)

        setattr(mod, name, watched)
        return mod, name, real

    def open_writes(file, mode="r", *a, **k):
        return any(c in mode for c in "wax+")

    def new_dir(path, *a, **k):
        return not os.path.isdir(path)

    patched = [wrap(builtins, "open", open_writes)] + [
        wrap(os, name) for name in ("replace", "rename", "unlink", "remove", "rmdir")] + [
        wrap(os, name, new_dir) for name in ("makedirs", "mkdir")]
    try:
        yield seen
    finally:
        for mod, name, real in reversed(patched):
            setattr(mod, name, real)


def plan_leaves(plan) -> dict:
    """Every tensor leaf of a plan (halo and overlap specs included), numpy."""
    import dataclasses

    out = {}
    for prefix, sub in (("", plan), ("halo.", plan.halo), ("overlap.", plan.overlap)):
        for f in dataclasses.fields(sub) if sub is not None else ():
            if isinstance(getattr(sub, f.name), torch.Tensor):
                out[prefix + f.name] = getattr(sub, f.name).numpy().copy()
    return out


# the cache turns of plan_cache_cases, in order
PLAN_CACHE_TURNS = ("cold", "warm", "repair")
REPAIRED_SHARD = 1  # the shard rank 0 truncates before the repair turn


def plan_cache_cases(group, path: str, cache_dir: str) -> dict:
    """GCN served through ``--plan_cache cache_dir`` in PLAN_CACHE_TURNS:
    cold (rank 0 builds and writes the artifact, the others load it), warm
    (every rank loads it), repair (rank 0 first truncates REPAIRED_SHARD,
    then rebuilds that shard alone). Each turn every rank reports its plan's
    leaves and the writes it made under ``cache_dir`` while building its
    engine; rank 0 takes ``full_logits()`` and serves SIZES, and the
    manifest. Last, rank 1 sees shard 0's checksum fail (a torn read only it
    meets): every rank's build raises, and nobody writes."""
    from dgraph_tpu_torch import plan_shards

    with open(path, "rb") as f:
        params = pickle.load(f)["gcn"]
    out = {"turns": {}}
    for turn in PLAN_CACHE_TURNS:
        if turn == "repair":
            if group.rank == 0:
                (plan_dir,) = [os.path.join(cache_dir, d) for d in os.listdir(cache_dir)]
                shard = os.path.join(plan_dir, plan_shards.shard_filename(REPAIRED_SHARD))
                with open(shard, "r+b") as f:
                    f.truncate(os.path.getsize(shard) // 2)
            group.barrier()
        with watch_writes(cache_dir) as writes:
            engine, batcher, graph = _built(group, "gcn", params, plan_cache=cache_dir)
        rec = {"writes": writes, "plan": plan_leaves(graph.plan),
               "world_size": engine.world_size}
        if batcher is None:
            rec["dispatches"] = engine.follow()
        else:
            batcher.stop()
            try:
                rec["full"] = engine.full_logits()
                rec["rank_slot"] = engine.rank_slot(np.arange(engine.num_nodes))
                rng = np.random.default_rng(5)
                rec["served"] = [(ids, engine.infer(ids)) for ids in (
                    rng.choice(engine.num_nodes, size=n, replace=False) for n in SIZES)]
            finally:
                engine.stop()
            (plan_dir,) = os.listdir(cache_dir)
            rec["plan_dir"] = plan_dir
            rec["manifest"] = plan_shards.read_manifest(os.path.join(cache_dir, plan_dir))
        rec["forwards"] = engine.forwards
        out["turns"][turn] = rec
        group.barrier()
    real = plan_shards._sha256_file
    if group.rank == 1:
        plan_shards._sha256_file = lambda p, *a: (
            "0" * 64 if p.endswith(plan_shards.shard_filename(0)) else real(p, *a))
    try:
        with watch_writes(cache_dir) as writes:
            try:
                _built(group, "gcn", params, plan_cache=cache_dir)
                out["bad_shard"] = None
            except Exception as e:  # noqa: BLE001 — reported to the test
                out["bad_shard"] = f"{type(e).__name__}: {e}"
        out["bad_shard_writes"] = writes
    finally:
        plan_shards._sha256_file = real
    return out


# --- checkpoint hot swap and the registry flip (slice 9d) -----------------------

# the swaps swap_cases makes on engine A, in order: (name, step, what each
# rank must end in). Rank 1's pre_swap raises at its second call (the
# "fault" swap); step 2 is torn for every rank (rank 0 rejects it before
# announcing); step 3 is a torn read only rank 1 meets; the last passes
# step 1's state dict itself (params=, announced to every rank) as step 5
SWAPS = (("adopt", 1, "adopted"), ("fault", 0, "fault"), ("torn", 2, "restore_failed"),
         ("torn_on_rank_1", 3, "restore_failed"), ("params", 5, "adopted"))
FLIP_REQUESTS = 24  # requests through one batcher across the registry flip


def swap_cases(group, path: str, dirs: dict) -> dict:
    """Two GCN engines over the same ranks, each from its ``--ckpt_dir``
    (step 0; A from ``dirs['a']``, B from ``dirs['b']``). Global rank 0
    saves steps 1 (``params1``), 2 (torn) and 3 (step 0's params) into A's
    directory and makes SWAPS on A, each followed by rows of every bucket;
    then a ModelRegistry holds A (now step 1) and B (step 0) behind one
    batcher, a client thread submits FLIP_REQUESTS requests and rank 0 flips
    to B midway. The followers run both engines' follow() in threads
    (``follow_all``). Every rank reports A's step, lineage and parameters."""
    from dgraph_tpu_torch.obs.metrics import Metrics
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.engine import follow_all
    from dgraph_tpu_torch.serve.errors import SwapRejected
    from dgraph_tpu_torch.serve.registry import ModelRegistry
    from dgraph_tpu_torch.train import checkpoint

    with open(path, "rb") as f:
        params1 = pickle.load(f)["params1"]
    built = []
    for name in ("a", "b"):
        cfg = Config(model="gcn", world_size=group.world_size, ckpt_dir=dirs[name])
        engine, batcher, _ = build_serving(cfg, comm=DistComm(group), device="cpu")
        if batcher is not None:
            batcher.stop()
        built.append(engine)
    a, b = built
    out = {"shared_lock": a._dispatch_lock is b._dispatch_lock}
    if group.rank != 0:
        calls = {"pre_swap": 0}

        def pre_swap():
            calls["pre_swap"] += 1
            if group.rank == 1 and calls["pre_swap"] == 2:
                raise RuntimeError("fault injected on rank 1 mid-swap")

        a.pre_swap = pre_swap
        real = checkpoint.restore_checkpoint

        def torn_read(ckpt_dir, template=None, step=None):
            if group.rank == 1 and step == 3:
                raise OSError("a torn read of step 3 on rank 1")
            return real(ckpt_dir, template, step)

        checkpoint.restore_checkpoint = torn_read
        try:
            out["dispatches"] = follow_all(a, b)
        finally:
            checkpoint.restore_checkpoint = real
        out["pre_swap_calls"] = calls["pre_swap"]
    else:
        torch_params = {k: torch.from_numpy(v) for k, v in params1.items()}
        checkpoint.save_checkpoint(dirs["a"], {"params": torch_params, "step": 1}, 1)
        checkpoint.save_checkpoint(dirs["a"], {"params": torch_params, "step": 2}, 2)
        for d, _, fs in os.walk(checkpoint.step_path(dirs["a"], 2)):
            for fn in fs:
                with open(os.path.join(d, fn), "r+b") as fh:
                    fh.truncate(3)
        state0 = checkpoint.restore_checkpoint(dirs["a"], step=0)
        checkpoint.save_checkpoint(dirs["a"], {"params": state0["params"], "step": 3}, 3)
        ptrs = {k: v.data_ptr() for k, v in a.model.state_dict().items()}
        try:
            a.warmup()
            b.warmup()
            out["full0"] = a.full_logits()
            out["rank_slot"] = a.rank_slot(np.arange(a.num_nodes))
            out["swaps"] = []
            for name, step, _ in SWAPS:
                try:
                    rec = (a.swap_params(params=torch_params, step=step) if name == "params"
                           else a.swap_params(step=step))
                except SwapRejected as e:
                    rec = e.record()
                full = a.full_logits()
                served = [(ids, a.infer(ids)) for ids in (
                    np.arange(min(n, a.num_nodes)) * 5 % a.num_nodes for n in a.ladder.sizes)]
                out["swaps"].append({"name": name, "rec": rec, "full": full,
                                     "served": served, "stages": dict(a.last_swap_s)})
            out["ptrs_kept"] = ptrs == {k: v.data_ptr() for k, v in a.model.state_dict().items()}
            out["full_b"] = b.full_logits()
            out["flip"] = _flip_traffic(a, b, ModelRegistry, MicroBatcher, Metrics)
        finally:
            a.stop()
            b.stop()
    out.update(serving_step=a.serving_step, lineage=a.lineage, forwards=a.forwards,
               forwards_b=b.forwards,
               params={k: v.numpy().copy() for k, v in a.model.state_dict().items()})
    return out


def _flip_traffic(a, b, ModelRegistry, MicroBatcher, Metrics, max_size: int = 64) -> dict:
    """Rank 0: a registry of A (active) and B behind one batcher; a client
    thread submits FLIP_REQUESTS requests one after another, and once half
    are answered the main thread activates B. Each reply with whether it was
    submitted after the flip returned."""
    reg = ModelRegistry()
    reg.register("a", a, activate=True)
    reg.register("b", b)
    batcher = MicroBatcher(reg, max_batch_size=4, max_delay_ms=1.0, registry=Metrics())
    replies, errors, flipped = [], [], threading.Event()
    half = threading.Event()

    def client():
        rng = np.random.default_rng(3)
        try:
            for i in range(FLIP_REQUESTS):
                ids = rng.choice(a.num_nodes, size=int(rng.integers(1, max_size + 1)),
                                 replace=False)
                after = flipped.is_set()
                replies.append((ids, after, batcher.submit(ids).result(timeout=120)))
                if i == FLIP_REQUESTS // 2:
                    half.set()
        except Exception as e:  # noqa: BLE001 — reported to the test
            errors.append(repr(e))
            half.set()

    t = threading.Thread(target=client)
    t.start()
    half.wait(120)
    reg.activate("b")
    flipped.set()
    t.join(120)
    batcher.stop()
    return {"replies": replies, "errors": errors, "alive": t.is_alive(),
            "active": reg.active_name, "record": reg.record()}


# --- live graph deltas (slice 9e) ------------------------------------------------

# the lowerings a delta case runs under, each in a run directory of its own
# (pallas_p2p through the transport's plain version: the split route)
DELTA_IMPLS = ("auto", "pallas_p2p")
DELTA_REQUESTS = 24  # requests a client thread submits across the appends
DELTA_APPEND_AFTER = (4, 12)  # replies answered before each append starts


def _delta_traffic(engine, batcher, inputs: dict, run_dir: str) -> dict:
    """Rank 0: a client thread submits DELTA_REQUESTS requests one after
    another, each over ids below the engine's ``num_nodes`` as it stands
    then (appended ids too, once served), while the main thread stages and
    installs each append of ``inputs['appends']`` after DELTA_APPEND_AFTER
    replies."""
    from dgraph_tpu_torch.serve import deltas

    replies, errors, answered = [], [], threading.Semaphore(0)

    def client():
        rng = np.random.default_rng(11)
        try:
            for _ in range(DELTA_REQUESTS):
                n = engine.num_nodes
                ids = rng.choice(n, size=int(rng.integers(1, 9)), replace=False)
                if n > 96:  # always one appended id once there are some
                    ids[0] = n - 1 - int(rng.integers(0, n - 96))
                    ids = np.unique(ids)
                replies.append((ids, batcher.submit(ids).result(timeout=120)))
                answered.release()
        except Exception as e:  # noqa: BLE001 — reported to the test
            errors.append(repr(e))
            for _ in DELTA_APPEND_AFTER:
                answered.release()

    t = threading.Thread(target=client)
    t.start()
    appended, seen = [], 0
    for after, (feats, edges) in zip(DELTA_APPEND_AFTER, inputs["appends"]):
        while seen < after:
            answered.acquire(timeout=120)
            seen += 1
        rec = deltas.append_delta(run_dir, feats, edges)
        ids = engine.append_vertices(feats)
        appended.append((rec["id_base"], ids))
    t.join(120)
    return {"replies": replies, "errors": errors, "alive": t.is_alive(), "appended": appended}


def _delta_case(group, run_dir: str, inputs: dict) -> dict:
    """Global rank 0 writes generation 0 (``init_world``, pad multiple
    ``inputs['pad']``); every rank builds its engine on it. Rank 0 warms
    it, serves traffic across two appends (the ``APPEND`` op), re-plans,
    adopts generation 1 (``build_engine(adopt_from=...)``: the followers
    build the new engine inside the old one's ``follow()``), warms it,
    flips a registry from the old engine to the new one under traffic
    (``_flip_traffic``), and stops both. Every rank reports its forwards,
    its successors' and the follower threads left."""
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.obs.metrics import Metrics
    from dgraph_tpu_torch.serve import deltas
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.bucketing import BucketLadder
    from dgraph_tpu_torch.serve.registry import ModelRegistry

    edges, feats = inputs["graph"]
    if group.global_rank == 0:
        deltas.init_world(run_dir, edges, feats, world_size=group.world_size,
                          pad_multiple=inputs["pad"])
    group.barrier()
    model = GCN(feats.shape[1], 8, 3, DistComm(group), num_layers=2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inputs["gcn"].items()})
    eng0 = deltas.build_engine(run_dir, model, add_symmetric_norm=True, device="cpu",
                               ladder=BucketLadder((8,)), registry=Metrics())
    out = {"generation0": eng0.generation, "halo_impl": eng0.halo_impl}
    x_ptr = eng0._batch["x"].data_ptr()
    if group.rank != 0:
        out["dispatches"] = eng0.follow()
        succ = eng0.successors
        out.update(forwards=eng0.forwards, successor_forwards=[e.forwards for e in succ],
                   successor_generations=[e.generation for e in succ],
                   num_nodes=eng0.num_nodes, x_ptr_kept=eng0._batch["x"].data_ptr() == x_ptr,
                   follow_threads=[t.name for t in threading.enumerate()
                                   if t.name.startswith("serve-follow")])
        return out
    try:
        eng0.warmup()
        out["full_before"] = eng0.full_logits()
        out["free_before"] = eng0.free_pad_slots()
        batcher = MicroBatcher(eng0, max_batch_size=4, max_delay_ms=1.0, registry=Metrics())
        try:
            out["append"] = _delta_traffic(eng0, batcher, inputs, run_dir)
        finally:
            batcher.stop()
        out["free_after"] = eng0.free_pad_slots()
        out["full_after"] = eng0.full_logits()
        out["x_ptr_kept"] = eng0._batch["x"].data_ptr() == x_ptr
        out["rank_slot0"] = eng0.rank_slot(np.arange(eng0.num_nodes))
        out["world1"] = deltas.replan(run_dir)
        eng1 = deltas.build_engine(run_dir, eng0.model, adopt_from=eng0,
                                   add_symmetric_norm=True, registry=Metrics())
        out["generation1"] = eng1.generation
        try:
            eng1.warmup()
            out["full1"] = eng1.full_logits()
            out["rank_slot1"] = eng1.rank_slot(np.arange(eng1.num_nodes))
            out["flip"] = _flip_traffic(eng0, eng1, ModelRegistry, MicroBatcher, Metrics,
                                        max_size=8)
            eng0.stop()
            out["full1_after_stop"] = eng1.full_logits()
        finally:
            eng1.stop()
        out["forwards1"] = eng1.forwards
    finally:
        eng0.stop()
    out["forwards"] = eng0.forwards
    return out


def delta_cases(group, path: str, root: str) -> dict:
    """:func:`_delta_case` under each of DELTA_IMPLS, in ``root/<impl>``."""
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {}
    try:
        config.use_pallas_p2p = True
        for impl in DELTA_IMPLS:
            config.halo_impl = impl
            out[impl] = _delta_case(group, os.path.join(root, impl), inputs)
    finally:
        config.halo_impl, config.use_pallas_p2p = "auto", None
    return out
