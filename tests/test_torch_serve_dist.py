"""Serving over W graph ranks on the CPU, held against the reference.

The port's side runs in spawned gloo processes (``tests/torch_serve_ranks.py``,
which imports no JAX): one spawn per world size with every case inside it,
one more for a rank lost mid-forward, and the CLI at two ranks. The
reference's side runs here on the 8-device virtual mesh, with flax weights
carried to the port by ``params_from_jax``.

The reference's ``ServeEngine.infer`` is not the oracle: on the installed
JAX it raises ``ShardingTypeError`` at its row gather (a failure the JAX
package keeps). Its ``full_logits()`` runs: the oracle is that, at the same
W on ``jax.devices()[:W]``, indexed by the reference's ``rank_slot``.

- GCN and GraphSAGE at W = 2 and 4 under each of the five lowerings pinned
  (``pallas_p2p`` through the transport's plain version): served rows
  (every bucket's edges, one at a time, and concurrent requests through
  the batcher) equal the port's gathered ``full_logits()`` bit for bit,
  and ``full_logits()`` is within 1e-5 of the reference's (the split
  lowerings group the owner-side sums per subset); the port's partition
  is the reference's (the same ``rank_slot``); every follower ran every
  dispatch rank 0 announced and left ``follow()`` at stop.
- More threads than cores dispatch on rank 0 at once (the batcher's
  worker and a caller share the engine there): the dispatch lock keeps
  each dispatch's collectives whole, every reply bit for bit.
- A fault on rank 1 before its forward is retried on every rank and the
  request served; ``degrade_after`` such requests degrade rank 0's engine,
  which sheds with ``QueueFull``; ``reset_degraded`` re-admits.
- A rank that exits mid-forward fails the request within the group
  timeout (``LOST_BOUND_S``) and every later one at once, and the engine
  degrades.
- ``python -m dgraph_tpu_torch.serve --device cpu --world_size 2
  --selftest`` exits 0 with ``world_size`` 2 in its record; without
  ``--device cpu`` and with no card it raises.
- From a checkpoint at W = 2: both ranks restore the step global rank 0
  took and hold bit-equal parameters, within 1e-5 of the reference's
  restore served on its 2-device mesh; the CLI seeds an empty
  ``--ckpt_dir`` once and a second run writes nothing.
- From a plan cache at W = 2: cold, warm and one-shard-repair turns serve
  ``full_logits()``'s bits within 1e-5 of the reference's, only global rank
  0 writes, a follower's bad shard raises on every rank; the CLI's selftest
  runs through a temporary ``plans/`` and an explicit ``--plan_cache``.
- Checkpoint hot swap at W = 2 (``torch_serve_ranks.swap_cases``): an
  adopted swap to step 1 leaves both ranks on step 1's parameters, its
  ``full_logits()`` within 1e-5 of the reference's on step 1; a ``pre_swap``
  fault on rank 1 alone, a torn step and a torn read only rank 1 meets are
  rolled back on both ranks, the served bits unchanged; then a registry
  flips between two engines on the same two ranks under traffic through
  one batcher: no hang, each reply the rows of the engine that served it.
- Live graph deltas at W = 2 (``torch_serve_ranks.delta_cases``, under the
  default lowering and ``pallas_p2p``): appends over the ``APPEND`` op
  under traffic, each reply wholly one graph's rows; a re-plan on rank 0,
  the W-rank adoption (``ADOPT``) and a registry flip under traffic with no
  hang; generation 1 within 1e-4 of the reference's ``full_logits()`` at
  W = 2 on the same run directory; no follower thread or rank process left.
"""

import json
import multiprocessing
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import torch_serve_ranks
from dgraph_tpu.comm import Communicator
from dgraph_tpu.comm.mesh import make_graph_mesh
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.data import synthetic as jax_synthetic
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models import GraphSAGE as JaxSAGE
from dgraph_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgraph_tpu.train import checkpoint as ref_ckpt
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.serve.__main__ import Config
from dgraph_tpu_torch.train import checkpoint as port_ckpt
from dgraph_tpu_torch.weights import params_from_jax

TOL = 1e-5
TIMEOUT = 300
LOST_BOUND_S = 20.0  # the lost-rank launch's group timeout


def _jax_side(model: str, W: int, ckpt_dir: str = "", scale: float = 1.0):
    """(flax params, the reference's full_logits [W, n_pad, C], its
    rank_slot of every vertex) at W ranks on the CLI's default graph; with
    ``ckpt_dir`` the params are saved there at step 0 (the reference's
    ``save_checkpoint``) and the engine is built from what its
    ``restore_checkpoint`` hands back; with ``scale`` every leaf of the
    params is scaled first (the serve selftest's step 1)."""
    cfg = Config(model=model)
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
        avg_degree=cfg.avg_degree, seed=cfg.seed)
    ref = JaxGraph.from_global(data["edge_index"], data["features"], data["labels"],
                               data["masks"], W, partition_method=cfg.partition,
                               add_symmetric_norm=model == "gcn", tune="off")
    cls = JaxGCN if model == "gcn" else JaxSAGE
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    args = [jnp.asarray(ref.features[0]), plan0]
    if model == "gcn":
        args.append(jnp.asarray(ref.edge_weight[0]))
    single = cls(cfg.hidden, cfg.num_classes, comm=Communicator.init_process_group("single"))
    params = single.init(jax.random.key(3), *args)
    if scale != 1.0:
        params = jax.tree.map(lambda a: np.asarray(a) * np.float32(scale), params)
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    jmodel = cls(cfg.hidden, cfg.num_classes,
                 comm=Communicator.init_process_group("tpu", world_size=W))
    if ckpt_dir:
        # from_checkpoint's body (engine.py:171-201): restore_checkpoint, then
        # from_distributed_graph. Called as one, it raises at W > 1 on the
        # installed JAX: orbax commits every restored array to device 0,
        # which the W-device jit refuses; the leaves go in as numpy instead
        ref_ckpt.save_checkpoint(ckpt_dir, {"params": params, "step": 0}, 0)
        params = jax.tree.map(np.asarray, ref_ckpt.restore_checkpoint(ckpt_dir)["params"])
    engine = JaxServeEngine.from_distributed_graph(jmodel, mesh, ref, params)
    full = engine.full_logits()
    return params, full, engine.rank_slot(np.arange(cfg.num_nodes))


def _assert_bits_equal(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, msg
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=msg)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{W: (the reference's side per model, per-rank results)} — one spawn
    per world size."""
    out = {}
    for W in (2, 4):
        ref = {m: _jax_side(m, W) for m in torch_serve_ranks.MODELS}
        inputs = {m: {k: v.numpy() for k, v in params_from_jax(ref[m][0]).items()}
                  for m in torch_serve_ranks.MODELS}
        path = tmp_path_factory.mktemp(f"serve_w{W}") / "inputs.pkl"
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        res = launch(torch_serve_ranks.run_cases, W, str(path), device="cpu",
                     timeout=TIMEOUT, threads=1)
        out[W] = (ref, res)
    return out


CASES = [(W, m, impl) for W in (2, 4) for m in torch_serve_ranks.MODELS
         for impl in torch_serve_ranks.IMPLS]


@pytest.mark.parametrize("W, model, impl", CASES,
                         ids=[f"W{W}-{m}-{i}" for W, m, i in CASES])
def test_served_rows_are_gathered_full_logits_and_match_reference(ranks, W, model, impl):
    ref, res = ranks[W]
    _, ref_full, (ref_rank, ref_slot) = ref[model]
    got = res[0][(model, impl)]
    assert all(r[(model, impl)]["halo_impl"] == impl for r in res)
    full = got["full"]
    assert full.shape == ref_full.shape and np.isfinite(full).all()
    rank, slot = got["rank_slot"]
    np.testing.assert_array_equal(rank, ref_rank)
    np.testing.assert_array_equal(slot, ref_slot)
    np.testing.assert_allclose(full[rank, slot], ref_full[ref_rank, ref_slot], rtol=TOL,
                               atol=TOL)
    assert len(got["served"]) == len(torch_serve_ranks.SIZES) + len(torch_serve_ranks.BATCHED)
    for ids, out in got["served"]:
        _assert_bits_equal(out, full[rank[ids], slot[ids]], f"{len(ids)} ids")
    # every rank ran each forward rank 0 did: the warmup's buckets and full
    # logits, the full logits, SIZES and the batcher's batches
    want = len(torch_serve_ranks.SIZES) + 6 + int(got["batches"])
    assert [r[(model, impl)]["forwards"] for r in res] == [want] * W
    assert [r[(model, impl)]["dispatches"] for r in res[1:]] == [want] * (W - 1)


@pytest.mark.parametrize("W", (2, 4))
def test_follower_fault_before_forward_is_retried_then_degrades(ranks, W):
    _, res = ranks[W]
    got = res[0]["fault"]
    rank, slot = got["rank_slot"]
    _assert_bits_equal(got["served"], got["full"][rank, slot], "retried request")
    _assert_bits_equal(got["after_reset"], got["full"][rank, slot], "after reset_degraded")
    assert got["retries"] == 1.0
    assert len(got["errors"]) == 3 and all("rank(s) [1]" in e for e in got["errors"])
    assert got["degraded"] and got["shed"]
    # two requests served and the full logits: three forwards on every rank
    assert [r["fault"]["forwards"] for r in res] == [3] * W
    assert res[1]["fault"]["attempts"] == 12  # 1 + 1 + 3 x 3 + 1 bucket attempts
    assert [r["fault"]["dispatches"] for r in res[1:]] == [13] * (W - 1)


@pytest.mark.parametrize("W", (2, 4))
def test_concurrent_dispatches_on_rank_0_stay_whole(ranks, W):
    """More threads than cores dispatching on rank 0 at once: every reply is
    the full logits' rows (or the full logits) bit for bit, no thread hangs,
    and every rank ran the same forwards."""
    _, res = ranks[W]
    got = res[0]["stress"]
    assert got["errors"] == [] and got["alive"] == 0
    n = torch_serve_ranks.STRESS_THREADS
    assert len(got["results"]) == n * (torch_serve_ranks.STRESS_CALLS + 1)
    rank, slot = got["rank_slot"]
    for ids, out in got["results"]:
        want = got["full"] if ids is None else got["full"][rank[ids], slot[ids]]
        _assert_bits_equal(out, want)
    want = 1 + n * (torch_serve_ranks.STRESS_CALLS + 1)
    assert [r["stress"]["forwards"] for r in res] == [want] * W
    assert [r["stress"]["dispatches"] for r in res[1:]] == [want] * (W - 1)


def _live_ranks() -> list:
    """The rank processes ``launch`` started that are still alive."""
    return [p.name for p in multiprocessing.active_children() if p.name.startswith("rank")]


def test_no_rank_process_is_left_after_stop(ranks):
    assert _live_ranks() == []


def test_lost_rank_fails_the_request_within_the_bound(tmp_path):
    params = _jax_side("gcn", 2)[0]
    path, record = tmp_path / "inputs.pkl", tmp_path / "lost.pkl"
    with open(path, "wb") as f:
        pickle.dump({"gcn": {k: v.numpy() for k, v in params_from_jax(params).items()}}, f)
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        launch(torch_serve_ranks.lost_rank, 2, str(path), str(record), device="cpu",
               timeout=TIMEOUT, threads=1, group_timeout=LOST_BOUND_S)
    with open(record, "rb") as f:
        rec = pickle.load(f)
    kinds = [k for k, _ in rec["failures"]]
    assert kinds == ["RankLost"] * 3 + ["QueueFull"] and rec["degraded"]
    first, *later = (s for _, s in rec["failures"])
    assert first < LOST_BOUND_S and all(s < 1.0 for s in later), rec
    assert _live_ranks() == []


def _cli(*args, **kw):
    return subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.serve", *args],
                          capture_output=True, text=True, timeout=TIMEOUT, **kw)


def test_cli_selftest_at_two_cpu_ranks():
    p = _cli("--device", "cpu", "--world_size", "2", "--selftest", "--requests", "8")
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert rec["kind"] == "serve_health" and "error" not in rec
    assert rec["world_size"] == 2 and rec["halo_impl"] == "all_to_all"
    assert rec["metrics"]["counters"]["serve.infer_calls"] >= 8
    # through a temporary plan cache beside the temporary checkpoint dir
    assert rec["plan_cache"] == os.path.join(os.path.dirname(rec["ckpt_dir"]), "plans")
    # the swap leg: step 1 adopted on both ranks, then a swap faulted on
    # rank 1 alone rolled back
    swaps = [r for r in rec["lineage"] if r["event"] == "swap"]
    assert [(r["adopted"], r["rolled_back"], r["step"]) for r in swaps] == [
        (True, False, 1), (False, True, 0)]
    assert swaps[1]["reason"] == "fault" and "[1]" in swaps[1]["detail"]
    assert rec["serving_steps"] == [1, 1] and rec["restored_steps"] == [0, 0]
    assert rec["metrics"]["counters"]["serve.swaps_adopted"] == 1


def test_cli_over_ranks_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    p = _cli("--world_size", "2")
    assert p.returncode != 0 and "no CUDA device is available" in p.stderr


# --- serving from a checkpoint ------------------------------------------------


def test_two_ranks_serve_from_a_checkpoint_as_the_reference_does(tmp_path):
    """The reference saves its flax params at step 0 and serves what it
    restores on a 2-device mesh (``_jax_side``); the port's ranks serve the
    same params (restored raw, ``params_from_jax``, saved by the port) through
    ``--ckpt_dir``: every rank restores step 0 and holds bit-equal
    parameters, the full logits are within TOL of the reference's, the
    served rows are the gathered ``full_logits()``'s bits."""
    W, dirs, ref = 2, {}, {}
    for model in torch_serve_ranks.MODELS:
        ref[model] = _jax_side(model, W, str(tmp_path / f"ref_{model}"))
        raw = ref_ckpt.restore_checkpoint(str(tmp_path / f"ref_{model}"))
        dirs[model] = str(tmp_path / f"port_{model}")
        port_ckpt.save_checkpoint(dirs[model], {"params": params_from_jax(raw["params"]),
                                                "step": int(raw["step"])}, 0)
    res = launch(torch_serve_ranks.ckpt_cases, W, dirs, device="cpu", timeout=TIMEOUT,
                 threads=1)
    for model in torch_serve_ranks.MODELS:
        _, ref_full, (ref_rank, ref_slot) = ref[model]
        got = res[0][model]
        assert [r[model]["restored_step"] for r in res] == [0] * W
        assert got["lineage"] == [{"kind": "serve_rollover", "event": "restore",
                                   "ckpt_dir": dirs[model], "step": 0, "adopted": True}]
        for r in res[1:]:
            assert set(r[model]["params"]) == set(got["params"])
            for k, v in got["params"].items():
                _assert_bits_equal(r[model]["params"][k], v, k)
        rank, slot = got["rank_slot"]
        np.testing.assert_array_equal(rank, ref_rank)
        np.testing.assert_allclose(got["full"][rank, slot], ref_full[ref_rank, ref_slot],
                                   rtol=TOL, atol=TOL)
        for ids, out in got["served"]:
            _assert_bits_equal(out, got["full"][rank[ids], slot[ids]], f"{model} {len(ids)}")
        assert port_ckpt.all_steps(dirs[model]) == [0]


def _tree_state(root) -> dict:
    return {str(p.relative_to(root)): p.stat().st_mtime_ns for p in sorted(root.rglob("*"))}


def test_cli_seeds_an_empty_ckpt_dir_once_at_two_ranks(tmp_path):
    """``--ckpt_dir`` on an empty dir: step 0 seeded, both ranks restore it
    and serve full_logits()'s bits; a second run on the same dir restores
    the same step and writes nothing."""
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    recs = []
    for run in range(2):
        p = _cli("--device", "cpu", "--world_size", "2", "--selftest", "--requests", "6",
                 "--ckpt_dir", str(ckpt))
        assert p.returncode == 0, p.stderr[-3000:]
        recs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        if run == 0:
            seeded = _tree_state(ckpt)
            assert port_ckpt.all_steps(str(ckpt)) == [0]
    assert _tree_state(ckpt) == seeded
    for rec in recs:
        assert "error" not in rec and rec["world_size"] == 2
        assert rec["restored_step"] == 0 and rec["restored_steps"] == [0, 0]
        assert rec["ckpt_dir"] == str(ckpt) and rec["lineage"][0]["step"] == 0


# --- serving from a plan cache --------------------------------------------------


def test_two_ranks_serve_from_a_plan_cache_cold_warm_then_repair(tmp_path):
    """``--plan_cache`` at W = 2 (``torch_serve_ranks.plan_cache_cases``):
    in every turn (cold, warm, one shard truncated) each rank's plan equals
    the uncached build leaf for leaf, rank 0's ``full_logits()`` is within
    TOL of the reference's and its served rows are their bits; only global
    rank 0 writes under the cache: the whole artifact cold, nothing warm,
    the truncated shard (bit-identical again), the manifest and the layout
    sidecar (the same bytes) in the repair. A follower that meets a bad shard makes every rank raise, and
    nobody writes. The directory is the reference's ``plan_<key>``."""
    from dgraph_tpu_torch import plan_shards
    from dgraph_tpu_torch.data import DistributedGraph

    W, cfg = 2, Config(model="gcn")
    params, ref_full, (ref_rank, ref_slot) = _jax_side("gcn", W)
    path, cache = tmp_path / "inputs.pkl", tmp_path / "plans"
    with open(path, "wb") as f:
        pickle.dump({"gcn": {k: v.numpy() for k, v in params_from_jax(params).items()}}, f)
    res = launch(torch_serve_ranks.plan_cache_cases, W, str(path), str(cache), device="cpu",
                 timeout=TIMEOUT, threads=1)
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
        avg_degree=cfg.avg_degree, seed=cfg.seed)
    args = (data["edge_index"], data["features"], data["labels"], data["masks"], W)
    plain = torch_serve_ranks.plan_leaves(DistributedGraph.from_global(
        *args, partition_method=cfg.partition, add_symmetric_norm=True).plan)
    JaxGraph.from_global(*args, partition_method=cfg.partition, add_symmetric_norm=True,
                         plan_cache_dir=str(tmp_path / "ref"), tune="off")
    (ref_dir,) = [p.name for p in (tmp_path / "ref").iterdir()]
    shard = plan_shards.shard_filename(torch_serve_ranks.REPAIRED_SHARD)
    cold = res[0]["turns"]["cold"]["manifest"]
    for turn in torch_serve_ranks.PLAN_CACHE_TURNS:
        front = res[0]["turns"][turn]
        assert front["plan_dir"] == ref_dir, turn
        for rank in range(W):
            got = res[rank]["turns"][turn]
            assert set(got["plan"]) == set(plain), (turn, rank)
            for k, v in plain.items():
                np.testing.assert_array_equal(got["plan"][k], v, err_msg=f"{turn} {rank} {k}")
            if rank:
                assert got["writes"] == [] and got["dispatches"] == front["forwards"], turn
        rank, slot = front["rank_slot"]
        np.testing.assert_array_equal(rank, ref_rank)
        np.testing.assert_allclose(front["full"][rank, slot], ref_full[ref_rank, ref_slot],
                                   rtol=TOL, atol=TOL)
        for ids, out in front["served"]:
            _assert_bits_equal(out, front["full"][rank[ids], slot[ids]], f"{turn} {len(ids)}")
        assert front["manifest"]["complete"]
        assert front["manifest"]["shards"] == cold["shards"], turn  # same bytes every turn
        files = {os.path.basename(p).split(".tmp")[0] for _, p in front["writes"]
                 if os.sep in p}
        if turn == "cold":
            assert files == {plan_shards.shard_filename(r) for r in range(W)} | {
                plan_shards.MANIFEST_NAME, plan_shards.LAYOUT_NAME}, files
        elif turn == "warm":
            assert front["writes"] == []
        else:
            # the named shard alone; the build's finalize rewrites the layout
            # sidecar with its bytes, as the reference's does
            assert files == {shard, plan_shards.MANIFEST_NAME, plan_shards.LAYOUT_NAME}, files
            assert front["manifest"]["layout"] == cold["layout"]
    assert res[0]["bad_shard"].startswith("RuntimeError") and "[1] failed" in res[0]["bad_shard"]
    assert res[1]["bad_shard"].startswith("PlanShardError") and "checksum" in res[1]["bad_shard"]
    assert res[0]["bad_shard_writes"] == [] and res[1]["bad_shard_writes"] == []


def test_cli_serves_from_an_explicit_plan_cache_at_two_ranks(tmp_path):
    """``--plan_cache <dir>`` at two ranks: the record names it, and it holds
    one complete W = 2 artifact."""
    from dgraph_tpu_torch import plan_shards

    cache = tmp_path / "plans"
    p = _cli("--device", "cpu", "--world_size", "2", "--selftest", "--requests", "4",
             "--plan_cache", str(cache))
    assert p.returncode == 0, p.stderr[-3000:]
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    assert "error" not in rec and rec["plan_cache"] == str(cache)
    (plan_dir,) = list(cache.iterdir())
    man = plan_shards.read_manifest(str(plan_dir))
    assert man["complete"] and man["world_size"] == 2 and not plan_shards.bad_shards(
        str(plan_dir), man)


# --- checkpoint hot swap and the registry flip --------------------------------


def test_two_ranks_swap_roll_back_and_flip_between_two_engines(tmp_path):
    W, scale = 2, 1.0625
    p0, ref_full0, (ref_rank, ref_slot) = _jax_side("gcn", W)
    p1, ref_full1, _ = _jax_side("gcn", W, scale=scale)
    dirs = {k: str(tmp_path / k) for k in ("a", "b")}
    for d in dirs.values():
        port_ckpt.save_checkpoint(d, {"params": params_from_jax(p0), "step": 0}, 0)
    want1 = {k: v.numpy() for k, v in params_from_jax(p1).items()}
    path = tmp_path / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params1": want1}, f)
    res = launch(torch_serve_ranks.swap_cases, W, str(path), dirs, device="cpu",
                 timeout=TIMEOUT, threads=1)
    front, follower = res
    assert front["shared_lock"] and follower["shared_lock"]
    rank, slot = front["rank_slot"]
    np.testing.assert_allclose(front["full0"][rank, slot], ref_full0[ref_rank, ref_slot],
                               rtol=TOL, atol=TOL)
    adopt, *rejected, by_params = front["swaps"]
    assert adopt["rec"]["adopted"] and adopt["rec"]["step"] == 1, adopt["rec"]
    full1 = adopt["full"]
    np.testing.assert_allclose(full1[rank, slot], ref_full1[ref_rank, ref_slot], rtol=TOL,
                               atol=TOL)
    assert not np.array_equal(full1, front["full0"])
    assert set(adopt["stages"]) >= {"restore", "stage", "validate", "adopt", "agree"}
    for (name, step, reason), case in zip(torch_serve_ranks.SWAPS[1:-1], rejected):
        rec = case["rec"]
        assert rec["error"] == "swap_rejected" and rec["reason"] == reason, (name, rec)
        assert not rec.get("adopted"), name
        if name == "torn":
            # rank 0 rejects a torn step before announcing it: the error says
            # nothing was staged (rolled_back False), as the reference's does
            assert not rec["rolled_back"]
        else:
            assert rec["rolled_back"] and "rank(s) [1]" in rec["detail"], (name, rec["detail"])
        _assert_bits_equal(case["full"], full1, name)
    # the same state dict again, by params=: adopted on both ranks, the bits kept
    assert by_params["rec"]["adopted"] and by_params["rec"]["ckpt_dir"] is None
    _assert_bits_equal(by_params["full"], full1, "params=")
    for case in front["swaps"]:
        for ids, out in case["served"]:
            _assert_bits_equal(out, case["full"][rank[ids], slot[ids]], case["name"])
    assert front["ptrs_kept"]
    # both ranks hold step 1's parameters, bit for bit (the last as "step 5")
    assert [r["serving_step"] for r in res] == [5, 5]
    for r in res:
        assert set(r["params"]) == set(want1)
        for k, v in want1.items():
            _assert_bits_equal(r["params"][k], v, k)
    # one lineage record an attempt: rank 0 every swap, rank 1 the three
    # it was announced (a torn step never leaves rank 0)
    assert [(x.get("reason"), x["rolled_back"]) for x in front["lineage"][1:]] == [
        (None, False), ("fault", True), ("restore_failed", True), ("restore_failed", True),
        (None, False)]
    assert [(x.get("reason"), x["step"]) for x in follower["lineage"][1:]] == [
        (None, 1), ("fault", 0), ("restore_failed", 3), (None, 5)]
    assert follower["pre_swap_calls"] == 3  # adopt, fault (raising), params=
    assert front["forwards"] == follower["forwards"]
    # the registry flip: every reply one engine's rows, B's after the flip
    flip = front["flip"]
    assert flip["errors"] == [] and not flip["alive"] and flip["active"] == "b"
    assert len(flip["replies"]) == torch_serve_ranks.FLIP_REQUESTS
    served_by = []
    for ids, after, out in flip["replies"]:
        on_a = np.array_equal(out, full1[rank[ids], slot[ids]])
        on_b = np.array_equal(out, front["full_b"][rank[ids], slot[ids]])
        assert on_a != on_b and (on_b or not after), (len(ids), after)
        served_by.append("a" if on_a else "b")
    assert "a" in served_by and served_by[-1] == "b"
    assert follower["dispatches"][1] == follower["forwards_b"] == front["forwards_b"]
    assert _live_ranks() == []


# --- live graph deltas over two ranks -------------------------------------------


def test_two_ranks_append_replan_adopt_and_flip_under_traffic(tmp_path):
    """``torch_serve_ranks.delta_cases`` under the default lowering and
    ``pallas_p2p``: two appends (the ``APPEND`` op) under a client thread's
    traffic, each reply wholly the rows of the graph it ran on; a re-plan on
    rank 0, then the W-rank adoption (``ADOPT``) and a registry flip under
    traffic with no hang, every reply wholly one engine's rows; generation
    1's ``full_logits()`` within 1e-4 of the reference's at W = 2 on the
    same run directory; the old engine stopped, every follower thread
    returned, no rank process left."""
    from dgraph_tpu.serve import deltas as ref_deltas
    from test_torch_deltas import PAD, V, _appends, _graph, _ref_engine, flax_gcn_params

    W = 2
    params = flax_gcn_params()
    data = _graph()
    inputs = {"gcn": {k: v.numpy() for k, v in params_from_jax(params).items()},
              "graph": (np.asarray(data["edge_index"]), np.asarray(data["features"])),
              "appends": _appends(), "pad": PAD}
    path, root = tmp_path / "inputs.pkl", tmp_path / "runs"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    res = launch(torch_serve_ranks.delta_cases, W, str(path), str(root), device="cpu",
                 timeout=TIMEOUT, threads=1)
    assert _live_ranks() == []
    n_new = sum(len(f) for f, _ in inputs["appends"])
    for impl in torch_serve_ranks.DELTA_IMPLS:
        front, follower = (r[impl] for r in res)
        assert front["halo_impl"] == follower["halo_impl"] == (
            "all_to_all" if impl == "auto" else impl)
        app = front["append"]
        assert app["errors"] == [] and not app["alive"], app["errors"]
        assert len(app["replies"]) == torch_serve_ranks.DELTA_REQUESTS
        assert [b for b, _ in app["appended"]] == [V, V + 4]
        assert front["free_before"] - front["free_after"] == n_new
        rank, slot = front["rank_slot0"]
        full = front["full_after"]
        saw_new = False
        for ids, out in app["replies"]:
            _assert_bits_equal(out, full[rank[ids], slot[ids]], f"{impl}: {ids}")
            saw_new |= bool((ids >= V).any())
        assert saw_new
        # old rows keep their bits across the appends; the ids were served at once
        rb, sb = rank[:V], slot[:V]
        _assert_bits_equal(front["full_before"][rb, sb], full[rb, sb], "old rows")
        assert front["x_ptr_kept"] and follower["x_ptr_kept"]
        assert follower["num_nodes"] == V + n_new  # the follower's id maps grew too
        # the adoption: generation 1 on every rank, placement kept
        assert front["world1"]["generation"] == front["generation1"] == 1
        assert follower["successor_generations"] == [1]
        rank1, slot1 = front["rank_slot1"]
        np.testing.assert_array_equal(rank1, rank)
        np.testing.assert_array_equal(slot1, slot)
        full1 = front["full1"]
        _assert_bits_equal(front["full1_after_stop"], full1, "the new engine after the old stopped")
        ref = _ref_engine(str(root / impl), params, W=W)
        assert ref.generation == 1
        r, s = ref.rank_slot(np.arange(V + n_new))
        np.testing.assert_allclose(full1[rank1, slot1], ref.full_logits()[r, s], rtol=1e-4,
                                   atol=1e-4)
        flip = front["flip"]
        assert flip["errors"] == [] and not flip["alive"] and flip["active"] == "b"
        served_by = []
        for ids, after, out in flip["replies"]:
            on_a = np.array_equal(out, full[rank[ids], slot[ids]])
            on_b = np.array_equal(out, full1[rank1[ids], slot1[ids]])
            assert on_a != on_b and (on_b or not after), (impl, ids, after)
            served_by.append("a" if on_a else "b")
        assert "a" in served_by and served_by[-1] == "b"
        assert follower["forwards"] == front["forwards"]
        assert follower["successor_forwards"] == [front["forwards1"]]
        assert follower["follow_threads"] == []
    assert ref_deltas.read_world(str(root / "auto"))["deltas_adopted"] == 2
