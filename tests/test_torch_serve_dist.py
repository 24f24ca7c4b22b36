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
"""

import json
import multiprocessing
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
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.serve.__main__ import Config
from dgraph_tpu_torch.weights import params_from_jax

TOL = 1e-5
TIMEOUT = 300
LOST_BOUND_S = 20.0  # the lost-rank launch's group timeout


def _jax_side(model: str, W: int):
    """(flax params, the reference's full_logits [W, n_pad, C], its
    rank_slot of every vertex) at W ranks on the CLI's default graph."""
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
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    jmodel = cls(cfg.hidden, cfg.num_classes,
                 comm=Communicator.init_process_group("tpu", world_size=W))
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


def test_cli_over_ranks_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    p = _cli("--world_size", "2")
    assert p.returncode != 0 and "no CUDA device is available" in p.stderr
