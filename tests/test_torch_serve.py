"""The port's serving stack on the CPU (``build_serving(device="cpu")``),
held against the JAX model's forward on the same graph and weights.

The JAX ``ServeEngine.infer`` is not the oracle: on the installed JAX it
raises ``ShardingTypeError`` at its row gather (a known failure the JAX
package keeps). The oracle is the flax model's forward (``model.apply``
with ``SingleComm``) indexed by the same (rank, slot) map. Served rows must
equal the port's own ``full_logits()`` bit for bit, and the JAX forward
within 1e-4.

From a checkpoint: the reference's ``ServeEngine.from_checkpoint`` on its
own save of the flax params is the oracle (within 1e-4) of the port served
through ``--ckpt_dir`` on the same params, saved by the port; and a torn
newer step is quarantined while the older one serves the same bits.
"""

import threading
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from dgraph_tpu.comm import Communicator
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.data import synthetic as jax_synthetic
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models import GraphSAGE as JaxSAGE
from dgraph_tpu_torch.serve.__main__ import Config, build_serving, main
from dgraph_tpu_torch.serve.batcher import MicroBatcher
from dgraph_tpu_torch.serve.errors import (
    EngineStopped,
    QueueFull,
    RequestTimeout,
    RequestTooLarge,
)
from dgraph_tpu_torch.weights import params_from_jax
from test_torch_checkpoint import truncate_step

TOL = 1e-4


def _serving(model: str, **kw):
    """Port engine + batcher, with flax-initialised weights carried over,
    and the JAX forward's logits in the original vertex numbering."""
    cfg = Config(model=model, num_nodes=400, max_bucket=64, **kw)
    engine, batcher, g = build_serving(cfg, device="cpu")
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes,
        feat_dim=cfg.feat_dim, avg_degree=cfg.avg_degree, seed=cfg.seed)
    ref = JaxGraph.from_global(
        data["edge_index"], data["features"], data["labels"], data["masks"], 1,
        partition_method=cfg.partition, add_symmetric_norm=model == "gcn", tune="off")
    comm = Communicator.init_process_group("single")
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    args = [jnp.asarray(ref.features[0]), plan0]
    if model == "gcn":
        jmodel = JaxGCN(cfg.hidden, cfg.num_classes, comm=comm)
        args.append(jnp.asarray(ref.edge_weight[0]))
    else:
        jmodel = JaxSAGE(cfg.hidden, cfg.num_classes, comm=comm)
    params = jmodel.init(jax.random.key(3), *args)
    engine.model.load_state_dict(params_from_jax(params))
    jax_logits = np.asarray(jmodel.apply(params, *args))  # [n_pad, C], rank 0
    perm = ref.ren.perm  # original id -> renumbered id
    rank = ref.ren.partition[perm]
    slot = perm - ref.ren.offsets[rank]
    return engine, batcher, jax_logits[slot], rank


@pytest.fixture(scope="module")
def gcn():
    engine, batcher, ref_rows, ref_rank = _serving("gcn")
    yield engine, batcher, ref_rows, ref_rank
    batcher.stop()


def _mixed_requests(engine, n_requests, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        n = int(rng.integers(1, engine.ladder.max_size + 1))
        yield rng.choice(engine.num_nodes, size=n, replace=False)


def test_engine_serves_full_logits_rows_and_matches_jax(gcn):
    engine, _, ref_rows, ref_rank = gcn
    engine.warmup()
    full = engine.full_logits()
    assert full.shape == (1, engine._plan.n_src_pad, 4) and full.dtype == np.float32
    r, s = engine.rank_slot(np.arange(engine.num_nodes))
    np.testing.assert_array_equal(r, ref_rank)
    np.testing.assert_allclose(full[r, s], ref_rows, rtol=TOL, atol=TOL)
    for ids in _mixed_requests(engine, 12):
        out = engine.infer(ids)
        r, s = engine.rank_slot(ids)
        np.testing.assert_array_equal(out, full[r, s])
        np.testing.assert_allclose(out, ref_rows[ids], rtol=TOL, atol=TOL)


def test_batcher_serves_concurrent_mixed_requests(gcn):
    engine, batcher, ref_rows, _ = gcn
    full = engine.full_logits()
    reqs = list(_mixed_requests(engine, 16, seed=1))
    futures = [batcher.submit(ids) for ids in reqs]
    for ids, fut in zip(reqs, futures):
        out = fut.result(timeout=60)
        r, s = engine.rank_slot(ids)
        np.testing.assert_array_equal(out, full[r, s])
        np.testing.assert_allclose(out, ref_rows[ids], rtol=TOL, atol=TOL)
    assert engine.registry.snapshot()["counters"]["serve.batches"] >= 1


def test_structured_rejections(gcn):
    engine, batcher, _, _ = gcn
    too_many = np.zeros(engine.ladder.max_size + 1, np.int64)
    with pytest.raises(RequestTooLarge) as e:
        engine.infer(too_many)
    assert e.value.record()["error"] == "too_large"
    with pytest.raises(RequestTooLarge):
        batcher.submit(too_many)
    for bad in (np.array([engine.num_nodes]), np.array([-1, 3])):
        with pytest.raises(ValueError):
            engine.infer(bad)
        with pytest.raises(ValueError):
            batcher.submit(bad)
    with pytest.raises(ValueError):
        engine.infer(np.zeros((2, 2), np.int64))


def test_sage_serving_matches_jax():
    engine, batcher, ref_rows, _ = _serving("sage")
    try:
        full = engine.full_logits()
        for ids in _mixed_requests(engine, 6, seed=2):
            out = batcher.infer(ids)
            r, s = engine.rank_slot(ids)
            np.testing.assert_array_equal(out, full[r, s])
            np.testing.assert_allclose(out, ref_rows[ids], rtol=TOL, atol=TOL)
    finally:
        batcher.stop()


def test_engine_retries_then_degrades_then_resets(gcn):
    engine, _, _, _ = gcn
    engine.retry_backoff_s = 0.0
    real = engine._run_bucket
    fails = {"n": 1}

    def flaky(*a):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise RuntimeError("transient device error")
        return real(*a)

    engine._run_bucket = flaky
    try:
        assert engine.infer(np.arange(5)).shape == (5, 4)  # one retry
        fails["n"] = 10 ** 6
        for _ in range(engine.degrade_after):
            with pytest.raises(RuntimeError):
                engine.infer(np.arange(5))
        assert engine.degraded
        with pytest.raises(QueueFull) as e:
            engine.infer(np.arange(5))
        assert e.value.context["degraded"]
        fails["n"] = 0
        engine.reset_degraded()
        assert engine.infer(np.arange(5)).shape == (5, 4)
    finally:
        engine._run_bucket = real
        engine.reset_degraded()


def test_batcher_backpressure_timeout_and_stop(gcn):
    engine = gcn[0]
    gate = threading.Event()
    real = engine.infer

    def slow_infer(ids, *a, **k):
        gate.wait(30)
        return real(ids, *a, **k)

    engine.infer = slow_infer
    b = MicroBatcher(engine, max_batch_size=1, max_delay_ms=0.0, max_queue_depth=2)
    try:
        first = b.submit(np.arange(3))  # occupies the worker
        deadline = time.monotonic() + 10
        while len(b) and time.monotonic() < deadline:  # the worker took it
            time.sleep(0.001)
        expired = b.submit(np.arange(3), timeout_s=0.0)
        queued = b.submit(np.arange(4))
        with pytest.raises(QueueFull):
            b.submit(np.arange(3))
        gate.set()
        assert first.result(timeout=30).shape == (3, 4)
        with pytest.raises(RequestTimeout):
            expired.result(timeout=30)
        assert queued.result(timeout=30).shape == (4, 4)
    finally:
        gate.set()
        engine.infer = real
        b.stop()
    with pytest.raises(EngineStopped):
        b.submit(np.arange(3))


def test_cli_selftest_on_cpu(capsys):
    rec = main(Config(selftest=True, device="cpu", requests=6))
    assert rec["kind"] == "serve_health" and rec["device"] == "cpu"
    assert "error" not in rec
    # the graph generation, as the reference's record carries it (None: the
    # CLI's graph is no delta world's)
    assert "generation" in rec and rec["generation"] is None
    assert rec["metrics"]["counters"]["serve.infer_calls"] >= 6
    # the swap leg: step 1 adopted, then a swap faulted at pre_swap rolled back
    swaps = [r for r in rec["lineage"] if r["event"] == "swap"]
    assert [(r["adopted"], r["rolled_back"], r["step"]) for r in swaps] == [
        (True, False, 1), (False, True, 0)]
    assert swaps[1]["reason"] == "fault"
    assert rec["serving_step"] == 1 and rec["restored_step"] == 0
    counters = rec["metrics"]["counters"]
    assert counters["serve.swaps_adopted"] == 1 and counters["serve.swap_rejected"] == 1


def test_engine_refuses_multi_rank_plans():
    """A W-rank plan needs a communicator of W ranks: a model built on
    ``SingleComm`` raises before any work."""
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.serve.engine import ServeEngine

    d = synthetic.sbm_classification_graph(num_nodes=100, seed=0)
    g = DistributedGraph.from_global(d["edge_index"], d["features"], None, None, 2,
                                     partition_method="block")
    with pytest.raises(ValueError, match="a plan of 2 ranks needs a communicator"):
        ServeEngine.from_distributed_graph(GCN(16, 8, 4, SingleComm()), g, device="cpu")


def test_engine_multi_rank_message_names_the_port_slice():
    """Serving over ranks is ported: the mismatch names how to build a
    W-rank engine (a ``DistComm`` in ranks that ``launch`` starts), not a
    slice still to come."""
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.serve.engine import ServeEngine

    d = synthetic.sbm_classification_graph(num_nodes=100, seed=0)
    g = DistributedGraph.from_global(d["edge_index"], d["features"], None, None, 2,
                                     partition_method="block")
    with pytest.raises(ValueError, match="DistComm") as info:
        ServeEngine.from_distributed_graph(GCN(16, 8, 4, SingleComm()), g, device="cpu")
    assert "comm.dist.launch" in str(info.value) and "slice 9" not in str(info.value)


# --- serving from a checkpoint ------------------------------------------------


def test_serves_from_a_checkpoint_as_the_reference_does(tmp_path):
    """The reference saves its flax params (its own ``save_checkpoint``) and
    serves them through its ``ServeEngine.from_checkpoint``; the port gets
    the same params (restored raw, ``params_from_jax``) saved by its own
    ``save_checkpoint`` and serves them through ``--ckpt_dir``: full logits
    within TOL of the reference's, served rows bit-equal to its own."""
    from dgraph_tpu.comm.mesh import make_graph_mesh
    from dgraph_tpu.serve.engine import ServeEngine as JaxServeEngine
    from dgraph_tpu.train import checkpoint as ref_ckpt
    from dgraph_tpu_torch.train import checkpoint as port_ckpt

    cfg = Config(model="gcn", num_nodes=400, max_bucket=64)
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
        avg_degree=cfg.avg_degree, seed=cfg.seed)
    ref = JaxGraph.from_global(data["edge_index"], data["features"], data["labels"],
                               data["masks"], 1, partition_method=cfg.partition,
                               add_symmetric_norm=True, tune="off")
    jmodel = JaxGCN(cfg.hidden, cfg.num_classes, comm=Communicator.init_process_group("single"))
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    params = jmodel.init(jax.random.key(5), jnp.asarray(ref.features[0]), plan0,
                         jnp.asarray(ref.edge_weight[0]))
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    ref_ckpt.save_checkpoint(ref_dir, {"params": params, "step": 3}, 3)
    jeng = JaxServeEngine.from_checkpoint(
        jmodel, make_graph_mesh(ranks_per_graph=1, devices=jax.devices()[:1]), ref, ref_dir)
    want = jeng.full_logits()
    want_rank, want_slot = jeng.rank_slot(np.arange(cfg.num_nodes))
    raw = ref_ckpt.restore_checkpoint(ref_dir)
    port_ckpt.save_checkpoint(port_dir, {"params": params_from_jax(raw["params"]),
                                         "step": int(raw["step"])}, 3)
    engine, batcher, _ = build_serving(Config(**dict(vars(cfg), ckpt_dir=port_dir)),
                                       device="cpu")
    try:
        assert engine.restored_step == 3 and engine.ckpt_dir == port_dir
        # the reference's restore record, naming the port's directory
        assert engine.lineage == [dict(jeng.lineage[-1], ckpt_dir=port_dir)]
        assert engine.lineage[0]["step"] == 3
        full = engine.full_logits()
        r, s = engine.rank_slot(np.arange(cfg.num_nodes))
        np.testing.assert_array_equal(r, want_rank)
        np.testing.assert_allclose(full[r, s], want[want_rank, want_slot], rtol=TOL, atol=TOL)
        for ids in _mixed_requests(engine, 6, seed=3):
            r, s = engine.rank_slot(ids)
            np.testing.assert_array_equal(batcher.infer(ids), full[r, s])
    finally:
        batcher.stop()
    assert port_ckpt.all_steps(port_dir) == [3]  # a dir with steps is never written


def test_checkpoint_fallback_serves_the_older_step(tmp_path):
    """``--ckpt_dir`` on an empty dir seeds step 0; a step 1 of scaled
    params, truncated, is then skipped by a fresh ``from_checkpoint``: it
    restores step 0, quarantines step 1 and serves the in-memory engine's
    full logits bit for bit."""
    from dgraph_tpu_torch.serve.engine import ServeEngine
    from dgraph_tpu_torch.train import checkpoint as port_ckpt

    ckpt = str(tmp_path / "ckpt")
    cfg = Config(model="sage", num_nodes=300, max_bucket=32, ckpt_dir=ckpt)
    engine, batcher, g = build_serving(cfg, device="cpu")
    batcher.stop()
    assert port_ckpt.all_steps(ckpt) == [0] and engine.restored_step == 0
    want = engine.full_logits()
    state = port_ckpt.restore_checkpoint(ckpt)
    port_ckpt.save_checkpoint(ckpt, {"params": {k: v * 1.0625 for k, v in
                                                state["params"].items()}, "step": 1}, 1)
    assert truncate_step(ckpt, 1) > 0
    again = ServeEngine.from_checkpoint(engine.model, g, ckpt, device="cpu")
    assert again.restored_step == 0 and again.lineage[0]["step"] == 0
    assert port_ckpt.quarantined_steps(ckpt) == [1] and port_ckpt.all_steps(ckpt) == [0]
    got = again.full_logits()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    with pytest.raises(FileNotFoundError):
        ServeEngine.from_checkpoint(engine.model, g, ckpt, step=1, device="cpu")
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        ServeEngine.from_checkpoint(engine.model, g, str(tmp_path / "none"), device="cpu")


# --- serving from a plan cache --------------------------------------------------


def test_serves_from_a_plan_cache_cold_then_warm(tmp_path):
    """``--plan_cache`` at one rank: the cold run builds the artifact, the warm
    run loads it and writes nothing; both serve the uncached engine's bits
    (the same seeded params), and the directory is the one the reference's
    ``from_global(plan_cache_dir=)`` names for the same graph."""
    import os

    cfg = Config(model="gcn", num_nodes=400, max_bucket=64)
    engine, batcher, _ = build_serving(cfg, device="cpu")
    batcher.stop()
    want = engine.full_logits()
    cache = tmp_path / "plans"
    state = None
    for run in range(2):
        engine, batcher, _ = build_serving(Config(**dict(vars(cfg), plan_cache=str(cache))),
                                           device="cpu")
        try:
            full = engine.full_logits()
            np.testing.assert_array_equal(full.view(np.int32), want.view(np.int32))
            for ids in _mixed_requests(engine, 4, seed=run):
                r, s = engine.rank_slot(ids)
                np.testing.assert_array_equal(batcher.infer(ids), full[r, s])
        finally:
            batcher.stop()
        now = {p.name: p.stat().st_mtime_ns for p in cache.rglob("*")}
        assert state is None or now == state
        state = now
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=cfg.num_nodes, num_classes=cfg.num_classes, feat_dim=cfg.feat_dim,
        avg_degree=cfg.avg_degree, seed=cfg.seed)
    JaxGraph.from_global(data["edge_index"], data["features"], data["labels"], data["masks"], 1,
                         partition_method=cfg.partition, add_symmetric_norm=True,
                         plan_cache_dir=str(tmp_path / "ref"), tune="off")
    assert os.listdir(str(cache)) == os.listdir(str(tmp_path / "ref"))


def test_cli_selftest_runs_through_a_plan_cache(tmp_path):
    """The selftest without ``--plan_cache`` serves through a temporary
    ``plans/`` beside its temporary ``ckpt/`` (gone after the run); with one
    it serves through that directory and keeps the artifact."""
    import os

    rec = main(Config(selftest=True, device="cpu", requests=4))
    assert "error" not in rec
    assert rec["plan_cache"] == os.path.join(os.path.dirname(rec["ckpt_dir"]), "plans")
    assert not os.path.exists(rec["plan_cache"])
    rec = main(Config(selftest=True, device="cpu", requests=4, plan_cache=str(tmp_path)))
    assert "error" not in rec and rec["plan_cache"] == str(tmp_path)
    assert [p.name.startswith("plan_") for p in tmp_path.iterdir()] == [True]
