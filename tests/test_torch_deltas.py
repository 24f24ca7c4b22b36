"""Live graph deltas (``serve/deltas.py``, ``ServeEngine.append_vertices``) on
the CPU, held against the reference's ``dgraph_tpu/serve/deltas.py``.

The reference's ``ServeEngine.infer`` raises ``ShardingTypeError`` on the
installed JAX (a failure the JAX package keeps), so its own acceptance pin
fails there at ``eng0.infer``. What runs of it is the oracle: the host half
(``init_world``, ``append_delta``, ``replan``, ``load_generation``), its
``build_engine`` and ``append_vertices``, and its ``full_logits()``.

- Artifacts: the two packages' run directories, on the same inputs, hold
  equal pointers, npz arrays (graph snapshots and staged deltas), and
  manifest, shard and layout bytes; each package's ``load_generation``
  reads the other's.
- Host scenarios on both packages: the width and id-horizon errors,
  ``id_base`` sequencing, the no-op re-plan, ``deltas_adopted``, a delta
  landing mid-build folded in, ``max_rounds`` raising; concurrent appends
  from threads and from two processes never collide; a SIGKILL at the
  commit point or mid shard stream leaves generation 0 adopted, and a clean
  rerun adopts generation 1.
- The engine at one rank: after ``append_vertices`` the port's
  ``full_logits()`` is within 1e-4 of the reference engine's after its own
  append of the same features; appended ids are served bit-equal to
  ``full_logits()`` and old rows keep their bits; the reference's error
  messages; ``data_ptr()``s kept, the caller's graph untouched, no CSR
  offsets computed; ``free_pad_slots()`` 0 without ``x``.
- The acceptance pin: append, re-plan, build generation 1, flip a registry
  behind one batcher: appended ids served bit-equal to the new engine's
  ``full_logits()``, every vertex bit-equal to a from-scratch monolithic
  build, within 1e-4 of the reference's, the live placement generation 1's.
- ``chip_smoke.delta_leg``, the card's leg, finds nothing at a small size
  on the CPU.

Over two gloo ranks: ``tests/test_torch_serve_dist.py`` (``delta_cases``).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.comm import Communicator
from dgraph_tpu.comm.mesh import make_graph_mesh
from dgraph_tpu.data import synthetic as jax_synthetic
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.serve import deltas as ref_deltas
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.models import GCN
from dgraph_tpu_torch.obs.metrics import Metrics
from dgraph_tpu_torch.serve import deltas
from dgraph_tpu_torch.serve.bucketing import BucketLadder
from dgraph_tpu_torch.weights import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_replan_worker.py")
TOL = 1e-4
V, F, C, HIDDEN = 96, 8, 3, 8
PAD = 64  # n_pad 128 at one rank, 64 at two: free pad slots for the appends
LADDER = (8,)
PACKAGES = {"reference": ref_deltas, "port": deltas}


def _graph(seed: int = 0) -> dict:
    return jax_synthetic.sbm_classification_graph(num_nodes=V, num_classes=C, feat_dim=F,
                                                  avg_degree=4.0, seed=seed)


def _appends(seed: int = 1) -> list:
    """Two appends of 4 vertices each, with edges to old and new vertices."""
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, F)).astype(np.float32),
             np.array([[0, 1, 96, 97], [96, 97, 2, 99]])),
            (rng.normal(size=(4, F)).astype(np.float32),
             np.array([[100, 101, 5, 103, 98], [3, 100, 103, 7, 102]]))]


def flax_gcn_params() -> dict:
    """The reference GCN's params (hidden 8, 3 classes), from the seed, on
    the graph's one-rank plan."""
    import tempfile

    with tempfile.TemporaryDirectory() as run_dir:
        ref_deltas.init_world(run_dir, _graph()["edge_index"], _graph()["features"],
                              world_size=1, pad_multiple=PAD)
        info = ref_deltas.load_generation(run_dir)
    model = JaxGCN(HIDDEN, C, comm=Communicator.init_process_group("single"), num_layers=2)
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), info["plan"])
    params = model.init(jax.random.key(3), jnp.asarray(info["batch"]["x"][0]), plan0)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def flax_params():
    return flax_gcn_params()


def _ref_engine(run_dir, params, W: int = 1):
    model = JaxGCN(HIDDEN, C, comm=Communicator.init_process_group(
        "single" if W == 1 else "tpu", **({} if W == 1 else {"world_size": W})), num_layers=2)
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    return ref_deltas.build_engine(run_dir, model, mesh, params, add_symmetric_norm=True)


def _port_model(params):
    model = GCN(F, HIDDEN, C, SingleComm(), num_layers=2)
    model.load_state_dict(params_from_jax(params))
    return model


def _port_engine(run_dir, model, **kw):
    return deltas.build_engine(run_dir, model, add_symmetric_norm=True, device="cpu",
                               ladder=BucketLadder(LADDER), registry=Metrics(), **kw)


def _by_id(engine, full, ids):
    r, s = engine.rank_slot(ids)
    return full[r, s]


def _bits_equal(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape, msg
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=msg)


def _world_with_deltas(pkg, run_dir, W):
    data = _graph()
    pkg.init_world(run_dir, data["edge_index"], data["features"], world_size=W,
                   pad_multiple=PAD)
    return [pkg.append_delta(run_dir, f, e) for f, e in _appends()]


# --- (a) artifacts ---------------------------------------------------------------


@pytest.mark.parametrize("W", (1, 2))
def test_run_dirs_are_equal_artifact_for_artifact(tmp_path, W):
    dirs = {name: str(tmp_path / name) for name in PACKAGES}
    recs = {name: _world_with_deltas(pkg, dirs[name], W) for name, pkg in PACKAGES.items()}
    assert recs["reference"] == recs["port"]
    worlds = {name: pkg.replan(dirs[name]) for name, pkg in PACKAGES.items()}
    assert worlds["reference"] == worlds["port"] and worlds["port"]["generation"] == 1
    ref_files, port_files = ([os.path.relpath(os.path.join(r, f), d)
                              for r, _, fs in os.walk(d) for f in fs]
                             for d in dirs.values())
    assert sorted(ref_files) == sorted(port_files)
    assert {"serving.json", "graph_g0.npz", "graph_g1.npz", "plan_g1/manifest.json",
            "deltas_g0/delta_0001.npz"} <= set(port_files)
    for rel in ref_files:
        a, b = (os.path.join(d, rel) for d in dirs.values())
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files), rel
            for k in za.files:
                assert za[k].dtype == zb[k].dtype, (rel, k)
                np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{rel}:{k}")
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read(), rel


@pytest.mark.parametrize("W", (1, 2))
def test_each_package_loads_the_others_run_dir(tmp_path, W):
    dirs = {name: str(tmp_path / name) for name in PACKAGES}
    for name, pkg in PACKAGES.items():
        _world_with_deltas(pkg, dirs[name], W)
        pkg.replan(dirs[name])
    got = deltas.load_generation(dirs["reference"])
    want = ref_deltas.load_generation(dirs["port"])
    assert got["generation"] == want["generation"] == 1 and got["world"] == want["world"]
    for k in ("id_rank", "id_slot", "edge_index"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("x", "vmask"):
        np.testing.assert_array_equal(got["batch"][k], want["batch"][k], err_msg=k)
    for leaf in ("src_index", "dst_index", "edge_mask", "num_edges"):
        np.testing.assert_array_equal(getattr(got["plan"], leaf).numpy(),
                                      np.asarray(getattr(want["plan"], leaf)), err_msg=leaf)
    np.testing.assert_array_equal(got["layout"].edge_slot, want["layout"].edge_slot)
    # a rank subset reads only that rank's shard and rows
    one = deltas.load_generation(dirs["reference"], ranks=[W - 1])
    assert one["plan"].ranks == (None if W == 1 else (W - 1,)) and one["layout"] is None
    np.testing.assert_array_equal(one["batch"]["x"][0], want["batch"]["x"][W - 1])
    np.testing.assert_array_equal(one["plan"].dst_index[0].numpy(),
                                  np.asarray(want["plan"].dst_index[W - 1]))


def test_assign_new_vertices_is_the_reference_waterfill():
    rng = np.random.default_rng(0)
    for _ in range(20):
        fill = rng.integers(0, 20, size=int(rng.integers(1, 6))).astype(np.int64)
        k = int(rng.integers(0, 30))
        a, b = fill.copy(), fill.copy()
        np.testing.assert_array_equal(deltas.assign_new_vertices(a, k),
                                      ref_deltas.assign_new_vertices(b, k))
        np.testing.assert_array_equal(a, b)


# --- (b) host scenarios, on both packages -------------------------------------------


def _tiny_world(pkg, tmp_path):
    run_dir = str(tmp_path / "world")
    edges = np.stack([np.arange(24), (np.arange(24) + 1) % 24])
    pkg.init_world(run_dir, edges, np.ones((24, 4), np.float32), world_size=4,
                   partition_method="block", pad_multiple=4)
    return run_dir


@pytest.mark.parametrize("pkg", PACKAGES)
def test_delta_validation_sequencing_and_noop_replan(pkg, tmp_path):
    mod = PACKAGES[pkg]
    run_dir = _tiny_world(mod, tmp_path)
    with pytest.raises(mod.DeltaError, match=r"\[k, 4\]"):  # wrong feature width
        mod.append_delta(run_dir, np.ones((2, 5), np.float32), np.zeros((2, 0), np.int64))
    with pytest.raises(mod.DeltaError, match=r"outside \[0, 25\)"):  # past the id horizon
        mod.append_delta(run_dir, np.ones((1, 4), np.float32), np.array([[0], [99]]))
    r1 = mod.append_delta(run_dir, np.ones((2, 4), np.float32), np.array([[24], [25]]))
    r2 = mod.append_delta(run_dir, np.ones((1, 4), np.float32), np.array([[26], [0]]))
    assert (r1["id_base"], r2["id_base"], r1["seq"], r2["seq"]) == (24, 26, 0, 1)
    w1 = mod.replan(run_dir)
    assert w1["generation"] == 1 and w1["deltas_adopted"] == 2 and w1["num_nodes"] == 27
    assert mod.replan(run_dir) == mod.read_world(run_dir) == w1  # nothing staged: a no-op
    r3 = mod.append_delta(run_dir, np.ones((1, 4), np.float32), np.zeros((2, 0), np.int64))
    assert (r3["generation"], r3["id_base"], r3["seq"]) == (1, 27, 0)
    assert mod.replan(run_dir)["deltas_adopted"] == 3
    with pytest.raises(mod.DeltaError, match="no serving pointer"):
        mod.read_world(str(tmp_path / "nowhere"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replan_folds_a_delta_that_lands_mid_build(pkg, tmp_path, monkeypatch):
    mod = PACKAGES[pkg]
    plan_mod = __import__("dgraph_tpu.plan" if pkg == "reference" else "dgraph_tpu_torch.plan",
                          fromlist=["build_plan_shards"])
    run_dir = _tiny_world(mod, tmp_path)
    mod.append_delta(run_dir, np.ones((2, 4), np.float32), np.array([[0, 24], [24, 25]]))
    real_build, rounds = plan_mod.build_plan_shards, []

    def racing_build(*args, **kwargs):
        rounds.append(1)
        if len(rounds) == 1:  # a request thread appends while the build runs
            mod.append_delta(run_dir, np.full((1, 4), 2.0, np.float32), np.array([[25], [26]]))
        return real_build(*args, **kwargs)

    monkeypatch.setattr(plan_mod, "build_plan_shards", racing_build)
    world = mod.replan(run_dir)
    assert len(rounds) == 2 and world["generation"] == 1
    assert world["num_nodes"] == 27 and world["deltas_adopted"] == 2
    assert len(mod.staged_delta_paths(run_dir, 0)) == 2
    g1 = np.load(mod.graph_path(run_dir, 1))
    assert g1["features"].shape == (27, 4) and g1["features"][26, 0] == 2.0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_replan_max_rounds_raises_and_adopts_nothing(pkg, tmp_path, monkeypatch):
    mod = PACKAGES[pkg]
    plan_mod = __import__("dgraph_tpu.plan" if pkg == "reference" else "dgraph_tpu_torch.plan",
                          fromlist=["build_plan_shards"])
    run_dir = _tiny_world(mod, tmp_path)
    real_build = plan_mod.build_plan_shards

    def always_racing(*args, **kwargs):
        mod.append_delta(run_dir, np.ones((1, 4), np.float32), np.zeros((2, 0), np.int64))
        return real_build(*args, **kwargs)

    monkeypatch.setattr(plan_mod, "build_plan_shards", always_racing)
    mod.append_delta(run_dir, np.ones((1, 4), np.float32), np.zeros((2, 0), np.int64))
    with pytest.raises(mod.DeltaError, match="quiesce appends") as e:
        mod.replan(run_dir, max_rounds=2)
    assert e.value.record()["kind"] == "serve_delta_error"
    assert mod.read_world(run_dir)["generation"] == 0


# --- (c) concurrent appends ----------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_concurrent_appends_from_threads_never_collide(pkg, tmp_path):
    mod = PACKAGES[pkg]
    run_dir = _tiny_world(mod, tmp_path)
    recs = []

    def appender(i):
        recs.append(mod.append_delta(run_dir, np.full((1, 4), float(i), np.float32),
                                     np.zeros((2, 0), np.int64)))

    threads = [threading.Thread(target=appender, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(mod.staged_delta_paths(run_dir, 0)) == 8
    assert sorted(r["id_base"] for r in recs) == list(range(24, 32))
    assert sorted(r["seq"] for r in recs) == list(range(8))


def test_concurrent_appends_from_two_processes_never_collide(tmp_path):
    run_dir = str(tmp_path / "world")
    subprocess.run([sys.executable, WORKER, run_dir, "init"], check=True, timeout=120,
                   capture_output=True)
    go, n = str(tmp_path / "go"), 6
    procs = [subprocess.Popen([sys.executable, WORKER, run_dir, "append", str(n), str(v), go],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for v in (1.0, 2.0)]
    open(go, "w").close()
    recs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        recs += json.loads(out.strip().splitlines()[-1])
    paths = deltas.staged_delta_paths(run_dir, 0)
    assert len(paths) == 2 * n + 1  # and the init's delta
    assert sorted(r["seq"] for r in recs) == list(range(1, 2 * n + 1))
    assert sorted(r["id_base"] for r in recs) == list(range(51, 51 + 2 * n))
    values = sorted(float(np.load(p)["features"][0, 0]) for p in paths[1:])
    assert values == [1.0] * n + [2.0] * n  # no file overwritten


# --- (d) atomicity under SIGKILL --------------------------------------------------------


@pytest.mark.parametrize("kill_at", ("commit", "shard"))
def test_replan_killed_leaves_the_old_generation_then_resumes(tmp_path, kill_at):
    from dgraph_tpu_torch.plan_shards import read_manifest

    run_dir = str(tmp_path / kill_at)
    subprocess.run([sys.executable, WORKER, run_dir, "init"], check=True, timeout=120,
                   capture_output=True)
    assert deltas.read_world(run_dir)["generation"] == 0
    p = subprocess.run([sys.executable, WORKER, run_dir, "replan", kill_at], timeout=120,
                       capture_output=True, text=True)
    assert p.returncode == -9, p.stdout + p.stderr
    assert deltas.read_world(run_dir)["generation"] == 0  # old, never torn
    if kill_at == "commit":  # every generation-1 artifact was durable
        assert os.path.exists(deltas.graph_path(run_dir, 1))
        assert read_manifest(deltas.plan_dir(run_dir, 1))["complete"]
    else:
        assert not os.path.exists(deltas.graph_path(run_dir, 1))
    p = subprocess.run([sys.executable, WORKER, run_dir, "replan"], timeout=120,
                       capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    world = deltas.read_world(run_dir)
    assert world["generation"] == 1 and world["num_nodes"] == 51
    assert read_manifest(deltas.plan_dir(run_dir, 1))["complete"]
    # the resumed artifact is the reference's (it reads and loads it)
    assert ref_deltas.load_generation(run_dir)["num_nodes"] == 51


# --- (e) the engine at one rank ----------------------------------------------------------


@pytest.fixture
def world1(tmp_path, flax_params):
    """A one-rank world of the port, its engine warmed, the reference's engine
    on the same directory."""
    run_dir = str(tmp_path / "world")
    data = _graph()
    deltas.init_world(run_dir, data["edge_index"], data["features"], world_size=1,
                      pad_multiple=PAD)
    engine = _port_engine(run_dir, _port_model(flax_params))
    engine.warmup()
    return run_dir, engine, _ref_engine(run_dir, flax_params)


def test_append_matches_the_reference_engine_and_keeps_old_bits(world1):
    from dgraph_tpu_torch.ops import segment as seg

    run_dir, engine, ref = world1
    assert engine.generation == ref.generation == 0 and engine.free_pad_slots() == 32
    before = engine.full_logits()
    ptrs = {k: v.data_ptr() for k, v in engine._batch.items()}
    computed, forwards = seg.csr_offsets.computed, engine.forwards
    feats = _appends()[0][0]
    ids = engine.append_vertices(feats)
    np.testing.assert_array_equal(ids, ref.append_vertices(feats))
    np.testing.assert_array_equal(ids, [96, 97, 98, 99])
    assert engine.num_nodes == 100 and engine.free_pad_slots() == 28
    assert engine.forwards == forwards  # an append runs no forward
    assert engine.registry.snapshot()["counters"]["serve.vertices_appended"] == 4.0
    after = engine.full_logits()
    all_ids = np.arange(100)
    np.testing.assert_allclose(_by_id(engine, after, all_ids),
                               _by_id(ref, ref.full_logits(), all_ids), rtol=TOL, atol=TOL)
    _bits_equal(_by_id(engine, after, np.arange(96)), _by_id(engine, before, np.arange(96)),
                "old rows")
    for req in (ids, np.array([99, 3, 97]), np.arange(92, 100)):
        _bits_equal(engine.infer(req), _by_id(engine, after, req), f"{req}")
    assert {k: v.data_ptr() for k, v in engine._batch.items()} == ptrs
    assert seg.csr_offsets.computed == computed


def test_append_errors_carry_the_reference_messages(world1):
    _, engine, ref = world1
    msgs = []
    for eng in (ref, engine):
        got = []
        for feats in (np.ones((2, F + 1), np.float32), np.ones((F,), np.float32),
                      np.ones((33, F), np.float32)):
            with pytest.raises(ValueError) as e:
                eng.append_vertices(feats)
            got.append(str(e.value))
        msgs.append(got)
    assert msgs[0] == msgs[1]
    assert "serve.deltas.replan" in msgs[1][2] and "32 free pad slots" in msgs[1][2]
    assert engine.num_nodes == 96 and engine.free_pad_slots() == 32


def test_append_leaves_the_callers_graph_alone(flax_params):
    from dgraph_tpu_torch.data import DistributedGraph
    from dgraph_tpu_torch.serve.engine import ServeEngine

    data = _graph()
    g = DistributedGraph.from_global(data["edge_index"], data["features"], None, None, 1,
                                     partition_method="random", add_symmetric_norm=True,
                                     pad_multiple=PAD)
    feats0, vmask0 = g.features.clone(), g.vertex_mask.clone()
    engine = ServeEngine.from_distributed_graph(_port_model(flax_params), g, device="cpu",
                                                ladder=BucketLadder(LADDER))
    assert engine._batch["x"].data_ptr() != g.features.data_ptr()
    engine.append_vertices(np.ones((5, F), np.float32))
    assert torch.equal(g.features, feats0) and torch.equal(g.vertex_mask, vmask0)
    assert engine._batch["vmask"].sum() == V + 5 and engine.generation is None


def test_free_pad_slots_is_zero_without_x(world1):
    _, engine, _ = world1
    x = engine._batch.pop("x")
    try:
        assert engine.free_pad_slots() == 0
        with pytest.raises(ValueError, match="no 'x' leaf"):
            engine.append_vertices(np.ones((1, F), np.float32))
    finally:
        engine._batch["x"] = x


# --- (f) the acceptance pin ---------------------------------------------------------------


def _from_scratch(run_dir, generation, model, W=1):
    """An engine on the composed graph of ``generation`` built by the
    monolithic build_edge_plan (not the sharded artifact), with the CLI's
    symmetric-norm weights."""
    from dgraph_tpu_torch.data.graph import symmetric_norm_weights
    from dgraph_tpu_torch.partition import renumber_contiguous
    from dgraph_tpu_torch.plan import build_edge_plan, shard_edge_data, shard_vertex_data
    from dgraph_tpu_torch.serve.engine import ServeEngine

    g = np.load(deltas.graph_path(run_dir, generation))
    nv = int(g["partition"].shape[0])
    ren = renumber_contiguous(g["partition"], W)
    new_edges = ren.perm[g["edge_index"]]
    plan, layout = build_edge_plan(new_edges, ren.partition, world_size=W, pad_multiple=PAD)
    batch = {
        "x": torch.from_numpy(shard_vertex_data(g["features"][ren.inv], ren.counts,
                                                plan.n_src_pad).astype(np.float32)),
        "vmask": torch.from_numpy(shard_vertex_data(np.ones(nv, np.float32), ren.counts,
                                                    plan.n_src_pad)),
        "edge_weight": torch.from_numpy(shard_edge_data(symmetric_norm_weights(new_edges, nv),
                                                        layout, plan.e_pad)),
    }
    id_rank = ren.partition[ren.perm]
    return ServeEngine(model, plan, batch, id_rank, ren.perm - ren.offsets[id_rank],
                       device="cpu", ladder=BucketLadder(LADDER))


def test_append_replan_adopt_flip_matches_from_scratch(world1, flax_params):
    from dgraph_tpu_torch.serve.batcher import MicroBatcher
    from dgraph_tpu_torch.serve.registry import ModelRegistry

    run_dir, eng0, _ = world1
    live = []
    for feats, edges in _appends():
        rec = deltas.append_delta(run_dir, feats, edges)  # durable first, then live
        ids = eng0.append_vertices(feats)
        np.testing.assert_array_equal(ids, rec["id_base"] + np.arange(len(feats)))
        live.append(ids)
    live = np.concatenate(live)
    w1 = deltas.replan(run_dir)
    assert w1["generation"] == 1 and w1["num_nodes"] == 104
    eng1 = _port_engine(run_dir, eng0.model, adopt_from=eng0)
    assert eng1.generation == 1 and eng1.free_pad_slots() == 128 - 104
    eng1.warmup()
    reg = ModelRegistry()
    reg.register("default", eng0, activate=True)
    bat = MicroBatcher(reg, max_batch_size=4, max_delay_ms=0.5)
    try:
        old_rows = bat.infer(np.arange(5))
        reg.activate("default", eng1, note={"kind": "serve_adopt", "generation": 1})
        out_live = bat.infer(live)
    finally:
        bat.stop()
    full0, full1 = eng0.full_logits(), eng1.full_logits()
    _bits_equal(old_rows, _by_id(eng0, full0, np.arange(5)))
    _bits_equal(out_live, _by_id(eng1, full1, live), "appended ids after the flip")
    assert reg.lineage("default")[-1]["generation"] == 1
    # every vertex bit-equal to a from-scratch monolithic build of generation 1
    all_ids = np.arange(104)
    oracle = _from_scratch(run_dir, 1, eng0.model)
    _bits_equal(_by_id(eng1, full1, all_ids), _by_id(oracle, oracle.full_logits(), all_ids))
    # and within TOL of the reference's full_logits() on generation 1
    ref1 = _ref_engine(run_dir, flax_params)
    assert ref1.generation == 1
    np.testing.assert_allclose(_by_id(eng1, full1, all_ids),
                               _by_id(ref1, ref1.full_logits(), all_ids), rtol=TOL, atol=TOL)
    # the new edges changed old rows (the norms of old vertices beside them)
    assert not np.array_equal(_by_id(eng1, full1, np.arange(8)),
                              _by_id(eng0, full0, np.arange(8)))
    # the live placement is generation 1's: adoption moved no vertex
    g1 = np.load(deltas.graph_path(run_dir, 1))
    np.testing.assert_array_equal(eng0.rank_slot(live)[0], g1["partition"][96:])
    for a, b in zip(eng0.rank_slot(all_ids), eng1.rank_slot(all_ids)):
        np.testing.assert_array_equal(a, b)


def test_chip_smoke_delta_leg_passes_on_the_cpu(tmp_path):
    """``chip_smoke.delta_leg`` (phases 4 and 16's leg on rank 0) at a small
    size on the CPU: its checks of the appends under traffic, the budget
    error, the re-plan, the adoption and the registry flip find nothing,
    and ``from_scratch_engine`` gives generation 1's bits."""
    import chip_smoke
    from dgraph_tpu_torch.data import synthetic
    from dgraph_tpu_torch.weights import init_params

    run_dir = str(tmp_path / "world")
    d = synthetic.sbm_classification_graph(num_nodes=400, num_classes=4, feat_dim=16, seed=0)
    deltas.init_world(run_dir, d["edge_index"], d["features"], world_size=1,
                      pad_multiple=chip_smoke.DELTA_PAD)
    model = GCN(16, 16, 4, SingleComm(), num_layers=2)
    init_params(model, 0)
    kw = dict(add_symmetric_norm=True, device="cpu", ladder=BucketLadder.geometric(8, 32))
    eng0 = deltas.build_engine(run_dir, model, **kw)
    eng0.warmup()
    appends = chip_smoke.delta_appends(400, (8, 8), 16, seed=2)
    out, failures, eng1, full1 = chip_smoke.delta_leg(eng0, run_dir, appends, kw, seed=2)
    assert failures == []
    assert out["replan"]["world"]["generation"] == eng1.generation == 1
    assert out["flip"]["served_by"][0] == "o" and out["flip"]["served_by"][-1] == "n"
    assert out["new_ids_served"] > 0 and out["free_before"] - out["free_after"] == 16
    oracle = chip_smoke.from_scratch_engine(run_dir, 1, model, 1, device="cpu",
                                            ladder=eng1.ladder)
    ids = np.arange(416)
    _bits_equal(_by_id(eng1, full1, ids), _by_id(oracle, oracle.full_logits(), ids))
