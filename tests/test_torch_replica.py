"""The port's replica axis (R replica groups of W graph ranks) against the
JAX package's ``('replica', 'graph')`` mesh on the virtual CPU mesh.

The port's side runs in spawned gloo processes (``tests/torch_replica_ranks.py``,
which imports no JAX): one launch at R = 2 x W = 2 (four CPU ranks) with
every case inside it, and one at R = 1 x W = 2 that runs each replica
group's inputs in turn. The JAX side runs here on 4 of the 8 virtual
devices. Inputs are numpy arrays made from seeds, handed over in a pickle.

- ``ReplicaSampler``: ``indices`` and ``steps_per_epoch`` equal to the
  reference's over several ``(num_samples, R, seed, step)`` cases, a wrap
  and an epoch change among them; ``stacked`` bit-equal.
- GCN with ``per_replica_batch=True`` against the reference's
  ``make_train_step(..., optax.sgd(1.0), make_graph_mesh(2, 2), ...,
  per_replica_batch=True)``: loss and updated parameters within ``rtol=2e-4,
  atol=2e-5`` (``tests/test_data_parallel.py:130``); the port's one step on
  two replica groups equal to the mean of its two one-sample steps at R = 1
  (that file's "hybrid equals sequential accumulation"), same tolerance;
  with ``per_replica_batch=False`` every replica on one batch gives the
  R = 1 step within 1e-6.
- GraphCast at R = 2 x W = 2 against a JAX oracle built as
  ``_dryrun_graphcast`` builds it (``__graft_entry__.py:173-245``; SGD):
  loss within 1e-6 relative, gradients and parameters within ``rtol=2e-4,
  atol=2e-5``.
- Every halo lowering (all_to_all, the p2p transport's plain version,
  ppermute, overlap, sched) at R = 2 gives each replica group the bits of
  an R = 1 run of that group's inputs, and every send and receive a rank
  posts names a global rank of its own replica group.
- ``replica_mean`` averages over the replica axis only; the parameters of
  all four ranks are bit-equal after each step.
- ``dryrun.dryrun_multichip(4, device="cpu")`` prints both OK lines and
  the line of the families that wait.
- ``chip_smoke.py`` phase 15's checks on CPU ranks at a toy size: each
  replica group's step-0 loss against one rank's on its sample, the synced
  gradient against the one-rank mean, the ranks' parameters bit-equal (no
  kernel launches on the CPU); with the one-rank runs' samples swapped
  (a halo or a sample from the other replica group) they fail.
"""

import dataclasses
import json
import pickle
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
from jax.sharding import PartitionSpec as P

from dgraph_tpu.comm import Communicator
from dgraph_tpu.comm.mesh import (
    GRAPH_AXIS, REPLICA_AXIS, make_graph_mesh, plan_in_specs, squeeze_plan,
)
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.data import synthetic as jax_synthetic
from dgraph_tpu.data.weather import SyntheticWeatherDataset as JaxWeather
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models.graphcast import GraphCast as JaxGraphCast
from dgraph_tpu.models.graphcast import build_graphcast_graphs as jax_build_graphs
from dgraph_tpu.train.loop import init_params as jax_init_params
from dgraph_tpu.train.loop import make_train_step as jax_make_train_step
from dgraph_tpu.train.sampler import ReplicaSampler as JaxSampler
from dgraph_tpu_torch import dryrun
from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.data import synthetic
from dgraph_tpu_torch.plan import build_edge_plan, shard_vertex_data
from dgraph_tpu_torch.train.sampler import ReplicaSampler
from dgraph_tpu_torch.weights import params_from_jax

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
import chip_smoke  # noqa: E402
import torch_replica_ranks  # noqa: E402
from test_torch_dist import _landed, _with_specials  # noqa: E402

R, W = 2, 2
F_HALO = 33
TIMEOUT = 240
RTOL, ATOL = 2e-4, 2e-5  # tests/test_data_parallel.py:130
GC_GRAPH = (1, 10, 18, 3)  # level, lat, lon, channels: _dryrun_graphcast's
GC_MODEL = dict(latent=8, processor_layers=1, out_channels=3)
GC_SAMPLES, GC_LR = 4, 1.0


def _halo_case() -> dict:
    """The W = 2 random partition of an SBM graph and R inputs, one a
    replica group (x with NaN where masked send slots read, h and the
    cotangents with NaN and negative values in masked slots)."""
    sbm = synthetic.sbm_classification_graph(num_nodes=240, num_classes=4, feat_dim=4, seed=3)
    new, ren = pt.partition_graph(sbm["edge_index"], 240, W, method="random", seed=1)
    part = np.asarray(ren.partition)
    plan, layout = build_edge_plan(new, part, world_size=W, overlap=True)
    S, n = plan.halo.s_pad, plan.n_src_pad
    send_idx, send_mask = plan.halo.send_idx.numpy(), plan.halo.send_mask.numpy()
    landed = np.stack([_landed(plan.halo_schedule, r) for r in range(W)])[..., None]
    inputs = []
    for seed in range(R):
        rng = np.random.default_rng(20 + seed)
        x = shard_vertex_data(rng.normal(size=(240, F_HALO)).astype(np.float32),
                              layout.src_counts, n)
        xs, halo_side = _with_specials(x, send_idx, send_mask, W, S, plan.halo_deltas)
        inp = {"x": xs,
               "h": halo_side(rng.normal(size=(W, W * S, F_HALO)).astype(np.float32)),
               "ct_halo": halo_side(rng.normal(size=(W, W * S, F_HALO)).astype(np.float32)),
               "ct_owner": rng.normal(size=(W, n, F_HALO)).astype(np.float32)}
        for k in ("h", "ct_halo"):
            inp[k + "_sched"] = np.where(landed, inp[k], np.float32(0))
        inputs.append(inp)
    return {"edges": new, "part": part, "inputs": inputs}


def _sample_batch(g, seed) -> dict:
    """Same topology, per-sample features and labels
    (``tests/test_data_parallel.py:43``)."""
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal(g.features.shape).astype(np.float32),
            "y": (rng.random(g.labels.shape) * 4).astype(g.labels.dtype),
            "mask": np.asarray(g.masks["train"]),
            "edge_weight": np.asarray(g.edge_weight)}


def _gcn_case() -> tuple:
    """The reference's GCN at W = 2 (``tests/test_data_parallel.py``'s
    graph), its parameters, two sample batches stacked by the sampler,
    and its one per-replica SGD(1.0) step on the 2 x 2 mesh."""
    sbm = jax_synthetic.sbm_classification_graph(num_nodes=256, num_classes=4, feat_dim=8,
                                                 avg_degree=6.0, seed=3)
    ref = JaxGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                               sbm["masks"], world_size=W, partition_method="random",
                               add_symmetric_norm=True, tune="off")
    plan = jax.tree.map(jnp.asarray, ref.plan)
    model = JaxGCN(hidden_features=16, out_features=4,
                   comm=Communicator.init_process_group("tpu", world_size=W,
                                                        replica_axis=REPLICA_AXIS))
    batches = [_sample_batch(ref, 10), _sample_batch(ref, 11)]
    mesh1 = make_graph_mesh(ranks_per_graph=W, num_replicas=1, devices=jax.devices()[:W])
    params = jax.device_get(jax_init_params(model, mesh1, plan,
                                            jax.tree.map(jnp.asarray, batches[0])))
    sampler = JaxSampler(num_samples=2, num_replicas=R, seed=0)
    stacked = sampler.stacked(0, lambda i: batches[i])
    mesh = make_graph_mesh(ranks_per_graph=W, num_replicas=R, devices=jax.devices()[:R * W])
    opt = optax.sgd(1.0)
    plan_h = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)), plan)
    step = jax_make_train_step(model, opt, mesh, plan_h, donate=False, per_replica_batch=True)
    with jax.set_mesh(mesh):
        p2, _, metrics = step(params, opt.init(params), jax.tree.map(jnp.asarray, stacked),
                              plan_h)
    g = {"edges": sbm["edge_index"], "features": sbm["features"], "labels": sbm["labels"],
         "masks": sbm["masks"], "hidden": 16, "classes": 4,
         "params": {k: v.numpy() for k, v in params_from_jax(params).items()},
         "batches": batches, "stacked": {k: np.asarray(v) for k, v in stacked.items()}}
    want = {"loss": float(metrics["loss"]), "accuracy": float(metrics["accuracy"]),
            "params": {k: v.numpy() for k, v in params_from_jax(jax.device_get(p2)).items()}}
    return g, want


def _graphcast_case() -> tuple:
    """The reference's dry-run GraphCast (``__graft_entry__.py:173-245``)
    on the 2 x 2 mesh with SGD at GC_LR: its parameters, step loss,
    synced gradients and updated parameters."""
    level, nlat, nlon, ch = GC_GRAPH
    mesh = make_graph_mesh(ranks_per_graph=W, num_replicas=R, devices=jax.devices()[:R * W])
    comm = Communicator.init_process_group("tpu", world_size=W, replica_axis=REPLICA_AXIS)
    graphs = jax_build_graphs(level, nlat, nlon, W)
    ds = JaxWeather(graphs, nlat, nlon, ch, num_samples=GC_SAMPLES)
    model = JaxGraphCast(comm=comm, **GC_MODEL)
    keys = ("grid_node_static", "mesh_node_static", "mesh_edge_static", "g2m_edge_static",
            "m2g_edge_static")
    statics = {k: jnp.asarray(getattr(graphs, k)) for k in keys}
    plans = {k: jax.tree.map(jnp.asarray, getattr(graphs, f"{k}_plan"))
             for k in ("mesh", "g2m", "m2g")}
    gmask = jnp.asarray(graphs.grid_mask)
    st_specs = {k: P(GRAPH_AXIS) for k in statics}
    pl_specs = {k: plan_in_specs(p) for k, p in plans.items()}

    def init_body(x, statics_, plans_):
        return model.init(jax.random.key(0), x[0], {k: v[0] for k, v in statics_.items()},
                          {k: squeeze_plan(p) for k, p in plans_.items()})

    x0, _ = ds.get_sharded(0)
    with jax.set_mesh(mesh):
        params = jax.jit(jax.shard_map(init_body, mesh=mesh,
                                       in_specs=(P(GRAPH_AXIS), st_specs, pl_specs),
                                       out_specs=P()))(jnp.asarray(x0), statics, plans)

    def train_body(params, x, y, mask, statics_, plans_):
        from dgraph_tpu import compat

        x_, y_, m_ = x[0][0], y[0][0], mask[0]
        st = {k: v[0] for k, v in statics_.items()}
        pln = {k: squeeze_plan(p) for k, p in plans_.items()}

        def lf(p):
            pred = model.apply(p, x_, st, pln)
            se = ((pred - y_) ** 2).sum(-1) * m_
            cnt = jax.lax.psum(m_.sum(), GRAPH_AXIS)
            return se.sum() / jnp.maximum(cnt, 1.0) / R

        loss, grads = jax.value_and_grad(lf)(params)
        grads = compat.sync_inbody_grads(grads, (REPLICA_AXIS, GRAPH_AXIS))
        loss = jax.lax.pmean(jax.lax.psum(loss, GRAPH_AXIS), REPLICA_AXIS)
        return loss * R, grads

    body = jax.shard_map(train_body, mesh=mesh,
                         in_specs=(P(), P(REPLICA_AXIS, GRAPH_AXIS), P(REPLICA_AXIS, GRAPH_AXIS),
                                   P(GRAPH_AXIS), st_specs, pl_specs),
                         out_specs=(P(), P()))
    opt = optax.sgd(GC_LR)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = body(params, x, y, gmask, statics, plans)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, grads

    sampler = JaxSampler(len(ds), R, seed=0)

    def get(i):
        x, y = ds.get_sharded(i)
        return {"x": x, "y": y}

    stacked = sampler.stacked(0, get)
    with jax.set_mesh(mesh):
        p2, loss, grads = step(params, opt.init(params), jnp.asarray(stacked["x"]),
                               jnp.asarray(stacked["y"]))
    def conv(tree):
        return {k: v.numpy() for k, v in params_from_jax(jax.device_get(tree)).items()}

    gc = {"graph": GC_GRAPH, "model": GC_MODEL, "num_samples": GC_SAMPLES, "lr": GC_LR,
          "params": conv(params)}
    return gc, {"loss": float(loss), "grads": conv(grads), "params": conv(p2),
                "samples": sampler.indices(0)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX results, the R = 2 ranks' results, the R = 1 ranks'
    results)."""
    gcn, gcn_want = _gcn_case()
    gc, gc_want = _graphcast_case()
    inputs = {"halo": _halo_case(), "gcn": gcn, "graphcast": gc}
    path = tmp_path_factory.mktemp("replica") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    two = launch(torch_replica_ranks.run_cases, W, str(path), "replica", num_replicas=R,
                 device="cpu", timeout=TIMEOUT, threads=1)
    one = launch(torch_replica_ranks.run_cases, W, str(path), "single", device="cpu",
                 timeout=TIMEOUT, threads=1)
    return inputs, {"gcn": gcn_want, "graphcast": gc_want}, two, one


def _close(got: dict, want: dict, rtol=RTOL, atol=ATOL):
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol, err_msg=k)


def _bits_equal(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32, msg
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=msg)


SAMPLER_CASES = [(8, 2, 0, 0), (8, 2, 0, 3), (8, 2, 0, 4), (7, 2, 1, 3), (7, 2, 1, 4),
                 (5, 3, 2, 1), (5, 3, 2, 2), (4, 4, 0, 9), (1, 2, 3, 5), (16, 2, 7, 123)]


@pytest.mark.parametrize("num_samples, num_replicas, seed, step", SAMPLER_CASES)
def test_replica_sampler_matches_reference(num_samples, num_replicas, seed, step):
    ours = ReplicaSampler(num_samples, num_replicas, seed)
    ref = JaxSampler(num_samples, num_replicas, seed)
    assert ours.steps_per_epoch == ref.steps_per_epoch
    assert ours.indices(step) == ref.indices(step)
    for t in range(step, step + 2 * ours.steps_per_epoch):  # across an epoch change
        assert ours.indices(t) == ref.indices(t)

    def get(i):
        return {"x": np.full((3, 5), i, np.float32) + np.arange(5, dtype=np.float32),
                "y": np.arange(3, dtype=np.int32) * i}

    got, want = ours.stacked(step, get), ref.stacked(step, get)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k])


def test_replica_sampler_rejects_an_empty_dataset():
    with pytest.raises(ValueError, match="num_samples"):
        ReplicaSampler(0, 2)


def test_rank_layout_is_row_major(runs):
    _, _, two, _ = runs
    assert [(r["replica"], r["rank"], r["global_rank"]) for r in two] == [
        (g // W, g % W, g) for g in range(R * W)]


def test_replica_mean_averages_over_the_replica_axis_only(runs):
    _, _, two, _ = runs
    for g, r in enumerate(two):
        # global ranks g and g + W (mod R * W) share graph rank g % W
        np.testing.assert_array_equal(r["replica_mean"], [g % W + W * (R - 1) / 2])


@pytest.mark.parametrize("impl", torch_replica_ranks.IMPLS)
def test_each_replica_group_gets_the_bits_of_its_own_run(runs, impl):
    _, _, two, one = runs
    for g, res in enumerate(two):
        replica, rank = divmod(g, W)
        got, want = res["halo"][impl], one[rank]["halo"][replica][impl]
        for leg, a, b in zip(("buffer", "x vjp", "scatter sum", "h vjp"), got, want):
            _bits_equal(a, b, f"{impl} replica {replica} rank {rank}: {leg}")


def test_sends_and_receives_name_global_ranks_of_their_replica_group(runs):
    _, _, two, _ = runs
    for g, res in enumerate(two):
        replica = g // W
        peers = {p for _, p in res["halo"]["peers"]}
        assert peers, "no round was posted"
        assert peers <= set(range(replica * W, (replica + 1) * W)) - {g}, (g, peers)


def test_gcn_per_replica_step_matches_reference(runs):
    _, want, two, _ = runs
    for res in two:
        got = res["gcn_per_replica"]
        np.testing.assert_allclose(got["loss"], want["gcn"]["loss"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got["accuracy"], want["gcn"]["accuracy"], rtol=RTOL,
                                   atol=ATOL)
        _close(got["params"], want["gcn"]["params"])
    for res in two[1:]:
        for k, v in two[0]["gcn_per_replica"]["params"].items():
            _bits_equal(res["gcn_per_replica"]["params"][k], v, k)


def test_gcn_replicas_equal_sequential_accumulation(runs):
    """One step on two replica groups with distinct samples == the mean of
    the two samples' steps at R = 1 (SGD(1.0): the deltas are -grad)."""
    inputs, _, two, one = runs
    p0 = inputs["gcn"]["params"]
    seq = [r["params"] for r in one[0]["gcn"]]
    i0, i1 = ReplicaSampler(2, R, 0).indices(0)
    assert {i0, i1} == {0, 1}
    want = {k: p0[k] + ((seq[0][k] - p0[k]) + (seq[1][k] - p0[k])) / 2 for k in p0}
    _close(two[0]["gcn_per_replica"]["params"], want)
    # the reported metrics are the replica means of the two groups' own
    np.testing.assert_allclose(two[0]["gcn_per_replica"]["loss"],
                               np.mean([r["loss"] for r in one[0]["gcn"]]), rtol=1e-6)


def test_shared_batch_on_replicas_gives_the_one_replica_step(runs):
    _, _, two, one = runs
    for res in two:
        _close(res["gcn_shared"]["params"], one[0]["gcn"][0]["params"], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(res["gcn_shared"]["loss"], one[0]["gcn"][0]["loss"],
                                   rtol=1e-6)


def test_graphcast_replicas_match_reference(runs):
    _, want, two, _ = runs
    gc = want["graphcast"]
    assert len(set(gc["samples"])) == R
    for g, res in enumerate(two):
        got = res["graphcast"]
        assert got["sample"] == gc["samples"][g // W]
        assert abs(got["loss"] - gc["loss"]) <= 1e-6 * abs(gc["loss"]), (got["loss"], gc["loss"])
        _close(got["grads"], gc["grads"])
        _close(got["params"], gc["params"])
    for res in two[1:]:
        for k, v in two[0]["graphcast"]["params"].items():
            _bits_equal(res["graphcast"]["params"][k], v, k)


def test_dryrun_multichip_on_cpu_ranks(capsys):
    lines = dryrun.dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    out = capsys.readouterr().out
    assert lines[0].startswith("dryrun GCN OK: mesh=(2x2) loss=")
    assert lines[1].startswith("dryrun GraphCast OK: mesh=(2x2) distinct-replica-samples=[")
    assert "param_delta=" in lines[0] and "param_delta=" in lines[1]
    assert "slice 10" in lines[2] and "RGAT" in lines[2]
    assert "all model families ran" not in out
    for line in lines:
        assert line in out
    samples = json.loads(lines[1].split("distinct-replica-samples=")[1].split(" loss=")[0])
    assert samples == JaxSampler(4, 2, seed=0).indices(0)


def test_chip_smoke_replica_checks_on_cpu_ranks():
    from dgraph_tpu_torch.ops.kernels import KERNELS

    base = chip_smoke.graphcast_config(mesh_level=1, num_lat=10, num_lon=18, channels=4,
                                       latent=16, processor_layers=2, steps=2, world_size=1,
                                       ema_decay=0.0, log_path="", device="cpu")
    samples = ReplicaSampler(8, R, seed=0).indices(0)
    one = chip_smoke.replica_one_rank(base, samples)
    ranks, _ = chip_smoke.replica_run("cpu", dataclasses.replace(base, world_size=W), R,
                                      "all_to_all")
    want = {k: 0 for k in KERNELS}  # the plain versions launch nothing
    rec = chip_smoke.replica_checks("cpu", ranks, want, one, W)
    assert rec["samples"] == samples and max(rec["step0_rel"]) <= chip_smoke.GC_W4_TOL
    assert rec["grad_rel_max"] <= chip_smoke.GC_R_GRAD_TOL
    with pytest.raises(SystemExit, match="step-0 loss"):
        chip_smoke.replica_checks("cpu", ranks, want, one[::-1], W)
