"""The port's GraphCast against the JAX package's, on the same numpy inputs.

- The mesh helpers, ``build_graphcast_graphs`` (plans, layouts,
  renumberings, statics, masks) and the synthetic weather are bit for bit
  the reference's: they are the same numpy code.
- The schedule within 1e-7 relative of optax's (which evaluates in f32), the
  EMA update bit for bit ``decay * e + (1 - decay) * p``.
- The blocks and the model (weights carried across by ``params_from_jax``):
  forward within 1e-5 of the flax model's, every gradient within 1e-4 of
  ``jax.grad``'s; ``remat`` changes no bit; the rollout within 1e-5.
- Three CLI steps (AdamW under the schedule, the EMA track) against
  ``optax.adamw`` and the reference's ``ema_update``: losses within 1e-5,
  parameters and EMA within 1e-5 (three updates of at most about lr each,
  the first at lr 0).
- Four gloo ranks under every halo lowering that runs on the CPU against
  the JAX forward at one rank, in global order through the renumberings:
  outputs within 1e-5, the global loss within 1e-5 and the summed gradients
  within 1e-4.
- The kernels a training step and a rollout step launch
  (``chip_smoke.graphcast_launches``), counted on the CPU at the dispatch
  of each kernel's plain version.
- The CLI on the CPU: the reference's record keys, two ranks equal to one,
  the options of later slices and the device rule raise.
"""

import contextlib
import json
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import chip_smoke
from dgraph_tpu.comm import Communicator
from dgraph_tpu.data.weather import SyntheticWeatherDataset as JaxWeather
from dgraph_tpu.models.graphcast import GraphCast as JaxGraphCast
from dgraph_tpu.models.graphcast import MeshEdgeBlock as JaxEdgeBlock
from dgraph_tpu.models.graphcast import MeshNodeBlock as JaxNodeBlock
from dgraph_tpu.models.graphcast import build_graphcast_graphs as jax_build_graphs
from dgraph_tpu.models.graphcast import graph as jax_graph
from dgraph_tpu.models.graphcast import mesh as jax_mesh
from dgraph_tpu.models.graphcast import rollout as jax_rollout
from dgraph_tpu.plan import unshard_vertex_data
from dgraph_tpu.train.ema import ema_update as jax_ema_update
from dgraph_tpu.train.schedules import graphcast_three_phase as jax_schedule
from dgraph_tpu_torch import config
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.data.weather import SyntheticWeatherDataset
from dgraph_tpu_torch.models.graphcast import (
    GraphCast, MeshEdgeBlock, MeshNodeBlock, build_graphcast_graphs, rollout,
)
from dgraph_tpu_torch.models.graphcast import graph as gc_graph
from dgraph_tpu_torch.models.graphcast import mesh as gc_mesh
from dgraph_tpu_torch.models.graphcast.graph import RELATIONS, STATIC_KEYS, rank_inputs
from dgraph_tpu_torch.ops import segment as seg
from dgraph_tpu_torch.train import graphcast as cli
from dgraph_tpu_torch.train.ema import ema_init, ema_update
from dgraph_tpu_torch.train.schedules import graphcast_three_phase
from dgraph_tpu_torch.weights import params_from_jax, params_to_jax

sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
import torch_dist_ranks  # noqa: E402
from test_torch_plan import assert_layouts_equal, assert_plans_equal  # noqa: E402

LEVEL, NLAT, NLON, CH = 2, 19, 36, 8
LATENT, LAYERS = 16, 2
JAX_COMM = Communicator.init_process_group("single")
RANKS_W = 4
TIMEOUT = 180


def jax_statics(g, rank=0):
    return {k: jnp.asarray(getattr(g, k)[rank]) for k in STATIC_KEYS}


def jax_plans(g, rank=0):
    return {k: jax.tree.map(lambda a: jnp.asarray(a[rank]), getattr(g, f"{k}_plan"))
            for k in RELATIONS}


def to_global(shards: np.ndarray, ren) -> np.ndarray:
    """``[W, n_pad, ...]`` rank shards -> rows in the original vertex order."""
    got = unshard_vertex_data(np.asarray(shards), ren.counts)
    out = np.empty_like(got)
    out[ren.inv] = got
    return out


@pytest.fixture(scope="module")
def graphs():
    """(port's, reference's) graphs at (LEVEL, NLAT, NLON, W = 1)."""
    return (build_graphcast_graphs(LEVEL, NLAT, NLON, 1),
            jax_build_graphs(LEVEL, NLAT, NLON, 1))


@pytest.fixture(scope="module")
def data(graphs):
    """One sample (x, y) of CH channels, ``[1, n_grid_pad, CH]``, and the
    flax GraphCast's parameters."""
    ours, ref = graphs
    x, y = SyntheticWeatherDataset(ours, NLAT, NLON, CH, num_samples=1).get_sharded(0)
    model = JaxGraphCast(comm=JAX_COMM, latent=LATENT, processor_layers=LAYERS,
                         out_channels=CH)
    params = model.init(jax.random.key(0), jnp.asarray(x[0]), jax_statics(ref),
                        jax_plans(ref))
    return x, y, params


def port_model(params, latent=LATENT, layers=LAYERS, remat=True, comm=None):
    model = GraphCast(latent=latent, processor_layers=layers, out_channels=CH,
                      comm=comm or SingleComm(), remat=remat)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return model


def jax_value_and_grad(model, mask, statics, plans):
    """The flax model's masked MSE and its gradient in the parameters,
    jitted: ``(params, x, y) -> (loss, grads)``."""
    def lf(p, x, y):
        pred = model.apply(p, x, statics, plans)
        se = ((pred - y) ** 2).sum(-1) * mask
        return se.sum() / jnp.maximum(mask.sum(), 1.0)

    return jax.jit(jax.value_and_grad(lf))


def assert_grads_close(model, want_tree, tol):
    want = params_from_jax(jax.tree.map(np.asarray, want_tree))
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol, atol=tol, err_msg=k)


# --- mesh helpers and graphs -----------------------------------------------


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_multimesh_bit_equal(level):
    ours, ref = gc_mesh.build_multimesh(level), jax_mesh.build_multimesh(level)
    for name in ("vertices", "faces", "edges"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.level == ref.level == level
    if level == 1:
        for a, b in zip(gc_mesh.icosahedron(), jax_mesh.icosahedron()):
            np.testing.assert_array_equal(a, b)
        v, f = jax_mesh.icosahedron()
        for a, b in zip(gc_mesh.subdivide(v, f), jax_mesh.subdivide(v, f)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(gc_mesh.faces_to_edges(f), jax_mesh.faces_to_edges(f))


@pytest.mark.parametrize("level, nlat, nlon", [(1, 10, 18), (2, 19, 36), (3, 37, 72)])
def test_grid_and_grid_mesh_edges_bit_equal(level, nlat, nlon):
    ll, xyz = gc_mesh.latlon_grid(nlat, nlon)
    ll_r, xyz_r = jax_mesh.latlon_grid(nlat, nlon)
    np.testing.assert_array_equal(ll, ll_r)
    np.testing.assert_array_equal(xyz, xyz_r)
    np.testing.assert_array_equal(gc_mesh.latlon_to_xyz(ll), jax_mesh.latlon_to_xyz(ll))
    mm = jax_mesh.build_multimesh(level)
    g2m, m2g = gc_mesh.grid2mesh_edges(xyz, mm), gc_mesh.mesh2grid_edges(xyz, mm)
    np.testing.assert_array_equal(g2m, jax_mesh.grid2mesh_edges(xyz, mm))
    np.testing.assert_array_equal(m2g, jax_mesh.mesh2grid_edges(xyz, mm))
    assert np.all(np.bincount(m2g[1], minlength=len(xyz)) == 3)
    assert len(np.unique(g2m[0])) == len(xyz)
    np.testing.assert_array_equal(gc_graph.xyz_to_latlon(xyz), jax_graph.xyz_to_latlon(xyz))


GRAPH_CASES = [(1, 10, 18, 1, "multilevel")] + [
    (2, 19, 36, w, m) for w in (2, 4) for m in ("multilevel", "rcm", "greedy")]


@pytest.mark.parametrize("level, nlat, nlon, world, method", GRAPH_CASES)
def test_build_graphcast_graphs_bit_equal(level, nlat, nlon, world, method):
    ours = build_graphcast_graphs(level, nlat, nlon, world, mesh_partition_method=method)
    ref = jax_build_graphs(level, nlat, nlon, world, mesh_partition_method=method)
    for name in ("world_size", "mesh_level", "num_grid", "num_mesh", "n_grid_pad",
                 "n_mesh_pad"):
        assert getattr(ours, name) == getattr(ref, name), name
    for rel in RELATIONS:
        assert_plans_equal(getattr(ours, f"{rel}_plan"), getattr(ref, f"{rel}_plan"))
        assert_layouts_equal(getattr(ours, f"{rel}_layout"), getattr(ref, f"{rel}_layout"))
    for ren in ("grid_ren", "mesh_ren"):
        for name in ("perm", "inv", "partition", "counts", "offsets"):
            np.testing.assert_array_equal(getattr(getattr(ours, ren), name),
                                          getattr(getattr(ref, ren), name))
    for name in STATIC_KEYS + ("grid_mask", "mesh_mask"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the bipartite plans: two vertex sets of their own pads, edges dst-owned
    assert ours.g2m_plan.n_src_pad == ours.n_grid_pad != ours.g2m_plan.n_dst_pad
    assert all(getattr(ours, f"{r}_plan").halo_side == "src" for r in RELATIONS)
    statics, plans, mask = rank_inputs(ours, world - 1, "cpu")
    assert set(statics) == set(STATIC_KEYS) and set(plans) == set(RELATIONS)
    np.testing.assert_array_equal(mask.numpy(), ours.grid_mask[world - 1])
    assert plans["g2m"].per_rank and plans["g2m"].halo_sort_perm is not None


@pytest.mark.parametrize("world", [1, 2])
def test_weather_samples_and_trajectories_bit_equal(world):
    ours_g = build_graphcast_graphs(1, 10, 18, world)
    ref_g = jax_build_graphs(1, 10, 18, world)
    ours = SyntheticWeatherDataset(ours_g, 10, 18, 5, num_samples=3, seed=7)
    ref = JaxWeather(ref_g, 10, 18, 5, num_samples=3, seed=7)
    assert len(ours) == len(ref) == 3
    for i in range(4):
        for a, b in zip(ours.get_sharded(i), ref.get_sharded(i)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.trajectory_sharded(1, 3), ref.trajectory_sharded(1, 3)):
        np.testing.assert_array_equal(a, b)


# --- schedule and EMA --------------------------------------------------------


@pytest.mark.parametrize("peak, warmup, decay, floor", [(1e-3, 100, 10_000, 3e-7),
                                                         (2e-3, 10, 50, 1e-5)])
def test_three_phase_schedule_matches_optax(peak, warmup, decay, floor):
    ours, ref = graphcast_three_phase(peak, warmup, decay, floor), jax_schedule(
        peak, warmup, decay, floor)
    points = [0, warmup // 2, warmup, warmup + decay // 4, warmup + decay // 2,
              warmup + decay, warmup + decay + 7, 10 ** 7]
    for c in points:
        want = float(ref(c))
        assert abs(ours(c) - want) <= 1e-7 * abs(want), (c, ours(c), want)
    assert ours(0) == 0.0 and ours(warmup) == peak and ours(warmup + decay) == floor


def test_schedule_drives_adamw_from_update_zero():
    """Through LambdaLR with a base lr of 1, update k runs at schedule(k)."""
    sched = graphcast_three_phase(1e-3, 4, 20)
    p = torch.nn.Parameter(torch.ones(3))
    opt = torch.optim.AdamW([p], lr=1.0, weight_decay=0.1)
    lr_sched = torch.optim.lr_scheduler.LambdaLR(opt, sched)
    seen = []
    for _ in range(6):
        seen.append(opt.param_groups[0]["lr"])
        p.grad = torch.ones(3)
        opt.step()
        lr_sched.step()
    assert seen == [sched(k) for k in range(6)] and seen[0] == 0.0


def test_ema_update_bit_equal_to_the_reference_expression():
    gen = np.random.default_rng(3)
    e = {"a": gen.standard_normal((17, 5)).astype(np.float32),
         "b": gen.standard_normal(9).astype(np.float32)}
    p = {k: gen.standard_normal(v.shape).astype(np.float32) for k, v in e.items()}
    state = ema_init({k: torch.from_numpy(v) for k, v in e.items()})
    assert all(not np.shares_memory(state[k].numpy(), e[k]) for k in e)
    for decay in (0.999, 0.9, 0.5):
        got = ema_update(state, {k: torch.from_numpy(v) for k, v in p.items()}, decay)
        ref = jax_ema_update({k: jnp.asarray(v) for k, v in e.items()},
                             {k: jnp.asarray(v) for k, v in p.items()}, decay)
        for k in e:
            expr = (decay * torch.from_numpy(e[k]) + (1 - decay) * torch.from_numpy(p[k]))
            assert torch.equal(got[k], expr), k
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


# --- blocks and the model ----------------------------------------------------


@pytest.mark.parametrize("relation", ["g2m", "m2g", "mesh"])
@pytest.mark.parametrize("latent", [16, 192])
def test_mesh_blocks_match_flax(graphs, relation, latent):
    """Each block alone on one relation's plan (latent 192: two feature
    chunks, 128 + 64): forward within 1e-5, gradients (of the inputs too)
    within 1e-4."""
    ours_g, ref_g = graphs
    jplan, plan = jax_plans(ref_g)[relation], rank_inputs(ours_g, 0, "cpu")[1][relation]
    gen = np.random.default_rng(5)
    e = gen.standard_normal((plan.e_pad, latent)).astype(np.float32)
    xs = gen.standard_normal((plan.n_src_pad, latent)).astype(np.float32)
    xd = gen.standard_normal((plan.n_dst_pad, latent)).astype(np.float32)
    ct_e = gen.standard_normal(e.shape).astype(np.float32)
    ct_n = gen.standard_normal(xd.shape).astype(np.float32)

    jedge = JaxEdgeBlock(latent, JAX_COMM)
    jnode = JaxNodeBlock(latent, JAX_COMM)
    pe = jedge.init(jax.random.key(1), e, xs, xd, jplan)
    pn = jnode.init(jax.random.key(2), xd, e, jplan)

    def jfwd(pe_, pn_, e_, xs_, xd_):
        e2 = jedge.apply(pe_, e_, xs_, xd_, jplan)
        x2 = jnode.apply(pn_, xd_, e2, jplan)
        return (e2 * ct_e).sum() + (x2 * ct_n).sum(), (e2, x2)

    (_, (we, wx)), wg = jax.jit(jax.value_and_grad(jfwd, argnums=(0, 1, 2, 3, 4),
                                                   has_aux=True))(pe, pn, e, xs, xd)

    edge, node = MeshEdgeBlock(latent, SingleComm()), MeshNodeBlock(latent, SingleComm())
    edge.load_state_dict(params_from_jax(jax.tree.map(np.asarray, pe)))
    node.load_state_dict(params_from_jax(jax.tree.map(np.asarray, pn)))
    te, txs, txd = (torch.from_numpy(a).requires_grad_() for a in (e, xs, xd))
    e2 = edge(te, txs, txd, plan)
    x2 = node(txd, e2, plan)
    ((e2 * torch.from_numpy(ct_e)).sum() + (x2 * torch.from_numpy(ct_n)).sum()).backward()
    np.testing.assert_allclose(e2.detach().numpy(), np.asarray(we), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x2.detach().numpy(), np.asarray(wx), rtol=1e-5, atol=1e-5)
    assert_grads_close(edge, wg[0], 1e-4)
    assert_grads_close(node, wg[1], 1e-4)
    for t, w in zip((te, txs, txd), wg[2:]):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("latent", [LATENT, 192])
def test_graphcast_forward_and_grads_match_flax(graphs, data, latent):
    ours_g, ref_g = graphs
    x, y, params = data
    jmodel = JaxGraphCast(comm=JAX_COMM, latent=latent, processor_layers=LAYERS,
                          out_channels=CH)
    if latent != LATENT:
        params = jmodel.init(jax.random.key(4), jnp.asarray(x[0]), jax_statics(ref_g),
                             jax_plans(ref_g))
    mask = jnp.asarray(ref_g.grid_mask[0])
    vg = jax_value_and_grad(jmodel, mask, jax_statics(ref_g), jax_plans(ref_g))
    want_loss, want_grads = vg(params, jnp.asarray(x[0]), jnp.asarray(y[0]))
    want = np.asarray(jmodel.apply(params, jnp.asarray(x[0]), jax_statics(ref_g),
                                   jax_plans(ref_g)))

    model = port_model(params, latent=latent)
    statics, plans, tmask = rank_inputs(ours_g, 0, "cpu")
    pred = model(torch.from_numpy(x[0]), statics, plans)
    np.testing.assert_allclose(pred.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    loss = cli.masked_mse(pred, torch.from_numpy(y[0]), tmask, tmask.sum())
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    assert_grads_close(model, want_grads, 1e-4)


def test_flax_tree_maps_onto_the_module_names(data):
    """Every flax leaf has a module of the same name, and back."""
    _, _, params = data
    model = port_model(params)
    sd = model.state_dict()
    assert set(sd) == set(params_from_jax(jax.tree.map(np.asarray, params)))
    back = params_to_jax(sd, model)["params"]
    assert jax.tree.structure(back) == jax.tree.structure(
        jax.tree.map(np.asarray, params)["params"])
    assert {"src_proj", "dst_proj", "edge_proj", "MLP_0"} == set(back["proc_edge_1"])
    assert set(back["head"]) == {"Dense_0", "Dense_1"}


def test_remat_changes_no_bit(graphs, data):
    ours_g, _ = graphs
    x, y, params = data
    statics, plans, mask = rank_inputs(ours_g, 0, "cpu")
    outs = []
    for remat in (True, False):
        model = port_model(params, remat=remat)
        pred = model(torch.from_numpy(x[0]), statics, plans)
        cli.masked_mse(pred, torch.from_numpy(y[0]), mask, mask.sum()).backward()
        outs.append((pred.detach(), {k: p.grad for k, p in model.named_parameters()}))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, g in outs[0][1].items():
        assert torch.equal(g, outs[1][1][k]), k


def test_rollout_matches_reference(graphs, data):
    ours_g, ref_g = graphs
    _, _, params = data
    ds = JaxWeather(ref_g, NLAT, NLON, CH, num_samples=1)
    x0, _ = ds.trajectory_sharded(0, 3)
    jmodel = JaxGraphCast(comm=JAX_COMM, latent=LATENT, processor_layers=LAYERS,
                          out_channels=CH)
    want = np.asarray(jax_rollout(jmodel, params, jnp.asarray(x0[0]), jax_statics(ref_g),
                                  jax_plans(ref_g), 3))
    model = port_model(params)
    statics, plans, _ = rank_inputs(ours_g, 0, "cpu")
    got = rollout(model, torch.from_numpy(x0[0]), statics, plans, 3)
    assert got.shape == want.shape == (3, x0.shape[1], CH)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # with the parameters passed in: the same as the module's own
    same = rollout(model, torch.from_numpy(x0[0]), statics, plans, 2,
                   params=dict(model.named_parameters()))
    assert torch.equal(same, got[:2])


# --- launches ----------------------------------------------------------------


@contextlib.contextmanager
def counted_dispatch():
    """Count the sorted-id kernels' dispatches on the CPU (each wrapper's
    plain branch is reached exactly where its kernel launches on a card)."""
    counts = {"sorted_segment_sum": 0, "sorted_row_gather": 0}
    saved = seg._segment_sum, seg._row_gather

    def segsum(*a, **k):
        counts["sorted_segment_sum"] += 1
        return saved[0](*a, **k)

    def gather(*a, **k):
        counts["sorted_row_gather"] += 1
        return saved[1](*a, **k)

    seg._segment_sum, seg._row_gather = segsum, gather
    try:
        yield counts
    finally:
        seg._segment_sum, seg._row_gather = saved


@pytest.mark.parametrize("latent", [LATENT, 192])
@pytest.mark.parametrize("gather", [False, True])
def test_step_and_rollout_launches_are_as_derived(graphs, data, latent, gather):
    ours_g, _ = graphs
    x, y, _ = data
    model = GraphCast(latent=latent, processor_layers=LAYERS, out_channels=CH,
                      comm=SingleComm())
    statics, plans, mask = rank_inputs(ours_g, 0, "cpu")
    config.use_pallas_gather = True if gather else None
    try:
        with counted_dispatch() as step:
            pred = model(torch.from_numpy(x[0]), statics, plans)
            cli.masked_mse(pred, torch.from_numpy(y[0]), mask, mask.sum()).backward()
        with counted_dispatch() as fwd:
            rollout(model, torch.from_numpy(x[0]), statics, plans, 1)
    finally:
        config.use_pallas_gather = None
    want = chip_smoke.graphcast_launches(LAYERS, latent, gather, train=True)
    assert step == {k: want[k] for k in step} and want["p2p_transport"] == 0
    want_fwd = chip_smoke.graphcast_launches(LAYERS, latent, gather, train=False)
    assert fwd == {k: want_fwd[k] for k in fwd}


# --- the CLI -----------------------------------------------------------------

TINY = dict(mesh_level=1, num_lat=10, num_lon=18, channels=4, latent=16, processor_layers=2,
            warmup_steps=2, device="cpu", log_path="")


def test_three_cli_steps_match_optax_adamw():
    cfg = cli.Config(**TINY, steps=3)
    t = cli.build_graphcast(cfg)
    ref_g = jax_build_graphs(1, 10, 18, 1)
    ds = JaxWeather(ref_g, 10, 18, 4)
    jmodel = JaxGraphCast(comm=JAX_COMM, latent=16, processor_layers=2, out_channels=4)
    params = jax.tree.map(jnp.asarray, params_to_jax(t.model.state_dict(), t.model))
    ema = params
    opt = optax.adamw(jax_schedule(cfg.peak_lr, cfg.warmup_steps, cfg.decay_steps),
                      weight_decay=0.1)
    opt_state = opt.init(params)
    vg = jax_value_and_grad(jmodel, jnp.asarray(ref_g.grid_mask[0]), jax_statics(ref_g),
                            jax_plans(ref_g))

    @jax.jit
    def update(grads, opt_state, params, ema):
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax_ema_update(ema, params, cfg.ema_decay)

    for i in range(3):
        x, y = ds.get_sharded(i)
        want_loss, grads = vg(params, jnp.asarray(x[0]), jnp.asarray(y[0]))
        params, opt_state, ema = update(grads, opt_state, params, ema)
        got = t.train_step(*t.batch(i))
        np.testing.assert_allclose(float(got.loss), float(want_loss), rtol=1e-5, atol=1e-5)
        assert t.optimizer.param_groups[0]["lr"] == t.schedule(i + 1)
    for name, tree in (("params", dict(t.model.named_parameters())), ("ema", t.ema)):
        want = params_from_jax(jax.tree.map(np.asarray, params if name == "params" else ema))
        for k, w in want.items():
            np.testing.assert_allclose(tree[k].detach().numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{name} {k}")


def test_cli_records_and_rollout_on_cpu(tmp_path):
    log = tmp_path / "gc.jsonl"
    args = [f"--{k} {v}" for k, v in dict(TINY, log_path=log).items()]
    cmd = (f"{sys.executable} -m dgraph_tpu_torch.train.graphcast {' '.join(args)} --steps 10 "
           "--eval_rollout 2 --step_metrics")
    subprocess.run(cmd.split(), check=True, timeout=300, capture_output=True)
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    step, raw, ema = recs
    assert set(step) == {"kind", "schema", "loss", "grad_norm", "step", "step_ms", "lr"}
    assert step["step"] == 10 and step["lr"] == graphcast_three_phase(1e-3, 2, 10_000)(10)
    assert raw["rollout_eval"] == "raw" and ema["rollout_eval"] == "ema"
    assert raw["steps"] == 2 and len(raw["rmse_per_step"]) == 2
    assert all(np.isfinite(raw["rmse_per_step"] + ema["rmse_per_step"]))


def test_cli_two_ranks_match_one_rank():
    one = cli.main(cli.Config(**TINY, steps=3))
    two = cli.main(cli.Config(**dict(TINY, world_size=2), steps=3))
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
    assert two["ranks"][1]["losses"] == two["losses"]
    micro = cli.main(cli.Config(**dict(TINY, world_size=2), microbenchmark=True))
    assert set(micro["microbenchmark"]) == {"comm_gather_ms_mean", "comm_gather_ms_std",
                                            "local_gather_ms_mean", "local_gather_ms_std"}
    assert micro["losses"] == []


def test_cli_refuses_later_slices_and_the_cpu_unless_asked():
    with pytest.raises(NotImplementedError, match="slice 9"):
        cli.main(cli.Config(**TINY, ckpt_dir="ckpt"))
    with pytest.raises(NotImplementedError, match="slice 12"):
        cli.main(cli.Config(**TINY, step_deadline_s=30.0))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is cuda here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.build_graphcast(cli.Config(**dict(TINY, device="")))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(cli.Config(**dict(TINY, device="", world_size=2)))


# --- four ranks --------------------------------------------------------------


@pytest.fixture(scope="module")
def four_ranks(graphs, data):
    """The JAX forward, loss and gradients at one rank, and every rank's
    results under each lowering (one spawn of RANKS_W gloo ranks)."""
    _, ref_g = graphs
    x, y, params = data
    jmodel = JaxGraphCast(comm=JAX_COMM, latent=LATENT, processor_layers=LAYERS,
                          out_channels=CH)
    mask = jnp.asarray(ref_g.grid_mask[0])
    want = to_global(np.asarray(jmodel.apply(params, jnp.asarray(x[0]), jax_statics(ref_g),
                                             jax_plans(ref_g)))[None], ref_g.grid_ren)
    vg = jax_value_and_grad(jmodel, mask, jax_statics(ref_g), jax_plans(ref_g))
    want_loss, want_grads = vg(params, jnp.asarray(x[0]), jnp.asarray(y[0]))
    gw = build_graphcast_graphs(LEVEL, NLAT, NLON, RANKS_W)
    ds = SyntheticWeatherDataset(gw, NLAT, NLON, CH, num_samples=1)
    xw, yw = ds.get_sharded(0)
    case = {"graph": (LEVEL, NLAT, NLON), "x": xw, "y": yw,
            "model": dict(latent=LATENT, processor_layers=LAYERS, out_channels=CH),
            "params": {k: v.numpy() for k, v in
                       params_from_jax(jax.tree.map(np.asarray, params)).items()}}
    res = launch(torch_dist_ranks.graphcast_step0, RANKS_W, case, device="cpu",
                 timeout=TIMEOUT, threads=1)
    return gw, want, float(want_loss), want_grads, res


@pytest.mark.parametrize("impl", torch_dist_ranks.IMPLS)
def test_four_ranks_match_the_reference_at_one_rank(four_ranks, impl):
    gw, want, want_loss, want_grads, res = four_ranks
    want_p2p = chip_smoke.graphcast_launches(LAYERS, LATENT, p2p=impl == "pallas_p2p")
    for r in range(RANKS_W):
        assert set(res[r][impl][0].values()) == {impl}, res[r][impl][0]
        assert res[r][impl][4] == want_p2p["p2p_transport"]
    got = to_global(np.stack([res[r][impl][1] for r in range(RANKS_W)]), gw.grid_ren)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for r in range(RANKS_W):
        np.testing.assert_allclose(res[r][impl][2], want_loss, rtol=1e-5)
        want_g = params_from_jax(jax.tree.map(np.asarray, want_grads))
        for k, w in want_g.items():
            np.testing.assert_allclose(res[r][impl][3][k], w.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} {k}")
