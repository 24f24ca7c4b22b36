"""The port across ranks against the JAX package on the virtual CPU mesh.

The port's side runs in spawned gloo processes (``tests/torch_dist_ranks.py``,
which imports no JAX): one spawn per world size with every case inside it.
The JAX side runs here on the 8-device virtual mesh. Inputs are numpy arrays
made from seeds and handed over in a pickle.

- The halo exchange, its five lowerings (all_to_all; the p2p transport's
  plain version, ``sign=+1`` forward and ``sign=-1`` in the reverse leg;
  the ppermute, the overlap and the compiled schedule's rounds over gloo)
  and ``halo_scatter_sum``, forward and VJP, against the reference's
  all_to_all lowering: bit for bit, bit patterns compared (pure data
  movement and the same masked segment sums), except ppermute's reverse
  leg, which sums a delta at a time as the reference's ppermute lowering
  does and is held to that lowering on the virtual mesh, bit for bit:
  ``halo_scatter_sum`` adds the deltas' sums in delta order, the x VJP (JAX's
  transpose of the per-delta gathers) in reverse delta order (on W4-random
  either differs from all_to_all's flat sum in the last bit, so the order
  is what the check sees). 'sched' is also held to the reference's 'sched'
  lowering (its plan's schedule passed), every leg bit for bit, and the
  port's plan carries the reference's ``schedule_id``. The rows that
  masked send slots read, and the masked slots of the halo-side inputs,
  hold NaN and negative values: a mask applied as a multiply gives NaN and
  -0.0 there, as the reference's does, where a select would give +0.0. The
  blocks of a rank's halo buffer that no put or round reaches (its own,
  and those of dead deltas) are +0.0 on the p2p, ppermute and overlap
  routes, as the reference's transport and rounds
  define them (``pallas_p2p.py:228-231``, ``collectives.py:223``), where the
  all_to_all lowering delivers ``x * 0``; there those buffers are held to
  zeros. Under 'sched' the same holds row by row: the rows outside every
  round's window are +0.0, and its halo-side inputs are 0 there. The
  overlap pair with its rounds left in flight (``halo_exchange_overlap``,
  ``halo_scatter_sum_overlap``) is bit-equal to the inline one. Graphs:
  W = 2 and W = 4 random partitions, a W = 4 block partition of a ring
  whose live deltas are {1, 3} (n < W-1), and a W = 4 block partition
  whose traffic matrix splits two hub pairs across rounds, with windows of
  one block overlapping, a rank idle in every round and another idle in
  some.
- The GCN at W = 4 on the p2p split route: logits, loss and every parameter
  gradient against the reference's W = 4 step under the all_to_all
  lowering and under its overlap split, within 1e-5 (f32: the split groups
  the owner-side sums per subset); 5 Adam steps against optax (losses
  within 1e-4, parameters within 1e-3, as in ``test_torch_train.py``).
- The split ops against the unsplit ones (port against port, 1e-5):
  ``gather_scatter_overlap`` and the GCN layer's separable split branch.
- GAT at W = 2 and 4 under the ppermute and the overlap pins: step 0's
  logits, loss and gradients against the reference's GAT step on the
  virtual mesh (all_to_all) within 1e-4 (the attention's sums over edges
  and heads in another order, as ``test_torch_gat.py`` holds GAT).
- GCN and GAT at W = 4 under the 'sched' pin against the reference's step
  under its own 'sched' pin, within 1e-5 and 1e-4.
- GraphSAGE's split route under the overlap pin at W = 2 and 4: logits,
  loss and gradients against the reference's split route (its overlap
  lowering) within 1e-5.
- ``MessagePassing`` with a segment-sum layer at W = 1, 2 and 4 (the port
  under the all_to_all, ppermute and overlap pins, and at W = 2 and 4 the
  same under the fp8 wire pin against the reference's under it) against
  the reference's within 1e-6; under the 'sched' pin it raises the
  reference's error, as the reference's does (the facade's exchange takes
  no schedule); the communicators' ``put`` (bit for bit; at W = 1 the
  reference's shape check) and ``gather_concat`` (1e-6).
- The wire formats (``dgraph_tpu_torch.wire``): under bf16 and fp8 each of
  the five lowerings against the reference's same lowering under the same
  format on every halo case (W = 2 and 4), all four outputs bit for bit:
  'pallas_p2p' against the reference's 'all_to_all' (the reference's
  kernel does not run on the installed JAX), and the buffer and h VJP of
  'pallas_p2p' and 'ppermute' against 'all_to_all''s with the unreached
  blocks zeroed, as the checks without a format hold them. Under 'fp32'
  every lowering is bit-identical to the run without a format, with no
  codec call. GCN at W = 4 under fp8 on the p2p split route (kernel 5's
  plain version moving the encoded uint8 tiles) against the reference's
  step under fp8 (all_to_all): logits, loss and gradients within
  ``np_roundtrip_bound('fp8')`` of each value's scale (each leaf's
  largest magnitude; the loss), since layer 2's exchanged inputs differ
  at rounding between the split and unsplit sums and an fp8 code can flip.
- The CLI at two CPU ranks, and a rank that raises ends the launch.
"""

import json
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_ranks
from dgraph_tpu import config as jcfg
from dgraph_tpu.comm import Communicator, collectives
from dgraph_tpu.comm.mesh import GRAPH_AXIS, make_graph_mesh, plan_in_specs, squeeze_plan
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.models import GAT as JaxGAT
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models import GraphSAGE as JaxSAGE
from dgraph_tpu.models.message_passing import MessagePassing as JaxMessagePassing
from dgraph_tpu.ops import local as jax_local
from dgraph_tpu.plan import build_edge_plan as jax_build_edge_plan
from dgraph_tpu.plan import shard_vertex_data
from dgraph_tpu.train.loop import make_train_step as jax_make_train_step
from dgraph_tpu.train.loop import masked_cross_entropy as jax_masked_ce
from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data import synthetic
from dgraph_tpu_torch.models.message_passing import MessagePassing
from dgraph_tpu_torch.plan import build_edge_plan
from dgraph_tpu_torch.weights import params_from_jax, params_to_jax

F_HALO = 33
F_IN, HIDDEN, C, LR = 24, 160, 5, 5e-3
GAT_HIDDEN, GAT_HEADS = 64, 4  # two head groups of two (gather_col_block 128)
# (model, pinned lowering) of the GAT and GraphSAGE cases at each world size
MODEL_CASES = (("gat", "ppermute"), ("gat", "overlap"), ("sage", "overlap"))
SCHED_MODEL_CASES = (("gcn", "sched"), ("gat", "sched"))  # at W = 4
# (model, pinned lowering, wire format) at W = 4, and the reference's lowering
WIRE_MODEL_CASES = (("gcn", "pallas_p2p", "fp8", "all_to_all"),)
TIMEOUT = 120


def _model_cases(W: int) -> tuple:
    return MODEL_CASES + (SCHED_MODEL_CASES if W == 4 else ())


def _hub_graph(W=4, V=160, seed=5):
    """Edges of a W-rank block partition whose traffic matrix has two hub
    pairs (rank 1 -> 0 33 rows, 2 -> 1 21 rows) among pairs of 1-2 rows, and
    none to or from rank 3: the schedule splits both hubs across rounds, a
    round's height exceeds some of its transfers' rows, so windows of one
    block overlap, and rank 3 is idle in every round."""
    n = V // W
    rng = np.random.default_rng(seed)

    def cross(s, d, k):
        return np.stack([s * n + rng.choice(n, k, replace=False), d * n + rng.integers(0, n, k)])

    local = rng.integers(0, n, (2, 240)) + np.repeat(np.arange(W), 60) * n
    pairs = ((1, 0, 33), (2, 1, 21), (0, 1, 2), (0, 2, 1), (2, 0, 2))
    return (np.concatenate([local] + [cross(*p) for p in pairs], axis=1),
            np.repeat(np.arange(W), n))


def _halo_graphs(W: int) -> list:
    """(label, edges, partition) of the halo cases for world size W."""
    sbm = synthetic.sbm_classification_graph(num_nodes=240, num_classes=4, feat_dim=4, seed=3)
    new, ren = pt.partition_graph(sbm["edge_index"], 240, W, method="random", seed=1)
    cases = [(f"W{W}-random", new, np.asarray(ren.partition))]
    if W == 4:
        V = 160
        ring = np.arange(V)
        rng = np.random.default_rng(4)
        local = rng.integers(0, V // W, (2, 200)) + (rng.integers(0, W, 200) * (V // W))
        edges = np.concatenate([np.stack([ring, (ring + 1) % V]),
                                np.stack([(ring + 1) % V, ring]), local], axis=1)
        cases.append(("W4-block-ring", edges, np.repeat(np.arange(W), V // W)))
        cases.append(("W4-hub-split",) + _hub_graph())
    return cases


def _assert_bits_equal(a, b, msg=""):
    """Equal bit patterns: -0.0 differs from 0.0, and NaN equals only the
    same NaN."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype == np.float32, msg
    np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=msg)


def _landed(schedule, r: int) -> np.ndarray:
    """The rows of rank r's ``[W*S]`` halo buffer some round of ``schedule``
    lands a window in."""
    W, S = schedule.world_size, schedule.s_pad
    rows = np.zeros(W * S, bool)
    for rnd in schedule.rounds:
        for t in rnd.transfers:
            if t.dst == r:
                rows[t.src * S + t.row_start:t.src * S + t.row_start + rnd.row_count] = True
    return rows


def _unreached(W: int, r: int, deltas) -> list:
    """The blocks of rank r's ``[W, S, F]`` halo buffer no put reaches."""
    return sorted(set(range(W)) - {(r - d) % W for d in deltas})


def _with_specials(x, send_idx, send_mask, W, S, deltas):
    """The halo inputs with NaN and negative values where the send mask is
    0: ``x [W, n, F]`` in the rows masked slots read (every fifth column
    NaN), and the halo-shaped ``h``/``ct_halo [W, W*S, F]`` in the masked
    slots of the blocks a put reaches (negative, every fifth column NaN;
    the other blocks 0, the halo buffer's own values there)."""
    xs = x.copy()
    for r in range(W):
        xs[r, send_idx[r][send_mask[r] == 0], ::5] = np.nan

    def halo_side(a):
        a = a.copy().reshape(W, W, S, -1)
        for r in range(W):
            slots = a[r][send_mask[r] == 0]
            slots = -np.abs(slots)
            slots[:, ::5] = np.nan
            a[r][send_mask[r] == 0] = slots
            a[r][_unreached(W, r, deltas)] = 0.0
        return a.reshape(W, W * S, -1)

    return xs, halo_side


def _halo_inputs(label, edges, part, W, seed):
    plan, layout = jax_build_edge_plan(edges, part, world_size=W, overlap=True,
                                       use_native=False)
    rng = np.random.default_rng(seed)
    V, S, n = len(part), plan.halo.s_pad, plan.n_src_pad
    x = shard_vertex_data(rng.normal(size=(V, F_HALO)).astype(np.float32),
                          layout.src_counts, n)
    send_idx, send_mask = np.asarray(plan.halo.send_idx), np.asarray(plan.halo.send_mask)
    assert (send_mask == 0).any(), "no masked send slot to hold the special values"
    xs, halo_side = _with_specials(x, send_idx, send_mask, W, S, plan.halo_deltas)
    case = {
        "label": label, "edges": edges, "part": part, "x": x, "xs": xs,
        "put": rng.normal(size=(W, W, S, F_HALO)).astype(np.float32),
        "h": halo_side(rng.normal(size=(W, W * S, F_HALO)).astype(np.float32)),
        "ct_halo": halo_side(rng.normal(size=(W, W * S, F_HALO)).astype(np.float32)),
        "ct_owner": rng.normal(size=(W, n, F_HALO)).astype(np.float32),
    }
    # 'sched''s halo-side inputs: 0 on the rows no round lands, the halo
    # buffer's own values there (as the other blocks no round reaches)
    if plan.halo_schedule is not None:
        landed = np.stack([_landed(plan.halo_schedule, r) for r in range(W)])[..., None]
        for k in ("h", "ct_halo"):
            case[k + "_sched"] = np.where(landed, case[k], np.float32(0))
    return plan, case


def _jax_halo(plan, case, W, impl="all_to_all", wire_format=None):
    """The reference's ``impl`` lowering under ``wire_format`` (None: the
    fp32 identity): buffer, x's VJP, halo_scatter_sum and h's VJP, per rank
    (the plan's schedule passed, which only 'sched' reads)."""
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    n_pad = plan.n_src_pad

    def body(p, x, h, cth, cto):
        p, x, h, cth, cto = squeeze_plan(p), x[0], h[0], cth[0], cto[0]

        def ex(x_):
            return collectives.halo_exchange(x_, p.halo, GRAPH_AXIS, deltas=p.halo_deltas,
                                             impl=impl, schedule=p.halo_schedule,
                                             wire_format=wire_format)

        def unex(h_):
            return collectives.halo_scatter_sum(h_, p.halo, n_pad, GRAPH_AXIS,
                                                deltas=p.halo_deltas, impl=impl,
                                                schedule=p.halo_schedule,
                                                wire_format=wire_format)

        buf, vjp = jax.vjp(ex, x)
        back, vjp2 = jax.vjp(unex, h)
        return [a[None] for a in (buf, vjp(cth)[0], back, vjp2(cto)[0])]

    f = jax.shard_map(body, mesh=mesh, in_specs=(plan_in_specs(plan),) + (P(GRAPH_AXIS),) * 4,
                      out_specs=P(GRAPH_AXIS))
    with jax.set_mesh(mesh):
        out = jax.jit(f)(jax.tree.map(jnp.asarray, plan),
                         *(jnp.asarray(case[k]) for k in ("xs", "h", "ct_halo", "ct_owner")))
    return [np.asarray(a) for a in out]


@pytest.fixture
def pinned():
    saved = (jcfg.halo_impl, jcfg.use_pallas_p2p, jcfg.wire_format)
    yield
    jcfg.set_flags(halo_impl=saved[0], use_pallas_p2p=saved[1], wire_format=saved[2])


def _gcn_inputs():
    sbm = synthetic.sbm_classification_graph(num_nodes=300, num_classes=C, feat_dim=F_IN,
                                             seed=2)
    saved = jcfg.halo_impl
    jcfg.set_flags(halo_impl="overlap")  # the reference's auto rule attaches the split
    try:
        ref = JaxGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                   sbm["masks"], 4, partition_method="random",
                                   add_symmetric_norm=True, tune="off")
    finally:
        jcfg.set_flags(halo_impl=saved)
    assert ref.plan.overlap is not None
    model = JaxGCN(HIDDEN, C, comm=Communicator.init_process_group("single"))
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    params = model.init(jax.random.key(0), jnp.asarray(ref.features[0]), plan0,
                        jnp.asarray(ref.edge_weight[0]))
    sd = {k: v.numpy() for k, v in params_from_jax(params).items()}
    g = {"edges": sbm["edge_index"], "features": sbm["features"], "labels": sbm["labels"],
         "masks": sbm["masks"], "hidden": HIDDEN, "classes": C, "params": sd, "lr": LR}
    return ref, params, g


def _jax_model(model: str, comm):
    if model == "gat":
        return JaxGAT(GAT_HIDDEN, C, comm=comm, num_layers=2, num_heads=GAT_HEADS)
    if model == "sage":
        return JaxSAGE(HIDDEN, C, comm=comm)
    return JaxGCN(HIDDEN, C, comm=comm)


def _model_inputs(model: str, W: int) -> tuple:
    """(reference graph, flax params, the ranks' inputs) of GAT, GCN or
    GraphSAGE at W ranks on the GCN case's graph (random partition, the
    split attached as the reference's overlap pin attaches it; GCN's
    symmetric-norm edge weights)."""
    sbm = synthetic.sbm_classification_graph(num_nodes=300, num_classes=C, feat_dim=F_IN,
                                             seed=2)
    saved = jcfg.halo_impl
    jcfg.set_flags(halo_impl="overlap")
    try:
        ref = JaxGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                   sbm["masks"], W, partition_method="random",
                                   add_symmetric_norm=model == "gcn", tune="off")
    finally:
        jcfg.set_flags(halo_impl=saved)
    jmodel = _jax_model(model, Communicator.init_process_group("single"))
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    ew = [jnp.asarray(ref.edge_weight[0])] if model == "gcn" else []
    params = jmodel.init(jax.random.key(1), jnp.asarray(ref.features[0]), plan0, *ew)
    sd = {k: v.numpy() for k, v in params_from_jax(params).items()}
    g = {"model": model, "edges": sbm["edge_index"], "features": sbm["features"],
         "labels": sbm["labels"], "masks": sbm["masks"], "classes": C, "params": sd,
         "hidden": GAT_HIDDEN if model == "gat" else HIDDEN, "heads": GAT_HEADS}
    return ref, params, g


def _jax_step(ref, params, impl, model="gcn", W=4, wire="auto"):
    """(logits [W, n, C], loss, grads) of the reference's step 0 of
    ``model`` at W ranks under ``impl`` and the wire-format pin ``wire``."""
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    jmodel = _jax_model(model, Communicator.init_process_group("tpu", world_size=W))
    batch = {"x": jnp.asarray(ref.features), "y": jnp.asarray(ref.labels),
             "mask": jnp.asarray(ref.masks["train"])}
    if model == "gcn":
        batch["edge_weight"] = jnp.asarray(ref.edge_weight)
    plan = jax.tree.map(jnp.asarray, ref.plan)
    jcfg.set_flags(halo_impl=impl, wire_format=wire)

    def body(p, b, pl):
        from dgraph_tpu import compat

        pl = squeeze_plan(pl)
        b = jax.tree.map(lambda a: a[0], b)

        def lf(p_):
            logits = jmodel.apply(p_, b["x"], pl, *([b["edge_weight"]] if model == "gcn"
                                                    else []))
            return jax_masked_ce(logits, b["y"], b["mask"], GRAPH_AXIS), logits

        (loss, logits), grads = jax.value_and_grad(lf, has_aux=True)(p)
        grads = compat.sync_inbody_grads(grads, (GRAPH_AXIS,))
        return jax.lax.psum(loss, GRAPH_AXIS), logits[None], grads

    f = jax.shard_map(body, mesh=mesh,
                      in_specs=(P(), jax.tree.map(lambda _: P(GRAPH_AXIS), batch),
                                plan_in_specs(plan)),
                      out_specs=(P(), P(GRAPH_AXIS), P()),
                      **collectives.shard_map_checks(relax="grads replicated by psum"))
    with jax.set_mesh(mesh):
        loss, logits, grads = jax.jit(f)(params, batch, plan)
    return np.asarray(logits), float(loss), grads


def _jax_adam(ref, params):
    W = 4
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    model = JaxGCN(HIDDEN, C, comm=Communicator.init_process_group("tpu", world_size=W))
    batch = {"x": jnp.asarray(ref.features), "y": jnp.asarray(ref.labels),
             "mask": jnp.asarray(ref.masks["train"]),
             "edge_weight": jnp.asarray(ref.edge_weight)}
    plan = jax.tree.map(jnp.asarray, ref.plan)
    jcfg.set_flags(halo_impl="all_to_all")
    opt = optax.adam(LR)
    step = jax_make_train_step(model, opt, mesh, plan, donate=False)
    opt_state, losses = opt.init(params), []
    with jax.set_mesh(mesh):
        for _ in range(5):
            params, opt_state, m = step(params, opt_state, batch, plan)
            losses.append(float(m["loss"]))
    return losses, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{W: (inputs, per-rank results)} — one spawn per world size."""
    out = {}
    for W in (2, 4):
        halo = []
        for i, (label, edges, part) in enumerate(_halo_graphs(W)):
            plan, case = _halo_inputs(label, edges, part, W, seed=10 + i)
            halo.append((plan, case))
        models = [_model_inputs(m, W) for m, _ in _model_cases(W)]
        inputs = {"halo": [c for _, c in halo],
                  "models": [dict(g, impl=impl) for (_, _, g), (_, impl) in
                             zip(models, _model_cases(W))]}
        if W == 4:
            wire_models = [_model_inputs(m, W) for m, *_ in WIRE_MODEL_CASES]
            models += wire_models
            inputs["models"] += [dict(g, impl=impl, wire=wire) for (_, _, g), (_, impl, wire, _)
                                 in zip(wire_models, WIRE_MODEL_CASES)]
        gcn = None
        if W == 4:
            gcn = _gcn_inputs()
            inputs["gcn"] = gcn[2]
        path = tmp_path_factory.mktemp(f"w{W}") / "inputs.pkl"
        with open(path, "wb") as f:
            pickle.dump(inputs, f)
        res = launch(torch_dist_ranks.run_cases, W, str(path), device="cpu",
                     timeout=TIMEOUT, threads=1)
        out[W] = (halo, gcn, res, models)
    return out


HALO_CASES = [(2, 0), (4, 0), (4, 1), (4, 2)]
HALO_IDS = ["W2-random", "W4-random", "W4-block-ring", "W4-hub-split"]


@pytest.mark.parametrize("impl", torch_dist_ranks.IMPLS)
@pytest.mark.parametrize("W, i", HALO_CASES, ids=HALO_IDS)
def test_halo_lowerings_bitwise_equal_reference_all_to_all(ranks, W, i, impl):
    halo, _, res, _ = ranks[W]
    plan, case = halo[i]
    if impl == "sched":
        case = dict(case, h=case["h_sched"], ct_halo=case["ct_halo_sched"])
    want = _jax_halo(plan, case, W)
    want_own = _jax_halo(plan, case, W, impl) if impl in ("ppermute", "sched") else None
    S = plan.halo.s_pad
    for r in range(W):
        got = res[r]["halo"][i]
        assert tuple(got["deltas"]) == tuple(plan.halo_deltas)
        assert got["schedule_id"] == plan.halo_schedule.schedule_id
        for k, (name, a, b) in enumerate(zip(("buffer", "x VJP", "halo_scatter_sum", "h VJP"),
                                             got[impl], want)):
            b = b[r]
            if impl == "ppermute" and name in ("halo_scatter_sum", "x VJP"):
                _assert_bits_equal(a, want_own[k][r], f"rank {r} {name} (reference ppermute)")
                continue
            if impl == "sched":
                _assert_bits_equal(a, want_own[k][r], f"rank {r} {name} (reference sched)")
                if name in ("buffer", "h VJP"):
                    b = np.where(_landed(plan.halo_schedule, r)[:, None], b, np.float32(0))
            elif impl != "all_to_all" and name in ("buffer", "h VJP"):
                b = _zero_unreached(b, W, S, r, plan.halo_deltas)
            _assert_bits_equal(a, b, f"rank {r} {name}")


def _zero_unreached(b, W, S, r, deltas):
    b = b.reshape(W, S, -1).copy()
    b[_unreached(W, r, deltas)] = 0.0
    return b.reshape(W * S, -1)


_JAX_WIRE: dict = {}


def _jax_halo_wire(ranks, W, i, impl, fmt):
    """The reference's ``impl`` lowering under ``fmt`` on halo case (W, i),
    on 'sched''s own halo-side inputs under 'sched' (computed once)."""
    key = (W, i, impl, fmt)
    if key not in _JAX_WIRE:
        plan, case = ranks[W][0][i]
        if impl == "sched":
            case = dict(case, h=case["h_sched"], ct_halo=case["ct_halo_sched"])
        _JAX_WIRE[key] = _jax_halo(plan, case, W, impl, fmt)
    return _JAX_WIRE[key]


LEGS = ("buffer", "x VJP", "halo_scatter_sum", "h VJP")


@pytest.mark.parametrize("fmt", torch_dist_ranks.WIRE_FORMATS)
@pytest.mark.parametrize("impl", torch_dist_ranks.IMPLS)
@pytest.mark.parametrize("W, i", HALO_CASES, ids=HALO_IDS)
def test_halo_lowerings_under_wire_format_bitwise_equal_reference(ranks, W, i, impl, fmt):
    """Each lowering under bf16 and fp8 (the codec inside both legs and both
    VJPs) against the reference's same lowering under the same format, bit
    for bit; 'pallas_p2p' against the reference's 'all_to_all', and the
    exchange-side outputs of 'pallas_p2p' and 'ppermute' against
    'all_to_all''s with the unreached blocks zeroed."""
    plan, _ = ranks[W][0][i]
    S = plan.halo.s_pad
    own = _jax_halo_wire(ranks, W, i, "all_to_all" if impl == "pallas_p2p" else impl, fmt)
    a2a = (_jax_halo_wire(ranks, W, i, "all_to_all", fmt) if impl in ("pallas_p2p", "ppermute")
           else None)
    for r, res in enumerate(ranks[W][2]):
        got = res["halo"][i][(fmt, impl)]
        for k, name in enumerate(LEGS):
            want = own[k][r]
            if a2a is not None and name in ("buffer", "h VJP"):
                want = _zero_unreached(a2a[k][r], W, S, r, plan.halo_deltas)
            _assert_bits_equal(got[k], want, f"rank {r} {name} {impl} {fmt}")


@pytest.mark.parametrize("impl", torch_dist_ranks.IMPLS)
@pytest.mark.parametrize("W, i", HALO_CASES, ids=HALO_IDS)
def test_fp32_wire_format_is_the_identity_with_no_codec_call(ranks, W, i, impl):
    """Under 'fp32' every lowering's four outputs are the bits of the run
    without a format, and no codec ran; the lossy turns ran the codec, one
    decode for each encode."""
    for r, res in enumerate(ranks[W][2]):
        got = res["halo"][i]
        for k, name in enumerate(LEGS):
            _assert_bits_equal(got[("fp32", impl)][k], got[impl][k], f"rank {r} {name}")
        assert got["fp32_codec_calls"] == {"encode": 0, "decode": 0}
        calls = got["codec_calls"]
        assert calls["encode"] == calls["decode"] > 0, calls


@pytest.mark.parametrize("W, i", HALO_CASES, ids=HALO_IDS)
def test_overlap_rounds_in_flight_equal_inline(ranks, W, i):
    """The overlap exchange and reverse with their rounds left in flight
    (a column view taken before the wait) give the inline lowering's bits."""
    for r, res in enumerate(ranks[W][2]):
        got = res["halo"][i]
        buf, back = got["overlap_pending"]
        _assert_bits_equal(buf, got["overlap"][0][:, :5], f"rank {r} buffer")
        _assert_bits_equal(back, got["overlap"][2], f"rank {r} halo_scatter_sum")


def test_halo_cases_mask_nan_and_negative_rows(ranks):
    """The bit comparisons above tell a multiply from a select: in the p2p
    buffers, slots their sender masked hold NaN and -0.0 (``x * 0``)."""
    masked = []
    for W, i in HALO_CASES:
        plan, _ = ranks[W][0][i]
        S, mask = plan.halo.s_pad, np.asarray(plan.halo.send_mask)
        for p in range(W):
            buf = ranks[W][2][p]["halo"][i]["pallas_p2p"][0].reshape(W, S, -1)
            for r in range(W):  # block r of rank p's buffer: rank r's sends to p
                if (p - r) % W in plan.halo_deltas:
                    masked.append(buf[r][mask[r, p] == 0].ravel())
    masked = np.concatenate(masked)
    assert np.isnan(masked).any() and np.signbit(masked[masked == 0]).any()
    assert not (masked[~np.isnan(masked)] != 0).any()


@pytest.mark.parametrize("W", [2, 4])
def test_split_ops_match_unsplit(ranks, W):
    """gather_scatter_overlap and the GCN's separable split branch against
    their unsplit forms on the same ranks, within 1e-5 (the split groups
    the owner-side sums per subset)."""
    for r, res in enumerate(ranks[W][2]):
        got = res["split_ops"]
        assert got["split"], f"rank {r} did not take the split route"
        np.testing.assert_allclose(got["gso"], got["gs"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["layer_split"], got["layer_unsplit"], rtol=1e-5,
                                   atol=1e-5)


def test_block_ring_has_sparse_deltas(ranks):
    plan, _ = ranks[4][0][1]
    assert plan.halo_deltas == (1, 3)


def test_hub_case_splits_hubs_and_idles_ranks(ranks):
    """The hub case's schedule is what its test claims: both hub pairs
    split across rounds, windows of one block overlapping across rounds,
    rank 3 idle in every round and rank 2 idle in some."""
    plan, _ = ranks[4][0][2]
    sched = plan.halo_schedule
    chunks = {}
    for rnd in sched.rounds:
        for t in rnd.transfers:
            chunks.setdefault((t.src, t.dst), []).append((t.row_start, rnd.row_count))
    assert len(chunks[(1, 0)]) > 1 and len(chunks[(2, 1)]) > 1
    assert any(a < b + cb and b < a + ca for ws in chunks.values()
               for i, (a, ca) in enumerate(ws) for b, cb in ws[i + 1:])
    busy = [{r for t in rnd.transfers for r in (t.src, t.dst)} for rnd in sched.rounds]
    assert not any(3 in b for b in busy)
    assert any(2 in b for b in busy) and any(2 not in b for b in busy)


def _assert_grads(got: dict, want, tol):
    want_sd = {k: v.numpy() for k, v in params_from_jax(want).items()}
    assert got.keys() == want_sd.keys()
    for k in want_sd:
        np.testing.assert_allclose(got[k], want_sd[k], rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("impl", ["all_to_all", "overlap"])
def test_gcn_p2p_split_matches_reference(ranks, pinned, impl):
    _, (ref, params, _), res, _ = ranks[4]
    logits, loss, grads = _jax_step(ref, params, impl)
    for r in range(4):
        got = res[r]["gcn"]
        assert got["split"]
        np.testing.assert_allclose(got["logits"], logits[r], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5, atol=1e-5)
        _assert_grads(got["grads"], grads, 1e-5)


def test_gcn_ranks_hold_equal_parameters(ranks):
    res = ranks[4][2]
    for r in range(1, 4):
        for k, v in res[0]["gcn"]["params"].items():
            _assert_bits_equal(res[r]["gcn"]["params"][k], v, k)


def test_five_adam_steps_at_w4_match_optax(ranks, pinned):
    _, (ref, params, _), res, _ = ranks[4]
    want_losses, want_params = _jax_adam(ref, params)
    got = res[0]["gcn"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=1e-4, atol=1e-4)
    assert got["losses"][-1] < got["losses"][0]
    flat = params_to_jax({k: torch.from_numpy(v) for k, v in got["params"].items()})
    jax.tree.map(lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                                         rtol=1e-3, atol=1e-3),
                 flat, want_params)


def _check_model_step(ranks, W, k, want_impl, tol, jax_impl):
    ref, params, _ = ranks[W][3][k]
    model = _model_cases(W)[k][0]
    logits, loss, grads = _jax_step(ref, params, jax_impl, model, W)
    for r, res in enumerate(ranks[W][2]):
        got = res["models"][k]
        assert got["impl"] == want_impl, f"rank {r} resolved {got['impl']}"
        np.testing.assert_allclose(got["logits"], logits[r], rtol=tol, atol=tol)
        np.testing.assert_allclose(got["loss"], loss, rtol=tol, atol=tol)
        _assert_grads(got["grads"], grads, tol)
    return [res["models"][k] for res in ranks[W][2]]


@pytest.mark.parametrize("impl", ["ppermute", "overlap"])
@pytest.mark.parametrize("W", [2, 4])
def test_gat_over_ranks_matches_reference(ranks, pinned, W, impl):
    """GAT's step 0 over ranks (its one collective, the src-side
    halo_extend, under the pinned lowering) against the reference's GAT
    step under all_to_all, within 1e-4."""
    _check_model_step(ranks, W, MODEL_CASES.index(("gat", impl)), impl, 1e-4, "all_to_all")


@pytest.mark.parametrize("model, tol", [("gcn", 1e-5), ("gat", 1e-4)])
def test_sched_models_at_w4_match_reference_sched(ranks, pinned, model, tol):
    """GCN and GAT's step 0 at W = 4 under the 'sched' pin (every rank
    resolves 'sched', the unsplit route) against the reference's step under
    its own 'sched' pin, within the limits of the overlap cases (GCN's
    1e-5, GAT's 1e-4)."""
    got = _check_model_step(ranks, 4, _model_cases(4).index((model, "sched")), "sched", tol,
                            "sched")
    assert not any(g["split"] for g in got)


def test_gcn_fp8_wire_on_the_p2p_route_matches_reference_fp8(ranks, pinned):
    """GCN's step 0 at W = 4 under the fp8 pin on the p2p split route (the
    encoded uint8 tiles through kernel 5's plain version) against the
    reference's step under fp8 ('all_to_all'): every rank resolves
    'pallas_p2p' and 'fp8'; logits, loss and every gradient leaf within
    ``np_roundtrip_bound('fp8')`` times the largest magnitude of that value
    (the loss: of the loss), and the loss nearer the reference's fp8 loss
    than that is to the reference's f32 one. Without the codec the same step
    is held to 1e-5 (``test_gcn_p2p_split_matches_reference``)."""
    from dgraph_tpu.wire.spec import np_roundtrip_bound

    bound = np_roundtrip_bound("fp8")
    model, impl, wire, jax_impl = WIRE_MODEL_CASES[0]
    k = len(_model_cases(4))
    ref, params, _ = ranks[4][3][k]
    logits, loss, grads = _jax_step(ref, params, jax_impl, model, 4, wire)
    want_sd = {k2: v.numpy() for k2, v in params_from_jax(grads).items()}
    _, f32_loss, _ = _jax_step(ref, params, jax_impl, model, 4, "auto")
    assert abs(f32_loss - loss) > 0, "the fp8 step equals the f32 one: no codec ran"
    for r, res in enumerate(ranks[4][2]):
        got = res["models"][k]
        assert (got["impl"], got["wire"], got["split"]) == (impl, wire, True), got["impl"]
        scale = np.abs(logits[r]).max()
        np.testing.assert_allclose(got["logits"], logits[r], rtol=0, atol=bound * scale)
        assert abs(got["loss"] - loss) <= bound * abs(loss)
        for key, w in want_sd.items():
            np.testing.assert_allclose(got["grads"][key], w, rtol=0,
                                       atol=bound * np.abs(w).max(), err_msg=key)
        # and closer to the reference's fp8 step than fp8 is to f32
        assert abs(got["loss"] - loss) < abs(f32_loss - loss)


@pytest.mark.parametrize("W", [2, 4])
def test_sage_split_route_matches_reference(ranks, pinned, W):
    """GraphSAGE on the split route under 'overlap' against the reference's
    split route (its overlap lowering), within 1e-5."""
    k = MODEL_CASES.index(("sage", "overlap"))
    got = _check_model_step(ranks, W, k, "overlap", 1e-5, "overlap")
    assert all(g["split"] for g in got)


def _jax_message_passing(plan, x, W):
    """The reference's MessagePassing with the segment-sum layer, per rank."""

    def layer(full, p):
        m = full[p.src_index] * p.edge_mask[:, None]
        return jax_local.segment_sum(m, p.dst_index, p.n_dst_pad)

    if W == 1:
        mp = JaxMessagePassing(layer, Communicator.init_process_group("single"))
        p = jax.tree.map(lambda a: jnp.asarray(a[0]), plan)
        return np.asarray(mp.apply({}, jnp.asarray(x[0]), p))[None]
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    mp = JaxMessagePassing(layer, Communicator.init_process_group("tpu", world_size=W))
    f = jax.shard_map(lambda p, x_: mp.apply({}, x_[0], squeeze_plan(p))[None], mesh=mesh,
                      in_specs=(plan_in_specs(plan), P(GRAPH_AXIS)), out_specs=P(GRAPH_AXIS))
    with jax.set_mesh(mesh):
        return np.asarray(jax.jit(f)(jax.tree.map(jnp.asarray, plan), jnp.asarray(x)))


@pytest.mark.parametrize("W", [1, 2, 4])
def test_message_passing_matches_reference(ranks, W):
    """MessagePassing (exchange, [local ; halo], the layer) against the
    reference's at W = 1 and, under each pinned lowering, at W = 2 and 4,
    within 1e-6."""
    if W == 1:
        label, edges, part = _halo_graphs(2)[0]
        part = np.zeros_like(part)
        plan, case = _halo_inputs(label, edges, part, 1, seed=20)
        tplan = build_edge_plan(edges, part, world_size=1)[0].shard(0)
        got = [{"none": ("none", MessagePassing(torch_dist_ranks.mp_layer, SingleComm())(
            torch.from_numpy(case["x"][0]), tplan).numpy())}]
    else:
        plan, case = ranks[W][0][0]
        got = [res["message_passing"] for res in ranks[W][2]]
    want = _jax_message_passing(plan, case["x"], W)
    for r, per_impl in enumerate(got):
        for pin, (impl, out) in ((k, v) for k, v in per_impl.items() if isinstance(k, str)):
            assert impl == pin, f"rank {r} resolved {impl} under the pin {pin}"
            np.testing.assert_allclose(out, want[r], rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r} {impl}")


@pytest.mark.parametrize("W", [2, 4])
def test_message_passing_under_fp8_wire_matches_reference(ranks, pinned, W):
    """MessagePassing resolves the wire format as the reference's does
    (``message_passing.py:97-103``): under the fp8 pin each lowering of
    MP_IMPLS resolves 'fp8' and its output matches the reference's under
    the same pin within 1e-6 (the layer's sums in another order, as the
    f32 case)."""
    plan, case = ranks[W][0][0]
    jcfg.set_flags(wire_format="fp8")
    want = _jax_message_passing(plan, case["x"], W)
    for r, res in enumerate(ranks[W][2]):
        for pin in torch_dist_ranks.MP_IMPLS:
            impl, wire, out = res["message_passing"][("fp8", pin)]
            assert (impl, wire) == (pin, "fp8"), f"rank {r}: {impl}, {wire} under {pin}"
            np.testing.assert_allclose(out, want[r], rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r} {impl} fp8")
        # the payloads did ride the wire in fp8: the f32 output differs
        assert not np.array_equal(res["message_passing"]["all_to_all"][1],
                                  res["message_passing"][("fp8", "all_to_all")][2])


@pytest.mark.parametrize("W", [2, 4])
def test_message_passing_under_sched_raises_as_reference(ranks, pinned, W):
    """Under the 'sched' pin MessagePassing resolves 'sched' (the plan
    carries a schedule), and the communicator's exchange, which takes no
    schedule in either package, raises the reference's error."""
    plan, case = ranks[W][0][0]
    jcfg.set_flags(halo_impl="sched")
    with pytest.raises(ValueError) as ref:
        _jax_message_passing(plan, case["x"], W)
    assert "needs the plan's compiled halo schedule" in str(ref.value)
    for r, res in enumerate(ranks[W][2]):
        impl, err = res["message_passing_sched"]
        assert impl == "sched", f"rank {r} resolved {impl}"
        assert err == str(ref.value), f"rank {r}: {err}"


def _jax_facade(plan, case, W):
    """The reference's ``put`` and ``gather_concat`` (x, x), per rank."""
    if W == 1:
        comm = Communicator.init_process_group("single")
        p = jax.tree.map(lambda a: jnp.asarray(a[0]), plan)
        x = jnp.asarray(case["x"][0])
        return [{"put": np.asarray(comm.put(jnp.asarray(case["put"][0]))),
                 "gather_concat": np.asarray(comm.gather_concat(x, x, p))}]
    mesh = make_graph_mesh(ranks_per_graph=W, devices=jax.devices()[:W])
    comm = Communicator.init_process_group("tpu", world_size=W)

    def body(p, x, send):
        p, x = squeeze_plan(p), x[0]
        return comm.put(send[0])[None], comm.gather_concat(x, x, p)[None]

    f = jax.shard_map(body, mesh=mesh, in_specs=(plan_in_specs(plan),) + (P(GRAPH_AXIS),) * 2,
                      out_specs=P(GRAPH_AXIS))
    with jax.set_mesh(mesh):
        put, gc = jax.jit(f)(jax.tree.map(jnp.asarray, plan), jnp.asarray(case["x"]),
                             jnp.asarray(case["put"]))
    put, gc = np.asarray(put), np.asarray(gc)
    return [{"put": put[r], "gather_concat": gc[r]} for r in range(W)]


@pytest.mark.parametrize("W", [1, 2, 4])
def test_comm_put_and_gather_concat_match_reference(ranks, W):
    """``put`` delivers block p of each rank's stack to rank p (bit for
    bit) and ``gather_concat`` sets the src- and dst-side rows side by side
    (1e-6), as the reference's; at W = 1 ``put`` takes one block only."""
    if W == 1:
        label, edges, part = _halo_graphs(2)[0]
        part = np.zeros_like(part)
        plan, case = _halo_inputs(label, edges, part, 1, seed=21)
        comm = SingleComm()
        tplan = build_edge_plan(edges, part, world_size=1)[0].shard(0)
        x = torch.from_numpy(case["x"][0])
        got = [{"put": comm.put(torch.from_numpy(case["put"][0])).numpy(),
                "gather_concat": comm.gather_concat(x, x, tplan).numpy()}]
        with pytest.raises(ValueError, match="world_size 1"):
            comm.put(torch.zeros(2, 3, 4))
    else:
        plan, case = ranks[W][0][0]
        got = [res["facade"] for res in ranks[W][2]]
    want = _jax_facade(plan, case, W)
    for r in range(W):
        _assert_bits_equal(got[r]["put"], want[r]["put"], f"rank {r} put")
        np.testing.assert_allclose(got[r]["gather_concat"], want[r]["gather_concat"],
                                   rtol=1e-6, atol=1e-6, err_msg=f"rank {r} gather_concat")


def test_train_cli_two_cpu_ranks(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.train", "--device", "cpu", "--world_size", "2",
         "--epochs", "2", "--data.num_nodes", "400", "--log_path", str(tmp_path / "log.jsonl")],
        capture_output=True, text=True, timeout=TIMEOUT, check=True,
    ).stdout
    steps = [json.loads(line) for line in out.splitlines() if '"kind": "step"' in line]
    assert [s["step"] for s in steps] == [0, 1]
    assert steps[1]["loss"] < steps[0]["loss"]
    assert (tmp_path / "log.jsonl").read_text().count("\n") == len(out.splitlines())


def test_ranks_take_the_launchers_environment_at_each_launch(monkeypatch):
    """The ranks fork from a server started at the first launch; each
    launch still hands them the environment of that moment, and the config
    flags are read from it."""
    for impl in ("ppermute", "sched", None):
        if impl is None:
            monkeypatch.delenv("DGRAPH_TPU_HALO_IMPL", raising=False)
        else:
            monkeypatch.setenv("DGRAPH_TPU_HALO_IMPL", impl)
        got = launch(torch_dist_ranks.halo_impl_seen, 2, device="cpu", timeout=TIMEOUT,
                     threads=1)
        assert got == [(impl, impl or "auto")] * 2


def test_a_failing_rank_ends_the_launch():
    t = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 gives up"):
        launch(torch_dist_ranks.fail_on_rank1, 2, device="cpu", timeout=TIMEOUT, threads=1)
    assert time.perf_counter() - t < TIMEOUT
