"""The port's graph transformer (GPS layers: local message passing, global
attention over every vertex, FFN) and its MLP against the JAX package's,
one rank, same graph, same weights (carried across by ``params_from_jax``).

The flax models run with ``SingleComm`` on the CPU (``seq_attention`` is the
dense oracle there); the port runs the plain path (``dense_attention``, the
kernels' plain versions). The graph is the reference test's
(tests/test_graph_transformer.py): a 400-vertex SBM of seed 1, latent 32, 4
heads, 2 layers; latent 256 makes the local branch cut two feature chunks
(128 + 128) at head width 64. A 397-vertex SBM of the same seed has padded
vertex slots (n_pad = 400), so the attention's key mask engages.

Tolerances (f32, rtol=atol): the MLP 1e-5; logits 1e-4 (both sides compute
in f32 and differ in summation order only: attention sums over every
vertex). Padded vertex rows of every layer's output are exactly zero.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dgraph_tpu.comm import Communicator
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.models import GraphTransformer as JaxGT
from dgraph_tpu.models.mlp import MLP as JaxMLP
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data import DistributedGraph, synthetic
from dgraph_tpu_torch.models import MLP, GPSLayer, GraphTransformer
from dgraph_tpu_torch.weights import params_from_jax, params_to_jax

JAX_COMM = Communicator.init_process_group("single")
C, HEADS, LAYERS = 4, 4, 2


def _graphs(num_nodes):
    sbm = synthetic.sbm_classification_graph(num_nodes=num_nodes, seed=1)
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], 1)
    ours = DistributedGraph.from_global(*args, partition_method="random",
                                        add_symmetric_norm=True)
    ref = JaxGraph.from_global(*args, partition_method="random", add_symmetric_norm=True,
                               tune="off")
    return ours, ref


@pytest.fixture(scope="module")
def graphs():
    return _graphs(400)


@pytest.fixture(scope="module")
def padded_graphs():
    return _graphs(397)


def _jax_args(ref):
    return (jnp.asarray(ref.features[0]), jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan),
            jnp.asarray(ref.vertex_mask[0]))


def _models(graphs, latent, seed=0):
    """(flax params, flax logits, the port's model loaded with the params)."""
    ours, ref = graphs
    jmodel = JaxGT(latent=latent, out_features=C, comm=JAX_COMM, num_layers=LAYERS,
                   num_heads=HEADS)
    jargs = _jax_args(ref)
    params = jmodel.init(jax.random.key(seed), *jargs)
    tmodel = GraphTransformer(ours.features.shape[-1], latent, C, SingleComm(),
                              num_layers=LAYERS, num_heads=HEADS)
    tmodel.load_state_dict(params_from_jax(params))
    return params, np.asarray(jmodel.apply(params, *jargs)), tmodel


def _apply(tmodel, ours):
    return tmodel(ours.features[0], ours.plan.shard(0), ours.vertex_mask[0])


@pytest.mark.parametrize("use_layer_norm", [False, True])
def test_mlp_matches_flax(use_layer_norm):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 12)).astype(np.float32)
    jmodel = JaxMLP([24, 7], use_layer_norm=use_layer_norm)
    params = jmodel.init(jax.random.key(1), jnp.asarray(x))
    tmodel = MLP(12, [24, 7], use_layer_norm=use_layer_norm)
    tmodel.load_state_dict(params_from_jax(params))
    np.testing.assert_allclose(tmodel(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jmodel.apply(params, jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("latent,padded", [(32, False), (256, False), (32, True)])
def test_logits_match_flax(graphs, padded_graphs, latent, padded):
    graphs = padded_graphs if padded else graphs
    ours, _ = graphs
    assert bool((ours.vertex_mask[0] == 0).any()) == padded
    _, want, tmodel = _models(graphs, latent)
    with torch.no_grad():
        got = _apply(tmodel, ours)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_padded_rows_stay_exactly_zero(padded_graphs):
    """Every GPS layer's output is exactly zero on padded vertex slots (they
    feed the next layer's local take), and real rows are not."""
    ours, _ = padded_graphs
    _, _, tmodel = _models(padded_graphs, 32)
    pad = ours.vertex_mask[0] == 0
    outs = []
    hooks = [m.register_forward_hook(lambda mod, a, out: outs.append(out.detach()))
             for m in tmodel.modules() if isinstance(m, GPSLayer)]
    try:
        with torch.no_grad():
            _apply(tmodel, ours)
    finally:
        for h in hooks:
            h.remove()
    assert len(outs) == LAYERS
    for out in outs:
        assert torch.equal(out[pad], torch.zeros_like(out[pad]))
        assert (out[~pad].abs().sum(-1) > 0).all()


def test_names_map_one_to_one_and_round_trip(graphs):
    """Every flax leaf has its state_dict key (load_state_dict is strict)
    and params_to_jax gives the flax tree back exactly."""
    params, _, tmodel = _models(graphs, 32, seed=3)
    keys = set(tmodel.state_dict())
    assert {"embed.weight", "head.bias", "gps_1.src_proj.weight", "gps_0.ffn.Dense_1.weight",
            "gps_0.ln_attn.weight"} <= keys and "gps_0.src_proj.bias" not in keys
    back = params_to_jax(tmodel.state_dict(), tmodel)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    assert flat_back.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_array_equal(flat_back[path], np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


def test_vmask_defaults_to_all_real_at_one_rank(graphs):
    """Without vmask every row counts as real (flax's single-rank default)."""
    ours, ref = graphs
    jmodel = JaxGT(latent=32, out_features=C, comm=JAX_COMM, num_layers=1, num_heads=HEADS)
    x, plan, _ = _jax_args(ref)
    params = jmodel.init(jax.random.key(0), x, plan)
    tmodel = GraphTransformer(ours.features.shape[-1], 32, C, SingleComm(), num_layers=1,
                              num_heads=HEADS)
    tmodel.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = tmodel(ours.features[0], ours.plan.shard(0))
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply(params, x, plan)),
                               rtol=1e-4, atol=1e-4)


def test_latent_not_divisible_by_heads_raises():
    with pytest.raises(ValueError, match="not divisible by heads"):
        GPSLayer(30, SingleComm(), num_heads=4)
