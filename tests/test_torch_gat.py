"""The port's GAT, its edge pipeline (``head_chunked_attention``) and the
segment ops it runs (``segment_max``, ``segment_mean``,
``segment_softmax``) against the JAX package's, on the CPU, same inputs
(made from seeded numpy generators), same weights (carried across by
``params_from_jax``).

The flax side runs with ``SingleComm``; the port runs its plain path, with
the sorted segment-sum kernel's plain version wherever the card runs the
kernel. Hidden width 64 with 4 heads makes ``head_chunked_attention`` cut
two head groups of 2 heads (``gather_col_block`` 128 // 64).

Tolerances (f32, rtol=atol): the segment ops, forward and gradients, 1e-5;
the attention pipeline and GAT logits 1e-4 (sums over edges and heads in
another order); the weight round trip exact.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dgraph_tpu.comm import Communicator
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.models import GAT as JaxGAT
from dgraph_tpu.models.message_passing import head_chunked_attention as jax_hca
from dgraph_tpu.ops import local as jax_local
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data import DistributedGraph, synthetic
from dgraph_tpu_torch.models import GAT, GATConv
from dgraph_tpu_torch.models.message_passing import head_chunked_attention
from dgraph_tpu_torch.ops import local
from dgraph_tpu_torch.weights import init_params, param_kinds, params_from_jax, params_to_jax

JAX_COMM = Communicator.init_process_group("single")
C, HIDDEN, HEADS = 4, 64, 4
E, N = 600, 50


def _ids(sorted_ids: bool, seed=0):
    """(ids [E] int32, mask [E] f32): real edges on segments [0, N - 10)
    (the last ten and every segment not drawn are empty), 20 % masked. With
    ``sorted_ids`` as a plan lays them out: sorted, the masked edges at the
    end with the out-of-range id N; otherwise shuffled, masked edges keeping
    in-range ids."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N - 10, E)
    ids[::7] = 5  # a hub
    mask = (rng.random(E) > 0.2).astype(np.float32)
    if sorted_ids:
        live = np.sort(ids[mask > 0])
        ids = np.concatenate([live, np.full(E - live.size, N)])
        mask = (np.arange(E) < live.size).astype(np.float32)
    return ids.astype(np.int32), mask


def _data(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _both(fn_jax, fn_torch, arrays, cot):
    """(forward, gradients) of JAX and of torch on the same numpy
    ``arrays``, the gradients those of sum(out * cot) with non-finite
    outputs zeroed."""
    def jloss(*xs):
        out = fn_jax(*xs)
        return (jnp.where(jnp.isfinite(out), out, 0.0) * cot).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(arrays))),
                                           has_aux=True)(*map(jnp.asarray, arrays))
    leaves = [torch.tensor(a, requires_grad=True) for a in arrays]
    tout = fn_torch(*leaves)
    (torch.where(torch.isfinite(tout), tout, 0.0) * torch.from_numpy(cot)).sum().backward()
    return (np.asarray(jout), tout.detach().numpy()), [
        (np.asarray(g), t.grad.numpy()) for g, t in zip(jgrads, leaves)]


def _close(pairs, tol):
    for want, got in pairs:
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("op", ["segment_max", "segment_mean"])
def test_segment_max_and_mean_match_reference(op, sorted_ids):
    ids, _ = _ids(sorted_ids)
    x = _data((E, 3), 1)
    kw = {"indices_are_sorted": sorted_ids} if op == "segment_max" else {}
    jfn, tfn = getattr(jax_local, op), getattr(local, op)
    out, grads = _both(lambda d: jfn(d, jnp.asarray(ids), N, **kw),
                       lambda d: tfn(d, torch.from_numpy(ids), N), [x],
                       _data((N, 3), 2))
    if op == "segment_max":  # empty segments give -inf on both sides
        assert np.isneginf(out[0][N - 10:]).all() and np.isneginf(out[1][N - 10:]).all()
    _close([out] + grads, 1e-5)


def test_segment_max_shares_the_gradient_among_ties():
    """Tied maxima share the segment's gradient evenly, as JAX's scatter
    max shares it."""
    data = np.array([[1.0], [1.0], [2.0], [-1.0]], np.float32)
    ids = np.array([0, 0, 1, 2], np.int32)
    out, grads = _both(lambda d: jax_local.segment_max(d, jnp.asarray(ids), 3),
                       lambda d: local.segment_max(d, torch.from_numpy(ids), 3), [data],
                       np.ones((3, 1), np.float32))
    np.testing.assert_array_equal(grads[0][1].ravel(), [0.5, 0.5, 1.0, 1.0])
    _close([out] + grads, 0.0)


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_segment_softmax_matches_reference(sorted_ids):
    ids, mask = _ids(sorted_ids)
    logits = 3 * _data((E, 2), 3)
    out, grads = _both(
        lambda l: jax_local.segment_softmax(l, jnp.asarray(ids), N, jnp.asarray(mask),
                                            indices_are_sorted=sorted_ids),
        lambda l: local.segment_softmax(l, torch.from_numpy(ids), N, torch.from_numpy(mask),
                                        indices_are_sorted=sorted_ids),
        [logits], _data((E, 2), 4))
    assert (out[1][mask == 0] == 0).all()  # masked edges weigh 0
    # each non-empty segment's live weights sum to one
    sums = np.zeros((N + 1, 2))
    np.add.at(sums, np.where(mask > 0, ids, N), out[1])
    live = np.isin(np.arange(N), ids[mask > 0])
    np.testing.assert_allclose(sums[:N][live], 1.0, rtol=1e-5)
    _close([out] + grads, 1e-5)


def test_segment_softmax_sorted_route_uses_the_sorted_sum(monkeypatch):
    """With sorted ids the denominator is the sorted segment sum (kernel 2
    on a card) and the two row lookups are sorted takes, whose backward is
    that sum too: one call in the forward, two more in the backward."""
    from dgraph_tpu_torch.ops import segment as seg

    calls = []
    real = seg._segment_sum
    monkeypatch.setattr(seg, "_segment_sum",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    ids, mask = _ids(True)
    logits = torch.tensor(_data((E, 2), 3), requires_grad=True)
    out = local.segment_softmax(logits, torch.from_numpy(ids), N, torch.from_numpy(mask),
                                indices_are_sorted=True)
    assert calls == [(E, 2)]
    out.sum().backward()
    assert calls == [(E, 2)] * 3


@pytest.fixture(scope="module")
def graphs():
    sbm = synthetic.sbm_classification_graph(num_nodes=400, seed=1)
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], 1)
    ours = DistributedGraph.from_global(*args, partition_method="random")
    ref = JaxGraph.from_global(*args, partition_method="random", tune="off")
    return ours, ref


def test_head_chunked_attention_matches_reference(graphs):
    ours, ref = graphs
    plan_j = jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan)
    plan_t = ours.plan.shard(0)
    n = plan_t.n_src_pad
    arrays = [_data((n, HEADS * HIDDEN), 5), _data((n, HEADS * HIDDEN), 6),
              _data((HEADS, HIDDEN), 7) / 8, _data((HEADS, HIDDEN), 8) / 8]
    out, grads = _both(
        lambda hs, hd, a, b: jax_hca(JAX_COMM, hs, hd, a, b, plan_j, 0.2),
        lambda hs, hd, a, b: head_chunked_attention(SingleComm(), hs, hd, a, b, plan_t, 0.2),
        arrays, _data((plan_t.n_dst_pad, HEADS, HIDDEN), 9))
    _close([out] + grads, 1e-4)


def test_head_chunked_attention_refuses_src_owned_plans(graphs):
    ours, _ = graphs
    plan = dataclasses.replace(ours.plan.shard(0), halo_side="dst")
    x = torch.zeros(plan.n_src_pad, HEADS * HIDDEN)
    a = torch.zeros(HEADS, HIDDEN)
    with pytest.raises(ValueError, match="requires dst-owned edges"):
        head_chunked_attention(SingleComm(), x, x, a, a, plan, 0.2)


def _gat(graphs, seed=0):
    """(flax params, flax logits, the port's GAT loaded with the params)."""
    ours, ref = graphs
    jmodel = JaxGAT(HIDDEN, C, comm=JAX_COMM, num_layers=2, num_heads=HEADS)
    jargs = (jnp.asarray(ref.features[0]), jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan))
    params = jmodel.init(jax.random.key(seed), *jargs)
    tmodel = GAT(ours.features.shape[-1], HIDDEN, C, SingleComm(), num_layers=2,
                 num_heads=HEADS)
    tmodel.load_state_dict(params_from_jax(params))
    return params, np.asarray(jmodel.apply(params, *jargs)), tmodel


def test_gat_logits_match_flax(graphs):
    ours, _ = graphs
    _, want, tmodel = _gat(graphs)
    with torch.no_grad():
        got = tmodel(ours.features[0], ours.plan.shard(0))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_gat_weights_round_trip_with_raw_parameters(graphs):
    """att_src and att_dst ([H, D] = [4, 64], raw self.param leaves) cross
    untransposed under their own names, both ways, with and without the
    module; the Dense kernels transpose."""
    params, _, tmodel = _gat(graphs, seed=4)
    p = params["params"]["GATConv_1"]
    sd = tmodel.state_dict()
    assert tuple(sd["GATConv_1.att_src"].shape) == (HEADS, HIDDEN)
    np.testing.assert_array_equal(sd["GATConv_1.att_src"].numpy(), np.asarray(p["att_src"]))
    np.testing.assert_array_equal(sd["GATConv_1.proj.weight"].numpy(),
                                  np.asarray(p["proj"]["kernel"]).T)
    kinds = param_kinds(tmodel)
    assert kinds["GATConv_0.att_dst"] == "att_dst" and kinds["Dense_0.weight"] == "kernel"
    for module in (tmodel, None):
        back = params_to_jax(sd, module)
        flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
        assert flat_back.keys() == flat_want.keys()
        for path, w in flat_want.items():
            np.testing.assert_array_equal(flat_back[path], np.asarray(w),
                                          err_msg=jax.tree_util.keystr(path))


def test_gat_conv_residual_loads_flax_tree_and_matches_forward(graphs):
    """GATConv(residual=True): a flax tree with the conv's ``res`` Dense
    (``res/kernel``) loads into the port's conv, comes back the same, and
    the forward equals the reference's within 1e-4 (GAT's limit); without
    the option the same tree does not load."""
    from dgraph_tpu.models.gat import GATConv as JaxGATConv

    ours, ref = graphs
    jconv = JaxGATConv(HIDDEN, comm=JAX_COMM, num_heads=HEADS, residual=True)
    jargs = (jnp.asarray(ref.features[0]), jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan))
    params = jconv.init(jax.random.key(3), *jargs)
    assert set(params["params"]) == {"proj", "att_src", "att_dst", "res"}
    sd = params_from_jax(params)
    conv = GATConv(ours.features.shape[-1], HIDDEN, SingleComm(), num_heads=HEADS,
                   residual=True)
    conv.load_state_dict(sd)
    np.testing.assert_array_equal(conv.res.weight.detach().numpy(),
                                  np.asarray(params["params"]["res"]["kernel"]).T)
    with torch.no_grad():
        got = conv(ours.features[0], ours.plan.shard(0))
    want = np.asarray(jconv.apply(params, *jargs))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    back = params_to_jax(conv.state_dict(), conv)
    np.testing.assert_array_equal(back["params"]["res"]["kernel"],
                                  np.asarray(params["params"]["res"]["kernel"]))
    plain = GATConv(ours.features.shape[-1], HIDDEN, SingleComm(), num_heads=HEADS)
    with pytest.raises(RuntimeError, match="res.weight"):
        plain.load_state_dict(sd)


def test_init_params_draws_attention_parameters_glorot_uniform():
    """init_params gives att_src/att_dst flax's glorot_uniform range,
    ±sqrt(6 / (H + D)), from the seed."""
    conv = GATConv(16, HIDDEN, SingleComm(), num_heads=HEADS)
    init_params(conv, seed=0)
    limit = np.sqrt(6 / (HEADS + HIDDEN))
    for p in (conv.att_src, conv.att_dst):
        assert p.abs().max() <= limit and p.abs().max() > 0.9 * limit
    again = init_params(GATConv(16, HIDDEN, SingleComm(), num_heads=HEADS), seed=0)
    assert torch.equal(again.att_src, conv.att_src)


@pytest.mark.parametrize("direction", ["from_jax", "to_jax"])
def test_weights_refuse_unknown_leaves(direction):
    """Only att_src and att_dst take the raw-leaf route: a misspelled flax
    leaf, or a buffer in a state_dict (a batch norm's running_mean), raises
    KeyError instead of crossing as a parameter."""
    leaf = np.zeros((HEADS, HIDDEN), np.float32)
    if direction == "from_jax":
        with pytest.raises(KeyError, match="GATConv_0/att_srcc"):
            params_from_jax({"params": {"GATConv_0": {"att_srcc": leaf}}})
    else:
        with pytest.raises(KeyError, match="norm.running_mean"):
            params_to_jax({"GATConv_0.att_src": torch.from_numpy(leaf),
                           "norm.running_mean": torch.zeros(HIDDEN)})
