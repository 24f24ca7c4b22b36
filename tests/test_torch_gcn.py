"""The port's GCN and GraphSAGE against the flax models, same graph, same
weights (carried across by ``params_from_jax``), one rank.

The JAX side runs its composed path on the CPU (dgraph_tpu/config.py:27-33);
the port runs the plain versions of its kernels. Hidden width 160 makes
``map_feature_chunks`` cut two chunks (128 + 32). Tolerances: f32 logits
rtol=atol=1e-4; bf16 rtol=atol=5e-2 (the two frameworks round bf16
intermediates at different places)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dgraph_tpu.comm import Communicator
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models import GraphSAGE as JaxSAGE
from dgraph_tpu.models.gcn import GraphConvLayer as JaxConv
from dgraph_tpu.plan import build_edge_plan as jax_build_edge_plan
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data import DistributedGraph, symmetric_norm_weights, synthetic
from dgraph_tpu_torch.models import GCN, GraphConvLayer, GraphSAGE
from dgraph_tpu_torch.ops import segment as seg
from dgraph_tpu_torch.plan import build_edge_plan, shard_edge_data
from dgraph_tpu_torch.weights import init_params, params_from_jax

F_IN, HIDDEN, C = 24, 160, 5
TOL = {"float32": 1e-4, "bfloat16": 5e-2}
DT = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
JAX_COMM = Communicator.init_process_group("single")


@pytest.fixture(scope="module")
def graphs():
    sbm = synthetic.sbm_classification_graph(num_nodes=300, num_classes=C,
                                             feat_dim=F_IN, seed=2)
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], 1)
    ours = DistributedGraph.from_global(*args, partition_method="random",
                                        add_symmetric_norm=True)
    ref = JaxGraph.from_global(*args, partition_method="random",
                               add_symmetric_norm=True, tune="off")
    return ours, ref


def _jax_rank0(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree)


def _close(got: torch.Tensor, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _run(jax_model, torch_model, jax_args, torch_args, seed=0):
    params = jax_model.init(jax.random.key(seed), *jax_args)
    want = jax_model.apply(params, *jax_args)
    torch_model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = torch_model(*torch_args)
    return got, want


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gcn_matches_flax(graphs, dtype, weighted):
    ours, ref = graphs
    jdt, tdt = DT[dtype]
    jax_args = (jnp.asarray(ref.features[0]), _jax_rank0(ref.plan))
    torch_args = (ours.features[0], ours.plan.shard(0))
    if weighted:
        jax_args += (jnp.asarray(ref.edge_weight[0]),)
        torch_args += (ours.edge_weight[0],)
    got, want = _run(JaxGCN(HIDDEN, C, comm=JAX_COMM, dtype=jdt),
                     GCN(F_IN, HIDDEN, C, SingleComm(), dtype=tdt), jax_args, torch_args)
    assert got.dtype == torch.float32 and got.shape == (ours.plan.n_src_pad, C)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sage_matches_flax(graphs, dtype):
    ours, ref = graphs
    jdt, tdt = DT[dtype]
    got, want = _run(JaxSAGE(HIDDEN, C, comm=JAX_COMM, dtype=jdt),
                     GraphSAGE(F_IN, HIDDEN, C, SingleComm(), dtype=tdt),
                     (jnp.asarray(ref.features[0]), _jax_rank0(ref.plan)),
                     (ours.features[0], ours.plan.shard(0)))
    _close(got, want, dtype)


def test_gcn_chunked_composed_route_matches_flax(graphs):
    """A bipartite (non-homogeneous) plan takes the chunked composed route."""
    ours, ref = graphs
    part = ours.ren.partition
    plan, layout = build_edge_plan(ours.edge_index, part, part, world_size=1)
    jplan, jlayout = jax_build_edge_plan(ref.edge_index, part, part, world_size=1,
                                         overlap=False)
    assert not plan.homogeneous
    w = symmetric_norm_weights(ours.edge_index, ours.num_nodes)
    ew = shard_edge_data(w, layout, plan.e_pad)
    got, want = _run(
        JaxGCN(HIDDEN, C, comm=JAX_COMM),
        GCN(F_IN, HIDDEN, C, SingleComm()),
        (jnp.asarray(ref.features[0]), _jax_rank0(jplan), jnp.asarray(ew[0])),
        (ours.features[0], plan.shard(0), torch.from_numpy(ew[0])),
    )
    _close(got, want, "float32")


def test_gcn_halo_side_aggregation_matches_flax(graphs):
    """aggregate_to='src' (the plan's halo side) takes the full-width
    fallback, scattering through the halo transpose."""
    ours, ref = graphs
    got, want = _run(
        JaxGCN(HIDDEN, C, comm=JAX_COMM, aggregate_to="src"),
        GCN(F_IN, HIDDEN, C, SingleComm(), aggregate_to="src"),
        (jnp.asarray(ref.features[0]), _jax_rank0(ref.plan), jnp.asarray(ref.edge_weight[0])),
        (ours.features[0], ours.plan.shard(0), ours.edge_weight[0]),
    )
    _close(got, want, "float32")


def test_conv_nonseparable_activation_matches_flax(graphs):
    """A non-relu activation takes the full-width fallback."""
    ours, ref = graphs
    got, want = _run(
        JaxConv(HIDDEN, comm=JAX_COMM, activation=jnp.tanh),
        GraphConvLayer(F_IN, HIDDEN, SingleComm(), activation=torch.tanh),
        (jnp.asarray(ref.features[0]), _jax_rank0(ref.plan), jnp.asarray(ref.edge_weight[0])),
        (ours.features[0], ours.plan.shard(0), ours.edge_weight[0]),
    )
    _close(got, want, "float32")


def _count_calls(monkeypatch, name):
    calls = []
    orig = getattr(seg, name)

    def spy(data, *a, **k):
        calls.append(tuple(data.shape))
        return orig(data, *a, **k)

    monkeypatch.setattr(seg, name, spy)
    return calls


def test_gcn_fused_route_runs_the_fused_op_per_chunk(graphs, monkeypatch):
    """Two layers x two feature chunks = four fused aggregations per
    forward: the launches the serving path makes on a card."""
    ours, _ = graphs
    calls = _count_calls(monkeypatch, "sorted_segment_sum_bias_relu")
    model = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=1)
    with torch.no_grad():
        model(ours.features[0], ours.plan.shard(0), ours.edge_weight[0])
    assert [c[1] for c in calls] == [128, 32, 128, 32]


def test_sage_runs_the_sorted_sum_per_chunk_and_degree(graphs, monkeypatch):
    ours, _ = graphs
    calls = _count_calls(monkeypatch, "sorted_segment_sum")
    model = init_params(GraphSAGE(F_IN, HIDDEN, C, SingleComm()), seed=1)
    with torch.no_grad():
        model(ours.features[0], ours.plan.shard(0))
    # layer 1: one 24-wide chunk + degree; layer 2: 128 + 32 + degree
    assert [c[1] for c in calls] == [24, 1, 128, 32, 1]


def test_params_from_jax_layout(graphs):
    ours, ref = graphs
    params = JaxGCN(HIDDEN, C, comm=JAX_COMM).init(
        jax.random.key(0), jnp.asarray(ref.features[0]), _jax_rank0(ref.plan))
    sd = params_from_jax(params)
    model = GCN(F_IN, HIDDEN, C, SingleComm())
    assert set(sd) == set(model.state_dict())
    k = np.asarray(params["params"]["GraphConvLayer_0"]["src_proj"]["kernel"])
    np.testing.assert_array_equal(sd["GraphConvLayer_0.src_proj.weight"].numpy(), k.T)


def test_init_params_is_seeded():
    a = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=3).state_dict()
    b = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["GraphConvLayer_0.src_proj.weight"]
    assert abs(float(w.std()) - (1 / F_IN) ** 0.5) < 0.05
    assert float(a["GraphConvLayer_0.src_proj.bias"].abs().max()) == 0.0
