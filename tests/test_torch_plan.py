"""The port's host plan, partitioners and DistributedGraph against the
reference's, on the same numpy inputs: every EdgePlan leaf and static,
the layout, the renumbering and the sharded vertex/edge data must be
array-equal (the builders are integer code; nothing may differ)."""

import numpy as np
import pytest

from dgraph_tpu import partition as jax_partition
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.plan import build_edge_plan as jax_build_edge_plan
from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.data import DistributedGraph, synthetic
from dgraph_tpu_torch.plan import build_edge_plan, validate_plan

STATICS = (
    "world_size", "n_src_pad", "n_dst_pad", "e_pad", "halo_side",
    "homogeneous", "owner_sorted", "scatter_mc", "scatter_block_e",
    "scatter_block_n", "halo_deltas", "halo_sort_mc", "gather_mv",
    "halo_pair_rows",
)
LEAVES = (
    "src_index", "dst_index", "edge_mask", "num_local_src", "num_local_dst",
    "num_edges", "halo_sort_perm", "halo_sorted_ids",
)


@pytest.fixture(scope="module")
def sbm():
    return synthetic.sbm_classification_graph(num_nodes=400, seed=1)


def assert_plans_equal(ours, ref):
    for name in STATICS:
        assert getattr(ours, name) == getattr(ref, name), name
    for name in LEAVES:
        a, b = getattr(ours, name), getattr(ref, name)
        if b is None:
            assert a is None, name
            continue
        a = a.numpy()
        b = np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ours.halo.s_pad == ref.halo.s_pad
    np.testing.assert_array_equal(ours.halo.send_idx.numpy(), np.asarray(ref.halo.send_idx))
    np.testing.assert_array_equal(ours.halo.send_mask.numpy(), np.asarray(ref.halo.send_mask))


def assert_layouts_equal(ours, ref):
    for name in ("edge_rank", "edge_slot", "halo_counts", "src_counts", "dst_counts"):
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)


def test_synthetic_data_matches_reference(sbm):
    from dgraph_tpu.data import synthetic as jax_synthetic

    ref = jax_synthetic.sbm_classification_graph(num_nodes=400, seed=1)
    for key in ("edge_index", "features", "labels"):
        np.testing.assert_array_equal(sbm[key], ref[key])
    for split in ref["masks"]:
        np.testing.assert_array_equal(sbm["masks"][split], ref["masks"][split])
    np.testing.assert_array_equal(synthetic.random_edges(50, 70, seed=3),
                                  jax_synthetic.random_edges(50, 70, seed=3))
    assert (synthetic.ARXIV_NODES, synthetic.ARXIV_EDGES) == (
        jax_synthetic.ARXIV_NODES, jax_synthetic.ARXIV_EDGES)


@pytest.mark.parametrize("method", ["random", "block", "round_robin", "rcm"])
@pytest.mark.parametrize("world", [1, 2, 3])
def test_partitioners_match_reference(sbm, method, world):
    new, ren = pt.partition_graph(sbm["edge_index"], 400, world, method=method, seed=5)
    new_ref, ren_ref = jax_partition.partition_graph(
        sbm["edge_index"], 400, world, method=method, seed=5)
    np.testing.assert_array_equal(new, new_ref)
    for name in ("perm", "inv", "partition", "counts", "offsets"):
        np.testing.assert_array_equal(getattr(ren, name), getattr(ren_ref, name))


@pytest.mark.parametrize("method", ["random", "rcm"])
@pytest.mark.parametrize("world", [1, 2])
def test_from_global_matches_reference(sbm, world, method):
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], world)
    g = DistributedGraph.from_global(*args, partition_method=method,
                                     add_symmetric_norm=True)
    ref = JaxGraph.from_global(*args, partition_method=method,
                               add_symmetric_norm=True, tune="off")
    assert_plans_equal(g.plan, ref.plan)
    assert_layouts_equal(g.layout, ref.layout)
    np.testing.assert_array_equal(g.edge_index, ref.edge_index)
    np.testing.assert_array_equal(g.features.numpy(), ref.features)
    np.testing.assert_array_equal(g.labels.numpy(), ref.labels)
    np.testing.assert_array_equal(g.vertex_mask.numpy(), ref.vertex_mask)
    np.testing.assert_array_equal(g.edge_weight.numpy(), ref.edge_weight)
    for split in ref.masks:
        np.testing.assert_array_equal(g.masks[split].numpy(), ref.masks[split])
    batch = g.batch("train")
    assert set(batch) == set(ref.batch("train"))
    validate_plan(g.plan)


@pytest.mark.parametrize(
    "kw",
    [
        dict(edge_owner="src"),
        dict(hetero=True),
        dict(sort_route=False, pad_multiple=4),
        dict(e_pad=2048, s_pad=256),
        dict(sort_edges=False),
    ],
    ids=["edge_owner_src", "bipartite", "no_sort_route", "explicit_pads", "unsorted"],
)
def test_build_edge_plan_matches_reference(sbm, kw):
    kw = dict(kw)
    new, ren = pt.partition_graph(sbm["edge_index"], 400, 2, method="random")
    dst_part = ren.partition if kw.pop("hetero", False) else None
    ours, lay = build_edge_plan(new, ren.partition, dst_part, world_size=2, **kw)
    ref, lay_ref = jax_build_edge_plan(new, ren.partition, dst_part, world_size=2,
                                       overlap=False, use_native=False, **kw)
    assert_plans_equal(ours, ref)
    assert_layouts_equal(lay, lay_ref)
    validate_plan(ours)


def test_kernel_scale_plan_aligns_e_pad_to_the_edge_block():
    edges = synthetic.random_edges(3000, 4000, seed=2)
    new, ren = pt.partition_graph(edges, 3000, 1, method="block")
    ours, _ = build_edge_plan(new, ren.partition, world_size=1)
    ref, _ = jax_build_edge_plan(new, ren.partition, world_size=1, overlap=False,
                                 use_native=False)
    assert ours.e_pad % 1024 == 0 and ours.e_pad >= 8000
    assert_plans_equal(ours, ref)


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(e_pad=1003), "pad_multiple"),
        (dict(s_pad=12), "pad_multiple"),
        (dict(e_pad=8), "e_pad=8 <"),
        (dict(pad_multiple=0), "pad_multiple=0"),
        (dict(edge_owner="both"), "edge_owner"),
    ],
)
def test_build_edge_plan_rejects_bad_knobs(sbm, kw, match):
    new, ren = pt.partition_graph(sbm["edge_index"], 400, 2, method="random")
    with pytest.raises(ValueError, match=match):
        build_edge_plan(new, ren.partition, world_size=2, **kw)
    with pytest.raises(ValueError):
        jax_build_edge_plan(new, ren.partition, world_size=2, overlap=False, **kw)


def test_non_contiguous_partition_rejected(sbm):
    part = pt.random_partition(400, 2)
    with pytest.raises(ValueError, match="contiguous"):
        build_edge_plan(sbm["edge_index"], part, world_size=2)


def test_validate_plan_catches_corruption(sbm):
    import dataclasses

    new, ren = pt.partition_graph(sbm["edge_index"], 400, 2, method="random")
    plan, _ = build_edge_plan(new, ren.partition, world_size=2)
    bad = plan.src_index.clone()
    bad[0, 0] = plan.n_src_pad + 2 * plan.halo.s_pad  # past the halo rows
    with pytest.raises(ValueError, match="src_index"):
        validate_plan(dataclasses.replace(plan, src_index=bad))
    perm = plan.halo_sort_perm.clone()
    perm[1, :2] = 0
    with pytest.raises(ValueError, match="permutation"):
        validate_plan(dataclasses.replace(plan, halo_sort_perm=perm))


def test_shard_and_to_keep_statics(sbm):
    g = DistributedGraph.from_global(sbm["edge_index"], sbm["features"], None, None, 2,
                                     partition_method="random")
    view = g.plan.to("cpu").shard(1)
    assert view.per_rank and view.e_pad == g.plan.e_pad
    assert view.src_index.shape == (g.plan.e_pad,)
    assert view.halo.send_idx.shape == (2, g.plan.halo.s_pad)
    assert view.ids_sorted("dst") and not view.ids_sorted("src")
    with pytest.raises(ValueError):
        view.shard(0)
    rank, slot = g.id_map()
    assert (g.features[rank, slot].numpy() == sbm["features"]).all()
