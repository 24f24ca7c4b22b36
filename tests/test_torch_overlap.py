"""The port's interior/boundary split and halo-lowering resolution against
the JAX package's (host-only: no collective runs here).

- ``build_edge_plan(..., overlap=True)``: every ``OverlapSpec`` array and
  static and ``halo_deltas`` equal to the reference's, for W in {2, 4},
  random and block partitions;
- ``resolve_halo_impl``'s env > heuristic ladder and the pallas_p2p gates:
  the cases of ``tests/test_pallas_p2p.py``'s ``TestResolveP2PLadder`` that
  need no adopted record (the port has no record tier), on the port's
  resolver, and the pin's build-time rejections;
- the interior sum in ``DGRAPH_TPU_OVERLAP_CHUNKS`` edge-axis chunks: at
  chunks = 2 (and 3, and 1, the default) ``interior_scatter_sum`` and the
  split neighbour sum ``gather_scatter_overlap`` bit-equal to the
  reference's under the same setting on every rank of a W = 4 plan, the
  chunks counted at the sorted sum (capped at the live-delta count);
- 'sched' asked for by name with no schedule raises the reference's
  error; a 'sched' pin on a plan without a schedule warns and runs the
  heuristic's lowering, as a pin the plan cannot lower does in the
  reference; a plan that carries a schedule resolves 'sched', off the
  split route.
"""

import dataclasses

import numpy as np
import pytest
import torch

from dgraph_tpu import config as jcfg
from dgraph_tpu import plan as jpl
from dgraph_tpu_torch import config as cfg
from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch import plan as pl
from dgraph_tpu_torch.comm import collectives
from dgraph_tpu_torch.data import synthetic

OVERLAP_LEAVES = ("int_src", "int_dst", "int_mask", "int_epos", "bnd_src", "bnd_dst",
                  "bnd_mask", "bnd_epos", "num_interior", "num_boundary")
OVERLAP_STATICS = ("e_int_pad", "e_bnd_pad", "interior_mc", "boundary_mc")
FLAGS = ("halo_impl", "use_pallas_p2p", "overlap_interior_chunks")


@pytest.fixture
def flags():
    saved = {k: getattr(cfg, k) for k in FLAGS}
    jsaved = (jcfg.halo_impl, jcfg.tuned_halo_impl, jcfg.use_pallas_p2p,
              jcfg.overlap_interior_chunks)
    yield
    for k, v in saved.items():
        setattr(cfg, k, v)
    jcfg.set_flags(halo_impl=jsaved[0], tuned_halo_impl=jsaved[1], use_pallas_p2p=jsaved[2],
                   overlap_interior_chunks=jsaved[3])


def set_flags(**kw):
    for k, v in kw.items():
        setattr(cfg, k, v)


@pytest.mark.parametrize("method", ["random", "block"])
@pytest.mark.parametrize("W", [2, 4])
def test_overlap_spec_matches_reference(W, method):
    sbm = synthetic.sbm_classification_graph(num_nodes=400, seed=1)
    new, ren = pt.partition_graph(sbm["edge_index"], 400, W, method=method, seed=3)
    ours, _ = pl.build_edge_plan(new, ren.partition, world_size=W, overlap=True)
    ref, _ = jpl.build_edge_plan(new, ren.partition, world_size=W, overlap=True,
                                 use_native=False)
    assert ours.halo_deltas == ref.halo_deltas and ours.halo_pair_rows == ref.halo_pair_rows
    for name in OVERLAP_STATICS:
        assert getattr(ours.overlap, name) == getattr(ref.overlap, name), name
    for name in OVERLAP_LEAVES:
        a, b = getattr(ours.overlap, name).numpy(), np.asarray(getattr(ref.overlap, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    pl.validate_plan(ours)
    view = ours.shard(W - 1)
    assert view.overlap.int_src.shape == (ours.overlap.e_int_pad,)
    assert int(view.overlap.num_interior) + int(view.overlap.num_boundary) == int(
        view.num_edges)


@pytest.mark.parametrize("chunks", [2, 3, 1])
def test_interior_chunks_match_reference(flags, monkeypatch, chunks):
    import jax
    import jax.numpy as jnp

    from dgraph_tpu.comm import collectives as jcoll
    from dgraph_tpu_torch.ops import local as local_ops

    W, F = 4, 16
    sbm = synthetic.sbm_classification_graph(num_nodes=400, seed=1)
    new, ren = pt.partition_graph(sbm["edge_index"], 400, W, method="random", seed=3)
    ours, _ = pl.build_edge_plan(new, ren.partition, world_size=W, overlap=True)
    ref, _ = jpl.build_edge_plan(new, ren.partition, world_size=W, overlap=True,
                                 use_native=False)
    assert cfg.overlap_interior_chunks == 1  # the default: one sum
    assert ours.halo_deltas == (1, 2, 3)
    set_flags(overlap_interior_chunks=chunks)
    jcfg.set_flags(overlap_interior_chunks=chunks)
    assert collectives.interior_chunks(3) == chunks and collectives.interior_chunks(1) == 1
    calls = []
    summed = local_ops.sorted_segment_sum_any
    monkeypatch.setattr(local_ops, "sorted_segment_sum_any",
                        lambda *a, **k: calls.append(1) or summed(*a, **k))
    rng = np.random.default_rng(chunks)
    for r in range(W):
        view = ours.shard(r)
        jview = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[r]), ref)
        e_int = rng.normal(size=(ours.overlap.e_int_pad, F)).astype(np.float32)
        x = rng.normal(size=(ours.n_src_pad, F)).astype(np.float32)
        halo = rng.normal(size=(W * ours.halo.s_pad, F)).astype(np.float32)
        w = rng.uniform(0.5, 1.5, ours.e_pad).astype(np.float32)
        calls.clear()
        got = collectives.interior_scatter_sum(torch.from_numpy(e_int), view, "dst").numpy()
        assert len(calls) == chunks
        want = np.asarray(jcoll.interior_scatter_sum(jnp.asarray(e_int), jview, "dst"))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        got = collectives.gather_scatter_overlap(torch.from_numpy(x), torch.from_numpy(halo),
                                                 view, torch.from_numpy(w)).numpy()
        want = np.asarray(jcoll.gather_scatter_overlap(jnp.asarray(x), jnp.asarray(halo),
                                                       jview, jnp.asarray(w)))
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_validate_plan_catches_a_broken_split():
    sbm = synthetic.sbm_classification_graph(num_nodes=200, seed=1)
    new, ren = pt.partition_graph(sbm["edge_index"], 200, 2, method="random")
    plan, _ = pl.build_edge_plan(new, ren.partition, world_size=2, overlap=True)
    mask = plan.overlap.bnd_mask.clone()
    mask[0, 0] = 0
    bad = dataclasses.replace(plan, overlap=dataclasses.replace(plan.overlap, bnd_mask=mask))
    with pytest.raises(ValueError, match="does not tile"):
        pl.validate_plan(bad)


@pytest.mark.parametrize("pins, overlap, want", [
    (dict(halo_impl="pallas_p2p", use_pallas_p2p=True), True, ("pallas_p2p", "env")),
    (dict(halo_impl="all_to_all", use_pallas_p2p=True), True, ("all_to_all", "env")),
    (dict(halo_impl="overlap", use_pallas_p2p=True), True, ("overlap", "env")),
    (dict(halo_impl="pallas_p2p", use_pallas_p2p=False), True, ("overlap", "heuristic")),
    (dict(halo_impl="auto", use_pallas_p2p=True), True, ("overlap", "heuristic")),
], ids=["env_pin", "env_all_to_all", "env_overlap", "degrades_without_backend",
        "heuristic_never_picks_p2p"])
def test_resolve_ladder_matches_reference(flags, pins, overlap, want):
    set_flags(**pins)
    jcfg.set_flags(**pins, tuned_halo_impl=None)
    got = pl.resolve_halo_impl((1,), overlap_available=overlap)
    assert got == want == jpl.resolve_halo_impl(2, (1,), overlap_available=overlap)


def test_p2p_pin_degrades_without_split(flags):
    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=True)
    assert pl.resolve_halo_impl((1,), overlap_available=False) == ("all_to_all", "heuristic")


def test_p2p_availability_follows_the_device(flags):
    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=None)
    assert cfg.pallas_p2p_available("cuda") and not cfg.pallas_p2p_available("cpu")
    assert pl.resolve_halo_impl((1,), overlap_available=True, p2p_available=False) == (
        "overlap", "heuristic")


@pytest.mark.parametrize("W, deltas, rows", [
    (4, (1, 2, 3), ()), (4, (1, 3), ()), (8, (1,), ()), (2, (), ()),
    (4, (1, 2, 3), ((0, 50, 1, 1), (1, 0, 50, 1), (1, 1, 0, 50), (50, 1, 1, 0))),
])
def test_pick_halo_impl_matches_reference(W, deltas, rows):
    """The reference's heuristic with its sparse-peer-set choice,
    ``ppermute``, resolved to ``all_to_all`` (the port has no ppermute
    lowering); the same answer wherever the reference picks all_to_all or
    none."""
    ref = jpl.pick_halo_impl(W, deltas, rows)
    assert pl.pick_halo_impl(deltas) == ("all_to_all" if ref == "ppermute" else ref)


def test_p2p_intent_builds_split(flags):
    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=True)
    part = np.repeat(np.arange(2), 16)
    edges = np.stack([np.arange(32), (np.arange(32) + 1) % 32])
    plan, _ = pl.build_edge_plan(edges, part, world_size=2)  # overlap=None: auto
    assert plan.overlap is not None
    set_flags(halo_impl="auto")
    assert pl.build_edge_plan(edges, part, world_size=2)[0].overlap is None


@pytest.mark.parametrize("kw, match", [
    (dict(sort_edges=False, overlap=False), "pallas_p2p.*sort_edges"),
    (dict(s_pad=12, pad_multiple=1), "pallas_p2p.*s_pad"),
    (dict(pad_multiple=4), "pallas_p2p.*pad_multiple"),
])
def test_p2p_pin_rejects_knobs(flags, kw, match):
    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=True)
    jcfg.set_flags(halo_impl="pallas_p2p", use_pallas_p2p=True)
    part = np.repeat(np.arange(2), 16)
    edges = np.stack([np.arange(32), (np.arange(32) + 1) % 32])
    with pytest.raises(ValueError, match=match):
        pl.build_edge_plan(edges, part, world_size=2, **kw)
    with pytest.raises(ValueError, match=match):
        jpl.build_edge_plan(edges, part, world_size=2, **kw)


def test_unported_lowerings_raise(flags, caplog):
    """'sched' asked for by name with no schedule raises the reference's
    error (``collectives.py:771-777``, ``:853-858``); a 'sched' pin on a plan
    without a schedule warns once and the heuristic decides; a plan that
    carries a schedule resolves 'sched' off the split route. 'overlap' and
    'ppermute' resolve and run."""
    import logging

    @dataclasses.dataclass(frozen=True)
    class Group:
        device: torch.device = torch.device("cpu")

    part = np.repeat(np.arange(2), 16)
    edges = np.stack([np.arange(32), (np.arange(32) + 1) % 32])
    plan, _ = pl.build_edge_plan(edges, part, world_size=2, overlap=True)
    view = plan.shard(0)
    assert view.halo_schedule is not None
    for fn, args in ((collectives.halo_exchange, (torch.zeros(view.n_src_pad, 3), view.halo)),
                     (collectives.halo_scatter_sum,
                      (torch.zeros(2 * view.halo.s_pad, 3), view.halo, view.n_src_pad))):
        with pytest.raises(ValueError, match=rf"{fn.__name__}\(impl='sched'\) needs the plan's "
                           "compiled halo schedule; resolve through resolve_plan_impl and pass "
                           r"schedule=plan.halo_schedule"):
            fn(*args, group=Group(), deltas=view.halo_deltas, impl="sched")
    bare = dataclasses.replace(view, halo_schedule=None)
    set_flags(halo_impl="sched")  # a pin the plan cannot lower: warned once, the heuristic runs
    pl._warned.clear()
    with caplog.at_level(logging.WARNING):
        assert collectives.resolve_plan_impl(bare, Group()) == "overlap"
        assert collectives.resolve_plan_impl(bare, Group()) == "overlap"
    warned = [r for r in caplog.records if "'sched'" in r.getMessage()]
    assert len(warned) == 1 and "'overlap'" in warned[0].getMessage()
    assert collectives.resolve_plan_impl(view, Group()) == "sched"  # the plan has one
    assert not collectives.split_active(view, Group())
    assert not collectives.overlap_active(view, Group())
    set_flags(halo_impl="overlap")
    assert collectives.split_active(view, Group()) and collectives.overlap_active(view, Group())
    set_flags(halo_impl="auto")  # the split alone resolves to 'overlap' too
    assert collectives.resolve_plan_impl(view, Group()) == "overlap"
    set_flags(halo_impl="ppermute")
    assert collectives.resolve_plan_impl(view, Group()) == "ppermute"
    assert not collectives.split_active(view, Group())
    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=True)
    assert collectives.split_active(view, Group())
    assert not collectives.overlap_active(view, Group())
    assert not collectives.split_active(view)  # one rank: nothing to split


@pytest.mark.parametrize("overlap, fallback", [
    (True, "overlap"), (False, "all_to_all")], ids=["split", "no_split"])
def test_unlowerable_p2p_pin_warning_says_what_runs(flags, caplog, overlap, fallback):
    """A pallas_p2p pin the rank cannot run resolves as the reference does;
    the warning names the lowering it falls to (the 'overlap' rounds where
    the plan carries the split; ``test_torch_dist.py`` runs each)."""
    import logging

    set_flags(halo_impl="pallas_p2p", use_pallas_p2p=None)
    pl._warned.clear()
    with caplog.at_level(logging.WARNING):
        got = pl.resolve_halo_impl((1, 2, 3), overlap_available=overlap, p2p_available=False)
    assert got == (fallback, "heuristic")
    text = " ".join(r.getMessage() for r in caplog.records)
    assert repr(fallback) in text and "will raise" not in text
