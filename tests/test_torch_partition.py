"""The port's partitioners and native host library against the JAX package's.

Every partitioner and ``partition_graph`` method of
``dgraph_tpu_torch.partition`` is held against ``dgraph_tpu.partition`` on
the same inputs (an SBM graph and ``power_law_graph`` at small V, W in
{2, 4, 8}): through the native route (each side's own build of
``dgraph_host.cpp``) the partitions are bit-equal, and through the numpy
fallback (``native.available`` patched to False on both sides) they are
equal too, with the same warning from the multilevel family. The native
wrappers, ``fold_partition``, ``unfold_partition`` and ``edge_cut`` are
compared the same way. The port's C++ source is the reference's, byte for
byte, and two processes that build it at once from an empty build
directory load the same library.
"""

import hashlib
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu import native as jnative
from dgraph_tpu import partition as jpt
from dgraph_tpu.data import synthetic as jsyn
from dgraph_tpu_torch import native, partition as pt
from dgraph_tpu_torch.data import synthetic

ROOT = Path(__file__).resolve().parents[1]
V = 600
WORLDS = (2, 4, 8)


def _graph(kind: str) -> np.ndarray:
    if kind == "sbm":
        return synthetic.sbm_classification_graph(num_nodes=V, num_classes=6, feat_dim=2,
                                                  avg_degree=8.0, seed=5)["edge_index"]
    return synthetic.power_law_graph(V, 6.0, seed=1)


GRAPHS = {kind: _graph(kind) for kind in ("sbm", "power_law")}
CASES = [(kind, W) for kind in GRAPHS for W in WORLDS]
IDS = [f"{kind}-W{W}" for kind, W in CASES]


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), native.build_error
    assert jnative.available(), "the reference's native library did not build"


@pytest.fixture
def no_native(monkeypatch):
    """The numpy fallback on both sides."""
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(jnative, "available", lambda: False)


def _eq(a, b, msg=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (msg, a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=msg)


def _partitioners():
    """(name, port function, reference function, kwargs) of each partitioner
    that takes an edge list."""
    return [
        ("greedy_bfs", pt.greedy_bfs_partition, jpt.greedy_bfs_partition, {}),
        ("multilevel", pt.multilevel_partition, jpt.multilevel_partition, {}),
        ("multilevel_big", pt.multilevel_big_partition, jpt.multilevel_big_partition, {}),
        ("multilevel_sampled", pt.multilevel_sampled_partition,
         jpt.multilevel_sampled_partition, {"sample_frac": 0.6}),
        ("multilevel_sampled_edge_balance", pt.multilevel_sampled_partition,
         jpt.multilevel_sampled_partition, {"sample_frac": 0.6, "edge_balance": 1.0}),
    ]


def test_host_source_is_the_references_byte_for_byte():
    ours = (ROOT / "dgraph_tpu_torch" / "csrc" / "dgraph_host.cpp").read_bytes()
    assert ours == (ROOT / "csrc" / "dgraph_host.cpp").read_bytes()
    assert native.SOURCE == ROOT / "dgraph_tpu_torch" / "csrc" / "dgraph_host.cpp"


def test_power_law_graph_matches_the_reference():
    for seed in (0, 1, 4):
        _eq(synthetic.power_law_graph(V, 6.0, seed=seed), jsyn.power_law_graph(V, 6.0, seed=seed))


@pytest.mark.parametrize("kind,W", CASES, ids=IDS)
@pytest.mark.parametrize("method", pt.METHODS)
def test_partition_graph_matches_the_reference(kind, W, method):
    edges = GRAPHS[kind]
    new, ren = pt.partition_graph(edges, V, W, method=method, seed=3)
    jnew, jren = jpt.partition_graph(edges, V, W, method=method, seed=3)
    _eq(new, jnew, method)
    for field in ("perm", "inv", "partition", "counts", "offsets"):
        _eq(getattr(ren, field), getattr(jren, field), f"{method} {field}")
    assert ren.counts.sum() == V and np.all(np.diff(ren.partition) >= 0)


@pytest.mark.parametrize("kind,W", CASES, ids=IDS)
def test_native_partitioners_match_the_reference(kind, W):
    edges = GRAPHS[kind]
    for name, ours, ref, kw in _partitioners():
        got = ours(edges, V, W, seed=2, **kw)
        _eq(got, ref(edges, V, W, seed=2, **kw), name)
        assert got.min() >= 0 and got.max() < W, name


@pytest.mark.parametrize("kind,W", CASES, ids=IDS)
def test_numpy_fallback_matches_the_reference(kind, W, no_native):
    """Greedy BFS's numpy loop is the oracle; the multilevel family falls
    back to it with the reference's warning."""
    edges = GRAPHS[kind]
    assert not native.available() and not jnative.available()
    for name, ours, ref, kw in _partitioners():
        with warnings.catch_warnings(record=True) as got_w:
            warnings.simplefilter("always")
            got = ours(edges, V, W, seed=2, **kw)
        with warnings.catch_warnings(record=True) as want_w:
            warnings.simplefilter("always")
            want = ref(edges, V, W, seed=2, **kw)
        _eq(got, want, name)
        assert [(w.category, str(w.message)) for w in got_w] == \
            [(w.category, str(w.message)) for w in want_w], name
        assert (len(got_w) == 1) == name.startswith("multilevel"), name
        if name.startswith("multilevel"):
            assert "falling back to greedy_bfs" in str(got_w[0].message)
    _eq(got, pt.greedy_bfs_partition(edges, V, W, seed=2))


@pytest.mark.parametrize("kind,W", CASES, ids=IDS)
def test_native_wrappers_match_the_reference(kind, W):
    edges = GRAPHS[kind]
    cmap, nc = native.cluster_coarsen(edges, V, 6, seed=1)
    jcmap, jnc = jnative.cluster_coarsen(edges, V, 6, seed=1)
    _eq(cmap, jcmap, "cluster_coarsen")
    assert nc == jnc
    lo, hi = np.minimum(cmap[edges[0]], cmap[edges[1]]), np.maximum(cmap[edges[0]], cmap[edges[1]])
    keep = lo != hi
    uniq, w = np.unique(lo[keep] * nc + hi[keep], return_counts=True)
    vw = np.bincount(cmap, minlength=nc).astype(np.int64)
    args = (uniq // nc, uniq % nc, w.astype(np.int64), vw, nc, W, 4)
    _eq(native.multilevel_partition_weighted(*args),
        jnative.multilevel_partition_weighted(*args), "weighted")
    vw_fine = 1 + np.bincount(edges[1], minlength=V).astype(np.int64)
    _eq(native.multilevel_partition_vertex_weighted(edges, vw_fine, V, W, 4),
        jnative.multilevel_partition_vertex_weighted(edges, vw_fine, V, W, 4), "vertex weighted")
    start = pt.random_partition(V, W, seed=7)
    _eq(native.refine_unweighted_csr(edges, V, W, start.copy(), passes=2),
        jnative.refine_unweighted_csr(edges, V, W, start.copy(), passes=2), "refine")
    _eq(native.refine_weighted_csr(edges, vw_fine, V, W, start.copy(), passes=2),
        jnative.refine_weighted_csr(edges, vw_fine, V, W, start.copy(), passes=2),
        "refine weighted")
    assert native.edge_cut_count(edges, start) == jnative.edge_cut_count(edges, start) == \
        int((start[edges[0]] != start[edges[1]]).sum())
    assert pt.edge_cut(edges, start) == jpt.edge_cut(edges, start)


def test_edge_cut_count_above_the_thread_threshold():
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 500, (2, 70_000))
    part = rng.integers(0, 4, 500).astype(np.int32)
    assert native.edge_cut_count(edges, part) == jnative.edge_cut_count(edges, part) == \
        int((part[edges[0]] != part[edges[1]]).sum())
    assert pt.edge_cut(edges, part) == jpt.edge_cut(edges, part)


def test_unique_encoded_pairs_matches_the_reference():
    rng = np.random.default_rng(1)
    keys, vals = rng.integers(0, 7, 5000), rng.integers(0, 1000, 5000)
    got = native.unique_encoded_pairs(keys, vals, 1000)
    _eq(got, jnative.unique_encoded_pairs(keys, vals, 1000))
    _eq(got, np.unique(keys.astype(np.int64) * 1000 + vals))


def test_refine_wrappers_refuse_the_int32_bound_before_the_call():
    edges = np.zeros((2, 1), np.int64)
    for fn, args in ((native.refine_unweighted_csr, (edges, 2**31, 2, np.zeros(1, np.int32))),
                     (native.refine_weighted_csr,
                      (edges, np.ones(1, np.int64), 2**31, 2, np.zeros(1, np.int32)))):
        with pytest.raises(ValueError, match="int32 CSR id bound"):
            fn(*args)


@pytest.mark.parametrize("W,lost", [(4, [1]), (4, [0, 3]), (8, [2, 5, 6]), (2, [1])])
def test_fold_partition_matches_the_reference(W, lost):
    _, ren = pt.partition_graph(GRAPHS["sbm"], V, W, method="multilevel")
    for part in (ren.partition, pt.random_partition(V, W, seed=W)):
        got, gmap = pt.fold_partition(part, W, lost)
        want, wmap = jpt.fold_partition(part, W, lost)
        _eq(got, want)
        assert gmap == wmap
        assert set(np.unique(got)) <= set(range(W - len(lost)))


@pytest.mark.parametrize("W,k", [(2, 1), (4, 2), (8, 3)])
def test_unfold_partition_matches_the_reference(W, k):
    _, ren = pt.partition_graph(GRAPHS["power_law"], V, W, method="greedy_bfs")
    got, gmap = pt.unfold_partition(ren.partition, W, k)
    want, wmap = jpt.unfold_partition(ren.partition, W, k)
    _eq(got, want)
    assert gmap == wmap
    # the fold of the unfold restores a renumbered partition
    back, _ = pt.fold_partition(got, W + k, list(range(W, W + k)))
    _eq(back, ren.partition)


def test_fold_and_unfold_errors_match_the_reference():
    part = pt.block_partition(40, 4)
    for fn, args in ((pt.fold_partition, (part, 4, [])), (pt.fold_partition, (part, 4, [4])),
                     (pt.fold_partition, (part, 4, [0, 1, 2, 3])),
                     (pt.unfold_partition, (part, 4, 0)), (pt.unfold_partition, (part, 3, 1))):
        jfn = getattr(jpt, fn.__name__)
        with pytest.raises(ValueError) as want:
            jfn(*args)
        with pytest.raises(ValueError, match=str(want.value).replace("[", r"\[").replace(
                "(", r"\(").replace(")", r"\)")):
            fn(*args)


def test_partition_graph_rejects_an_unknown_method():
    edges = GRAPHS["sbm"]
    with pytest.raises(ValueError) as want:
        jpt.partition_graph(edges, V, 4, method="spectral")
    with pytest.raises(ValueError) as got:
        pt.partition_graph(edges, V, 4, method="spectral")
    # the port's message goes on to list the known methods
    assert str(got.value).startswith(str(want.value))


_LOADER = """
import hashlib, sys
from pathlib import Path
from dgraph_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
assert native.available(), native.build_error
path = native.library_path()
print(path, hashlib.sha256(path.read_bytes()).hexdigest(), native._lib._name)
"""


def test_two_processes_building_at_once_load_one_library(tmp_path):
    """Ranks partition the same graph each on its own: two processes that
    find an empty build directory build under the lock, one after the
    other finds the library, and both load the same file."""
    procs = [subprocess.Popen([sys.executable, "-c", _LOADER, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = [o[0].split() for o in outs]
    assert lines[0] == lines[1]
    path, digest, loaded = lines[0]
    assert loaded == path and Path(path).parent == tmp_path
    sos = sorted(p.name for p in tmp_path.iterdir() if ".so" in p.name)
    assert sos == [Path(path).name]  # no temporary left behind
    assert hashlib.sha256(Path(path).read_bytes()).hexdigest() == digest


def test_step0_is_invariant_to_the_partition_at_two_ranks():
    """Renumbering vertices changes neither the seeded parameters nor the
    masked mean loss: the training CLI's step 0 at 2 CPU ranks under
    ``multilevel`` (its default) gives the loss and gradients of the same
    run under ``random`` within 1e-5, and every rank holds the same
    partition."""
    import dataclasses

    import torch_dist_ranks
    from dgraph_tpu_torch.comm.dist import launch
    from dgraph_tpu_torch.train import __main__ as cli

    cfg = cli.Config(hidden=32, device="cpu", world_size=2,
                     data=cli.DataConfig(num_nodes=400, num_classes=5, feat_dim=16))
    assert cfg.data.partition == "multilevel"
    runs = {}
    for method in ("multilevel", "random"):
        c = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, partition=method))
        runs[method] = launch(torch_dist_ranks.cli_step0, 2, dataclasses.asdict(c),
                              device="cpu", timeout=120, threads=1)
    for method, ranks in runs.items():
        for r in ranks[1:]:
            _eq(r["partition"], ranks[0]["partition"], method)
            _eq(r["perm"], ranks[0]["perm"], method)
    ml, rnd = runs["multilevel"][0], runs["random"][0]
    assert not np.array_equal(ml["perm"], rnd["perm"])  # two different numberings
    np.testing.assert_allclose(ml["loss"], rnd["loss"], rtol=1e-5, atol=1e-5)
    assert ml["grads"].keys() == rnd["grads"].keys()
    for k, v in rnd["grads"].items():
        np.testing.assert_allclose(ml["grads"][k], v, rtol=1e-5, atol=1e-5, err_msg=k)
