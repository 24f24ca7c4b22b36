"""The port's OGB reader, writer and loaders against the JAX package's.

Fixtures in the official raw download layout are written by the
reference's ``write_node_pred_raw`` (pandas ``to_csv`` into gzip) for
ogbn-arxiv, -products, -proteins and -papers100M (binary) at small V. The
port's writer, on numpy and gzip only, must give the same bytes after
gunzip (the same arrays for the binary npz files); the port's reader must
give the reference reader's arrays, dtypes and shapes. ``from_npz`` (file
and memmap directory), ``masks_from_split``, ``export_arxiv_shaped_npz``
and ``DistributedOGBDataset``'s cache key are held to the reference the
same way. The training CLI's ``--data.ogb_name`` run is held to the
reference's ``experiments/ogb_gcn.py`` data and GCN: step-0 loss within
1e-4 (f32, as ``test_torch_train.py``).
"""

import ast
import gzip
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.data import memmap as jmemmap
from dgraph_tpu.data import ogb_raw as jraw
from dgraph_tpu.data import ogbn as jogbn
from dgraph_tpu_torch.data import ogb_raw, ogbn

ROOT = Path(__file__).resolve().parents[1]
DATASETS = tuple(ogb_raw.NODE_DATASET_META)


def _fixture(name: str, V: int = 80, E: int = 320, F: int = 6, seed: int = 0) -> dict:
    """The keyword arguments of ``write_node_pred_raw`` for one dataset:
    unrounded float32 features (their shortest repr has up to 9 digits),
    and the features each dataset ships."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(V)
    kw = {
        "edge_index": rng.integers(0, V, (2, E)).astype(np.int64),
        "split_idx": {"train": np.sort(perm[: V // 2]), "valid": np.sort(perm[V // 2: 3 * V // 4]),
                      "test": np.sort(perm[3 * V // 4:])},
    }
    feat = (rng.normal(size=(V, F)) * 10.0 ** rng.integers(-6, 6, (V, F))).astype(np.float32)
    feat[0, :3] = (0.0, -0.0, 1e20)
    if name == "ogbn-proteins":
        kw["node_species"] = rng.choice([3702, 4932, 9606], V).astype(np.int64)
        kw["labels"] = rng.integers(0, 2, (V, 5)).astype(np.int64)
        edge_feat = rng.uniform(size=(E, 8)).astype(np.float32)
        edge_feat[3, 2] = np.nan  # an empty field in the csv
        kw["edge_feat"] = edge_feat
    elif name == "ogbn-papers100M":
        labels = rng.integers(0, 7, V).astype(np.float32)
        labels[perm[3 * V // 4:][::2]] = np.nan  # unlabeled nodes
        kw.update(labels=labels, node_feat=feat)
    else:
        kw.update(labels=rng.integers(0, 7, V).astype(np.int64), node_feat=feat)
    return kw


def _files(base: Path) -> dict:
    return {p.relative_to(base).as_posix(): p for p in sorted(base.rglob("*")) if p.is_file()}


def _assert_arrays_equal(got, want, msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (msg, got.dtype, want.dtype,
                                                                  got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)  # NaN equals NaN here


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory) -> Path:
    """Every dataset written by the reference's writer under one root."""
    root = tmp_path_factory.mktemp("ogb_ref")
    for name in DATASETS:
        jraw.write_node_pred_raw(str(root), name, **_fixture(name))
    return root


@pytest.mark.parametrize("name", DATASETS)
def test_writer_gives_the_references_bytes(tmp_path, name):
    kw = _fixture(name, seed=1)
    ours = Path(ogb_raw.write_node_pred_raw(str(tmp_path / "ours"), name, **kw))
    ref = Path(jraw.write_node_pred_raw(str(tmp_path / "ref"), name, **kw))
    got, want = _files(ours), _files(ref)
    assert got.keys() == want.keys()
    for rel, path in want.items():
        if rel.endswith(".gz"):
            assert gzip.decompress(got[rel].read_bytes()) == gzip.decompress(path.read_bytes()), rel
        elif rel.endswith(".npz"):
            a, b = np.load(got[rel]), np.load(path)
            assert a.files == b.files, rel
            for k in b.files:
                _assert_arrays_equal(a[k], b[k], f"{rel}:{k}")
        else:
            assert got[rel].read_bytes() == path.read_bytes(), rel


@pytest.mark.parametrize("name", DATASETS)
def test_reader_gives_the_references_arrays(fixtures, name):
    assert ogb_raw.has_raw_download(str(fixtures), name)
    graph, labels, split = ogb_raw.read_node_pred_raw(str(fixtures), name)
    jgraph, jlabels, jsplit = jraw.read_node_pred_raw(str(fixtures), name)
    assert graph.keys() == jgraph.keys()
    for k, v in jgraph.items():
        if k == "num_nodes":
            assert graph[k] == v
        else:
            _assert_arrays_equal(graph[k], v, k)
    _assert_arrays_equal(labels, jlabels, "labels")
    assert split.keys() == jsplit.keys()
    for k, v in jsplit.items():
        _assert_arrays_equal(split[k], v, k)


@pytest.mark.parametrize("name", DATASETS)
def test_load_ogb_arrays_matches_the_reference(fixtures, name):
    got = ogbn.load_ogb_arrays(name, root=str(fixtures))
    want = jogbn.load_ogb_arrays(name, root=str(fixtures))
    assert got.keys() == want.keys()
    for k, v in want.items():
        if k == "num_nodes":
            assert got[k] == v
        else:
            _assert_arrays_equal(got[k], v, k)


def test_split_dict_pt_short_circuit(fixtures, tmp_path):
    jraw.write_node_pred_raw(str(tmp_path), "ogbn-arxiv", **_fixture("ogbn-arxiv"))
    split = ogb_raw.read_split(str(tmp_path), "ogbn-arxiv")
    other = {k: torch.from_numpy(v[: len(v) // 2].copy()) for k, v in split.items()}
    torch.save(other, str(tmp_path / "ogbn_arxiv/split/time/split_dict.pt"))
    got, want = ogb_raw.read_split(str(tmp_path), "ogbn-arxiv"), jraw.read_split(str(tmp_path),
                                                                                  "ogbn-arxiv")
    for k in ("train", "valid", "test"):
        _assert_arrays_equal(got[k], want[k], k)
        _assert_arrays_equal(got[k], other[k].numpy(), k)


def test_masks_from_split_matches_the_reference():
    split = {"train": np.array([0, 3, 5]), "valid": np.array([1]), "test": np.array([2, 9])}
    for s in (split, {"train": split["train"]}):
        got, want = ogbn.masks_from_split(s, 10), jogbn.masks_from_split(s, 10)
        assert got.keys() == want.keys()
        for k in want:
            _assert_arrays_equal(got[k], want[k], k)


def test_from_npz_on_a_file_and_a_memmap_directory(fixtures, tmp_path):
    # a file: export_npz of the raw fixture
    p, jp = str(tmp_path / "arxiv.npz"), str(tmp_path / "arxiv_ref.npz")
    ogbn.export_npz("ogbn-arxiv", p, root=str(fixtures))
    jogbn.export_npz("ogbn-arxiv", jp, root=str(fixtures))
    got, want = ogbn.from_npz(p), jogbn.from_npz(jp)
    assert got.keys() == want.keys() and got["num_nodes"] == want["num_nodes"] == 80
    for k in jogbn._ARRAYS:
        _assert_arrays_equal(got[k], want[k], k)
    # a memmap directory with the sidecar, written by the reference
    d = str(tmp_path / "mm")
    out = jmemmap.create_memmap_dataset(d, {k: (want[k].shape, want[k].dtype.str)
                                            for k in jogbn._ARRAYS})
    for k, arr in out.items():
        arr[...] = want[k]
        arr.flush()
    got_mm, want_mm = ogbn.from_npz(d), jogbn.from_npz(d)
    assert isinstance(got_mm["features"], np.memmap)
    assert got_mm.keys() == want_mm.keys() and got_mm["num_nodes"] == want_mm["num_nodes"]
    for k in jogbn._ARRAYS:
        _assert_arrays_equal(got_mm[k], want_mm[k], k)
    # a sidecar that disagrees with an array fails at open, as the reference does
    np.save(os.path.join(d, "labels.npy"), np.zeros(3, np.int32))
    for mod in (ogbn, jogbn):
        with pytest.raises(ValueError, match="dgraph_meta.json records"):
            mod.from_npz(d)


def test_export_arxiv_shaped_npz_at_its_floor_matches_the_reference(tmp_path):
    p, jp = str(tmp_path / "a.npz"), str(tmp_path / "a_ref.npz")
    ogbn.export_arxiv_shaped_npz(p, scale=0.001, seed=3)
    jogbn.export_arxiv_shaped_npz(jp, scale=0.001, seed=3)
    got, want = np.load(p), np.load(jp)
    assert got.files == want.files
    for k in want.files:
        _assert_arrays_equal(got[k], want[k], k)
    assert got["features"].shape == (1000, 128)


def test_load_ogb_arrays_without_a_raw_layout_raises_and_fetches_nothing(tmp_path):
    code = (
        "import sys\n"
        "from dgraph_tpu_torch.data import ogbn\n"
        "try:\n"
        f"    ogbn.load_ogb_arrays('ogbn-arxiv', root={str(tmp_path)!r})\n"
        "except FileNotFoundError as e:\n"
        "    msg = str(e)\n"
        "else:\n"
        "    raise SystemExit('no error')\n"
        "assert 'raw download layout' in msg and 'export_npz' in msg, msg\n"
        "assert 'ogb' not in sys.modules and 'pandas' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
    with pytest.raises(ValueError, match="unsupported dataset"):
        ogbn.load_ogb_arrays("ogbn-mag", root=str(tmp_path))


def test_the_loaders_import_neither_ogb_nor_pandas():
    for mod in ("ogbn", "ogb_raw", "memmap"):
        tree = ast.parse((ROOT / "dgraph_tpu_torch" / "data" / f"{mod}.py").read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not [m for m in names if m.split(".")[0] in ("ogb", "pandas")], (mod, names)


def _cache_files(d: Path) -> list:
    return sorted(p.name for p in d.glob("*.pkl"))


def test_distributed_dataset_keys_its_cache_as_the_reference(fixtures, tmp_path, monkeypatch):
    """The same cache names for the same options (dataset, world size,
    method, then a hash of the graph-shaping options and the source), the
    same options telling two caches apart, and a second construction read
    from the cache."""
    variants = [dict(), dict(pad_multiple=16), dict(symmetrize=False),
                dict(add_symmetric_norm=False), dict(partition_method="multilevel")]
    names = {}
    for side, mod in (("ours", ogbn), ("ref", jogbn)):
        for i, kw in enumerate(variants):
            d = tmp_path / f"{side}{i}"
            kw = dict(dict(pad_multiple=8, partition_method="random"), **kw)
            mod.DistributedOGBDataset("ogbn-arxiv", 2, root=str(fixtures), cache_dir=str(d),
                                      is_lead=True, **kw)
            (name,) = _cache_files(d)
            names.setdefault(side, []).append(name)
    prefix = [n.rsplit("_", 1)[0] for n in names["ours"]]
    assert prefix == [n.rsplit("_", 1)[0] for n in names["ref"]]
    assert prefix[0] == "ogbn-arxiv_w2_random" and prefix[-1] == "ogbn-arxiv_w2_multilevel"
    assert len(set(names["ours"])) == len(set(names["ref"])) == len(variants)
    # the cache, not the loader, serves the second construction
    d = tmp_path / "ours0"
    first = ogbn.DistributedOGBDataset("ogbn-arxiv", 2, root=str(fixtures), cache_dir=str(d),
                                       pad_multiple=8, partition_method="random", is_lead=True)

    def no_loader(*a, **k):
        raise AssertionError("the cache was not used")

    monkeypatch.setattr(ogbn, "load_ogb_arrays", no_loader)
    again = ogbn.DistributedOGBDataset("ogbn-arxiv", 2, root=str(fixtures), cache_dir=str(d),
                                       pad_multiple=8, partition_method="random", is_lead=True)
    assert _cache_files(d) == [names["ours"][0]]
    assert torch.equal(again.graph.features, first.graph.features)
    assert again.batch("train")["x"].shape[0] == 2 and again.plan.world_size == 2
    assert ogbn.DistributedOGBDataset.__init__.__kwdefaults__["cache_dir"] != \
        jogbn.DistributedOGBDataset.__init__.__kwdefaults__["cache_dir"]


def test_distributed_dataset_from_npz_and_its_graph(fixtures, tmp_path):
    p = str(tmp_path / "arxiv.npz")
    ogbn.export_npz("ogbn-arxiv", p, root=str(fixtures))
    ds = ogbn.DistributedOGBDataset("ogbn-arxiv", 2, data_path=p, cache_dir=str(tmp_path / "c"),
                                    pad_multiple=8, partition_method="multilevel", is_lead=True)
    ref = jogbn.DistributedOGBDataset("ogbn-arxiv", 2, data_path=p,
                                      cache_dir=str(tmp_path / "jc"), pad_multiple=8,
                                      partition_method="multilevel", is_lead=True)
    assert ds.graph.num_nodes == ref.graph.num_nodes == 80
    np.testing.assert_array_equal(ds.graph.ren.partition, ref.graph.ren.partition)
    np.testing.assert_array_equal(ds.graph.features.numpy(), np.asarray(ref.graph.features))


def test_lead_first_sentinel_and_follower_timeout(tmp_path):
    path, calls = str(tmp_path / "artifact.bin"), []

    def build(p):
        calls.append(p)
        Path(p).write_bytes(b"x")

    ogbn.lead_first(path, build, is_lead=True)
    ogbn.lead_first(path, build, is_lead=False)
    assert calls == [path]
    with pytest.raises(TimeoutError):
        ogbn.lead_first(str(tmp_path / "never.bin"), lambda p: None, is_lead=False,
                        poll_s=0.01, timeout_s=0.05)


# --- the training CLI --------------------------------------------------------


@pytest.fixture(scope="module")
def arxiv_sbm(tmp_path_factory) -> Path:
    """An SBM node-classification graph in ogbn-arxiv's raw layout, written
    by the reference's writer."""
    from dgraph_tpu_torch.data import synthetic

    g = synthetic.sbm_classification_graph(num_nodes=300, num_classes=5, feat_dim=24, seed=2)
    idx = {k: np.flatnonzero(g["masks"][k]) for k in ("train", "val", "test")}
    root = tmp_path_factory.mktemp("arxiv_sbm")
    jraw.write_node_pred_raw(
        str(root), "ogbn-arxiv", edge_index=g["edge_index"], labels=g["labels"],
        node_feat=g["features"].astype(np.float32),
        split_idx={"train": idx["train"], "valid": idx["val"], "test": idx["test"]})
    return root


def test_train_cli_loads_the_raw_layout_and_matches_the_reference(arxiv_sbm):
    """``--device cpu --data.ogb_name ogbn-arxiv --data.root <fixture>``:
    2 steps; the step-0 loss equals the reference GCN's on the data of
    experiments/ogb_gcn.py's ``load_data`` with the CLI's initial weights."""
    sys.path.insert(0, str(ROOT))
    from dgraph_tpu.comm import Communicator
    from dgraph_tpu.data import DistributedGraph as JaxGraph
    from dgraph_tpu.models import GCN as JaxGCN
    from dgraph_tpu.train.loop import masked_cross_entropy as jax_masked_ce
    from dgraph_tpu_torch.train import __main__ as cli
    from dgraph_tpu_torch.weights import params_to_jax
    from experiments import ogb_gcn

    argv = ["--device", "cpu", "--epochs", "2", "--hidden", "32", "--log_path", "",
            "--data.ogb_name", "ogbn-arxiv", "--data.root", str(arxiv_sbm)]
    cfg = cli.parse_config(argv)
    assert cfg.data.partition == "multilevel"
    init = {k: v.detach().clone() for k, v in cli.build_training(cfg).model.named_parameters()}
    out = cli.main(cfg)
    assert [r["step"] for r in out["records"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) for r in out["records"])
    t = out["training"]
    assert set(t.batches) == {"train", "val", "test"}

    data = ogb_gcn.load_data(ogb_gcn.DataConfig(ogb_name="ogbn-arxiv", root=str(arxiv_sbm)))
    ours = cli.load_data(cfg.data)
    assert ours["masks"].keys() == data["masks"].keys() == {"train", "val", "test"}
    for k in ("edge_index", "features", "labels"):
        _assert_arrays_equal(ours[k], data[k], k)
    assert ours["num_classes"] == data["num_classes"] == 5
    ref = JaxGraph.from_global(data["edge_index"], data["features"], data["labels"],
                               data["masks"], 1, partition_method="multilevel",
                               add_symmetric_norm=True, tune="off")
    model = JaxGCN(32, 5, comm=Communicator.init_process_group("single"))
    logits = model.apply(params_to_jax(init), jnp.asarray(ref.features[0]),
                         jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan),
                         jnp.asarray(ref.edge_weight[0]))
    want = float(jax_masked_ce(logits, jnp.asarray(ref.labels[0]),
                               jnp.asarray(ref.masks["train"][0]), None))
    np.testing.assert_allclose(out["records"][0]["loss"], want, rtol=1e-4, atol=1e-4)


def test_train_cli_ogb_name_with_an_export_path(arxiv_sbm, tmp_path):
    """``--data.ogb_name`` with ``--data.path``: the export (file or memmap
    directory) instead of the raw layout, "valid" renamed "val"."""
    from dgraph_tpu_torch.train import __main__ as cli

    p = str(tmp_path / "arxiv.npz")
    ogbn.export_npz("ogbn-arxiv", p, root=str(arxiv_sbm))
    raw = cli.load_data(cli.DataConfig(ogb_name="ogbn-arxiv", root=str(arxiv_sbm)))
    npz = cli.load_data(cli.DataConfig(ogb_name="ogbn-arxiv", path=p))
    assert npz["masks"].keys() == {"train", "val", "test"}
    for k in ("edge_index", "features", "labels"):
        _assert_arrays_equal(npz[k], raw[k], k)
    for k in raw["masks"]:
        _assert_arrays_equal(npz["masks"][k], raw["masks"][k], k)
    with pytest.raises(FileNotFoundError, match="raw download layout"):
        cli.load_data(cli.DataConfig(ogb_name="ogbn-arxiv", root=str(tmp_path / "none")))
