"""Reader and writer of OGB's node-prediction on-disk download layout.

The port's copy of ``dgraph_tpu/data/ogb_raw.py`` on numpy and ``gzip``
only (no pandas): it parses the layout a raw download ships into the same
``(graph, labels, split_idx)`` triple the ``ogb`` package returns, and
writes that layout for fixtures. The reader gives the reference reader's
arrays, and the writer the bytes of pandas' ``to_csv(header=False,
index=False)`` (each value as numpy prints it, NaN as an empty field) before
gzip; ``tests/test_torch_ogb.py`` holds both to the reference.

Layout (ogb >= 1.3 ``ogb/io/read_graph_raw.py`` conventions):

``{root}/{name with - -> _}/``
  ``raw/edge.csv.gz``            "src,dst" int lines, no header
  ``raw/num-node-list.csv.gz``   one int (single-graph datasets)
  ``raw/num-edge-list.csv.gz``   one int
  ``raw/node-feat.csv.gz``       comma floats, one row per node (if any)
  ``raw/edge-feat.csv.gz``       comma floats, one row per edge (if any)
  ``raw/node_species.csv.gz``    extra node file (ogbn-proteins)
  ``raw/node-label.csv.gz``      one label row per node
  ``split/{split_type}/{train,valid,test}.csv.gz``  node index per line

Binary datasets (ogbn-papers100M) instead ship ``raw/data.npz`` (keys
``edge_index``, ``node_feat``, ``num_nodes_list``, ``num_edges_list``) and
``raw/node-label.npz`` (key ``node_label``); splits stay csv.gz. A
``split/{split_type}/split_dict.pt`` short-circuit is honored when present.

``add_inverse_edge`` appends the reversed edges after the originals (ogb's
own reader interleaves them): the same edge set in another order, as in the
reference.
"""

from __future__ import annotations

import gzip
import os
from typing import Optional

import numpy as np

# split type and graph-shaping flags from ogb's package-internal master.csv
# (the download itself does not carry them)
NODE_DATASET_META = {
    "ogbn-arxiv": dict(
        split="time", add_inverse_edge=False, binary=False,
        has_node_feat=True, has_edge_feat=False, extra_node_files=(),
    ),
    "ogbn-products": dict(
        split="sales_ranking", add_inverse_edge=True, binary=False,
        has_node_feat=True, has_edge_feat=False, extra_node_files=(),
    ),
    "ogbn-proteins": dict(
        split="species", add_inverse_edge=True, binary=False,
        has_node_feat=False, has_edge_feat=True,
        extra_node_files=("node_species",),
    ),
    "ogbn-papers100M": dict(
        split="time", add_inverse_edge=False, binary=True,
        has_node_feat=True, has_edge_feat=False, extra_node_files=(),
    ),
}

# rows a write formats at a time (bounds the text held in memory)
_WRITE_ROWS = 1 << 16


def dataset_dir(root: str, name: str) -> str:
    """ogb's directory naming: dashes become underscores."""
    return os.path.join(root, "_".join(name.split("-")))


def has_raw_download(root: str, name: str) -> bool:
    """True when the official download layout is present under ``root``."""
    if name not in NODE_DATASET_META:
        return False
    raw = os.path.join(dataset_dir(root, name), "raw")
    probe = "data.npz" if NODE_DATASET_META[name]["binary"] else "edge.csv.gz"
    return os.path.exists(os.path.join(raw, probe))


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    """A headerless csv.gz as a 2-D array (one row per line), as pandas'
    ``read_csv(header=None).values.astype(dtype)`` gives it. numpy's C
    parser reads the common case; a file with empty fields (NaN) takes
    ``genfromtxt``."""
    with gzip.open(path, "rt") as f:
        try:
            return np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2)
        except ValueError:
            f.seek(0)
            out = np.genfromtxt(f, delimiter=",", dtype=np.float64, ndmin=2,
                                filling_values=np.nan)
            return out.astype(dtype)


def _read_split_component(split_dir: str, key: str) -> np.ndarray:
    """One split file: csv.gz (canonical) or npz (some mirrors)."""
    csv = os.path.join(split_dir, key + ".csv.gz")
    if os.path.exists(csv):
        return _read_csv_gz(csv, np.int64).reshape(-1)
    npz = os.path.join(split_dir, key + ".npz")
    if os.path.exists(npz):
        return np.asarray(np.load(npz)["data"], dtype=np.int64).reshape(-1)
    raise FileNotFoundError(f"no {key}.csv.gz / {key}.npz under {split_dir}")


def read_split(root: str, name: str) -> dict:
    """``split_idx`` dict with train/valid/test int64 index arrays."""
    split_dir = os.path.join(
        dataset_dir(root, name), "split", NODE_DATASET_META[name]["split"]
    )
    pt = os.path.join(split_dir, "split_dict.pt")
    if os.path.exists(pt):
        import torch

        d = torch.load(pt, map_location="cpu", weights_only=False)
        return {
            k: np.asarray(v.numpy() if hasattr(v, "numpy") else v, dtype=np.int64)
            for k, v in d.items()
        }
    return {k: _read_split_component(split_dir, k) for k in ("train", "valid", "test")}


def read_node_pred_raw(root: str, name: str) -> tuple[dict, np.ndarray, dict]:
    """Parse a raw download into ``(graph, labels, split_idx)`` — the triple
    ``NodePropPredDataset`` yields (``ds[0]`` and ``get_idx_split()``),
    with ``add_inverse_edge`` doubling where master.csv asks for it."""
    if name not in NODE_DATASET_META:
        raise ValueError(f"unknown dataset {name!r}; known: {tuple(NODE_DATASET_META)}")
    meta = NODE_DATASET_META[name]
    raw = os.path.join(dataset_dir(root, name), "raw")

    if meta["binary"]:
        data = np.load(os.path.join(raw, "data.npz"))
        num_nodes_list = np.asarray(data["num_nodes_list"]).reshape(-1)
        num_edges_list = np.asarray(data["num_edges_list"]).reshape(-1)
        if len(num_nodes_list) != 1:
            raise ValueError(f"{name}: expected a single graph, got {len(num_nodes_list)}")
        graph = {
            "num_nodes": int(num_nodes_list[0]),
            "edge_index": np.asarray(data["edge_index"], dtype=np.int64),
        }
        if graph["edge_index"].shape != (2, int(num_edges_list[0])):
            raise ValueError(
                f"{name}: data.npz edge_index shape {graph['edge_index'].shape} != "
                f"(2, {int(num_edges_list[0])}) from num_edges_list (truncated or "
                "drifted download?)")
        if "node_feat" in data:
            graph["node_feat"] = np.asarray(data["node_feat"])
            if graph["node_feat"].shape[0] != graph["num_nodes"]:
                raise ValueError(
                    f"{name}: data.npz node_feat rows {graph['node_feat'].shape[0]} != "
                    f"num_nodes_list {graph['num_nodes']}")
        labels = np.asarray(np.load(os.path.join(raw, "node-label.npz"))["node_label"])
    else:
        num_nodes = int(_read_csv_gz(os.path.join(raw, "num-node-list.csv.gz"),
                                     np.int64).reshape(-1)[0])
        num_edges = int(_read_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"),
                                     np.int64).reshape(-1)[0])
        edge_index = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64).T
        if edge_index.shape != (2, num_edges):
            raise ValueError(f"{name}: edge.csv.gz rows {edge_index.shape[1]} != "
                             f"num-edge-list {num_edges}")
        graph = {"num_nodes": num_nodes, "edge_index": edge_index}
        if meta["has_node_feat"]:
            graph["node_feat"] = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"),
                                              np.float32)
            if graph["node_feat"].shape[0] != num_nodes:
                raise ValueError(f"{name}: node-feat rows {graph['node_feat'].shape[0]} "
                                 f"!= num-node-list {num_nodes}")
        if meta["has_edge_feat"]:
            graph["edge_feat"] = _read_csv_gz(os.path.join(raw, "edge-feat.csv.gz"),
                                              np.float32)
        for extra in meta["extra_node_files"]:
            graph[extra] = _read_csv_gz(os.path.join(raw, extra + ".csv.gz"), np.int64)
        labels = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"), np.float32)

    if meta["add_inverse_edge"]:
        # the reversed edges appended as one block (see the module docstring)
        graph["edge_index"] = np.concatenate(
            [graph["edge_index"], graph["edge_index"][::-1]], axis=1)
        if "edge_feat" in graph:
            graph["edge_feat"] = np.concatenate([graph["edge_feat"], graph["edge_feat"]],
                                                axis=0)

    return graph, labels, read_split(root, name)


def _write_csv_gz(path: str, arr: np.ndarray) -> None:
    """pandas' ``to_csv(header=False, index=False)`` bytes, gzipped: one
    line per row, values as numpy's ``str`` gives them (the shortest
    repr of the array's own type), NaN as an empty field."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    floating = np.issubdtype(arr.dtype, np.floating)
    # level 1: the text is what the tests compare, and it is several times
    # faster than gzip's default at arxiv size
    with gzip.open(path, "wb", compresslevel=1) as f:
        for lo in range(0, arr.shape[0], _WRITE_ROWS):
            block = arr[lo:lo + _WRITE_ROWS]
            text = block.astype(str)
            if floating:
                text[np.isnan(block)] = ""
            f.write(("\n".join(map(",".join, text.tolist())) + "\n").encode())


def write_node_pred_raw(
    root: str,
    name: str,
    *,
    edge_index: np.ndarray,  # [2, E] before the inverse edges (as the download ships it)
    labels: np.ndarray,
    split_idx: dict,
    node_feat: Optional[np.ndarray] = None,
    edge_feat: Optional[np.ndarray] = None,
    node_species: Optional[np.ndarray] = None,
    num_nodes: Optional[int] = None,
) -> str:
    """Write the official download layout (the fixture generator; also the
    recipe a real download must match). Returns the dataset directory."""
    meta = NODE_DATASET_META[name]
    base = dataset_dir(root, name)
    raw = os.path.join(base, "raw")
    split_dir = os.path.join(base, "split", meta["split"])
    os.makedirs(raw, exist_ok=True)
    os.makedirs(split_dir, exist_ok=True)
    num_nodes = int(num_nodes if num_nodes is not None
                    else (len(node_feat) if node_feat is not None else len(labels)))

    if meta["binary"]:
        arrays = {
            "edge_index": np.asarray(edge_index, np.int64),
            "num_nodes_list": np.asarray([num_nodes], np.int64),
            "num_edges_list": np.asarray([edge_index.shape[1]], np.int64),
        }
        if node_feat is not None:
            arrays["node_feat"] = np.asarray(node_feat)
        np.savez(os.path.join(raw, "data.npz"), **arrays)
        np.savez(os.path.join(raw, "node-label.npz"), node_label=np.asarray(labels))
    else:
        _write_csv_gz(os.path.join(raw, "edge.csv.gz"), np.asarray(edge_index).T)
        _write_csv_gz(os.path.join(raw, "num-node-list.csv.gz"), np.asarray([num_nodes]))
        _write_csv_gz(os.path.join(raw, "num-edge-list.csv.gz"),
                      np.asarray([edge_index.shape[1]]))
        if node_feat is not None:
            _write_csv_gz(os.path.join(raw, "node-feat.csv.gz"), node_feat)
        if edge_feat is not None:
            _write_csv_gz(os.path.join(raw, "edge-feat.csv.gz"), edge_feat)
        if node_species is not None:
            _write_csv_gz(os.path.join(raw, "node_species.csv.gz"), node_species)
        _write_csv_gz(os.path.join(raw, "node-label.csv.gz"), labels)

    for key in ("train", "valid", "test"):
        _write_csv_gz(os.path.join(split_dir, key + ".csv.gz"),
                      np.asarray(split_idx[key], np.int64))
    # the download ships a release marker at the dataset root
    with open(os.path.join(base, "RELEASE_v1.txt"), "w") as f:
        f.write(f"{name} fixture in the official raw layout\n")
    return base
