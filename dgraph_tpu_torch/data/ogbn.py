"""OGB node-property-prediction ingestion.

The port's copy of ``dgraph_tpu/data/ogbn.py``: the supported-dataset
table, the raw-download loader (:func:`load_ogb_arrays`, through
:mod:`dgraph_tpu_torch.data.ogb_raw`), the ``.npz`` / memmap-directory
export and its reader, the arxiv-shaped stand-in export, and the
partitioned dataset with its on-disk cache. It never imports the ``ogb``
package and never downloads: where the reference would fetch through
``ogb``, this loader needs the raw download on disk already, or an export
made elsewhere with :func:`export_npz`.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from typing import Optional

import numpy as np

SUPPORTED = (
    "ogbn-arxiv",
    "ogbn-products",
    "ogbn-proteins",
    "ogbn-papers100M",
)

_ARRAYS = ("edge_index", "features", "labels", "train_mask", "valid_mask", "test_mask")

# format of the DistributedGraph pickles DistributedOGBDataset caches; bump
# when the port's plan or DistributedGraph fields change, so no warm cache
# serves an old layout
PLAN_FORMAT_VERSION = 1


def masks_from_split(split_idx: dict, num_nodes: int) -> dict:
    """OGB's {train,valid,test} index arrays -> float masks."""
    masks = {}
    for name in ("train", "valid", "test"):
        m = np.zeros(num_nodes, np.float32)
        if name in split_idx:
            m[np.asarray(split_idx[name], dtype=np.int64)] = 1.0
        masks[name] = m
    return masks


def load_ogb_arrays(name: str, root: str = "dataset") -> dict:
    """Load one OGB node-prediction dataset as plain numpy arrays from its
    raw download layout under ``root`` (:mod:`dgraph_tpu_torch.data.ogb_raw`).
    With no such layout it raises, naming the layout and the export route;
    it never fetches anything."""
    from dgraph_tpu_torch.data.ogb_raw import dataset_dir, has_raw_download, read_node_pred_raw

    if name not in SUPPORTED:
        raise ValueError(f"unsupported dataset {name!r}; supported: {SUPPORTED}")
    if not has_raw_download(root, name):
        raise FileNotFoundError(
            f"no raw download layout for {name} under {root!r}: place the official "
            f"download at {dataset_dir(root, name)!r} (raw/edge.csv.gz, raw/node-feat.csv.gz, "
            "raw/node-label.csv.gz, raw/num-node-list.csv.gz, raw/num-edge-list.csv.gz, "
            "split/<type>/{train,valid,test}.csv.gz; papers100M raw/data.npz and "
            "raw/node-label.npz), or export the dataset where it exists with "
            "dgraph_tpu_torch.data.ogbn.export_npz(name, out_path) and pass the .npz (or "
            "memmap directory) to from_npz() / --data.path; nothing is downloaded")
    return _arrays_from_graph(name, *read_node_pred_raw(root, name))


def _arrays_from_graph(name: str, graph: dict, labels, split_idx: dict) -> dict:
    """(graph, labels, split_idx) -> the flat array dict every consumer takes."""
    num_nodes = int(graph["num_nodes"])
    edge_index = np.asarray(graph["edge_index"], dtype=np.int64)
    if name == "ogbn-proteins":
        # no node features (edge features only) and [V, 112] multi-label
        # float targets: node features are the species one-hot and the
        # log-degree (the standard featureless recipe)
        species = np.asarray(graph["node_species"]).squeeze()
        uniq, inv = np.unique(species, return_inverse=True)
        onehot = np.zeros((num_nodes, len(uniq)), np.float32)
        onehot[np.arange(num_nodes), inv] = 1.0
        deg = np.bincount(edge_index[0], minlength=num_nodes).astype(np.float32)
        features = np.concatenate([onehot, np.log1p(deg)[:, None]], axis=1)
        labels = np.asarray(labels, dtype=np.float32)  # [V, 112] multi-label
    else:
        features = np.asarray(graph["node_feat"], dtype=np.float32)
        labels = np.asarray(labels).squeeze()
        # papers100M labels are float with NaN on unlabeled nodes: class 0
        # and the loss mask are equivalent
        if np.issubdtype(labels.dtype, np.floating):
            labels = np.where(np.isnan(labels), 0, labels)
        labels = labels.astype(np.int32)
    out = {"edge_index": edge_index, "features": features, "labels": labels,
           "num_nodes": num_nodes}
    out.update({k + "_mask": v for k, v in masks_from_split(split_idx, num_nodes).items()})
    return out


def export_npz(name: str, out_path: str, root: str = "dataset") -> str:
    """Write the dataset to one ``.npz`` that :func:`from_npz` and the
    training CLI's ``--data.path`` read."""
    arrs = load_ogb_arrays(name, root=root)
    np.savez(out_path, **{k: v for k, v in arrs.items() if isinstance(v, np.ndarray)})
    return out_path


def export_arxiv_shaped_npz(out_path: str, scale: float = 1.0, seed: int = 0) -> str:
    """Write an ogbn-arxiv-shaped learnable stand-in export: the shapes,
    dtypes, array names and split proportions of a real :func:`export_npz`
    of ogbn-arxiv (169,343 nodes, 1,166,243 directed edges, 128-dim
    features, 40 classes, 90,941 / 29,799 / 48,603 train/valid/test), with
    SBM community structure and a feature signal so accuracy measures real
    learning. Equal to the reference's export for the same arguments."""
    from dgraph_tpu_torch.data.synthetic import sbm_classification_graph

    V = max(int(169_343 * scale), 1_000)
    avg_directed_degree = 2 * 1_166_243 / 169_343  # symmetrized, like the CLI
    data = sbm_classification_graph(
        num_nodes=V, num_classes=40, feat_dim=128, avg_degree=avg_directed_degree,
        homophily=0.8, train_frac=90_941 / 169_343, val_frac=29_799 / 169_343, seed=seed,
    )
    np.savez(
        out_path,
        edge_index=data["edge_index"],
        features=data["features"].astype(np.float32),
        labels=data["labels"].astype(np.int32),
        train_mask=data["masks"]["train"],
        valid_mask=data["masks"]["val"],
        test_mask=data["masks"]["test"],
    )
    return out_path


def from_npz(path: str) -> dict:
    """Load the :func:`export_npz` format (or a memmap directory with the
    same array names) into the dict :func:`load_ogb_arrays` returns."""
    if os.path.isdir(path):
        from dgraph_tpu_torch.data.memmap import open_memmap_dataset

        present = [n for n in _ARRAYS if os.path.exists(os.path.join(path, n + ".npy"))]
        z = open_memmap_dataset(path, names=present)
    else:
        z = dict(np.load(path).items())
    z["num_nodes"] = int(z["features"].shape[0])
    return z


def lead_first(path: str, build, is_lead: bool, poll_s: float = 5.0,
               timeout_s: float = 24 * 3600.0):
    """Run ``build(path)`` on the lead process only; followers wait for the
    ``.done`` sentinel beside the artifact (a shared filesystem is the
    barrier)."""
    done = path + ".done"
    # the sentinel vouches for the artifact only if the artifact is there too
    if os.path.exists(done) and os.path.exists(path):
        return path
    if is_lead:
        if os.path.exists(done):
            os.remove(done)  # stale sentinel without artifact
        build(path)
        with open(done, "w") as f:
            json.dump({"ts": time.time()}, f)
        return path
    waited = 0.0
    while not (os.path.exists(done) and os.path.exists(path)):
        time.sleep(poll_s)
        waited += poll_s
        if waited > timeout_s:
            raise TimeoutError(f"lead process never produced {done}")
    return path


def _is_lead_process() -> bool:
    """Rank 0 of the default process group, or the only process."""
    import torch.distributed as dist

    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _atomic_pickle_dump(path: str, obj) -> None:
    """Pickle to a temporary file, fsync, then rename into place: a reader
    never sees a truncated artifact."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class DistributedOGBDataset:
    """Partitioned OGB dataset with an on-disk cache of the built
    :class:`~dgraph_tpu_torch.data.graph.DistributedGraph`, built once by the
    lead process. The cache is keyed as the reference keys its own: by
    dataset, world size and partition method, plus a hash of every other
    option that shapes the graph, the source (``data_path``, ``root``), the
    pickle format and the block size that shapes ``e_pad``."""

    def __init__(
        self,
        name: str,
        world_size: int,
        *,
        data_path: Optional[str] = None,  # npz / memmap export
        root: str = "dataset",
        cache_dir: str = "cache/ogb_torch",
        partition_method: str = "rcm",
        symmetrize: bool = True,
        add_symmetric_norm: bool = True,
        pad_multiple: int = 128,
        is_lead: Optional[bool] = None,
    ):
        from dgraph_tpu_torch.data.graph import DistributedGraph
        from dgraph_tpu_torch.plan import SCATTER_BLOCK_E

        if is_lead is None:
            is_lead = _is_lead_process()
        self.name = name
        self.world_size = world_size
        os.makedirs(cache_dir, exist_ok=True)
        opts = hashlib.sha256(
            repr((pad_multiple, symmetrize, add_symmetric_norm, data_path, root,
                  PLAN_FORMAT_VERSION, SCATTER_BLOCK_E)).encode()
        ).hexdigest()[:10]
        cache = os.path.join(cache_dir, f"{name}_w{world_size}_{partition_method}_{opts}.pkl")

        def build(path):
            arrs = from_npz(data_path) if data_path else load_ogb_arrays(name, root)
            edge_index = np.asarray(arrs["edge_index"])
            if symmetrize:
                edge_index = np.concatenate([edge_index, edge_index[::-1]], axis=1)
            g = DistributedGraph.from_global(
                edge_index,
                np.asarray(arrs["features"]),
                np.asarray(arrs["labels"]),
                {k[: -len("_mask")]: np.asarray(v) for k, v in arrs.items()
                 if k.endswith("_mask")},
                world_size=world_size,
                partition_method=partition_method,
                add_symmetric_norm=add_symmetric_norm,
                pad_multiple=pad_multiple,
            )
            _atomic_pickle_dump(path, g)

        lead_first(cache, build, is_lead)
        with open(cache, "rb") as f:
            self.graph: DistributedGraph = pickle.load(f)

    @property
    def plan(self):
        return self.graph.plan

    def batch(self, split: str) -> dict:
        return self.graph.batch(split)
