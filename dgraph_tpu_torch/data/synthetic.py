"""Synthetic graph datasets (numpy) — a copy of ``dgraph_tpu/data/synthetic.py``.

The same seeds give the same graphs as the reference, so tests can hold the
two packages against each other on one input.
"""

from __future__ import annotations

import numpy as np

# ogbn-arxiv shape (V, directed E before symmetrization)
ARXIV_NODES = 169_343
ARXIV_EDGES = 1_166_243
# average symmetric degree of ogbn-arxiv (2 * ARXIV_EDGES / ARXIV_NODES)
ARXIV_AVG_DEGREE = 13.77


def random_edges(
    num_nodes: int, num_edges: int, seed: int = 0, symmetrize: bool = True
) -> np.ndarray:
    """Uniform random [2, E] edge list (the arxiv-shaped synthetic workload)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, num_nodes, num_edges)
    dst = rng.integers(0, num_nodes, num_edges)
    if symmetrize:
        return np.stack(
            [np.concatenate([src, dst]), np.concatenate([dst, src])]
        ).astype(np.int64)
    return np.stack([src, dst]).astype(np.int64)


def arxiv_shaped_edges(seed: int = 0) -> tuple:
    """(edge_index [2, 2*ARXIV_EDGES], num_nodes) for the arxiv workload."""
    return random_edges(ARXIV_NODES, ARXIV_EDGES, seed), ARXIV_NODES


def sbm_classification_graph(
    num_nodes: int = 1000,
    num_classes: int = 4,
    feat_dim: int = 16,
    avg_degree: float = 8.0,
    homophily: float = 0.8,
    train_frac: float = 0.6,
    val_frac: float = 0.2,
    seed: int = 0,
):
    """Stochastic-block-model node-classification task.

    Features = class centroid + noise; edges mostly intra-class. Returns
    dict(edge_index [2,E], features [V,F], labels [V], masks
    {train,val,test}, num_classes).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, num_nodes)
    centroids = rng.normal(0, 1.0, (num_classes, feat_dim))
    feats = centroids[labels] + rng.normal(0, 2.0, (num_nodes, feat_dim))

    E = int(num_nodes * avg_degree // 2)
    # rejection sampling with the analytic acceptance rate
    p_keep = homophily / num_classes + (1 - homophily) * (1 - 1 / num_classes)
    src_parts, dst_parts, have = [], [], 0
    while have < E:
        n_draw = int((E - have) / max(p_keep, 1e-6) * 1.2) + 1024
        s = rng.integers(0, num_nodes, n_draw)
        d = rng.integers(0, num_nodes, n_draw)
        same = labels[s] == labels[d]
        keep = np.where(same, rng.random(n_draw) < homophily, rng.random(n_draw) < (1 - homophily))
        keep &= s != d
        src_parts.append(s[keep])
        dst_parts.append(d[keep])
        have += int(keep.sum())
    src = np.concatenate(src_parts)[:E]
    dst = np.concatenate(dst_parts)[:E]
    edge_index = np.stack(
        [np.concatenate([src, dst]), np.concatenate([dst, src])]
    ).astype(np.int64)

    order = rng.permutation(num_nodes)
    n_tr = int(train_frac * num_nodes)
    n_va = int(val_frac * num_nodes)
    masks = {
        "train": np.zeros(num_nodes, bool),
        "val": np.zeros(num_nodes, bool),
        "test": np.zeros(num_nodes, bool),
    }
    masks["train"][order[:n_tr]] = True
    masks["val"][order[n_tr : n_tr + n_va]] = True
    masks["test"][order[n_tr + n_va :]] = True
    return {
        "edge_index": edge_index,
        "features": feats.astype(np.float32),
        "labels": labels.astype(np.int32),
        "masks": masks,
        "num_classes": num_classes,
    }


def power_law_graph(num_nodes: int, avg_degree: float, seed: int = 0) -> np.ndarray:
    """Degree-skewed random digraph (papers100M-like degree profile) —
    endpoint sampling proportional to a Zipf-ish weight."""
    rng = np.random.default_rng(seed)
    E = int(num_nodes * avg_degree)
    w = 1.0 / np.arange(1, num_nodes + 1) ** 0.75
    w /= w.sum()
    src = rng.choice(num_nodes, E, p=w)
    dst = rng.integers(0, num_nodes, E)
    return np.stack([src, dst]).astype(np.int64)


def skewed_arxiv_edges(seed: int = 0) -> np.ndarray:
    """ogbn-arxiv's vertex and edge counts with a skewed degree profile (the
    port's own, not in the reference's module): ``power_law_graph(ARXIV_NODES,
    ARXIV_EDGES / ARXIV_NODES, seed)`` symmetrized, ``[src; dst]`` with
    ``[dst; src]``, as ``[2, 2 * ARXIV_EDGES]`` int64. At seed 0 its largest
    in-degree is 15,001 and 36 rows hold more than 1,024 edges."""
    src, dst = power_law_graph(ARXIV_NODES, ARXIV_EDGES / ARXIV_NODES, seed)
    return np.stack([np.concatenate([src, dst]), np.concatenate([dst, src])])
