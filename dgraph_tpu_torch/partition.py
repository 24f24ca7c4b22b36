"""Graph partitioning and renumbering (host-side numpy).

A copy of the ``random``, ``block``, ``round_robin`` and ``rcm``
partitioners of ``dgraph_tpu/partition.py``, with ``Renumbering``,
``renumber_contiguous`` and ``partition_graph``: same inputs, same
partitions, so a port plan and a reference plan number vertices alike.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def round_robin_partition(num_nodes: int, world_size: int) -> np.ndarray:
    """Rank of vertex v = v % world_size."""
    return (np.arange(num_nodes) % world_size).astype(np.int32)


def block_partition(num_nodes: int, world_size: int) -> np.ndarray:
    """Contiguous blocks of ceil(n/w) vertices per rank (last rank may be short)."""
    per = -(-num_nodes // world_size)
    return np.minimum(np.arange(num_nodes) // per, world_size - 1).astype(np.int32)


def random_partition(num_nodes: int, world_size: int, seed: int = 0) -> np.ndarray:
    """Balanced random assignment (shuffled round-robin)."""
    rng = np.random.default_rng(seed)
    part = np.arange(num_nodes) % world_size
    rng.shuffle(part)
    return part.astype(np.int32)


def rcm_partition(edge_index: np.ndarray, num_nodes: int, world_size: int) -> np.ndarray:
    """Locality partition: reverse Cuthill-McKee ordering + balanced block split."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    data = np.ones(len(src), dtype=np.int8)
    adj = coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes)).tocsr()
    adj = adj + adj.T
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    part = np.empty(num_nodes, dtype=np.int32)
    per = -(-num_nodes // world_size)
    part[order] = np.minimum(np.arange(num_nodes) // per, world_size - 1)
    return part


@dataclasses.dataclass(frozen=True)
class Renumbering:
    """Vertex renumbering into contiguous per-rank blocks.

    Attributes:
      perm: old_id -> new_id (apply to edge lists as ``perm[edges]``).
      inv: new_id -> old_id (apply to feature matrices as ``x[inv]``).
      partition: [V] rank per NEW vertex id (non-decreasing).
      counts: [W] vertices owned per rank.
      offsets: [W+1] block start offsets in the new numbering.
    """

    perm: np.ndarray
    inv: np.ndarray
    partition: np.ndarray
    counts: np.ndarray
    offsets: np.ndarray


def renumber_contiguous(partition: np.ndarray, world_size: int) -> Renumbering:
    """Stable-sort vertices by rank so each rank owns a contiguous id block."""
    partition = np.asarray(partition)
    inv = np.argsort(partition, kind="stable")
    perm = np.empty_like(inv)
    perm[inv] = np.arange(len(inv))
    counts = np.bincount(partition, minlength=world_size).astype(np.int64)
    offsets = np.zeros(world_size + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    new_part = partition[inv].astype(np.int32)
    return Renumbering(perm=perm, inv=inv, partition=new_part, counts=counts, offsets=offsets)


METHODS = ("round_robin", "block", "random", "rcm")


def partition_graph(
    edge_index: np.ndarray,
    num_nodes: int,
    world_size: int,
    method: str = "rcm",
    seed: int = 0,
) -> tuple[np.ndarray, Renumbering]:
    """Partition + renumber in one call.

    Returns (renumbered_edge_index [2, E], renumbering). Edge endpoints are
    remapped into the new contiguous numbering; edge order is preserved.
    The multilevel and native partitioners of the reference are not ported
    yet and raise here.
    """
    if method == "round_robin":
        part = round_robin_partition(num_nodes, world_size)
    elif method == "block":
        part = block_partition(num_nodes, world_size)
    elif method == "random":
        part = random_partition(num_nodes, world_size, seed)
    elif method == "rcm":
        part = rcm_partition(edge_index, num_nodes, world_size)
    else:
        raise ValueError(
            f"unknown partition method: {method!r} (ported: {', '.join(METHODS)})"
        )
    ren = renumber_contiguous(part, world_size)
    new_edges = ren.perm[np.asarray(edge_index)]
    return new_edges, ren
