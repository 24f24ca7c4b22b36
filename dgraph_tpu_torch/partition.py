"""Graph partitioning and renumbering (host-side numpy).

A copy of every partitioner of ``dgraph_tpu/partition.py`` (round_robin,
block, random, rcm, greedy_bfs, the multilevel family) with ``Renumbering``,
``renumber_contiguous``, ``partition_graph``, ``fold_partition``,
``unfold_partition`` and ``edge_cut``: same inputs, same partitions, so a
port plan and a reference plan number vertices alike. The greedy BFS and
multilevel partitioners run in the native host library
(:mod:`dgraph_tpu_torch.native`, ``csrc/dgraph_host.cpp``) when it builds;
greedy BFS keeps a numpy fallback, and the multilevel family falls back to
greedy BFS with a warning, as the reference does.
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


def greedy_bfs_partition(
    edge_index: np.ndarray, num_nodes: int, world_size: int, seed: int = 0
) -> np.ndarray:
    """Greedy BFS region-growing partition with a hard balance cap.

    Grows each partition from an unassigned seed vertex by BFS until it holds
    ceil(n/w) vertices, then moves to the next partition. Cheap, deterministic,
    and cut-quality between round-robin and METIS. Dispatches to the native
    C++ implementation (csrc/dgraph_host.cpp) when built — the python loop
    below is the fallback-and-oracle.
    """
    from dgraph_tpu_torch import native

    if native.available():
        return native.greedy_bfs_partition(edge_index, num_nodes, world_size, seed)
    from scipy.sparse import coo_matrix

    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    data = np.ones(len(src), dtype=np.int8)
    adj = coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes)).tocsr()
    adj = (adj + adj.T).tocsr()

    cap = -(-num_nodes // world_size)
    part = np.full(num_nodes, -1, dtype=np.int32)
    rng = np.random.default_rng(seed)
    unassigned_ptr = 0
    order = np.arange(num_nodes)
    rng.shuffle(order)

    for r in range(world_size):
        count = 0
        frontier: list[int] = []
        while count < cap:
            if not frontier:
                # find a fresh seed
                while unassigned_ptr < num_nodes and part[order[unassigned_ptr]] >= 0:
                    unassigned_ptr += 1
                if unassigned_ptr >= num_nodes:
                    break
                frontier = [int(order[unassigned_ptr])]
            v = frontier.pop()
            if part[v] >= 0:
                continue
            part[v] = r
            count += 1
            nbrs = adj.indices[adj.indptr[v] : adj.indptr[v + 1]]
            frontier.extend(int(n) for n in nbrs if part[n] < 0)
    part[part < 0] = world_size - 1
    return part


def multilevel_partition(
    edge_index: np.ndarray, num_nodes: int, world_size: int, seed: int = 0
) -> np.ndarray:
    """Multilevel k-way partition — the METIS-shaped algorithm the reference
    uses via pymetis for its quality partitions (``experiments/OGB/
    preprocess.py:15-27``, ``GraphCast/data_utils/preprocess.py:14-31``):
    heavy-edge-matching coarsening, weighted greedy growth on the coarsest
    graph, FM-lite boundary refinement on the way back up.

    Native C++ only (csrc/dgraph_host.cpp) — a Python multilevel stack would
    defeat its purpose at scale; when the library is unavailable this falls
    back to :func:`greedy_bfs_partition` (the next-best cut quality here)
    with a warning.
    """
    from dgraph_tpu_torch import native

    if native.available():
        return native.multilevel_partition(edge_index, num_nodes, world_size, seed)
    import warnings

    warnings.warn(
        "native library unavailable; multilevel partition falling back to "
        "greedy_bfs (worse cut quality)", stacklevel=2,
    )
    return greedy_bfs_partition(edge_index, num_nodes, world_size, seed)


def multilevel_big_partition(
    edge_index: np.ndarray,
    num_nodes: int,
    world_size: int,
    seed: int = 0,
    max_cluster_weight: int = 12,
    refine_passes: int = 3,
    chunk: int = 1 << 26,
) -> np.ndarray:
    """Memory-bounded METIS-shaped partition for graphs the in-RAM
    multilevel stack cannot hold (papers100M scale).

    Pipeline (host peak = one int32 CSR + O(V) arrays + the coarse graph):

    1. capped greedy cluster coarsening (native ``cluster_coarsen_c``,
       ~4 bytes x 2E CSR) — one aggressive level instead of ~log V
       matching levels;
    2. chunked numpy contraction to unique weighted coarse pairs (the
       edge list may be a disk memmap; per-chunk dedup happens before
       the merged dedup, but the merge itself still sorts ALL surviving
       pairs — on hub-heavy graphs coarse pairs stay near E (measured
       ~0.93E even at 16x vertex reduction), so the merge transient is
       O(E) ints, not bounded; :func:`multilevel_sampled_partition` is
       the default full-papers100M path for exactly this reason);
    3. the full in-RAM multilevel+FM+volume-polish stack on the coarse
       graph (native ``multilevel_partition_w_c`` — balance objective is
       summed fine-vertex weight);
    4. projection + greedy boundary refinement on the fine graph (native
       ``refine_unweighted_csr_c``, same int32-CSR memory form).

    Falls back to :func:`greedy_bfs_partition` with a warning when the
    native library is unavailable (same policy as multilevel).
    """
    from dgraph_tpu_torch import native

    if not native.available():
        import warnings

        warnings.warn(
            "native library unavailable; multilevel_big falling back to "
            "greedy_bfs (worse cut quality)", stacklevel=2,
        )
        return greedy_bfs_partition(edge_index, num_nodes, world_size, seed)

    src, dst = edge_index[0], edge_index[1]
    cmap, nc = native.cluster_coarsen(
        edge_index, num_nodes, max_cluster_weight, seed
    )

    # chunked contraction: map endpoints through cmap, drop intra-cluster
    # edges, dedup-accumulate (lo, hi) pair multiplicities
    enc_parts, cnt_parts = [], []
    E = src.shape[0]
    for lo_e in range(0, E, chunk):
        hi_e = min(lo_e + chunk, E)
        cu = cmap[np.asarray(src[lo_e:hi_e])]
        cv = cmap[np.asarray(dst[lo_e:hi_e])]
        lo = np.minimum(cu, cv)
        hi = np.maximum(cu, cv)
        keep = lo != hi
        enc = lo[keep] * nc + hi[keep]
        u, c = np.unique(enc, return_counts=True)
        enc_parts.append(u)
        cnt_parts.append(c.astype(np.int64))
    enc = np.concatenate(enc_parts) if enc_parts else np.zeros(0, np.int64)
    cnt = np.concatenate(cnt_parts) if cnt_parts else np.zeros(0, np.int64)
    del enc_parts, cnt_parts
    # no kind="stable": reduceat sums equal keys regardless of their
    # relative order, and introsort skips mergesort's working buffer
    order = np.argsort(enc)
    enc, cnt = enc[order], cnt[order]
    del order
    starts = np.flatnonzero(
        np.concatenate([[True], enc[1:] != enc[:-1]])
    ) if len(enc) else np.zeros(0, np.int64)
    uniq = enc[starts]
    w = np.add.reduceat(cnt, starts) if len(starts) else cnt
    del enc, cnt
    vw = np.bincount(cmap, minlength=nc).astype(np.int64)

    cpart = native.multilevel_partition_weighted(
        uniq // nc, uniq % nc, w, vw, nc, world_size, seed
    )
    part = cpart[cmap].astype(np.int32)
    return native.refine_unweighted_csr(
        edge_index, num_nodes, world_size, part, passes=refine_passes
    )


def multilevel_sampled_partition(
    edge_index: np.ndarray,
    num_nodes: int,
    world_size: int,
    seed: int = 0,
    sample_frac: float = 0.5,
    refine_passes: int = 3,
    chunk: int = 1 << 26,
    edge_balance: float = 0.0,
) -> np.ndarray:
    """Full multilevel+FM stack on a uniform edge sample, then greedy
    boundary refinement on the full graph (native
    ``refine_unweighted_csr_c``).

    Uniform sampling keeps the EXPECTED cut of every candidate partition
    proportional to its true cut, so the multilevel optimizer sees an
    unbiased objective at ``sample_frac`` of the memory/time — the lever
    that brings full papers100M (111M nodes / 1.6B edges) inside one
    host's RAM.

    The sample is drawn chunk-wise so ``edge_index`` may be a disk memmap.
    """
    from dgraph_tpu_torch import native

    if not native.available():
        import warnings

        warnings.warn(
            "native library unavailable; multilevel_sampled falling back "
            "to greedy_bfs (worse cut quality)", stacklevel=2,
        )
        return greedy_bfs_partition(edge_index, num_nodes, world_size, seed)

    rng = np.random.default_rng(seed)
    E = edge_index.shape[1]
    parts = []
    deg_in = (
        np.zeros(num_nodes, np.int64) if edge_balance > 0 else None
    )
    for lo in range(0, E, chunk):
        hi = min(lo + chunk, E)
        blk = np.asarray(edge_index[:, lo:hi])
        if deg_in is not None:
            # plans own edges at the dst vertex, so per-rank edge volume
            # is summed IN-degree of owned vertices — that's the weight
            # that co-balances e_pad
            deg_in += np.bincount(blk[1], minlength=num_nodes)
        keep = rng.random(hi - lo) < sample_frac
        parts.append(blk[:, keep])
    sub = np.ascontiguousarray(np.concatenate(parts, axis=1))
    del parts
    if deg_in is not None:
        # vw = 16 + round(16*alpha*deg/mean_deg): Σvw ≈ 16V(1+alpha); the
        # x16 scale keeps integer rounding from quantizing small alphas.
        # A vertex-balanced partition leaves owner-edge volume imbalanced
        # where hub in-degrees concentrate; the blend trades a little
        # vertex padding (n_pad) for edge balance (e_pad).
        mean_deg = max(E / num_nodes, 1e-9)
        vw = 16 + np.rint(16.0 * edge_balance * deg_in / mean_deg).astype(
            np.int64
        )
        del deg_in
        part = native.multilevel_partition_vertex_weighted(
            sub, vw, num_nodes, world_size, seed
        )
        del sub
        # refine under the SAME weights: a unit-count refine rebalances
        # vertex counts to 1.03 and undoes the edge balance
        return native.refine_weighted_csr(
            edge_index, vw, num_nodes, world_size, part,
            passes=refine_passes,
        )
    part = multilevel_partition(sub, num_nodes, world_size, seed)
    del sub
    return native.refine_unweighted_csr(
        edge_index, num_nodes, world_size, part, passes=refine_passes
    )


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


METHODS = ("round_robin", "block", "random", "rcm", "greedy_bfs", "multilevel", "metis",
           "multilevel_big", "multilevel_sampled")


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
    """
    if method == "round_robin":
        part = round_robin_partition(num_nodes, world_size)
    elif method == "block":
        part = block_partition(num_nodes, world_size)
    elif method == "random":
        part = random_partition(num_nodes, world_size, seed)
    elif method == "rcm":
        part = rcm_partition(edge_index, num_nodes, world_size)
    elif method == "greedy_bfs":
        part = greedy_bfs_partition(edge_index, num_nodes, world_size, seed)
    elif method in ("multilevel", "metis"):
        part = multilevel_partition(edge_index, num_nodes, world_size, seed)
    elif method == "multilevel_big":
        part = multilevel_big_partition(edge_index, num_nodes, world_size, seed)
    elif method == "multilevel_sampled":
        part = multilevel_sampled_partition(edge_index, num_nodes, world_size, seed)
    else:
        raise ValueError(
            f"unknown partition method: {method!r} (known: {', '.join(METHODS)})"
        )
    ren = renumber_contiguous(part, world_size)
    new_edges = ren.perm[np.asarray(edge_index)]
    return new_edges, ren


def fold_partition(
    partition: np.ndarray, world_size: int, lost_ranks
) -> tuple[np.ndarray, dict]:
    """Shrink-to-fit a partition: deterministically reassign the LOST
    ranks' vertices to the survivors and compact surviving rank ids to
    ``0..W'-1``.

    This is the redistribution step of elastic rank-loss recovery
    (the reference's ``train/shrink.py``): instead of re-partitioning from
    scratch (which would move *every* vertex and invalidate locality the
    tuner already priced), only the dead ranks' blocks move.  Allocation
    is a waterfill — each survivor receives enough orphaned vertices to
    equalize final loads (ties broken toward lower survivor ids), and the
    orphans are handed out in vertex order as contiguous chunks per
    survivor, preserving intra-block locality.  The whole fold is a pure
    function of ``(partition, lost_ranks)``, so a crashed recovery that
    reruns — or a fault-free run shrunk from the same inputs — lands the
    identical partition (the bit-identical degraded-resume contract).

    Returns ``(new_partition, survivor_map)`` where ``new_partition`` is
    over the SAME vertex numbering as the input (run
    :func:`renumber_contiguous` before building a plan) and
    ``survivor_map`` maps old surviving rank id -> new compact id.
    """
    part = np.asarray(partition)
    lost = sorted(set(int(r) for r in lost_ranks))
    if not lost:
        raise ValueError("fold_partition: lost_ranks is empty")
    for r in lost:
        if not 0 <= r < world_size:
            raise ValueError(
                f"fold_partition: lost rank {r} not in [0, {world_size})"
            )
    survivors = [r for r in range(world_size) if r not in lost]
    if not survivors:
        raise ValueError("fold_partition: no surviving ranks")
    survivor_map = {old: new for new, old in enumerate(survivors)}
    S = len(survivors)
    counts = np.bincount(part, minlength=world_size).astype(np.int64)
    loads = counts[survivors].copy()
    orphans = np.flatnonzero(np.isin(part, lost))
    L = orphans.size
    # waterfill: smallest final max-load, deterministic. Find the lowest
    # integer level T with sum(max(0, T - load)) >= L, allocate up to T,
    # then trim the surplus from the HIGHEST-id survivors (stable rule).
    lo, hi = int(loads.min()), int(loads.max()) + L
    while lo < hi:
        mid = (lo + hi) // 2
        if int(np.clip(mid - loads, 0, None).sum()) >= L:
            hi = mid
        else:
            lo = mid + 1
    alloc = np.clip(lo - loads, 0, None).astype(np.int64)
    surplus = int(alloc.sum()) - L
    for i in range(S - 1, -1, -1):
        if surplus <= 0:
            break
        take = min(surplus, int(alloc[i]))
        alloc[i] -= take
        surplus -= take
    new_part = np.empty_like(part, dtype=np.int32)
    # survivors keep their vertices under compacted ids
    remap = np.full(world_size, -1, dtype=np.int32)
    for old, new in survivor_map.items():
        remap[old] = new
    keep = ~np.isin(part, lost)
    new_part[keep] = remap[part[keep]]
    # orphans: contiguous chunks per survivor, in vertex order
    new_part[orphans] = np.repeat(
        np.arange(S, dtype=np.int32), alloc
    )
    return new_part, survivor_map

def unfold_partition(
    partition: np.ndarray, world_size: int, k: int
) -> tuple[np.ndarray, dict]:
    """Grow-to-fit a partition: deterministically donate tail chunks of
    the existing ranks' blocks to ``k`` NEW ranks (ids ``world_size ..
    world_size+k-1``) — the waterfill inverse of :func:`fold_partition`.

    This is the redistribution step of elastic rank-arrival recovery
    (the reference's ``train/grow.py``): instead of re-partitioning from
    scratch (which would move *every* vertex and invalidate locality the
    tuner already priced), existing ranks' kept vertices never move —
    each over-level rank donates only the TAIL of its block (its
    highest-id vertices, so the keepers stay a contiguous prefix after
    :func:`renumber_contiguous`).  The level is a waterfill mirror of
    the fold's: the lowest integer ``T`` such that capping every
    existing rank at ``T`` frees enough vertices to fill ``k`` newcomers
    to at most ``T`` each; newcomer allocations are trimmed from the
    HIGHEST-id newcomers first (the same stable tie rule the fold trims
    survivors with), and donated vertices are handed out in vertex
    order as contiguous chunks per newcomer.  The whole unfold is a
    pure function of ``(partition, k)``, so a crashed recovery that
    reruns lands the identical partition — and on a renumbered
    partition whose donated chunks sit at the high end of vertex order,
    ``fold_partition(unfold_partition(p, W, k)[0], W+k, [W..W+k-1])``
    restores ``p`` exactly.

    Returns ``(new_partition, donor_map)`` where ``new_partition`` is
    over the SAME vertex numbering as the input (run
    :func:`renumber_contiguous` before building a plan) and
    ``donor_map`` maps donating old rank id -> number of vertices it
    donated.
    """
    part = np.asarray(partition)
    k = int(k)
    if k < 1:
        raise ValueError(f"unfold_partition: k must be >= 1, got {k}")
    counts = np.bincount(part, minlength=world_size).astype(np.int64)
    if len(counts) > world_size:
        raise ValueError(
            f"unfold_partition: partition names rank "
            f"{len(counts) - 1} >= world_size {world_size}"
        )
    # waterfill level: lowest integer T with
    # sum(min(counts, T)) + k*T >= total, i.e. capping every existing
    # rank at T frees enough orphans to fill k newcomers to <= T each —
    # the smallest achievable final max-load, deterministic
    lo, hi = 0, int(counts.max(initial=0))
    while lo < hi:
        mid = (lo + hi) // 2
        if int(np.clip(counts - mid, 0, None).sum()) <= k * mid:
            hi = mid
        else:
            lo = mid + 1
    level = lo
    donate = np.clip(counts - level, 0, None).astype(np.int64)
    donated_total = int(donate.sum())
    alloc = np.full(k, level, dtype=np.int64)
    surplus = k * level - donated_total
    for i in range(k - 1, -1, -1):
        if surplus <= 0:
            break
        take = min(surplus, int(alloc[i]))
        alloc[i] -= take
        surplus -= take
    new_part = part.astype(np.int32).copy()
    donated_ids = [
        # the donor's TAIL: its highest-id vertices, so the kept block
        # stays a contiguous prefix under the existing numbering
        np.flatnonzero(part == r)[-int(donate[r]):]
        for r in np.flatnonzero(donate)
    ]
    if donated_ids:
        donated_sorted = np.sort(np.concatenate(donated_ids))
        new_part[donated_sorted] = world_size + np.repeat(
            np.arange(k, dtype=np.int32), alloc
        )
    donor_map = {int(r): int(donate[r]) for r in np.flatnonzero(donate)}
    return new_part, donor_map

def edge_cut(edge_index: np.ndarray, partition: np.ndarray) -> float:
    """Fraction of edges crossing partitions (quality metric)."""
    src, dst = edge_index[0], edge_index[1]
    return float(np.mean(partition[src] != partition[dst]))
