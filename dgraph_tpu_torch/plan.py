"""Host-side builder of the static-shape, padded edge plan.

Counterpart of ``dgraph_tpu/plan.py`` along its single-process numpy path
(``build_edge_plan`` -> ``_plan_build_prologue`` -> ``_numpy_plan_prep`` ->
``_finalize_plan``). The arrays are built with numpy exactly as the reference
builds them, so every plan leaf is array-equal to the reference's for the
same inputs; they are then held as torch tensors in an :class:`EdgePlan`
dataclass with ``.to(device)``.

Not ported yet: the interior/boundary overlap split, the native streaming
core (the reference only takes it from ``NATIVE_PLAN_MIN_EDGES`` edges on),
the sharded build, and the sched/wire attachments.

Conventions (as in the reference): edge lists are ``[2, E]``; vertices are
renumbered into contiguous per-rank blocks first; the default edge owner is
the dst rank; every plan array carries a leading ``[world_size]`` axis. On
a rank with ``n_pad`` padded local vertices and send pad ``s_pad``, the halo
copy of a vertex owned by rank p at position i of p's send list lives at row
``n_pad + p*s_pad + i`` of the ``[local ; halo]`` feature table.
"""

from __future__ import annotations

import dataclasses
import math
import os
import types
from typing import Optional

import numpy as np
import torch

# Edge-block size the reference's Pallas scatter kernels tile by. The plan
# keeps it for two reasons: e_pad aligns to it once the plan reaches kernel
# scale (so both packages pad alike), and the reference's chunk hints
# (scatter_mc, gather_mv, halo_sort_mc) are computed for it. Same env names
# as the reference, so one environment gives both packages one plan.
SCATTER_BLOCK_E = int(os.environ.get("DGRAPH_TPU_SCATTER_BLOCK_E", "1024"))
SCATTER_BLOCK_N = int(os.environ.get("DGRAPH_TPU_SCATTER_BLOCK_N", "256"))

# Edge count from which the reference's builder skips the halo sort route
# (and takes its native core); the port follows the same default.
NATIVE_PLAN_MIN_EDGES = 1 << 24


def _tensor_fields(obj):
    return [
        f.name for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    ]


def _map_tensors(obj, fn):
    """Copy of a plan dataclass with ``fn`` applied to every tensor leaf."""
    kw = {name: fn(getattr(obj, name)) for name in _tensor_fields(obj)}
    halo = getattr(obj, "halo", None)
    if isinstance(halo, HaloSpec):
        kw["halo"] = _map_tensors(halo, fn)
    return dataclasses.replace(obj, **kw)


@dataclasses.dataclass(frozen=True)
class HaloSpec:
    """Halo-exchange spec for one vertex set.

    ``send_idx[r, p, i]`` = local vertex id (on rank r) of the i-th vertex r
    sends to rank p; ``send_mask`` marks real (non-padded) slots. Rank r's
    received block from p occupies halo rows ``[p*s_pad, (p+1)*s_pad)``.
    A per-rank view (:meth:`EdgePlan.shard`) drops the leading rank axis.
    """

    send_idx: torch.Tensor  # i32[W, W, S]
    send_mask: torch.Tensor  # f32[W, W, S]
    s_pad: int


@dataclasses.dataclass(frozen=True)
class EdgePlan:
    """Padded, static-shape plan for one edge set, stacked over ranks.

    Index spaces (per rank):
      - ``src_index``: [E] into ``[0, n_src_pad + W*s_pad)`` if
        ``halo_side=='src'`` else ``[0, n_src_pad)``.
      - ``dst_index``: [E] into ``[0, n_dst_pad + W*s_pad)`` if
        ``halo_side=='dst'`` else ``[0, n_dst_pad)``.
    Padded edges have halo-side index 0, owner-side index ``n_owner_pad``
    (out of range, so the sorted order stays monotone and reductions drop
    them) and ``edge_mask`` 0.
    """

    src_index: torch.Tensor  # i32[W, E]
    dst_index: torch.Tensor  # i32[W, E]
    edge_mask: torch.Tensor  # f32[W, E]
    num_local_src: torch.Tensor  # i32[W]
    num_local_dst: torch.Tensor  # i32[W]
    num_edges: torch.Tensor  # i32[W]
    halo: HaloSpec
    world_size: int
    n_src_pad: int
    n_dst_pad: int
    e_pad: int
    halo_side: str  # 'src' or 'dst'
    homogeneous: bool
    # True when each rank's edges are sorted by the owner-side vertex index:
    # the aggregation's segment ids are then monotone — what the CSR
    # segment kernels require
    owner_sorted: bool = True
    # the reference's Pallas chunk hints, computed for the recorded block
    # sizes; carried for plan parity, unused by the CSR kernels
    scatter_mc: int = 1
    scatter_block_e: int = 512
    scatter_block_n: int = 256
    # rank deltas ((peer - rank) mod W) with halo traffic anywhere
    halo_deltas: tuple = ()
    # a permutation putting the (non-monotone) halo-side ids in sorted
    # order, and those sorted ids; None on plans built with sort_route=False
    halo_sort_perm: Optional[torch.Tensor] = None  # i32[W, E]
    halo_sorted_ids: Optional[torch.Tensor] = None  # i32[W, E]
    halo_sort_mc: int = 1
    gather_mv: int = 0
    # [W][W] deduped live halo rows per (sender, needer) pair
    halo_pair_rows: tuple = ()
    # True on a per-rank view (leading rank axis dropped)
    per_rank: bool = False

    def ids_sorted(self, side: str) -> bool:
        """True iff this side's per-edge index is monotone: the OWNER side
        of an owner-sorted plan. The halo side mixes local rows with halo
        slots and is never monotone."""
        return self.owner_sorted and side != self.halo_side

    def to(self, device) -> "EdgePlan":
        """Copy with every tensor leaf moved to ``device``."""
        return _map_tensors(self, lambda t: t.to(device))

    def shard(self, rank: int) -> "EdgePlan":
        """Per-rank view: every leaf indexed at ``rank`` (the counterpart of
        the reference's ``squeeze_plan`` inside ``shard_map``)."""
        if self.per_rank:
            raise ValueError("plan is already a per-rank view")
        view = _map_tensors(self, lambda t: t[rank])
        return dataclasses.replace(view, per_rank=True)


@dataclasses.dataclass
class EdgePlanLayout:
    """Host-side companion of :class:`EdgePlan` (numpy; build metadata).

    ``edge_rank``/``edge_slot``: for global edge i (in the caller's original
    edge order), the owning rank and its padded slot — :func:`shard_edge_data`
    lays per-edge data into the ``[W, e_pad]`` plan layout with them.
    """

    edge_rank: np.ndarray  # [E_total]
    edge_slot: np.ndarray  # [E_total]
    halo_counts: np.ndarray  # [W, W] (sender, needer) deduped halo vertex counts
    src_counts: np.ndarray  # [W]
    dst_counts: np.ndarray  # [W]


def _pad_to(x: int, multiple: int) -> int:
    if multiple <= 1:
        return max(x, 1)
    return max(-(-x // multiple) * multiple, multiple)


def _reject_incompatible_knobs(
    pad_multiple: int, e_pad: Optional[int], s_pad: Optional[int]
) -> None:
    """Fail fast, naming the knobs, on plan geometry that cannot be built."""
    if pad_multiple < 1:
        raise ValueError(f"pad_multiple={pad_multiple} must be >= 1")
    if e_pad is not None:
        if e_pad < 1:
            raise ValueError(f"e_pad={e_pad} must be >= 1")
        if pad_multiple > 1 and e_pad % pad_multiple:
            raise ValueError(
                f"e_pad={e_pad} conflicts with pad_multiple={pad_multiple}: "
                f"an explicit e_pad must be a multiple of pad_multiple; pick "
                f"e_pad={_pad_to(e_pad, pad_multiple)} or drop one of the two knobs"
            )
        if e_pad >= SCATTER_BLOCK_E and e_pad % SCATTER_BLOCK_E:
            raise ValueError(
                f"e_pad={e_pad} conflicts with scatter_block_e="
                f"{SCATTER_BLOCK_E}: a kernel-scale e_pad must be a multiple "
                f"of the edge block (or stay below it); pick "
                f"e_pad={_pad_to(e_pad, SCATTER_BLOCK_E)}"
            )
    if s_pad is not None:
        if s_pad < 1:
            raise ValueError(f"s_pad={s_pad} must be >= 1")
        if pad_multiple > 1 and s_pad % pad_multiple:
            raise ValueError(
                f"s_pad={s_pad} conflicts with pad_multiple={pad_multiple}: "
                f"an explicit s_pad must be a multiple of pad_multiple; pick "
                f"s_pad={_pad_to(s_pad, pad_multiple)}"
            )


def _edge_pad_align(e_max: int, pad_multiple: int) -> int:
    """Alignment of the per-rank edge padding: once the plan reaches kernel
    scale, e_pad also aligns to the edge block."""
    if e_max >= SCATTER_BLOCK_E:
        return math.lcm(pad_multiple, SCATTER_BLOCK_E)
    return pad_multiple


def max_chunks_hint(
    segment_ids, num_segments: int, block_e: int = 512, block_n: int = 256
) -> int:
    """Max ``block_e`` edge chunks any ``block_n`` vertex block spans, for
    sorted ids (the reference kernel's ``max_chunks_per_block`` bound)."""
    ids = np.asarray(segment_ids)
    nb = -(-num_segments // block_n)
    starts = np.searchsorted(ids, np.arange(nb) * block_n)
    ends = np.searchsorted(ids, np.arange(1, nb + 1) * block_n, side="left")
    cs = starts // block_e
    ce = -(-ends // block_e)
    return max(1, int((ce - cs).max(initial=1)))


def max_vblocks_hint(
    segment_ids, num_rows: int, block_e: int = 512, block_n: int = 256
) -> int:
    """Max ``block_n`` vertex blocks any ``block_e`` edge chunk spans, for
    sorted ids (the reference's sorted-row-gather bound)."""
    ids = np.clip(np.asarray(segment_ids), 0, max(num_rows - 1, 0))
    E = ids.shape[0]
    if E == 0:
        return 1
    E_pad = -(-E // block_e) * block_e
    ids_p = np.pad(ids, (0, E_pad - E), constant_values=ids[-1])
    chunks = ids_p.reshape(-1, block_e)
    span = chunks[:, -1] // block_n - chunks[:, 0] // block_n + 1
    return max(1, int(span.max(initial=1)))


def build_edge_plan(
    edge_index: np.ndarray,
    src_partition: np.ndarray,
    dst_partition: Optional[np.ndarray] = None,
    *,
    world_size: int,
    edge_owner: str = "dst",
    n_src_pad: Optional[int] = None,
    n_dst_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    s_pad: Optional[int] = None,
    pad_multiple: int = 8,
    sort_edges: bool = True,
    sort_route: Optional[bool] = None,
) -> tuple[EdgePlan, EdgePlanLayout]:
    """Build the padded plan for one edge set.

    Args:
      edge_index: [2, E] global edges in contiguous-block numbering
        (:func:`dgraph_tpu_torch.partition.renumber_contiguous`).
      src_partition / dst_partition: [V_src] / [V_dst] owner rank per vertex;
        dst_partition=None means homogeneous (same vertex set both sides).
      edge_owner: 'dst' (aggregation is rank-local) or 'src'.
      pad_multiple: round padded sizes up to this multiple.
      sort_route: attach the halo-side sorting permutation (None = when
        E < NATIVE_PLAN_MIN_EDGES, as the reference decides).

    Returns (plan, layout); the plan's tensors live on the CPU.
    """
    pro = _plan_build_prologue(
        edge_index, src_partition, dst_partition, edge_owner=edge_owner,
        sort_route=sort_route, pad_multiple=pad_multiple, e_pad=e_pad,
        s_pad=s_pad, world_size=world_size,
    )
    W = world_size
    prep = _numpy_plan_prep(
        pro.src, pro.dst, pro.src_partition, pro.dst_partition,
        pro.src_offsets, pro.dst_offsets, pro.src_counts, pro.dst_counts,
        W, edge_owner, sort_edges, n_src_pad, n_dst_pad, e_pad, s_pad,
        pad_multiple,
    )

    def to_padded(vals, dtype, fill=0):
        out = np.full((W, prep.e_pad), fill, dtype=dtype)
        out[prep.edge_rank, prep.edge_slot] = vals
        return out

    edge_mask = np.zeros((W, prep.e_pad), dtype=np.float32)
    edge_mask[prep.edge_rank, prep.edge_slot] = 1.0
    # owner-side padding = n_pad: keeps sorted order monotone through the
    # padded tail and is dropped by segment reductions
    halo_vals = prep.halo_side_local_idx.astype(np.int32)
    own_vals = prep.own_local.astype(np.int32)
    if prep.halo_side == "src":
        src_idx_arr = to_padded(halo_vals, np.int32)
        dst_idx_arr = to_padded(own_vals, np.int32, fill=prep.n_owner_pad)
    else:
        src_idx_arr = to_padded(own_vals, np.int32, fill=prep.n_owner_pad)
        dst_idx_arr = to_padded(halo_vals, np.int32)

    return _finalize_plan(
        prep, src_idx_arr=src_idx_arr, dst_idx_arr=dst_idx_arr,
        edge_mask=edge_mask, homogeneous=pro.homogeneous,
        edge_owner=edge_owner, owner_sorted=sort_edges,
        sort_route=pro.sort_route,
    )


def _plan_build_prologue(
    edge_index, src_partition, dst_partition, *, edge_owner, sort_route,
    pad_multiple, e_pad, s_pad, world_size,
):
    """Validation and derived inputs: shapes, owner, knobs, per-rank
    counts/offsets, the contiguity check and the sort_route default."""
    edge_index = np.asarray(edge_index)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    _reject_incompatible_knobs(pad_multiple, e_pad, s_pad)
    if edge_owner not in ("src", "dst"):
        raise ValueError("edge_owner must be 'src' or 'dst'")
    src_partition = np.asarray(src_partition)
    homogeneous = dst_partition is None
    dst_partition = src_partition if homogeneous else np.asarray(dst_partition)
    W = world_size
    src = edge_index[0].astype(np.int64, copy=False)
    dst = edge_index[1].astype(np.int64, copy=False)
    E = len(src)
    src_counts = np.bincount(src_partition, minlength=W).astype(np.int64)
    dst_counts = np.bincount(dst_partition, minlength=W).astype(np.int64)
    src_offsets = np.concatenate([[0], np.cumsum(src_counts)])
    dst_offsets = np.concatenate([[0], np.cumsum(dst_counts)])
    if np.any(np.diff(src_partition) < 0) or np.any(np.diff(dst_partition) < 0):
        raise ValueError(
            "partitions must be contiguous per-rank blocks; run "
            "dgraph_tpu_torch.partition.renumber_contiguous first"
        )
    if sort_route is None:
        sort_route = E < NATIVE_PLAN_MIN_EDGES
    return types.SimpleNamespace(
        src=src, dst=dst, E=E,
        src_partition=src_partition, dst_partition=dst_partition,
        homogeneous=homogeneous,
        src_counts=src_counts, dst_counts=dst_counts,
        src_offsets=src_offsets, dst_offsets=dst_offsets,
        sort_route=sort_route,
    )


def _numpy_plan_prep(
    src, dst, src_partition, dst_partition, src_offsets, dst_offsets,
    src_counts, dst_counts, W, edge_owner, sort_edges,
    n_src_pad, n_dst_pad, e_pad, s_pad, pad_multiple,
):
    """Every per-edge / per-peer intermediate of the padded index arrays."""
    E = len(src)
    if edge_owner == "dst":
        owner = dst_partition[dst]
        halo_side = "src"
        halo_vid, halo_part = src, src_partition
    else:
        owner = src_partition[src]
        halo_side = "dst"
        halo_vid, halo_part = dst, dst_partition

    # group edges by owner rank; sort by owner-side vertex within each rank
    # so aggregation segment ids are monotone
    owner_side_vid = dst if edge_owner == "dst" else src
    if sort_edges:
        order = np.lexsort((owner_side_vid, owner))
    else:
        order = np.argsort(owner, kind="stable")
    e_counts = np.bincount(owner, minlength=W).astype(np.int64)
    _e_max = int(e_counts.max(initial=1))
    E_pad = e_pad if e_pad is not None else _pad_to(
        _e_max, _edge_pad_align(_e_max, pad_multiple))
    if int(e_counts.max(initial=0)) > E_pad:
        raise ValueError(f"e_pad={E_pad} < max per-rank edges {int(e_counts.max())}")
    e_starts = np.concatenate([[0], np.cumsum(e_counts)])
    slot_sorted = np.arange(E, dtype=np.int64) - e_starts[owner[order]]
    edge_slot = np.empty(E, dtype=np.int64)
    edge_slot[order] = slot_sorted
    edge_rank = owner

    # halo sets: unique (needer_rank, halo_vertex) pairs of cross edges
    cross = halo_part[halo_vid] != owner
    v_total = len(halo_part)
    enc = owner[cross].astype(np.int64) * v_total + halo_vid[cross]
    enc_u = np.unique(enc)  # sorted by (needer, vid); vid-sorted == owner-grouped
    needer = enc_u // v_total
    hvid = enc_u % v_total
    sender = halo_part[hvid]
    halo_counts = np.zeros((W, W), dtype=np.int64)
    np.add.at(halo_counts, (sender, needer), 1)
    S_pad = s_pad if s_pad is not None else _pad_to(int(halo_counts.max(initial=1)), pad_multiple)
    if int(halo_counts.max(initial=0)) > S_pad:
        raise ValueError(f"s_pad={S_pad} < max per-peer halo {int(halo_counts.max())}")

    halo_side_offsets = src_offsets if halo_side == "src" else dst_offsets
    N_src_pad = n_src_pad if n_src_pad is not None else _pad_to(int(src_counts.max(initial=1)), pad_multiple)
    N_dst_pad = n_dst_pad if n_dst_pad is not None else _pad_to(int(dst_counts.max(initial=1)), pad_multiple)
    N_halo_pad = N_src_pad if halo_side == "src" else N_dst_pad

    # position of each (needer, vid) within its (sender->needer) segment
    seg_key = needer * W + sender
    change = np.concatenate([[True], seg_key[1:] != seg_key[:-1]])
    run_starts = np.nonzero(change)[0]
    run_id = np.cumsum(change) - 1
    pos_in_seg = np.arange(len(seg_key)) - run_starts[run_id]

    send_idx = np.zeros((W, W, S_pad), dtype=np.int32)
    send_mask = np.zeros((W, W, S_pad), dtype=np.float32)
    send_local = hvid - halo_side_offsets[sender]
    send_idx[sender, needer, pos_in_seg] = send_local.astype(np.int32)
    send_mask[sender, needer, pos_in_seg] = 1.0

    halo_slot = N_halo_pad + sender * S_pad + pos_in_seg
    edge_enc = owner.astype(np.int64) * v_total + halo_vid
    idx_in_u = np.searchsorted(enc_u, edge_enc)
    idx_in_u = np.clip(idx_in_u, 0, max(len(enc_u) - 1, 0))

    if halo_side == "src":
        own_side_vid, own_side_off = dst, dst_offsets
        halo_side_vid = src
    else:
        own_side_vid, own_side_off = src, src_offsets
        halo_side_vid = dst

    own_local = own_side_vid - own_side_off[owner]
    local_halo_side = halo_side_vid - halo_side_offsets[owner]
    if len(enc_u) > 0:
        remote_slot = halo_slot[idx_in_u]
    else:
        remote_slot = np.zeros(E, dtype=np.int64)
    halo_side_local_idx = np.where(~cross, local_halo_side, remote_slot)

    n_owner_pad = N_dst_pad if edge_owner == "dst" else N_src_pad
    return types.SimpleNamespace(
        W=W, E=E, halo_side=halo_side, e_counts=e_counts, e_pad=E_pad,
        edge_rank=edge_rank, edge_slot=edge_slot,
        halo_counts=halo_counts, s_pad=S_pad,
        n_src_pad=N_src_pad, n_dst_pad=N_dst_pad, n_owner_pad=n_owner_pad,
        send_idx=send_idx, send_mask=send_mask,
        own_local=own_local, halo_side_local_idx=halo_side_local_idx,
        src_counts=src_counts, dst_counts=dst_counts,
        halo_deltas=tuple(int(d) for d in np.unique((needer - sender) % W)),
    )


def _finalize_plan(
    prep, *, src_idx_arr, dst_idx_arr, edge_mask, homogeneous, edge_owner,
    owner_sorted, sort_route,
) -> tuple[EdgePlan, EdgePlanLayout]:
    """Chunk hints, the halo sort route, and the EdgePlan/EdgePlanLayout."""
    W = prep.W
    owner_idx_arr = dst_idx_arr if edge_owner == "dst" else src_idx_arr
    block_e, block_n = SCATTER_BLOCK_E, SCATTER_BLOCK_N
    if owner_sorted:
        scatter_mc = max(
            max_chunks_hint(owner_idx_arr[r], prep.n_owner_pad,
                            block_e=block_e, block_n=block_n)
            for r in range(W)
        )
        gather_mv = max(
            max_vblocks_hint(owner_idx_arr[r], prep.n_owner_pad,
                             block_e=block_e, block_n=block_n)
            for r in range(W)
        )
    else:
        scatter_mc, gather_mv = 1, 0

    halo_sort_perm = halo_sorted_ids = None
    halo_sort_mc = 1
    if sort_route:
        halo_idx_arr = src_idx_arr if prep.halo_side == "src" else dst_idx_arr
        n_halo_rows = (
            prep.n_src_pad if prep.halo_side == "src" else prep.n_dst_pad
        ) + W * prep.s_pad
        perm = np.argsort(halo_idx_arr, axis=1, kind="stable").astype(np.int32)
        sorted_ids = np.take_along_axis(halo_idx_arr, perm, axis=1)
        halo_sort_mc = max(
            max_chunks_hint(sorted_ids[r], n_halo_rows,
                            block_e=block_e, block_n=block_n)
            for r in range(W)
        )
        halo_sort_perm = torch.from_numpy(perm)
        halo_sorted_ids = torch.from_numpy(sorted_ids)

    t = torch.from_numpy
    plan = EdgePlan(
        src_index=t(src_idx_arr),
        dst_index=t(dst_idx_arr),
        edge_mask=t(edge_mask),
        num_local_src=t(prep.src_counts.astype(np.int32)),
        num_local_dst=t(prep.dst_counts.astype(np.int32)),
        num_edges=t(prep.e_counts.astype(np.int32)),
        halo=HaloSpec(send_idx=t(prep.send_idx), send_mask=t(prep.send_mask),
                      s_pad=prep.s_pad),
        world_size=W,
        n_src_pad=prep.n_src_pad,
        n_dst_pad=prep.n_dst_pad,
        e_pad=prep.e_pad,
        halo_side=prep.halo_side,
        homogeneous=homogeneous,
        owner_sorted=owner_sorted,
        scatter_mc=scatter_mc,
        scatter_block_e=block_e,
        scatter_block_n=block_n,
        halo_deltas=prep.halo_deltas,
        halo_sort_perm=halo_sort_perm,
        halo_sorted_ids=halo_sorted_ids,
        halo_sort_mc=halo_sort_mc,
        gather_mv=gather_mv,
        halo_pair_rows=tuple(
            tuple(int(v) for v in row) for row in prep.halo_counts
        ),
    )
    layout = EdgePlanLayout(
        edge_rank=prep.edge_rank,
        edge_slot=prep.edge_slot,
        halo_counts=prep.halo_counts,
        src_counts=prep.src_counts,
        dst_counts=prep.dst_counts,
    )
    return plan, layout


def validate_plan(plan: EdgePlan) -> None:
    """Host-side structural validation of a stacked plan: index bounds, send
    lists, edge counts and the halo sort route. Raises ValueError."""
    if plan.per_rank:
        raise ValueError("validate_plan takes the stacked plan, not a per-rank view")
    W, S = plan.world_size, plan.halo.s_pad
    src_hi = plan.n_src_pad + (W * S if plan.halo_side == "src" else 0)
    dst_hi = plan.n_dst_pad + (W * S if plan.halo_side == "dst" else 0)
    src = plan.src_index.cpu().numpy()
    dst = plan.dst_index.cpu().numpy()
    mask = plan.edge_mask.cpu().numpy() > 0
    errors = []
    if src[mask].size and (src[mask].min() < 0 or src[mask].max() >= src_hi):
        errors.append(f"src_index out of [0,{src_hi})")
    if dst[mask].size and (dst[mask].min() < 0 or dst[mask].max() >= dst_hi):
        errors.append(f"dst_index out of [0,{dst_hi})")
    send_idx = plan.halo.send_idx.cpu().numpy()
    send_mask = plan.halo.send_mask.cpu().numpy() > 0
    n_halo_owner = plan.n_src_pad if plan.halo_side == "src" else plan.n_dst_pad
    if send_idx[send_mask].size and (
        send_idx[send_mask].min() < 0 or send_idx[send_mask].max() >= n_halo_owner
    ):
        errors.append(f"halo send_idx out of [0,{n_halo_owner})")
    for r in range(W):
        if send_mask[r, r].any():
            errors.append(f"rank {r} sends to itself")
    counts = plan.num_edges.cpu().numpy()
    if (counts > plan.e_pad).any():
        errors.append("num_edges exceeds e_pad")
    if plan.owner_sorted:
        own = dst if plan.halo_side == "src" else src
        if (np.diff(own, axis=1) < 0).any():
            errors.append("owner-side ids not monotone")
    if plan.halo_sort_perm is not None:
        perm = plan.halo_sort_perm.cpu().numpy()
        sids = plan.halo_sorted_ids.cpu().numpy()
        halo_idx = src if plan.halo_side == "src" else dst
        seen = np.empty(plan.e_pad, bool)
        for r in range(W):
            pr = perm[r]
            in_range = (pr >= 0) & (pr < plan.e_pad)
            seen[:] = False
            seen[pr[in_range]] = True
            if not (in_range.all() and seen.all()):
                errors.append(f"halo_sort_perm[{r}] is not a permutation")
                break
            if (np.diff(sids[r]) < 0).any():
                errors.append(f"halo_sorted_ids[{r}] not monotone")
                break
            if not np.array_equal(halo_idx[r][pr], sids[r]):
                errors.append(f"halo_sorted_ids[{r}] != halo_index[perm]")
                break
    if errors:
        raise ValueError("invalid EdgePlan: " + "; ".join(errors))


# ---------------------------------------------------------------------------
# Data layout helpers (numpy)
# ---------------------------------------------------------------------------


def shard_vertex_data(
    x: np.ndarray, counts: np.ndarray, n_pad: int
) -> np.ndarray:
    """[V, ...] global (contiguous-block numbered) -> [W, n_pad, ...] padded."""
    W = len(counts)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    out = np.zeros((W, n_pad) + x.shape[1:], dtype=x.dtype)
    for r in range(W):
        out[r, : counts[r]] = x[offsets[r] : offsets[r + 1]]
    return out


def shard_edge_data(
    vals: np.ndarray, layout: EdgePlanLayout, e_pad: int
) -> np.ndarray:
    """[E, ...] per-edge data (original edge order) -> [W, e_pad, ...] padded."""
    W = layout.src_counts.shape[0]
    out = np.zeros((W, e_pad) + vals.shape[1:], dtype=vals.dtype)
    out[layout.edge_rank, layout.edge_slot] = vals
    return out
