"""Host-side builder of the static-shape, padded edge plan.

Counterpart of ``dgraph_tpu/plan.py`` along its single-process numpy path
(``build_edge_plan`` -> ``_plan_build_prologue`` -> ``_numpy_plan_prep`` ->
``_finalize_plan``). The arrays are built with numpy exactly as the reference
builds them, so every plan leaf is array-equal to the reference's for the
same inputs; they are then held as torch tensors in an :class:`EdgePlan`
dataclass with ``.to(device)``.

The interior/boundary split (:class:`OverlapSpec`, ``build_edge_plan(
overlap=...)``) and the halo-lowering resolution (:func:`resolve_halo_impl`)
are ported with the reference's semantics, and so is the compiled halo
schedule (:func:`compile_plan_schedule`, ``EdgePlan.halo_schedule``) and
the wire-format attachment (:func:`plan_wire_format`,
``EdgePlan.wire_format``), and the sharded build and load behind the plan
cache (:func:`build_plan_shards`, :func:`build_edge_plan_sharded`,
:func:`load_sharded_plan`, :func:`assemble_plan`; the artifact's IO is
:mod:`dgraph_tpu_torch.plan_shards`). Shard payloads stay numpy arrays and
Python ints, as the reference's, so the two packages write the same bytes.
Not ported yet: the native streaming core (the reference only takes it from
``NATIVE_PLAN_MIN_EDGES`` edges on).

Conventions (as in the reference): edge lists are ``[2, E]``; vertices are
renumbered into contiguous per-rank blocks first; the default edge owner is
the dst rank; every plan array carries a leading ``[world_size]`` axis. On
a rank with ``n_pad`` padded local vertices and send pad ``s_pad``, the halo
copy of a vertex owned by rank p at position i of p's send list lives at row
``n_pad + p*s_pad + i`` of the ``[local ; halo]`` feature table.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
import types
from typing import Any, Optional

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

_logger = logging.getLogger(__name__)


def _tensor_fields(obj):
    return [
        f.name for f in dataclasses.fields(obj)
        if isinstance(getattr(obj, f.name), torch.Tensor)
    ]


def _map_tensors(obj, fn):
    """Copy of a plan dataclass with ``fn`` applied to every tensor leaf."""
    kw = {name: fn(getattr(obj, name)) for name in _tensor_fields(obj)}
    for name in ("halo", "overlap"):
        sub = getattr(obj, name, None)
        if isinstance(sub, (HaloSpec, OverlapSpec)):
            kw[name] = _map_tensors(sub, fn)
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
class OverlapSpec:
    """Interior/boundary edge split of the split halo lowerings (the
    reference's ``OverlapSpec``, ``dgraph_tpu/plan.py:287-342``).

    Per rank, the live edges split into **interior** edges (halo-side
    endpoint local) and **boundary** edges (halo-side endpoint remote); each
    subset keeps the plan's owner-sorted order, so owner-side sums over it
    stay sorted. Padded slots carry the owner-side fill ``n_owner_pad`` and,
    on the halo side, ``n_halo_pad`` (interior) or ``W*s_pad`` (boundary);
    a boundary edge's halo-side id is rebased into the ``[W*S, F]`` exchange
    buffer (``slot - n_halo_pad``). ``int_epos``/``bnd_epos`` place each
    subset edge on the plan's ``[0, e_pad)`` edge axis (fill ``e_pad``).
    """

    int_src: torch.Tensor  # i32[W, Ei]
    int_dst: torch.Tensor  # i32[W, Ei]
    int_mask: torch.Tensor  # f32[W, Ei]
    int_epos: torch.Tensor  # i32[W, Ei]
    bnd_src: torch.Tensor  # i32[W, Eb]
    bnd_dst: torch.Tensor  # i32[W, Eb]
    bnd_mask: torch.Tensor  # f32[W, Eb]
    bnd_epos: torch.Tensor  # i32[W, Eb]
    num_interior: torch.Tensor  # i32[W]
    num_boundary: torch.Tensor  # i32[W]
    e_int_pad: int
    e_bnd_pad: int
    # the reference's Pallas chunk hints per subset (plan parity only)
    interior_mc: int = 1
    boundary_mc: int = 1

    def side(self, which: str, side: str) -> torch.Tensor:
        """The ``side`` ('src'/'dst') ids of subset ``which``
        ('interior'/'boundary')."""
        if which == "interior":
            return self.int_src if side == "src" else self.int_dst
        return self.bnd_src if side == "src" else self.bnd_dst


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
    # the compiled halo schedule (sched.ir.HaloSchedule, frozen and
    # hashable) of halo_pair_rows, the full-world matrix: the same on every
    # rank, so .to() and .shard() carry it whole; None without traffic
    halo_schedule: Any = None
    # the wire format (wire.spec.WIRE_FORMATS) attached at build, the
    # build-time pass of the wire ladder (plan_wire_format); the resolution
    # at an exchange (comm.collectives.resolve_plan_wire_format) takes it as
    # its plan tier, so a later pin still wins. "fp32" without traffic
    wire_format: str = "fp32"
    # True on a per-rank view (leading rank axis dropped)
    per_rank: bool = False
    # the global ranks along the leading axis of a rank-subset plan
    # (load_sharded_plan(ranks=...)); None: every rank 0..world_size-1
    ranks: Optional[tuple] = None
    # the interior/boundary split (build_edge_plan(overlap=True)), or None
    overlap: Optional[OverlapSpec] = None

    def ids_sorted(self, side: str) -> bool:
        """True iff this side's per-edge index is monotone: the OWNER side
        of an owner-sorted plan. The halo side mixes local rows with halo
        slots and is never monotone."""
        return self.owner_sorted and side != self.halo_side

    def to(self, device) -> "EdgePlan":
        """Copy with every tensor leaf moved to ``device``."""
        return _map_tensors(self, lambda t: t.to(device))

    def shard(self, rank: int) -> "EdgePlan":
        """Per-rank view of global rank ``rank``: every leaf indexed at its
        row (the counterpart of the reference's ``squeeze_plan`` inside
        ``shard_map``); on a rank-subset plan, the row holding that rank."""
        if self.per_rank:
            raise ValueError("plan is already a per-rank view")
        row = rank
        if self.ranks is not None:
            if rank not in self.ranks:
                raise ValueError(f"rank {rank} is not in this plan's ranks {list(self.ranks)}")
            row = self.ranks.index(rank)
        view = _map_tensors(self, lambda t: t[row])
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
    pad_multiple: int, e_pad: Optional[int], s_pad: Optional[int],
    overlap: Optional[bool] = None, sort_edges: bool = True,
) -> None:
    """Fail fast, naming the knobs, on plan geometry that cannot be built
    (the reference's rules, ``dgraph_tpu/plan.py:999-1040``, with the
    pallas_p2p pin's preconditions)."""
    from dgraph_tpu_torch import config as _cfg

    if overlap and not sort_edges:
        raise ValueError(
            "overlap=True conflicts with sort_edges=False: the "
            "interior/boundary split's subset sums rely on owner-sorted edge "
            "order; drop one of the two knobs"
        )
    if _cfg.halo_impl == "pallas_p2p":
        if not sort_edges:
            raise ValueError(
                "halo_impl='pallas_p2p' conflicts with sort_edges=False: the "
                "one-sided lowering routes through the interior/boundary "
                "split, which relies on owner-sorted edge order; drop the pin "
                "or re-enable sort_edges"
            )
        if s_pad is not None and s_pad % 8:
            raise ValueError(
                f"halo_impl='pallas_p2p' conflicts with s_pad={s_pad}: the "
                f"per-delta [s_pad, F] tiles need 8-row alignment; pick "
                f"s_pad={_pad_to(s_pad, 8)} or drop the pin"
            )
        if pad_multiple % 8 and s_pad is None:
            raise ValueError(
                f"halo_impl='pallas_p2p' conflicts with pad_multiple="
                f"{pad_multiple}: s_pad inherits this multiple and the "
                f"per-delta tiles need 8-row alignment; use a multiple of 8 "
                f"or pass an aligned explicit s_pad"
            )
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
    overlap: Optional[bool] = None,
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
      overlap: attach the interior/boundary split (:class:`OverlapSpec`);
        None = when the halo-lowering pin asks for a split lowering
        (:func:`resolve_overlap_intent`).

    Returns (plan, layout); the plan's tensors live on the CPU.
    """
    pro = _plan_build_prologue(
        edge_index, src_partition, dst_partition, edge_owner=edge_owner,
        sort_edges=sort_edges, sort_route=sort_route, overlap=overlap,
        pad_multiple=pad_multiple, e_pad=e_pad, s_pad=s_pad,
        world_size=world_size,
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
        sort_route=pro.sort_route, overlap=pro.overlap,
    )


def _plan_build_prologue(
    edge_index, src_partition, dst_partition, *, edge_owner, sort_edges,
    sort_route, overlap, pad_multiple, e_pad, s_pad, world_size,
):
    """Validation and derived inputs: shapes, owner, knobs, the resolved
    overlap intent, per-rank counts/offsets, the contiguity check and the
    sort_route default."""
    edge_index = np.asarray(edge_index)
    if edge_index.ndim != 2 or edge_index.shape[0] != 2:
        raise ValueError(f"edge_index must be [2, E], got {edge_index.shape}")
    if overlap is None:
        overlap = resolve_overlap_intent()
    _reject_incompatible_knobs(pad_multiple, e_pad, s_pad, overlap, sort_edges)
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
        sort_route=sort_route, overlap=overlap,
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
        edge_rank=edge_rank, edge_slot=edge_slot, cross=cross,
        halo_counts=halo_counts, s_pad=S_pad,
        n_src_pad=N_src_pad, n_dst_pad=N_dst_pad, n_owner_pad=n_owner_pad,
        n_halo_pad=N_halo_pad,
        send_idx=send_idx, send_mask=send_mask,
        own_local=own_local, halo_side_local_idx=halo_side_local_idx,
        src_counts=src_counts, dst_counts=dst_counts,
        halo_deltas=tuple(int(d) for d in np.unique((needer - sender) % W)),
    )


def _finalize_plan(
    prep, *, src_idx_arr, dst_idx_arr, edge_mask, homogeneous, edge_owner,
    owner_sorted, sort_route, overlap=False,
) -> tuple[EdgePlan, EdgePlanLayout]:
    """Chunk hints, the halo sort route, the interior/boundary split, and
    the EdgePlan/EdgePlanLayout."""
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

    overlap_spec = None
    if overlap:
        overlap_spec = _build_overlap_spec(
            src_idx_arr, dst_idx_arr, edge_mask, prep.halo_side,
            prep.n_src_pad, prep.n_dst_pad, prep.s_pad, W, prep.e_pad,
            owner_sorted,
        )

    halo_pair_rows = tuple(tuple(int(v) for v in row) for row in prep.halo_counts)
    halo_schedule = compile_plan_schedule(
        halo_pair_rows, s_pad=prep.s_pad, world_size=W, halo_deltas=prep.halo_deltas)

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
        halo_pair_rows=halo_pair_rows,
        halo_schedule=halo_schedule,
        wire_format=plan_wire_format(W, prep.halo_deltas),
        overlap=overlap_spec,
    )
    layout = EdgePlanLayout(
        edge_rank=prep.edge_rank,
        edge_slot=prep.edge_slot,
        halo_counts=prep.halo_counts,
        src_counts=prep.src_counts,
        dst_counts=prep.dst_counts,
    )
    return plan, layout


def _overlap_rows_for_rank(
    src_row, dst_row, mask_row, *, halo_side, n_halo_pad, n_owner_pad,
    s_pad, W, e_pad, e_int_pad, e_bnd_pad, owner_sorted,
):
    """One rank's interior/boundary rows and chunk hints
    (``dgraph_tpu/plan.py:1499-1568``): interior halo-side fill
    ``n_halo_pad``, owner-side fill ``n_owner_pad``, ``epos`` fill
    ``e_pad``, boundary halo-side ids rebased into ``[0, W*s_pad)`` (padded
    slots ``W*s_pad``), and the subsets' live counts: a shard's payload
    holds these rows as they are."""
    halo_row = src_row if halo_side == "src" else dst_row
    live = mask_row > 0
    is_bnd = live & (halo_row >= n_halo_pad)
    is_int = live & ~is_bnd

    def subset(sel_mask, e_sub_pad):
        pos = np.nonzero(sel_mask)[0]
        k = len(pos)
        epos = np.full(e_sub_pad, e_pad, np.int32)
        s_arr = np.full(e_sub_pad, n_owner_pad if halo_side == "dst"
                        else n_halo_pad, np.int32)
        d_arr = np.full(e_sub_pad, n_owner_pad if halo_side == "src"
                        else n_halo_pad, np.int32)
        mask = np.zeros(e_sub_pad, np.float32)
        epos[:k] = pos
        s_arr[:k] = src_row[pos]
        d_arr[:k] = dst_row[pos]
        mask[:k] = 1.0
        return epos, s_arr, d_arr, mask

    int_epos, int_src, int_dst, int_mask = subset(is_int, e_int_pad)
    bnd_epos, bnd_src, bnd_dst, bnd_mask = subset(is_bnd, e_bnd_pad)
    bnd_halo = bnd_src if halo_side == "src" else bnd_dst
    rebased = np.where(bnd_mask > 0, bnd_halo - n_halo_pad, W * s_pad).astype(np.int32)
    if halo_side == "src":
        bnd_src = rebased
    else:
        bnd_dst = rebased
    interior_mc = boundary_mc = 1
    if owner_sorted:
        int_owner = int_dst if halo_side == "src" else int_src
        bnd_owner = bnd_dst if halo_side == "src" else bnd_src
        interior_mc = max_chunks_hint(int_owner, n_owner_pad, block_e=SCATTER_BLOCK_E,
                                      block_n=SCATTER_BLOCK_N)
        boundary_mc = max_chunks_hint(bnd_owner, n_owner_pad, block_e=SCATTER_BLOCK_E,
                                      block_n=SCATTER_BLOCK_N)
    rows = {
        "int_src": int_src, "int_dst": int_dst, "int_mask": int_mask,
        "int_epos": int_epos,
        "bnd_src": bnd_src, "bnd_dst": bnd_dst, "bnd_mask": bnd_mask,
        "bnd_epos": bnd_epos,
        "num_interior": int(is_int.sum()),
        "num_boundary": int(is_bnd.sum()),
    }
    return rows, interior_mc, boundary_mc


def _build_overlap_spec(
    src_idx_arr, dst_idx_arr, edge_mask, halo_side, n_src_pad, n_dst_pad,
    s_pad, W, e_pad, owner_sorted,
) -> OverlapSpec:
    """The interior/boundary split of the assembled padded index arrays
    (``dgraph_tpu/plan.py:1571-1621``); each subset pads by the plan's
    edge-pad rule."""
    halo_idx = src_idx_arr if halo_side == "src" else dst_idx_arr
    n_halo_pad = n_src_pad if halo_side == "src" else n_dst_pad
    n_owner_pad = n_dst_pad if halo_side == "src" else n_src_pad
    live = edge_mask > 0
    is_bnd = live & (halo_idx >= n_halo_pad)
    n_bnd = is_bnd.sum(axis=1).astype(np.int64)
    n_int = live.sum(axis=1).astype(np.int64) - n_bnd
    int_max = int(n_int.max(initial=1))
    bnd_max = int(n_bnd.max(initial=1))
    e_int_pad = _pad_to(int_max, _edge_pad_align(int_max, 8))
    e_bnd_pad = _pad_to(bnd_max, _edge_pad_align(bnd_max, 8))
    per_rank = [
        _overlap_rows_for_rank(
            src_idx_arr[r], dst_idx_arr[r], edge_mask[r], halo_side=halo_side,
            n_halo_pad=n_halo_pad, n_owner_pad=n_owner_pad, s_pad=s_pad, W=W,
            e_pad=e_pad, e_int_pad=e_int_pad, e_bnd_pad=e_bnd_pad,
            owner_sorted=owner_sorted,
        )
        for r in range(W)
    ]

    def stack(key):
        return torch.from_numpy(np.stack([p[0][key] for p in per_rank]))

    return OverlapSpec(
        **{k: stack(k) for k, v in per_rank[0][0].items() if isinstance(v, np.ndarray)},
        num_interior=torch.from_numpy(n_int.astype(np.int32)),
        num_boundary=torch.from_numpy(n_bnd.astype(np.int32)),
        e_int_pad=e_int_pad, e_bnd_pad=e_bnd_pad,
        interior_mc=max(p[1] for p in per_rank),
        boundary_mc=max(p[2] for p in per_rank),
    )


# ---------------------------------------------------------------------------
# Halo-lowering resolution (dgraph_tpu/plan.py:552-799)
# ---------------------------------------------------------------------------


def compile_plan_schedule(pair_rows: tuple, *, s_pad: int, world_size: int,
                          halo_deltas: tuple):
    """The plan's compiled halo schedule (``dgraph_tpu/plan.py:589-612``):
    :func:`~dgraph_tpu_torch.sched.passes.compile_halo_schedule` of the
    full-world ``[W][W]`` traffic matrix at the reference's default split
    threshold, so every rank holds the same round order and the reference's
    ``schedule_id``. None without live deltas or without traffic."""
    if not halo_deltas or not pair_rows:
        return None
    if not any(v for row in pair_rows for v in row):
        return None
    from dgraph_tpu_torch.sched.passes import compile_halo_schedule

    return compile_halo_schedule(pair_rows, s_pad=int(s_pad), world_size=int(world_size))


def plan_wire_format(world_size: int, halo_deltas: tuple) -> str:
    """The one attach rule for a plan's wire format
    (``dgraph_tpu/plan.py:614-635``): the build-time pass of the wire
    ladder without a plan tier (the plan is being built): pin > adopted
    record > the fp32 identity. The exchange re-resolves with this value as
    the plan tier (``comm.collectives.resolve_plan_wire_format``)."""
    if not halo_deltas:
        return "fp32"
    from dgraph_tpu_torch.wire.spec import resolve_wire_format

    name, _source = resolve_wire_format(int(world_size), tuple(halo_deltas),
                                        plan_format="fp32")
    return name


def pick_halo_impl(halo_deltas: tuple) -> str:
    """The heuristic lowering from the plan's live peer set: one padded
    ``all_to_all``, ``none`` with no traffic. The reference picks
    ``ppermute`` rounds for a sparse peer set (``plan.py:586``), a TPU cost
    model; the port keeps ``all_to_all`` there, which beat ``ppermute`` on
    four H100s over NCCL (PERF.md §5). A pin runs ``ppermute``."""
    return "all_to_all" if halo_deltas else "none"


def resolve_halo_impl(
    halo_deltas: tuple, *, overlap_available: bool = False,
    p2p_available: "bool | None" = None, sched_available: bool = False,
) -> tuple[str, str]:
    """``(impl, source)``: the lowering a run executes and who decided it —
    ``env`` (``config.halo_impl``), ``heuristic`` (the split lowering
    'overlap' when the plan carries the split, else :func:`pick_halo_impl`)
    or ``plan`` (no traffic). A pin that cannot lower ('overlap' without the
    split, 'sched' without a schedule, 'pallas_p2p' without the split or
    :func:`config.pallas_p2p_available`) warns once and the heuristic
    decides; the heuristic never picks 'pallas_p2p' or 'sched'.
    ``p2p_available`` overrides the availability probe. The reference's
    adopted-record tier between the two has no counterpart (no tuner)."""
    from dgraph_tpu_torch import config as _cfg

    if not halo_deltas:
        return "none", "plan"

    def _p2p_ok() -> bool:
        if not overlap_available:
            return False
        if p2p_available is not None:
            return p2p_available
        return _cfg.pallas_p2p_available()

    legal = ("all_to_all", "ppermute") + (
        ("overlap",) if overlap_available else ()
    ) + (("sched",) if sched_available else ())
    impl = _cfg.halo_impl
    if impl in legal:
        return impl, "env"
    heuristic = "overlap" if overlap_available else pick_halo_impl(halo_deltas)
    if impl == "overlap":
        _warn_unavailable("'overlap'", "the plan carries no interior/boundary split "
                          "(built without overlap=True)", heuristic)
    if impl == "sched":
        _warn_unavailable("'sched'", "the plan carries no compiled halo schedule", heuristic)
    if impl == "pallas_p2p":
        if _p2p_ok():
            return impl, "env"
        _warn_unavailable(
            "'pallas_p2p'",
            "the plan carries no interior/boundary split (built without "
            "overlap=True)" if not overlap_available else
            "the rank's device is not CUDA (set DGRAPH_TPU_PALLAS_P2P=1 to "
            "run the transport's plain version on the CPU)", heuristic)
    return heuristic, "heuristic"


def resolve_overlap_intent() -> bool:
    """Whether a plan built now with ``overlap=None`` attaches the split:
    the env pin asks for 'overlap' or 'pallas_p2p'."""
    from dgraph_tpu_torch import config as _cfg

    return _cfg.halo_impl in ("overlap", "pallas_p2p")


_warned: set = set()


def _warn_unavailable(impl: str, why: str, fallback: str) -> None:
    """The one-time warning of a pin that cannot lower, naming the lowering
    the heuristic resolves to instead."""
    key = (impl, why, fallback)
    if key in _warned:
        return
    _warned.add(key)
    _logger.warning("halo_impl=%s pinned by DGRAPH_TPU_HALO_IMPL but %s; the heuristic "
                    "decides the lowering instead: %r", impl, why, fallback)


def _masked_owner_ids_in_range(plan: EdgePlan) -> bool:
    """True when a masked edge of an owner-sorted plan carries an in-range
    owner-side id (a stacked plan or a per-rank view; read on the host)."""
    if not plan.owner_sorted:
        return False
    halo_src = plan.halo_side == "src"
    own = (plan.dst_index if halo_src else plan.src_index).cpu().numpy()
    n_own = plan.n_dst_pad if halo_src else plan.n_src_pad
    return bool((own[plan.edge_mask.cpu().numpy() <= 0] < n_own).any())


def check_owner_padding(plan: EdgePlan) -> None:
    """Raise ValueError unless every masked edge of an owner-sorted plan
    carries an out-of-range owner-side id (``n_owner_pad``): the sorted
    kernels then drop it, and the owner-side take reads a zero row for it,
    with the ids as they are and still sorted."""
    if _masked_owner_ids_in_range(plan):
        raise ValueError("invalid EdgePlan: masked edges carry in-range owner-side "
                         "ids; the sorted owner-side take would read them")


def validate_plan(plan: EdgePlan) -> None:
    """Host-side structural validation of a stacked plan (a rank-subset plan
    too): index bounds, send lists, edge counts and the halo sort route.
    Raises ValueError."""
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
    rows = plan.ranks if plan.ranks is not None else range(W)
    for i, r in enumerate(rows):
        if send_mask[i, r].any():
            errors.append(f"rank {r} sends to itself")
    counts = plan.num_edges.cpu().numpy()
    if (counts > plan.e_pad).any():
        errors.append("num_edges exceeds e_pad")
    if plan.owner_sorted:
        own = dst if plan.halo_side == "src" else src
        if (np.diff(own, axis=1) < 0).any():
            errors.append("owner-side ids not monotone")
        if _masked_owner_ids_in_range(plan):
            errors.append("masked edges carry in-range owner-side ids")
    if plan.overlap is not None:
        errors += _overlap_errors(plan, counts)
    if plan.halo_sort_perm is not None:
        perm = plan.halo_sort_perm.cpu().numpy()
        sids = plan.halo_sorted_ids.cpu().numpy()
        halo_idx = src if plan.halo_side == "src" else dst
        seen = np.empty(plan.e_pad, bool)
        for r in range(perm.shape[0]):
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


def _overlap_errors(plan: EdgePlan, num_edges: np.ndarray) -> list:
    """The split's invariants (``dgraph_tpu/plan.py:898-943``): the subsets
    tile the live edges, interior halo-side ids are local, boundary slots
    lie in the halo buffer, owner ids stay monotone per subset."""
    ov, W, S = plan.overlap, plan.world_size, plan.halo.s_pad
    n_halo_pad = plan.n_src_pad if plan.halo_side == "src" else plan.n_dst_pad
    owner = "dst" if plan.halo_side == "src" else "src"
    im = ov.int_mask.cpu().numpy() > 0
    bm = ov.bnd_mask.cpu().numpy() > 0
    errors = []
    if not np.array_equal(im.sum(1) + bm.sum(1), num_edges):
        errors.append("overlap split does not tile the live edge set")
    int_halo = ov.side("interior", plan.halo_side).cpu().numpy()[im]
    if int_halo.size and int_halo.max() >= n_halo_pad:
        errors.append("overlap interior halo-side id not local")
    bnd_halo = ov.side("boundary", plan.halo_side).cpu().numpy()[bm]
    if bnd_halo.size and (bnd_halo.min() < 0 or bnd_halo.max() >= W * S):
        errors.append(f"overlap boundary slot out of [0,{W * S})")
    for which in ("interior", "boundary"):
        if plan.owner_sorted and (np.diff(ov.side(which, owner).cpu().numpy(), axis=1) < 0).any():
            errors.append(f"overlap {which} owner ids not monotone")
    return errors


# ---------------------------------------------------------------------------
# Sharded plan builds and loads (dgraph_tpu/plan.py:1691-2187)
# ---------------------------------------------------------------------------


def _shard_statics(prep, *, homogeneous, edge_owner, sort_edges, sort_route, overlap) -> dict:
    """The manifest's JSON-able statics of a sharded plan: everything
    :func:`assemble_plan` needs besides the per-rank payloads. The per-rank
    chunk hints are maxed in at finalize time (:func:`build_plan_shards`)."""
    st = {
        "world_size": int(prep.W),
        "n_src_pad": int(prep.n_src_pad),
        "n_dst_pad": int(prep.n_dst_pad),
        "e_pad": int(prep.e_pad),
        "s_pad": int(prep.s_pad),
        "halo_side": prep.halo_side,
        "homogeneous": bool(homogeneous),
        "edge_owner": edge_owner,
        "owner_sorted": bool(sort_edges),
        "sort_route": bool(sort_route),
        "overlap": bool(overlap),
        "scatter_block_e": SCATTER_BLOCK_E,
        "scatter_block_n": SCATTER_BLOCK_N,
        "halo_deltas": [int(d) for d in prep.halo_deltas],
        # the full-world traffic matrix: a rank-subset load keeps the whole
        # world's statics, so every process compiles the same halo schedule
        "halo_pair_rows": [[int(v) for v in row] for row in np.asarray(prep.halo_counts)],
        # the build-time wire format (the monolithic build's one attach
        # rule), stamped so a cache round trip keeps it
        "wire_format": plan_wire_format(prep.W, tuple(prep.halo_deltas)),
    }
    if overlap:
        # the subset pads are maxima over ranks, computable from the
        # skeleton alone (boundary == cross edges), so every shard pads its
        # subsets alike whether built in one run or resumed
        n_bnd = np.bincount(prep.edge_rank[prep.cross], minlength=prep.W).astype(np.int64)
        n_int = prep.e_counts - n_bnd
        int_max = int(n_int.max(initial=1))
        bnd_max = int(n_bnd.max(initial=1))
        st["e_int_pad"] = _pad_to(int_max, _edge_pad_align(int_max, 8))
        st["e_bnd_pad"] = _pad_to(bnd_max, _edge_pad_align(bnd_max, 8))
    return st


def shard_nbytes_estimate(statics: dict) -> int:
    """Upper bound of one rank's shard payload bytes from the manifest
    statics alone: the upfront memory-budget check's number (an over-budget
    build fails before assembling anything)."""
    e_pad, W, s_pad = statics["e_pad"], statics["world_size"], statics["s_pad"]
    n = e_pad * (4 + 4 + 4)  # src/dst ids and the mask
    if statics.get("sort_route"):
        n += 2 * e_pad * 4  # halo_sort_perm and halo_sorted_ids
    if statics.get("overlap"):
        n += (statics["e_int_pad"] + statics["e_bnd_pad"]) * 4 * 4
    n += 2 * W * s_pad * 4  # send_idx and send_mask rows
    return n


def _assemble_shard_payload(prep, r: int, *, sort_edges: bool, sort_route: bool,
                            overlap: bool, overlap_pads: tuple = (None, None)):
    """One rank's plan arrays (numpy) and chunk hints from the shared numpy
    skeleton: row for row what the monolithic build's ``[W, e_pad]`` stack
    holds at index ``r``."""
    W, E_pad = prep.W, prep.e_pad
    sel = prep.edge_rank == r
    slots = prep.edge_slot[sel]
    halo_row = np.zeros(E_pad, np.int32)
    halo_row[slots] = prep.halo_side_local_idx[sel].astype(np.int32)
    own_row = np.full(E_pad, prep.n_owner_pad, np.int32)
    own_row[slots] = prep.own_local[sel].astype(np.int32)
    mask_row = np.zeros(E_pad, np.float32)
    mask_row[slots] = 1.0
    if prep.halo_side == "src":
        src_row, dst_row = halo_row, own_row
    else:
        src_row, dst_row = own_row, halo_row

    hints = {"scatter_mc": 1, "gather_mv": 0, "halo_sort_mc": 1,
             "interior_mc": 1, "boundary_mc": 1}
    if sort_edges:
        hints["scatter_mc"] = max_chunks_hint(own_row, prep.n_owner_pad,
                                              block_e=SCATTER_BLOCK_E, block_n=SCATTER_BLOCK_N)
        hints["gather_mv"] = max_vblocks_hint(own_row, prep.n_owner_pad,
                                              block_e=SCATTER_BLOCK_E, block_n=SCATTER_BLOCK_N)

    perm = sorted_ids = None
    if sort_route:
        n_halo_rows = prep.n_halo_pad + W * prep.s_pad
        perm = np.argsort(halo_row, kind="stable").astype(np.int32)
        sorted_ids = halo_row[perm]
        hints["halo_sort_mc"] = max_chunks_hint(sorted_ids, n_halo_rows,
                                                block_e=SCATTER_BLOCK_E, block_n=SCATTER_BLOCK_N)

    payload = {
        "src_index": src_row,
        "dst_index": dst_row,
        "edge_mask": mask_row,
        "num_local_src": int(prep.src_counts[r]),
        "num_local_dst": int(prep.dst_counts[r]),
        "num_edges": int(prep.e_counts[r]),
        "send_idx": prep.send_idx[r],
        "send_mask": prep.send_mask[r],
        "halo_sort_perm": perm,
        "halo_sorted_ids": sorted_ids,
        "overlap": None,
    }
    if overlap:
        payload["overlap"], ov_hints = _assemble_overlap_rows(
            prep, src_row, dst_row, mask_row, sort_edges,
            e_int_pad=overlap_pads[0], e_bnd_pad=overlap_pads[1])
        hints.update(ov_hints)
    return payload, hints


def _assemble_overlap_rows(prep, src_row, dst_row, mask_row, sort_edges: bool, *,
                           e_int_pad: int, e_bnd_pad: int):
    """One shard's interior/boundary rows: :func:`_overlap_rows_for_rank`,
    the core the monolithic :func:`_build_overlap_spec` stacks, at the
    subset pads the manifest statics record."""
    rows, interior_mc, boundary_mc = _overlap_rows_for_rank(
        src_row, dst_row, mask_row, halo_side=prep.halo_side, n_halo_pad=prep.n_halo_pad,
        n_owner_pad=prep.n_owner_pad, s_pad=prep.s_pad, W=prep.W, e_pad=prep.e_pad,
        e_int_pad=e_int_pad, e_bnd_pad=e_bnd_pad, owner_sorted=sort_edges)
    return rows, {"interior_mc": interior_mc, "boundary_mc": boundary_mc}


def _content_fingerprint(edge_index, src_partition, dst_partition) -> str:
    """Streaming SHA-256 of the build inputs (dtype, shape, bytes), read in
    64 MiB windows: the default fingerprint of a sharded build, so a resumed
    manifest never adopts shards built from other edges with the same
    statics."""
    h = hashlib.sha256()
    for arr in (edge_index, src_partition, dst_partition):
        if arr is None:
            h.update(b"|none")
            continue
        a = np.asarray(arr)
        h.update(f"|{a.dtype.str}{a.shape}".encode())
        if not a.flags.c_contiguous:
            a = np.ascontiguousarray(a)
        flat = a.reshape(-1)
        step = max(1, (1 << 26) // max(a.itemsize, 1))
        for i in range(0, flat.size, step):
            h.update(flat[i:i + step].data)
    return "content:" + h.hexdigest()[:24]


def build_plan_shards(
    edge_index: np.ndarray,
    src_partition: np.ndarray,
    dst_partition: Optional[np.ndarray] = None,
    *,
    out_dir: str,
    world_size: int,
    memory_budget_bytes: Optional[int] = None,
    resume: bool = True,
    rebuild_ranks: tuple = (),
    write_layout: bool = True,
    fingerprint: str = "",
    edge_owner: str = "dst",
    n_src_pad: Optional[int] = None,
    n_dst_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    s_pad: Optional[int] = None,
    pad_multiple: int = 8,
    sort_edges: bool = True,
    sort_route: Optional[bool] = None,
    overlap: Optional[bool] = None,
    use_native: Optional[bool] = None,
) -> dict:
    """The sharded build: assemble one rank's shard at a time and write it
    durably under ``out_dir`` (``shard_XXXX.pkl``, a checksummed
    ``manifest.json`` and, unless ``write_layout=False``, ``layout.pkl``;
    :mod:`dgraph_tpu_torch.plan_shards`). Returns the final manifest, not
    a plan: :func:`build_edge_plan_sharded` or :func:`load_sharded_plan`
    assemble one.

    The memory beyond the O(E) skeleton is one shard's arrays, held to
    ``memory_budget_bytes`` (else ``$DGRAPH_PLAN_MEMORY_BUDGET_MB``): over
    it, :class:`~dgraph_tpu_torch.plan_shards.PlanBuildMemoryExceeded` is
    raised, before any shard when the upfront estimate is over. A killed
    build resumes past the shards the manifest holds (same fingerprint,
    format and statics, checksums intact), bit-identical to an
    uninterrupted one; ``rebuild_ranks`` rebuilds named shards even when
    the manifest holds them (the loaders' one-shard repair).

    ``use_native=True`` raises: the native core fills the whole
    ``[W, e_pad]`` stack at once, the allocation this build avoids.
    ``fingerprint`` defaults to a content hash of the inputs
    (:func:`_content_fingerprint`); pass one only when it is content-derived.
    """
    from dgraph_tpu_torch import plan_shards as ps

    if use_native:
        raise ValueError(
            "build_plan_shards streams through the numpy per-rank core; use_native=True "
            "would materialize the full [W, E_pad] stack this mode exists to avoid")
    if not fingerprint:
        fingerprint = _content_fingerprint(edge_index, src_partition, dst_partition)
    pro = _plan_build_prologue(
        edge_index, src_partition, dst_partition, edge_owner=edge_owner,
        sort_edges=sort_edges, sort_route=sort_route, overlap=overlap,
        pad_multiple=pad_multiple, e_pad=e_pad, s_pad=s_pad, world_size=world_size,
    )
    W = world_size
    sort_route, overlap = pro.sort_route, pro.overlap
    prep = _numpy_plan_prep(
        pro.src, pro.dst, pro.src_partition, pro.dst_partition,
        pro.src_offsets, pro.dst_offsets, pro.src_counts, pro.dst_counts,
        W, edge_owner, sort_edges, n_src_pad, n_dst_pad, e_pad, s_pad, pad_multiple,
    )
    statics = _shard_statics(prep, homogeneous=pro.homogeneous, edge_owner=edge_owner,
                             sort_edges=sort_edges, sort_route=sort_route, overlap=overlap)
    writer = ps.PlanShardWriter(
        out_dir, fingerprint=fingerprint, world_size=W, statics=statics,
        build_kwargs={"edge_owner": edge_owner, "pad_multiple": pad_multiple,
                      "sort_edges": sort_edges, "sort_route": bool(sort_route),
                      "overlap": bool(overlap), "num_edges": pro.E},
        memory_budget_bytes=memory_budget_bytes, resume=resume, rebuild_ranks=rebuild_ranks,
    )
    # fail before assembling anything when even one shard cannot fit
    writer.check_budget(shard_nbytes_estimate(statics))
    built = 0
    for r in range(W):
        if writer.done(r):
            continue
        # the reference's ``plan.build_shard`` chaos point fires here
        # (index r; slice 12's chaos/)
        payload, hints = _assemble_shard_payload(
            prep, r, sort_edges=sort_edges, sort_route=sort_route, overlap=overlap,
            overlap_pads=(statics.get("e_int_pad"), statics.get("e_bnd_pad")))
        writer.write(r, payload, hints=hints)
        built += 1
    # plan-level hints are maxima over the per-shard values the manifest
    # recorded: the same whether built in one pass or across resumes
    entries = writer.manifest["shards"]
    hints_max = {
        name: max(int(entries[str(r)].get("hints", {}).get(name, 0)) for r in range(W))
        for name in ("scatter_mc", "gather_mv", "halo_sort_mc", "interior_mc", "boundary_mc")
    }
    # the layout sidecar is O(E): callers that never read it (a per-process
    # shard load) opt out with write_layout=False
    layout_payload = None
    if write_layout:
        layout_payload = {"edge_rank": prep.edge_rank, "edge_slot": prep.edge_slot,
                          "halo_counts": prep.halo_counts, "src_counts": pro.src_counts,
                          "dst_counts": pro.dst_counts}
    manifest = writer.finalize(layout_payload, statics_update=hints_max)
    _logger.info("sharded EdgePlan built in %s: W=%d E=%d e_pad=%d s_pad=%d "
                 "(%d shard(s) assembled this run, %d resumed)",
                 out_dir, W, pro.E, prep.e_pad, prep.s_pad, built, W - built)
    return manifest


def build_edge_plan_sharded(
    edge_index: np.ndarray,
    src_partition: np.ndarray,
    dst_partition: Optional[np.ndarray] = None,
    *,
    out_dir: str,
    ranks: Optional[list] = None,
    load_layout: Optional[bool] = None,
    **build_kwargs: Any,
) -> tuple:
    """:func:`build_plan_shards` then :func:`load_sharded_plan`: the sharded
    :func:`build_edge_plan`, returning ``(plan, layout)`` (every
    :func:`build_plan_shards` keyword is taken).

    ``ranks=None`` assembles every rank, equal to the monolithic build leaf
    for leaf. A subset gives a plan whose leading axis is ``len(ranks)``
    (``EdgePlan.ranks``) while every static, ``world_size`` too, describes
    the full world. ``load_layout=None`` loads the O(E) layout sidecar only
    for a full-world load.
    """
    build_plan_shards(edge_index, src_partition, dst_partition, out_dir=out_dir,
                      **build_kwargs)
    if load_layout is None:
        load_layout = ranks is None and build_kwargs.get("write_layout", True)
    # verify=False: every shard was written by this process moments ago or
    # checksum-verified when the writer adopted it on resume
    return load_sharded_plan(out_dir, ranks=ranks, load_layout=load_layout, verify=False)


def assemble_plan(manifest: dict, payloads: dict, ranks: list) -> EdgePlan:
    """Stack per-rank shard payloads (in ``ranks`` order) into an
    :class:`EdgePlan` (torch tensors on the CPU) under the manifest's
    statics, with the halo schedule compiled from its ``halo_pair_rows``
    and its stamped ``wire_format``. ``ranks == range(W)`` gives the
    monolithic build's plan; a subset the partial stack a process of a few
    ranks holds (``EdgePlan.ranks`` names them)."""
    st = manifest["statics"]
    W = int(st["world_size"])
    t = torch.from_numpy

    def stack(key):
        return t(np.stack([payloads[r][key] for r in ranks]))

    def counts(key):
        return t(np.asarray([payloads[r][key] for r in ranks], np.int32))

    sort_route = st.get("sort_route", False)
    pair_rows = tuple(tuple(int(v) for v in row) for row in st.get("halo_pair_rows", []))
    deltas = tuple(int(d) for d in st["halo_deltas"])
    overlap_spec = None
    if st.get("overlap"):
        def ostack(key):
            return t(np.stack([payloads[r]["overlap"][key] for r in ranks]))

        overlap_spec = OverlapSpec(
            int_src=ostack("int_src"), int_dst=ostack("int_dst"),
            int_mask=ostack("int_mask"), int_epos=ostack("int_epos"),
            bnd_src=ostack("bnd_src"), bnd_dst=ostack("bnd_dst"),
            bnd_mask=ostack("bnd_mask"), bnd_epos=ostack("bnd_epos"),
            num_interior=t(np.asarray([payloads[r]["overlap"]["num_interior"] for r in ranks],
                                      np.int32)),
            num_boundary=t(np.asarray([payloads[r]["overlap"]["num_boundary"] for r in ranks],
                                      np.int32)),
            e_int_pad=int(st["e_int_pad"]), e_bnd_pad=int(st["e_bnd_pad"]),
            interior_mc=int(st.get("interior_mc", 1)),
            boundary_mc=int(st.get("boundary_mc", 1)),
        )
    return EdgePlan(
        src_index=stack("src_index"),
        dst_index=stack("dst_index"),
        edge_mask=stack("edge_mask"),
        num_local_src=counts("num_local_src"),
        num_local_dst=counts("num_local_dst"),
        num_edges=counts("num_edges"),
        halo=HaloSpec(send_idx=stack("send_idx"), send_mask=stack("send_mask"),
                      s_pad=int(st["s_pad"])),
        world_size=W,
        n_src_pad=int(st["n_src_pad"]),
        n_dst_pad=int(st["n_dst_pad"]),
        e_pad=int(st["e_pad"]),
        halo_side=st["halo_side"],
        homogeneous=bool(st["homogeneous"]),
        owner_sorted=bool(st["owner_sorted"]),
        scatter_mc=int(st.get("scatter_mc", 1)),
        scatter_block_e=int(st["scatter_block_e"]),
        scatter_block_n=int(st["scatter_block_n"]),
        halo_deltas=deltas,
        halo_sort_perm=stack("halo_sort_perm") if sort_route else None,
        halo_sorted_ids=stack("halo_sorted_ids") if sort_route else None,
        halo_sort_mc=int(st.get("halo_sort_mc", 1)),
        gather_mv=int(st.get("gather_mv", 0)),
        halo_pair_rows=pair_rows,
        halo_schedule=compile_plan_schedule(pair_rows, s_pad=int(st["s_pad"]), world_size=W,
                                            halo_deltas=deltas),
        # a manifest without the key (none of format 10 lacks it) re-resolves
        # through the one attach rule
        wire_format=st.get("wire_format") or plan_wire_format(W, deltas),
        ranks=None if list(ranks) == list(range(W)) else tuple(int(r) for r in ranks),
        overlap=overlap_spec,
    )


def load_sharded_plan(plan_dir: str, *, ranks: Optional[list] = None, verify: bool = True,
                      load_layout: bool = True) -> tuple:
    """``(plan, layout)`` from a sharded-plan directory, reading only the
    requested ranks' shards (size and SHA-256 checked with ``verify``).
    Raises :class:`~dgraph_tpu_torch.plan_shards.PlanManifestError` or
    :class:`~dgraph_tpu_torch.plan_shards.PlanShardError`: a caller that
    can rebuild (``train.checkpoint.cached_edge_plan``) repairs the named
    shard, one that cannot surfaces the error. ``load_layout=False`` gives
    ``layout=None`` (the sidecar is O(E))."""
    from dgraph_tpu_torch import plan_shards as ps

    manifest = ps.read_manifest(plan_dir)
    if not manifest.get("complete"):
        raise ps.PlanManifestError(
            ps.manifest_path(plan_dir),
            "build incomplete (resume it with build_edge_plan_sharded)")
    W = manifest["world_size"]
    rank_list = list(range(W)) if ranks is None else [int(r) for r in ranks]
    payloads = {r: ps.read_shard(plan_dir, r, manifest["shards"][str(r)], verify=verify)
                for r in rank_list}
    plan = assemble_plan(manifest, payloads, rank_list)
    layout = None
    if load_layout:
        lp = ps.read_layout(plan_dir, manifest, verify=verify)
        layout = EdgePlanLayout(edge_rank=lp["edge_rank"], edge_slot=lp["edge_slot"],
                                halo_counts=lp["halo_counts"], src_counts=lp["src_counts"],
                                dst_counts=lp["dst_counts"])
    return plan, layout


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
