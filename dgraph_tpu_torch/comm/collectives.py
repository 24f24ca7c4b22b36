"""Graph primitives of one rank — counterpart of
``dgraph_tpu/comm/collectives.py``.

Every function takes the PER-RANK plan (:meth:`EdgePlan.shard`) and, where
ranks talk, a ``group`` (:class:`~dgraph_tpu_torch.comm.dist.RankGroup`)
in the place of the reference's ``axis_name``: ``None`` is world size 1,
where the halo exchange only reads the (all-masked) send lists, as the
reference's ``axis_name=None`` path does.

Across ranks the halo exchange has five lowerings, each a pair of
directions (the exchange and its transpose, the reverse delivery plus the
sum into the owners' rows) run by one :class:`_Lowering` and wrapped as two
``autograd.Function``\\ s whose backwards are each other, as the reference
pins its custom VJPs (``collectives.py:266-466``):

- ``all_to_all``: one padded ``all_to_all`` of the ``[W, S, F]`` send stack;
- ``ppermute``: per live delta d the masked ``[S, F]`` block to
  ``(me + d) % W`` and the block from ``(me - d) % W`` landed at its rows,
  every delta posted in one ``batch_isend_irecv``; the reverse adds one
  masked segment sum a delta into the owners' rows: in delta order in
  ``halo_scatter_sum``, as the reference's does (``collectives.py:861-883``),
  and in reverse delta order in the exchange's backward, as JAX's transpose
  of the reference's exchange accumulates x's cotangent;
- ``overlap``: the same rounds, every block gathered before any is posted;
  the reverse parks the returned blocks in one ``[W, S, F]`` buffer and
  reduces it as ``all_to_all`` does. Over the interior/boundary split the
  rounds stay in flight (:class:`PendingHalo`) while the interior subset's
  sums are queued, and the boundary take waits for them: on NCCL nothing
  orders those sums after the receives. On a gloo group nothing overlaps
  (the waits block the host);
- ``pallas_p2p``: kernel 5 (:func:`~dgraph_tpu_torch.ops.p2p.p2p_transport`),
  one-sided puts into the peers' halo buffers;
- ``sched``: the plan's compiled halo schedule (``plan.halo_schedule``,
  :mod:`dgraph_tpu_torch.sched`) replayed round by round
  (``collectives.py:515-610``): in round k a rank ships rows ``[start,
  start + C_k)`` of its masked block to its round peer, every round posted
  in one ``batch_isend_irecv`` in round order, and each received block is
  copied to its rows in round order; the reverse sends each landed window
  back and reduces as ``all_to_all`` does. A rank idle in a round posts
  nothing in it. Not a split lowering.

Every lowering carries the call site's wire format (:mod:`dgraph_tpu_torch.wire`,
resolved once by :func:`resolve_plan_wire_format`) into both directions, at
the reference's encode points (``collectives.py:200-610``, ``:779-902``):
each send block is encoded before it leaves (the exchange's blocks after the
mask, a cotangent's unmasked, the mask applying after decode), each
received block lands in a buffer of the wire operand's shape and is decoded
after the wait, before it is placed (``sched`` encodes after its row slice;
``pallas_p2p`` moves the encoded tiles with ``mask=None``). The fp32
identity calls no codec and leaves every lowering as it is.

``overlap`` and ``pallas_p2p`` are the split lowerings (:data:`SPLIT_IMPLS`,
:func:`split_active`, :func:`halo_exchange_split`). Every lowering lands
the rows ``all_to_all`` lands with the same bits; the blocks no round
reaches (the rank's own, those of dead deltas, and under ``sched`` the
rows outside every round's window) are +0.0 where ``all_to_all`` delivers
``x * 0``. Every reverse leg but ``ppermute``'s reduces with one masked
segment sum over the same ``[W, S, F]`` buffer, so it is bit-equal to
``all_to_all``'s. On a gloo group with CUDA tensors (ranks sharing a card)
the two-sided lowerings copy their payloads to the host and back. A
lowering that cannot run raises; none gives way to another.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable

from dgraph_tpu_torch import config as _cfg
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.plan import EdgePlan, HaloSpec, resolve_halo_impl

# the lowerings that route through the interior/boundary split
SPLIT_IMPLS = ("overlap", "pallas_p2p")


def _side_index(plan: EdgePlan, side: str) -> torch.Tensor:
    return plan.src_index if side == "src" else plan.dst_index


def _side_npad(plan: EdgePlan, side: str) -> int:
    return plan.n_src_pad if side == "src" else plan.n_dst_pad


def resolve_plan_impl(plan: EdgePlan, group) -> str:
    """The halo lowering of this call site, resolved once (env pin >
    heuristic; :func:`plan.resolve_halo_impl`) and passed to every leg. A
    pin that cannot lower here ('sched' on a plan without a compiled
    schedule, 'overlap' without the split) warns and the heuristic decides,
    as in the reference."""
    if group is None:
        return "none"
    impl, _ = resolve_halo_impl(
        plan.halo_deltas,
        overlap_available=plan.overlap is not None,
        p2p_available=_cfg.pallas_p2p_available(group.device),
        sched_available=plan.halo_schedule is not None,
    )
    return impl


def resolve_plan_wire_format(plan: EdgePlan, group) -> str:
    """The wire format of this call site, resolved once (pin > adopted
    record > the plan's build-time attachment > fp32;
    :func:`dgraph_tpu_torch.wire.spec.resolve_wire_format`) and carried by
    the lowering into both directions, so an exchange and its transpose
    never use two codecs (``collectives.py:65-82``). 'fp32' at world size
    1."""
    if group is None:
        return "fp32"
    from dgraph_tpu_torch.wire.spec import resolve_wire_format

    name, _source = resolve_wire_format(plan.world_size, tuple(plan.halo_deltas),
                                        plan_format=plan.wire_format)
    return name


def _wire_fns(wire_format, dtype) -> tuple:
    """The raw ``(encode, decode)`` of the format at this activation
    dtype; ``(None, None)`` (the fp32 identity, bf16 on bf16) keeps the
    path without a codec."""
    if wire_format in (None, "fp32"):
        return None, None
    from dgraph_tpu_torch.wire.codec import make_wire_transform

    return make_wire_transform(wire_format, dtype)


def _wire_buffer(like: torch.Tensor, rows: int, wire_format) -> torch.Tensor:
    """An empty receive buffer of ``rows`` encoded rows of ``like``'s
    width and dtype under the format."""
    from dgraph_tpu_torch.wire.codec import wire_operand

    width, dtype = wire_operand(wire_format, like.shape[-1], like.dtype)
    return torch.empty((rows, width), dtype=dtype, device=like.device)


def overlap_active(plan: EdgePlan, group=None) -> bool:
    """True when this plan lowers its exchange as the overlap rounds over
    the interior/boundary split."""
    return (group is not None and plan.overlap is not None
            and resolve_plan_impl(plan, group) == "overlap")


def split_active(plan: EdgePlan, group=None) -> bool:
    """True when this plan routes through the interior/boundary split (the
    models' routing predicate): the plan carries the split and the
    resolution names a split lowering ('overlap' or 'pallas_p2p');
    :func:`halo_exchange_split` picks the transport."""
    return (group is not None and plan.overlap is not None
            and resolve_plan_impl(plan, group) in SPLIT_IMPLS)


# --- the lowerings ---------------------------------------------------------


def _masked_owner_sum(back: torch.Tensor, halo: HaloSpec, n_pad: int) -> torch.Tensor:
    """``[W, S, F]`` returned halo rows -> their owners' ``[n_pad, F]``
    sums: the send mask in the payload's dtype, one flat segment sum."""
    F = back.shape[-1]
    back = back * halo.send_mask[..., None].to(back.dtype)
    return local_ops.segment_sum(back.reshape(-1, F), halo.send_idx.reshape(-1), n_pad)


def _per_delta_owner_sum(back: torch.Tensor, halo: HaloSpec, n_pad: int,
                         peers: list) -> torch.Tensor:
    """The ``ppermute`` reverse's reduction: one masked segment sum a peer's
    block of ``back``, added in the order of ``peers``, the first sum
    standing alone. In delta order it is the reference's ``ppermute``
    ``halo_scatter_sum`` (``collectives.py:861-883``); in reverse delta
    order, JAX's transpose of its ``ppermute`` exchange, which accumulates
    x's cotangent walking the per-delta gathers from last to first. The
    bits differ from the flat sum's where an owner row gets partials from
    more than one peer."""
    out = None
    for p in peers:
        blk = back[p] * halo.send_mask[p, :, None].to(back.dtype)
        part = local_ops.segment_sum(blk, halo.send_idx[p], n_pad)
        out = part if out is None else out + part
    return out


def _staged(t: torch.Tensor, group, what: str) -> bool:
    from dgraph_tpu_torch.comm.dist import log_staged_once

    if group.staged(t):
        log_staged_once(what)
        return True
    return False


def _masked_block(x: torch.Tensor, halo: HaloSpec, peer: int) -> torch.Tensor:
    """This rank's masked send block to ``peer``, ``x[send_idx[peer]] *
    send_mask[peer]``: element for element what ``all_to_all`` sends there."""
    idx = halo.send_idx[peer].long()
    return x.index_select(0, idx) * halo.send_mask[peer, :, None].to(x.dtype)


class _Rounds:
    """Rounds posted in one ``batch_isend_irecv``, every rank in the same
    (delta or round) order: each send ``(block, peer, tag)``, each receive
    ``(rows, peer, tag)``, ``rows`` a view of the buffer its block lands in,
    ``peer`` a graph rank (posted as its global rank).
    A rank with nothing to post posts no batch.
    :meth:`wait` returns once every block has landed: on NCCL it orders the
    current stream after the rounds (the host does not wait, and work queued
    before it can run beside them); on gloo it blocks, and a payload staged
    through the host (CUDA tensors, ranks sharing a card) is copied into its
    rows there."""

    def __init__(self, group, sends: list, recvs: list, like: torch.Tensor, what: str):
        self._staged = _staged(like, group, f"the {what} lowering (nothing overlaps: gloo "
                                            "waits on the host)")
        keep = [b.cpu() if self._staged else b.contiguous() for b, _, _ in sends]
        land = [torch.empty(rows.shape, dtype=rows.dtype) if self._staged else rows
                for rows, _, _ in recvs]
        # torch reads a P2POp's peer as a global rank, whatever its group:
        # graph rank p of this replica group is global_peer(p)
        ops = [dist.P2POp(dist.isend, b, group.global_peer(peer), group.pg, tag)
               for b, (_, peer, tag) in zip(keep, sends)]
        ops += [dist.P2POp(dist.irecv, buf, group.global_peer(peer), group.pg, tag)
                for buf, (_, peer, tag) in zip(land, recvs)]
        self._works = dist.batch_isend_irecv(ops) if ops else []
        self._keep = keep
        self._land = [(rows, buf) for (rows, _, _), buf in zip(recvs, land)]

    def wait(self) -> None:
        for w in self._works:
            w.wait()
        if self._staged:
            for rows, buf in self._land:
                rows.copy_(buf)
        self._works, self._keep, self._land = [], [], []


class _Posted:
    """Rounds posted into a buffer: :meth:`finish` waits for them and,
    under a codec, decodes each received block into its rows of the buffer
    (every round posted before any is placed). Returns the buffer."""

    def __init__(self, buffer, rounds: _Rounds, places: list, decode):
        self.buffer, self.rounds, self.places, self.decode = buffer, rounds, places, decode

    def finish(self) -> torch.Tensor:
        self.rounds.wait()
        for rows, wire in self.places:
            rows.copy_(self.decode(wire))
        return self.buffer


@dataclasses.dataclass(frozen=True)
class _Lowering:
    """One lowering of the exchange on one group: ``fwd`` (local rows ->
    ``[W*S, F]`` halo buffer) and ``rev`` (halo buffer -> owners' sums),
    both under the call site's ``wire_format``. The per-delta round
    lowerings post first (``post_fwd`` / ``post_rev``) and finish in
    ``fwd`` / ``rev``, which take rounds already posted."""

    impl: str  # 'all_to_all' | 'ppermute' | 'overlap' | 'pallas_p2p' | 'sched'
    group: object
    deltas: tuple
    schedule: object = None  # sched.ir.HaloSchedule under 'sched' (frozen, hashable)
    wire_format: str = "fp32"  # a key of wire.spec.WIRE_FORMATS

    def _post(self, like, buffer, sends: list, lands: list) -> _Posted:
        """Post ``sends`` ``(block, peer, tag)``, each encoded under the
        codec, and receives for ``lands`` ``(rows of buffer, peer, tag)``:
        straight into the rows without a codec, else into a wire buffer
        each, decoded into the rows when the rounds finish."""
        enc, dec = _wire_fns(self.wire_format, like.dtype)
        if enc is None:
            return _Posted(buffer, _Rounds(self.group, sends, lands, like, self.impl), [], None)
        sends = [(enc(b), peer, tag) for b, peer, tag in sends]
        wires = [_wire_buffer(like, rows.shape[0], self.wire_format) for rows, _, _ in lands]
        recvs = [(w, peer, tag) for w, (_, peer, tag) in zip(wires, lands)]
        return _Posted(buffer, _Rounds(self.group, sends, recvs, like, self.impl),
                       [(rows, w) for w, (rows, _, _) in zip(wires, lands)], dec)

    def post_fwd(self, x, halo: HaloSpec) -> _Posted:
        """The exchange's rounds, every block gathered before any is posted:
        the masked block to ``(me + d) % W`` and the block from ``(me - d) %
        W`` landed at its rows of the ``[W*S, F]`` buffer."""
        W, S = halo.send_idx.shape[0], halo.s_pad
        me = self.group.rank
        out = x.new_zeros((W * S, x.shape[-1]))
        sends = [(_masked_block(x, halo, (me + d) % W), (me + d) % W, d) for d in self.deltas]
        lands = [(out[src * S:(src + 1) * S], src, d)
                 for src, d in (((me - d) % W, d) for d in self.deltas)]
        return self._post(x, out, sends, lands)

    def post_rev(self, h, halo: HaloSpec) -> _Posted:
        """The reverse rounds: each delta's halo block back to its owner
        ``(me - d) % W`` (encoded unmasked under a codec), and the partials of
        this rank's rows from ``(me + d) % W`` parked at block ``(me + d) %
        W`` of a ``[W, S, F]`` buffer (where ``all_to_all`` delivers
        them)."""
        W, S = halo.send_idx.shape[0], halo.s_pad
        me, F = self.group.rank, h.shape[-1]
        h = h.reshape(W * S, F)
        back = h.new_zeros((W, S, F))
        sends = [(h[src * S:(src + 1) * S], src, d)
                 for src, d in (((me - d) % W, d) for d in self.deltas)]
        lands = [(back[(me + d) % W], (me + d) % W, d) for d in self.deltas]
        return self._post(h, back, sends, lands)

    def _sched_fwd(self, x, halo: HaloSpec) -> torch.Tensor:
        """The compiled rounds (``collectives.py:515-566``): in round k
        this rank sends rows ``[start, start + C_k)`` of its masked block to
        its round peer and receives a ``[C_k, F]`` block into a buffer of its
        own; after the wait each buffer is copied to rows ``src*S + start``
        of the ``[W*S, F]`` buffer in round order. Windows of one block can
        overlap across rounds (a round's C_k can exceed a transfer's rows),
        with equal values: a copy, never an add. Under a codec each window
        is encoded after its row slice (``collectives.py:548-550``) and
        decoded before its copy."""
        W, S = halo.send_idx.shape[0], halo.s_pad
        me, F = self.group.rank, x.shape[-1]
        enc, dec = _wire_fns(self.wire_format, x.dtype)
        sends, recvs, lands = [], [], []
        for k, rnd in enumerate(self.schedule.rounds):
            C = rnd.row_count
            for t in rnd.transfers:
                if t.src == me:
                    rows = slice(t.row_start, t.row_start + C)
                    blk = x.index_select(0, halo.send_idx[t.dst, rows].long())
                    blk = blk * halo.send_mask[t.dst, rows, None].to(x.dtype)
                    sends.append((blk if enc is None else enc(blk), t.dst, k))
                if t.dst == me:
                    buf = x.new_empty((C, F)) if enc is None else _wire_buffer(
                        x, C, self.wire_format)
                    recvs.append((buf, t.src, k))
                    lands.append((t.src * S + t.row_start, buf))
        _Rounds(self.group, sends, recvs, x, self.impl).wait()
        out = x.new_zeros((W * S, F))
        for off, buf in lands:
            out[off:off + buf.shape[0]] = buf if dec is None else dec(buf)
        return out

    def _sched_rev(self, h, halo: HaloSpec, n_pad: int) -> torch.Tensor:
        """The compiled rounds reversed (``collectives.py:569-610``): each
        forward receiver sends back the window its block landed in; the
        forward sender copies what returns into plane ``dst``, rows
        ``[start, start + C_k)``, of a ``[W, S, F]`` buffer in round order,
        which reduces as ``all_to_all``'s does (each window encoded
        unmasked under a codec, decoded before its copy)."""
        W, S = halo.send_idx.shape[0], halo.s_pad
        me, F = self.group.rank, h.shape[-1]
        enc, dec = _wire_fns(self.wire_format, h.dtype)
        h = h.reshape(W * S, F)
        sends, recvs, lands = [], [], []
        for k, rnd in enumerate(self.schedule.rounds):
            C = rnd.row_count
            for t in rnd.transfers:
                if t.dst == me:
                    off = t.src * S + t.row_start
                    blk = h[off:off + C]
                    sends.append((blk if enc is None else enc(blk), t.src, k))
                if t.src == me:
                    buf = h.new_empty((C, F)) if enc is None else _wire_buffer(
                        h, C, self.wire_format)
                    recvs.append((buf, t.dst, k))
                    lands.append((t.dst, t.row_start, buf))
        _Rounds(self.group, sends, recvs, h, self.impl).wait()
        back = h.new_zeros((W, S, F))
        for plane, start, buf in lands:
            back[plane, start:start + buf.shape[0]] = buf if dec is None else dec(buf)
        return _masked_owner_sum(back, halo, n_pad)

    def fwd(self, x, halo: HaloSpec, posted: Optional[_Posted] = None) -> torch.Tensor:
        W, S = halo.send_idx.shape[0], halo.s_pad
        me, F = self.group.rank, x.shape[-1]
        if self.impl == "sched":
            return self._sched_fwd(x, halo)
        if self.impl in ("ppermute", "overlap"):
            return (posted or self.post_fwd(x, halo)).finish()
        enc, dec = _wire_fns(self.wire_format, x.dtype)
        if self.impl == "pallas_p2p":
            from dgraph_tpu_torch.ops.p2p import p2p_transport

            rows = torch.tensor([(me + d) % W for d in self.deltas], device=x.device)
            blocks = x.index_select(0, halo.send_idx.index_select(0, rows).reshape(-1).long())
            blocks = blocks.reshape(len(self.deltas), S, F)
            mask = halo.send_mask.index_select(0, rows)
            if enc is None:
                return p2p_transport(blocks, self.deltas, W, S, sign=1, mask=mask,
                                     group=self.group)
            # masked, then encoded: kernel 5 moves the wire tiles as data
            wire = enc(blocks * mask[..., None].to(x.dtype))
            out = p2p_transport(wire, self.deltas, W, S, sign=1, group=self.group)
            return dec(out.reshape(W, S, -1)).reshape(W * S, F)
        from dgraph_tpu_torch.ops.p2p import all_to_all

        send = x.index_select(0, halo.send_idx.reshape(-1).long()).reshape(W, S, F)
        send = send * halo.send_mask[..., None].to(x.dtype)
        if enc is None:
            return all_to_all(send, self.group).reshape(W * S, F)
        return dec(all_to_all(enc(send), self.group)).reshape(W * S, F)

    def rev(self, h, halo: HaloSpec, n_pad: int, posted: Optional[_Posted] = None,
            reverse_deltas: bool = False) -> torch.Tensor:
        """``reverse_deltas``: the exchange's backward, where ``ppermute``
        adds its per-delta sums in reverse delta order. Under a codec the
        halo blocks are encoded unmasked; the mask applies after decode."""
        W, S = halo.send_idx.shape[0], halo.s_pad
        me, F = self.group.rank, h.shape[-1]
        if self.impl == "sched":
            return self._sched_rev(h, halo, n_pad)
        enc, dec = _wire_fns(self.wire_format, h.dtype)
        if self.impl in ("ppermute", "overlap"):
            back = (posted or self.post_rev(h, halo)).finish()
            if self.impl == "ppermute":
                peers = [(me + d) % W for d in self.deltas]
                return _per_delta_owner_sum(back, halo, n_pad,
                                            peers[::-1] if reverse_deltas else peers)
        elif self.impl == "pallas_p2p":
            from dgraph_tpu_torch.ops.p2p import p2p_transport

            rows = torch.tensor([(me - d) % W for d in self.deltas], device=h.device)
            blocks = h.reshape(W, S, F).index_select(0, rows)
            if enc is None:
                back = p2p_transport(blocks, self.deltas, W, S, sign=-1,
                                     group=self.group).reshape(W, S, F)
            else:
                wire = p2p_transport(enc(blocks), self.deltas, W, S, sign=-1, group=self.group)
                back = dec(wire.reshape(W, S, -1))
        else:
            from dgraph_tpu_torch.ops.p2p import all_to_all

            back = h.reshape(W, S, F)
            back = all_to_all(back, self.group) if enc is None else dec(
                all_to_all(enc(back), self.group))
        return _masked_owner_sum(back, halo, n_pad)


class _Exchange(torch.autograd.Function):
    """The exchange; its backward is the reverse delivery. ``posted`` holds
    rounds :meth:`_Lowering.post_fwd` already posted."""

    @staticmethod
    def forward(ctx, x, send_idx, send_mask, s_pad, lowering, posted=None):
        ctx.save_for_backward(send_idx, send_mask)
        ctx.s_pad, ctx.lowering, ctx.n_pad = s_pad, lowering, x.shape[0]
        return lowering.fwd(x, HaloSpec(send_idx, send_mask, s_pad), posted)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        halo = HaloSpec(*ctx.saved_tensors, ctx.s_pad)
        dx = ctx.lowering.rev(g.contiguous(), halo, ctx.n_pad, reverse_deltas=True)
        return dx, None, None, None, None, None


class _Unexchange(torch.autograd.Function):
    """The reverse delivery; its backward is the exchange."""

    @staticmethod
    def forward(ctx, h, send_idx, send_mask, s_pad, n_pad, lowering, posted=None):
        ctx.save_for_backward(send_idx, send_mask)
        ctx.s_pad, ctx.lowering = s_pad, lowering
        return lowering.rev(h, HaloSpec(send_idx, send_mask, s_pad), n_pad, posted)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        halo = HaloSpec(*ctx.saved_tensors, ctx.s_pad)
        return ctx.lowering.fwd(g.contiguous(), halo), None, None, None, None, None, None


def _resolve_halo_arg(impl, deltas, W) -> str:
    """Resolution for call sites that hold only a HaloSpec: ``deltas=None``
    carries no round information, which only ``all_to_all`` can lower."""
    if impl is not None:
        return impl
    if deltas is None:
        return "all_to_all"
    return resolve_halo_impl(tuple(deltas))[0]


def _lowering(impl, deltas, W, group, schedule, entry: str, wire_format=None) -> _Lowering:
    """The lowering of one call under ``wire_format`` (None: fp32);
    under 'sched' with the plan's schedule, whose absence raises the
    reference's error (``collectives.py:771-777``, ``:853-858``)."""
    impl = _resolve_halo_arg(impl, deltas, W)
    if impl == "sched" and schedule is None:
        raise ValueError(
            f"{entry}(impl='sched') needs the plan's compiled halo schedule; resolve "
            "through resolve_plan_impl and pass schedule=plan.halo_schedule")
    return _Lowering(impl, group, tuple(deltas or range(1, W)),
                     schedule if impl == "sched" else None, wire_format or "fp32")


def halo_exchange(x: torch.Tensor, halo: HaloSpec, group=None, deltas=None,
                  impl: Optional[str] = None, schedule=None,
                  wire_format: Optional[str] = None) -> torch.Tensor:
    """The halo buffer ``[W*S, F]`` of this rank: rows ``[p*S, (p+1)*S)``
    hold the rows rank p sends here, masked. ``deltas`` is the plan's live
    rank offsets; ``impl`` the lowering, resolved once by the caller (None
    resolves here); ``schedule`` the plan's compiled halo schedule
    (``plan.halo_schedule``), read under 'sched' only, where it must be
    given; ``wire_format`` the payload codec, resolved once by the caller
    (:func:`resolve_plan_wire_format`; None: the fp32 identity). At world
    size 1 (``group=None``) the send lists are all masked and the buffer is
    zeros of the plan's shape; the mask is cast to x's dtype so a bf16
    stream stays bf16."""
    F = x.shape[-1]
    W, S = halo.send_idx.shape[0], halo.s_pad
    if group is None:
        idx = halo.send_idx.reshape(-1).long()
        send = x.index_select(0, idx) * halo.send_mask.reshape(-1, 1).to(x.dtype)
        return send.reshape(-1, F)
    if deltas is not None and len(deltas) == 0:
        return x.new_zeros((W * S, F))
    lowering = _lowering(impl, deltas, W, group, schedule, "halo_exchange", wire_format)
    return _Exchange.apply(x, halo.send_idx, halo.send_mask, S, lowering)


def halo_scatter_sum(h: torch.Tensor, halo: HaloSpec, n_pad: int, group=None,
                     deltas=None, impl: Optional[str] = None, schedule=None,
                     wire_format: Optional[str] = None) -> torch.Tensor:
    """Transpose of :func:`halo_exchange`: halo-slot values delivered back
    to their owner ranks (encoded under ``wire_format``) and summed into
    local rows."""
    W, S = halo.send_idx.shape[0], halo.s_pad
    F = h.shape[-1]
    if group is None:
        back = h.reshape(-1, F) * halo.send_mask.reshape(-1, 1).to(h.dtype)
        return local_ops.segment_sum(back, halo.send_idx.reshape(-1), n_pad)
    if deltas is not None and len(deltas) == 0:
        return h.new_zeros((n_pad, F))
    lowering = _lowering(impl, deltas, W, group, schedule, "halo_scatter_sum", wire_format)
    return _Unexchange.apply(h, halo.send_idx, halo.send_mask, S, n_pad, lowering)


class PendingHalo:
    """A halo result whose rounds may still be in flight (the overlap
    lowering over the split): :meth:`wait` finishes them, once, and gives
    the tensor; indexing gives a pending view of it. Work queued before the
    first :meth:`wait` runs while the rounds fly (on NCCL)."""

    def __init__(self, finish):
        self._finish, self._value = finish, None

    def wait(self) -> torch.Tensor:
        if self._finish is not None:
            self._value, self._finish = self._finish(), None
        return self._value

    def __getitem__(self, key) -> "PendingHalo":
        return PendingHalo(lambda: self.wait()[key])


def ready(t) -> torch.Tensor:
    """``t`` as a tensor (a :class:`PendingHalo` waited for)."""
    return t.wait() if isinstance(t, PendingHalo) else t


def halo_exchange_overlap(x: torch.Tensor, halo: HaloSpec, group, deltas,
                          wire_format: str = "fp32") -> PendingHalo:
    """:func:`halo_exchange` under the overlap lowering with its rounds left
    in flight: every block gathered (and encoded) and every round posted
    now, the buffer (bit-equal to ``all_to_all``'s under the same format on
    the rows it lands) when the :class:`PendingHalo` is waited for."""
    if group is None or not deltas:
        buf = halo_exchange(x, halo, group, deltas)
        return PendingHalo(lambda: buf)
    lowering = _Lowering("overlap", group, tuple(deltas), wire_format=wire_format)
    with torch.no_grad():
        posted = lowering.post_fwd(x, halo)
    return PendingHalo(lambda: _Exchange.apply(x, halo.send_idx, halo.send_mask, halo.s_pad,
                                               lowering, posted))


def halo_scatter_sum_overlap(h: torch.Tensor, halo: HaloSpec, n_pad: int, group,
                             deltas, wire_format: str = "fp32") -> PendingHalo:
    """:func:`halo_scatter_sum` under the overlap lowering with its reverse
    rounds left in flight; waited for, the owners' sums, bit-equal to the
    ``all_to_all`` reverse's (the same masked flat sum over the same
    ``[W, S, F]`` buffer)."""
    if group is None or not deltas:
        out = halo_scatter_sum(h, halo, n_pad, group, deltas)
        return PendingHalo(lambda: out)
    lowering = _Lowering("overlap", group, tuple(deltas), wire_format=wire_format)
    with torch.no_grad():
        posted = lowering.post_rev(h, halo)
    return PendingHalo(lambda: _Unexchange.apply(h, halo.send_idx, halo.send_mask,
                                                 halo.s_pad, n_pad, lowering, posted))


def halo_exchange_split(x: torch.Tensor, plan: EdgePlan, group):
    """The split lowerings' exchange: one resolution, then the one-sided
    puts (kernel 5; a tensor) or the overlap rounds (a
    :class:`PendingHalo`): the ``[W*S, F]`` buffer the boundary takes
    index, the same bits either way (under the same wire format)."""
    impl = resolve_plan_impl(plan, group)
    wf = resolve_plan_wire_format(plan, group)
    if impl == "pallas_p2p":
        return halo_exchange(x, plan.halo, group, plan.halo_deltas, impl, wire_format=wf)
    return halo_exchange_overlap(x, plan.halo, group, plan.halo_deltas, wf)


def map_feature_chunks(fn, width: int, chunk: Optional[int] = None):
    """Apply ``fn(slice)`` over <=chunk-wide feature slices and concat the
    results on the last axis (``chunk`` defaults to
    ``config.gather_col_block``): every per-edge intermediate of the edge
    pipeline stays at most one chunk wide."""
    cb = chunk or _cfg.gather_col_block or width
    outs = [fn(slice(j, min(j + cb, width))) for j in range(0, width, cb)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)


def halo_extend(x: torch.Tensor, plan: EdgePlan, side: str, group=None) -> torch.Tensor:
    """The extended vertex table ``local_take`` indexes into: ``[n_pad +
    W*S, F]`` on the halo side (the halo rows appended even when nothing
    crosses ranks), ``x`` unchanged on the other side. One full-width
    exchange, so a feature-chunked pipeline never repeats it."""
    if side != plan.halo_side:
        return x
    impl = resolve_plan_impl(plan, group) if group is not None else None
    return torch.cat([x, halo_exchange(x, plan.halo, group, plan.halo_deltas, impl,
                                       plan.halo_schedule,
                                       resolve_plan_wire_format(plan, group))], dim=0)


def local_take(full: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Per-edge rows from the (halo-extended) vertex table; masked edges
    are zero and take no gradient (the reference's ``taken * edge_mask``,
    collectives.py:954-987), with no ``[e_pad, F]`` multiply pass:

    - halo side: the edge mask is folded into the ids (a masked edge takes
      an out-of-range id, which the gather fills with a zero row); the
      backward runs through the plan's sorting permutation when it has one;
    - owner side of an owner-sorted plan: the plan's ids as they are, which
      keeps them sorted — masked edges already carry the out-of-range
      ``n_owner_pad`` (``plan.check_owner_padding``) — so the backward is
      the sorted segment sum and, with ``config.use_pallas_gather``, the
      forward the sorted-row-gather kernel."""
    idx = _side_index(plan, side)
    if side != plan.halo_side and plan.ids_sorted(side):
        return local_ops.take_rows(full, idx, indices_are_sorted=True,
                                   gather_mv=plan.gather_mv)
    idx = torch.where(plan.edge_mask > 0, idx, full.shape[0])
    if side == plan.halo_side and plan.halo_sort_perm is not None:
        return local_ops.take_rows_sort_route(
            full, idx, plan.halo_sort_perm, plan.halo_sorted_ids)
    return local_ops.take_rows(full, idx)


def gather(x: torch.Tensor, plan: EdgePlan, side: str, group=None) -> torch.Tensor:
    """Per-edge features gathered from one endpoint side: ``[e_pad, F]``."""
    return local_take(halo_extend(x, plan, side, group), plan, side)


def scatter_sum(edata: torch.Tensor, plan: EdgePlan, side: str, group=None) -> torch.Tensor:
    """Sum per-edge values into that side's vertices: ``[n_pad, F]``. On
    the halo side the remote partials go back to their owners through the
    plan's lowering (the split schedule under a split lowering)."""
    edata = edata * plan.edge_mask[:, None].to(edata.dtype)
    idx = _side_index(plan, side)
    n_pad = _side_npad(plan, side)
    if side != plan.halo_side:
        if plan.ids_sorted(side):
            return local_ops.sorted_segment_sum_any(edata, idx, n_pad,
                                                    gather_mv=plan.gather_mv)
        return local_ops.segment_sum(edata, idx, n_pad)
    impl = resolve_plan_impl(plan, group) if group is not None else None
    wf = resolve_plan_wire_format(plan, group)
    if impl in SPLIT_IMPLS:
        return _scatter_sum_split(edata, plan, side, group, impl, wf)
    n_full = n_pad + plan.world_size * plan.halo.s_pad
    if plan.halo_sort_perm is not None:
        full = local_ops.segment_sum_sort_route(
            edata, idx, plan.halo_sort_perm, plan.halo_sorted_ids, n_full)
    else:
        full = local_ops.segment_sum(edata, idx, n_full)
    return full[:n_pad] + halo_scatter_sum(full[n_pad:], plan.halo, n_pad, group,
                                           plan.halo_deltas, impl, plan.halo_schedule, wf)


def scatter_bias_relu(
    edata: torch.Tensor,  # [e_pad, F] per-edge stream (e.g. gathered src proj)
    bias: torch.Tensor,  # [n_pad, F] owner-side vertex operand
    plan: EdgePlan,
    side: str,
    edge_weight: Optional[torch.Tensor] = None,  # [e_pad]
    group=None,
) -> torch.Tensor:
    """Fused owner-side aggregation ``out[v] = Σ_e w_e·relu(edata_e + bias_v)``:
    the fused kernel on the owner side, composed ops elsewhere."""
    idx = _side_index(plan, side)
    n_pad = _side_npad(plan, side)
    bias = bias.to(edata.dtype)
    if plan.ids_sorted(side):
        return local_ops.sorted_segment_sum_bias_relu_any(
            edata, idx, bias, n_pad, edge_weight=edge_weight, gather_mv=plan.gather_mv)
    m = torch.relu(edata + gather(bias, plan, side, group))
    if edge_weight is not None:
        m = m * edge_weight[:, None].to(m.dtype)
    return scatter_sum(m, plan, side, group)


# --- the interior/boundary split (collectives.py:1075-1337) ---------------


def _overlap_spec(plan: EdgePlan):
    if plan.overlap is None:
        raise ValueError("plan carries no interior/boundary split; build it with "
                         "build_edge_plan(overlap=True)")
    return plan.overlap


def interior_take(x: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Per-edge rows of the INTERIOR subset from the local table (no
    interior edge references a halo slot); padded slots give zero rows."""
    idx = _overlap_spec(plan).side("interior", side)
    return local_ops.take_rows(x, idx, indices_are_sorted=side != plan.halo_side
                               and plan.ids_sorted(side))


def boundary_take(x_or_halo: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Per-edge rows of the BOUNDARY subset: on the halo side from the
    ``[W*S, F]`` halo buffer (the ids are rebased into it; a
    :class:`PendingHalo` is waited for here), on the owner side from the
    local table."""
    idx = _overlap_spec(plan).side("boundary", side)
    return local_ops.take_rows(ready(x_or_halo), idx, indices_are_sorted=side != plan.halo_side
                               and plan.ids_sorted(side))


def interior_chunks(n_deltas: int) -> int:
    """Edge-axis chunks of the overlap lowering's interior sum
    (``collectives.py:1086-1098``): ``config.overlap_interior_chunks``
    (``DGRAPH_TPU_OVERLAP_CHUNKS``, default 1: one sum, the bits of the
    serial path) capped at the live-delta count. More chunks regroup the
    float adds."""
    c = _cfg.overlap_interior_chunks
    return max(1, min(int(c) if c else 1, max(n_deltas, 1)))


def _subset_owner_sum(edata, plan, side, which, chunks: int = 1):
    """Owner-side sum of one subset's rows (the sorted sum when the plan's
    ids are sorted), in ``chunks`` edge-axis pieces added in order when the
    subset has at least two rows a piece (``collectives.py:1123-1145``)."""
    ids = _overlap_spec(plan).side(which, side)
    n_pad = _side_npad(plan, side)
    if not plan.ids_sorted(side):
        return local_ops.segment_sum(edata, ids, n_pad)
    E = edata.shape[0]
    if chunks <= 1 or E < 2 * chunks:
        return local_ops.sorted_segment_sum_any(edata, ids, n_pad)
    step = -(-E // chunks)
    out = None
    for j in range(0, E, step):
        part = local_ops.sorted_segment_sum_any(edata[j:j + step], ids[j:j + step], n_pad)
        out = part if out is None else out + part
    return out


def interior_scatter_sum(edata_int: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Sum INTERIOR rows into ``side``'s vertices; on the owner side in
    :func:`interior_chunks` pieces, so they can interleave with the rounds
    in flight."""
    ov = _overlap_spec(plan)
    if side == plan.halo_side:
        return local_ops.segment_sum(edata_int, ov.side("interior", side), _side_npad(plan, side))
    return _subset_owner_sum(edata_int, plan, side, "interior",
                             interior_chunks(len(plan.halo_deltas)))


def boundary_scatter_sum(edata_bnd: torch.Tensor, plan: EdgePlan, side: str) -> torch.Tensor:
    """Sum BOUNDARY rows into ``side``'s OWNER vertices; a halo-side
    boundary scatter needs the reverse exchange (:func:`scatter_sum`)."""
    _overlap_spec(plan)
    if side == plan.halo_side:
        raise ValueError("boundary_scatter_sum targets the owner side; halo-side "
                         "boundary scatters need the reverse exchange — use scatter_sum")
    return _subset_owner_sum(edata_bnd, plan, side, "boundary")


def overlap_edge_weight(edge_weight: Optional[torch.Tensor], plan: EdgePlan) -> tuple:
    """A ``[e_pad]`` per-edge weight split into its (interior, boundary)
    subsets (padded slots 0); (None, None) without a weight."""
    if edge_weight is None:
        return None, None
    ov = _overlap_spec(plan)
    return local_ops.row_take(edge_weight, ov.int_epos), local_ops.row_take(edge_weight, ov.bnd_epos)


def gather_scatter_overlap(x_local: torch.Tensor, halo_buf: torch.Tensor, plan: EdgePlan,
                           edge_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[v] = Σ_e w_e·x[halo-side endpoint of e]`` into the owner side
    over the split: the interior edges' sum from ``x_local`` first (while
    the overlap rounds fly), then the boundary edges' from ``halo_buf``,
    merged at the end."""
    owner = "dst" if plan.halo_side == "src" else "src"
    w_int, w_bnd = overlap_edge_weight(edge_weight, plan)
    m_int = interior_take(x_local, plan, plan.halo_side)
    if w_int is not None:
        m_int = m_int * w_int[:, None].to(m_int.dtype)
    agg_int = interior_scatter_sum(m_int, plan, owner)
    m_bnd = boundary_take(halo_buf, plan, plan.halo_side)
    if w_bnd is not None:
        m_bnd = m_bnd * w_bnd[:, None].to(m_bnd.dtype)
    return agg_int + boundary_scatter_sum(m_bnd, plan, owner)


def _scatter_sum_split(edata, plan: EdgePlan, side: str, group, impl: str,
                       wire_format: str = "fp32") -> torch.Tensor:
    """Halo-side scatter over the split (``collectives.py:1228-1262``):
    boundary rows pre-reduced into halo slots and sent back first (the
    reverse overlap rounds, left in flight, or the reverse puts, under
    ``wire_format``), interior rows summed into local rows meanwhile, the
    two merged. ``edata`` is already edge-masked."""
    ov = _overlap_spec(plan)
    n_pad = _side_npad(plan, side)
    W, S = plan.world_size, plan.halo.s_pad
    bnd_rows = local_ops.take_rows(edata, ov.bnd_epos)
    slot_sums = local_ops.segment_sum(bnd_rows, ov.side("boundary", side), W * S)
    if impl == "pallas_p2p":
        remote = halo_scatter_sum(slot_sums, plan.halo, n_pad, group, plan.halo_deltas, impl,
                                  wire_format=wire_format)
    else:
        remote = halo_scatter_sum_overlap(slot_sums, plan.halo, n_pad, group, plan.halo_deltas,
                                          wire_format)
    int_rows = local_ops.take_rows(edata, ov.int_epos)
    interior = local_ops.segment_sum(int_rows, ov.side("interior", side), n_pad)
    return interior + ready(remote)


def scatter_bias_relu_overlap(
    stream_local: torch.Tensor,  # [n_halo_pad, F] halo-side stream (local table)
    halo_buf: torch.Tensor,  # [W*S, F] the exchange's output
    bias: torch.Tensor,  # [n_owner_pad, F] owner-side vertex operand
    plan: EdgePlan,
    side: str,  # owner side to aggregate into
    edge_weight: Optional[torch.Tensor] = None,  # [e_pad]
) -> torch.Tensor:
    """:func:`scatter_bias_relu` over the split: the fused kernel once over
    the interior subset (local rows only) and once over the boundary subset
    (the landed halo buffer), summed. The same math as the unsplit op —
    relu is per edge and the sum runs over a partition of the edges — with
    the owner-side sums grouped per subset."""
    ov = _overlap_spec(plan)
    n_pad = _side_npad(plan, side)
    bias = bias.to(stream_local.dtype)
    w_int, w_bnd = overlap_edge_weight(edge_weight, plan)
    a = local_ops.sorted_segment_sum_bias_relu_any(
        interior_take(stream_local, plan, plan.halo_side), ov.side("interior", side), bias,
        n_pad, edge_weight=w_int)
    b = local_ops.sorted_segment_sum_bias_relu_any(
        boundary_take(halo_buf, plan, plan.halo_side), ov.side("boundary", side), bias,
        n_pad, edge_weight=w_bnd)
    return a + b


def gather_concat(x_src: torch.Tensor, x_dst: torch.Tensor, plan: EdgePlan,
                  group=None) -> torch.Tensor:
    """``[e_pad, F_src + F_dst]``: the src- and the dst-side per-edge
    features side by side, the double gather the reference's GCN and GAT
    layers start with."""
    return torch.cat([gather(x_src, plan, "src", group), gather(x_dst, plan, "dst", group)],
                     dim=-1)


# --- reductions over the ranks ----------------------------------------------


def _all_reduce(x: torch.Tensor, group, pg) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``pg``, as a new tensor (through the
    host on a shared card's gloo group)."""
    staged = _staged(x, group, "all_reduce")
    out = x.detach().cpu() if staged else x.detach().clone()
    dist.all_reduce(out, group=pg)
    return out.to(x.device) if staged else out


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the graph group (the reference's ``psum`` over
    the graph axis), as a new tensor; ``x`` itself at world size 1."""
    if group is None:
        return x
    return _all_reduce(x, group, group.pg)


def replica_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean of ``x`` over the replica axis (the reference's ``pmean`` over
    ``replica``): over this graph rank's R ranks, one in each replica
    group. ``x`` itself at one replica."""
    if group is None or group.num_replicas == 1:
        return x
    return _all_reduce(x, group, group.replica_pg) / group.num_replicas


def grad_sync(params, group=None, *, prescaled: bool = False) -> None:
    """The DDP all-reduce of every parameter's gradient, in place (the
    reference's ``grad_sync``, communicator.py:251-270): the SUM over the
    graph group (each rank's gradient is a partial sum of one sample's
    loss) and the MEAN over the replicas (each replica group holds its own
    sample), as one collective over all R * W ranks. ``prescaled``: the
    loss was already divided by R before the backward (the reference's
    train step, ``train/loop.py:162-166``, ``:206-211``), so the sum over
    all ranks is the mean. At R = 1 the sum over the graph group."""
    grads = [p.grad for p in params if p.grad is not None]
    if group is None or not grads:
        return
    R = group.num_replicas
    flat = _all_reduce(torch.cat([g.reshape(-1) for g in grads]), group,
                       group.pg if R == 1 else group.world_pg)
    if R > 1 and not prescaled:
        flat = flat / R
    for g, s in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(s.view_as(g))
