"""Communicator facade — counterpart of ``dgraph_tpu/comm/communicator.py``.

:class:`SingleComm` is the world-size-1 communicator; :class:`DistComm`
(the reference's ``TpuComm``) is one rank of a ``torch.distributed`` group
(:class:`~dgraph_tpu_torch.comm.dist.RankGroup`). The models are written
against the methods both share, so model code is the same under either.
:meth:`Communicator.init_process_group` builds the right one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from dgraph_tpu_torch.comm import collectives
from dgraph_tpu_torch.ops.attention import flash_attention
from dgraph_tpu_torch.plan import EdgePlan, HaloSpec


@dataclasses.dataclass(frozen=True)
class SingleComm:
    """World-size-1 communicator (no collectives)."""

    def get_rank(self) -> int:
        return 0

    def get_world_size(self) -> int:
        return 1

    @property
    def group(self):
        return None

    def split_active(self, plan: EdgePlan) -> bool:
        return collectives.split_active(plan)

    def overlap_active(self, plan: EdgePlan) -> bool:
        return collectives.overlap_active(plan)

    def halo_exchange(self, x, halo: HaloSpec, deltas=None, impl=None, wire_format=None):
        """The world-size-1 exchange: the (all-masked) send lists read into
        a buffer of the plan's shape (no wire: ``wire_format`` is moot)."""
        return collectives.halo_exchange(x, halo, None, deltas, impl, wire_format=wire_format)

    def halo_exchange_overlap(self, x, plan: EdgePlan):
        return collectives.halo_exchange_overlap(x, plan.halo, None, plan.halo_deltas)

    def gather(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.gather(x, plan, side)

    def gather_concat(self, x_src, x_dst, plan: EdgePlan):
        return collectives.gather_concat(x_src, x_dst, plan)

    def halo_extend(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.halo_extend(x, plan, side)

    def local_take(self, x_full, plan: EdgePlan, side: str = "src"):
        return collectives.local_take(x_full, plan, side)

    def scatter(self, edata, plan: EdgePlan, side: str = "dst"):
        return collectives.scatter_sum(edata, plan, side)

    scatter_sum = scatter

    def scatter_bias_relu(self, edata, bias, plan: EdgePlan, side: str = "dst",
                          edge_weight=None):
        return collectives.scatter_bias_relu(edata, bias, plan, side, edge_weight)

    def put(self, send: torch.Tensor) -> torch.Tensor:
        """``[1, S, F]`` -> ``[S, F]``: the one block, this rank's own."""
        W, S, F = send.shape
        if W != 1:
            raise ValueError("put with world_size 1 expects send.shape[0] == 1")
        return send.reshape(S, F)

    def seq_attention(self, q, k, v, *, causal: bool = False, kv_mask=None,
                      impl: str = "ring"):
        """Exact attention over the full sequence (``[T, H, D]`` inputs).

        ``impl`` is validated as the reference does (``'ring'`` or
        ``'ulysses'``); at one rank both are one full-sequence attention,
        :func:`~dgraph_tpu_torch.ops.attention.flash_attention`: the flash
        kernels on a card, the dense oracle on the CPU. (The reference's
        single mode runs its dense oracle unless flash is pinned on.)"""
        if impl not in ("ring", "ulysses"):
            raise ValueError(f"unknown seq_attention impl: {impl!r}")
        return flash_attention(q, k, v, causal=causal, kv_mask=kv_mask)


@dataclasses.dataclass(frozen=True)
class DistComm:
    """One rank of a process group (the reference's ``TpuComm``,
    communicator.py:47-295): every graph primitive runs on this rank's
    per-rank plan and talks to the other ranks through ``group``."""

    group: object  # comm.dist.RankGroup

    def get_rank(self) -> int:
        return self.group.rank

    def get_world_size(self) -> int:
        return self.group.world_size

    # -- the split lowering (communicator.py:77-135) --
    def split_active(self, plan: EdgePlan) -> bool:
        """True when this plan routes through the interior/boundary split
        (the models' routing predicate)."""
        return collectives.split_active(plan, self.group)

    def overlap_active(self, plan: EdgePlan) -> bool:
        """True when this plan lowers its exchange as the overlap rounds
        over the interior/boundary split."""
        return collectives.overlap_active(plan, self.group)

    def halo_exchange_split(self, x, plan: EdgePlan):
        """The split lowerings' exchange (one resolution picks the overlap
        rounds or the one-sided puts): the ``[W*S, F]`` buffer the boundary
        takes index, a :class:`~dgraph_tpu_torch.comm.collectives.PendingHalo`
        under 'overlap'."""
        return collectives.halo_exchange_split(x, plan, self.group)

    def halo_exchange_overlap(self, x, plan: EdgePlan):
        """The overlap lowering's exchange, its rounds in flight: a
        :class:`~dgraph_tpu_torch.comm.collectives.PendingHalo` of the
        ``[W*S, F]`` buffer, under the plan's resolved wire format."""
        return collectives.halo_exchange_overlap(
            x, plan.halo, self.group, plan.halo_deltas,
            collectives.resolve_plan_wire_format(plan, self.group))

    def interior_take(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.interior_take(x, plan, side)

    def boundary_take(self, x_or_halo, plan: EdgePlan, side: str = "src"):
        return collectives.boundary_take(x_or_halo, plan, side)

    def interior_scatter_sum(self, edata_int, plan: EdgePlan, side: str = "dst"):
        return collectives.interior_scatter_sum(edata_int, plan, side)

    def boundary_scatter_sum(self, edata_bnd, plan: EdgePlan, side: str = "dst"):
        return collectives.boundary_scatter_sum(edata_bnd, plan, side)

    def gather_scatter_overlap(self, x_local, halo_buf, plan: EdgePlan, edge_weight=None):
        return collectives.gather_scatter_overlap(x_local, halo_buf, plan, edge_weight)

    def scatter_bias_relu_overlap(self, stream_local, halo_buf, bias, plan: EdgePlan,
                                  side: str = "dst", edge_weight=None):
        return collectives.scatter_bias_relu_overlap(stream_local, halo_buf, bias, plan,
                                                     side, edge_weight)

    # -- the unsplit primitives --
    def halo_exchange(self, x, halo: HaloSpec, deltas=None, impl=None, wire_format=None):
        """Exchange boundary rows: the ``[W*S, F]`` halo buffer. ``deltas``,
        ``impl`` and ``wire_format`` (the plan's ``halo_deltas``,
        :func:`~dgraph_tpu_torch.comm.collectives.resolve_plan_impl` and
        :func:`~dgraph_tpu_torch.comm.collectives.resolve_plan_wire_format`)
        pick the lowering and the payload codec; resolve once a call site.
        Without them the padded ``all_to_all`` runs with the fp32 identity
        wire (``communicator.py:65-82``)."""
        return collectives.halo_exchange(x, halo, self.group, deltas, impl,
                                         wire_format=wire_format)

    def gather(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.gather(x, plan, side, self.group)

    def gather_concat(self, x_src, x_dst, plan: EdgePlan):
        return collectives.gather_concat(x_src, x_dst, plan, self.group)

    def halo_extend(self, x, plan: EdgePlan, side: str = "src"):
        return collectives.halo_extend(x, plan, side, self.group)

    def local_take(self, x_full, plan: EdgePlan, side: str = "src"):
        return collectives.local_take(x_full, plan, side)

    def scatter(self, edata, plan: EdgePlan, side: str = "dst"):
        return collectives.scatter_sum(edata, plan, side, self.group)

    scatter_sum = scatter

    def scatter_bias_relu(self, edata, bias, plan: EdgePlan, side: str = "dst",
                          edge_weight=None):
        return collectives.scatter_bias_relu(edata, bias, plan, side, edge_weight, self.group)

    def put(self, send: torch.Tensor) -> torch.Tensor:
        """Deliver per-peer blocks (the reference's ``put``,
        communicator.py:169-191): block p of ``send`` ``[W, S, F]`` goes to
        rank p in one ``all_to_all``; rows ``[p*S, (p+1)*S)`` of the
        ``[W*S, F]`` result hold rank p's block."""
        from dgraph_tpu_torch.ops.p2p import all_to_all

        W, S, F = send.shape
        return all_to_all(send, self.group).reshape(W * S, F)

    def seq_attention(self, q, k, v, *, causal: bool = False, kv_mask=None,
                      impl: str = "ring"):
        raise NotImplementedError(
            "attention over a sequence sharded across ranks (ring, ulysses) is a later "
            "slice of the port")

    # -- reductions over the ranks --
    def all_reduce_sum(self, x):
        """Sum over the graph group."""
        return collectives.all_reduce_sum(x, self.group)

    def all_reduce_mean(self, x):
        """Mean over the graph group."""
        return collectives.all_reduce_sum(x, self.group) / self.group.world_size

    def replica_mean(self, x):
        """Mean over the replica axis (``x`` itself at one replica)."""
        return collectives.replica_mean(x, self.group)

    def grad_sync(self, params) -> None:
        """The DDP all-reduce of every gradient, in place: the sum over the
        graph group (each rank holds a slice of one sample's graph: its
        gradients are partial sums) and the mean over the replicas."""
        collectives.grad_sync(params, self.group)


class Communicator:
    """Constructor facade (communicator.py:305-330): ``single`` for one
    rank; ``nccl`` (one card a rank) or ``gloo`` (ranks that share a card,
    or the CPU when the caller asks for it) for a rank of a
    ``torch.distributed`` group."""

    SUPPORTED_BACKENDS = ("nccl", "gloo", "single")

    @staticmethod
    def init_process_group(backend: str = "single", *, rank: int = 0, world_size: int = 1,
                           init_method: str = "env://", device: Optional[str] = None,
                           timeout: float = 600.0, num_replicas: int = 1):
        """``device`` is the rank's device type: the card by default (the
        port's device rule; no card raises before any group is joined), or
        ``"cpu"`` for a gloo rank on the plain path. NCCL ranks are always
        on the card. ``world_size`` is the graph ranks W and
        ``num_replicas`` the replica groups R (the reference's
        ``replica_axis=``): ``rank`` is the global rank of R * W."""
        if backend == "single":
            return SingleComm()
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"Backend {backend!r} not supported; expected one of "
                             f"{Communicator.SUPPORTED_BACKENDS}")
        from dgraph_tpu_torch.comm.dist import init_group
        from dgraph_tpu_torch.config import default_device

        dev = default_device("cuda" if backend == "nccl" else device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"backend {backend!r} on the card, but no CUDA device is "
                               "available")
        return DistComm(init_group(rank, world_size, init_method, dev.type, timeout,
                                   backend=backend, num_replicas=num_replicas))
