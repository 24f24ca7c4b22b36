"""Multi-host launch: the counterpart of ``dgraph_tpu/comm/multihost.py``.

The reference joins a multi-controller JAX cluster
(``jax.distributed.initialize``) and builds one ``('replica', 'graph')``
mesh over every host's devices. Here every host runs the same program under
a launcher that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` (``torchrun``, or
``srun``/``mpirun`` with those set), one process a rank:
:func:`initialize_multihost` joins the default process group from them, and
:func:`make_pod_groups` builds this rank's
:class:`~dgraph_tpu_torch.comm.dist.RankGroup` of R replica groups of W
graph ranks over all of them.

Placement: global rank g is replica ``g // W``, graph rank ``g % W``, and a
launcher numbers a node's ranks contiguously, so the graph axis (a halo
exchange a layer: latency-bound) stays inside a node when W divides
``LOCAL_WORLD_SIZE``, and the replica axis (one gradient all-reduce a step)
crosses nodes. Otherwise a graph group spans nodes, as the reference's R = 1
pod mesh does.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from dgraph_tpu_torch.comm.dist import (
    DEFAULT_TIMEOUT_S, RankGroup, check_layout, join_world, make_groups, rank_device,
)


_device: Optional[torch.device] = None  # the rank's device, set when it joins


def _launcher_int(name: str, given: Optional[int]) -> int:
    if given is not None:
        return int(given)
    if name not in os.environ:
        raise RuntimeError(f"{name} is not set: start every rank through a launcher "
                           "(torchrun) or pass it")
    return int(os.environ[name])


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *, device: Optional[str] = None,
                         timeout: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group of every host's ranks (``env://``:
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``; the
    arguments override them, ``coordinator_address`` as ``host:port``).
    ``device`` is the rank's device type: the card unless ``"cpu"`` (no
    card raises before any group is joined); the card is ``LOCAL_RANK``'s.
    NCCL when every rank of the node has its card, else gloo. Idempotent:
    a process already in a group returns."""
    global _device
    from dgraph_tpu_torch.config import default_device

    dev_type = default_device(device).type
    if dist.is_initialized():
        if _device is None:
            _device = rank_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())), dev_type)
        return
    rank = _launcher_int("RANK", process_id)
    n = _launcher_int("WORLD_SIZE", num_processes)
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    else:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT") if k not in os.environ]
        if missing:
            raise RuntimeError(f"{' and '.join(missing)} not set: start every rank through "
                               "a launcher (torchrun) or pass coordinator_address")
        init_method = "env://"
    _device, _ = join_world(rank, n, init_method, dev_type, timeout)


def make_pod_groups(ranks_per_graph: Optional[int] = None, num_replicas: int = 1,
                    timeout: float = DEFAULT_TIMEOUT_S) -> RankGroup:
    """This rank's :class:`RankGroup` over every host's ranks (the
    reference's ``make_pod_mesh``): ``num_replicas`` replica groups of
    ``ranks_per_graph`` graph ranks (default ``WORLD_SIZE / num_replicas``),
    placed as the module docstring says. Every rank calls it, in the same
    order as its other group calls. Raises, before any group is created,
    when the two do not make the world."""
    if not dist.is_initialized() or _device is None:
        raise RuntimeError("call initialize_multihost() first")
    n = dist.get_world_size()
    if ranks_per_graph is None:
        ranks_per_graph = n // num_replicas
    check_layout(ranks_per_graph, num_replicas, n)
    return make_groups(ranks_per_graph, num_replicas, _device, dist.get_backend(), timeout)


def process_local_shards(world_size: int) -> list:
    """The graph shards this process materialises host-side (per-host data
    loading: the reference's per-rank dataset slicing,
    ``data/ogbn_datasets.py:135-148``): one process is one rank, so its own
    graph rank's shard, ``[RANK % world_size]``. At R = 1 this is the
    reference's ``index_of[d] * world_size // n`` for the process's one
    device. At R > 1 the reference's formula gives ``RANK // R``, which is
    not the rank's graph index on the row-major mesh; this function does not
    follow it there."""
    rank = dist.get_rank() if dist.is_initialized() else _launcher_int("RANK", None)
    n = dist.get_world_size() if dist.is_initialized() else _launcher_int("WORLD_SIZE", None)
    if world_size < 1 or n % world_size:
        raise ValueError(f"a graph of {world_size} ranks does not divide {n} ranks")
    return [rank % world_size]


def process_local_plan_shards(plan_dir: str, *, ranks: Optional[list] = None,
                              verify: bool = True) -> tuple:
    """``(plan, ranks)`` holding only this process's ranks' shards of a
    sharded plan artifact (:mod:`dgraph_tpu_torch.plan_shards`, written by
    ``plan.build_plan_shards`` or ``train.checkpoint.cached_edge_plan``):
    each process reads, verifies (size and SHA-256 a shard) and stacks just
    the shards it needs, never the O(E) layout sidecar. ``ranks`` defaults
    to :func:`process_local_shards` of the manifest's world. The plan's
    leading axis is ``len(ranks)`` (``EdgePlan.ranks``; ``plan.shard(r)``
    takes a global rank) while its statics describe the whole world.

    Raises :class:`~dgraph_tpu_torch.plan_shards.PlanManifestError` or
    :class:`~dgraph_tpu_torch.plan_shards.PlanShardError` on an integrity
    failure and never rebuilds: processes rebuilding one artifact would
    race; rebuild it on one process (``cached_edge_plan``) instead."""
    from dgraph_tpu_torch import plan_shards as ps
    from dgraph_tpu_torch.plan import load_sharded_plan

    manifest = ps.read_manifest(plan_dir)
    if ranks is None:
        ranks = process_local_shards(int(manifest["world_size"]))
    plan, _ = load_sharded_plan(plan_dir, ranks=ranks, verify=verify, load_layout=False)
    return plan, list(ranks)
