"""Process groups and the rank launcher: the counterpart of
``dgraph_tpu/comm/mesh.py``.

The reference runs one SPMD program over a ``('replica', 'graph')`` mesh
(``make_graph_mesh(ranks_per_graph, num_replicas)``). Here each rank is a
process, and :class:`RankGroup` is what a rank's code holds in place of
the two axis names. R replica groups of W graph ranks make R * W processes;
global rank g is replica ``g // W``, graph rank ``g % W`` (the mesh's
row-major order), so a graph group is W contiguous ranks and, under
``torchrun``, sits on one node when W divides the node's ranks.

:class:`RankGroup`'s ``rank``, ``world_size``, ``pg`` and ``host_pg`` are
the GRAPH axis, so every graph collective runs as it does at R = 1:

- ``pg`` carries the collectives: NCCL when every rank has a card of its
  own, gloo when ranks share a card (NCCL refuses two ranks on one device)
  and on the CPU;
- ``host_pg`` is always gloo: host barriers, the exchange of Python
  objects (the CUDA IPC handles of ``ops.p2p``) and, on a shared card, the
  two-sided lowerings, whose CUDA tensors gloo cannot move: they are copied
  to the host and back (:meth:`RankGroup.staged`).

The replica axis adds ``replica``, ``num_replicas``, ``replica_pg`` (the
R ranks of this graph rank, one in each replica group: the gradient mean)
and ``world_pg`` (all R * W ranks). A send or receive names its peer by
global rank (:meth:`RankGroup.global_peer`). At R = 1 the groups are the
default group and, over NCCL, one gloo group, as before the replica axis.
Every rank creates every group in one order (``new_group`` is collective
over the whole world).

:func:`launch` runs ``fn(group, *args)`` on R * W ranks. Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) it joins that group and runs this rank
only; otherwise it starts the processes, which meet through a ``FileStore``
in a temporary directory, so concurrent launches never collide on a TCP
port. The processes fork from a server that imported torch once (start
method ``forkserver``, torch preloaded): a rank then skips the import, the
bulk of its start-up. CUDA is never initialised in the server. Each rank
takes the launcher's environment as it is at the launch (the server's is
the one it started with) and reads the ``config`` flags from it again. A
rank that raises ends the whole launch with its traceback; a launch that
outlives ``timeout`` is killed.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

_logger = logging.getLogger(__name__)

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class RankGroup:
    """One rank's view of the process groups (see the module docstring):
    ``rank``, ``world_size``, ``pg`` and ``host_pg`` are the graph axis."""

    rank: int
    world_size: int
    device: torch.device
    backend: str  # of pg, replica_pg and world_pg: "nccl" or "gloo"
    pg: object
    host_pg: object
    replica: int = 0
    num_replicas: int = 1
    replica_pg: object = None  # None at R = 1
    world_pg: object = None  # pg at R = 1
    world_host_pg: object = None  # host_pg at R = 1

    @property
    def global_rank(self) -> int:
        return self.replica * self.world_size + self.rank

    def global_peer(self, peer: int) -> int:
        """The global rank of graph rank ``peer`` of this replica group:
        what a send or receive names (torch reads ``peer`` as a global
        rank, whatever the group)."""
        return self.replica * self.world_size + peer

    def staged(self, t: torch.Tensor) -> bool:
        """True when ``t`` must go through the host to cross ranks: a CUDA
        tensor on a gloo group (ranks sharing one card)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def barrier(self) -> None:
        """Host barrier over the graph group (gloo)."""
        dist.barrier(group=self.host_pg)

    def world_barrier(self) -> None:
        """Host barrier over all R * W ranks (gloo)."""
        dist.barrier(group=self.world_host_pg or self.host_pg)

    def all_gather_object(self, obj) -> list:
        """``obj`` of every rank of the graph group, in graph-rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.host_pg)
        return out


_staged_logged: set = set()


def log_staged_once(what: str) -> None:
    """Say once per process which two-sided collective goes through the
    host on this group (a shared card's gloo group)."""
    if what not in _staged_logged:
        _staged_logged.add(what)
        _logger.warning("%s: gloo moves no CUDA tensors; the payload is copied to "
                        "the host and back (ranks share a card)", what)


def rank_device(rank: int, device_type: str) -> torch.device:
    """``cuda:{rank % device_count}`` for a CUDA run, else the CPU. ``rank``
    is the rank on its node (``LOCAL_RANK`` under ``torchrun``)."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device 'cuda' asked for but no CUDA device is available")
        return torch.device("cuda", rank % n)
    if device_type != "cpu":
        raise ValueError(f"device type must be 'cuda' or 'cpu', got {device_type!r}")
    return torch.device("cpu")


def check_layout(ranks_per_graph: int, num_replicas: int, n: int) -> None:
    """Raise unless R * W ranks make the world of ``n`` (the reference's
    ``make_graph_mesh`` message)."""
    if ranks_per_graph < 1 or num_replicas < 1 or ranks_per_graph * num_replicas != n:
        raise ValueError(f"ranks_per_graph ({ranks_per_graph}) x num_replicas "
                         f"({num_replicas}) != {n}")


def join_world(rank: int, n: int, init_method: str, device_type: str,
               timeout: float = DEFAULT_TIMEOUT_S, backend: str = "") -> tuple:
    """Bind this rank's card (``LOCAL_RANK``'s under ``torchrun``) and join
    the default process group of ``n`` ranks as global rank ``rank``.
    ``backend`` "" picks NCCL when every rank of the node has its own card,
    else gloo. Returns (device, backend)."""
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} is outside a world of {n} ranks")
    device = rank_device(int(os.environ.get("LOCAL_RANK", rank)), device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not backend:
        on_node = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        nccl = device.type == "cuda" and torch.cuda.device_count() >= on_node
        backend = "nccl" if nccl else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    return device, backend


def init_group(rank: int, world_size: int, init_method: str, device_type: str,
               timeout: float = DEFAULT_TIMEOUT_S, backend: str = "",
               num_replicas: int = 1) -> RankGroup:
    """Join the default process group of ``world_size * num_replicas``
    ranks as global rank ``rank`` (:func:`join_world`) and build the
    :class:`RankGroup` of W = ``world_size`` graph ranks."""
    n = world_size * num_replicas
    check_layout(world_size, num_replicas, n)
    device, backend = join_world(rank, n, init_method, device_type, timeout, backend)
    return make_groups(world_size, num_replicas, device, backend, timeout)


def make_groups(world_size: int, num_replicas: int, device: torch.device, backend: str,
                timeout: float = DEFAULT_TIMEOUT_S) -> RankGroup:
    """This rank's :class:`RankGroup` over the joined default group: W =
    ``world_size`` graph ranks in each of ``num_replicas`` replica groups.
    Every rank creates every group in the same order: the gloo world group
    (over NCCL), each replica group's graph group (and its gloo twin over
    NCCL), then the W strided groups of the replica axis. At R = 1 only the
    first, as before the replica axis."""
    n, g = dist.get_world_size(), dist.get_rank()
    check_layout(world_size, num_replicas, n)
    td = datetime.timedelta(seconds=timeout)
    world = dist.group.WORLD
    world_host = dist.new_group(backend="gloo", timeout=td) if backend == "nccl" else world
    if num_replicas == 1:
        return RankGroup(rank=g, world_size=world_size, device=device, backend=backend,
                         pg=world, host_pg=world_host, world_pg=world,
                         world_host_pg=world_host)
    replica, rank = divmod(g, world_size)
    pg = host_pg = replica_pg = None
    for r in range(num_replicas):
        ranks = list(range(r * world_size, (r + 1) * world_size))
        p = dist.new_group(ranks, timeout=td, backend=backend)
        h = dist.new_group(ranks, timeout=td, backend="gloo") if backend == "nccl" else p
        if r == replica:
            pg, host_pg = p, h
    for j in range(world_size):
        p = dist.new_group(list(range(j, n, world_size)), timeout=td, backend=backend)
        if j == rank:
            replica_pg = p
    if pg is None or replica_pg is None:
        raise RuntimeError(f"rank {g} found no graph or replica group of its own")
    return RankGroup(rank=rank, world_size=world_size, device=device, backend=backend, pg=pg,
                     host_pg=host_pg, replica=replica, num_replicas=num_replicas,
                     replica_pg=replica_pg, world_pg=world, world_host_pg=world_host)


def _take_environment(env: dict) -> None:
    """Make ``env`` this process's environment and read the ``config``
    flags from it again."""
    import importlib

    from dgraph_tpu_torch import config

    os.environ.clear()
    os.environ.update(env)
    importlib.reload(config)


def _rank_entry(rank, world_size, tmp, fn, args, device_type, timeout, threads, env,
                num_replicas=1):
    """A started rank: take the launcher's environment, join the groups,
    run ``fn``, leave its result (or its traceback) in ``tmp``."""
    try:
        _take_environment(env)
        if threads:
            torch.set_num_threads(threads)
        group = init_group(rank, world_size, f"file://{tmp}/store", device_type, timeout,
                           num_replicas=num_replicas)
        out = fn(group, *args)
        group.world_barrier()
        path = os.path.join(tmp, f"result.{rank}")
        with open(path + ".part", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".part", path)
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"error.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        sys.stderr.flush()
        # the other ranks may sit in a collective with this one: leave at
        # once and let the launcher end them
        os._exit(1)


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join()


def launch(fn: Callable, world_size: int, *args, num_replicas: int = 1, device: str = "cuda",
           timeout: Optional[float] = None, threads: int = 0) -> list:
    """Run ``fn(group, *args)`` on ``num_replicas`` replica groups of
    ``world_size`` graph ranks each and return the ranks' results in global
    rank order (under ``torchrun``, whose ``WORLD_SIZE`` must be R * W:
    this rank's only). ``fn`` and ``args`` must pickle (``fn`` a
    module-level function); ``threads`` > 0 sets each rank's
    ``torch.set_num_threads``. Raises ``RuntimeError`` with the traceback of
    a rank that failed and ``TimeoutError`` when the ranks outlive
    ``timeout`` seconds (None: no deadline; a collective that waits longer
    than the group's timeout, ``min(timeout, DEFAULT_TIMEOUT_S)``, fails its
    rank either way)."""
    import multiprocessing as mp

    n = world_size * num_replicas
    check_layout(world_size, num_replicas, n)
    pg_timeout = min(timeout or DEFAULT_TIMEOUT_S, DEFAULT_TIMEOUT_S)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, w = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if w != n:
            raise ValueError(f"torchrun started {w} ranks, the run asks for {n} "
                             f"({num_replicas} x {world_size})")
        group = init_group(rank, world_size, "env://", device, pg_timeout,
                           num_replicas=num_replicas)
        try:
            return [fn(group, *args)]
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(["torch"])
    env = dict(os.environ)
    with tempfile.TemporaryDirectory(prefix="dgraph_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                             args=(r, world_size, tmp, fn, args, device, pg_timeout, threads,
                                   env, num_replicas))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout if timeout else float("inf")
        try:
            while True:
                codes = [p.exitcode for p in procs]
                failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if failed:
                    # the first traceback written is the cause; the others
                    # are usually its peers losing their connection to it
                    errs = {r: os.path.join(tmp, f"error.{r}") for r in failed}
                    r = min(failed, key=lambda r: os.path.getmtime(errs[r])
                            if os.path.exists(errs[r]) else float("inf"))
                    why = (open(errs[r]).read() if os.path.exists(errs[r])
                           else f"exit code {codes[r]}")
                    raise RuntimeError(f"rank {r} of {n} failed:\n{why}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks still running after {timeout} s")
                procs[codes.index(None)].join(0.05)
        finally:
            _stop(procs)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"result.{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out
