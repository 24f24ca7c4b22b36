"""Process groups and the rank launcher: the counterpart of
``dgraph_tpu/comm/mesh.py``.

The reference runs W ranks as one SPMD program over a mesh axis. Here each
rank is a process, and :class:`RankGroup` is what a rank's code holds in
place of the axis name: its rank, the world size, its device and two
process groups:

- ``pg`` carries the collectives: NCCL when every rank has a card of its
  own, gloo when ranks share a card (NCCL refuses two ranks on one device)
  and on the CPU;
- ``host_pg`` is always gloo: host barriers, the exchange of Python
  objects (the CUDA IPC handles of ``ops.p2p``) and, on a shared card, the
  two-sided lowerings, whose CUDA tensors gloo cannot move: they are copied
  to the host and back (:meth:`RankGroup.staged`).

:func:`launch` runs ``fn(group, *args)`` on W ranks. Under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) it joins that group and runs this rank
only; otherwise it spawns W processes (start method ``spawn``) that meet
through a ``FileStore`` in a temporary directory, so concurrent launches
never collide on a TCP port. A rank that raises ends the whole launch with
its traceback; a launch that outlives ``timeout`` is killed.
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
    """One rank's view of the process group (see the module docstring)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str  # of pg: "nccl" or "gloo"
    pg: object
    host_pg: object

    def staged(self, t: torch.Tensor) -> bool:
        """True when ``t`` must go through the host to cross ranks: a CUDA
        tensor on a gloo group (ranks sharing one card)."""
        return self.backend == "gloo" and t.device.type == "cuda"

    def barrier(self) -> None:
        """Host barrier over the ranks (gloo)."""
        dist.barrier(group=self.host_pg)

    def all_gather_object(self, obj) -> list:
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
    """``cuda:{rank % device_count}`` for a CUDA run, else the CPU."""
    if device_type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("device 'cuda' asked for but no CUDA device is available")
        return torch.device("cuda", rank % n)
    if device_type != "cpu":
        raise ValueError(f"device type must be 'cuda' or 'cpu', got {device_type!r}")
    return torch.device("cpu")


def init_group(rank: int, world_size: int, init_method: str, device_type: str,
               timeout: float = DEFAULT_TIMEOUT_S, backend: str = "") -> RankGroup:
    """Join the default process group as ``rank`` and build the
    :class:`RankGroup`. ``backend`` "" picks NCCL when every rank has its
    own card, else gloo."""
    device = rank_device(rank, device_type)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not backend:
        nccl = device.type == "cuda" and torch.cuda.device_count() >= world_size
        backend = "nccl" if nccl else "gloo"
    td = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=td)
    pg = dist.group.WORLD
    host_pg = dist.new_group(backend="gloo", timeout=td) if backend == "nccl" else pg
    return RankGroup(rank=rank, world_size=world_size, device=device, backend=backend,
                     pg=pg, host_pg=host_pg)


def _rank_entry(rank, world_size, tmp, fn, args, device_type, timeout, threads):
    """A spawned rank: join the group, run ``fn``, leave its result (or its
    traceback) in ``tmp``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        group = init_group(rank, world_size, f"file://{tmp}/store", device_type, timeout)
        out = fn(group, *args)
        group.barrier()
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


def launch(fn: Callable, world_size: int, *args, device: str = "cuda",
           timeout: Optional[float] = None, threads: int = 0) -> list:
    """Run ``fn(group, *args)`` on ``world_size`` ranks and return the
    ranks' results in rank order (under ``torchrun``: this rank's only).
    ``fn`` and ``args`` must pickle (``fn`` a module-level function);
    ``threads`` > 0 sets each rank's ``torch.set_num_threads``. Raises
    ``RuntimeError`` with the traceback of a rank that failed and
    ``TimeoutError`` when the ranks outlive ``timeout`` seconds (None: no
    deadline; a collective that waits longer than the group's timeout,
    ``min(timeout, DEFAULT_TIMEOUT_S)``, fails its rank either way)."""
    import multiprocessing as mp

    pg_timeout = min(timeout or DEFAULT_TIMEOUT_S, DEFAULT_TIMEOUT_S)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank, w = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        if w != world_size:
            raise ValueError(f"torchrun started {w} ranks, the run asks for {world_size}")
        group = init_group(rank, w, "env://", device, pg_timeout)
        try:
            return [fn(group, *args)]
        finally:
            dist.destroy_process_group()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="dgraph_ranks_") as tmp:
        procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                             args=(r, world_size, tmp, fn, args, device, pg_timeout, threads))
                 for r in range(world_size)]
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
                    raise RuntimeError(f"rank {r} of {world_size} failed:\n{why}")
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks still running after {timeout} s")
                procs[codes.index(None)].join(0.05)
        finally:
            _stop(procs)
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"result.{r}"), "rb") as f:
                out.append(pickle.load(f))
        return out
