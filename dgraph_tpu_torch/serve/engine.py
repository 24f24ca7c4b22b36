"""Online inference engine: graph + model -> per-bucket forward on the card.

Counterpart of ``dgraph_tpu/serve/engine.py``. A request's target-node ids
(the caller's ORIGINAL vertex numbering) are padded to a bucket of the
:class:`~dgraph_tpu_torch.serve.bucketing.BucketLadder`; the engine runs one
full forward over the partitioned graph under ``torch.inference_mode()`` and
gathers the requested ``(rank, slot)`` rows. Warmup runs every bucket once.
The forward is ``train.loop.model_apply``, the call training and evaluation
run, so serving cannot drift from them.

**Over W graph ranks** (a model built on a :class:`~dgraph_tpu_torch.comm.
DistComm`, ranks started by :func:`~dgraph_tpu_torch.comm.dist.launch`) a
rank is a process holding its own plan and batch shard on its own device.
The reference runs its W ranks as one program (``shard_map``, then the row
gather ``full(...)[rank_idx, slot_idx]``, ``engine.py:210-245``); here
global rank 0 is the FRONT, the only rank with a caller (``infer``,
``full_logits``, ``warmup``, ``stop``; the batcher lives there), and ranks
1..W-1 run :meth:`ServeEngine.follow`. One dispatch:

1. rank 0 announces it on a gloo control group of the engine's own (a
   header: bucket, full logits or stop, and its row count; for a bucket the
   padded ``(rank_idx, slot_idx)``, so the id map lives on rank 0 alone);
2. for a bucket, every rank runs its pre-forward check (:attr:`pre_forward`,
   the counterpart of the reference's ``chaos.fire("serve.infer")``), and
   one all-reduce over ``host_pg`` tells every rank which ranks failed it:
   if any did, every rank drops the attempt before the forward's first
   collective, and rank 0 retries it as the reference retries
   (``max_retries``, then ``degrade_after``, ``engine.py:325-373``);
3. the forward, then each rank's rows ``logits[slot_idx]`` (a full logits:
   its ``[n_pad, C]`` shard) go to rank 0 in one gather over ``host_pg``,
   and rank 0 takes row i from rank ``rank_idx[i]``: a selection, never a
   sum, so the served rows are ``full_logits()``'s bits.

A failure from step 3 on (a rank lost mid-forward, a collective that timed
out) leaves the ranks in different places of the forward: the request
fails with :class:`RankLost` without a retry, and so does every later
dispatch, without touching the group (the degrade window then sheds load).
A rank that exits fails the request as soon as its sockets close; one that
hangs holds it for the group timeout at most (``launch``'s
``group_timeout``: the CLI's ``request_timeout_s``). Followers wait for the
next announcement on the control group, whose timeout is
:data:`CONTROL_TIMEOUT`. Serving runs on the graph axis only, as the
reference's serving mesh (``make_graph_mesh(ranks_per_graph=world)``,
``dgraph_tpu/serve/__main__.py:88``): a replica layout raises.

PyTorch runs eagerly, so there is no compile to count (the reference's
recompile counter has no counterpart); one CUDA graph per bucket is later
work, as are checkpoint restore, ``swap_params`` and ``append_vertices``.
"""

from __future__ import annotations

import contextlib
import datetime
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dgraph_tpu_torch.comm import SingleComm, collectives
from dgraph_tpu_torch.config import default_device
from dgraph_tpu_torch.obs.metrics import Metrics
from dgraph_tpu_torch.serve.bucketing import BucketLadder, pad_ids
from dgraph_tpu_torch.serve.errors import EngineStopped, QueueFull, ServeError
from dgraph_tpu_torch.train.loop import model_apply

# how long a follower waits for rank 0's next announcement: as long as
# serving lasts (rank 0's exit closes the group at once)
CONTROL_TIMEOUT = datetime.timedelta(days=7)
# the ops a header announces
STOP, BUCKET, FULL = 0, 1, 2


class RankLost(RuntimeError):
    """A multi-rank dispatch failed once the ranks had begun its forward
    (or its announcement): the ranks may stand in different collectives,
    so the engine runs no further dispatch."""


def model_comm(model: torch.nn.Module):
    """The communicator the model's layers were built on (one rank's
    :class:`SingleComm` when none holds one)."""
    return next((m.comm for m in model.modules() if getattr(m, "comm", None) is not None),
                SingleComm())


class ServeEngine:
    """Forward-only serving over one partitioned graph.

    Construction moves the model, this rank's plan shard and its vertex
    data to ``device`` (the rank's card over W ranks; else ``cuda`` unless
    the caller names another; raises with no card); :meth:`warmup` runs
    every bucket; :meth:`infer` is the hot path. One engine per (graph,
    model) pair on each rank, shared on rank 0 by the micro-batcher's
    worker and the caller's thread (a dispatch lock serializes them).
    """

    def __init__(
        self,
        model: torch.nn.Module,
        plan,
        batch: dict,
        id_rank: np.ndarray,
        id_slot: np.ndarray,
        *,
        device=None,
        ladder: Optional[BucketLadder] = None,
        registry: Optional[Metrics] = None,
        max_retries: int = 2,
        degrade_after: int = 3,
        retry_backoff_s: float = 0.05,
    ):
        comm = model_comm(model)
        group = comm.group
        W = comm.get_world_size()
        if plan.world_size != W:
            raise ValueError(
                f"a plan of {plan.world_size} ranks needs a communicator of as many ranks; "
                f"the model's has {W} (build the model on DistComm(group) in each rank that "
                "dgraph_tpu_torch.comm.dist.launch starts)")
        if group is not None and group.num_replicas != 1:
            raise ValueError(
                f"serving runs on the graph axis only, as the reference's serving mesh "
                f"(make_graph_mesh(ranks_per_graph=world)); got {group.num_replicas} replica "
                "groups: launch the ranks with num_replicas=1")
        self.group, self.world_size = group, W
        self.rank = comm.get_rank()
        if device is None and group is not None:
            device = group.device
        self.device = default_device(device)
        self.ladder = ladder or BucketLadder.geometric()
        self.registry = registry if registry is not None else Metrics()
        # self-healing knobs: a failed forward is retried up to max_retries
        # times per request; after degrade_after CONSECUTIVE requests
        # exhaust their retries the engine sheds every request as QueueFull
        # until reset_degraded()
        self.max_retries = int(max_retries)
        self.degrade_after = int(degrade_after)
        self.retry_backoff_s = float(retry_backoff_s)
        self.degraded = False
        self._consecutive_failures = 0
        # bumped by reset_degraded: a request dispatched before a reset
        # must not count toward the fresh degrade window
        self._failure_epoch = 0
        self._lock = threading.RLock()
        # one dispatch at a time on this rank: over W ranks two dispatches
        # whose collectives interleaved would deadlock or mix halos
        self._dispatch_lock = threading.Lock()
        # called on every rank before each attempt's forward; an exception
        # from it fails that attempt on every rank (a fault injection point)
        self.pre_forward: Optional[Callable[[], None]] = None
        self._stopped = False
        self._lost: Optional[str] = None  # why the ranks can run no dispatch
        self.model = model.to(self.device).eval()
        self._plan = (plan if plan.per_rank else plan.shard(self.rank)).to(self.device)
        self._batch = {k: v[self.rank].to(self.device) for k, v in batch.items()}
        self._id_rank = np.asarray(id_rank, np.int64)
        self._id_slot = np.asarray(id_slot, np.int64)
        if self._id_rank.shape != self._id_slot.shape:
            raise ValueError("id_rank / id_slot length mismatch")
        self.num_nodes = int(self._id_rank.shape[0])
        self.forwards = 0  # full-graph forwards this rank ran so far
        self.last_stage_ms: dict = {}
        self.warmup_s: Optional[float] = None
        self._ctrl = None
        if W > 1:  # collective: every rank builds its engine at this point
            self._ctrl = dist.new_group([group.global_peer(r) for r in range(W)],
                                        backend="gloo", timeout=CONTROL_TIMEOUT)

    @classmethod
    def from_distributed_graph(cls, model, g, **kwargs) -> "ServeEngine":
        """Wire an engine from a :class:`~dgraph_tpu_torch.data.graph.
        DistributedGraph`: forward-only batch (features, vertex mask,
        optional edge weights) and the original-id -> (rank, slot) map."""
        rank, slot = g.id_map()
        batch = {"x": g.features, "vmask": g.vertex_mask}
        if g.edge_weight is not None:
            batch["edge_weight"] = g.edge_weight
        return cls(model, g.plan, batch, rank, slot, **kwargs)

    @property
    def halo_impl(self) -> str:
        """The halo lowering this engine's forward resolves ('none' at one
        rank)."""
        return collectives.resolve_plan_impl(self._plan, self.group)

    def _check_front(self, what: str) -> None:
        if self.rank != 0:
            raise RuntimeError(f"{what} is rank 0's; rank {self.rank} runs follow()")

    def _on_device(self):
        # a new thread's current card is not the rank's
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    # --- forward ---

    def _logits(self) -> torch.Tensor:
        """Full-graph logits ``[W, n_pad, C]`` on the device (one rank)."""
        with torch.inference_mode():
            out = model_apply(self.model, self._batch, self._plan)[None]
        self.forwards += 1
        return out

    def _run_bucket(self, rank_idx: np.ndarray, slot_idx: np.ndarray) -> np.ndarray:
        """One attempt of one bucket: the full forward, then the
        ``[bucket]`` row gather."""
        if self.world_size > 1:
            return self._dispatch(BUCKET, np.stack([rank_idx, slot_idx]))
        with self._dispatch_lock, self._on_device(), torch.inference_mode():
            if self.pre_forward is not None:
                self.pre_forward()
            rows = self._logits()[torch.from_numpy(rank_idx).to(self.device),
                                  torch.from_numpy(slot_idx).to(self.device)]
            return rows.cpu().numpy()

    def _dispatch(self, op: int, idx: Optional[np.ndarray] = None):
        """Rank 0's dispatch over W ranks: announce, then :meth:`_attempt`."""
        with self._dispatch_lock, self._on_device():
            if self._stopped:
                raise EngineStopped("engine stopped")
            if self._lost is not None:
                raise RankLost(f"the ranks can run no dispatch: {self._lost}")
            try:
                n = 0 if idx is None else idx.shape[1]
                dist.broadcast(torch.tensor([op, n], dtype=torch.int64), self._src,
                               group=self._ctrl)
                if n:
                    dist.broadcast(torch.from_numpy(np.ascontiguousarray(idx, np.int64)),
                                   self._src, group=self._ctrl)
            except Exception as e:  # noqa: BLE001 — a peer is gone
                raise self._lose("announcing a dispatch", e) from e
            return self._attempt(op, idx)

    @property
    def _src(self) -> int:
        return self.group.global_peer(0)

    def _attempt(self, op: int, idx: Optional[np.ndarray]):
        """One announced dispatch on this rank (rank 0 and followers alike):
        for a bucket the agreed pre-forward check, then the forward and the
        gather to rank 0. Rank 0 returns the rows; followers None."""
        if op == BUCKET and self._agree_pre_forward():
            return None  # a follower: the attempt was dropped on every rank
        try:
            with torch.inference_mode():
                logits = model_apply(self.model, self._batch, self._plan)
                self.forwards += 1
                if op == BUCKET:
                    logits = logits[torch.from_numpy(idx[1]).to(self.device)]
                rows = logits.cpu()
            parts = ([torch.empty_like(rows) for _ in range(self.world_size)]
                     if self.rank == 0 else None)
            dist.gather(rows, parts, dst=self._src, group=self.group.host_pg)
        except Exception as e:  # noqa: BLE001 — the ranks may be out of step now
            raise self._lose("the forward", e) from e
        if self.rank != 0:
            return None
        out = torch.stack(parts).numpy()
        return out[idx[0], np.arange(idx.shape[1])] if op == BUCKET else out

    def _agree_pre_forward(self) -> bool:
        """Run :attr:`pre_forward` and tell every rank who failed it. On a
        failure every rank drops the attempt: rank 0 raises the fault,
        which :meth:`infer` retries, and a follower returns True."""
        err = None
        try:
            if self.pre_forward is not None:
                self.pre_forward()
        except Exception as e:  # noqa: BLE001 — agreed below, before any collective
            err = e
        flags = torch.zeros(self.world_size, dtype=torch.int32)
        flags[self.rank] = int(err is not None)
        try:
            dist.all_reduce(flags, group=self.group.host_pg)
        except Exception as e:  # noqa: BLE001 — a peer is gone
            raise self._lose("the pre-forward agreement", e) from e
        failed = flags.nonzero().flatten().tolist()
        if failed and self.rank == 0:
            raise err if err is not None else RuntimeError(
                f"rank(s) {failed} failed their pre-forward check; the attempt was dropped "
                "on every rank")
        return bool(failed)

    def _lose(self, where: str, err: Exception) -> RankLost:
        self._lost = f"{where} failed on rank {self.rank}: {type(err).__name__}: {err}"
        return RankLost(self._lost)

    # --- hot path ---

    def infer(self, node_ids, _record: bool = True) -> np.ndarray:
        """Logits ``[n, num_classes]`` for ``node_ids`` (original numbering).

        Pads to the request's bucket, runs it, and slices the padding off.
        Raises :class:`~dgraph_tpu_torch.serve.errors.RequestTooLarge` past
        the ladder and ValueError on out-of-range ids. A failed forward is
        retried ``max_retries`` times (over W ranks only a fault before the
        forward, which every rank agreed on; a :class:`RankLost` fails at
        once); ``degrade_after`` consecutive failed requests flip the
        engine into DEGRADED mode, where every request is shed with
        :class:`QueueFull` until :meth:`reset_degraded`. Rank 0's only.
        """
        self._check_front("infer")
        ids = np.asarray(node_ids)
        if ids.ndim != 1:
            raise ValueError(f"node_ids must be 1-D, got shape {ids.shape}")
        with self._lock:
            degraded = self.degraded
            consecutive = self._consecutive_failures
            epoch = self._failure_epoch
        if ids.size and (ids.min() < 0 or ids.max() >= self.num_nodes):
            raise ValueError(
                f"node ids must be in [0, {self.num_nodes}), got "
                f"[{ids.min()}, {ids.max()}]"
            )
        if degraded:
            self.registry.counter("serve.shed_degraded")
            raise QueueFull(
                "engine degraded after repeated device failures; shedding "
                "load (reset_degraded() to re-admit)",
                degraded=True,
                consecutive_failures=consecutive,
            )
        t0 = time.perf_counter()
        bucket = self.ladder.bucket_for(ids.shape[0])
        padded, n = pad_ids(ids, bucket)
        rank_idx, slot_idx = self._id_rank[padded], self._id_slot[padded]
        pad_ms = (time.perf_counter() - t0) * 1e3
        t_infer = time.perf_counter()
        out = last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                out = self._run_bucket(rank_idx, slot_idx)[:n]
                last_err = None
                break
            except ServeError:  # structured rejections are never transient
                raise
            except Exception as e:  # noqa: BLE001 — a failed device forward
                last_err = e
                if isinstance(e, RankLost) or attempt == self.max_retries:
                    break
                self.registry.counter("serve.infer_retries")
                time.sleep(self.retry_backoff_s)
        if last_err is not None:
            with self._lock:
                degraded_now = False
                if epoch == self._failure_epoch:
                    self._consecutive_failures += 1
                    if (self._consecutive_failures >= self.degrade_after
                            and not self.degraded):
                        self.degraded = degraded_now = True
            self.registry.counter("serve.infer_failures")
            if degraded_now:
                self.registry.gauge("serve.degraded", 1.0)
            raise last_err
        with self._lock:
            if epoch == self._failure_epoch:
                self._consecutive_failures = 0
        infer_ms = (time.perf_counter() - t_infer) * 1e3
        self.last_stage_ms = {"pad": pad_ms, "infer": infer_ms}
        if _record:
            reg = self.registry
            reg.counter("serve.infer_calls")
            reg.histogram("serve.infer_ms", (time.perf_counter() - t0) * 1e3)
            reg.histogram(f"serve.bucket.{bucket}.infer_ms", infer_ms)
            reg.histogram("serve.stage.pad_ms", pad_ms)
            reg.histogram("serve.stage.infer_ms", infer_ms)
            reg.histogram("serve.batch_occupancy", n / bucket)
        return out

    def reset_degraded(self) -> None:
        """Re-admit traffic after a degraded period (an operator's explicit
        decision). Requests dispatched before the reset report their
        failures into the old epoch and cannot re-degrade the engine."""
        with self._lock:
            self._failure_epoch += 1
            self.degraded = False
            self._consecutive_failures = 0
        self.registry.gauge("serve.degraded", 0.0)

    def rank_slot(self, node_ids) -> tuple:
        """(rank, slot) arrays for original vertex ids — their row addresses
        in any ``[W, n_pad, ...]`` tensor such as :meth:`full_logits`."""
        ids = np.asarray(node_ids)
        return self._id_rank[ids], self._id_slot[ids]

    def full_logits(self) -> np.ndarray:
        """``[W, n_pad, C]`` logits for the whole graph (over W ranks every
        rank's shard, gathered on rank 0) — the oracle the bucketed path is
        checked against bit-for-bit. Rank 0's only."""
        self._check_front("full_logits")
        if self.world_size > 1:
            return self._dispatch(FULL)
        with self._dispatch_lock, self._on_device(), torch.inference_mode():
            return self._logits().cpu().numpy()

    def warmup(self) -> dict:
        """Run every bucket once (and the full-logits forward), so the first
        request of each size pays no one-off cost (kernel build, allocator
        growth, library autotuning). Returns a summary record."""
        t0 = time.perf_counter()
        for b in self.ladder.sizes:
            self.infer(np.zeros(b, np.int64), _record=False)
        self.full_logits()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.warmup_s = round(time.perf_counter() - t0, 3)
        self.registry.gauge("serve.warmup_s", self.warmup_s)
        return {
            "kind": "serve_warmup",
            "buckets": [int(b) for b in self.ladder.sizes],
            "warmup_s": self.warmup_s,
            "device": str(self.device),
        }

    # --- ranks 1..W-1 ---

    def follow(self) -> int:
        """Ranks 1..W-1: run every dispatch rank 0 announces, until it
        announces stop. Returns the dispatches run. A :class:`RankLost`
        propagates: this rank's part of the group is gone."""
        if self.rank == 0:
            raise RuntimeError("rank 0 is the front: it dispatches; follow() is for ranks "
                               "1..W-1")
        n = 0
        while True:
            with self._dispatch_lock, self._on_device():
                head = torch.empty(2, dtype=torch.int64)
                dist.broadcast(head, self._src, group=self._ctrl)
                op, rows = head.tolist()
                if op == STOP:
                    break
                idx = None
                if rows:
                    t = torch.empty(2, rows, dtype=torch.int64)
                    dist.broadcast(t, self._src, group=self._ctrl)
                    idx = t.numpy()
                self._attempt(op, idx)
            n += 1
        with self._dispatch_lock:
            self._close()
        return n

    def stop(self) -> None:
        """Rank 0: announce stop, so that every follower leaves
        :meth:`follow` (not after a :class:`RankLost`: the followers are gone
        or out of step). Later dispatches raise ``EngineStopped``.
        Idempotent."""
        self._check_front("stop")
        with self._dispatch_lock:
            if self._stopped:
                return
            self._stopped = True
            if self._ctrl is None or self._lost is not None:
                return
            dist.broadcast(torch.tensor([STOP, 0], dtype=torch.int64), self._src,
                           group=self._ctrl)
            self._close()

    def _close(self) -> None:
        if self._ctrl is not None:
            dist.destroy_process_group(self._ctrl)
            self._ctrl = None
