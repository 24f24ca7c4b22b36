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

:meth:`ServeEngine.from_checkpoint` restores the parameters from a
checkpoint directory (``train.checkpoint``; over W ranks global rank 0
resolves the step and every rank restores that step) and records it in
``lineage``, against whose ``ckpt_dir`` :meth:`ServeEngine.swap_params`
resolves bare step numbers. A swap (:mod:`~dgraph_tpu_torch.serve.rollover`)
validates a new checkpoint through the live module and adopts it by
``copy_`` into the live tensors, so every parameter keeps its
``data_ptr()``: the torch meaning of the reference's zero-recompile pin
(what a CUDA graph a bucket would capture is what a swap writes). PyTorch
runs eagerly, so there is no compile to count and the reference's
``recompile`` rejection has no counterpart; one CUDA graph per bucket is
later work. Over W ranks rank 0 announces a swap (the header op ``SWAP``)
as it announces a dispatch, so every rank's parameters change between the
same two dispatches.

**Live graph deltas** (:mod:`~dgraph_tpu_torch.serve.deltas`). The engine
owns its vertex data (a copy of the caller's). :meth:`ServeEngine.
append_vertices` writes new vertices into the reserved pad slots above
each rank's real rows, in place (``index_copy_`` into ``x``,
``index_fill_`` into ``vmask``) under the dispatch lock, so a batch sees
the whole old graph or the whole new one and every tensor keeps its
``data_ptr()``; the reference flips to new arrays instead. No plan tensor
is touched (the CSR offset caches stay valid) and no shape changes: an
appended vertex is served at once, as an isolated vertex until a
re-planned generation is adopted. Over W ranks rank 0 checks the width and
the pad budget, places the vertices (the reference's waterfill over its
global slot occupancy) and announces them (``APPEND``); every rank writes
the rows it owns, one all-reduce says every rank wrote, and only then do
the id maps grow. Adopting a generation builds a new engine on it
(:func:`~dgraph_tpu_torch.serve.deltas.build_engine`); over W ranks rank 0
announces the build on the serving engine (``ADOPT``), so that every rank
builds the new engine at the same point, and a follower then follows it in
a thread of its own until rank 0 stops it. A failure after an
announcement is a :class:`RankLost`, as for a dispatch.

**Several engines over one set of ranks** (a :class:`~dgraph_tpu_torch.
serve.registry.ModelRegistry` flipping between them): every engine of a
process shares one dispatch lock, so two engines' dispatches never
interleave their collectives on any rank; a follower runs each engine's
:meth:`ServeEngine.follow` in a thread of its own (:func:`follow_all`),
which takes that lock only once a header has arrived.
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
STOP, BUCKET, FULL, SWAP, APPEND, ADOPT = 0, 1, 2, 3, 4, 5
# the ops whose header is followed by a pickled payload
PAYLOAD_OPS = (SWAP, APPEND, ADOPT)
# one dispatch at a time in this process (a rank), whatever the engine: two
# engines over the same ranks share the rank's process groups and device,
# so their dispatches' collectives must never interleave
_RANK_DISPATCH_LOCK = threading.Lock()


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
        open_control: bool = True,
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
        # one dispatch at a time on this rank, shared by every engine of the
        # process: over W ranks two dispatches whose collectives interleaved
        # would deadlock or mix halos
        self._dispatch_lock = _RANK_DISPATCH_LOCK
        # called on every rank before each attempt's forward; an exception
        # from it fails that attempt on every rank (a fault injection point)
        self.pre_forward: Optional[Callable[[], None]] = None
        # called on every rank of a swap between its restore and its
        # validation; an exception from it rolls the swap back on every rank
        self.pre_swap: Optional[Callable[[], None]] = None
        self._stopped = False
        self._lost: Optional[str] = None  # why the ranks can run no dispatch
        self.model = model.to(self.device).eval()
        self._plan = (plan if plan.per_rank else plan.shard(self.rank)).to(self.device)
        # a rank-subset plan (deltas.build_engine over W ranks) comes with
        # its ranks' rows of the batch only
        row = self.rank if plan.ranks is None else list(plan.ranks).index(self.rank)
        # a copy of our own (.to would hand back the caller's CPU tensor):
        # append_vertices writes into it in place
        self._batch = {k: v[row].to(self.device, copy=True) for k, v in batch.items()}
        self._id_rank = np.asarray(id_rank, np.int64)
        self._id_slot = np.asarray(id_slot, np.int64)
        if self._id_rank.shape != self._id_slot.shape:
            raise ValueError("id_rank / id_slot length mismatch")
        self.num_nodes = int(self._id_rank.shape[0])
        # real vertices a rank: the pad slots above them are the append
        # budget until the next adopted generation
        self._slot_fill = np.bincount(self._id_rank, minlength=W).astype(np.int64)
        # the adopted graph generation (deltas.build_engine stamps it)
        self.generation: Optional[int] = None
        # a follower's engines of later generations (ADOPT), each followed
        # in a thread: [(engine, thread, {"error": its exception, if any})]
        self._successors: list = []
        self.forwards = 0  # full-graph forwards this rank ran so far
        self.last_stage_ms: dict = {}
        self.warmup_s: Optional[float] = None
        # the checkpoint the parameters came from (from_checkpoint), the
        # step served now (a swap moves it), and the record of each attempt
        self.ckpt_dir: Optional[str] = None
        self.restored_step: Optional[int] = None
        self.serving_step: Optional[int] = None
        self.lineage: list = []
        self.last_swap_s: dict = {}  # the last swap's seconds a stage
        self._ctrl = None
        if open_control:
            self._open_control()

    def _open_control(self) -> None:
        """The engine's gloo control group over its W ranks (none at one
        rank). Collective: every rank opens it at the same point, and no
        other group may be made meanwhile. ``open_control=False`` defers it
        to an adoption, which first agrees that every rank built its
        engine."""
        if self.world_size > 1:
            self._ctrl = dist.new_group(
                [self.group.global_peer(r) for r in range(self.world_size)],
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

    @classmethod
    def from_checkpoint(cls, model, g, ckpt_dir: str, *, step: Optional[int] = None,
                        template=None, **kwargs) -> "ServeEngine":
        """Restore the parameters from ``ckpt_dir`` (the newest readable
        step, corrupt steps falling back older; a named ``step`` strictly)
        into ``model`` and build the engine (:meth:`from_distributed_graph`).
        The checkpoint may be a bare ``state_dict`` or a train state with a
        ``'params'`` entry; ``template`` checks it as
        :func:`~dgraph_tpu_torch.train.checkpoint.restore_checkpoint` does.
        Over W ranks every rank calls it at the same point: global rank 0
        resolves the step and every rank restores that one
        (:func:`~dgraph_tpu_torch.train.checkpoint.restore_agreed`)."""
        from dgraph_tpu_torch.train.checkpoint import restore_agreed

        state, s = restore_agreed(ckpt_dir, template, model_comm(model).group, step=step)
        if state is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir!r}")
        params = state["params"] if isinstance(state, dict) and "params" in state else state
        model.load_state_dict(params)
        eng = cls.from_distributed_graph(model, g, **kwargs)
        # the lineage root: swap_params(step=...) resolves bare step numbers
        # against this directory
        eng.ckpt_dir, eng.restored_step = ckpt_dir, s
        eng.serving_step = s
        saved = state.get("step") if isinstance(state, dict) else None
        eng.lineage.append({
            "kind": "serve_rollover",
            "event": "restore",
            "ckpt_dir": ckpt_dir,
            "step": int(step) if step is not None else int(s if saved is None else saved),
            "adopted": True,
        })
        return eng

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

    def _forward(self, params: Optional[dict] = None) -> torch.Tensor:
        """This rank's full-graph logits ``[n_pad, C]`` on the device, with
        the live parameters or, for a swap's validation, with ``params`` (a
        state dict on the device) through ``torch.func.functional_call``:
        the live tensors are not touched."""
        model = self.model if params is None else (
            lambda *args: torch.func.functional_call(self.model, params, args))
        with torch.inference_mode():
            out = model_apply(model, self._batch, self._plan)
        self.forwards += 1
        return out

    def _bucket_rows(self, slot_idx: torch.Tensor, params: Optional[dict] = None):
        """A bucket's rows of this rank: the full forward, then its
        ``slot_idx`` rows (the served path, swap validation included)."""
        return self._forward(params)[slot_idx]

    def _run_bucket(self, rank_idx: np.ndarray, slot_idx: np.ndarray) -> np.ndarray:
        """One attempt of one bucket: the full forward, then the
        ``[bucket]`` row gather."""
        if self.world_size > 1:
            return self._dispatch(BUCKET, np.stack([rank_idx, slot_idx]))
        with self._dispatch_lock, self._on_device():
            if self.pre_forward is not None:
                self.pre_forward()
            return self._bucket_rows(torch.from_numpy(slot_idx).to(self.device)).cpu().numpy()

    def _dispatch(self, op: int, idx: Optional[np.ndarray] = None):
        """Rank 0's dispatch over W ranks: announce, then :meth:`_attempt`."""
        with self._dispatch_lock, self._on_device():
            self._announce(op, idx)
            return self._attempt(op, idx)

    def _announce(self, op: int, idx: Optional[np.ndarray] = None, payload=None) -> None:
        """Rank 0, the dispatch lock held: the header ``[op, rows]`` on the
        control group, then a bucket's padded ``(rank_idx, slot_idx)`` or
        the payload of a swap (:mod:`~dgraph_tpu_torch.serve.rollover`), an
        append or an adoption."""
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
            if op in PAYLOAD_OPS:
                dist.broadcast_object_list([payload], self._src, group=self._ctrl)
        except Exception as e:  # noqa: BLE001 — a peer is gone
            raise self._lose("announcing a dispatch", e) from e

    def _receive(self) -> tuple:
        """A follower's side of :meth:`_announce`: ``(op, idx, payload)``."""
        head = torch.empty(2, dtype=torch.int64)
        dist.broadcast(head, self._src, group=self._ctrl)
        op, rows = head.tolist()
        idx = payload = None
        if rows:
            t = torch.empty(2, rows, dtype=torch.int64)
            dist.broadcast(t, self._src, group=self._ctrl)
            idx = t.numpy()
        if op in PAYLOAD_OPS:
            box = [None]
            dist.broadcast_object_list(box, self._src, group=self._ctrl)
            payload = box[0]
        return op, idx, payload

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
            rows = (self._bucket_rows(torch.from_numpy(idx[1]).to(self.device))
                    if op == BUCKET else self._forward()).cpu()
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
        failed = self._agree("the pre-forward agreement", err is not None)
        if failed and self.rank == 0:
            raise err if err is not None else RuntimeError(
                f"rank(s) {failed} failed their pre-forward check; the attempt was dropped "
                "on every rank")
        return bool(failed)

    def _agree(self, what: str, failed_here: bool) -> list:
        """The ranks that failed a check every rank ran: one all-reduce over
        ``host_pg`` (this rank alone at one rank)."""
        if self.world_size == 1:
            return [0] if failed_here else []
        flags = torch.zeros(self.world_size, dtype=torch.int32)
        flags[self.rank] = int(failed_here)
        try:
            dist.all_reduce(flags, group=self.group.host_pg)
        except Exception as e:  # noqa: BLE001 — a peer is gone
            raise self._lose(what, e) from e
        return flags.nonzero().flatten().tolist()

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

    def swap_params(self, source=None, *, step: Optional[int] = None, params=None,
                    parity_ids=None) -> dict:
        """Hot-swap to a new checkpoint: restore, validate through the live
        module with the new tensors, then adopt (``copy_`` into the live
        tensors, every ``data_ptr()`` kept) or roll back. ``source`` is a
        checkpoint directory (``step`` picks a step, default the newest
        readable), defaulting to :attr:`ckpt_dir`; or pass ``params``, a
        state dict. A rejection raises :class:`~dgraph_tpu_torch.serve.
        errors.SwapRejected` with the prior parameters still serving; every
        attempt lands one record in :attr:`lineage`. Over W ranks every rank
        adopts or every rank rolls back. Rank 0's only; see
        :func:`dgraph_tpu_torch.serve.rollover.swap_params`."""
        from dgraph_tpu_torch.serve.rollover import swap_params

        return swap_params(self, source, step=step, params=params, parity_ids=parity_ids)

    # --- live graph deltas ---

    def free_pad_slots(self) -> int:
        """Reserved pad capacity left for live vertex appends before a
        re-planned generation must be adopted (``serve.deltas.replan``); 0
        when the batch has no ``x`` to append into."""
        if self._batch.get("x") is None:
            return 0
        fill = self._slot_fill
        return int((self._batch["x"].shape[0] - fill).sum())

    def append_vertices(self, features) -> np.ndarray:
        """Write new vertices into reserved pad slots, live; returns their
        ids (original numbering), ``num_nodes .. num_nodes + k``.

        They are served at once: their features enter ``x`` and their
        vertex mask turns 1 in place, under the dispatch lock (a batch sees
        the whole old graph or the whole new one), and then the id maps
        grow. No shape changes and no plan tensor is touched. Edges of the
        appended vertices are not live until a re-planned generation is
        adopted (:mod:`~dgraph_tpu_torch.serve.deltas`): until then an
        appended vertex aggregates nothing, as an isolated vertex. Raises
        ValueError when the pad budget is spent (the signal to re-plan).
        Over W ranks see the module docstring (``APPEND``). Rank 0's only."""
        from dgraph_tpu_torch.serve.deltas import assign_new_vertices

        self._check_front("append_vertices")
        with self._dispatch_lock, self._on_device():
            x = self._batch.get("x")
            if x is None:
                raise ValueError("engine batch has no 'x' leaf to append into")
            feats = np.asarray(features, np.float32)
            if feats.ndim != 2 or feats.shape[1] != x.shape[1]:
                raise ValueError(f"features must be [k, {x.shape[1]}], got {feats.shape}")
            k = int(feats.shape[0])
            if k > self.free_pad_slots():
                raise ValueError(
                    f"{k} new vertices exceed the {self.free_pad_slots()} free pad slots; "
                    "adopt a re-planned generation first (serve.deltas.replan)")
            # the waterfill serve.deltas.replan replays, so adoption never
            # moves a vertex already served from a pad slot
            fill = self._slot_fill.copy()
            new_rank = assign_new_vertices(fill, k)
            new_slot = np.empty(k, np.int64)
            for i, r in enumerate(new_rank):
                new_slot[i] = self._slot_fill[r] + np.count_nonzero(new_rank[:i] == r)
            ids = np.arange(self.num_nodes, self.num_nodes + k, dtype=np.int64)
            if self.world_size > 1:
                self._announce(APPEND, payload={"rank": new_rank, "slot": new_slot,
                                                "features": feats})
            self._append_on_rank(new_rank, new_slot, feats)
        self.registry.counter("serve.vertices_appended", float(k))
        return ids

    def _append_on_rank(self, new_rank, new_slot, feats) -> None:
        """One rank's side of an append (the dispatch lock held): write the
        rows it owns in place, agree that every rank wrote, grow the id
        maps. A failure over W ranks is a :class:`RankLost`: the ranks may
        hold different graphs now."""
        err = None
        try:
            mine = np.asarray(new_rank) == self.rank
            if mine.any():
                rows = torch.from_numpy(np.asarray(new_slot, np.int64)[mine]).to(self.device)
                x = self._batch["x"]
                x.index_copy_(0, rows, torch.from_numpy(feats[mine]).to(self.device, x.dtype))
                vmask = self._batch.get("vmask")
                if vmask is not None:
                    vmask.index_fill_(0, rows, 1.0)
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
        except Exception as e:  # noqa: BLE001 — agreed below (raised at one rank)
            if self.world_size == 1:
                raise
            err = e
        failed = self._agree("the append agreement", err is not None)
        if failed:
            raise self._lose("an append", err or RuntimeError(
                f"rank(s) {failed} failed to write their appended rows"))
        self._id_rank = np.concatenate([self._id_rank, np.asarray(new_rank, np.int64)])
        self._id_slot = np.concatenate([self._id_slot, np.asarray(new_slot, np.int64)])
        self._slot_fill = self._slot_fill + np.bincount(new_rank,
                                                        minlength=self.world_size)
        # last: a request that passes the id range check sees the grown maps
        self.num_nodes += len(new_rank)

    def _adopt_generation(self, run_dir: str, *, add_symmetric_norm: bool, verify: bool,
                          **engine_kwargs) -> "ServeEngine":
        """Rank 0 of W ranks (:func:`~dgraph_tpu_torch.serve.deltas.
        build_engine` with ``adopt_from=self``): announce the adopted
        generation, then build its engine on every rank at once, under the
        dispatch lock. This engine keeps serving until the caller stops
        it."""
        from dgraph_tpu_torch.serve.deltas import read_world

        self._check_front("adopting a generation")
        payload = {"run_dir": run_dir, "generation": int(read_world(run_dir)["generation"]),
                   "add_symmetric_norm": bool(add_symmetric_norm), "verify": bool(verify)}
        kwargs = dict({"device": self.device, "ladder": self.ladder}, **engine_kwargs)
        with self._dispatch_lock, self._on_device():
            self._announce(ADOPT, payload=payload)
            return self._adopt_on_rank(payload, kwargs)

    def _adopt_on_rank(self, payload: dict, engine_kwargs: dict) -> Optional["ServeEngine"]:
        """One rank's side of an adoption (the dispatch lock held): load
        its shard of the announced generation and build its engine on this
        engine's module, agree that every rank did, then open the new
        engine's control group (collective). A generation some rank could
        not load is dropped on every rank: rank 0 raises
        :class:`~dgraph_tpu_torch.serve.deltas.DeltaError`, a follower
        returns None."""
        from dgraph_tpu_torch.serve.deltas import DeltaError, engine_inputs

        gen, err, eng = int(payload["generation"]), None, None
        try:
            info = engine_inputs(payload["run_dir"], ranks=[self.rank], generation=gen,
                                 add_symmetric_norm=payload["add_symmetric_norm"],
                                 verify=payload["verify"])
            eng = ServeEngine(self.model, info["plan"], info["batch"], info["id_rank"],
                              info["id_slot"], open_control=False, **engine_kwargs)
        except Exception as e:  # noqa: BLE001 — agreed below, before any group is made
            err = f"{type(e).__name__}: {e}"
        failed = self._agree("the adoption's load agreement", err is not None)
        if failed:
            if self.rank != 0:
                return None
            raise DeltaError(f"generation {gen} could not be loaded on rank(s) {failed}"
                             f"{': ' + err if err else ''}; the serving engine stays")
        try:
            eng._open_control()
        except Exception as e:  # noqa: BLE001 — the ranks may be out of step now
            raise self._lose("opening the adopted generation's control group", e) from e
        eng.generation = gen
        return eng

    def full_logits(self) -> np.ndarray:
        """``[W, n_pad, C]`` logits for the whole graph (over W ranks every
        rank's shard, gathered on rank 0) — the oracle the bucketed path is
        checked against bit-for-bit. Rank 0's only."""
        self._check_front("full_logits")
        if self.world_size > 1:
            return self._dispatch(FULL)
        with self._dispatch_lock, self._on_device():
            return self._forward()[None].cpu().numpy()

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
        """Ranks 1..W-1: run every dispatch rank 0 announces (a swap, an
        append and an adoption too), until it announces stop. Returns the
        dispatches run. The dispatch lock is taken only once a header has
        arrived, so another engine's follower thread runs its dispatches
        meanwhile (:func:`follow_all`). An adopted generation's engine is
        followed in a thread of its own, which this call waits for after
        its stop: it returns once every engine it started is stopped. A
        :class:`RankLost` propagates: this rank's part of the group is
        gone."""
        from dgraph_tpu_torch.serve.rollover import follow_swap

        if self.rank == 0:
            raise RuntimeError("rank 0 is the front: it dispatches; follow() is for ranks "
                               "1..W-1")
        n = 0
        while True:
            with self._on_device():
                op, idx, payload = self._receive()
                if op == STOP:
                    break
                with self._dispatch_lock:
                    if op == SWAP:
                        follow_swap(self, payload)
                    elif op == APPEND:
                        self._append_on_rank(payload["rank"], payload["slot"],
                                             payload["features"])
                    elif op == ADOPT:
                        self._follow_successor(self._adopt_on_rank(payload, {
                            "device": self.device, "ladder": self.ladder,
                            "registry": self.registry}))
                    else:
                        self._attempt(op, idx)
            n += 1
        with self._dispatch_lock:
            self._close()
        for _, thread, _ in self._successors:
            thread.join()
        err = next((box["error"] for *_, box in self._successors if "error" in box), None)
        if err is not None:
            raise err
        return n

    def _follow_successor(self, engine: Optional["ServeEngine"]) -> None:
        """A follower: follow an adopted generation's engine in a thread of
        its own (nothing when the adoption was dropped)."""
        if engine is None:
            return
        box: dict = {}

        def run():
            try:
                engine.follow()
            except BaseException as e:  # noqa: BLE001 — raised by follow() after the join
                box["error"] = e

        thread = threading.Thread(target=run, name=f"serve-follow-g{engine.generation}")
        thread.start()
        self._successors.append((engine, thread, box))

    @property
    def successors(self) -> list:
        """A follower's engines of the generations adopted while it followed
        this one."""
        return [e for e, _, _ in self._successors]

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


def follow_all(*engines) -> list:
    """Ranks 1..W-1 of several engines over the same ranks (a registry on
    rank 0 flipping between them): each engine's :meth:`ServeEngine.follow`
    in a thread of its own, until rank 0 stops every engine. Returns each
    engine's dispatches; raises the first error once every thread ended."""
    counts, errors = [None] * len(engines), []

    def run(i, engine):
        try:
            counts[i] = engine.follow()
        except BaseException as e:  # noqa: BLE001 — raised below, on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, e), name=f"serve-follow-{i}")
               for i, e in enumerate(engines)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return counts
