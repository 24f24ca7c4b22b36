"""Micro-batching request queue: bounded depth, deadline, flush policy.

Counterpart of ``dgraph_tpu/serve/batcher.py`` without tenants. A forward
over the partitioned graph costs the same whether it gathers 3 target rows
or 300, so :class:`MicroBatcher` coalesces concurrent requests into one
padded engine call, with the safety properties an online queue needs:

- **bounded depth** — ``submit`` raises :class:`~dgraph_tpu_torch.serve.
  errors.QueueFull` once ``max_queue_depth`` requests wait;
- **bounded delay** — a batch flushes when ``max_batch_size`` requests are
  waiting, when the oldest waiting request has aged ``max_delay_ms``, or
  when the next request would overflow the largest bucket;
- **deadlines** — a request that ages past its timeout while queued is
  rejected with :class:`~dgraph_tpu_torch.serve.errors.RequestTimeout` and
  never runs.

One worker thread owns the engine (device work stays single-threaded);
clients get a ``concurrent.futures.Future`` resolving to the logits slice
or the structured error.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from dgraph_tpu_torch.obs.metrics import Metrics
from dgraph_tpu_torch.serve.errors import (
    EngineStopped,
    QueueFull,
    RequestTimeout,
    RequestTooLarge,
    WorkerCrashed,
)


@dataclasses.dataclass
class _Pending:
    ids: np.ndarray
    future: Future
    enqueued_at: float  # time.monotonic()
    deadline: float
    popped_at: float = 0.0  # when the worker pulled it off the queue


class MicroBatcher:
    """Groups concurrent requests into one padded :class:`~dgraph_tpu_torch.
    serve.engine.ServeEngine` call. See the module docstring for the flush
    and rejection semantics."""

    def __init__(
        self,
        engine,
        *,
        max_batch_size: int = 8,
        max_delay_ms: float = 2.0,
        max_queue_depth: int = 64,
        default_timeout_s: float = 30.0,
        registry: Optional[Metrics] = None,
    ):
        if max_batch_size < 1 or max_queue_depth < 1:
            raise ValueError("max_batch_size and max_queue_depth must be >= 1")
        self.engine = engine
        self.max_batch_size = int(max_batch_size)
        self.max_delay_ms = float(max_delay_ms)
        self.max_queue_depth = int(max_queue_depth)
        self.default_timeout_s = float(default_timeout_s)
        self.registry = registry if registry is not None else engine.registry
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._stopped = False
        # requests popped but not yet resolved: reachable by the crash
        # handler so a worker dying mid-batch still fails them
        self._inflight: list = []
        self._worker = threading.Thread(
            target=self._loop, name="serve-batcher", daemon=True
        )
        self._worker.start()

    def __len__(self) -> int:
        """Current queue depth (requests waiting, not in flight)."""
        with self._cv:
            return len(self._q)

    # --- client side ---

    def submit(self, node_ids, timeout_s: Optional[float] = None) -> Future:
        """Enqueue one request; returns a Future of the [n, C] logits.

        Raises (never queues past) :class:`QueueFull` at capacity,
        :class:`RequestTooLarge` for requests no bucket fits, ValueError for
        ids outside the graph, and :class:`EngineStopped` after :meth:`stop`.
        """
        ids = np.asarray(node_ids)
        if ids.ndim != 1:
            raise ValueError(f"node_ids must be 1-D, got shape {ids.shape}")
        # full validation up front: the worker concatenates requests, so an
        # impossible one must never reach the engine, where its failure
        # would fan out to every request coalesced with it
        try:
            self.engine.ladder.bucket_for(ids.shape[0])
        except RequestTooLarge:
            self.registry.counter("serve.rejected_too_large")
            raise
        num_nodes = self.engine.num_nodes
        if ids.size and (ids.min() < 0 or ids.max() >= num_nodes):
            raise ValueError(
                f"node ids must be in [0, {num_nodes}), got [{ids.min()}, {ids.max()}]"
            )
        now = time.monotonic()
        timeout_s = self.default_timeout_s if timeout_s is None else float(timeout_s)
        with self._cv:
            if self._stopped:
                raise EngineStopped("batcher is stopped")
            if len(self._q) >= self.max_queue_depth:
                self.registry.counter("serve.rejected_backpressure")
                raise QueueFull(
                    f"queue at capacity ({self.max_queue_depth} requests "
                    "waiting); retry with backoff",
                    queue_depth=len(self._q),
                    max_queue_depth=self.max_queue_depth,
                )
            fut: Future = Future()
            self._q.append(_Pending(ids, fut, now, now + timeout_s))
            self.registry.gauge("serve.queue_depth", float(len(self._q)))
            self._cv.notify()
        return fut

    def infer(self, node_ids, timeout_s: Optional[float] = None) -> np.ndarray:
        """Blocking submit: logits [n, C], or raises the structured error."""
        return self.submit(node_ids, timeout_s).result()

    @staticmethod
    def _fail_future(fut: Future, err: Exception) -> None:
        """Resolve ``fut`` with ``err`` unless the client already did."""
        try:
            fut.set_exception(err)
        except Exception:  # noqa: BLE001 — already resolved/cancelled: fine
            pass

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Stop the worker (it drains what is queued; anything unserved at
        join timeout fails with :class:`EngineStopped`). Idempotent."""
        with self._cv:
            self._stopped = True
            self._cv.notify_all()
        self._worker.join(timeout=join_timeout_s)
        with self._cv:
            leftover = list(self._q)
            self._q.clear()
            if self._worker.is_alive():
                # wedged inside a dispatch: its batch will never resolve
                leftover += self._inflight
                self._inflight = []
        for p in leftover:
            self._fail_future(p.future, EngineStopped("batcher stopped"))

    # --- worker side ---

    def _loop(self) -> None:
        # fault-contained: an unexpected exception fails every pending
        # future with WorkerCrashed instead of leaving them to hang
        try:
            while True:
                batch = self._collect()
                if batch is None:
                    return
                self._flush(batch)
                with self._cv:
                    self._inflight = []
        except BaseException as e:  # noqa: BLE001 — fail pending, then die
            self._worker_crashed(e)

    def _worker_crashed(self, exc: BaseException) -> None:
        err = WorkerCrashed(f"serve batcher worker crashed: {type(exc).__name__}: {exc}")
        with self._cv:
            self._stopped = True
            pending = list(self._inflight) + list(self._q)
            self._inflight = []
            self._q.clear()
            self._cv.notify_all()
        for p in pending:
            self._fail_future(p.future, err)
        self.registry.counter("serve.worker_crashed")
        print(f"[serve] {err} ({len(pending)} pending failed)", file=sys.stderr, flush=True)

    def _collect(self):
        """Block until a batch is ready per the flush policy; None = exit."""
        with self._cv:
            while not self._q:
                if self._stopped:
                    return None
                self._cv.wait(0.1)
            flush_at = self._q[0].enqueued_at + self.max_delay_ms / 1e3
            while len(self._q) < self.max_batch_size and not self._stopped:
                remaining = flush_at - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            batch = self._inflight = []
            total = 0
            cap = self.engine.ladder.max_size
            popped_at = time.monotonic()
            while self._q and len(batch) < self.max_batch_size:
                nxt = self._q[0]
                if batch and total + nxt.ids.shape[0] > cap:
                    break  # would overflow the largest bucket; next batch
                p = self._q.popleft()
                p.popped_at = popped_at
                batch.append(p)
                total += nxt.ids.shape[0]
            self.registry.gauge("serve.queue_depth", float(len(self._q)))
            return batch

    def _flush(self, batch) -> None:
        now = time.monotonic()
        live = []
        for p in batch:
            # claim the future atomically: a client-cancelled one is dropped
            if not p.future.set_running_or_notify_cancel():
                self.registry.counter("serve.rejected_cancelled")
                continue
            if now > p.deadline:
                self.registry.counter("serve.rejected_timeout")
                p.future.set_exception(RequestTimeout(
                    f"request expired after {now - p.enqueued_at:.3f}s in queue "
                    f"(timeout {p.deadline - p.enqueued_at:.3f}s)",
                    waited_s=round(now - p.enqueued_at, 4),
                ))
                continue
            live.append(p)
        if not live:
            return  # expired/cancelled-only batch: no engine call
        for p in live:
            self.registry.histogram("serve.stage.queue_wait_ms",
                                    (p.popped_at - p.enqueued_at) * 1e3)
        ids = np.concatenate([p.ids for p in live]) if len(live) > 1 else live[0].ids
        try:
            out = self.engine.infer(ids)
        except Exception as e:  # noqa: BLE001 — fan the failure to every waiter
            for p in live:
                p.future.set_exception(e)
            return
        off = 0
        for p in live:
            n = p.ids.shape[0]
            p.future.set_result(out[off : off + n])
            off += n
        done = time.monotonic()
        for p in live:
            self.registry.histogram("serve.request_ms", (done - p.enqueued_at) * 1e3)
        self.registry.counter("serve.batches")
        self.registry.histogram("serve.requests_per_batch", float(len(live)))
