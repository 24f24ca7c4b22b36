"""Online inference engine: graph + model -> per-bucket forward on the card.

Counterpart of ``dgraph_tpu/serve/engine.py``. A request's target-node ids
(the caller's ORIGINAL vertex numbering) are padded to a bucket of the
:class:`~dgraph_tpu_torch.serve.bucketing.BucketLadder`; the engine runs one
full forward over the partitioned graph under ``torch.inference_mode()`` and
gathers the requested ``(rank, slot)`` rows. Warmup runs every bucket once.

PyTorch runs eagerly, so there is no compile to count (the reference's
recompile counter has no counterpart); one CUDA graph per bucket is later
work, as are checkpoint restore, ``swap_params`` and ``append_vertices``.
This slice serves one rank (world size 1).
"""

from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from dgraph_tpu_torch.config import default_device
from dgraph_tpu_torch.obs.metrics import Metrics
from dgraph_tpu_torch.serve.bucketing import BucketLadder, pad_ids
from dgraph_tpu_torch.serve.errors import QueueFull, ServeError
from dgraph_tpu_torch.train.loop import model_apply


class ServeEngine:
    """Forward-only serving over one partitioned graph.

    Construction moves the model, plan and vertex data to ``device``
    (``cuda`` unless the caller names another; raises with no card);
    :meth:`warmup` runs every bucket; :meth:`infer` is the hot path. One
    engine per (graph, model) pair, shared by the micro-batcher's worker.
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
        self.device = default_device(device)
        if plan.world_size != 1:
            raise NotImplementedError(
                f"serving a {plan.world_size}-rank plan is slice 9 of the port (the "
                "multi-rank communicator runs, for training); build the graph with "
                "world_size=1"
            )
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
        self.model = model.to(self.device).eval()
        self._plan = plan.to(self.device).shard(0)
        self._batch = {k: v.to(self.device)[0] for k, v in batch.items()}
        self._id_rank = np.asarray(id_rank, np.int64)
        self._id_slot = np.asarray(id_slot, np.int64)
        if self._id_rank.shape != self._id_slot.shape:
            raise ValueError("id_rank / id_slot length mismatch")
        self.num_nodes = int(self._id_rank.shape[0])
        self.forwards = 0  # full-graph forwards run so far
        self.last_stage_ms: dict = {}
        self.warmup_s: Optional[float] = None

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

    # --- forward ---

    def _logits(self) -> torch.Tensor:
        """Full-graph logits ``[W, n_pad, C]`` on the device."""
        with torch.inference_mode():
            out = model_apply(self.model, self._batch, self._plan)[None]
        self.forwards += 1
        return out

    def _run_bucket(self, rank_idx: torch.Tensor, slot_idx: torch.Tensor) -> np.ndarray:
        """One bucket: full forward, then the ``[bucket]`` row gather."""
        with torch.inference_mode():
            rows = self._logits()[rank_idx, slot_idx]
        return rows.cpu().numpy()

    # --- hot path ---

    def infer(self, node_ids, _record: bool = True) -> np.ndarray:
        """Logits ``[n, num_classes]`` for ``node_ids`` (original numbering).

        Pads to the request's bucket, runs it, and slices the padding off.
        Raises :class:`~dgraph_tpu_torch.serve.errors.RequestTooLarge` past
        the ladder and ValueError on out-of-range ids. A failed forward is
        retried ``max_retries`` times; ``degrade_after`` consecutive failed
        requests flip the engine into DEGRADED mode, where every request is
        shed with :class:`QueueFull` until :meth:`reset_degraded`.
        """
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
        rank_idx = torch.from_numpy(self._id_rank[padded]).to(self.device)
        slot_idx = torch.from_numpy(self._id_slot[padded]).to(self.device)
        pad_ms = (time.perf_counter() - t0) * 1e3
        t_infer = time.perf_counter()
        last_err = None
        for attempt in range(self.max_retries + 1):
            try:
                out = self._run_bucket(rank_idx, slot_idx)[:n]
                break
            except ServeError:  # structured rejections are never transient
                raise
            except Exception as e:  # noqa: BLE001 — a failed device forward
                last_err = e
                if attempt < self.max_retries:
                    self.registry.counter("serve.infer_retries")
                    time.sleep(self.retry_backoff_s)
        else:
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
        """``[W, n_pad, C]`` logits for the whole graph — the oracle the
        bucketed path is checked against bit-for-bit."""
        with torch.inference_mode():
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
