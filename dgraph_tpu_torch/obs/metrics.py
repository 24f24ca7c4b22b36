"""Runtime metrics — counterpart of ``dgraph_tpu/obs/metrics.py``.

- :class:`Metrics`: the host-side registry of counters, gauges and
  histograms with quantile snapshots; one lock, so the serve batcher's
  worker thread and client threads can share a registry.
- :class:`StepMetrics` and :func:`step_record`: what a train step returns
  (``train.loop.make_train_step(step_metrics=True)``) and the one JSONL
  record per step built from it, in the reference's schema.
"""

from __future__ import annotations

import dataclasses
import random
import threading
from typing import Any, Optional

STEP_SCHEMA_VERSION = 1

# fields serialized into / parsed out of a step record, in schema order;
# nonfinite_skipped (0.0/1.0) is set only by guarded steps
_STEP_FIELDS = ("loss", "accuracy", "grad_norm", "mask_count",
                "nonfinite_skipped")


@dataclasses.dataclass
class StepMetrics:
    """One train step's metrics: tensors (or floats) that stay on the
    device until :meth:`record` reads them. Unset fields (None) are left
    out of the record."""

    loss: Any = None
    accuracy: Any = None
    grad_norm: Any = None
    mask_count: Any = None
    nonfinite_skipped: Any = None

    # dict-style access, so call sites written against the metrics dict
    # (``m["loss"]``) take a StepMetrics unchanged
    def __getitem__(self, key: str):
        if key not in _STEP_FIELDS:
            raise KeyError(key)
        return getattr(self, key)

    def record(self, **extra) -> dict:
        """One JSONL-ready dict: floats only, schema-stamped. ``extra``
        carries host-side context (step index, wall_ms...)."""
        out = {"kind": "step", "schema": STEP_SCHEMA_VERSION}
        for name in _STEP_FIELDS:
            v = getattr(self, name)
            if v is not None:
                out[name] = float(v)
        out.update(extra)
        return out

    @classmethod
    def from_record(cls, rec: dict) -> "StepMetrics":
        """Inverse of :meth:`record` (extras are dropped)."""
        if rec.get("kind") != "step":
            raise ValueError(f"not a step record: kind={rec.get('kind')!r}")
        return cls(**{k: rec[k] for k in _STEP_FIELDS if k in rec})


def step_record(metrics, *, step: int, wall_ms: Optional[float] = None, **extra) -> dict:
    """The step record from a :class:`StepMetrics` or a metrics dict, so a
    loop logs one schema whichever form its step returns."""
    if not isinstance(metrics, StepMetrics):
        metrics = StepMetrics(**{k: metrics[k] for k in _STEP_FIELDS if k in metrics})
    if wall_ms is not None:
        extra["wall_ms"] = round(float(wall_ms), 3)
    return metrics.record(step=int(step), **extra)

# quantiles every histogram snapshot reports: the serving SLO trio
DEFAULT_QUANTILES = (0.5, 0.95, 0.99)


def _q_label(q: float) -> str:
    """0.5 -> 'p50', 0.95 -> 'p95', 0.999 -> 'p99.9'."""
    return "p" + format(q * 100, "g")


class _Histogram:
    """Bounded-memory histogram: count/mean/min/max exact; quantiles from a
    fixed-size uniform reservoir (deterministic seed), exact until
    ``MAX_SAMPLES`` observations."""

    MAX_SAMPLES = 4096

    __slots__ = ("count", "total", "vmin", "vmax", "values", "_rng")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")
        self.values: list = []
        self._rng = random.Random(0x5EED)

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.vmin = v if v < self.vmin else self.vmin
        self.vmax = v if v > self.vmax else self.vmax
        if len(self.values) < self.MAX_SAMPLES:
            self.values.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < self.MAX_SAMPLES:
                self.values[j] = v

    def quantile(self, q: float) -> float:
        """Empirical quantile, linear interpolation (numpy's default)."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        if not self.values:
            raise ValueError("quantile of an empty histogram")
        s = sorted(self.values)
        pos = q * (len(s) - 1)
        lo = int(pos)
        frac = pos - lo
        if frac == 0.0:
            return s[lo]
        return s[lo] + (s[lo + 1] - s[lo]) * frac

    def snapshot(self, quantiles: tuple = DEFAULT_QUANTILES) -> dict:
        if not self.count:
            return {"count": 0}
        out = {
            "count": self.count,
            "mean": self.total / self.count,
            "min": self.vmin,
            "max": self.vmax,
        }
        for q in quantiles:
            out[_q_label(q)] = self.quantile(q)
        return out


class Metrics:
    """Host-side metrics registry; snapshot() is JSON-ready."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    def counter(self, name: str, inc: float = 1.0) -> float:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + float(inc)
            return self._counters[name]

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def histogram(self, name: str, value: float) -> None:
        with self._lock:
            self._histograms.setdefault(name, _Histogram()).observe(value)

    def quantile(self, name: str, q: float) -> float:
        """Quantile of a recorded histogram (KeyError if never observed)."""
        with self._lock:
            return self._histograms[name].quantile(q)

    def snapshot(self, quantiles: tuple = DEFAULT_QUANTILES) -> dict:
        with self._lock:
            return {
                "counters": dict(self._counters),
                "gauges": dict(self._gauges),
                "histograms": {
                    k: h.snapshot(quantiles) for k, h in self._histograms.items()
                },
            }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
