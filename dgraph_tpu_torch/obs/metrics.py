"""Host-side metrics registry — a copy of ``dgraph_tpu/obs/metrics.py``'s
``Metrics`` (without the JAX step-metrics pytree).

Counters, gauges and histograms with quantile snapshots; one lock, so the
serve batcher's worker thread and client threads can share a registry.
"""

from __future__ import annotations

import random
import threading

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
