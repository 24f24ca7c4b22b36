"""Shape-bucketed request padding — a copy of ``dgraph_tpu/serve/bucketing.py``.

Target-node counts are rounded up a small geometric ladder of bucket sizes,
every bucket is run once ahead of time (``ServeEngine.warmup``), and the
hot path only ever sees those shapes. In the reference each bucket is one
compiled XLA executable; here it is one warmed eager forward, and later one
CUDA graph. Padding waste is bounded by the ladder's growth factor, and the
``serve.batch_occupancy`` histogram measures what the ladder costs.
"""

from __future__ import annotations

import bisect
import dataclasses
import math

import numpy as np

from dgraph_tpu_torch.serve.errors import RequestTooLarge


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Ascending tuple of target-node-count bucket sizes.

    One warmed forward exists per size, so the ladder should stay small —
    a geometric ladder covers a 128x dynamic range in 8 buckets at growth
    2.0.
    """

    sizes: tuple

    def __post_init__(self):
        if not self.sizes:
            raise ValueError("BucketLadder needs at least one size")
        if any(s <= 0 for s in self.sizes):
            raise ValueError(f"bucket sizes must be positive: {self.sizes}")
        if any(b <= a for a, b in zip(self.sizes, self.sizes[1:])):
            raise ValueError(f"bucket sizes must be strictly ascending: {self.sizes}")

    @classmethod
    def geometric(
        cls, min_size: int = 8, max_size: int = 1024, growth: float = 2.0
    ) -> "BucketLadder":
        """min_size, ~min_size*growth, ... capped at exactly max_size."""
        if growth <= 1.0:
            raise ValueError(f"growth must be > 1.0, got {growth}")
        if max_size < min_size:
            raise ValueError(f"max_size {max_size} < min_size {min_size}")
        sizes, s = [], min_size
        while s < max_size:
            sizes.append(s)
            s = max(s + 1, int(math.ceil(s * growth)))
        sizes.append(max_size)
        return cls(tuple(sizes))

    @property
    def max_size(self) -> int:
        return self.sizes[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest bucket that fits ``n`` target nodes (``n=0`` maps to the
        smallest bucket — an all-padding gather is cheaper than a bucket
        shape that only ever appears in tests). Raises
        :class:`RequestTooLarge` past the ladder's top."""
        if n < 0:
            raise ValueError(f"negative request size {n}")
        if n > self.sizes[-1]:
            raise RequestTooLarge(
                f"request of {n} target nodes exceeds the largest bucket "
                f"({self.sizes[-1]}); split the request or raise max_bucket",
                request_size=int(n),
                max_bucket=int(self.sizes[-1]),
            )
        return self.sizes[bisect.bisect_left(self.sizes, n)]


def pad_ids(ids: np.ndarray, bucket: int) -> tuple:
    """Pad a [n] id vector to [bucket] with id 0 (any *valid* id — padded
    rows gather real logits that are sliced off, never out-of-bounds
    indices). Returns (padded int32 [bucket], n)."""
    ids = np.asarray(ids)
    if ids.ndim != 1:
        raise ValueError(f"node_ids must be 1-D, got shape {ids.shape}")
    n = ids.shape[0]
    if n > bucket:
        raise ValueError(f"{n} ids do not fit bucket {bucket}")
    out = np.zeros(bucket, np.int32)
    out[:n] = ids
    return out, n
