"""Replica-axis data sampling — counterpart of ``dgraph_tpu/train/sampler.py``
(the reference's ``CommAwareDistributedSampler``,
``experiments/GraphCast/dist_utils.py:50-113``).

Every rank of a graph group trains on the SAME sample and each replica
group on a DIFFERENT one. For global step ``t`` the sampler gives the R
sample indices of the replica axis and stacks their sharded batches into
``[R, W, ...]`` leaves, which ``train.loop.make_train_step(...,
per_replica_batch=True)`` reads as ``[replica][rank]``. Numpy only.
"""

from __future__ import annotations

import numpy as np


class ReplicaSampler:
    """Deterministic epoch-shuffled sampler over ``num_samples`` items for
    ``num_replicas`` replica groups: an epoch is a permutation of the
    dataset seeded by ``(seed, epoch)``; step ``t`` of an epoch hands
    replica ``r`` the item ``perm[t * R + r]``; a short last step wraps
    (modulo, drop_last=False)."""

    def __init__(self, num_samples: int, num_replicas: int, seed: int = 0):
        if num_samples < 1:
            raise ValueError("num_samples must be >= 1")
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.seed = seed

    @property
    def steps_per_epoch(self) -> int:
        return max(1, -(-self.num_samples // self.num_replicas))

    def indices(self, global_step: int) -> list:
        """The sample index of each replica at this global step."""
        epoch, t = divmod(int(global_step), self.steps_per_epoch)
        perm = np.random.default_rng((self.seed, epoch)).permutation(self.num_samples)
        base = t * self.num_replicas
        return [int(perm[(base + r) % self.num_samples]) for r in range(self.num_replicas)]

    def stacked(self, global_step: int, get_sharded) -> dict:
        """Fetch and stack: ``get_sharded(i)``, a dict of numpy ``[W, ...]``
        leaves, becomes a dict of ``[R, W, ...]`` leaves, one sample a
        replica."""
        parts = [get_sharded(i) for i in self.indices(global_step)]
        return {k: np.stack([p[k] for p in parts], axis=0) for k in parts[0]}
