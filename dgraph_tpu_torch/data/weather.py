"""Synthetic ERA5-like weather for GraphCast training.

Counterpart of ``dgraph_tpu/data/weather.py``: one seed gives the
reference's fields bit for bit (its loop, with each channel's field held
contiguous while it is summed): smooth random
fields (low-frequency Fourier mixtures, so one-step prediction is
learnable), served as (input, target) pairs whose target is a fixed
deterministic advection and decay of the input, laid out per rank by the
graphs' grid renumbering.
"""

from __future__ import annotations

import numpy as np

from dgraph_tpu_torch.plan import shard_vertex_data


class SyntheticWeatherDataset:
    def __init__(
        self,
        graphs,  # GraphCastGraphs
        num_lat: int,
        num_lon: int,
        num_channels: int = 73,
        num_samples: int = 8,
        seed: int = 0,
    ):
        self.num_lat, self.num_lon = num_lat, num_lon
        self.num_channels = num_channels
        self.graphs = graphs
        rng = np.random.default_rng(seed)
        n_grid = num_lat * num_lon

        # smooth random fields: sum of a few random spatial harmonics / channel
        # (the reference's loop and draws; the fields channel-major, so that
        # each channel's adds run over contiguous rows)
        lat = np.linspace(0, np.pi, num_lat)[:, None]
        lon = np.linspace(0, 2 * np.pi, num_lon, endpoint=False)[None, :]
        self._samples = []
        for _ in range(num_samples):
            fields = np.zeros((num_channels, num_lat, num_lon), np.float32)
            for c in range(num_channels):
                for _ in range(3):
                    kl, kk = rng.integers(1, 4), rng.integers(1, 5)
                    ph = rng.uniform(0, 2 * np.pi)
                    amp = rng.normal(0, 1.0)
                    fields[c] += amp * np.sin(kl * lat + ph) * np.cos(kk * lon)
            x = np.ascontiguousarray(fields.transpose(1, 2, 0)).reshape(n_grid, num_channels)
            self._samples.append((x, self._advance(x)))

    def _advance(self, x: np.ndarray) -> np.ndarray:
        """The dataset's deterministic dynamics T: eastward roll + mild
        decay + channel mix. Iterating T gives true multi-step
        trajectories for rollout evaluation."""
        fields = x.reshape(self.num_lat, self.num_lon, self.num_channels)
        rolled = np.roll(fields, shift=3, axis=1).reshape(x.shape)
        return (0.9 * rolled + 0.1 * x.mean(axis=1, keepdims=True)).astype(
            np.float32)

    def __len__(self):
        return len(self._samples)

    def _shard(self, a: np.ndarray):
        g = self.graphs
        return shard_vertex_data(a[g.grid_ren.inv], g.grid_ren.counts, g.n_grid_pad)

    def get_sharded(self, i: int):
        """(input, target) as [W, n_grid_pad, C] plan-layout arrays."""
        x, y = self._samples[i % len(self._samples)]
        return self._shard(x), self._shard(y)

    def trajectory_sharded(self, i: int, num_steps: int):
        """(x0, [T, W, n_grid_pad, C]): the true num_steps-long forward
        trajectory T(x0), T^2(x0), ... for rollout evaluation
        (``models.graphcast.rollout``)."""
        x, _ = self._samples[i % len(self._samples)]
        steps = []
        cur = x
        for _ in range(num_steps):
            cur = self._advance(cur)
            steps.append(self._shard(cur))
        return self._shard(x), np.stack(steps)
