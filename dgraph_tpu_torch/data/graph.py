"""DistributedGraph: one vertex-partitioned graph, its plan and sharded tensors.

Counterpart of ``dgraph_tpu/data/graph.py`` with the reference's
``tune="off"`` semantics: the partition method and pad multiple are the
caller's (defaults ``"rcm"`` / 8, the reference's hard-coded defaults).
The plan comes from the on-disk plan cache when ``plan_cache_dir`` is set
(:func:`~dgraph_tpu_torch.train.checkpoint.cached_edge_plan`, under the
reference's key: the two packages share one artifact), over ranks in its
agreed form (``group``: global rank 0 resolves and writes, the others load
what it resolved). The reference's tuning-record lookup inside
``plan_cache_dir`` comes with the port's tuner. Everything is stacked
``[W, n_pad, ...]`` as torch tensors on the CPU;
:meth:`DistributedGraph.to` moves them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.plan import (
    EdgePlan,
    EdgePlanLayout,
    shard_edge_data,
    shard_vertex_data,
)


@dataclasses.dataclass
class DistributedGraph:
    num_nodes: int
    num_edges: int
    world_size: int
    edge_index: np.ndarray  # [2, E] renumbered (contiguous per-rank blocks)
    ren: pt.Renumbering
    plan: EdgePlan
    layout: EdgePlanLayout
    features: torch.Tensor  # [W, n_pad, F] f32
    # [W, n_pad] int32 class ids, or [W, n_pad, C] float32 multi-label targets
    labels: Optional[torch.Tensor]
    masks: dict  # split name -> [W, n_pad] f32
    vertex_mask: torch.Tensor  # [W, n_pad] f32: 1.0 for real vertices
    edge_weight: Optional[torch.Tensor] = None  # [W, e_pad] f32
    partition_s: float = 0.0  # host seconds partition_graph took (partition + renumbering)

    @classmethod
    def from_global(
        cls,
        edge_index: np.ndarray,
        features: np.ndarray,
        labels: Optional[np.ndarray],
        masks: Optional[dict],
        world_size: int,
        *,
        partition_method: str = "rcm",
        edge_owner: str = "dst",
        add_symmetric_norm: bool = False,
        pad_multiple: int = 8,
        seed: int = 0,
        overlap: Optional[bool] = None,
        plan_cache_dir: str = "",
        group=None,
    ) -> "DistributedGraph":
        """Partition + plan + shard one global graph (numpy in, torch out).
        ``overlap`` attaches the interior/boundary split (None = when the
        halo-lowering pin asks for it, as ``build_edge_plan`` decides; the
        resolved intent is part of the cache key). ``plan_cache_dir`` ("" =
        build without a cache) names the plan cache, keyed as the
        reference's (the partition method folded in); ``group`` (a
        :class:`~dgraph_tpu_torch.comm.dist.RankGroup`, every rank calling)
        takes the cache's agreed form. Every rank partitions the graph
        (deterministic, from ``seed``) and holds every rank's shards."""
        from dgraph_tpu_torch.train.checkpoint import cached_edge_plan

        features = np.asarray(features)
        num_nodes = features.shape[0]
        edge_index = np.asarray(edge_index)
        t0 = time.perf_counter()
        new_edges, ren = pt.partition_graph(
            edge_index, num_nodes, world_size, method=partition_method, seed=seed,
        )
        partition_s = time.perf_counter() - t0
        # a falsy plan_cache_dir is a plain build on every rank; the port's
        # partitioners take no parameters beyond the method and the seed,
        # so the reference's part_* key extras do not arise
        plan, layout = cached_edge_plan(
            plan_cache_dir, new_edges, ren.partition, world_size=world_size,
            edge_owner=edge_owner, pad_multiple=pad_multiple, overlap=overlap,
            key_extra={"partition_method": partition_method}, group=group,
        )
        n_pad = plan.n_src_pad
        feats = shard_vertex_data(features[ren.inv], ren.counts, n_pad).astype(np.float32)
        lab = None
        if labels is not None:
            lab_arr = np.asarray(labels)
            lab_dtype = (
                np.float32 if np.issubdtype(lab_arr.dtype, np.floating) else np.int32
            )
            lab = torch.from_numpy(shard_vertex_data(
                lab_arr[ren.inv].astype(lab_dtype), ren.counts, n_pad
            ))
        m = {
            k: torch.from_numpy(shard_vertex_data(
                np.asarray(v).astype(np.float32)[ren.inv], ren.counts, n_pad
            ))
            for k, v in (masks or {}).items()
        }
        vmask = shard_vertex_data(np.ones(num_nodes, np.float32), ren.counts, n_pad)
        ew = None
        if add_symmetric_norm:
            ew = torch.from_numpy(shard_edge_data(
                symmetric_norm_weights(new_edges, num_nodes), layout, plan.e_pad
            ))
        return cls(
            num_nodes=num_nodes,
            num_edges=edge_index.shape[1],
            world_size=world_size,
            edge_index=new_edges,
            ren=ren,
            plan=plan,
            layout=layout,
            features=torch.from_numpy(feats),
            labels=lab,
            masks=m,
            vertex_mask=torch.from_numpy(vmask),
            edge_weight=ew,
            partition_s=partition_s,
        )

    def batch(self, split: str) -> dict:
        """Model inputs for one split: leaves have a leading [W] axis."""
        out = {
            "x": self.features,
            "mask": self.masks[split] if split in self.masks else self.vertex_mask,
        }
        if self.labels is not None:
            out["y"] = self.labels
        if self.edge_weight is not None:
            out["edge_weight"] = self.edge_weight
        return out

    def rank_batch(self, split: str, rank: int) -> dict:
        """One rank's slice of :meth:`batch` plus the labels (``"y"``): the
        leaves without the leading rank axis, what rank ``rank``'s model
        takes with ``plan.shard(rank)``."""
        b = dict(self.batch(split))
        if self.labels is not None:
            b["y"] = self.labels
        return {k: v[rank] for k, v in b.items()}

    def id_map(self) -> tuple[np.ndarray, np.ndarray]:
        """(rank, slot) of every vertex in the caller's original numbering:
        its row address in any ``[W, n_pad, ...]`` sharded tensor."""
        rank = np.asarray(self.ren.partition)[np.asarray(self.ren.perm)]
        slot = np.asarray(self.ren.perm) - np.asarray(self.ren.offsets)[rank]
        return rank, slot


def symmetric_norm_weights(edge_index: np.ndarray, num_nodes: int) -> np.ndarray:
    """Kipf-Welling GCN normalization 1/sqrt(d_src * d_dst) per edge."""
    src, dst = edge_index
    deg = np.zeros(num_nodes, np.float64)
    np.add.at(deg, src, 1.0)
    np.add.at(deg, dst, 1.0)
    deg = np.maximum(deg, 1.0)
    return (1.0 / np.sqrt(deg[src] * deg[dst])).astype(np.float32)
