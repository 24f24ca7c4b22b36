"""DistributedGraph: one vertex-partitioned graph, its plan and sharded tensors.

Counterpart of ``dgraph_tpu/data/graph.py`` with the reference's
``tune="off"`` semantics and no plan cache: the partition method and pad
multiple are the caller's (defaults ``"rcm"`` / 8, the reference's
hard-coded defaults). Everything is stacked ``[W, n_pad, ...]`` as torch
tensors on the CPU; :meth:`DistributedGraph.to` moves them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.plan import (
    EdgePlan,
    EdgePlanLayout,
    build_edge_plan,
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
    ) -> "DistributedGraph":
        """Partition + plan + shard one global graph (numpy in, torch out)."""
        features = np.asarray(features)
        num_nodes = features.shape[0]
        edge_index = np.asarray(edge_index)
        new_edges, ren = pt.partition_graph(
            edge_index, num_nodes, world_size, method=partition_method, seed=seed,
        )
        plan, layout = build_edge_plan(
            new_edges, ren.partition, world_size=world_size,
            edge_owner=edge_owner, pad_multiple=pad_multiple,
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
