"""Distributed GraphCast graph assembly: three partitioned edge sets and
their static features, sharded over the ranks.

Counterpart of ``dgraph_tpu/models/graphcast/graph.py`` on the port's
``partition`` and ``plan``, with the same arrays: the mesh vertices are
partitioned by ``multilevel`` (the reference's METIS stand-in, through the
port's native host library), ``rcm`` or greedy BFS; the grid points by
latitude-band blocks (lat-major ids, so a block is geographically
contiguous). Every plan owns its edges on the dst side, so each NodeBlock's
aggregation is rank-local and the only collectives are the src-side halo
gathers of the three relations.

:func:`rank_inputs` moves one rank's statics, plans and grid mask to a
device, as the training CLI and ``chip_smoke.py`` feed the model.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch.models.graphcast import mesh as mesh_lib
from dgraph_tpu_torch.plan import (
    EdgePlan,
    EdgePlanLayout,
    _pad_to,
    build_edge_plan,
    shard_edge_data,
    shard_vertex_data,
)

STATIC_KEYS = ("grid_node_static", "mesh_node_static", "mesh_edge_static",
               "g2m_edge_static", "m2g_edge_static")
RELATIONS = ("mesh", "g2m", "m2g")


@dataclasses.dataclass
class GraphCastGraphs:
    world_size: int
    mesh_level: int
    num_grid: int
    num_mesh: int
    # plans
    mesh_plan: EdgePlan
    g2m_plan: EdgePlan
    m2g_plan: EdgePlan
    mesh_layout: EdgePlanLayout
    g2m_layout: EdgePlanLayout
    m2g_layout: EdgePlanLayout
    # renumberings
    grid_ren: pt.Renumbering
    mesh_ren: pt.Renumbering
    # static sharded features
    grid_node_static: np.ndarray  # [W, n_grid_pad, 4]
    mesh_node_static: np.ndarray  # [W, n_mesh_pad, 4]
    mesh_edge_static: np.ndarray  # [W, e_pad, 4]
    g2m_edge_static: np.ndarray
    m2g_edge_static: np.ndarray
    grid_mask: np.ndarray  # [W, n_grid_pad]
    mesh_mask: np.ndarray  # [W, n_mesh_pad]

    @property
    def n_grid_pad(self) -> int:
        return self.g2m_plan.n_src_pad

    @property
    def n_mesh_pad(self) -> int:
        return self.mesh_plan.n_src_pad


def node_static_features(xyz: np.ndarray, latlon: np.ndarray) -> np.ndarray:
    """[cos lat, sin lon * cos lat, cos lon * cos lat, sin lat]: the
    GraphCast node geometry features."""
    lat = np.deg2rad(latlon[:, 0])
    lon = np.deg2rad(latlon[:, 1])
    return np.stack(
        [np.cos(lat), np.sin(lon) * np.cos(lat), np.cos(lon) * np.cos(lat), np.sin(lat)],
        axis=1,
    ).astype(np.float32)


def edge_static_features(
    src_xyz: np.ndarray, dst_xyz: np.ndarray, edges: np.ndarray
) -> np.ndarray:
    """[length, dx, dy, dz] per edge, normalized by the longest edge."""
    d = src_xyz[edges[0]] - dst_xyz[edges[1]]
    length = np.linalg.norm(d, axis=1, keepdims=True)
    scale = max(length.max(), 1e-12)
    return np.concatenate([length / scale, d / scale], axis=1).astype(np.float32)


def build_graphcast_graphs(
    mesh_level: int,
    num_lat: int,
    num_lon: int,
    world_size: int,
    *,
    mesh_partition_method: str = "multilevel",  # 'multilevel'/'metis', 'rcm',
    # or anything else for greedy BFS, as in the reference
    pad_multiple: int = 8,
) -> GraphCastGraphs:
    """The multimesh, the grid, their three relations' plans and the static
    features, sharded over ``world_size`` ranks (numpy and CPU tensors)."""
    mm = mesh_lib.build_multimesh(mesh_level)
    grid_latlon, grid_xyz = mesh_lib.latlon_grid(num_lat, num_lon)
    g2m = mesh_lib.grid2mesh_edges(grid_xyz, mm)
    m2g = mesh_lib.mesh2grid_edges(grid_xyz, mm)
    num_grid, num_mesh = len(grid_xyz), len(mm.vertices)

    # --- partitions ---
    if world_size == 1:
        mesh_part = np.zeros(num_mesh, np.int32)
    elif mesh_partition_method == "rcm":
        mesh_part = pt.rcm_partition(mm.edges, num_mesh, world_size)
    elif mesh_partition_method in ("multilevel", "metis"):
        mesh_part = pt.multilevel_partition(mm.edges, num_mesh, world_size)
    else:
        mesh_part = pt.greedy_bfs_partition(mm.edges, num_mesh, world_size)
    mesh_ren = pt.renumber_contiguous(mesh_part, world_size)
    grid_part = pt.block_partition(num_grid, world_size)  # latitude bands
    grid_ren = pt.renumber_contiguous(grid_part, world_size)

    n_mesh_pad = _pad_to(int(mesh_ren.counts.max(initial=1)), pad_multiple)
    n_grid_pad = _pad_to(int(grid_ren.counts.max(initial=1)), pad_multiple)

    def remap(edges, src_ren, dst_ren):
        return np.stack([src_ren.perm[edges[0]], dst_ren.perm[edges[1]]])

    mesh_edges_r = remap(mm.edges, mesh_ren, mesh_ren)
    g2m_r = remap(g2m, grid_ren, mesh_ren)
    m2g_r = remap(m2g, mesh_ren, grid_ren)

    mesh_plan, mesh_layout = build_edge_plan(
        mesh_edges_r, mesh_ren.partition, world_size=world_size, edge_owner="dst",
        n_src_pad=n_mesh_pad, n_dst_pad=n_mesh_pad, pad_multiple=pad_multiple,
    )
    g2m_plan, g2m_layout = build_edge_plan(
        g2m_r, grid_ren.partition, mesh_ren.partition, world_size=world_size,
        edge_owner="dst", n_src_pad=n_grid_pad, n_dst_pad=n_mesh_pad,
        pad_multiple=pad_multiple,
    )
    m2g_plan, m2g_layout = build_edge_plan(
        m2g_r, mesh_ren.partition, grid_ren.partition, world_size=world_size,
        edge_owner="dst", n_src_pad=n_mesh_pad, n_dst_pad=n_grid_pad,
        pad_multiple=pad_multiple,
    )

    # --- static features (renumbered order) ---
    mesh_xyz_r = mm.vertices[mesh_ren.inv]
    grid_xyz_r = grid_xyz[grid_ren.inv]
    grid_latlon_r = grid_latlon[grid_ren.inv]
    mesh_latlon_r = xyz_to_latlon(mesh_xyz_r)

    grid_node_static = shard_vertex_data(
        node_static_features(grid_xyz_r, grid_latlon_r), grid_ren.counts, n_grid_pad
    )
    mesh_node_static = shard_vertex_data(
        node_static_features(mesh_xyz_r, mesh_latlon_r), mesh_ren.counts, n_mesh_pad
    )
    mesh_edge_static = shard_edge_data(
        edge_static_features(mesh_xyz_r, mesh_xyz_r, mesh_edges_r),
        mesh_layout, mesh_plan.e_pad,
    )
    g2m_edge_static = shard_edge_data(
        edge_static_features(grid_xyz_r, mesh_xyz_r, g2m_r), g2m_layout, g2m_plan.e_pad
    )
    m2g_edge_static = shard_edge_data(
        edge_static_features(mesh_xyz_r, grid_xyz_r, m2g_r), m2g_layout, m2g_plan.e_pad
    )
    grid_mask = shard_vertex_data(np.ones(num_grid, np.float32), grid_ren.counts, n_grid_pad)
    mesh_mask = shard_vertex_data(np.ones(num_mesh, np.float32), mesh_ren.counts, n_mesh_pad)

    return GraphCastGraphs(
        world_size=world_size,
        mesh_level=mesh_level,
        num_grid=num_grid,
        num_mesh=num_mesh,
        mesh_plan=mesh_plan,
        g2m_plan=g2m_plan,
        m2g_plan=m2g_plan,
        mesh_layout=mesh_layout,
        g2m_layout=g2m_layout,
        m2g_layout=m2g_layout,
        grid_ren=grid_ren,
        mesh_ren=mesh_ren,
        grid_node_static=grid_node_static,
        mesh_node_static=mesh_node_static,
        mesh_edge_static=mesh_edge_static,
        g2m_edge_static=g2m_edge_static,
        m2g_edge_static=m2g_edge_static,
        grid_mask=grid_mask,
        mesh_mask=mesh_mask,
    )


def xyz_to_latlon(xyz: np.ndarray) -> np.ndarray:
    lat = np.rad2deg(np.arcsin(np.clip(xyz[:, 2], -1, 1)))
    lon = np.rad2deg(np.arctan2(xyz[:, 1], xyz[:, 0])) % 360.0
    return np.stack([lat, lon], axis=1)


def rank_inputs(graphs: GraphCastGraphs, rank: int, device) -> tuple:
    """``(statics, plans, grid_mask)`` of one rank on ``device``: the five
    static feature tables (``STATIC_KEYS``), the per-rank views of the
    three plans (``RELATIONS``) and the ``[n_grid_pad]`` grid mask, as
    :class:`~dgraph_tpu_torch.models.graphcast.model.GraphCast` takes them."""
    statics = {k: torch.from_numpy(getattr(graphs, k)[rank]).to(device) for k in STATIC_KEYS}
    plans = {k: getattr(graphs, f"{k}_plan").shard(rank).to(device) for k in RELATIONS}
    return statics, plans, torch.from_numpy(graphs.grid_mask[rank]).to(device)
