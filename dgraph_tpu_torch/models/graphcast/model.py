"""GraphCast: encode grid -> mesh, process the multimesh, decode mesh -> grid.

Counterpart of ``dgraph_tpu/models/graphcast/model.py`` as ``nn.Module``s
with flax's names (``embed_grid.Dense_0``, ``enc_edge.src_proj``,
``proc_node_3.MLP_0.LayerNorm_0``, ``head.Dense_1``, ...), so
:func:`dgraph_tpu_torch.weights.params_from_jax` carries a flax tree
across as it is.

Each EdgeBlock gathers both endpoints' projections; edges are dst-owned, so
only the src side crosses ranks (one ``halo_extend`` a block) and each
NodeBlock's sum is rank-local (the sorted segment-sum kernel).

``remat=True`` (the reference's default) runs every block and embedder
under ``torch.utils.checkpoint`` (non-reentrant): the backward keeps only
the blocks' inputs and recomputes the rest, the halo exchange included, in
the same order on every rank. The gradients are the same bits as with
``remat=False``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from dgraph_tpu_torch.comm.collectives import map_feature_chunks
from dgraph_tpu_torch.models.gcn import dense
from dgraph_tpu_torch.models.mlp import MLP

STATIC_FEATURES = 4  # node [cos lat, sin lon cos lat, cos lon cos lat, sin lat]; edge [len, d]


class MeshEdgeBlock(nn.Module):
    """``e' = e + MLP([e, h_src, h_dst])`` with the first layer split by
    input rows: ``silu(edge_proj(e) + take(src_proj(x_src)) +
    take(dst_proj(x_dst)))``, computed per ``<= gather_col_block``-wide
    feature chunk, so no ``[E, 3L]`` concat exists. Then ``MLP([L], LN)``."""

    def __init__(self, latent: int, comm, dtype=None):
        super().__init__()
        self.latent, self.comm, self.dtype = latent, comm, dtype
        self.src_proj = nn.Linear(latent, latent, bias=False)
        self.dst_proj = nn.Linear(latent, latent, bias=False)
        self.edge_proj = nn.Linear(latent, latent)
        self.MLP_0 = MLP(latent, [latent], use_layer_norm=True, dtype=dtype)

    def forward(self, e, x_src, x_dst, plan):
        # flax's Dense(dtype=self.dtype): None computes in the promoted type
        hs = dense(self.src_proj, x_src, self.dtype)
        hd = dense(self.dst_proj, x_dst, self.dtype)
        e_proj = dense(self.edge_proj, e, self.dtype)
        # halo_extend is the identity on the non-halo side: one exchange
        hs_ext = self.comm.halo_extend(hs, plan, side="src")
        hd_ext = self.comm.halo_extend(hd, plan, side="dst")
        h = map_feature_chunks(
            lambda sl: F.silu(
                e_proj[:, sl]
                + self.comm.local_take(hs_ext[:, sl], plan, side="src")
                + self.comm.local_take(hd_ext[:, sl], plan, side="dst")
            ),
            self.latent,
        )
        return e + self.MLP_0(h)


class MeshNodeBlock(nn.Module):
    """``x' = x + MLP([x, sum of incoming edge features])``, ``MLP([L, L], LN)``."""

    def __init__(self, latent: int, comm, dtype=None):
        super().__init__()
        self.comm = comm
        self.MLP_0 = MLP(2 * latent, [latent, latent], use_layer_norm=True, dtype=dtype)

    def forward(self, x_dst, e, plan):
        agg = self.comm.scatter_sum(e, plan, side="dst")
        return x_dst + self.MLP_0(torch.cat([x_dst, agg], dim=-1))


class GraphCast(nn.Module):
    """The full model on one rank's shard.

    ``forward(grid_feats, statics, plans)``: ``grid_feats`` ``[n_grid_pad,
    out_channels]`` (the weather state, whose next state the model
    predicts); ``statics`` the five static tables and ``plans`` the
    per-rank ``mesh``, ``g2m`` and ``m2g`` plans
    (:func:`~dgraph_tpu_torch.models.graphcast.graph.rank_inputs`). Returns
    ``[n_grid_pad, out_channels]`` f32: the input channels plus the head's
    residual prediction."""

    def __init__(self, latent: int = 64, processor_layers: int = 4, out_channels: int = 73,
                 comm=None, dtype=None, remat: bool = True):
        super().__init__()
        L, S = latent, STATIC_FEATURES
        self.latent, self.processor_layers = latent, processor_layers
        self.out_channels, self.remat, self.dtype = out_channels, remat, dtype

        def emb(width):
            return MLP(width, [L, L], use_layer_norm=True, dtype=dtype)

        self.embed_grid = emb(out_channels + S)
        self.embed_mesh = emb(S)
        self.embed_mesh_edges = emb(S)
        self.embed_g2m_edges = emb(S)
        self.embed_m2g_edges = emb(S)
        self.enc_edge = MeshEdgeBlock(L, comm, dtype)
        self.enc_node = MeshNodeBlock(L, comm, dtype)
        self.enc_grid_mlp = emb(L)
        for i in range(processor_layers):
            self.add_module(f"proc_edge_{i}", MeshEdgeBlock(L, comm, dtype))
            self.add_module(f"proc_node_{i}", MeshNodeBlock(L, comm, dtype))
        self.dec_edge = MeshEdgeBlock(L, comm, dtype)
        self.dec_node = MeshNodeBlock(L, comm, dtype)
        self.head = MLP(L, [L, out_channels], dtype=dtype)

    def _run(self, block, *args):
        """``block(*args)``, under non-reentrant checkpointing when remat is
        on and a gradient is being recorded."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, grid_feats, statics, plans):
        run = self._run
        # --- embedders ---
        g = run(self.embed_grid, torch.cat([grid_feats, statics["grid_node_static"]], dim=-1))
        m = run(self.embed_mesh, statics["mesh_node_static"])
        e_mesh = run(self.embed_mesh_edges, statics["mesh_edge_static"])
        e_g2m = run(self.embed_g2m_edges, statics["g2m_edge_static"])
        e_m2g = run(self.embed_m2g_edges, statics["m2g_edge_static"])
        # --- encoder: grid -> mesh ---
        e_g2m = run(self.enc_edge, e_g2m, g, m, plans["g2m"])
        m = run(self.enc_node, m, e_g2m, plans["g2m"])
        g = g + run(self.enc_grid_mlp, g)
        # --- processor: the multimesh ---
        for i in range(self.processor_layers):
            e_mesh = run(getattr(self, f"proc_edge_{i}"), e_mesh, m, m, plans["mesh"])
            m = run(getattr(self, f"proc_node_{i}"), m, e_mesh, plans["mesh"])
        # --- decoder: mesh -> grid ---
        e_m2g = run(self.dec_edge, e_m2g, m, g, plans["m2g"])
        g = run(self.dec_node, g, e_m2g, plans["m2g"])
        # --- residual prediction over the input channels ---
        delta = self.head(g)
        return grid_feats[..., : self.out_channels] + delta.float()


def rollout(model: GraphCast, x0, statics, plans, num_steps: int, params=None):
    """Autoregressive forecast ``x_{t+1} = model(x_t)``, forward only:
    ``[num_steps, n_grid_pad, C]``, the states x_1 .. x_{num_steps}.
    ``params`` (a ``{name: tensor}`` dict, e.g. the EMA track) replaces the
    model's own parameters for the call."""
    def step(x):
        if params is None:
            return model(x, statics, plans)
        return torch.func.functional_call(model, params, (x, statics, plans))

    traj, x = [], x0
    with torch.no_grad():
        for _ in range(num_steps):
            x = step(x)
            traj.append(x)
    return torch.stack(traj)
