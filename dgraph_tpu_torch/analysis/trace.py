"""The canonical audit workload and the programs the kernel tier runs —
the part of ``dgraph_tpu/analysis/trace.py`` that ``analysis.kernel``
needs.

:func:`build_audit_workload` builds, on the host, the reference's canonical
graph (``trace.py:286-338``: 48 nodes, 300 edges, seed 0, the
interior/boundary split, F = 8, hidden 16, 4 classes, 2 layers) with the
port's own :func:`~dgraph_tpu_torch.plan.build_edge_plan`. :data:`PROGRAMS`
are the steps the audit runs on each rank of a gloo group on the CPU with
the halo pinned to ``pallas_p2p``: ``train_step`` and ``eval_step`` of
``train/loop.py``. The reference traces; the port runs them, since a step
of this size costs milliseconds and the p2p transport records its protocol
as it runs.

The reference's compute dtype here is bf16 (its trace tier checks f32
accumulation); the port's kernel tier reads only the transports, so the
model runs in f32. Not here yet: ``serve_forward`` at W > 1 (serving over
ranks is a later slice) and the trace tier's op-count and byte pins (the
collective-schedule audit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dgraph_tpu_torch.plan import EdgePlan, build_edge_plan, shard_vertex_data


@dataclasses.dataclass
class AuditWorkload:
    """A ``world_size``-rank graph, its stacked plan (CPU tensors) and a
    batch (numpy, ``[W, n_pad, ...]``), with the model's widths."""

    world_size: int
    edge_index: np.ndarray  # [2, E] the graph the plan was built from
    partition: np.ndarray  # [V] owner rank per vertex
    plan: EdgePlan
    batch: dict
    feat_dim: int
    hidden: int
    num_classes: int
    num_layers: int
    seed: int


def build_audit_workload(
    world_size: int = 2,
    *,
    num_nodes: int = 48,
    num_edges: int = 300,
    feat_dim: int = 8,
    hidden: int = 16,
    num_classes: int = 4,
    num_layers: int = 2,
    seed: int = 0,
) -> AuditWorkload:
    """The reference's canonical audit graph (same draws from
    ``default_rng(seed)``, same plan build) and a batch of its features,
    zero labels and a full mask."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, world_size, num_nodes)).astype(np.int32)
    edges = np.stack([
        rng.integers(0, num_nodes, num_edges),
        rng.integers(0, num_nodes, num_edges),
    ])
    plan, layout = build_edge_plan(edges, part, world_size=world_size, overlap=True)
    x = shard_vertex_data(
        rng.normal(size=(num_nodes, feat_dim)).astype(np.float32),
        layout.src_counts, plan.n_src_pad,
    )
    batch = {
        "x": x,
        "y": np.zeros((world_size, plan.n_src_pad), np.int64),
        "mask": np.ones((world_size, plan.n_src_pad), np.float32),
    }
    return AuditWorkload(world_size=world_size, edge_index=edges, partition=part, plan=plan,
                         batch=batch, feat_dim=feat_dim, hidden=hidden,
                         num_classes=num_classes, num_layers=num_layers, seed=seed)


def _model(w: AuditWorkload, comm):
    from dgraph_tpu_torch.models import GCN
    from dgraph_tpu_torch.weights import init_params

    return init_params(GCN(w.feat_dim, w.hidden, w.num_classes, comm,
                           num_layers=w.num_layers), w.seed)


def _batch(w: AuditWorkload) -> dict:
    return {k: torch.from_numpy(v) for k, v in w.batch.items()}


def _train_program(w: AuditWorkload, comm):
    from dgraph_tpu_torch.train.loop import make_train_step

    model = _model(w, comm)
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-2), w.plan,
                           comm=comm)
    batch = _batch(w)
    return lambda: step(batch)


def _eval_program(w: AuditWorkload, comm):
    from dgraph_tpu_torch.train.loop import make_eval_step

    step = make_eval_step(_model(w, comm), w.plan, comm=comm)
    batch = _batch(w)
    return lambda: step(batch)


# label -> (workload, this rank's communicator) -> one step, run by the audit
PROGRAMS = {
    "train_step": _train_program,
    "eval_step": _eval_program,
}

# transport calls a rank makes per layer: the exchange forward and its
# transpose in the backward (train), the exchange alone (eval)
TRANSPORTS_PER_LAYER = {"train_step": 2, "eval_step": 1}
