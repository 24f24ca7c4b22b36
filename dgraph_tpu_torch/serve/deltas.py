"""Live graph deltas: pad-slot appends, background re-plan, atomic adoption.

Counterpart of ``dgraph_tpu/serve/deltas.py``, over the port's own
``partition``, ``plan`` and ``plan_shards``; numpy only, torch inside
:func:`build_engine`. A serving graph grows while traffic runs, and
"rebuild everything and restart" drops requests and warms every bucket
again. Growth is split into a live half and a durable background half,
glued by one generation pointer:

- **Append (live, bounded).** Every plan pads each rank's vertex block to
  ``n_pad``; the slack above the real count is reserved capacity.
  :func:`append_delta` makes the new vertices and edges durable (one npz an
  append, staged against the current generation), and
  :meth:`~dgraph_tpu_torch.serve.engine.ServeEngine.append_vertices` writes
  the vertices into those pad slots of the running engine, in place: they
  are served at once, with no shape change. New edges stay staged (the
  plan's routing is fixed) until the next adoption: until then an appended
  vertex serves as an isolated vertex.
- **Re-plan (background, resumable).** :func:`replan` composes the base
  graph with every staged delta, places the new vertices with the same
  deterministic waterfill the live append ran (so adoption moves no vertex
  already served), and builds generation ``g+1``'s sharded plan through
  :func:`~dgraph_tpu_torch.plan.build_plan_shards` (memory-budgeted,
  durable a shard, resumable after a kill).
- **Adopt (atomic).** Only once the new generation's plan and graph
  snapshot are durable does the ``serving.json`` pointer move, by one
  atomic rename (:func:`~dgraph_tpu_torch.plan_shards.atomic_write_json`):
  a crash anywhere leaves the old or the new generation adopted, never a
  mix. The server then builds a fresh engine on the generation
  (:func:`build_engine`), warms it off the request path and flips it live
  through :meth:`~dgraph_tpu_torch.serve.registry.ModelRegistry.activate`:
  batches in flight finish on the old engine, the next runs on the new one.
  Over W graph ranks rank 0 passes ``adopt_from=`` the serving engine, which
  announces the build to its followers (the engine's ``ADOPT`` op), so every
  rank builds the new engine at the same point.

The artifacts are the reference's: for the same inputs the two packages
write equal ``serving.json`` records, equal arrays in every ``graph_g*.npz``
and ``deltas_g*/delta_*.npz``, and the same manifest and shard bytes under
``plan_g*/``; each package's :func:`load_generation` reads a run directory
the other wrote. Layout under one run directory::

    run_dir/
      serving.json          <- the adoption pointer {generation, ...}
      graph_g0.npz          <- edges, features and partition, original numbering
      plan_g0/              <- the sharded plan artifact (manifest, shards, layout)
      deltas_g0/            <- appends staged against generation 0
        delta_0000.npz
      graph_g1.npz  plan_g1/  deltas_g1/   <- the next generation, same shape

The reference's chaos points (``serve.delta_append`` at an append's entry,
``serve.replan`` at a re-plan's entry and at its commit boundary) are
comments here until slice 12's ``chaos/``, and its ``serve.replan`` span
until slice 11's ``obs/spans``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np

SERVE_POINTER = "serving.json"

# per-run_dir append/adopt serialization in this process (the serving
# process appends on request threads and re-plans on a background one);
# appends from other processes are kept apart by append_delta's no-clobber
# link publish
_RUN_LOCKS: dict = {}
_RUN_LOCKS_GUARD = threading.Lock()


def _run_lock(run_dir: str) -> threading.Lock:
    key = os.path.abspath(run_dir)
    with _RUN_LOCKS_GUARD:
        lock = _RUN_LOCKS.get(key)
        if lock is None:
            lock = _RUN_LOCKS[key] = threading.Lock()
        return lock


class DeltaError(RuntimeError):
    """A delta append or generation transition could not complete."""

    def __init__(self, reason: str):
        super().__init__(f"serve graph-delta failure: {reason}")
        self.reason = reason

    def record(self) -> dict:
        return {"kind": "serve_delta_error", "reason": self.reason}


# --- the generation layout (one place derives every path) ---------------------


def world_path(run_dir: str) -> str:
    return os.path.join(run_dir, SERVE_POINTER)


def plan_dir(run_dir: str, generation: int) -> str:
    return os.path.join(run_dir, f"plan_g{generation}")


def graph_path(run_dir: str, generation: int) -> str:
    return os.path.join(run_dir, f"graph_g{generation}.npz")


def delta_dir(run_dir: str, generation: int) -> str:
    return os.path.join(run_dir, f"deltas_g{generation}")


def read_world(run_dir: str) -> dict:
    """The current adoption pointer; raises :class:`DeltaError` when the
    run directory holds none (the atomic write makes a torn pointer real
    corruption, not a benign race)."""
    path = world_path(run_dir)
    try:
        with open(path) as fh:
            rec = json.load(fh)
    except OSError as e:
        raise DeltaError(f"no serving pointer at {path} ({e})")
    except ValueError as e:
        raise DeltaError(f"serving pointer {path} unreadable: {e}")
    if rec.get("kind") != "serve_world":
        raise DeltaError(f"{path} is not a serve_world record")
    return rec


def write_world(run_dir: str, rec: dict) -> None:
    """Atomic adoption: the rename is the commit point of a generation
    transition."""
    from dgraph_tpu_torch.plan_shards import atomic_write_json

    atomic_write_json(world_path(run_dir), rec)


def _atomic_savez(path: str, **arrays) -> None:
    from dgraph_tpu_torch.plan_shards import atomic_savez

    atomic_savez(path, **arrays)


# --- deterministic new-vertex placement (shared with append_vertices) --------


def assign_new_vertices(fill: np.ndarray, k: int) -> np.ndarray:
    """Rank of each of ``k`` appended vertices over per-rank occupancy
    ``fill`` (mutated in place): least-filled rank first, lowest rank on a
    tie. Deterministic on purpose: the live append and the background
    re-plan replay the same placement, so adoption never moves a vertex
    already served from its pad slot's rank."""
    fill = np.asarray(fill)
    ranks = np.empty(k, np.int32)
    for i in range(k):
        r = int(np.argmin(fill))
        ranks[i] = r
        fill[r] += 1
    return ranks


# --- the world's lifecycle ----------------------------------------------------


def init_world(
    run_dir: str,
    edge_index: np.ndarray,
    features: np.ndarray,
    *,
    world_size: int,
    partition_method: str = "random",
    seed: int = 0,
    pad_multiple: int = 8,
    memory_budget_bytes: Optional[int] = None,
) -> dict:
    """Create generation 0 of a delta-capable serving world: partition the
    graph, build the sharded plan artifact, snapshot the graph in its
    original numbering, adopt ``serving.json``. Idempotent on a rerun (the
    plan build resumes; the pointer write is last)."""
    from dgraph_tpu_torch.partition import partition_graph
    from dgraph_tpu_torch.plan import build_plan_shards

    os.makedirs(run_dir, exist_ok=True)
    edge_index = np.asarray(edge_index)
    features = np.asarray(features, np.float32)
    num_nodes = int(features.shape[0])
    new_edges, ren = partition_graph(
        edge_index, num_nodes, world_size, method=partition_method, seed=seed,
    )
    part_orig = np.asarray(ren.partition)[np.asarray(ren.perm)]
    _atomic_savez(
        graph_path(run_dir, 0),
        edge_index=edge_index,  # the original numbering: deltas append to it
        features=features,
        partition=part_orig,
    )
    build_plan_shards(
        new_edges, ren.partition, out_dir=plan_dir(run_dir, 0),
        world_size=world_size, pad_multiple=pad_multiple,
        write_layout=True, memory_budget_bytes=memory_budget_bytes,
    )
    rec = {
        "kind": "serve_world",
        "generation": 0,
        "world_size": int(world_size),
        "num_nodes": num_nodes,
        "num_edges": int(edge_index.shape[1]),
        "feat_dim": int(features.shape[1]),
        "pad_multiple": int(pad_multiple),
        "partition_method": partition_method,
        "seed": int(seed),
        "deltas_adopted": 0,
    }
    write_world(run_dir, rec)
    return rec


# --- staged deltas --------------------------------------------------------------


def staged_delta_paths(run_dir: str, generation: int) -> list:
    d = delta_dir(run_dir, generation)
    if not os.path.isdir(d):
        return []
    return sorted(
        os.path.join(d, f) for f in os.listdir(d)
        if f.startswith("delta_") and f.endswith(".npz")
    )


def append_delta(run_dir: str, features, edge_index) -> dict:
    """Durably stage new vertices (and their edges, which may name any
    existing or just-appended vertex) against the current generation.
    Returns the record, with ``id_base``: the appended vertices' original
    ids are ``id_base .. id_base + k``.

    Stage here first, then install live with ``engine.append_vertices``: a
    crash between the two replays the append from disk at the next re-plan
    instead of losing it."""
    # the reference's chaos.fire("serve.delta_append") (slice 12's chaos/)
    feats = np.asarray(features, np.float32)
    edges = np.asarray(edge_index, np.int64)
    if edges.size and (edges.ndim != 2 or edges.shape[0] != 2):
        raise DeltaError(f"delta edge_index must be [2, m], got {edges.shape}")
    edges = edges.reshape(2, -1)
    k = int(feats.shape[0])
    with _run_lock(run_dir):
        # under the lock: the pointer read, the seq / id_base derivation and
        # the publish are one step against this process's other appenders
        # and against replan's commit (which re-snapshots under this lock)
        world = read_world(run_dir)
        gen = int(world["generation"])
        if feats.ndim != 2 or feats.shape[1] != int(world["feat_dim"]):
            raise DeltaError(
                f"delta features must be [k, {world['feat_dim']}], got "
                f"{feats.shape}"
            )
        os.makedirs(delta_dir(run_dir, gen), exist_ok=True)
        while True:
            existing = staged_delta_paths(run_dir, gen)
            if existing:
                # every delta file carries its id_base and new_nodes, so the
                # next base reads one file's scalars
                last = np.load(existing[-1])
                id_base = int(last["id_base"]) + int(last["new_nodes"])
            else:
                id_base = int(world["num_nodes"])
            if edges.size and (
                edges.min() < 0 or edges.max() >= id_base + k
            ):
                raise DeltaError(
                    f"delta edges reference vertex ids outside "
                    f"[0, {id_base + k})"
                )
            seq = len(existing)
            path = os.path.join(
                delta_dir(run_dir, gen), f"delta_{seq:04d}.npz"
            )
            tmp = path + ".tmp.npz"
            np.savez(
                tmp, features=feats, edge_index=edges,
                id_base=np.int64(id_base), new_nodes=np.int64(k),
            )
            try:
                # no-clobber publish: link() fails where os.replace would
                # overwrite, if another process took this seq; then the seq
                # and id_base are derived again
                os.link(tmp, path)
                os.unlink(tmp)
                break
            except FileExistsError:
                os.unlink(tmp)
    return {
        "kind": "serve_delta",
        "generation": gen,
        "seq": seq,
        "new_nodes": k,
        "new_edges": int(edges.shape[1]),
        "id_base": id_base,
    }


# --- the background re-plan and the atomic adoption -----------------------------


def replan(
    run_dir: str, *, memory_budget_bytes: Optional[int] = None,
    max_rounds: int = 5,
) -> dict:
    """Fold every staged delta into generation ``g+1`` and adopt it.

    Crash-safe and rerunnable: every artifact is written under the new
    generation's names (the old one stays intact and adopted), the plan
    build resumes from its own manifest, the graph snapshot write is
    atomic, and the ``serving.json`` write is the one commit point.

    Append-safe: the commit re-snapshots the staged set under the lock
    ``append_delta`` publishes under. A delta that landed while the build
    ran is never orphaned: another round folds it in (up to
    ``max_rounds``, then a :class:`DeltaError` asks to quiesce appends),
    and only a build whose input set is still current adopts.

    The composition holds the whole graph on the host (base plus staged
    deltas); ``memory_budget_bytes`` bounds the plan build's per-shard
    peak, not this step. With nothing staged this is a no-op returning the
    current pointer."""
    from dgraph_tpu_torch.partition import renumber_contiguous
    from dgraph_tpu_torch.plan import build_plan_shards

    world = read_world(run_dir)
    gen, W = int(world["generation"]), int(world["world_size"])
    # the reference's chaos.fire("serve.replan") at entry (slice 12)
    delta_paths = staged_delta_paths(run_dir, gen)
    if not delta_paths:
        return world
    # the reference's span "serve.replan" around the rounds (slice 11)
    for _round in range(max_rounds):
        base = np.load(graph_path(run_dir, gen))
        part = np.asarray(base["partition"])
        fill = np.bincount(part, minlength=W).astype(np.int64)
        feats = [np.asarray(base["features"])]
        edges = [np.asarray(base["edge_index"])]
        parts = [part]
        for p in delta_paths:
            d = np.load(p)
            k = int(d["features"].shape[0])
            # the same waterfill the live append ran (it mutates fill), so
            # the placement composes identically
            parts.append(assign_new_vertices(fill, k))
            feats.append(np.asarray(d["features"]))
            edges.append(np.asarray(d["edge_index"]))
        partition_full = np.concatenate(parts)
        features_full = np.concatenate(feats)
        edges_full = np.concatenate(edges, axis=1)
        V_new = int(partition_full.shape[0])
        ren = renumber_contiguous(partition_full, W)
        new_edges = np.asarray(ren.perm)[edges_full]
        build_plan_shards(
            new_edges, ren.partition,
            out_dir=plan_dir(run_dir, gen + 1),
            world_size=W, pad_multiple=int(world.get("pad_multiple", 8)),
            write_layout=True, memory_budget_bytes=memory_budget_bytes,
        )
        _atomic_savez(
            graph_path(run_dir, gen + 1),
            edge_index=edges_full,
            features=features_full,
            partition=partition_full,
        )
        # every artifact is durable; the pointer write below is the commit
        # (the reference's second chaos.fire("serve.replan") point: a kill
        # here must leave generation g adopted)
        with _run_lock(run_dir):
            latest = staged_delta_paths(run_dir, gen)
            if latest == delta_paths:
                rec = {
                    **world,
                    "generation": gen + 1,
                    "num_nodes": V_new,
                    "num_edges": int(edges_full.shape[1]),
                    "deltas_adopted": int(world.get("deltas_adopted", 0))
                    + len(delta_paths),
                }
                write_world(run_dir, rec)
                return rec
        # a delta landed mid-build: adopting now would orphan it (the next
        # generation reads only its own staged directory), so fold again
        # with the grown set
        delta_paths = latest
    raise DeltaError(
        f"staged deltas kept arriving across {max_rounds} replan "
        "rounds; quiesce appends (or raise max_rounds) to adopt"
    )


# --- loading an adopted generation into a serving engine ------------------------


def load_generation(run_dir: str, *, verify: bool = True, ranks: Optional[list] = None,
                    generation: Optional[int] = None,
                    load_layout: Optional[bool] = None) -> dict:
    """What a :class:`~dgraph_tpu_torch.serve.engine.ServeEngine` needs
    for a generation (default: the adopted one; ``generation`` names
    another): the plan and layout (from the sharded artifact), the
    vertex-sharded batch ``{"x", "vmask"}`` (numpy ``[len(ranks), n_pad,
    ...]``) and the original-id -> (rank, slot) maps.

    ``ranks`` (default every rank) reads only those ranks' plan shards, as
    :func:`~dgraph_tpu_torch.comm.multihost.process_local_plan_shards`
    does, and shards only their vertex rows; the plan's ``ranks`` names
    them. ``load_layout`` (default: with every rank, as the reference's
    always does) reads the O(E) layout sidecar, which edge weights need."""
    from dgraph_tpu_torch.partition import renumber_contiguous
    from dgraph_tpu_torch.plan import load_sharded_plan

    world = read_world(run_dir)
    W = int(world["world_size"])
    gen = int(world["generation"]) if generation is None else int(generation)
    rank_list = list(range(W)) if ranks is None else [int(r) for r in ranks]
    if load_layout is None:
        load_layout = ranks is None
    plan, layout = load_sharded_plan(plan_dir(run_dir, gen), ranks=ranks, verify=verify,
                                     load_layout=load_layout)
    graph = np.load(graph_path(run_dir, gen))
    part = np.asarray(graph["partition"])
    V = int(part.shape[0])
    ren = renumber_contiguous(part, W)
    n_pad = int(plan.n_src_pad)
    feats = np.asarray(graph["features"], np.float32)[ren.inv]
    x = np.zeros((len(rank_list), n_pad) + feats.shape[1:], np.float32)
    vmask = np.zeros((len(rank_list), n_pad), np.float32)
    for i, r in enumerate(rank_list):
        lo, hi = int(ren.offsets[r]), int(ren.offsets[r + 1])
        x[i, : hi - lo] = feats[lo:hi]
        vmask[i, : hi - lo] = 1.0
    id_rank = np.asarray(ren.partition)[np.asarray(ren.perm)]
    id_slot = np.asarray(ren.perm) - np.asarray(ren.offsets)[id_rank]
    return {
        "world": world,
        "generation": gen,
        "plan": plan,
        "layout": layout,
        "ranks": rank_list,
        "edge_index": np.asarray(graph["edge_index"]),
        "batch": {"x": x, "vmask": vmask},
        "id_rank": id_rank.astype(np.int32),
        "id_slot": id_slot.astype(np.int32),
        "num_nodes": V,
    }


def engine_inputs(run_dir: str, *, ranks: Optional[list] = None,
                  generation: Optional[int] = None, add_symmetric_norm: bool = False,
                  verify: bool = True) -> dict:
    """:func:`load_generation`, with ``batch`` as torch tensors and, with
    ``add_symmetric_norm``, the GCN edge weights of the generation's
    composed graph (so the norms of old vertices beside new edges change
    at adoption, as in the reference) laid out for ``ranks``."""
    import torch

    from dgraph_tpu_torch.data.graph import symmetric_norm_weights
    from dgraph_tpu_torch.partition import renumber_contiguous
    from dgraph_tpu_torch.plan import shard_edge_data

    info = load_generation(run_dir, verify=verify, ranks=ranks, generation=generation,
                           load_layout=add_symmetric_norm)
    batch = {k: torch.from_numpy(v) for k, v in info["batch"].items()}
    if add_symmetric_norm:
        ren = renumber_contiguous(np.asarray(info["id_rank"]), int(info["world"]["world_size"]))
        new_edges = np.asarray(ren.perm)[info["edge_index"]]
        w = symmetric_norm_weights(new_edges, info["num_nodes"])
        batch["edge_weight"] = torch.from_numpy(shard_edge_data(
            w, info["layout"], int(info["plan"].e_pad))[info["ranks"]])
    return dict(info, batch=batch)


def build_engine(run_dir: str, model, params=None, *, add_symmetric_norm: bool = False,
                 verify: bool = True, adopt_from=None, **engine_kwargs):
    """A fresh (unwarmed) engine on the adopted generation, stamped with
    ``engine.generation``: what a :class:`~dgraph_tpu_torch.serve.
    registry.ModelRegistry` activates after a re-plan. ``params`` (a state
    dict) is loaded into ``model`` first; None keeps the module's
    parameters (adoption changes the graph, not the checkpoint:
    ``swap_params`` does that).

    Over W graph ranks every rank holds only its own plan shard and vertex
    rows. At the first generation every rank calls this at the same point
    (the engine's control group is collective). To adopt a later one while
    an engine serves, rank 0 alone calls it with ``adopt_from=`` that
    engine and ``model`` its module: the engine announces the build under
    its dispatch lock (the ``ADOPT`` op), every rank loads the generation,
    one agreement says every rank could, and only then does every rank
    build the new engine (a follower inside the old engine's ``follow()``,
    which then follows the new one in a thread of its own). A generation
    some rank could not load raises :class:`DeltaError` on rank 0 with the
    old engine still serving."""
    from dgraph_tpu_torch.serve.engine import ServeEngine, model_comm

    if params is not None:
        model.load_state_dict(params)
    if adopt_from is not None and adopt_from.world_size > 1:
        if params is not None or model is not adopt_from.model:
            raise ValueError(
                "adopting a generation over W ranks builds the new engine on the serving "
                "engine's module on every rank: pass model=adopt_from.model and no params "
                "(swap_params changes parameters)")
        return adopt_from._adopt_generation(run_dir, add_symmetric_norm=add_symmetric_norm,
                                            verify=verify, **engine_kwargs)
    comm = model_comm(model)
    W, rank = comm.get_world_size(), comm.get_rank()
    info = engine_inputs(run_dir, ranks=None if W == 1 else [rank],
                         add_symmetric_norm=add_symmetric_norm, verify=verify)
    eng = ServeEngine(model, info["plan"], info["batch"], info["id_rank"], info["id_slot"],
                      **engine_kwargs)
    eng.generation = info["generation"]
    return eng
