"""ModelRegistry: named model/graph versions behind one micro-batcher.

A copy of ``dgraph_tpu/serve/registry.py``. The single-engine serving stack
bakes ONE (model, checkpoint, graph) triple into the process for its
lifetime; every change meant a restart and a cold warmup. The registry is
the control-plane indirection that removes that coupling:

- Named entries, each one warmed :class:`~dgraph_tpu_torch.serve.engine.
  ServeEngine` plus its lineage (the audit trail of checkpoint swaps and
  graph-generation adoptions that produced its current state).
- ONE entry is *active*; the :class:`~dgraph_tpu_torch.serve.batcher.
  MicroBatcher` resolves the active engine **per batch**, so activating a
  replacement engine is an atomic flip between batches — in-flight batches
  complete on the engine they started on, the next batch runs on the new
  one, and no request is ever dropped by an adoption. Over W graph ranks
  the engines of one rank share its dispatch lock, so a flip between two
  engines on the same ranks never interleaves their collectives.
- Checkpoint rollover (:meth:`~dgraph_tpu_torch.serve.engine.ServeEngine.
  swap_params`) mutates an entry's engine in place (same tensors, new
  values) and appends to its lineage; graph-delta adoption builds a NEW
  engine for the new generation and :meth:`~ModelRegistry.activate`\\ s it.

This module imports neither torch nor jax, as the reference's is jax-free
by contract: the engines it holds are opaque objects, so the registry and
lineage bookkeeping stays importable by health tooling in processes that
never load a backend.
"""

from __future__ import annotations

import threading
import time
from typing import Optional


class _Entry:
    __slots__ = ("name", "engine", "registered_at", "lineage", "retired")

    def __init__(self, name: str, engine, lineage: Optional[list] = None):
        self.name = name
        self.engine = engine
        self.registered_at = time.time()
        self.lineage = list(lineage or [])
        self.retired = False


class ModelRegistry:
    """Named serving versions with one atomically-switchable active entry.

    Thread-safe: ``activate`` runs on operator/control threads while the
    batcher's worker thread reads :attr:`active_engine` per batch — the
    flip is one reference assignment under the lock, and readers only ever
    see entirely the old or entirely the new engine.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._active: Optional[str] = None

    # --- registration / activation ---

    def register(self, name: str, engine, *, activate: bool = False,
                 lineage: Optional[list] = None) -> None:
        """Add (or replace) the named entry. Replacing an entry whose
        engine the batcher may be flushing on is safe — the old engine
        object stays alive until its in-flight batch resolves. Replacing
        the entry that is (or becomes) ACTIVE applies the same
        ladder-coverage rule as :meth:`activate`: requests already
        admitted against the old ladder must still fit."""
        name = str(name)
        with self._lock:
            prior = self._entries.get(name)
            becomes_active = activate or self._active in (None, name)
            if (
                prior is not None and becomes_active
                and not _ladder_covers(engine, prior.engine)
            ):
                raise ValueError(
                    f"replacement engine for active model {name!r} has a "
                    "smaller bucket ladder than the entry it replaces; "
                    "admitted requests could no longer fit"
                )
            entry = _Entry(name, engine,
                           lineage=prior.lineage if prior else lineage)
            self._entries[name] = entry
            if activate or self._active is None:
                self._active = name

    def activate(self, name: str, engine=None,
                 *, note: Optional[dict] = None) -> None:
        """Make ``name`` the active entry (optionally installing a new
        engine for it first — the graph-delta adoption path). The ladder
        of a replacement engine must cover the old one's ``max_size`` so
        requests admitted against the old ladder still fit; a shrinking
        swap must go through a fresh entry name instead."""
        name = str(name)
        with self._lock:
            if engine is not None:
                prior = self._entries.get(name)
                if prior is not None and not _ladder_covers(
                    engine, prior.engine
                ):
                    raise ValueError(
                        f"replacement engine for {name!r} has a smaller "
                        "bucket ladder than the entry it replaces; "
                        "admitted requests could no longer fit"
                    )
                entry = _Entry(name, engine,
                               lineage=prior.lineage if prior else None)
                if note:
                    entry.lineage.append(dict(note))
                self._entries[name] = entry
            if name not in self._entries:
                raise KeyError(f"no registered model {name!r}")
            self._active = name

    def retire(self, name: str) -> None:
        """Drop a named entry (must not be active)."""
        name = str(name)
        with self._lock:
            if name == self._active:
                raise ValueError(f"cannot retire the active model {name!r}")
            self._entries.pop(name, None)

    def note(self, name: str, record: dict) -> None:
        """Append one lineage record (swap/adoption outcome) to an entry."""
        with self._lock:
            entry = self._entries.get(str(name))
            if entry is not None:
                entry.lineage.append(dict(record))

    # --- lookup ---

    @property
    def active_name(self) -> Optional[str]:
        # under the lock like every other reader: _active is flipped by
        # activate()/register() on operator threads, and an unlocked
        # read here was the one hole in the registry's locking story
        # (host-lock-discipline; pinned in test_analysis_host)
        with self._lock:
            return self._active

    @property
    def active_engine(self):
        """The engine the next batch should run on; raises KeyError with
        an empty registry (a misconfigured stack must fail loudly, not
        NoneType its way into the worker thread)."""
        with self._lock:
            if self._active is None:
                raise KeyError("ModelRegistry has no active model")
            return self._entries[self._active].engine

    def get(self, name: str):
        with self._lock:
            entry = self._entries.get(str(name))
            if entry is None:
                raise KeyError(f"no registered model {name!r}")
            return entry.engine

    def names(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def lineage(self, name: str) -> list:
        with self._lock:
            entry = self._entries.get(str(name))
            return list(entry.lineage) if entry else []

    def record(self) -> dict:
        """JSONL-able control-plane snapshot for the serve_health record."""
        with self._lock:
            return {
                "active": self._active,
                "models": {
                    n: {
                        "registered_at": e.registered_at,
                        "lineage": list(e.lineage),
                    }
                    for n, e in sorted(self._entries.items())
                },
            }


def _ladder_covers(new_engine, old_engine) -> bool:
    """True when the new engine's ladder can serve every request size the
    old one admitted (duck-typed: engines are opaque here by the jax-free
    contract)."""
    try:
        return int(new_engine.ladder.max_size) >= int(old_engine.ladder.max_size)
    except AttributeError:
        return True
