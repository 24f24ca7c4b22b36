"""Hot-swap checkpoint rollover: restore -> stage -> validate -> adopt | roll back.

Counterpart of ``dgraph_tpu/serve/rollover.py``. A serving fleet cannot
restart to pick up a new checkpoint: a restart drops every queued request
and warms every bucket again. The parameters are a ``state_dict`` of the
live module, so a rollover that keeps its keys, shapes and dtypes writes
new values into the same tensors. This module is the state machine around
that write:

```
            restore_checkpoint(step|path)        .to(device, copy=True)
  RESTORE ────────────────────────────────► STAGED ─────────────────► VALIDATE
                                                                        │
          pre_swap() raised (the fault point)?          ── yes ──► ROLLBACK
          keys / shapes / dtypes == the live state_dict? ── no ──► ROLLBACK
          every float tensor finite?                     ── no ──► ROLLBACK
          full forward finite on the real vertices?      ── no ──► ROLLBACK
          bucket rows == full forward rows, bit for bit? ── no ──► ROLLBACK
                          │ yes
                          ▼
                        ADOPT   (copy_ into the live tensors, under the dispatch lock)
```

The reference passes its staged tree as an argument to its compiled
programs. Here both validation forwards run the LIVE module on the staged
tensors through ``torch.func.functional_call``, under the dispatch lock, so
no request's forward runs meanwhile and the live tensors never hold
anything unvalidated: ROLLBACK is free. ADOPT copies each staged tensor
into the live one (``copy_``), so every parameter keeps its storage and
its ``data_ptr()``. That is the torch meaning of the reference's
zero-new-compiles pin (``rollover.py:254-262``): the tensors a CUDA graph a
bucket would capture are the ones a swap writes. The port compiles
nothing, so the reference's ``recompile`` rejection has no counterpart.
Adoption is atomic per batch: a dispatch holds the same lock.

**Over W graph ranks** rank 0 restores (resolving the step by the
reference's rules), then announces the swap on the engine's control group
as it announces a dispatch (``engine.SWAP``): the resolved ``(ckpt_dir,
step)``, or the state dict for ``params=``, and the parity rows. Every rank
then runs :func:`swap_on_rank` under its dispatch lock; a follower restores
that step strictly from the shared directory. Each check ends in one
all-reduce over ``host_pg`` of which ranks failed it, so every rank adopts
or every rank rolls back between the same two dispatches, and rank 0
raises :class:`SwapRejected` naming the failing ranks. A failure inside a
validation forward (its collectives) is a :class:`~dgraph_tpu_torch.serve.
engine.RankLost`, as for a dispatch: the ranks may be out of step, so it is
not a rollback.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from dgraph_tpu_torch.serve.bucketing import pad_ids
from dgraph_tpu_torch.serve.errors import EngineStopped, SwapRejected


def params_mismatch(old: dict, new) -> Optional[str]:
    """None when ``new`` can be written into ``old`` (the live
    ``state_dict``: the same keys, each tensor of the same shape and
    dtype); otherwise a human-readable reason."""
    if not isinstance(new, dict):
        return f"a state dict was expected, got {type(new).__name__}"
    missing, extra = sorted(set(old) - set(new)), sorted(set(new) - set(old))
    if missing or extra:
        return f"state dict keys differ: missing {missing}, unexpected {extra}"
    for k, a in old.items():
        b = new[k]
        if not isinstance(b, torch.Tensor):
            return f"param {k!r} is a {type(b).__name__}, not a tensor"
        if a.shape != b.shape or a.dtype != b.dtype:
            return (f"param {k!r} differs: {tuple(a.shape)}/{a.dtype} vs "
                    f"{tuple(b.shape)}/{b.dtype}")
    return None


def nonfinite_param_leaves(params: dict) -> int:
    """Count of floating tensors carrying any non-finite value: a checkpoint
    that diverged before it was saved must never reach traffic."""
    return sum(1 for v in params.values()
               if v.is_floating_point() and not bool(torch.isfinite(v).all()))


def _params_of(state, step: Optional[int]) -> tuple:
    """(state dict, step) of a restored checkpoint: a train state with a
    ``'params'`` entry (and its ``'step'``) or a bare state dict."""
    params = state["params"] if isinstance(state, dict) and "params" in state else state
    if isinstance(state, dict) and "step" in state:
        step = int(state["step"])
    return params, step


def _restore(engine, source, step) -> tuple:
    """(state dict, ckpt_dir, the step it records, the step directory it
    came from) by :func:`~dgraph_tpu_torch.train.checkpoint.
    restore_checkpoint`'s rules, or the reference's restore rejection."""
    from dgraph_tpu_torch.train.checkpoint import _restore as restore_with_step

    ckpt_dir = source if source is not None else engine.ckpt_dir
    if not ckpt_dir:
        raise SwapRejected(
            "no checkpoint source: pass a directory (or params=) or build "
            "the engine via from_checkpoint",
            reason="no_source", rolled_back=False,
        )
    try:
        state, dir_step = restore_with_step(ckpt_dir, None, step)
    except Exception as e:  # noqa: BLE001 — unreadable/corrupt checkpoint
        raise SwapRejected(
            f"checkpoint restore failed: {type(e).__name__}: {e}",
            reason="restore_failed", ckpt_dir=ckpt_dir, rolled_back=False,
        )
    if state is None:
        raise SwapRejected(
            f"no checkpoint under {ckpt_dir!r}",
            reason="not_found", ckpt_dir=ckpt_dir, rolled_back=False,
        )
    params, restored_step = _params_of(state, step)
    return params, ckpt_dir, restored_step, dir_step


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def _timed(stages: dict, name: str, t0: float) -> None:
    stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0


def swap_on_rank(engine, params, restore: Optional[dict],
                 slot_idx: np.ndarray) -> Optional[tuple]:
    """One rank's swap, the dispatch lock held (rank 0 and every follower
    alike): the checks, each agreed over the ranks, the stage, the two
    validation forwards, the adoption. ``params`` is the state dict rank 0
    restored or was given; a follower of a checkpoint swap gets None and
    restores ``restore``'s step strictly. ``slot_idx``: the parity rows of
    the smallest bucket. Returns None once adopted, else ``(reason,
    detail)``, the same reason on every rank. Stage seconds land in
    ``engine.last_swap_s``."""
    from dgraph_tpu_torch.serve.engine import RankLost
    from dgraph_tpu_torch.train.checkpoint import restore_checkpoint

    stages = engine.last_swap_s
    box = {"state": params}

    def agree(reason: str, check: Callable[[], Optional[str]]) -> Optional[tuple]:
        """``check()``'s failure message (an exception's too), then every
        rank's verdict: ``(reason, detail)`` if any rank failed."""
        try:
            err = check()
        except RankLost:
            raise
        except Exception as e:  # noqa: BLE001 — this rank failed the check
            err = f"{type(e).__name__}: {e}"
        t = time.perf_counter()
        failed = engine._agree(f"the swap's {reason} agreement", err is not None)
        _timed(stages, "agree", t)
        if not failed:
            return None
        if engine.world_size > 1:
            err = f"{err + '; ' if err else ''}failed on rank(s) {failed}"
        return reason, err

    def restored() -> Optional[str]:
        if box["state"] is None:  # a follower: rank 0's step, strictly
            t = time.perf_counter()
            try:
                state = restore_checkpoint(restore["ckpt_dir"], step=restore["dir_step"])
            except Exception as e:  # noqa: BLE001 — unreadable on this rank
                return f"checkpoint restore failed: {type(e).__name__}: {e}"
            finally:
                _timed(stages, "restore", t)
            box["state"] = _params_of(state, None)[0]
        return None

    def fault_point() -> None:
        # the reference's chaos.fire("serve.swap") (slice 12's chaos/)
        if engine.pre_swap is not None:
            engine.pre_swap()

    live = engine.model.state_dict()
    for reason, check in (
        ("restore_failed", restored),
        ("fault", fault_point),
        ("structure_mismatch", lambda: params_mismatch(live, box["state"])),
        ("nonfinite_params", lambda: (
            f"{n} param leaf(s) carry non-finite values"
            if (n := nonfinite_param_leaves(box["state"])) else None)),
    ):
        out = agree(reason, check)
        if out is not None:
            return out

    # STAGE: new tensors on the rank's device; the live ones do not move
    t = time.perf_counter()
    staged = {k: v.to(device=engine.device, copy=True) for k, v in box["state"].items()}
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    _timed(stages, "stage", t)

    # VALIDATE: the live module on the staged tensors, full forward first,
    # then the served path's rows of the parity ids
    def forward(fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — over ranks: out of step now
            if engine.world_size > 1:
                raise engine._lose("a swap's validation forward", e) from e
            raise

    t = time.perf_counter()
    full = forward(lambda: engine._forward(staged))
    real = torch.from_numpy(engine._id_slot[engine._id_rank == engine.rank]).to(engine.device)
    out = agree("nonfinite_logits", lambda: None if bool(torch.isfinite(full[real]).all()) else
                "new checkpoint produces non-finite logits on real vertices")
    if out is not None:
        return out
    slot = torch.from_numpy(np.ascontiguousarray(slot_idx, np.int64)).to(engine.device)
    served = forward(lambda: engine._bucket_rows(slot, staged))
    ref = full[slot]
    out = agree("parity", lambda: None if _same_bits(served, ref) else (
        "served logits diverge from the eval forward under the new checkpoint (max abs "
        f"diff {float((served.float() - ref.float()).abs().max())})"))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    _timed(stages, "validate", t)
    if out is not None:
        return out

    # ADOPT: into the live tensors, each keeping its storage
    t = time.perf_counter()
    with torch.no_grad():
        for k, v in live.items():
            v.copy_(staged[k])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    _timed(stages, "adopt", t)
    return None


def swap_params(engine, source=None, *, step: Optional[int] = None,
                params=None, parity_ids=None) -> dict:
    """Run the rollover state machine on ``engine`` (rank 0's); returns the
    adopted lineage record or raises :class:`SwapRejected` with the
    rollback record (the prior parameters serving either way).

    ``parity_ids``: explicit vertex ids for the served == eval oracle;
    default the first ``min(smallest bucket, num_nodes)`` ids.
    """
    from dgraph_tpu_torch.serve.engine import SWAP, RankLost

    engine._check_front("swap_params")
    t0 = time.perf_counter()
    stages = engine.last_swap_s = {}
    rec = {
        "kind": "serve_rollover",
        "event": "swap",
        "adopted": False,
        "rolled_back": False,
    }

    def finish(**fields) -> None:
        rec.update(swap_s=round(time.perf_counter() - t0, 3), **fields)
        engine.lineage.append(dict(rec))

    def reject(reason: str, detail: str):
        finish(reason=reason, detail=detail, rolled_back=True)
        engine.registry.counter("serve.swap_rejected")
        raise SwapRejected(
            f"checkpoint swap rolled back ({reason}): {detail}; prior "
            "params remain installed",
            **{k: v for k, v in rec.items() if k != "kind"},
        )

    # RESTORE (outside the dispatch lock: disk IO must not stall a dispatch)
    if params is None:
        try:
            params, ckpt_dir, restored_step, dir_step = _restore(engine, source, step)
        except SwapRejected as e:
            # restore-phase rejections land in the lineage too: ONE record
            # per attempt, adopted or not
            finish(rolled_back=True, reason=e.context.get("reason", "restore"),
                   detail=str(e), ckpt_dir=e.context.get("ckpt_dir", source), step=step)
            engine.registry.counter("serve.swap_rejected")
            raise
        rec.update(ckpt_dir=ckpt_dir, step=restored_step)
        # the followers restore the step DIRECTORY rank 0 resolved, strictly
        payload = {"ckpt_dir": ckpt_dir, "dir_step": dir_step, "step": restored_step}
    else:
        rec.update(ckpt_dir=None, step=step)
        payload = {"params": params, "step": step}
    stages["restore"] = time.perf_counter() - t0

    ids = (np.arange(min(int(engine.ladder.sizes[0]), engine.num_nodes), dtype=np.int64)
           if parity_ids is None else np.asarray(parity_ids))
    padded, _ = pad_ids(ids, engine.ladder.bucket_for(ids.shape[0]))
    slot_idx = engine._id_slot[padded]
    try:
        with engine._dispatch_lock, engine._on_device():
            if engine.world_size > 1:
                if "params" in payload and isinstance(params, dict):  # pickled from the host
                    payload["params"] = {k: v.detach().cpu() if isinstance(v, torch.Tensor)
                                         else v for k, v in params.items()}
                engine._announce(SWAP, payload=dict(payload, slot_idx=slot_idx))
            out = swap_on_rank(engine, params, None, slot_idx)
    except Exception as e:  # noqa: BLE001 — a fault mid-swap: roll back at one rank
        if engine.world_size == 1 and not isinstance(e, EngineStopped):
            out = ("fault", f"{type(e).__name__}: {e}")
        else:
            # not a rollback: over ranks the others may stand anywhere in
            # the swap, so the engine runs no further dispatch
            if not isinstance(e, (RankLost, EngineStopped)):
                e = engine._lose("a swap", e)
            finish(reason="stopped" if isinstance(e, EngineStopped) else "rank_lost",
                   detail=str(e))
            raise e
    if out is not None:
        reject(*out)

    engine.serving_step = rec["step"]
    finish(adopted=True)
    engine.registry.counter("serve.swaps_adopted")
    engine.registry.gauge("serve.swap_s", rec["swap_s"])
    return rec


def follow_swap(engine, payload: dict) -> None:
    """A follower's side of a swap rank 0 announced (the dispatch lock
    held): :func:`swap_on_rank` on the announced step or state dict, one
    lineage record, and the adopted step kept in ``engine.serving_step``.
    A :class:`~dgraph_tpu_torch.serve.engine.RankLost` propagates."""
    t0 = time.perf_counter()
    engine.last_swap_s = {}
    rec = {"kind": "serve_rollover", "event": "swap", "adopted": False, "rolled_back": False,
           "ckpt_dir": payload.get("ckpt_dir"), "step": payload["step"]}
    restore = None if "params" in payload else payload
    out = swap_on_rank(engine, payload.get("params"), restore, payload["slot_idx"])
    if out is None:
        rec["adopted"] = True
        engine.serving_step = payload["step"]
        engine.registry.counter("serve.swaps_adopted")
    else:
        rec.update(rolled_back=True, reason=out[0], detail=out[1])
        engine.registry.counter("serve.swap_rejected")
    rec["swap_s"] = round(time.perf_counter() - t0, 3)
    engine.lineage.append(rec)
