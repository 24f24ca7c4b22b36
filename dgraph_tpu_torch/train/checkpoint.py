"""Train-state checkpoints: the counterpart of the state half of
``dgraph_tpu/train/checkpoint.py`` (``:29-216``).

The reference saves a pytree through orbax; here a step is a directory
``step_XXXXXXXX/`` holding the state's ``torch.save`` (``state.pt``) and its
top-level keys (``keys.json``), so the names, :func:`all_steps` and
:func:`quarantined_steps` read as the reference's do. A save writes both
files into a sibling ``step_XXXXXXXX.tmp.<pid>`` (a name :func:`all_steps`
cannot parse), fsyncs them and the directory, renames it into place and
fsyncs ``ckpt_dir``: a killed save leaves no step behind, and a host crash
no step whose bytes are not durable. Saving a step that exists replaces it
(orbax's ``force=True``). Tensors are saved from the CPU and come back with
their bits; :func:`restore_checkpoint` reads with ``weights_only=True``.

The **template** is the torch form of orbax's ``item=``: a tree (dicts,
lists, tuples) of the same keys and lengths, each tensor with the same shape
and dtype (an optimizer's ``state_dict()`` inside too). A restored tree that
does not match it raises :class:`TemplateMismatch`; what the restore rules
call "readable raw" is a step that loads with no template.

**Over ranks** (the port runs a process a rank; the reference one program)
every caller goes through :func:`restore_agreed` and :func:`save_agreed`:
global rank 0 alone resolves the step (falling back, quarantining) and
alone writes; the others restore the step it took by name. ``ckpt_dir``
must be on storage every host sees, as the reference's orbax directory is.

The reference's ``cached_edge_plan`` (the plan cache, the second half of
its module) is slice 9c of the port.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
import shutil
from typing import Any, Callable, Optional

import torch

_logger = logging.getLogger("dgraph_tpu_torch.checkpoint")

STATE_FILE = "state.pt"
KEYS_FILE = "keys.json"


class TemplateMismatch(ValueError):
    """A restored tree differs from the template in structure, shape or dtype."""


def atomic_pickle_dump(path: str, obj: Any) -> None:
    """Pickle to a temp file, flush + fsync, then os.replace into place:
    concurrent readers (multi-process launches polling a cache path) never
    see a truncated artifact, and a HOST crash cannot leave a
    durable-looking but empty/truncated file behind the rename — without
    the fsync, os.replace can commit the name before the kernel commits
    the data, and the post-crash filesystem shows a valid path holding
    zero bytes."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def step_path(ckpt_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def to_cpu(tree):
    """``tree`` with every tensor detached and on the CPU (a CPU tensor
    stays itself: ``torch.save`` copies its bytes at once)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree


def _write_synced(path: str, write: Callable) -> None:
    with open(path, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(ckpt_dir: str, state: dict, step: int) -> None:
    """Save a state dict (e.g. ``{'params': ..., 'opt_state': ..., 'step':
    ...}``) as step ``step`` of ``ckpt_dir``, replacing one that exists."""
    # the reference's ``ckpt.save`` chaos point fires here (slice 12's chaos/)
    os.makedirs(ckpt_dir, exist_ok=True)
    final = step_path(ckpt_dir, step)
    tmp = f"{final}.tmp.{os.getpid()}"
    old = f"{final}.old.{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    try:
        keys = sorted(map(str, state)) if isinstance(state, dict) else None
        _write_synced(os.path.join(tmp, KEYS_FILE), lambda f: f.write(json.dumps(keys).encode()))
        cpu = to_cpu(state)
        _write_synced(os.path.join(tmp, STATE_FILE), lambda f: torch.save(cpu, f))
        _fsync_dir(tmp)
        # a directory cannot be renamed over a non-empty one: the old step
        # steps aside first (a crash here loses that step, as orbax's
        # force=True deletes it before writing)
        replaced = os.path.isdir(final)
        if replaced:
            os.replace(final, old)
        os.replace(tmp, final)
        _fsync_dir(ckpt_dir)
        if replaced:
            shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def all_steps(ckpt_dir: str) -> list:
    """Ascending list of checkpoint step numbers present in ``ckpt_dir``.
    Quarantined entries (``step_XXXXXXXX.corrupt``, see
    :func:`restore_checkpoint`) and a save's temporary directories are
    skipped."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d.split("_")[1])
        for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    )


def quarantined_steps(ckpt_dir: str) -> list:
    """Ascending step numbers of quarantined (``.corrupt``-renamed)
    checkpoint dirs. Rename a dir back to ``step_XXXXXXXX`` to retry it."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and d.endswith(".corrupt"):
            num = d[len("step_"):-len(".corrupt")]
            if num.isdigit():
                out.append(int(num))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def check_template(template, got, where: str = "") -> None:
    """Raise :class:`TemplateMismatch` unless ``got`` has ``template``'s
    structure: the same dict keys, list and tuple lengths, and each tensor
    the same shape and dtype; a leaf that is not a tensor matches any leaf
    that is neither a tensor nor a container."""
    here = where or "<root>"
    if isinstance(template, dict):
        if not isinstance(got, dict):
            raise TemplateMismatch(f"{here}: a dict in the template, {type(got).__name__} saved")
        if set(template) != set(got):
            missing, extra = set(template) - set(got), set(got) - set(template)
            raise TemplateMismatch(f"{here}: keys differ (missing {sorted(map(str, missing))}, "
                                   f"not in the template {sorted(map(str, extra))})")
        for k in template:
            check_template(template[k], got[k], f"{where}.{k}" if where else str(k))
    elif isinstance(template, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(template):
            raise TemplateMismatch(f"{here}: a sequence of {len(template)} in the template, "
                                   f"{type(got).__name__} saved")
        for i, (t, g) in enumerate(zip(template, got)):
            check_template(t, g, f"{where}[{i}]")
    elif isinstance(template, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise TemplateMismatch(f"{here}: a tensor in the template, {type(got).__name__} saved")
        if got.shape != template.shape or got.dtype != template.dtype:
            raise TemplateMismatch(f"{here}: {tuple(template.shape)} {template.dtype} in the "
                                   f"template, {tuple(got.shape)} {got.dtype} saved")
    elif isinstance(got, (dict, list, tuple, torch.Tensor)):
        raise TemplateMismatch(f"{here}: a leaf in the template, {type(got).__name__} saved")


def _read(path: str, template):
    """One step directory's state, checked against ``template``."""
    file = os.path.join(path, STATE_FILE)
    if not os.path.isfile(file):
        # a step directory without its state is unreadable, not missing
        raise OSError(f"{path} holds no {STATE_FILE}")
    got = torch.load(file, map_location="cpu", weights_only=True)
    if template is not None:
        check_template(template, got)
    return got


def _restore(ckpt_dir: str, template, step: Optional[int]) -> tuple:
    """(state, the step it came from) or (None, None): the rules of
    :func:`restore_checkpoint`."""
    # the reference's ``ckpt.read`` chaos point fires here (slice 12's chaos/)
    steps = all_steps(ckpt_dir)
    if step is not None:
        if step not in steps:
            raise FileNotFoundError(
                f"checkpoint step {step} not found under {ckpt_dir!r} (present: {steps})")
        steps = [step]
    if not steps:
        return None, None
    last_err = None
    failed = []  # (step, path, error) pending quarantine
    for s in reversed(steps):
        path = step_path(ckpt_dir, s)
        try:
            got = _read(path, template)
        except Exception as e:  # noqa: BLE001 — any read/parse/template failure
            if step is not None:
                raise
            last_err = e
            failed.append((s, path, e))
            _logger.warning("checkpoint step_%08d unreadable (%s: %s); falling back to "
                            "next-older step", s, type(e).__name__, e)
            continue
        # quarantine ONLY once an older step restored (the reader works),
        # and only a step unreadable even raw: one that loads raw failed
        # the template (a schema change) and stays a resume candidate
        for fs, fpath, fe in failed:
            if template is not None:
                try:
                    _read(fpath, None)
                    _logger.warning(
                        "checkpoint step_%08d restores raw but not into the given template "
                        "(%s: %s); NOT quarantining — likely a state-schema mismatch, not "
                        "corruption", fs, type(fe).__name__, fe)
                    continue
                except Exception:  # noqa: BLE001 — genuinely unreadable
                    pass
            qpath = fpath + ".corrupt"
            try:
                os.replace(fpath, qpath)
                _logger.warning("checkpoint step_%08d quarantined to %s (%s: %s)", fs,
                                os.path.basename(qpath), type(fe).__name__, fe)
            except OSError as qe:
                _logger.warning("checkpoint step_%08d quarantine failed: %s", fs, qe)
        return got, s
    # every step failed: likely systematic (a bad template); quarantining
    # here would destroy the evidence wholesale
    raise last_err


def restore_checkpoint(ckpt_dir: str, template=None, step: Optional[int] = None):
    """Restore the given (or latest) step, checked against ``template``
    (None: the raw saved tree); None if no checkpoint exists. Tensors land
    on the CPU: a caller moves them with ``load_state_dict``.

    With ``step=None`` (the serving / resume path) an unreadable step
    (killed mid-save, torn copy) does not abort the restore: it is logged,
    the next-older step is tried, and once an older step restores (the
    reader and template work) each failed step that is unreadable even raw
    is **quarantined**, renamed to ``step_XXXXXXXX.corrupt``, so it is never
    re-read or re-logged. A failed step that loads raw is a schema mismatch:
    logged and kept. When every step fails the last error propagates and
    nothing is quarantined. A named ``step`` is strict: missing raises
    ``FileNotFoundError``, unreadable raises its own error and is never
    quarantined."""
    return _restore(ckpt_dir, template, step)[0]


def checkpoint_keys(ckpt_dir: str, step: Optional[int] = None):
    """Top-level keys of the given (or latest) checkpoint, read from its key
    file without loading a tensor; None if no checkpoint exists or its key
    file is unreadable. Lets a caller pick a restore template from what
    the checkpoint contains (e.g. an ``'ema'`` track)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    try:
        with open(os.path.join(step_path(ckpt_dir, step), KEYS_FILE), "rb") as f:
            keys = json.loads(f.read().decode())
    except (OSError, ValueError):
        return None
    return set(keys) if isinstance(keys, list) else None


# --- over ranks --------------------------------------------------------------


def _world_host_pg(group):
    return group.world_host_pg or group.host_pg


def _single(group) -> bool:
    return group is None or group.world_size * group.num_replicas == 1


def on_rank0(group, fn: Callable[[], Any]):
    """``fn()`` on global rank 0 alone, its value (pickled) on every rank of
    all R * W (``group``: a :class:`~dgraph_tpu_torch.comm.dist.RankGroup`,
    None for one rank). When ``fn`` raises there, every rank raises: rank 0
    its own error, the others a ``RuntimeError`` naming it. The broadcast
    is a host barrier: no rank goes on before rank 0's ``fn`` returned."""
    if _single(group):
        return fn()
    import torch.distributed as dist

    box, err = [None], None
    if group.global_rank == 0:
        try:
            box[0] = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — every rank raises below
            err, box[0] = e, ("error", f"{type(e).__name__}: {e}")
    dist.broadcast_object_list(box, src=0, group=_world_host_pg(group))
    if err is not None:
        raise err
    kind, value = box[0]
    if kind == "error":
        raise RuntimeError(f"global rank 0 failed: {value}")
    return value


def on_every_rank(group, fn: Callable[[], Any]):
    """``fn()`` on every rank, then one all-reduce of who failed: if any
    rank's ``fn`` raised, every rank raises (that rank its own error)."""
    if _single(group):
        return fn()
    import torch.distributed as dist

    out, err = None, None
    try:
        out = fn()
    except Exception as e:  # noqa: BLE001 — agreed below
        err = e
    flags = torch.zeros(group.world_size * group.num_replicas, dtype=torch.int32)
    flags[group.global_rank] = int(err is not None)
    dist.all_reduce(flags, group=_world_host_pg(group))
    if err is not None:
        raise err
    failed = flags.nonzero().flatten().tolist()
    if failed:
        raise RuntimeError(f"global rank(s) {failed} failed")
    return out


def save_agreed(ckpt_dir: str, state: dict, step: int, group=None) -> None:
    """:func:`save_checkpoint` on global rank 0 alone (every rank holds the
    same replicated state), then a host barrier, so no rank reads the step
    before it is durable; a failed save raises on every rank."""
    on_rank0(group, lambda: save_checkpoint(ckpt_dir, state, step))


def restore_agreed(ckpt_dir: str, template=None, group=None, *,
                   step: Optional[int] = None) -> tuple:
    """(state, step) restored on every rank, or (None, None) with no step.
    Global rank 0 resolves the step by :func:`restore_checkpoint`'s rules
    (a named ``step`` strictly; otherwise falling back and quarantining)
    and broadcasts it; every other rank restores that step by name. If any
    rank's restore raises, every rank raises."""
    got = {}

    def resolve():
        got["state"], s = _restore(ckpt_dir, template, step)
        return s

    s = on_rank0(group, resolve)
    if s is None:
        return None, None
    if not _single(group) and group.global_rank != 0:
        return on_every_rank(group, lambda: restore_checkpoint(ckpt_dir, template, step=s)), s
    return on_every_rank(group, lambda: got["state"]), s
