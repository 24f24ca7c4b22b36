"""Train-state checkpoints and the plan cache: the counterpart of
``dgraph_tpu/train/checkpoint.py`` (the state half ``:29-216``, the plan
cache ``:218-419``).

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

The **plan cache** (:func:`cached_edge_plan`) keeps a built plan as a
directory ``plan_<key>/`` of per-rank shards and a checksummed manifest
(:mod:`dgraph_tpu_torch.plan_shards`), under the reference's key
(:func:`_graph_fingerprint`, :data:`PLAN_FORMAT_VERSION`), so the two
packages name, write and read the same artifact. A bad shard is rebuilt
alone; only an unreadable manifest means a full rebuild. Over ranks
(``group=``) global rank 0 alone resolves the plan (loads, repairs or
builds) and alone writes under the cache directory; every other rank then
loads that directory, verified, and never rebuilds: a bad shard there
raises on every rank (processes that rebuilt one artifact would race).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
import shutil
from typing import Any, Callable, Optional

import numpy as np
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


# --- plan cache ----------------------------------------------------------------


# The reference's format version (``dgraph_tpu/train/checkpoint.py:225``):
# part of every key, so a cache of an older format is never read, only
# rebuilt beside. v10 stamps wire_format in the statics, v9 the halo traffic
# matrix (the compiled schedule's input), v8 is the sharded artifact.
PLAN_FORMAT_VERSION = 10


def _hash_array(h, arr: np.ndarray) -> None:
    # memoryview feeds hashlib without a copy of the array
    arr = np.ascontiguousarray(arr)
    h.update(str(arr.dtype).encode())
    h.update(str(arr.shape).encode())
    h.update(memoryview(arr).cast("B"))


def _graph_fingerprint(edge_index: np.ndarray, partition: np.ndarray, **kw) -> str:
    """The plan cache's key: the format version, the edges' and the
    partition's dtype, shape and bytes, and ``repr(sorted(kw.items()))``
    (so a knob's Python type is part of it, as in the reference)."""
    h = hashlib.sha256()
    h.update(f"plan-format-v{PLAN_FORMAT_VERSION};".encode())
    _hash_array(h, edge_index)
    _hash_array(h, partition)
    h.update(repr(sorted(kw.items())).encode())
    return h.hexdigest()[:24]


def _plan_cache_key(edge_index, src_partition, dst_partition, key_extra,
                    build_kwargs) -> tuple:
    """(the key of ``plan_<key>``, the resolved overlap intent).
    The resolved tile sizes and overlap intent are part of the key: the
    builder resolves them from the environment, which a warm cache must
    not ignore. ``key_extra`` folds upstream knobs (the partition method
    and its parameters) into the key without reaching the builder;
    ``write_layout`` shapes the artifact, not the plan, and stays out."""
    from dgraph_tpu_torch import plan as _plan

    overlap = build_kwargs.get("overlap")
    if overlap is None:
        overlap = _plan.resolve_overlap_intent()
    key = _graph_fingerprint(
        edge_index,
        src_partition if dst_partition is None
        else np.concatenate([src_partition, dst_partition]),
        scatter_block_e=_plan.SCATTER_BLOCK_E,
        scatter_block_n=_plan.SCATTER_BLOCK_N,
        overlap=bool(overlap),
        **{f"x_{k}": v for k, v in sorted((key_extra or {}).items())
           if v is not None and (np.isscalar(v) or isinstance(v, str))},
        **{k: v for k, v in build_kwargs.items()
           if k not in ("overlap", "write_layout") and (np.isscalar(v) or isinstance(v, str))},
    )
    return key, bool(overlap)


def _resolve_cached_plan(cache_dir, edge_index, src_partition, dst_partition, *, ranks,
                         load_layout, memory_budget_bytes, verify, key_extra,
                         build_kwargs) -> tuple:
    """(plan_dir, (plan, layout)): load ``plan_<key>`` or repair or build
    it, by :func:`cached_edge_plan`'s rules."""
    from dgraph_tpu_torch import plan_shards as ps
    from dgraph_tpu_torch.plan import build_edge_plan_sharded, load_sharded_plan

    os.makedirs(cache_dir, exist_ok=True)
    # the sharded cache always builds through the numpy per-rank core (the
    # port has no native plan core; the reference's fills the whole
    # [W, e_pad] stack at once): an explicit use_native is ignored
    if build_kwargs.pop("use_native", None):
        _logger.warning(
            "plan cache %s: use_native is ignored for sharded (v8) cache builds — the "
            "streaming numpy core bounds peak memory by one shard", cache_dir)
    key, overlap = _plan_cache_key(edge_index, src_partition, dst_partition, key_extra,
                                   build_kwargs)
    plan_dir = os.path.join(cache_dir, f"plan_{key}")

    def build(rebuild_ranks=()):
        return build_edge_plan_sharded(
            edge_index, src_partition, dst_partition, out_dir=plan_dir,
            fingerprint=key, ranks=ranks,
            load_layout=load_layout, memory_budget_bytes=memory_budget_bytes,
            rebuild_ranks=rebuild_ranks, **{**build_kwargs, "overlap": overlap})

    try:
        return plan_dir, load_sharded_plan(plan_dir, ranks=ranks, load_layout=load_layout,
                                           verify=verify)
    except ps.PlanShardError as e:
        # one bad shard is a shard repair, never a full rebuild: the builder
        # resumes past every durable, checksum-intact shard and rebuilds
        # what is broken (and the named shard, should it pass its checksum
        # but not unpickle)
        _logger.warning("plan cache %s: shard %s unreadable (%s); rebuilding that shard",
                        plan_dir, e.rank, e.reason)
        return plan_dir, build(rebuild_ranks=(e.rank,) if e.rank >= 0 else ())
    except ps.PlanManifestError as e:
        if os.path.exists(ps.manifest_path(plan_dir)):
            # incomplete (a killed build: resume) or corrupt (the writer
            # discards what it cannot verify: a full rebuild)
            _logger.warning("plan cache %s: %s; %s", plan_dir, e.reason,
                            "resuming the interrupted build" if "incomplete" in e.reason
                            else "rebuilding")
        return plan_dir, build()


def cached_edge_plan(
    cache_dir: str,
    edge_index: np.ndarray,
    src_partition: np.ndarray,
    dst_partition: Optional[np.ndarray] = None,
    *,
    ranks: Optional[list] = None,
    load_layout: Optional[bool] = None,
    memory_budget_bytes: Optional[int] = None,
    verify: bool = True,
    key_extra: Optional[dict] = None,
    group=None,
    **build_kwargs: Any,
):
    """``build_edge_plan`` with an on-disk sharded cache: ``(plan, layout)``.

    The artifact is ``plan_<key>/`` under ``cache_dir``: a shard a rank and
    a checksummed manifest (:mod:`dgraph_tpu_torch.plan_shards`), written by
    :func:`~dgraph_tpu_torch.plan.build_edge_plan_sharded`. ``key_extra``
    folds scalar knobs into the key without passing them to the builder
    (the partition method and its parameters shaped the inputs; the
    partition's content is hashed as well).

    A load verifies every shard's size and SHA-256 (``verify=False`` skips
    the hash on a hit; a torn shard still fails to unpickle). A corrupt,
    truncated or missing shard rebuilds that shard alone, logged with its
    rank; an incomplete manifest (a killed build) resumes; an unreadable
    manifest rebuilds everything.

    ``ranks`` loads only those shards (the plan's leading axis is
    ``len(ranks)``, its statics the full world's) and defaults
    ``load_layout`` to False: the layout sidecar is O(E).
    ``memory_budget_bytes`` bounds the build's memory a shard.
    ``use_native`` is ignored with a warning. A falsy ``cache_dir`` builds
    without a cache (the CLIs' ``--plan_cache ""``; ``ranks`` then raises).

    ``group`` (a :class:`~dgraph_tpu_torch.comm.dist.RankGroup`; None for
    one process) is the agreed form over ranks, as :func:`restore_agreed`:
    global rank 0 alone resolves the plan (loads, repairs or builds) and
    alone writes under ``cache_dir``; every other rank then loads the
    directory it resolved, always verified, and never rebuilds. If any
    rank fails (a follower that meets a bad shard), every rank raises.
    ``cache_dir`` must be on storage every host sees. Without a cache dir
    every rank builds its own plan.
    """
    from dgraph_tpu_torch.plan import build_edge_plan, load_sharded_plan

    if not cache_dir:
        if ranks is not None:
            raise ValueError(
                "cached_edge_plan(ranks=...) needs a cache_dir: per-rank "
                "loading is a property of the sharded on-disk artifact")
        # the layout sidecar's knob describes the artifact; without a cache
        # there is none (build_edge_plan does not take it)
        build_kwargs.pop("write_layout", None)
        return build_edge_plan(edge_index, src_partition, dst_partition, **build_kwargs)
    ll = load_layout if load_layout is not None else (
        # no sidecar for a rank-subset load, nor when none was written
        ranks is None and build_kwargs.get("write_layout", True))
    kw = dict(ranks=ranks, load_layout=ll, memory_budget_bytes=memory_budget_bytes,
              verify=verify, key_extra=key_extra, build_kwargs=build_kwargs)
    if _single(group):
        return _resolve_cached_plan(cache_dir, edge_index, src_partition, dst_partition,
                                    **kw)[1]
    got = {}

    def resolve():
        plan_dir, got["plan"] = _resolve_cached_plan(
            cache_dir, edge_index, src_partition, dst_partition, **kw)
        return plan_dir

    plan_dir = on_rank0(group, resolve)
    if group.global_rank == 0:
        return on_every_rank(group, lambda: got.pop("plan"))
    return on_every_rank(group, lambda: load_sharded_plan(plan_dir, ranks=ranks,
                                                          load_layout=ll, verify=True))
