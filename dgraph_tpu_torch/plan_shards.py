"""Crash-safe sharded plan artifacts: per-rank shard IO and an integrity
manifest. The counterpart of ``dgraph_tpu/plan_shards.py`` (stdlib and
numpy; the same files byte for byte).

A cached plan is a directory of

- one ``shard_XXXX.pkl`` per rank: a plain dict of that rank's plan arrays
  (numpy arrays and Python ints; the schema is
  :func:`dgraph_tpu_torch.plan._assemble_shard_payload`'s), each written
  with :func:`~dgraph_tpu_torch.train.checkpoint.atomic_pickle_dump`;
- ``manifest.json``: per shard its SHA-256 and byte size, the build
  fingerprint, :data:`~dgraph_tpu_torch.train.checkpoint.PLAN_FORMAT_VERSION`,
  the plan statics and the build's progress. It is rewritten atomically
  after every shard, so a build killed mid-way **resumes** from the last
  durable shard;
- an optional ``layout.pkl`` sidecar (the
  :class:`~dgraph_tpu_torch.plan.EdgePlanLayout` arrays), checksummed the
  same way.

Loaders (:func:`~dgraph_tpu_torch.train.checkpoint.cached_edge_plan`,
``DistributedGraph.from_global``, the serve CLI,
``comm.multihost.process_local_plan_shards``) read only the shards they
need and verify their checksums; a corrupt, truncated or missing shard is
rebuilt alone, and only an unreadable manifest means a full rebuild.

The build's memory beyond the O(E) numpy skeleton is bounded by one shard,
and the bound is enforced: the writer (and the build's upfront estimate)
raise :class:`PlanBuildMemoryExceeded` instead of being killed.

The reference fires its chaos points ``plan.write`` (before each shard
write), ``plan.load`` (before each shard read) and ``plan.build_shard``
(before each rank's assembly, in ``plan.build_plan_shards``); the port's
chaos registry comes with its resilience slice, and a comment marks each
place.

``python -m dgraph_tpu_torch.plan_shards --selftest true`` runs the
compile-free checks: manifest round trip and tamper detection, shard
checksum and missing-file detection, writer resume, stale-artifact reclaim
and the memory budget. The reference's chaos checks are left out (and
named in the output).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import pickle
from typing import Any, Iterable, Optional

import numpy as np

from dgraph_tpu_torch.train.checkpoint import atomic_pickle_dump

_logger = logging.getLogger("dgraph_tpu_torch.plan_shards")

MANIFEST_NAME = "manifest.json"
LAYOUT_NAME = "layout.pkl"

# default per-shard memory budget in MiB of a sharded plan build (0 / unset:
# unlimited); an explicit memory_budget_bytes wins. The reference's name.
MEMORY_BUDGET_ENV = "DGRAPH_PLAN_MEMORY_BUDGET_MB"


# ---------------------------------------------------------------------------
# structured errors
# ---------------------------------------------------------------------------


class PlanManifestError(RuntimeError):
    """The manifest is missing, unparseable, or fails its own checksum: the
    one condition that turns a shard repair into a full rebuild."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"plan manifest {path!r} unreadable: {reason}")
        self.path = path
        self.reason = reason


class PlanShardError(RuntimeError):
    """One shard is missing, truncated or fails its checksum: the caller
    rebuilds that shard, not the world."""

    def __init__(self, rank: int, path: str, reason: str):
        super().__init__(f"plan shard {rank} ({path!r}) unreadable: {reason}")
        self.rank = rank
        self.path = path
        self.reason = reason

    def record(self) -> dict:
        return {"kind": "plan_shard_error", "rank": self.rank, "path": self.path,
                "reason": self.reason}


class PlanBuildMemoryExceeded(RuntimeError):
    """The sharded build would exceed its memory budget: raised early and
    structured instead of letting the host kill the build."""

    def __init__(self, needed_bytes: int, budget_bytes: int, rank: Optional[int] = None):
        where = "upfront estimate" if rank is None else f"shard {rank}"
        super().__init__(
            f"plan build {where} needs ~{needed_bytes / 2**20:.1f} MiB per "
            f"shard, over the {budget_bytes / 2**20:.1f} MiB budget "
            f"(raise it via memory_budget_bytes or ${MEMORY_BUDGET_ENV})"
        )
        self.needed_bytes = int(needed_bytes)
        self.budget_bytes = int(budget_bytes)
        self.rank = rank

    def record(self) -> dict:
        return {"kind": "plan_build_memory_exceeded", "needed_bytes": self.needed_bytes,
                "budget_bytes": self.budget_bytes, "rank": self.rank}


def resolve_memory_budget(memory_budget_bytes: Optional[int]) -> Optional[int]:
    """The explicit argument, else the env knob, else None (unlimited)."""
    if memory_budget_bytes is not None:
        return int(memory_budget_bytes) or None
    mb = os.environ.get(MEMORY_BUDGET_ENV, "").strip()
    return int(float(mb) * 2**20) if mb else None


# ---------------------------------------------------------------------------
# checksums and manifest IO
# ---------------------------------------------------------------------------


def _sha256_file(path: str, chunk: int = 1 << 22) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def _manifest_body_sha(manifest: dict) -> str:
    body = {k: v for k, v in manifest.items() if k != "manifest_sha256"}
    return hashlib.sha256(json.dumps(body, sort_keys=True).encode()).hexdigest()


def manifest_path(plan_dir: str) -> str:
    return os.path.join(plan_dir, MANIFEST_NAME)


def shard_filename(rank: int) -> str:
    return f"shard_{rank:04d}.pkl"


def atomic_write_json(path: str, obj: dict) -> None:
    """Durable atomic JSON write (tmp + flush + fsync + rename, as
    ``atomic_pickle_dump``): readers never see a truncated document, and a
    host crash cannot leave a durable-looking empty file behind the
    rename."""
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, sort_keys=True, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def atomic_savez(path: str, **arrays) -> None:
    """Durable atomic ``.npz`` write (savez to tmp + flush + fsync +
    rename), the numpy sibling of :func:`atomic_write_json`."""
    tmp = path + f".tmp.{os.getpid()}.npz"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_manifest(plan_dir: str, manifest: dict) -> None:
    """Atomically write the manifest with its self-checksum."""
    manifest = dict(manifest)
    manifest["manifest_sha256"] = _manifest_body_sha(manifest)
    atomic_write_json(manifest_path(plan_dir), manifest)


def read_manifest(plan_dir: str) -> dict:
    """Read and checksum-verify the manifest; raises
    :class:`PlanManifestError` on any failure (missing file, bad JSON,
    wrong kind, tampered body)."""
    path = manifest_path(plan_dir)
    try:
        with open(path) as f:
            manifest = json.load(f)
    except OSError as e:
        raise PlanManifestError(path, f"{type(e).__name__}: {e}")
    except ValueError as e:
        raise PlanManifestError(path, f"bad JSON: {e}")
    if not isinstance(manifest, dict) or manifest.get("kind") != "plan_manifest":
        raise PlanManifestError(path, "not a plan manifest")
    if manifest.get("manifest_sha256") != _manifest_body_sha(manifest):
        raise PlanManifestError(path, "manifest checksum mismatch")
    return manifest


# ---------------------------------------------------------------------------
# shard IO
# ---------------------------------------------------------------------------


def payload_nbytes(payload: Any) -> int:
    """Total numpy bytes of one shard payload (a dict/list/tuple tree): the
    number the memory budget is held against."""
    if isinstance(payload, dict):
        return sum(payload_nbytes(v) for v in payload.values())
    if isinstance(payload, (list, tuple)):
        return sum(payload_nbytes(v) for v in payload)
    if isinstance(payload, np.ndarray):
        return int(payload.nbytes)
    return 0


def write_shard(plan_dir: str, rank: int, payload: dict) -> dict:
    """Write one rank's payload; returns its manifest entry ``{"file",
    "sha256", "bytes"}``."""
    # the reference's ``plan.write`` chaos point fires here (slice 12's chaos/)
    fname = shard_filename(rank)
    path = os.path.join(plan_dir, fname)
    atomic_pickle_dump(path, payload)
    return {"file": fname, "sha256": _sha256_file(path), "bytes": os.path.getsize(path)}


def read_shard(plan_dir: str, rank: int, entry: dict, *, verify: bool = True) -> dict:
    """Read (and with ``verify`` check the size and SHA-256 of) one shard;
    raises :class:`PlanShardError` with a ``reason`` of ``missing``,
    ``checksum`` or ``unreadable``."""
    # the reference's ``plan.load`` chaos point fires here (slice 12's chaos/)
    path = os.path.join(plan_dir, entry["file"])
    if not os.path.exists(path):
        raise PlanShardError(rank, path, "missing")
    if verify:
        if os.path.getsize(path) != entry["bytes"]:
            raise PlanShardError(
                rank, path, f"checksum (size {os.path.getsize(path)} != {entry['bytes']})")
        if _sha256_file(path) != entry["sha256"]:
            raise PlanShardError(rank, path, "checksum")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:  # noqa: BLE001 — a truncated or corrupt pickle
        raise PlanShardError(rank, path, f"unreadable ({type(e).__name__}: {e})")


def write_layout(plan_dir: str, payload: dict) -> dict:
    """Write the (whole-graph) layout sidecar; returns its manifest entry."""
    path = os.path.join(plan_dir, LAYOUT_NAME)
    atomic_pickle_dump(path, payload)
    return {"file": LAYOUT_NAME, "sha256": _sha256_file(path), "bytes": os.path.getsize(path)}


def read_layout(plan_dir: str, manifest: dict, *, verify: bool = True) -> dict:
    entry = manifest.get("layout")
    if not entry:
        raise PlanShardError(-1, os.path.join(plan_dir, LAYOUT_NAME), "missing")
    path = os.path.join(plan_dir, entry["file"])
    if not os.path.exists(path):
        raise PlanShardError(-1, path, "missing")
    if verify and _sha256_file(path) != entry["sha256"]:
        raise PlanShardError(-1, path, "checksum")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:  # noqa: BLE001
        raise PlanShardError(-1, path, f"unreadable ({type(e).__name__}: {e})")


def bad_shards(plan_dir: str, manifest: dict, ranks: Optional[Iterable[int]] = None) -> dict:
    """rank -> reason for every requested shard that fails its integrity
    check (missing, size, checksum), without unpickling."""
    shards = manifest.get("shards", {})
    out: dict = {}
    for rank in [int(r) for r in (ranks if ranks is not None else shards)]:
        entry = shards.get(str(rank))
        if entry is None:
            out[rank] = "not in manifest"
            continue
        path = os.path.join(plan_dir, entry["file"])
        if not os.path.exists(path):
            out[rank] = "missing"
        elif os.path.getsize(path) != entry["bytes"]:
            out[rank] = "truncated"
        elif _sha256_file(path) != entry["sha256"]:
            out[rank] = "checksum"
    return out


# ---------------------------------------------------------------------------
# streaming writer (resume and memory budget)
# ---------------------------------------------------------------------------


class PlanShardWriter:
    """Streams per-rank shards into ``plan_dir`` with durable progress.

    The manifest is rewritten atomically after every shard, so a killed
    build resumes: a fresh writer with the same ``fingerprint`` adopts the
    durable shards (each re-verified by checksum) and :meth:`done` says
    which ranks to skip. A fingerprint, format-version or statics mismatch
    discards the stale progress and deletes its files: a manifest never
    splices shards of two builds.
    """

    def __init__(self, plan_dir: str, *, fingerprint: str, world_size: int, statics: dict,
                 build_kwargs: Optional[dict] = None,
                 memory_budget_bytes: Optional[int] = None, resume: bool = True,
                 rebuild_ranks: Iterable[int] = ()):
        from dgraph_tpu_torch.train.checkpoint import PLAN_FORMAT_VERSION

        self.plan_dir = plan_dir
        self.budget = resolve_memory_budget(memory_budget_bytes)
        os.makedirs(plan_dir, exist_ok=True)
        self.manifest = {
            "kind": "plan_manifest",
            "format_version": PLAN_FORMAT_VERSION,
            "fingerprint": fingerprint,
            "world_size": int(world_size),
            "statics": dict(statics),
            "build_kwargs": dict(build_kwargs or {}),
            "shards": {},
            "layout": None,
            "complete": False,
        }
        if resume:
            self._adopt_progress({int(r) for r in rebuild_ranks})

    def _adopt_progress(self, rebuild: set) -> None:
        try:
            old = read_manifest(self.plan_dir)
        except PlanManifestError:
            return
        old_statics = old.get("statics", {})
        # finalize() folds the maxed per-shard hints into the durable
        # statics; a fresh writer knows only the build-time keys, so compare
        # on those (extra finalized keys are not drift)
        same = all(old.get(k) == self.manifest[k]
                   for k in ("format_version", "fingerprint", "world_size")) and all(
            old_statics.get(k) == v for k, v in self.manifest["statics"].items())
        if not same:
            # reclaim the stale artifact now, its manifest too, so a kill
            # before the first new shard leaves nothing that names it
            stale = [e["file"] for e in old.get("shards", {}).values()]
            if old.get("layout"):
                stale.append(old["layout"]["file"])
            freed = 0
            for fname in stale:
                path = os.path.join(self.plan_dir, fname)
                try:
                    freed += os.path.getsize(path)
                    os.unlink(path)
                except OSError:
                    pass
            try:
                os.unlink(manifest_path(self.plan_dir))
            except OSError:
                pass
            _logger.info(
                "plan shard progress in %s is from a different build "
                "(fingerprint/format/statics changed); starting fresh "
                "(%d stale file(s) deleted, %.1f MiB reclaimed)",
                self.plan_dir, len(stale), freed / 2**20)
            return
        kept = {rank: entry for rank, entry in old.get("shards", {}).items()
                if int(rank) not in rebuild}
        bad = bad_shards(self.plan_dir, {"shards": kept})
        self.manifest["shards"] = {rank: entry for rank, entry in kept.items()
                                   if int(rank) not in bad}
        if self.manifest["shards"]:
            _logger.info("resuming plan shard build in %s: %d/%d shards already durable",
                         self.plan_dir, len(self.manifest["shards"]),
                         self.manifest["world_size"])

    def done(self, rank: int) -> bool:
        """True when ``rank``'s shard is already durable (resume skips it)."""
        return str(rank) in self.manifest["shards"]

    def check_budget(self, needed_bytes: int, rank: Optional[int] = None) -> None:
        if self.budget is not None and needed_bytes > self.budget:
            raise PlanBuildMemoryExceeded(needed_bytes, self.budget, rank)

    def write(self, rank: int, payload: dict, hints: Optional[dict] = None) -> None:
        """Budget-check, write, and durably record one shard."""
        self.check_budget(payload_nbytes(payload), rank)
        entry = write_shard(self.plan_dir, rank, payload)
        if hints:
            entry["hints"] = {k: int(v) for k, v in hints.items()}
        self.manifest["shards"][str(rank)] = entry
        write_manifest(self.plan_dir, self.manifest)

    def finalize(self, layout_payload: Optional[dict] = None,
                 statics_update: Optional[dict] = None) -> dict:
        """Mark the build complete (every rank present) and return the final
        manifest."""
        missing = [r for r in range(self.manifest["world_size"])
                   if str(r) not in self.manifest["shards"]]
        if missing:
            raise PlanShardError(missing[0], self.plan_dir, "cannot finalize: shard not built")
        if statics_update:
            self.manifest["statics"].update(statics_update)
        if layout_payload is not None:
            self.manifest["layout"] = write_layout(self.plan_dir, layout_payload)
        self.manifest["complete"] = True
        write_manifest(self.plan_dir, self.manifest)
        return dict(self.manifest)


# ---------------------------------------------------------------------------
# selftest CLI (compile-free)
# ---------------------------------------------------------------------------

# the reference selftest's checks this one leaves out, with the reason
SKIPPED_CHECKS = ("chaos points plan.build_shard, plan.write and plan.load: the port's "
                  "chaos registry comes with its resilience slice (slice 12)",)


def _selftest() -> dict:
    import tempfile

    failures: list = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    with tempfile.TemporaryDirectory(prefix="dgraph_plan_shards_") as tmp:
        statics = {"e_pad": 8, "s_pad": 2}
        w = PlanShardWriter(tmp, fingerprint="fp0", world_size=3, statics=statics)
        pay = {"src_index": np.arange(8, dtype=np.int32), "edge_mask": np.ones(8, np.float32)}
        for r in range(2):
            w.write(r, pay, hints={"scatter_mc": r + 1})
        # durable progress: a fresh writer resumes past ranks 0-1
        w2 = PlanShardWriter(tmp, fingerprint="fp0", world_size=3, statics=statics)
        check(w2.done(0) and w2.done(1) and not w2.done(2),
              "writer resume did not adopt durable shards")
        # finalize requires every shard
        try:
            w2.finalize()
            failures.append("finalize accepted a missing shard")
        except PlanShardError:
            pass
        w2.write(2, pay)
        man = w2.finalize(layout_payload={"edge_rank": np.zeros(4, np.int8)})
        check(man["complete"], "finalize did not mark complete")
        man = read_manifest(tmp)
        check(man["complete"] and len(man["shards"]) == 3, "manifest round-trip lost state")
        got = read_shard(tmp, 1, man["shards"]["1"])
        check(np.array_equal(got["src_index"], pay["src_index"]),
              "shard round-trip corrupted payload")
        check(read_layout(tmp, man)["edge_rank"].dtype == np.int8,
              "layout round-trip corrupted payload")
        # corruption: flip one byte -> a checksum error, and bad_shards
        # names exactly that rank
        spath = os.path.join(tmp, man["shards"]["1"]["file"])
        with open(spath, "rb") as f:
            blob = bytearray(f.read())
        blob[len(blob) // 2] ^= 0xFF
        # deliberate in-place corruption: the selftest tests the checksum
        with open(spath, "wb") as f:  # lint: allow(host-durable-write)
            f.write(bytes(blob))
        try:
            read_shard(tmp, 1, man["shards"]["1"])
            failures.append("checksum mismatch not detected")
        except PlanShardError as e:
            check(e.reason == "checksum" and e.record()["rank"] == 1,
                  f"wrong shard error: {e.reason}")
        check(bad_shards(tmp, man) == {1: "checksum"}, f"bad_shards wrong: {bad_shards(tmp, man)}")
        # missing-file detection
        os.unlink(os.path.join(tmp, man["shards"]["0"]["file"]))
        check(bad_shards(tmp, man, ranks=[0]) == {0: "missing"}, "missing shard not detected")
        # manifest tamper detection
        mpath = manifest_path(tmp)
        with open(mpath) as f:
            txt = f.read().replace('"complete": true', '"complete": false')
        # deliberate non-atomic tamper: the selftest tests the checksum
        with open(mpath, "w") as f:  # lint: allow(host-durable-write)
            f.write(txt)
        try:
            read_manifest(tmp)
            failures.append("manifest tamper not detected")
        except PlanManifestError:
            pass

    # a different fingerprint discards the stale progress and deletes the
    # orphaned shard and manifest files
    with tempfile.TemporaryDirectory(prefix="dgraph_plan_shards_") as tmp:
        w = PlanShardWriter(tmp, fingerprint="fp0", world_size=2, statics={})
        w.write(0, {"a": np.zeros(4)})
        w3 = PlanShardWriter(tmp, fingerprint="OTHER", world_size=2, statics={})
        check(not w3.done(0), "stale progress adopted across fingerprints")
        check(not os.path.exists(os.path.join(tmp, shard_filename(0))),
              "stale shard file not deleted on fresh start")
        check(not os.path.exists(manifest_path(tmp)),
              "stale manifest not deleted on fresh start")

    # memory budget: a structured raise
    with tempfile.TemporaryDirectory(prefix="dgraph_plan_shards_") as tmp:
        w = PlanShardWriter(tmp, fingerprint="fp", world_size=1, statics={},
                            memory_budget_bytes=16)
        try:
            w.write(0, {"big": np.zeros(64, np.float32)})
            failures.append("memory budget not enforced")
        except PlanBuildMemoryExceeded as e:
            rec = e.record()
            check(rec["budget_bytes"] == 16 and rec["rank"] == 0 and rec["needed_bytes"] >= 256,
                  f"budget record malformed: {rec}")
    return {"kind": "plan_shards_selftest", "failures": failures,
            "skipped": list(SKIPPED_CHECKS)}


def _main() -> None:
    import dataclasses

    from dgraph_tpu_torch.obs.health import RunHealth
    from dgraph_tpu_torch.utils.cli import parse_config

    @dataclasses.dataclass
    class Config:
        """Sharded plan artifact IO (``--selftest`` for the compile-free
        checks; otherwise a manifest summary of ``--plan_dir``)."""

        selftest: bool = False
        plan_dir: str = ""
        indent: int = 0

    cfg = parse_config(Config)
    health = RunHealth.begin("plan_shards.cli")
    if not cfg.selftest:
        out: dict = {"kind": "plan_manifest_summary", "plan_dir": cfg.plan_dir}
        if cfg.plan_dir:
            try:
                man = read_manifest(cfg.plan_dir)
                out.update(complete=man["complete"], world_size=man["world_size"],
                           fingerprint=man["fingerprint"], shards=len(man["shards"]),
                           bad=bad_shards(cfg.plan_dir, man))
            except PlanManifestError as e:
                out["error"] = str(e)
        out["run_health"] = health.finish(out.get("error"))
        print(json.dumps(out, indent=cfg.indent or None))
        return
    try:
        out = _selftest()
    except BaseException as e:
        print(json.dumps({
            "kind": "plan_shards_selftest",
            "failures": [f"crashed: {type(e).__name__}: {e}"],
            "run_health": health.finish(
                f"plan_shards selftest crashed: {type(e).__name__}: {e}",
                wedge="stage_failure"),
        }))
        raise
    failures = out["failures"]
    out["run_health"] = health.finish("; ".join(failures) if failures else None,
                                      wedge="stage_failure" if failures else None)
    print(json.dumps(out, indent=cfg.indent or None))
    if failures:
        raise SystemExit("plan_shards selftest FAILED: " + "; ".join(failures))


if __name__ == "__main__":
    _main()
