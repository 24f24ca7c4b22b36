"""Schedule-compiler selftest CLI (stdlib only) — counterpart of
``dgraph_tpu/sched/__main__.py``, printing the same JSON.

``python -m dgraph_tpu_torch.sched --selftest true`` proves on fixed fixture
matrices, without importing torch or numpy:

- IR round-trip: to_dict -> JSON -> from_dict is identity, and
  ``schedule_id`` is stable across the trip (the equality every rank's
  round order rests on);
- pass-pipeline invariants: every compiled fixture verifies clean,
  conflict-freedom and exact pair coverage hold, a skewed hub pair is
  recursive-doubling split while a uniform matrix compiles unsplit,
  and compilation is deterministic (same matrix -> same id);
- vacuity mutants: a hand-built conflicting round and a dropped
  transfer must each turn :func:`~dgraph_tpu_torch.sched.ir.verify_schedule`
  RED — a verifier that cannot fail proves nothing.

Exits 1 on any failure.
"""

from __future__ import annotations

import dataclasses
import json
import sys

from dgraph_tpu_torch.sched.ir import (
    HaloSchedule,
    Round,
    Transfer,
    verify_schedule,
)
from dgraph_tpu_torch.sched.passes import compile_halo_schedule

# Fixture traffic matrices: name -> (pair_rows, s_pad).
_FIXTURES = {
    # uniform 4-rank ring: every off-diagonal neighbour pair live
    "uniform_ring": (
        ((0, 5, 0, 5), (5, 0, 5, 0), (0, 5, 0, 5), (5, 0, 5, 0)),
        8,
    ),
    # the motivating skew: one hub-heavy pair among tiny ones
    "skewed_hub": (
        ((0, 64, 1, 2), (1, 0, 1, 0), (2, 1, 0, 1), (0, 2, 1, 0)),
        64,
    ),
    # dense all-pairs
    "dense": (
        ((0, 3, 4, 2), (3, 0, 2, 4), (4, 2, 0, 3), (2, 4, 3, 0)),
        6,
    ),
    # two ranks, one direction
    "one_way_pair": (((0, 7), (0, 0)), 8),
    # no traffic at all
    "empty": (((0, 0), (0, 0)), 4),
}


def _selftest() -> dict:
    failures = []

    def check(cond, msg):
        if not cond:
            failures.append(msg)

    preloaded = {m for m in ("torch", "numpy") if m in sys.modules}

    for name, (rows, s_pad) in _FIXTURES.items():
        sched = compile_halo_schedule(rows, s_pad=s_pad)
        check(verify_schedule(sched, rows) == [],
              f"{name}: compiled schedule fails its own verifier")
        # round-trip: dict -> JSON -> dict -> object is identity
        wire = json.loads(json.dumps(sched.to_dict()))
        back = HaloSchedule.from_dict(wire)
        check(back == sched, f"{name}: JSON round-trip lost structure")
        check(back.schedule_id == sched.schedule_id,
              f"{name}: schedule_id unstable across round-trip")
        # determinism: recompile -> identical id
        check(compile_halo_schedule(rows, s_pad=s_pad).schedule_id
              == sched.schedule_id,
              f"{name}: compilation is not deterministic")
        total = sum(v for row in rows for v in row)
        check(sum(t.row_count for r in sched.rounds for t in r.transfers)
              == total,
              f"{name}: scheduled rows != live rows (coverage leak)")

    # empty matrix -> empty schedule (halo_impl='none' territory)
    check(compile_halo_schedule(_FIXTURES["empty"][0],
                                s_pad=4).num_rounds == 0,
          "empty matrix compiled to non-empty schedule")

    # skew invariant: the 64-row hub pair must be split (several chunks)
    # and must NOT drag every round's padded height to hub size
    hub_rows, hub_s = _FIXTURES["skewed_hub"]
    hub = compile_halo_schedule(hub_rows, s_pad=hub_s)
    hub_chunks = [t for r in hub.rounds for t in r.transfers
                  if (t.src, t.dst) == (0, 1)]
    check(len(hub_chunks) > 1,
          "skewed hub pair was not recursive-doubling split")
    check(min(hub.round_rows()) < 64,
          "every round inherited hub height — small pairs not merged "
          "into cheaper rounds")

    # uniform matrix must compile unsplit: one transfer per live pair
    uni_rows, uni_s = _FIXTURES["uniform_ring"]
    uni = compile_halo_schedule(uni_rows, s_pad=uni_s)
    check(uni.num_transfers
          == sum(1 for row in uni_rows for v in row if v),
          "uniform matrix was split (threshold not skew-relative)")

    # explicit threshold is honoured
    forced = compile_halo_schedule(uni_rows, s_pad=uni_s,
                                   split_threshold=2)
    check(all(t.row_count <= 2 for r in forced.rounds
              for t in r.transfers),
          "explicit split_threshold not honoured")

    # --- vacuity mutants: the verifier must be able to go RED --------
    rows2 = ((0, 4, 3, 0), (2, 0, 0, 0), (0, 0, 0, 0), (0, 0, 0, 0))
    # mutant 1: conflicting round — rank 0 sends twice in one round
    conflict = HaloSchedule(world_size=4, s_pad=4, rounds=(
        Round(transfers=(Transfer(0, 1, 0, 4), Transfer(0, 2, 0, 3))),
        Round(transfers=(Transfer(1, 0, 0, 2),)),
    ))
    check(any("sends twice" in f for f in verify_schedule(conflict, rows2)),
          "vacuity: conflicting round (double sender) not flagged RED")
    # mutant 1b: double receiver
    conflict_rx = HaloSchedule(world_size=4, s_pad=4, rounds=(
        Round(transfers=(Transfer(0, 1, 0, 4), Transfer(2, 1, 0, 1))),
        Round(transfers=(Transfer(1, 0, 0, 2), Transfer(0, 2, 0, 3))),
    ))
    rows2b = ((0, 4, 3, 0), (2, 0, 0, 0), (0, 1, 0, 0), (0, 0, 0, 0))
    check(any("receives twice" in f
              for f in verify_schedule(conflict_rx, rows2b)),
          "vacuity: conflicting round (double receiver) not flagged RED")
    # mutant 2: dropped transfer — the 1->0 block never ships
    dropped = HaloSchedule(world_size=4, s_pad=4, rounds=(
        Round(transfers=(Transfer(0, 1, 0, 4),)),
        Round(transfers=(Transfer(0, 2, 0, 3),)),
    ))
    check(any("uncovered" in f for f in verify_schedule(dropped, rows2)),
          "vacuity: dropped transfer not flagged RED")
    # mutant 3: double-covered rows (reverse reduce would double-count)
    doubled = HaloSchedule(world_size=4, s_pad=4, rounds=(
        Round(transfers=(Transfer(0, 1, 0, 4),)),
        Round(transfers=(Transfer(0, 1, 2, 2), Transfer(1, 0, 0, 2))),
        Round(transfers=(Transfer(0, 2, 0, 3),)),
    ))
    check(any("covered twice" in f for f in verify_schedule(doubled, rows2)),
          "vacuity: double-covered rows not flagged RED")
    # mutant 4: ragged matrix rejected loudly, not truncated silently
    try:
        compile_halo_schedule(((0, 1), (1, 0, 0)), s_pad=2)
        failures.append("vacuity: ragged pair_rows accepted")
    except ValueError:
        pass

    # the compiler core must run without pulling torch or numpy in (this
    # pins the runtime fact when we own the process — under pytest they
    # are already resident, skip then)
    for mod in ("torch", "numpy"):
        if mod not in preloaded:
            check(mod not in sys.modules,
                  f"selftest imported {mod} — compiler core is not stdlib-only")

    return {"kind": "sched_selftest", "fixtures": sorted(_FIXTURES),
            "failures": failures, "ok": not failures}


@dataclasses.dataclass
class Config:
    """Schedule-compiler CLI: ``--selftest true`` runs the compile-free
    invariant + vacuity-mutant suite; exit 1 on any failure."""

    selftest: bool = False
    indent: int = 0


def main(cfg: Config) -> None:
    if not cfg.selftest:
        print(__doc__)
        return
    out = _selftest()
    print(json.dumps(out, indent=cfg.indent or None))
    if out["failures"]:
        raise SystemExit(1)


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
