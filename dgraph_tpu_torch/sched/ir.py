"""Halo schedule IR: the compiled multi-round collective schedule, as data.

The schedule-as-data compilation model of "GC3: An Optimizing Compiler
for GPU Collective Communication" (PAPERS.md), applied to the halo
exchange: instead of one fixed lowering shape (dense ``all_to_all``, one
``ppermute`` ring per delta), the EdgePlan's sparse rank-to-rank traffic
matrix (``plan.halo_pair_rows``) is compiled by :mod:`dgraph_tpu_torch.sched.
passes` into an explicit :class:`HaloSchedule` — a list of
:class:`Round`\\ s, each a set of non-conflicting (src, dst, row-slice)
:class:`Transfer`\\ s — that the generic round executor in
``comm.collectives`` replays under ``halo_impl="sched"``.

Contracts:

- **jax-free + stdlib-only** (``analysis.lint``'s ``jax-free-module``
  rule): the IR must construct, serialize, and VERIFY on a host where
  jax is wedged or absent — the compiler and its selftest perform zero
  XLA compiles by construction.
- **Hashable**: every node is a frozen dataclass of ints/tuples, so a
  schedule can ride an :class:`~dgraph_tpu_torch.plan.EdgePlan`'s STATIC aux
  (jit cache keys, ``functools.lru_cache``'d executor factories) without
  ceremony.
- **Serializable**: ``to_dict``/``from_dict`` round-trip through plain
  JSON; :attr:`HaloSchedule.schedule_id` is a content hash of the
  canonical serialization, so two ranks (or two commits) holding the
  same id provably hold the same round order — the identity the SPMD
  issue-sequence auditor and ``obs.regress``'s byte-exact gate key on.

Row-slice semantics: transfer rows index the PACKED (src -> dst) send
block — the plan packs each (sender, needer) pair's live rows from row 0
of its ``s_pad`` slot block, so rows ``[0, halo_pair_rows[src][dst])``
are live and rows beyond are mask-zero padding. A round ships one
uniform ``[row_count, F]`` operand per rank (``lax.ppermute`` requires a
single shape), so smaller transfers in a round ride padded rows — value-
safe because padded rows are masked zero on send and masked zero again
on the reverse reduce.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

# Bump when a serialized field changes meaning; additive fields do not
# bump (from_dict ignores unknown keys). Stamped into every to_dict().
SCHED_IR_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Transfer:
    """One (src, dst, row-slice) move: rows ``[row_start, row_start +
    row_count)`` of the packed (src -> dst) send block. ``src != dst``
    always — the self block never rides the wire (same convention as the
    all_to_all lowering's self-block accounting in obs.footprint)."""

    src: int
    dst: int
    row_start: int
    row_count: int

    def to_dict(self) -> dict:
        return {"src": self.src, "dst": self.dst,
                "row_start": self.row_start, "row_count": self.row_count}

    @classmethod
    def from_dict(cls, d: dict) -> "Transfer":
        return cls(src=int(d["src"]), dst=int(d["dst"]),
                   row_start=int(d["row_start"]),
                   row_count=int(d["row_count"]))


@dataclasses.dataclass(frozen=True)
class Round:
    """One collective round: a set of transfers no two of which share a
    sender or a receiver — exactly the conflict-freedom one
    ``lax.ppermute`` with partial pairs can carry."""

    transfers: tuple  # tuple[Transfer, ...]

    @property
    def row_count(self) -> int:
        """The round's uniform padded operand height C: every rank ships
        ``[C, F]`` (ppermute is single-shape), so C is the max member
        row_count and smaller members ride masked padding."""
        return max((t.row_count for t in self.transfers), default=0)

    @property
    def pairs(self) -> tuple:
        """Static ``lax.ppermute`` permutation: one (src, dst) per
        transfer, in transfer order."""
        return tuple((t.src, t.dst) for t in self.transfers)

    def to_dict(self) -> dict:
        return {"transfers": [t.to_dict() for t in self.transfers]}

    @classmethod
    def from_dict(cls, d: dict) -> "Round":
        return cls(transfers=tuple(
            Transfer.from_dict(t) for t in d["transfers"]
        ))


@dataclasses.dataclass(frozen=True)
class HaloSchedule:
    """A compiled halo-exchange schedule for one plan's traffic matrix.

    ``s_pad`` is the plan's per-pair slot height (every row index below
    lives in ``[0, s_pad)``); the executor lands round operands at
    ``src * s_pad + row_start`` of the ``[W * s_pad, F]`` halo buffer —
    the same slot numbering the all_to_all lowering produces, which is
    what makes the two bit-identical.
    """

    world_size: int
    s_pad: int
    rounds: tuple  # tuple[Round, ...]
    version: int = SCHED_IR_VERSION

    @property
    def num_rounds(self) -> int:
        return len(self.rounds)

    @property
    def num_transfers(self) -> int:
        return sum(len(r.transfers) for r in self.rounds)

    def round_rows(self) -> tuple:
        """Per-round padded operand height C_k — the row count every rank
        ships in round k (obs.footprint prices ``C_k * row_bytes``)."""
        return tuple(r.row_count for r in self.rounds)

    def operand_rows(self) -> int:
        """Total rows one shard ships across all rounds (the 'sched' row
        of footprint's ``wire_bytes_per_shard`` at ``* row_bytes``)."""
        return sum(self.round_rows())

    def rank_arrays(self, k: int) -> dict:
        """Round k's per-rank STATIC placement tables, one int per rank —
        the executor indexes them with the traced ``lax.axis_index`` so
        every rank traces the IDENTICAL program (the SPMD-divergence
        class the issue-sequence auditor proves absent):

        - ``send_dst[r]``: peer row r gathers its send block for (its own
          transfer's dst; r itself when r does not send — the self row's
          mask is all-zero, so the unused operand is zeros).
        - ``send_start[r]``: row offset of r's outgoing slice (0 when
          idle).
        - ``place_off[r]``: where r's received block lands in the
          ``[W*s_pad + C, F]`` halo buffer (``src*s_pad + row_start``;
          the scratch tail ``W*s_pad`` when r receives nothing — ppermute
          hands non-receivers zeros, which the dropped tail absorbs).
        - ``slice_off[r]``: where r slices the reverse leg's cotangent
          block from (0 when r receives nothing — the slice feeds a
          reversed permutation that drops it).
        - ``back_plane[r]``: which ``[W+1, s_pad]`` reduce-buffer plane
          r's returning reverse block lands in (its transfer's dst; the
          scratch plane W when r sent nothing this round).
        """
        W, S = self.world_size, self.s_pad
        send_dst = list(range(W))
        send_start = [0] * W
        place_off = [W * S] * W
        slice_off = [0] * W
        back_plane = [W] * W
        for t in self.rounds[k].transfers:
            send_dst[t.src] = t.dst
            send_start[t.src] = t.row_start
            back_plane[t.src] = t.dst
            place_off[t.dst] = t.src * S + t.row_start
            slice_off[t.dst] = t.src * S + t.row_start
        return {
            "send_dst": tuple(send_dst),
            "send_start": tuple(send_start),
            "place_off": tuple(place_off),
            "slice_off": tuple(slice_off),
            "back_plane": tuple(back_plane),
        }

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "world_size": self.world_size,
            "s_pad": self.s_pad,
            "rounds": [r.to_dict() for r in self.rounds],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HaloSchedule":
        return cls(
            world_size=int(d["world_size"]),
            s_pad=int(d["s_pad"]),
            rounds=tuple(Round.from_dict(r) for r in d["rounds"]),
            version=int(d.get("version", SCHED_IR_VERSION)),
        )

    @property
    def schedule_id(self) -> str:
        """Content hash of the canonical serialization: equal ids imply
        equal round order on every holder (rank, commit, ledger row)."""
        key = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha1(key.encode()).hexdigest()[:12]


def normalize_pair_rows(pair_rows, world_size: int = None) -> tuple:
    """Canonical ``[W][W]`` tuple-of-tuples traffic matrix from any
    nested int sequence (numpy rows, JSON lists, tuples). Raises on a
    ragged or mis-sized matrix — a silently truncated traffic matrix
    would compile a schedule that drops transfers, the exact vacuity the
    verifier exists to catch."""
    rows = tuple(tuple(int(v) for v in row) for row in pair_rows)
    W = world_size if world_size is not None else len(rows)
    if len(rows) != W or any(len(r) != W for r in rows):
        raise ValueError(
            f"pair_rows must be [{W}][{W}]; got "
            f"{len(rows)} rows of lengths {sorted({len(r) for r in rows})}"
        )
    if any(v < 0 for row in rows for v in row):
        raise ValueError("pair_rows entries must be non-negative row counts")
    return rows


def verify_schedule(schedule: HaloSchedule, pair_rows) -> list:
    """Every invariant the executor's bit-parity with all_to_all rides
    on, as a failure list (empty == verified):

    - bounds: ranks in ``[0, W)``, no self transfers, live rows only
      (``row_start + row_count <= pair_rows[src][dst]``), and the padded
      round operand stays inside the slot block
      (``row_start + round C <= s_pad``);
    - conflict-freedom: no rank appears twice as sender or twice as
      receiver inside one round (one ppermute carries at most one
      outgoing and one incoming block per rank);
    - coverage: every live (src, dst) pair's rows ``[0, count)`` are
      covered by its transfers exactly once (a gap is a silently dropped
      halo block; an overlap of LIVE ranges would make the reverse
      reduce double-count) and dead pairs carry no transfers.

    The selftest's vacuity mutants (a conflicting round, a dropped
    transfer) must turn this list non-empty — a verifier that cannot go
    RED proves nothing.
    """
    failures = []
    W, S = schedule.world_size, schedule.s_pad
    try:
        rows = normalize_pair_rows(pair_rows, W)
    except ValueError as e:
        return [f"pair_rows: {e}"]
    covered: dict = {}
    for k, rnd in enumerate(schedule.rounds):
        C = rnd.row_count
        if not rnd.transfers:
            failures.append(f"round {k}: empty round (dead launch)")
        senders: set = set()
        receivers: set = set()
        for t in rnd.transfers:
            tag = f"round {k}: transfer {t.src}->{t.dst}"
            if not (0 <= t.src < W and 0 <= t.dst < W):
                failures.append(f"{tag}: rank out of [0, {W})")
                continue
            if t.src == t.dst:
                failures.append(f"{tag}: self transfer (never on the wire)")
            if t.row_count < 1 or t.row_start < 0:
                failures.append(f"{tag}: empty or negative row slice")
            if t.row_start + t.row_count > rows[t.src][t.dst]:
                failures.append(
                    f"{tag}: rows [{t.row_start}, "
                    f"{t.row_start + t.row_count}) exceed the pair's "
                    f"{rows[t.src][t.dst]} live rows"
                )
            if t.row_start + C > S:
                failures.append(
                    f"{tag}: row_start {t.row_start} + round C {C} "
                    f"exceeds s_pad {S} (padded operand leaves the slot)"
                )
            if t.src in senders:
                failures.append(
                    f"round {k}: rank {t.src} sends twice (conflicting "
                    f"round — one ppermute carries one block per sender)"
                )
            if t.dst in receivers:
                failures.append(
                    f"round {k}: rank {t.dst} receives twice (conflicting "
                    f"round — two blocks cannot land in one operand)"
                )
            senders.add(t.src)
            receivers.add(t.dst)
            covered.setdefault((t.src, t.dst), []).append(
                (t.row_start, t.row_start + t.row_count)
            )
    for s in range(W):
        for d in range(W):
            count = rows[s][d]
            ranges = sorted(covered.get((s, d), []))
            if count == 0:
                if ranges:
                    failures.append(
                        f"pair {s}->{d}: transfers scheduled for a pair "
                        f"with zero live rows"
                    )
                continue
            pos = 0
            for lo, hi in ranges:
                if lo > pos:
                    failures.append(
                        f"pair {s}->{d}: rows [{pos}, {lo}) uncovered "
                        f"(dropped transfer — the halo block silently "
                        f"never arrives)"
                    )
                elif lo < pos:
                    failures.append(
                        f"pair {s}->{d}: rows [{lo}, {pos}) covered twice "
                        f"(the reverse reduce would double-count)"
                    )
                pos = max(pos, hi)
            if pos < count:
                failures.append(
                    f"pair {s}->{d}: rows [{pos}, {count}) uncovered "
                    f"(dropped transfer — the halo block silently never "
                    f"arrives)"
                )
    return failures
