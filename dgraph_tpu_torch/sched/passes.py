"""Pass pipeline: traffic matrix -> verified multi-round HaloSchedule.

The compiler proper. Input is the EdgePlan's static rank-to-rank
traffic matrix ``pair_rows[src][dst]`` (deduped live halo rows the
plan packs into the (src -> dst) send block) plus the slot height
``s_pad``; output is a :class:`~dgraph_tpu_torch.sched.ir.HaloSchedule` that
:func:`~dgraph_tpu_torch.sched.ir.verify_schedule` accepts against the same
matrix. Three passes, in order:

1. **normalize** — one :class:`~dgraph_tpu_torch.sched.ir.Transfer` per live
   pair, covering rows ``[0, count)``. Dead pairs (zero rows, incl. the
   diagonal) emit nothing: this is the delta-skip the fixed lowerings
   can't express per-pair (all_to_all ships every block dense; a
   ppermute ring ships a full [S] operand for every rank on the ring
   even when only one pair is live).
2. **split** — recursive-doubling decomposition ("The Big Send-off",
   PAPERS.md): any transfer wider than the split threshold is halved
   recursively, so one hub-heavy pair becomes several round-sized
   chunks that pack alongside the small pairs instead of forcing every
   round's padded operand to hub height. Default threshold: twice the
   median live pair count (skew-relative — a uniform matrix never
   splits), floor 1.
3. **pack + order** — greedy first-fit-decreasing into conflict-free
   rounds (no rank twice as src or twice as dst per round; chunk must
   fit under the round's padded height C inside ``s_pad``), then rounds
   ordered by descending estimated ICI load ``C * len(transfers)`` so
   the heavy rounds issue first and the serial tail is the cheap tail
   (mirrors the overlap executor's absorb-behind-interior story, which
   footprint prices per-round).

Everything is deterministic pure-stdlib arithmetic on ints — ties break
on (src, dst, row_start) — so every rank compiling the same full-world
matrix gets the byte-identical schedule (same ``schedule_id``), which is
what makes attach-at-plan-build safe under SPMD: rank-divergent round
order is the deadlock class the issue-sequence auditor checks.
"""

from __future__ import annotations

from dgraph_tpu_torch.sched.ir import (
    HaloSchedule,
    Round,
    Transfer,
    normalize_pair_rows,
    verify_schedule,
)


def normalize_transfers(pair_rows) -> list:
    """Pass 1: one whole-pair Transfer per live (src, dst), rows
    ``[0, count)``; dead pairs emit nothing."""
    out = []
    for src, row in enumerate(pair_rows):
        for dst, count in enumerate(row):
            if count > 0 and src != dst:
                out.append(Transfer(src=src, dst=dst, row_start=0,
                                    row_count=int(count)))
    return out


def default_split_threshold(transfers: list) -> int:
    """Twice the median live row count: skew-relative, so a uniform
    matrix compiles unsplit while one hub pair among small ones is
    chopped down to ride the small rounds."""
    counts = sorted(t.row_count for t in transfers)
    if not counts:
        return 1
    median = counts[len(counts) // 2]
    return max(1, 2 * median)


def split_transfers(transfers: list, threshold: int) -> list:
    """Pass 2: recursively halve any transfer wider than ``threshold``.
    Halving (not fixed-size chunking) keeps the chunk count a power of
    two per pair and the chunk sizes within 1 row of each other."""
    out = []

    def rec(t: Transfer):
        if t.row_count <= threshold:
            out.append(t)
            return
        half = t.row_count // 2
        rec(Transfer(t.src, t.dst, t.row_start, half))
        rec(Transfer(t.src, t.dst, t.row_start + half, t.row_count - half))

    for t in transfers:
        rec(t)
    return out


def pack_rounds(transfers: list, s_pad: int) -> list:
    """Pass 3a: first-fit-decreasing into conflict-free rounds.

    Sorted descending by row_count, each round's padded height C is set
    by its first (largest) member, so the fit check for a later chunk is
    only ``row_start + C <= s_pad`` (its own rows always fit under C)
    plus src/dst conflict-freedom. FFD keeps same-height chunks of a
    split hub pair in consecutive rounds while small pairs fill the
    leftover src/dst slots of every round: small pairs merge into the
    rounds the large ones set.
    """
    order = sorted(transfers,
                   key=lambda t: (-t.row_count, t.src, t.dst, t.row_start))
    rounds = []  # each: {"C": int, "srcs": set, "dsts": set, "ts": list}
    for t in order:
        placed = False
        for r in rounds:
            if (t.src not in r["srcs"] and t.dst not in r["dsts"]
                    and t.row_start + r["C"] <= s_pad):
                r["srcs"].add(t.src)
                r["dsts"].add(t.dst)
                r["ts"].append(t)
                placed = True
                break
        if not placed:
            rounds.append({"C": t.row_count, "srcs": {t.src},
                           "dsts": {t.dst}, "ts": [t]})
    return rounds


def order_rounds(rounds: list) -> tuple:
    """Pass 3b: heaviest estimated ICI load first (``C * transfers``),
    deterministic tie-break on the round's sorted transfer keys."""

    def key(r):
        ts = sorted(r["ts"], key=lambda t: (t.src, t.dst, t.row_start))
        return (-r["C"] * len(ts),
                tuple((t.src, t.dst, t.row_start) for t in ts))

    out = []
    for r in sorted(rounds, key=key):
        ts = sorted(r["ts"], key=lambda t: (t.src, t.dst, t.row_start))
        out.append(Round(transfers=tuple(ts)))
    return tuple(out)


def compile_halo_schedule(pair_rows, *, s_pad: int,
                          world_size: int = None,
                          split_threshold: int = None) -> HaloSchedule:
    """The full pipeline; the result is verified against ``pair_rows``
    before return, so a compiler bug is a loud ValueError at plan build,
    never a silently-dropped halo block at exchange time."""
    rows = normalize_pair_rows(pair_rows, world_size)
    W = len(rows)
    transfers = normalize_transfers(rows)
    if transfers:
        threshold = (split_threshold if split_threshold is not None
                     else default_split_threshold(transfers))
        threshold = min(threshold, int(s_pad))
        transfers = split_transfers(transfers, max(1, threshold))
    schedule = HaloSchedule(
        world_size=W,
        s_pad=int(s_pad),
        rounds=order_rounds(pack_rounds(transfers, int(s_pad))),
    )
    failures = verify_schedule(schedule, rows)
    if failures:
        raise ValueError(
            "compile_halo_schedule produced an unverifiable schedule "
            f"(compiler bug): {failures[:5]}"
        )
    return schedule
