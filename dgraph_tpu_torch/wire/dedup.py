"""Hub-row dedup: send each replicated boundary row once, fan out by relay —
counterpart of ``dgraph_tpu/wire/dedup.py``, the reference's file with its
import paths pointed at the port's :mod:`dgraph_tpu_torch.sched`.

Power-law graphs concentrate boundary incidence: one high-degree "hub"
vertex is needed by MANY ranks' halos, and every dense lowering (and the
direct compiled schedule) ships its feature row once PER NEEDER from the
owning rank — the owner's egress link pays degree times for one row.
This pass detects those rows at plan-build time, reduces the traffic
matrix so the owner sends each hub row to ONE primary needer, and
compiles extra relay rounds (recursive-doubling broadcast among the
needers) that fan the row out — the owner's egress cost drops from
``len(needers)`` rows to 1, and the relay hops spread across ranks that
were otherwise idle.

Scope: this is a *planning and verification* pass — it proves the
dedup'd round structure delivers every (needer, row) demand exactly once
(reusing :func:`dgraph_tpu_torch.sched.ir.verify_schedule` for the direct
rounds plus a store-and-forward delivery simulation for the relays) and
prices the egress savings. The runtime ``sched`` executor still replays
direct schedules; wiring relay forwarding into the executor is future
work gated on this verifier (docs/wire-formats.md is explicit about the
boundary).

Contracts (same as :mod:`dgraph_tpu_torch.sched.ir`): numpy only, deterministic,
every node a frozen dataclass of ints/tuples, so a dedup plan can be
hashed, serialized, and verified on a host with no accelerator.

Input convention: ``send_idx[src, dst, slot]`` is the owner-local row id
``src`` packs into slot ``slot`` of its (src -> dst) send block;
``send_mask[src, dst, slot]`` is 1 for live slots — exactly the plan's
halo send tables with the leading ``[world_size]`` axis kept.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from dgraph_tpu_torch.sched.ir import HaloSchedule, verify_schedule
from dgraph_tpu_torch.sched.passes import compile_halo_schedule


@dataclasses.dataclass(frozen=True)
class HubRow:
    """One boundary row replicated into ``len(needers)`` ranks' halos.
    ``primary`` (the lowest-ranked needer) receives it directly; the
    rest receive it by relay."""

    src: int
    row: int
    needers: tuple  # tuple[int, ...], sorted, len >= min_fanout
    @property
    def primary(self) -> int:
        return self.needers[0]


@dataclasses.dataclass(frozen=True)
class RelayTransfer:
    """One store-and-forward hop: ``carrier`` (which already holds the
    hub row ``(src, row)``) ships it to needer ``dst``."""

    carrier: int
    dst: int
    src: int
    row: int


@dataclasses.dataclass(frozen=True)
class DedupPlan:
    """The verified artifact: reduced direct schedule + relay rounds.

    ``reduced_live[s][d]`` is the tuple of owner-local row ids the
    reduced (s -> d) block still carries (hub rows only at their primary
    needer); ``reduced_pair_rows`` is its count matrix — the matrix the
    direct schedule is compiled and verified against.
    """

    world_size: int
    s_pad: int
    min_fanout: int
    hubs: tuple  # tuple[HubRow, ...]
    reduced_live: tuple  # [W][W] -> tuple[row ids]
    reduced_pair_rows: tuple  # [W][W] -> int
    direct_schedule: HaloSchedule
    relay_rounds: tuple  # tuple[tuple[RelayTransfer, ...], ...]


def pair_live_rows(send_idx, send_mask) -> tuple:
    """``[W][W]`` tuple-of-tuples of live owner-local row ids per
    (src, dst) send block, slot order preserved, duplicates dropped
    deterministically (first slot wins). Diagonal blocks are never live
    on the wire and are returned empty."""
    idx = np.asarray(send_idx)
    msk = np.asarray(send_mask)
    if idx.ndim != 3 or idx.shape != msk.shape:
        raise ValueError(
            f"send_idx/send_mask must be matching [W, W, S]; got "
            f"{idx.shape} vs {msk.shape}"
        )
    W = idx.shape[0]
    out = []
    for s in range(W):
        row = []
        for d in range(W):
            if s == d:
                row.append(())
                continue
            live = idx[s, d][msk[s, d].astype(bool)]
            row.append(tuple(dict.fromkeys(int(v) for v in live)))
        out.append(tuple(row))
    return tuple(out)


def detect_hub_rows(send_idx, send_mask, min_fanout: int = 2) -> tuple:
    """Rows replicated into at least ``min_fanout`` ranks' halos, as
    :class:`HubRow` records sorted by (src, row)."""
    live = pair_live_rows(send_idx, send_mask)
    W = len(live)
    hubs = []
    for s in range(W):
        needers: dict = {}
        for d in range(W):
            for r in live[s][d]:
                needers.setdefault(r, []).append(d)
        for r in sorted(needers):
            ds = sorted(needers[r])
            if len(ds) >= max(2, int(min_fanout)):
                hubs.append(HubRow(src=s, row=r, needers=tuple(ds)))
    return tuple(sorted(hubs, key=lambda h: (h.src, h.row)))


def _relay_stages(hub: HubRow) -> list:
    """Recursive-doubling broadcast among the needers: every rank that
    holds the row forwards it each stage, so ``k`` needers are covered
    in ``ceil(log2 k)`` relay stages instead of a depth-``k`` chain."""
    holders = [hub.primary]
    pending = list(hub.needers[1:])
    stages = []
    while pending:
        stage = []
        grown = []
        for h in holders:
            if not pending:
                break
            d = pending.pop(0)
            stage.append(RelayTransfer(carrier=h, dst=d,
                                       src=hub.src, row=hub.row))
            grown.append(d)
        holders.extend(grown)
        stages.append(stage)
    return stages


def _pack_relay_rounds(stages_by_depth: list) -> tuple:
    """Greedy conflict-free packing of each depth's relays (no rank
    twice as carrier or twice as receiver per round — the same
    one-ppermute budget :func:`verify_schedule` enforces). Depth order
    is preserved, so every carrier provably received its row in an
    earlier round."""
    rounds = []
    for stage in stages_by_depth:
        remaining = sorted(stage, key=lambda t: (t.src, t.row, t.dst))
        while remaining:
            used_c: set = set()
            used_d: set = set()
            packed = []
            rest = []
            for t in remaining:
                if t.carrier not in used_c and t.dst not in used_d:
                    used_c.add(t.carrier)
                    used_d.add(t.dst)
                    packed.append(t)
                else:
                    rest.append(t)
            rounds.append(tuple(packed))
            remaining = rest
    return tuple(rounds)


def build_dedup_plan(send_idx, send_mask, *, s_pad: int,
                     min_fanout: int = 2) -> DedupPlan:
    """Detect hubs, reduce the traffic matrix to primary-needer-only for
    hub rows, compile + verify the direct schedule against the REDUCED
    matrix, and pack the relay fan-out rounds."""
    live = pair_live_rows(send_idx, send_mask)
    W = len(live)
    hubs = detect_hub_rows(send_idx, send_mask, min_fanout)
    drop = {(h.src, d, h.row) for h in hubs for d in h.needers[1:]}
    reduced_live = tuple(
        tuple(
            tuple(r for r in live[s][d] if (s, d, r) not in drop)
            for d in range(W)
        )
        for s in range(W)
    )
    reduced_pair_rows = tuple(
        tuple(len(reduced_live[s][d]) for d in range(W)) for s in range(W)
    )
    direct = compile_halo_schedule(
        reduced_pair_rows, s_pad=int(s_pad), world_size=W
    )
    depth = max((len(_relay_stages(h)) for h in hubs), default=0)
    stages_by_depth = [[] for _ in range(depth)]
    for h in hubs:
        for i, stage in enumerate(_relay_stages(h)):
            stages_by_depth[i].extend(stage)
    return DedupPlan(
        world_size=W,
        s_pad=int(s_pad),
        min_fanout=max(2, int(min_fanout)),
        hubs=hubs,
        reduced_live=reduced_live,
        reduced_pair_rows=reduced_pair_rows,
        direct_schedule=direct,
        relay_rounds=_pack_relay_rounds(stages_by_depth),
    )


def verify_dedup_coverage(plan: DedupPlan, send_idx, send_mask) -> list:
    """Prove the dedup'd structure still delivers EXACTLY the original
    demand — the invariant that lets a lossy-looking rewrite claim bit
    parity. Failure list (empty == verified):

    - the direct schedule passes :func:`verify_schedule` against the
      reduced matrix (bounds / conflict-freedom / exact coverage);
    - relay rounds are conflict-free and causal: every carrier already
      holds the row (received it directly as primary, or by an earlier
      relay round) — a relay from a non-holder would forward garbage;
    - store-and-forward delivery simulation ends with every original
      (needer, src, row) demand delivered exactly ONCE: a gap is a
      dropped halo block, a double delivery is the double-count the
      reverse reduce would turn into a wrong gradient.

    The selftest's vacuity mutants (a duplicated relay, a dropped
    needer) must each turn this list non-empty.
    """
    failures = list(verify_schedule(plan.direct_schedule,
                                    plan.reduced_pair_rows))
    live = pair_live_rows(send_idx, send_mask)
    W = len(live)
    demand = {(d, s, r) for s in range(W) for d in range(W)
              for r in live[s][d]}
    delivered: dict = {}
    holders: dict = {}
    for s in range(W):
        for d in range(W):
            for r in plan.reduced_live[s][d]:
                delivered[(d, s, r)] = delivered.get((d, s, r), 0) + 1
                holders.setdefault((s, r), set()).add(d)
    for k, rnd in enumerate(plan.relay_rounds):
        carriers: set = set()
        receivers: set = set()
        for t in rnd:
            tag = f"relay round {k}: {t.carrier}->{t.dst} of ({t.src},{t.row})"
            if t.carrier in carriers:
                failures.append(f"{tag}: carrier sends twice in one round")
            if t.dst in receivers:
                failures.append(f"{tag}: rank receives twice in one round")
            carriers.add(t.carrier)
            receivers.add(t.dst)
            held = holders.get((t.src, t.row), set())
            if t.carrier not in held:
                failures.append(
                    f"{tag}: carrier does not hold the row yet "
                    f"(non-causal relay forwards garbage)"
                )
            delivered[(t.dst, t.src, t.row)] = (
                delivered.get((t.dst, t.src, t.row), 0) + 1
            )
        # holders grow only after the round completes (store-and-forward)
        for t in rnd:
            holders.setdefault((t.src, t.row), set()).add(t.dst)
    for key in sorted(demand):
        n = delivered.pop(key, 0)
        d, s, r = key
        if n == 0:
            failures.append(
                f"demand ({s},{r})->rank {d}: never delivered "
                f"(dropped needer — the halo block silently never arrives)"
            )
        elif n > 1:
            failures.append(
                f"demand ({s},{r})->rank {d}: delivered {n} times "
                f"(double-count — the reverse reduce would sum it twice)"
            )
    for key, n in sorted(delivered.items()):
        d, s, r = key
        failures.append(
            f"delivery ({s},{r})->rank {d} x{n} has no matching demand"
        )
    return failures


def dedup_stats(plan: DedupPlan, send_idx, send_mask) -> dict:
    """Egress accounting: what the owner links stop paying. Total hop
    count is conserved (store-and-forward moves the same rows), so the
    honest headline is BOTTLENECK egress, not total volume."""
    live = pair_live_rows(send_idx, send_mask)
    W = len(live)
    egress_before = [sum(len(live[s][d]) for d in range(W))
                     for s in range(W)]
    direct_after = [sum(plan.reduced_pair_rows[s][d] for d in range(W))
                    for s in range(W)]
    relay_out = [0] * W
    for rnd in plan.relay_rounds:
        for t in rnd:
            relay_out[t.carrier] += 1
    egress_after = [direct_after[s] + relay_out[s] for s in range(W)]
    return {
        "hubs_found": len(plan.hubs),
        "hub_needers_max": max((len(h.needers) for h in plan.hubs),
                               default=0),
        "owner_egress_rows_saved": sum(
            len(h.needers) - 1 for h in plan.hubs
        ),
        "relay_rows": sum(len(r) for r in plan.relay_rounds),
        "relay_rounds": len(plan.relay_rounds),
        "direct_rounds": plan.direct_schedule.num_rounds,
        "rows_total_before": sum(egress_before),
        "rows_direct_after": sum(direct_after),
        "max_rank_egress_before": max(egress_before, default=0),
        "max_rank_egress_after": max(egress_after, default=0),
    }
