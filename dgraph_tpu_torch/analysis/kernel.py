"""The put-discipline verifier of the one-sided halo transport — counterpart
of ``dgraph_tpu/analysis/kernel.py`` (the Pallas DMA-discipline verifier).

One-sided puts are correct only under an exact ordering discipline, and no
numeric test sees a violation: ranks that run in lock step (the CPU plain
path, a card that time-slices its ranks) give the right halo whatever the
order. The reference proves its kernel's semaphore discipline from the
jaxpr. On the card the TPU kernel's semaphores became host steps
(:data:`dgraph_tpu_torch.ops.p2p.PROTOCOL`: zero, sync, barrier, put, sync,
barrier, read) and its meta arithmetic became
:func:`~dgraph_tpu_torch.ops.p2p.put_destinations`, so the same rules are
checked on the recorded steps of every call
(:func:`~dgraph_tpu_torch.ops.p2p.record_transports`) and on the
destinations over symbolic bases:

- ``send-wait`` (the reference's paired send wait): every put is followed
  by a sync of its card before the next barrier;
- ``recv-wait`` (paired recv wait, nothing outstanding at exit): the read
  comes after a barrier that comes after the last put;
- ``wait-before-reuse``: a zero of the landing buffer is followed by a
  sync and then a barrier before any put into it;
- ``dst-rows`` (destination rows provably ``[me*S, (me+1)*S)``): every
  put lands at peer ``(me + sign*delta) % W``'s buffer, ``me*S`` rows in;
- ``extent`` (the VMEM discipline's counterpart: there is no staging
  here): each put stores exactly ``S*F`` elements into a buffer of exactly
  ``W*S`` rows.

The verifier has three parts:

- the **static tier**: :func:`verify_transport` on one record,
  :func:`kernel_selftest_failures` (the clean protocol GREEN, each of the
  five seeded faults RED naming its own rule: :data:`MUTANTS`), and
  :func:`audit_workload_kernels` (:data:`~.trace.PROGRAMS` on W gloo ranks
  on the CPU under the recorder: every transport call verified, their
  count pinned). No card, no launch;
- the **landing check**, :func:`audit_landing`: sentinel-filled landing
  buffers with a guard slot, tiles whose values name their sender, tile
  and row; each rank checks its own buffer after one transport. On the
  card it launches kernel 5 and kernel 6 (``csrc/p2p_transport.cu``), on
  the CPU their plain versions;
- the **entry point**::

      python -m dgraph_tpu_torch.analysis.kernel [--selftest] [--audit true]
          [--landing true] [--world 2] [--device cuda|cpu]

  prints one JSON line with a RunHealth record and exits nonzero on any
  finding. The static tiers always run on the host (as the reference pins
  the CPU); the landing check runs on ``--device`` (the card by default:
  it raises without one).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional

import torch

from dgraph_tpu_torch.ops import p2p
from dgraph_tpu_torch.ops.p2p import PeerAddress

__all__ = [
    "collect_transports",
    "verify_transport",
    "audit_workload_kernels",
    "kernel_selftest_failures",
    "audit_landing",
    "main",
]

RULES = {
    "send-wait": "every put is followed by a sync of its card before the next barrier",
    "recv-wait": "the read comes after a barrier that comes after the last put",
    "wait-before-reuse": "a zero of the landing buffer is followed by a sync, then a barrier, "
                         "before any put into it",
    "dst-rows": "every put lands at peer (me + sign*delta) % W's buffer at rows "
                "[me*S, (me+1)*S)",
    "extent": "each put stores exactly S*F elements into a buffer of exactly W*S rows",
}


def _drop(i: int) -> tuple:
    return p2p.PROTOCOL[:i] + p2p.PROTOCOL[i + 1:]


# seeded fault -> (the rule it must trip, the protocol it runs, kernel 6's
# mutation); the reference's five (analysis/kernel.py:641-660), with
# oversize_staging as 'oversize'
MUTANTS = {
    "drop_send_wait": ("send-wait", _drop(4), None),  # the sync after the put
    "drop_recv_wait": ("recv-wait", _drop(5), None),  # the barrier before the read
    "no_slot_wait": ("wait-before-reuse", _drop(2), None),  # the barrier after the zero
    "bad_dst_row": ("dst-rows", p2p.PROTOCOL, "bad_dst_row"),
    "oversize": ("extent", p2p.PROTOCOL, "oversize"),
}

# the landing check's transports: (kernel, mutation) -> the rule it must
# trip (None: GREEN)
LANDING_VARIANTS = {
    ("p2p_transport", None): None,
    ("p2p_transport_mutant", None): None,
    ("p2p_transport_mutant", "bad_dst_row"): "dst-rows",
    ("p2p_transport_mutant", "oversize"): "extent",
}


def collect_transports(fn) -> list:
    """Run ``fn()`` under :func:`~dgraph_tpu_torch.ops.p2p.record_transports`
    and return the :class:`~dgraph_tpu_torch.ops.p2p.TransportRecord` of
    every transport call it made."""
    with p2p.record_transports() as log:
        fn()
    return list(log)


# ---------------------------------------------------------------------------
# the static tier
# ---------------------------------------------------------------------------


def verify_transport(rec, label: str, failures: list) -> dict:
    """Check one recorded call against :data:`RULES`; appends one failure per
    broken rule (``[kernel:<label>] rule <name>: ...``) and returns the
    call's summary."""
    before = len(failures)

    def fail(rule: str, msg: str) -> None:
        failures.append(f"[kernel:{label}] rule {rule}: {msg}")

    steps = list(rec.steps)
    end = len(steps)
    puts = [i for i, s in enumerate(steps) if s == "put"]
    if not puts:
        fail("send-wait", "the protocol makes no put at all")
    for i in puts:
        nxt = next((j for j in range(i + 1, end) if steps[j] == "barrier"), end)
        if "sync" not in steps[i + 1:nxt]:
            where = f"the barrier at step {nxt}" if nxt < end else "the end"
            fail("send-wait", f"the put at step {i} is not followed by a sync of its card "
                              f"before {where}: a peer may read before its stores land")
    if steps.count("read") != 1 or steps[-1] != "read":
        fail("recv-wait", f"the protocol {steps} does not end in one read of the buffer")
    elif puts and "barrier" not in steps[puts[-1] + 1:end - 1]:
        fail("recv-wait", f"no barrier between the last put (step {puts[-1]}) and the read "
                          f"(step {end - 1}): the read can see peers' puts outstanding")
    zeros = [i for i, s in enumerate(steps) if s == "zero"]
    if puts and not any(z < puts[0] for z in zeros):
        fail("wait-before-reuse", "no zero of the landing buffer before the first put")
    for z in zeros:
        nxt = next((j for j in puts if j > z), None)
        if nxt is None:
            continue
        seg = steps[z + 1:nxt]
        if "sync" not in seg or "barrier" not in seg[seg.index("sync") + 1:]:
            fail("wait-before-reuse", f"the zero at step {z} is not followed by a sync and "
                                      f"then a barrier before the put at step {nxt}: a peer's "
                                      f"put can land before the buffer is cleared, or while "
                                      f"its last clone still reads it")
    W, S, F, e, me, sign = rec.world_size, rec.S, rec.F, rec.esize, rec.rank, rec.sign
    if len(rec.dests) != len(rec.deltas):
        fail("dst-rows", f"{len(rec.dests)} destinations for {len(rec.deltas)} tiles")
    for k, (d, got) in enumerate(zip(rec.deltas, rec.dests)):
        want = PeerAddress((me + sign * d) % W, me * S * F * e)
        if got != want:
            fail("dst-rows", f"tile {k} (delta {d}) lands in rank {got.rank}'s buffer at row "
                             f"{got.offset / (F * e):g}, not rank {want.rank}'s row {me * S} "
                             f"(this rank's me*S slot)")
    if rec.extent != S * F:
        fail("extent", f"each put stores {rec.extent / F:g} rows ({rec.extent} elements); the "
                       f"halo slot is exactly S={S} rows: the put leaves its slot")
    if rec.buffer_rows != W * S:
        fail("extent", f"the landing buffer has {rec.buffer_rows} rows, not W*S = {W * S}")
    return {"label": label, "kernel": rec.kernel, "mutation": rec.mutation, "rank": me,
            "sign": sign, "n_deltas": len(rec.deltas), "s_pad": S, "feat_dim": F,
            "steps": len(steps), "ok": len(failures) == before}


def _selftest_record(mutant: Optional[str], me: int, W: int, S: int, F: int, deltas: tuple,
                     sign: int):
    """The record of one call of the clean transport (``mutant`` None: the
    protocol the wrapper runs) or of a seeded fault, its steps run through
    the wrapper's own runner."""
    protocol, mutation = (p2p.PROTOCOL, None) if mutant is None else MUTANTS[mutant][1:]
    rec = p2p.transport_record("p2p_transport" if mutation is None else "p2p_transport_mutant",
                               mutation, rank=me, W=W, S=S, F=F, esize=4, deltas=deltas,
                               sign=sign, guard=mutation == "oversize")
    p2p.run_protocol(protocol, p2p.ObservedSteps(None), rec.steps)
    return rec


def kernel_selftest_failures(W: int = 4, S: int = 8, F: int = 16) -> list:
    """Vacuity guards: the clean transport must verify GREEN on every rank
    and direction, and each seeded fault of :data:`MUTANTS` RED on every
    rank and direction with failures that name its own rule and no other.
    Also the ``no_slot_wait`` spelling that drops the sync after the zero."""
    deltas = tuple(range(1, min(W, 4)))
    failures: list = []
    for mutant in (None, *MUTANTS):
        for me in range(W):
            for sign in (1, -1):
                rec = _selftest_record(mutant, me, W, S, F, deltas, sign)
                mism: list = []
                verify_transport(rec, f"mutant:{mutant or 'clean'}:r{me}:{sign:+d}", mism)
                if mutant is None:
                    if mism:
                        failures.append(f"verifier flagged the CLEAN transport: {mism[:3]}")
                    continue
                rule = MUTANTS[mutant][0]
                if not mism:
                    failures.append(f"verifier accepted the {mutant!r} mutant on rank {me} "
                                    f"sign {sign:+d}: the {rule} rule is vacuous")
                elif any(f" rule {rule}: " not in m for m in mism):
                    failures.append(f"the {mutant!r} mutant tripped another rule than "
                                    f"{rule}: {mism[:3]}")
    rec = p2p.transport_record("p2p_transport", None, rank=0, W=W, S=S, F=F, esize=4,
                               deltas=deltas, sign=1, guard=False)
    p2p.run_protocol(_drop(1), p2p.ObservedSteps(None), rec.steps)
    mism = []
    verify_transport(rec, "mutant:no_slot_sync", mism)
    if not mism or any(" rule wait-before-reuse: " not in m for m in mism):
        failures.append(f"dropping the sync after the zero must trip wait-before-reuse "
                        f"alone, got {mism[:3]}")
    return failures


@contextlib.contextmanager
def pinned_p2p():
    """The halo pinned to ``pallas_p2p`` (on the CPU: the transport's plain
    version), as the reference's audit pins it; restored on exit."""
    from dgraph_tpu_torch import config

    saved = (config.halo_impl, config.use_pallas_p2p)
    config.halo_impl, config.use_pallas_p2p = "pallas_p2p", True
    try:
        yield
    finally:
        config.halo_impl, config.use_pallas_p2p = saved


def _verifier_rank(group, w, labels: tuple, landing: tuple) -> dict:
    """One rank of the verifier (under ``comm.dist.launch``): the
    ``labels`` programs of workload ``w`` under the recorder, then the
    landing check for each case of ``landing``."""
    from dgraph_tpu_torch.analysis.trace import PROGRAMS
    from dgraph_tpu_torch.comm import DistComm

    records = {}
    if labels:
        comm = DistComm(group)
        with pinned_p2p():
            for label in labels:
                records[label] = collect_transports(PROGRAMS[label](w, comm))
    return {"records": records,
            "landing": [audit_landing(group, **case) for case in landing]}


def _launch(W: int, w, labels: tuple, landing: tuple, device: str) -> list:
    """:func:`_verifier_rank` on W ranks; the rank function goes by its
    module's name (under ``python -m`` this module is ``__main__``, which a
    spawned rank does not import)."""
    import importlib

    from dgraph_tpu_torch.comm.dist import launch

    rank_fn = importlib.import_module("dgraph_tpu_torch.analysis.kernel")._verifier_rank
    return launch(rank_fn, W, w, labels, landing, device=device, timeout=300,
                  threads=1 if device == "cpu" else 0)


def audit_workload_kernels(w, programs=None, *, per_rank: Optional[list] = None) -> dict:
    """Run ``programs`` (default all of :data:`~.trace.PROGRAMS`) on the
    workload's W ranks (gloo, CPU) with the halo pinned to ``pallas_p2p``,
    verify every transport call and pin their count. ``per_rank`` takes the
    ranks' results of a launch already made. A ``kind="kernel_audit"``
    report (``ok``/``failures`` like the other tiers)."""
    from dgraph_tpu_torch.analysis.trace import PROGRAMS

    from dgraph_tpu_torch.analysis.trace import TRANSPORTS_PER_LAYER

    labels = tuple(programs or PROGRAMS)
    if per_rank is None:
        per_rank = _launch(w.world_size, w, labels, (), "cpu")
    failures: list = []
    kernels = []
    for label in labels:
        want = TRANSPORTS_PER_LAYER[label] * w.num_layers
        calls = [res["records"][label] for res in per_rank]
        for r, recs in enumerate(calls):
            if len(recs) != want:
                failures.append(f"[kernel:{label}] rank {r} made {len(recs)} transport calls, "
                                f"expected {want} ({w.num_layers} layers; pallas_p2p pinned)")
            for i, rec in enumerate(recs):
                kernels.append(verify_transport(rec, f"{label}#r{r}.{i}", failures))
        # every rank must make the same transport calls in the same order, or
        # the ones waiting in a barrier wait forever
        shapes = [[(rec.deltas, rec.sign, rec.S, rec.F) for rec in recs] for recs in calls]
        if any(sh != shapes[0] for sh in shapes):
            failures.append(f"[kernel:{label}] the ranks' transport sequences differ: {shapes}")
    return {
        "kind": "kernel_audit",
        "world_size": w.world_size,
        "num_halo_deltas": len(w.plan.halo_deltas),
        "kernels": kernels,
        "records": [res["records"] for res in per_rank],
        "failures": failures,
        "ok": not failures,
    }


def overlapping_rows(deltas, W: int, S: int, sign: int, mutation=None) -> int:
    """Rows of the ranks' landing buffers that more than one sender writes
    (kernel 6's faults can make the landings overlap: there the card's
    outcome is a race between ranks, which no plain version reproduces)."""
    seen: dict = {}
    ext = p2p.put_rows(S, mutation)
    for me in range(W):
        for a in p2p.put_destinations([PeerAddress(p) for p in range(W)], deltas, W, S, 1, 1,
                                      me, sign, mutation):
            for row in range(a.offset, a.offset + ext):
                seen[(a.rank, row)] = seen.get((a.rank, row), 0) + 1
    return sum(1 for c in seen.values() if c > 1)


def disjoint_deltas(W: int, mutation=None) -> tuple:
    """The largest set of live deltas (the first of its size) whose
    landings no two senders share in either direction
    (:func:`overlapping_rows` 0): where kernel 6 is held bit for bit
    against its plain version."""
    for size in range(W - 1, 0, -1):
        for deltas in itertools.combinations(range(1, W), size):
            if all(overlapping_rows(deltas, W, 2, sign, mutation) == 0 for sign in (1, -1)):
                return deltas
    return ()


# ---------------------------------------------------------------------------
# the landing check
# ---------------------------------------------------------------------------

# NaN bit patterns no tile holds (the tiles are small positive integers)
SENTINEL_BITS = {torch.float32: 0x7FA5A5A5, torch.bfloat16: 0x7FA5}


def _tile(sender: int, k: int, n: int, S: int, F: int, dtype, device) -> torch.Tensor:
    """Tile k of ``sender``: row i holds ``1 + (sender*n + k)*S + i`` in
    every column (mod 250 in bf16, which holds integers exactly to 256)."""
    code = (sender * n + k) * S + torch.arange(S, device=device, dtype=torch.int64)
    if dtype == torch.bfloat16:
        code = code % 250
    return (1 + code).to(dtype)[:, None].expand(S, F).contiguous()


def audit_landing(group, *, deltas=None, S: int = 8, F: int = 16, dtype=torch.float32,
                  sign: int = 1, kernel: str = "p2p_transport", mutation=None) -> dict:
    """The landing check on this rank of ``group`` (on its device): every
    rank's landing buffer, guard slot included, starts as
    :data:`SENTINEL_BITS`; every rank puts tiles that name their sender,
    tile and row (``deltas`` default: every peer) through one transport
    (:func:`~dgraph_tpu_torch.ops.p2p.land_tiles`); then this rank checks
    its own buffer. Slot p must hold exactly peer p's tile where p is a
    live source, the sentinel must stay everywhere else, the guard slot
    must be untouched. Each failure names its rule: ``extent`` when the one
    row that differs in a slot is its first, holding row 0 of the previous
    slot's sender (a put that stored more than S rows), ``dst-rows`` for
    everything else. Returns
    ``{"kernel", "mutation", "rank", "failures"}``."""
    W, me, dev = group.world_size, group.rank, group.device
    deltas = tuple(range(1, W)) if deltas is None else tuple(deltas)
    n = len(deltas)
    blocks = torch.stack([_tile(me, k, n, S, F, dtype, dev) for k in range(n)])
    got = p2p.land_tiles(blocks, deltas, W, S, sign=sign, group=group, kernel=kernel,
                         mutation=mutation, fill_bits=SENTINEL_BITS[dtype])
    src = {(me - sign * d) % W: k for k, d in enumerate(deltas)}
    want = torch.full_like(p2p.bits(got), SENTINEL_BITS[dtype]).view(dtype)
    for q, k in src.items():
        want[q * S:(q + 1) * S] = _tile(q, k, n, S, F, dtype, dev)
    bad_rows = (p2p.bits(got) != p2p.bits(want)).any(dim=1).nonzero().flatten().tolist()
    label = f"{kernel}:{mutation or 'clean'}"
    failures = []
    for q in range(W + 1):
        rows = [r for r in bad_rows if q * S <= r < (q + 1) * S]
        if not rows:
            continue
        where = "the guard slot" if q == W else f"slot {q}"
        past = src.get(q - 1)
        if rows == [q * S] and past is not None and torch.equal(
                p2p.bits(got[q * S]), p2p.bits(_tile(q - 1, past, n, S, F, dtype, dev)[0])):
            failures.append(f"[landing:{label}] rank {me} rule extent: row {q * S} ({where}) "
                            f"holds row 0 of peer {q - 1}'s tile, just past its slot: a put "
                            f"stored more than S={S} rows")
            continue
        what = f"peer {q}'s tile" if q in src else "the sentinel (no put lands here)"
        failures.append(f"[landing:{label}] rank {me} rule dst-rows: {len(rows)} of the "
                        f"{S} rows of {where} differ from {what}")
    return {"kernel": kernel, "mutation": mutation, "rank": me, "failures": failures}


def landing_cases(W: int, *, S: int = 8, F: int = 16) -> tuple:
    """The landing check's cases: every :data:`LANDING_VARIANTS` entry, f32
    and bf16, both directions, every peer a live source."""
    return tuple(dict(kernel=kernel, mutation=mutation, S=S, F=F, dtype=dtype, sign=sign)
                 for kernel, mutation in LANDING_VARIANTS
                 for dtype in (torch.float32, torch.bfloat16) for sign in (1, -1))


def check_landing(results: list, failures: list) -> dict:
    """Hold the ranks' landing results (``[rank][case]``) to
    :data:`LANDING_VARIANTS`: kernel 5 and kernel 6 ``None`` GREEN on
    every rank, each mutant RED with failures of its own rule only.
    Returns ``{"<kernel>:<mutation>": sorted rules seen}``."""
    seen: dict = {}
    for per_rank in results:
        for res in per_rank:
            name = f"{res['kernel']}:{res['mutation'] or 'clean'}"
            rules = {m.split(" rule ", 1)[1].split(":", 1)[0] for m in res["failures"]}
            seen.setdefault(name, set()).update(rules)
            want = LANDING_VARIANTS[(res["kernel"], res["mutation"])]
            if want is None and res["failures"]:
                failures.append(f"landing check RED on {name}: {res['failures'][:3]}")
            elif want is not None and rules - {want}:
                failures.append(f"landing check on {name} names {sorted(rules)}, not {want} "
                                f"alone: {res['failures'][:3]}")
    for (kernel, mutation), want in LANDING_VARIANTS.items():
        name = f"{kernel}:{mutation or 'clean'}"
        if want is not None and want not in seen.get(name, set()):
            failures.append(f"the landing check accepted {name}: the {want} rule is vacuous")
    return {name: sorted(rules) for name, rules in seen.items()}


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Config:
    """Put-discipline verifier of the one-sided halo transport (``--selftest``
    runs the seeded-fault vacuity guards; ``--audit`` verifies the real
    transports of the train and eval steps; ``--landing`` runs the landing
    check on ``--device``, the card unless ``cpu``)."""

    selftest: bool = False
    audit: bool = True
    landing: bool = True
    world: int = 2
    device: str = "cuda"
    seed: int = 0
    indent: int = 0


def main(cfg: Config) -> dict:
    import json

    from dgraph_tpu_torch.obs.health import RunHealth

    health = RunHealth.begin("analysis.kernel")
    try:
        failures: list = []
        if cfg.selftest:
            failures.extend(kernel_selftest_failures())
        w, labels = None, ()
        if cfg.audit:
            from dgraph_tpu_torch.analysis.trace import PROGRAMS, build_audit_workload

            w, labels = build_audit_workload(cfg.world, seed=cfg.seed), tuple(PROGRAMS)
        cases = landing_cases(cfg.world) if cfg.landing else ()
        on_cpu = cfg.device == "cpu"
        if cases and not on_cpu and not torch.cuda.is_available():
            raise RuntimeError("the landing check runs on the card and no CUDA device is "
                               "available; pass --device cpu to run it on the plain versions")
        # the static tiers always on gloo ranks on the host; the landing
        # check there too with --device cpu (one launch), else on the card
        host_cases = cases if on_cpu else ()
        per_rank = (_launch(cfg.world, w, labels, host_cases, "cpu")
                    if labels or host_cases else None)
        audit = landing = None
        if w is not None:
            audit = audit_workload_kernels(w, per_rank=per_rank)
            failures.extend(audit["failures"])
        if cases:
            ranks = per_rank if on_cpu else _launch(cfg.world, None, (), cases, cfg.device)
            landing = {"device": cfg.device,
                       "rules": check_landing([r["landing"] for r in ranks], failures)}
        out = {
            "kind": "kernel_verifier",
            "failures": failures,
            "audit": {"world_size": cfg.world, "transports": len(audit["kernels"]),
                      "ok": audit["ok"]} if audit else None,
            "landing": landing,
            "run_health": health.finish("; ".join(failures) if failures else None,
                                        wedge="stage_failure" if failures else None),
        }
        print(json.dumps(out, indent=cfg.indent or None))
        if failures:
            raise SystemExit("kernel verifier FAILED: " + "; ".join(failures[:8]))
        return out
    except SystemExit:
        raise
    except BaseException as e:
        print(json.dumps({
            "kind": "kernel_verifier",
            "failures": [f"{type(e).__name__}: {e}"],
            "run_health": health.finish(f"kernel verifier crashed: {type(e).__name__}: {e}",
                                        wedge="stage_failure"),
        }))
        raise


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
