"""The put-discipline verifier (``dgraph_tpu_torch.analysis.kernel``) on the
CPU, held against the reference's plan arithmetic and its rule and mutant
set.

The reference's kernel verifier cannot run on the installed JAX (its
fault-seeded kernel needs ``pltpu.TPUMemorySpace``), so it is no oracle
here. What is held against the reference: the audit graph's plan (the
reference's ``build_edge_plan`` on the same graph: ``halo_deltas``,
``s_pad``, ``n_src_pad``) and the placement arithmetic of its transport's
meta operand (``pallas_p2p.py:248-255``: targets ``(me + sign*d) % W``,
sources ``(me - sign*d) % W``, the landing row ``me*S``); and the five
mutations of ``analysis/kernel.py:641-660``, each of which must trip its
own rule.

One spawn of gloo ranks per world size runs, on every rank: the train and
eval steps of the canonical workload under the recorder (halo pinned to
``pallas_p2p``), the landing check on the plain versions, and kernel 6's
plain versions. The CLI runs once, with ``--device cpu``.
"""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_ranks
from dgraph_tpu.plan import build_edge_plan as jax_build_edge_plan
from dgraph_tpu_torch.analysis import kernel
from dgraph_tpu_torch.analysis.trace import PROGRAMS, build_audit_workload
from dgraph_tpu_torch.comm.dist import launch
from dgraph_tpu_torch.ops import p2p

TIMEOUT = 120


@pytest.fixture(scope="module")
def ranks():
    """{W: (workload, per-rank results)} — one spawn per world size."""
    out = {}
    for W in (2, 4):
        w = build_audit_workload(W)
        res = launch(torch_dist_ranks.analysis_case, W, w, tuple(PROGRAMS),
                     kernel.landing_cases(W), device="cpu", timeout=TIMEOUT, threads=1)
        out[W] = (w, res)
    return out


def test_kernel_selftest_is_green():
    assert kernel.kernel_selftest_failures() == []


@pytest.mark.parametrize("mutant", [None, *kernel.MUTANTS])
def test_each_seeded_fault_trips_its_own_rule(mutant):
    """The clean protocol GREEN; each of the reference's five mutations RED
    with its rule's words and no other rule (as the reference's
    ``test_kernel_verifier_flags_each_mutation_specifically``)."""
    failures = []
    for me in range(4):
        rec = kernel._selftest_record(mutant, me, 4, 8, 16, (1, 2, 3), 1)
        kernel.verify_transport(rec, "t", failures)
    if mutant is None:
        assert failures == []
        return
    rule = kernel.MUTANTS[mutant][0]
    assert failures and all(f" rule {rule}: " in f for f in failures), failures
    words = {"send-wait": "sync of its card", "recv-wait": "outstanding",
             "wait-before-reuse": "cleared", "dst-rows": "me*S slot", "extent": "leaves its slot"}
    assert any(words[rule] in f for f in failures), failures


def test_the_clean_protocol_is_what_the_wrapper_runs():
    assert p2p.PROTOCOL == ("zero", "sync", "barrier", "put", "sync", "barrier", "read")
    assert {m[1] for m in kernel.MUTANTS.values()} > {p2p.PROTOCOL}
    assert all(len(m[1]) == len(p2p.PROTOCOL) - 1 for m in kernel.MUTANTS.values()
               if m[2] is None)


@pytest.mark.parametrize("W", [2, 4])
def test_audit_verifies_every_transport_and_pins_the_count(ranks, W):
    """4 transports a rank in a train step and 2 in an eval at 2 layers,
    each with the clean protocol and destinations."""
    w, res = ranks[W]
    rep = kernel.audit_workload_kernels(w, per_rank=res)
    assert rep["ok"], rep["failures"]
    for r in res:
        assert [len(r["records"][k]) for k in PROGRAMS] == [4, 2]
        for recs in r["records"].values():
            assert all(rec.steps == list(p2p.PROTOCOL) for rec in recs)
    assert len(rep["kernels"]) == 6 * W


def test_audit_flags_a_rank_that_skips_a_transport(ranks):
    """A rank whose eval step made one transport fewer: the count pin and
    the cross-rank sequence check both go RED."""
    w, res = ranks[2]
    short = [dict(r, records=dict(r["records"])) for r in res]
    short[1]["records"]["eval_step"] = short[1]["records"]["eval_step"][:-1]
    rep = kernel.audit_workload_kernels(w, per_rank=short)
    assert not rep["ok"]
    assert any("rank 1 made 1 transport calls, expected 2" in f for f in rep["failures"])
    assert any("sequences differ" in f for f in rep["failures"])


@pytest.mark.parametrize("W", [2, 4])
def test_audit_lands_every_tile_where_the_reference_plan_puts_it(ranks, W):
    """The plan and every destination against the reference: its plan of
    the same graph, and its transport's targets, sources and me*S row."""
    w, res = ranks[W]
    ref, _ = jax_build_edge_plan(w.edge_index, w.partition, world_size=W, overlap=True)
    assert tuple(ref.halo_deltas) == w.plan.halo_deltas and ref.halo_deltas
    assert ref.halo.s_pad == w.plan.halo.s_pad and ref.n_src_pad == w.plan.n_src_pad
    S, deltas = int(ref.halo.s_pad), np.asarray(ref.halo_deltas)
    for label in PROGRAMS:
        calls = [r["records"][label] for r in res]
        for i in range(len(calls[0])):
            landed = {}  # receiver -> {sender: row}
            for me, recs in enumerate(calls):
                rec = recs[i]
                assert rec.rank == me and rec.deltas == tuple(ref.halo_deltas) and rec.S == S
                targets = (me + rec.sign * deltas) % W  # pallas_p2p.py:248
                assert [a.rank for a in rec.dests] == targets.tolist()
                for a in rec.dests:
                    landed.setdefault(a.rank, {})[me] = a.offset // (rec.F * rec.esize)
            sign = calls[0][i].sign
            assert {rec[i].sign for rec in calls} == {sign}  # the ranks agree
            for p, senders in landed.items():
                sources = (p - sign * deltas) % W  # pallas_p2p.py:249
                assert sorted(senders) == sorted(sources.tolist())
                assert all(row == s * S for s, row in senders.items())  # me*S, :252


@pytest.mark.parametrize("W", [2, 4])
def test_landing_check_on_the_plain_versions(ranks, W):
    """Kernel 5's and kernel 6's clean placement GREEN; bad_dst_row RED on
    dst-rows, oversize RED on extent, each alone."""
    _, res = ranks[W]
    failures = []
    rules = kernel.check_landing([r["landing"] for r in res], failures)
    assert failures == []
    assert rules == {"p2p_transport:clean": [], "p2p_transport_mutant:clean": [],
                     "p2p_transport_mutant:bad_dst_row": ["dst-rows"],
                     "p2p_transport_mutant:oversize": ["extent"]}


def test_landing_check_is_not_vacuous():
    """check_landing turns RED when a mutant's check comes back GREEN, or
    the clean one RED."""
    ok = {"kernel": "p2p_transport_mutant", "mutation": "oversize", "rank": 0, "failures": []}
    failures = []
    kernel.check_landing([[ok]], failures)
    assert any("oversize" in f and "vacuous" in f for f in failures)
    bad = {"kernel": "p2p_transport", "mutation": None, "rank": 0,
           "failures": ["[landing:x] rank 0 rule dst-rows: 8 of the 8 rows"]}
    failures = []
    kernel.check_landing([[bad]], failures)
    assert any("RED on p2p_transport:clean" in f for f in failures)


@pytest.mark.parametrize("W", [2, 4])
def test_kernel6_plain_versions(ranks, W):
    """Kernel 6's plain ``None`` equals kernel 5's plain version bit for bit;
    its recorded calls verify GREEN, or RED on the seeded fault's rule."""
    _, res = ranks[W]
    for r in res:
        assert r["plain_none_equal"] and all(r["plain_none_equal"])
        assert {rec.mutation for rec in r["mutant_records"]} == set(p2p.MUTATIONS)
        for rec in r["mutant_records"]:
            failures = []
            kernel.verify_transport(rec, "t", failures)
            rule = {None: None, "bad_dst_row": "dst-rows", "oversize": "extent"}[rec.mutation]
            if rule is None:
                assert failures == []
            else:
                assert failures and all(f" rule {rule}: " in f for f in failures)


def test_mutant_landings_overlap_only_where_documented():
    """The deltas the bit-equality checks use give disjoint landings; with
    every peer live (W = 4) both faults make two senders write one row."""
    assert {W: {m: kernel.disjoint_deltas(W, m) for m in p2p.MUTATIONS} for W in (2, 4)} == {
        2: {None: (1,), "bad_dst_row": (1,), "oversize": (1,)},
        4: {None: (1, 2, 3), "bad_dst_row": (1, 2), "oversize": (1, 3)}}
    for mutation in ("bad_dst_row", "oversize"):
        assert kernel.overlapping_rows((1, 2, 3), 4, 8, 1, mutation) > 0
    assert kernel.overlapping_rows((1, 2, 3), 4, 8, 1, None) == 0


def test_kernel_cli_on_the_cpu():
    """``python -m dgraph_tpu_torch.analysis.kernel --selftest --device cpu``
    exits 0 and prints one JSON line with a RunHealth record."""
    p = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.analysis.kernel", "--selftest",
                        "--device", "cpu"], capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["kind"] == "kernel_verifier" and out["failures"] == []
    assert out["audit"] == {"world_size": 2, "transports": 12, "ok": True}
    assert out["landing"]["rules"]["p2p_transport_mutant:oversize"] == ["extent"]
    assert out["run_health"]["wedge"] == "none"


def test_kernel_cli_fails_on_a_seeded_finding(monkeypatch, capsys):
    """A protocol that drops the barrier before the read makes the
    selftest's clean transport RED: the CLI exits nonzero."""
    monkeypatch.setattr(p2p, "PROTOCOL", kernel._drop(5))
    with pytest.raises(SystemExit, match="recv-wait"):
        kernel.main(kernel.Config(selftest=True, audit=False, landing=False))
    out = json.loads(capsys.readouterr().out)
    assert out["run_health"]["wedge"] == "stage_failure"


def test_the_landing_check_needs_the_card_it_names():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        kernel.main(kernel.Config(audit=False))
