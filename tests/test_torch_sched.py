"""The port's compiled halo schedule (``dgraph_tpu_torch/sched/``, the plan's
``halo_schedule`` and the 'sched' resolution) against the JAX package's.

- ``compile_halo_schedule`` gives the reference's schedule, ``schedule_id``
  included, on the selftest's five fixtures and on seeded random ``[W][W]``
  traffic matrices at W in {2, 4, 8}, uniform and skewed (hub pairs the
  split pass cuts);
- ``build_edge_plan`` at W = 2 and 4 attaches the reference plan's
  schedule, which ``.to()`` and ``.shard()`` carry whole; none at W = 1 or
  without cross-rank traffic;
- ``python -m dgraph_tpu_torch.sched --selftest true`` prints the
  reference's JSON and exits 0, and the package loads neither torch nor
  numpy;
- the heuristic never picks 'sched', in either package;
- ``python -m dgraph_tpu_torch.train``'s main at 4 CPU ranks under the
  'sched' pin: every rank resolves 'sched', off the split route.

The rounds themselves run in ``tests/test_torch_dist.py`` (the 'sched'
member of ``torch_dist_ranks.IMPLS``, and GCN and GAT under the pin).
"""

import json
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_ranks
from dgraph_tpu import config as jcfg
from dgraph_tpu import plan as jpl
from dgraph_tpu.sched import __main__ as jsched_main
from dgraph_tpu.sched import compile_halo_schedule as jcompile
from dgraph_tpu_torch import config as cfg
from dgraph_tpu_torch import partition as pt
from dgraph_tpu_torch import plan as pl
from dgraph_tpu_torch.data import synthetic
from dgraph_tpu_torch.sched import HaloSchedule, compile_halo_schedule, verify_schedule

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def _random_matrix(W: int, seed: int, skewed: bool) -> tuple:
    """A seeded ``[W][W]`` traffic matrix (zero diagonal, some dead pairs)
    and an ``s_pad`` above its largest entry; ``skewed``: one or two hub
    pairs 8-40x the others."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 12, (W, W)) * (rng.random((W, W)) < 0.7)
    if skewed:
        for _ in range(1 + seed % 2):
            s, d = rng.choice(W, 2, replace=False)
            rows[s, d] = rng.integers(100, 400)
    np.fill_diagonal(rows, 0)
    s_pad = int(-(-max(int(rows.max()), 1) // 8) * 8)
    return tuple(tuple(int(v) for v in r) for r in rows), s_pad


@pytest.mark.parametrize("name", sorted(jsched_main._FIXTURES))
def test_schedule_matches_reference_on_fixtures(name):
    rows, s_pad = jsched_main._FIXTURES[name]
    ours, ref = compile_halo_schedule(rows, s_pad=s_pad), jcompile(rows, s_pad=s_pad)
    assert ours.to_dict() == ref.to_dict()
    assert ours.schedule_id == ref.schedule_id
    assert HaloSchedule.from_dict(json.loads(json.dumps(ref.to_dict()))) == ours


@pytest.mark.parametrize("skewed", [False, True], ids=["uniform", "skewed"])
@pytest.mark.parametrize("W", [2, 4, 8])
def test_schedule_matches_reference_on_random_matrices(W, skewed):
    split = 0
    for seed in range(6):
        rows, s_pad = _random_matrix(W, seed, skewed)
        ours, ref = compile_halo_schedule(rows, s_pad=s_pad), jcompile(rows, s_pad=s_pad)
        assert ours.schedule_id == ref.schedule_id, (seed, rows)
        assert ours.to_dict() == ref.to_dict()
        assert verify_schedule(ours, rows) == []
        split += ours.num_transfers > sum(1 for r in rows for v in r if v)
    if skewed and W > 2:  # the split pass runs (at W = 2 the median of two
        assert split > 0  # live pairs is the larger: nothing splits)


@pytest.mark.parametrize("W", [2, 4])
def test_plan_attaches_reference_schedule(W):
    sbm = synthetic.sbm_classification_graph(num_nodes=400, seed=1)
    new, ren = pt.partition_graph(sbm["edge_index"], 400, W, method="random", seed=3)
    ours, _ = pl.build_edge_plan(new, ren.partition, world_size=W)
    ref, _ = jpl.build_edge_plan(new, ren.partition, world_size=W, use_native=False)
    assert ours.halo_pair_rows == ref.halo_pair_rows
    assert ours.halo_schedule is not None
    assert ours.halo_schedule.schedule_id == ref.halo_schedule.schedule_id
    assert ours.halo_schedule.s_pad == ours.halo.s_pad
    for view in (ours.to("cpu"), ours.shard(W - 1), ours.shard(0).to("cpu")):
        assert view.halo_schedule is ours.halo_schedule


def test_no_schedule_without_traffic():
    part = np.repeat(np.arange(2), 16)
    local = np.stack([np.arange(32), (np.arange(32) // 16) * 16 + (np.arange(32) + 1) % 16])
    plan, _ = pl.build_edge_plan(local, part, world_size=2)
    ref, _ = jpl.build_edge_plan(local, part, world_size=2, use_native=False)
    assert plan.halo_deltas == () and plan.halo_schedule is None is ref.halo_schedule
    one, _ = pl.build_edge_plan(local, np.zeros(32, np.int64), world_size=1)
    assert one.halo_schedule is None
    assert pl.compile_plan_schedule(((0, 3), (0, 0)), s_pad=8, world_size=2,
                                    halo_deltas=()) is None


def test_selftest_cli_prints_reference_json():
    out = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.sched", "--selftest", "true"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == jsched_main._selftest()
    assert got["ok"] and got["failures"] == []


def test_sched_package_loads_neither_torch_nor_numpy():
    code = ("import sys, dgraph_tpu_torch.sched, dgraph_tpu_torch.sched.__main__\n"
            "bad = [m for m in ('torch', 'numpy', 'jax', 'dgraph_tpu') if m in sys.modules]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.fixture
def flags():
    saved, jsaved = cfg.halo_impl, (jcfg.halo_impl, jcfg.tuned_halo_impl)
    yield
    cfg.halo_impl = saved
    jcfg.set_flags(halo_impl=jsaved[0], tuned_halo_impl=jsaved[1])


@pytest.mark.parametrize("deltas", [(1,), (1, 3), (1, 2, 3)])
@pytest.mark.parametrize("overlap", [False, True])
def test_heuristic_never_picks_sched(flags, deltas, overlap):
    """With no pin, a plan that carries a schedule resolves what it resolved
    before the schedule existed, in both packages; a 'sched' pin runs it."""
    cfg.halo_impl = "auto"
    jcfg.set_flags(halo_impl="auto", tuned_halo_impl=None)
    W = max(deltas) + 1
    got = pl.resolve_halo_impl(deltas, overlap_available=overlap, sched_available=True)
    ref = jpl.resolve_halo_impl(W, deltas, overlap_available=overlap, sched_available=True)
    assert got == pl.resolve_halo_impl(deltas, overlap_available=overlap)
    assert got[0] != "sched" and ref[0] != "sched" and got[1] == ref[1] == "heuristic"
    cfg.halo_impl = "sched"
    assert pl.resolve_halo_impl(deltas, overlap_available=overlap,
                                sched_available=True) == ("sched", "env")


def test_train_cli_sched_pin_four_cpu_ranks(monkeypatch, tmp_path):
    """``DGRAPH_TPU_HALO_IMPL=sched python -m dgraph_tpu_torch.train --device
    cpu --world_size 4``: every rank resolves 'sched' off the split route,
    and the loss falls."""
    from dgraph_tpu_torch.train import __main__ as cli

    monkeypatch.setenv("DGRAPH_TPU_HALO_IMPL", "sched")
    c = cli.parse_config(["--device", "cpu", "--world_size", "4", "--epochs", "2",
                          "--data.num_nodes", "400", "--log_path", str(tmp_path / "log.jsonl")])
    res = cli.main(c, on_step=torch_dist_ranks.resolved_lowering)
    assert [p for rank in res["ranks"] for p in rank["on_step"]] == [("sched", False)] * 8
    losses = [r["loss"] for r in res["records"]]
    assert all(np.isfinite(losses)) and losses[1] < losses[0]


@pytest.mark.parametrize("name", ["skewed_hub", "dense", "uniform_ring"])
def test_chip_smoke_control_drops_one_transfer(name):
    """``chip_smoke.py`` phase 13's control schedule: one transfer taken out
    (rows no other window of its pair covers), which the verifier flags as
    uncovered, everything else as compiled."""
    import chip_smoke

    rows, s_pad = jsched_main._FIXTURES[name]
    sched = compile_halo_schedule(rows, s_pad=s_pad)
    ctrl, cut = chip_smoke.dropped_transfer(sched)
    kept = [t for r in ctrl.rounds for t in r.transfers]
    assert cut not in kept and len(kept) == sched.num_transfers - 1
    assert any(f"pair {cut.src}->{cut.dst}" in f and "uncovered" in f
               for f in verify_schedule(ctrl, rows))
