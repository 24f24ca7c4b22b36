"""The port's sharded plan cache (``dgraph_tpu_torch/plan_shards.py``, the
sharded build and load in ``plan.py``, ``train.checkpoint.cached_edge_plan``,
``DistributedGraph.from_global(plan_cache_dir=)``), held against the
reference on the same numpy inputs.

- The sharded build equals the monolithic ``build_edge_plan`` leaf for leaf
  and static for static (the compiled schedule and wire format too) over
  homogeneous and bipartite graphs, both edge owners, ``sort_route`` and
  ``overlap`` on and off, W = 1, 2, 4; its manifest, shard SHA-256s
  included, equals the reference's ``build_plan_shards``' (the pickles are
  the same bytes).
- ``cached_edge_plan`` names the reference's ``plan_<key>`` and writes its
  manifest; each package loads what the other wrote into its own plan.
- Resume after a failure at shard k (in process, and in a subprocess killed
  with SIGKILL after two shards) is bit-identical to an uninterrupted build,
  the durable shards untouched; a corrupt, truncated or missing shard is
  rebuilt alone; an unreadable manifest rebuilds everything; a stale
  fingerprint or format version starts fresh and deletes the old files.
- The memory budget raises before any shard is written; ``write_layout=
  False`` round-trips; a rank subset equals the full world's rows;
  ``ranks=`` without a cache dir raises; ``use_native`` is warned about and
  ignored; ``from_global(plan_cache_dir=)`` equals the uncached graph and
  the reference's directory name; the selftest CLI passes every check the
  reference's has but its chaos checks.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from dgraph_tpu import plan as ref_plan
from dgraph_tpu import plan_shards as ref_ps
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.train import checkpoint as ref_ckpt
from dgraph_tpu_torch import plan as port_plan
from dgraph_tpu_torch import plan_shards as ps
from dgraph_tpu_torch.data import DistributedGraph, synthetic
from dgraph_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _graph(seed=0, n=48, e=300, w=4, bipartite=False):
    """A small random graph in contiguous per-rank blocks (the kill-and-resume
    worker rebuilds the same one from the same seed)."""
    rng = np.random.default_rng(seed)
    part = np.sort(rng.integers(0, w, n)).astype(np.int64)
    if not bipartite:
        return rng.integers(0, n, (2, e)).astype(np.int64), part, None
    n_dst = n // 2 + 5
    dst_part = np.sort(rng.integers(0, w, n_dst)).astype(np.int64)
    edges = np.stack([rng.integers(0, n, e), rng.integers(0, n_dst, e)]).astype(np.int64)
    return edges, part, dst_part


def _tensor_leaves(plan) -> dict:
    out = {}
    for name, sub in (("", plan), ("halo.", plan.halo), ("overlap.", plan.overlap)):
        if sub is None:
            continue
        for f in dataclasses.fields(sub):
            v = getattr(sub, f.name)
            if isinstance(v, torch.Tensor):
                out[name + f.name] = v
    return out


def _statics(plan) -> dict:
    out = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
           if not isinstance(getattr(plan, f.name), (torch.Tensor, type(plan.halo)))
           and f.name != "overlap"}
    out["halo.s_pad"] = plan.halo.s_pad
    if plan.overlap is not None:
        out.update({f"overlap.{k}": getattr(plan.overlap, k)
                    for k in ("e_int_pad", "e_bnd_pad", "interior_mc", "boundary_mc")})
    return out


def assert_plans_equal(a, b):
    la, lb = _tensor_leaves(a), _tensor_leaves(b)
    assert set(la) == set(lb) and la
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k
    assert _statics(a) == _statics(b)
    for k in ("halo_sort_perm", "halo_sorted_ids"):
        assert (getattr(a, k) is None) == (getattr(b, k) is None), k


def assert_layouts_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name), err_msg=f.name)


def _plan_dir(cache_dir) -> str:
    (d,) = [os.path.join(str(cache_dir), x) for x in os.listdir(str(cache_dir))
            if x.startswith("plan_")]
    return d


def _mtimes(d, man, skip=()) -> dict:
    return {r: os.stat(os.path.join(d, e["file"])).st_mtime_ns
            for r, e in man["shards"].items() if r not in skip}


def _shas(d) -> dict:
    return {r: e["sha256"] for r, e in ps.read_manifest(d)["shards"].items()}


# --- the sharded build ----------------------------------------------------------


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("sort_route", [False, True])
@pytest.mark.parametrize("edge_owner", ["dst", "src"])
@pytest.mark.parametrize("bipartite", [False, True], ids=["homogeneous", "bipartite"])
def test_sharded_build_equals_monolithic_and_writes_the_reference_bytes(
        tmp_path, bipartite, edge_owner, sort_route, overlap, W):
    edges, part, dst_part = _graph(seed=W, w=W, bipartite=bipartite)
    kw = dict(world_size=W, edge_owner=edge_owner, sort_route=sort_route, overlap=overlap)
    mono, mono_layout = port_plan.build_edge_plan(edges, part, dst_part, **kw)
    plan, layout = port_plan.build_edge_plan_sharded(
        edges, part, dst_part, out_dir=str(tmp_path / "port"), fingerprint="parity", **kw)
    assert_plans_equal(plan, mono)
    assert plan.halo_schedule == mono.halo_schedule and plan.wire_format == mono.wire_format
    assert plan.ranks is None
    assert_layouts_equal(layout, mono_layout)
    ref_plan.build_plan_shards(edges, part, dst_part, out_dir=str(tmp_path / "ref"),
                               fingerprint="parity", use_native=False, **kw)
    assert ps.read_manifest(str(tmp_path / "port")) == ref_ps.read_manifest(str(tmp_path / "ref"))


def test_native_core_rejected_in_the_sharded_build(tmp_path):
    edges, part, _ = _graph()
    with pytest.raises(ValueError, match="use_native"):
        port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4,
                                    use_native=True)


def test_default_fingerprint_is_the_reference_content_hash(tmp_path):
    edges, part, _ = _graph()
    m = port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path / "a"), world_size=4)
    assert m["fingerprint"] == ref_plan._content_fingerprint(edges, part, None)
    assert m["fingerprint"].startswith("content:")
    edges2 = np.ascontiguousarray(edges[:, ::-1])
    m2 = port_plan.build_plan_shards(edges2, part, out_dir=str(tmp_path / "a"), world_size=4)
    assert m2["fingerprint"] != m["fingerprint"] and m2["complete"]


def test_shard_nbytes_estimate_is_an_upper_bound(tmp_path):
    edges, part, _ = _graph()
    man = port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4,
                                      overlap=True, sort_route=True)
    est = port_plan.shard_nbytes_estimate(man["statics"])
    assert est == ref_plan.shard_nbytes_estimate(man["statics"])
    for r in range(4):
        assert ps.payload_nbytes(ps.read_shard(str(tmp_path), r, man["shards"][str(r)])) <= est


# --- the cache against the reference's -------------------------------------------


@pytest.mark.parametrize("case", ["plain", "bipartite", "overlap", "key_extra"])
def test_cache_key_and_manifest_match_the_reference(tmp_path, case):
    edges, part, dst_part = _graph(bipartite=case == "bipartite")
    kw = {"overlap": True} if case == "overlap" else {}
    if case == "key_extra":
        kw["key_extra"] = {"partition_method": "random", "part_sample_frac": 0.35}
    plan, layout = ckpt.cached_edge_plan(str(tmp_path / "port"), edges, part, dst_part,
                                         world_size=4, pad_multiple=8, **kw)
    ref_ckpt.cached_edge_plan(str(tmp_path / "ref"), edges, part, dst_part, world_size=4,
                              pad_multiple=8, **kw)
    d, dr = _plan_dir(tmp_path / "port"), _plan_dir(tmp_path / "ref")
    assert os.path.basename(d) == os.path.basename(dr)
    assert ps.read_manifest(d) == ref_ps.read_manifest(dr)
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as a, open(os.path.join(dr, f), "rb") as b:
            assert a.read() == b.read(), f
    mono, mono_layout = port_plan.build_edge_plan(edges, part, dst_part, world_size=4, **{
        k: v for k, v in kw.items() if k != "key_extra"})
    assert_plans_equal(plan, mono)
    assert_layouts_equal(layout, mono_layout)


def test_port_loads_a_reference_written_cache_into_its_own_plan(tmp_path):
    edges, part, _ = _graph(seed=5)
    ref_ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4, overlap=True)
    d = _plan_dir(tmp_path)
    before = {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)}
    got, got_layout = port_plan.load_sharded_plan(d)
    own, own_layout = port_plan.build_edge_plan(edges, part, world_size=4, overlap=True)
    assert_plans_equal(got, own)
    assert got.halo_schedule == own.halo_schedule
    assert_layouts_equal(got_layout, own_layout)
    # the port's cache warm-hits the reference's artifact: nothing rewritten
    plan, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4, overlap=True)
    assert_plans_equal(plan, own)
    assert {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)} == before


def test_reference_loads_a_port_written_cache_into_its_own_plan(tmp_path):
    edges, part, _ = _graph(seed=6, w=2)
    ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=2, sort_route=True)
    got, _ = ref_plan.load_sharded_plan(_plan_dir(tmp_path))
    own, _ = ref_plan.build_edge_plan(edges, part, world_size=2, sort_route=True,
                                      use_native=False)
    for f in dataclasses.fields(own):
        a, b = getattr(got, f.name), getattr(own, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        elif f.name not in ("halo", "overlap"):
            assert a == b, f.name
    np.testing.assert_array_equal(got.halo.send_idx, own.halo.send_idx)


# --- resume --------------------------------------------------------------------


def test_resume_after_a_failure_at_shard_k_is_bit_identical(tmp_path, monkeypatch):
    edges, part, _ = _graph()
    out, clean = str(tmp_path / "resumed"), str(tmp_path / "clean")
    real = ps.write_shard

    def failing(plan_dir, rank, payload):
        if rank == 2:
            raise OSError("injected failure before shard 2")
        return real(plan_dir, rank, payload)

    monkeypatch.setattr(ps, "write_shard", failing)
    with pytest.raises(OSError, match="shard 2"):
        port_plan.build_plan_shards(edges, part, out_dir=out, world_size=4, fingerprint="res")
    monkeypatch.setattr(ps, "write_shard", real)
    man = ps.read_manifest(out)
    assert sorted(man["shards"]) == ["0", "1"] and not man["complete"]
    durable = _mtimes(out, man)
    man = port_plan.build_plan_shards(edges, part, out_dir=out, world_size=4, fingerprint="res")
    assert man["complete"] and _mtimes(out, man, skip=("2", "3")) == durable
    port_plan.build_plan_shards(edges, part, out_dir=clean, world_size=4, fingerprint="res")
    assert _shas(out) == _shas(clean)
    assert ps.read_manifest(out) == ps.read_manifest(clean)


_KILL_WORKER = """
import os, signal, sys
import numpy as np
sys.path.insert(0, {repo!r})
from dgraph_tpu_torch import plan, plan_shards

rng = np.random.default_rng(0)
part = np.sort(rng.integers(0, 4, 48)).astype(np.int64)
edges = rng.integers(0, 48, (2, 300)).astype(np.int64)
if sys.argv[2] == "kill":
    real = plan_shards.write_shard

    def write_shard(plan_dir, rank, payload):
        if rank == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return real(plan_dir, rank, payload)

    plan_shards.write_shard = write_shard
plan.build_plan_shards(edges, part, out_dir=sys.argv[1], world_size=4, fingerprint="killres")
print("BUILD_COMPLETE")
"""


def _run_kill_worker(out_dir, mode):
    return subprocess.run([sys.executable, "-c", _KILL_WORKER.format(repo=REPO), str(out_dir),
                           mode], capture_output=True, text=True, timeout=120, cwd=REPO)


def test_build_killed_after_two_shards_resumes_bit_identical(tmp_path):
    killed, clean = tmp_path / "killed", tmp_path / "clean"
    r = _run_kill_worker(killed, "kill")
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-800:])
    assert "BUILD_COMPLETE" not in r.stdout
    man = ps.read_manifest(str(killed))
    assert not man["complete"] and sorted(man["shards"]) == ["0", "1"]
    durable = _mtimes(str(killed), man)
    r = _run_kill_worker(killed, "resume")
    assert r.returncode == 0 and "BUILD_COMPLETE" in r.stdout, r.stderr[-800:]
    man = ps.read_manifest(str(killed))
    assert man["complete"] and _mtimes(str(killed), man, skip=("2", "3")) == durable
    assert _run_kill_worker(clean, "resume").returncode == 0
    assert _shas(str(killed)) == _shas(str(clean))
    assert_plans_equal(port_plan.load_sharded_plan(str(killed))[0],
                       port_plan.load_sharded_plan(str(clean))[0])


# --- repair --------------------------------------------------------------------


def _damage(path, how):
    if how == "missing":
        os.unlink(path)
        return
    with open(path, "r+b") as f:
        if how == "truncated":
            f.truncate(os.path.getsize(path) // 2)
        else:
            f.seek(os.path.getsize(path) // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("how", ["corrupt", "truncated", "missing"])
def test_bad_shard_is_rebuilt_alone(tmp_path, caplog, how):
    edges, part, _ = _graph()
    plan0, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    d = _plan_dir(tmp_path)
    man = ps.read_manifest(d)
    shas = _shas(d)
    others = _mtimes(d, man, skip=("2",))
    _damage(os.path.join(d, man["shards"]["2"]["file"]), how)
    want = {"corrupt": "checksum", "truncated": "truncated", "missing": "missing"}[how]
    assert ps.bad_shards(d, man) == {2: want}
    with caplog.at_level("WARNING", logger="dgraph_tpu_torch.checkpoint"):
        plan1, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    assert_plans_equal(plan1, plan0)
    assert any("shard 2" in r.getMessage() for r in caplog.records)
    man = ps.read_manifest(d)
    assert man["complete"] and not ps.bad_shards(d, man)
    assert _mtimes(d, man, skip=("2",)) == others and _shas(d) == shas


def test_unreadable_manifest_rebuilds_everything(tmp_path):
    edges, part, _ = _graph()
    plan0, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    d = _plan_dir(tmp_path)
    with open(ps.manifest_path(d), "w") as f:
        f.write("{ not json")
    plan1, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    assert_plans_equal(plan1, plan0)
    assert ps.read_manifest(d)["complete"]


def test_incomplete_manifest_resumes_through_the_cache(tmp_path, monkeypatch):
    edges, part, _ = _graph()
    real = ps.write_shard

    def failing(plan_dir, rank, payload):
        if rank == 3:
            raise OSError("injected")
        return real(plan_dir, rank, payload)

    monkeypatch.setattr(ps, "write_shard", failing)
    with pytest.raises(OSError):
        ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    monkeypatch.setattr(ps, "write_shard", real)
    d = _plan_dir(tmp_path)
    durable = _mtimes(d, ps.read_manifest(d))
    plan, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    assert_plans_equal(plan, port_plan.build_edge_plan(edges, part, world_size=4)[0])
    assert _mtimes(d, ps.read_manifest(d), skip=("3",)) == durable


@pytest.mark.parametrize("stale", ["fingerprint", "format_version"])
def test_stale_artifact_starts_fresh_and_deletes_its_files(tmp_path, stale):
    edges, part, _ = _graph()
    out = str(tmp_path / "shards")
    port_plan.build_plan_shards(edges, part, out_dir=out, world_size=4, fingerprint="old")
    if stale == "format_version":
        man = ps.read_manifest(out)
        man["format_version"] = ckpt.PLAN_FORMAT_VERSION - 1
        ps.write_manifest(out, man)
        fp = "old"
    else:
        fp = "new"
    w = ps.PlanShardWriter(out, fingerprint=fp, world_size=4, statics={})
    assert not w.done(0)
    assert not any(f.startswith("shard_") or f == ps.LAYOUT_NAME for f in os.listdir(out))
    assert not os.path.exists(ps.manifest_path(out))


def test_verify_off_warm_hit_still_repairs_a_truncated_shard(tmp_path):
    edges, part, _ = _graph()
    plan, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    plan2, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4, verify=False)
    assert_plans_equal(plan2, plan)
    d = _plan_dir(tmp_path)
    _damage(os.path.join(d, ps.read_manifest(d)["shards"]["1"]["file"]), "truncated")
    plan3, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4, verify=False)
    assert_plans_equal(plan3, plan)


# --- budget, layout, subsets, knobs ---------------------------------------------


def test_memory_budget_raises_before_any_shard(tmp_path, monkeypatch):
    edges, part, _ = _graph()
    with pytest.raises(ps.PlanBuildMemoryExceeded) as ei:
        port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4,
                                    memory_budget_bytes=1024)
    rec = ei.value.record()
    assert rec["kind"] == "plan_build_memory_exceeded" and rec["budget_bytes"] == 1024
    assert rec["needed_bytes"] > 1024 and rec["rank"] is None
    assert not any(f.startswith("shard_") for f in os.listdir(str(tmp_path)))
    monkeypatch.setenv(ps.MEMORY_BUDGET_ENV, "0.001")
    with pytest.raises(ps.PlanBuildMemoryExceeded):
        port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4)
    monkeypatch.setenv(ps.MEMORY_BUDGET_ENV, "64")
    assert port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4)[
        "complete"]


def test_write_layout_false_round_trips_under_one_key(tmp_path):
    edges, part, _ = _graph()
    man = port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path / "b"), world_size=4,
                                      write_layout=False)
    assert man["complete"] and man["layout"] is None
    assert port_plan.load_sharded_plan(str(tmp_path / "b"), load_layout=False)[1] is None
    cache = tmp_path / "cache"
    plan, layout = ckpt.cached_edge_plan(str(cache), edges, part, world_size=4,
                                         write_layout=False)
    assert layout is None and not os.path.exists(os.path.join(_plan_dir(cache), "layout.pkl"))
    plan2, layout2 = ckpt.cached_edge_plan(str(cache), edges, part, world_size=4,
                                           write_layout=False)
    assert layout2 is None
    assert_plans_equal(plan2, plan)
    # the same key with the sidecar: written on demand, one directory
    plan3, layout3 = ckpt.cached_edge_plan(str(cache), edges, part, world_size=4)
    assert layout3 is not None and len(os.listdir(str(cache))) == 1
    assert_plans_equal(plan3, plan)


@pytest.mark.parametrize("W", [2, 4])
def test_rank_subset_equals_the_full_world_rows(tmp_path, W):
    edges, part, _ = _graph(seed=3, w=W)
    d = str(tmp_path / "shards")
    port_plan.build_plan_shards(edges, part, out_dir=d, world_size=W, overlap=True,
                                sort_route=True, write_layout=False)
    full, _ = port_plan.load_sharded_plan(d, load_layout=False)
    port_plan.validate_plan(full)
    full_leaves = _tensor_leaves(full)
    for r in range(W):
        sub, layout = port_plan.load_sharded_plan(d, ranks=[r], load_layout=False)
        assert layout is None and sub.ranks == (r,) and sub.world_size == W
        for name, leaf in _tensor_leaves(sub).items():
            assert leaf.shape[0] == 1 and torch.equal(leaf[0], full_leaves[name][r]), name
        assert {k: v for k, v in _statics(sub).items() if k != "ranks"} == {
            k: v for k, v in _statics(full).items() if k != "ranks"}
        port_plan.validate_plan(sub)
        one, want = sub.to("cpu").shard(r), full.shard(r)
        assert_plans_equal(dataclasses.replace(one, ranks=None), want)
        with pytest.raises(ValueError, match="not in this plan's ranks"):
            sub.shard((r + 1) % W)
    two, _ = port_plan.load_sharded_plan(d, ranks=[W - 1, 0], load_layout=False)
    assert two.ranks == (W - 1, 0)
    assert torch.equal(two.shard(0).src_index, full.shard(0).src_index)
    assert torch.equal(two.shard(W - 1).dst_index, full.shard(W - 1).dst_index)


def test_cached_subset_skips_the_layout_sidecar(tmp_path):
    edges, part, _ = _graph()
    ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)
    with open(os.path.join(_plan_dir(tmp_path), "layout.pkl"), "wb") as f:
        f.write(b"garbage")
    plan, layout = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4, ranks=[0, 2])
    assert layout is None and plan.ranks == (0, 2) and plan.src_index.shape[0] == 2
    assert ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4)[1] is not None


def test_ranks_without_a_cache_dir_raises_and_no_cache_builds():
    edges, part, _ = _graph()
    with pytest.raises(ValueError, match="cache_dir"):
        ckpt.cached_edge_plan("", edges, part, world_size=4, ranks=[0])
    plan, layout = ckpt.cached_edge_plan("", edges, part, world_size=4, write_layout=False)
    assert_plans_equal(plan, port_plan.build_edge_plan(edges, part, world_size=4)[0])
    assert layout is not None


def test_use_native_is_warned_about_and_ignored(tmp_path, caplog):
    edges, part, _ = _graph()
    with caplog.at_level("WARNING", logger="dgraph_tpu_torch.checkpoint"):
        plan, _ = ckpt.cached_edge_plan(str(tmp_path), edges, part, world_size=4,
                                        use_native=True)
    assert any("use_native is ignored" in r.getMessage() for r in caplog.records)
    assert_plans_equal(plan, port_plan.build_edge_plan(edges, part, world_size=4)[0])
    assert os.path.basename(_plan_dir(tmp_path)) == "plan_" + ref_ckpt._graph_fingerprint(
        edges, part, scatter_block_e=ref_plan.SCATTER_BLOCK_E,
        scatter_block_n=ref_plan.SCATTER_BLOCK_N, overlap=False, world_size=4)


# --- from_global -----------------------------------------------------------------


@pytest.fixture(scope="module")
def sbm():
    return synthetic.sbm_classification_graph(num_nodes=300, seed=2)


@pytest.mark.parametrize("W", [1, 2, 4])
def test_from_global_through_the_cache_equals_uncached_and_names_the_reference_dir(
        tmp_path, sbm, W):
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], W)
    kw = dict(partition_method="random", add_symmetric_norm=True)
    plain = DistributedGraph.from_global(*args, **kw)
    for run in range(2):  # cold, then warm
        g = DistributedGraph.from_global(*args, plan_cache_dir=str(tmp_path / "port"), **kw)
        assert_plans_equal(g.plan, plain.plan)
        assert_layouts_equal(g.layout, plain.layout)
        for name in ("features", "labels", "vertex_mask", "edge_weight"):
            assert torch.equal(getattr(g, name), getattr(plain, name)), name
        for k in plain.masks:
            assert torch.equal(g.masks[k], plain.masks[k]), k
    JaxGraph.from_global(*args, plan_cache_dir=str(tmp_path / "ref"), tune="off", **kw)
    names = [os.listdir(str(tmp_path / w)) for w in ("port", "ref")]
    assert names[0] == names[1] and len(names[0]) == 1


# --- the selftest CLI ------------------------------------------------------------


def test_selftest_agrees_with_the_reference_but_its_chaos_checks():
    from dgraph_tpu.plan_shards import _selftest as ref_selftest

    assert ref_selftest()["failures"] == []
    p = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.plan_shards", "--selftest",
                        "true"], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["kind"] == "plan_shards_selftest" and out["failures"] == []
    assert any("chaos" in s for s in out["skipped"])
    assert out["run_health"]["error"] is None


def test_manifest_summary_cli(tmp_path):
    edges, part, _ = _graph()
    port_plan.build_plan_shards(edges, part, out_dir=str(tmp_path), world_size=4)
    p = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.plan_shards", "--plan_dir",
                        str(tmp_path)], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["complete"] and out["shards"] == 4 and out["bad"] == {}
