"""Checkpoint hot swap (``serve/rollover.py``, ``ServeEngine.swap_params``) at
one rank on the CPU, held against the reference.

The reference's ``ServeEngine.infer`` raises ``ShardingTypeError`` on the
installed JAX (a failure the JAX package keeps), so its ``swap_params``
cannot reach adoption: its bucket forward inside validation fails. The
oracles are therefore:

- the reference's ``full_logits()`` on the new flax params, for an adopted
  swap: the port's new ``full_logits()`` within 1e-4 of it, served rows
  over every bucket bit-equal to the port's own, every parameter's
  ``data_ptr()`` unchanged, the lineage record with the reference's keys;
- the reference's ``swap_params`` itself, on an un-warmed reference engine,
  for every rejection it decides before its first forward (``no_source``,
  ``not_found``, ``restore_failed`` on a torn step, ``structure_mismatch``
  on a missing key or a changed shape, ``nonfinite_params``): the same
  reason, ``adopted``, ``rolled_back`` and step, one lineage record each,
  the served bits unchanged;
- the port alone for ``nonfinite_logits`` (finite weights whose logits
  overflow), ``parity`` (a served path patched to differ) and ``fault``
  (``pre_swap`` raising), each rolled back;
- threads driving the batcher across an adopted and a rejected swap: no
  request dropped, every reply wholly the old or the new rows.
"""

import json
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dgraph_tpu.comm import Communicator
from dgraph_tpu.comm.mesh import make_graph_mesh
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.data import synthetic as jax_synthetic
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.serve import rollover as ref_rollover
from dgraph_tpu.serve.engine import ServeEngine as JaxServeEngine
from dgraph_tpu.serve.errors import SwapRejected as RefSwapRejected
from dgraph_tpu.train import checkpoint as ref_ckpt
from dgraph_tpu_torch.serve import rollover
from dgraph_tpu_torch.serve.__main__ import Config, build_serving
from dgraph_tpu_torch.serve.errors import SwapRejected
from dgraph_tpu_torch.train import checkpoint as port_ckpt
from dgraph_tpu_torch.weights import params_from_jax
from test_torch_checkpoint import truncate_step

TOL = 1e-4
SCALE = 1.0625  # step 1: step 0's params scaled, as the serve selftest saves it
CFG = Config(model="gcn", num_nodes=400, max_bucket=64)


def _scaled(tree, factor):
    return jax.tree.map(lambda a: np.asarray(a) * np.asarray(factor, np.asarray(a).dtype), tree)


@pytest.fixture(scope="module")
def ref():
    """The reference's side at one rank: the graph, the flax model, step 0's
    and step 1's params, and its full_logits() on step 1 (original ids)."""
    data = jax_synthetic.sbm_classification_graph(
        num_nodes=CFG.num_nodes, num_classes=CFG.num_classes, feat_dim=CFG.feat_dim,
        avg_degree=CFG.avg_degree, seed=CFG.seed)
    graph = JaxGraph.from_global(data["edge_index"], data["features"], data["labels"],
                                 data["masks"], 1, partition_method=CFG.partition,
                                 add_symmetric_norm=True, tune="off")
    model = JaxGCN(CFG.hidden, CFG.num_classes, comm=Communicator.init_process_group("single"))
    plan0 = jax.tree.map(lambda a: jnp.asarray(a[0]), graph.plan)
    p0 = model.init(jax.random.key(3), jnp.asarray(graph.features[0]), plan0,
                    jnp.asarray(graph.edge_weight[0]))
    p0 = jax.tree.map(np.asarray, p0)
    p1 = _scaled(p0, SCALE)
    mesh = make_graph_mesh(ranks_per_graph=1, devices=jax.devices()[:1])
    eng = JaxServeEngine.from_distributed_graph(model, mesh, graph, p1)
    full1 = eng.full_logits()
    r, s = eng.rank_slot(np.arange(CFG.num_nodes))
    return {"graph": graph, "model": model, "mesh": mesh, "p0": p0, "p1": p1,
            "full1": full1[r, s]}


def _ref_engine(ref, ckpt_dir=None):
    eng = JaxServeEngine.from_distributed_graph(ref["model"], ref["mesh"], ref["graph"],
                                                ref["p0"])
    eng.ckpt_dir = ckpt_dir
    return eng


def _port(ref, tmp_path, *, ckpt=True):
    """The port's engine and batcher serving step 0 (through ``--ckpt_dir``
    when ``ckpt``; else from the flax params loaded in place), with step 1
    saved beside it."""
    ckpt_dir = str(tmp_path / "port_ckpt")
    if ckpt:
        port_ckpt.save_checkpoint(ckpt_dir, {"params": params_from_jax(ref["p0"]), "step": 0}, 0)
    engine, batcher, _ = build_serving(
        Config(**dict(vars(CFG), ckpt_dir=ckpt_dir if ckpt else "")), device="cpu")
    if not ckpt:
        engine.model.load_state_dict(params_from_jax(ref["p0"]))
    else:
        assert engine.restored_step == 0
        port_ckpt.save_checkpoint(ckpt_dir, {"params": params_from_jax(ref["p1"]), "step": 1}, 1)
    return engine, batcher, ckpt_dir


def _bits(a):
    return np.asarray(a).view(np.int32)


def _served_every_bucket(engine):
    """(ids, rows) of one request a bucket and of one request of each odd
    size past a bucket's edge."""
    out = []
    for n in (1, 7, 8, 9, 16, 17, 33, 64):
        ids = np.arange(n) * 3 % engine.num_nodes
        out.append((ids, engine.infer(ids)))
    return out


def _ptrs(engine):
    return {k: (p.data_ptr(), p.device) for k, p in engine.model.state_dict().items()}


def test_adopted_swap_serves_the_reference_full_logits(ref, tmp_path):
    engine, batcher, ckpt_dir = _port(ref, tmp_path)
    batcher.stop()
    engine.warmup()
    before, ptrs = engine.full_logits(), _ptrs(engine)
    forwards = engine.forwards
    rec = engine.swap_params(step=1)  # a bare step: against engine.ckpt_dir
    assert engine.forwards - forwards == 2  # the full and the bucket validation forwards
    assert rec["adopted"] and not rec["rolled_back"] and rec["step"] == 1
    assert rec["ckpt_dir"] == ckpt_dir and engine.serving_step == 1
    assert _ptrs(engine) == ptrs  # adopted in place: every data_ptr() kept
    full = engine.full_logits()
    assert not np.array_equal(full, before)
    r, s = engine.rank_slot(np.arange(engine.num_nodes))
    np.testing.assert_allclose(full[r, s], ref["full1"], rtol=TOL, atol=TOL)
    for ids, out in _served_every_bucket(engine):
        rr, ss = engine.rank_slot(ids)
        np.testing.assert_array_equal(_bits(out), _bits(full[rr, ss]))
    # the live parameters are step 1's, bit for bit
    want = params_from_jax(ref["p1"])
    for k, v in engine.model.state_dict().items():
        np.testing.assert_array_equal(_bits(v.numpy()), _bits(want[k].numpy()), err_msg=k)
    # one lineage record, with the keys the reference's swap_params writes
    # (an adopted record is a rejected one without reason and detail)
    assert engine.lineage[-1] == rec and len(engine.lineage) == 2
    ref_eng = _ref_engine(ref)
    bad = jax.tree.map(np.array, ref["p0"])
    jax.tree.leaves(bad)[0].reshape(-1)[0] = np.nan
    with pytest.raises(RefSwapRejected):
        ref_rollover.swap_params(ref_eng, params=bad)
    assert set(rec) == set(ref_eng.lineage[-1]) - {"reason", "detail"}
    json.dumps(engine.lineage)
    snap = engine.registry.snapshot()
    assert snap["counters"]["serve.swaps_adopted"] == 1
    assert snap["gauges"]["serve.swap_s"] == rec["swap_s"]
    assert set(engine.last_swap_s) >= {"restore", "stage", "validate", "adopt", "agree"}


def test_swap_by_params_and_parity_ids(ref, tmp_path):
    """``params=`` (a state dict) and explicit ``parity_ids`` adopt as a
    directory does; the record names no directory."""
    engine, batcher, _ = _port(ref, tmp_path)
    batcher.stop()
    rec = engine.swap_params(params=params_from_jax(ref["p1"]), step=7,
                             parity_ids=np.array([5, 399, 17]))
    assert rec["adopted"] and rec["ckpt_dir"] is None and rec["step"] == 7
    full = engine.full_logits()
    r, s = engine.rank_slot(np.arange(engine.num_nodes))
    np.testing.assert_allclose(full[r, s], ref["full1"], rtol=TOL, atol=TOL)


def _reject_case(case, ref, tmp_path):
    """(the reference's call, the port's call) of one early rejection."""
    ref_dir, port_dir = str(tmp_path / "ref_ckpt"), str(tmp_path / "port_dir")
    if case == "no_source":
        return (lambda e: ref_rollover.swap_params(e), lambda e: e.swap_params(), False)
    if case == "not_found":
        (tmp_path / "empty").mkdir()
        empty = str(tmp_path / "empty")
        return (lambda e: ref_rollover.swap_params(e, empty),
                lambda e: e.swap_params(empty), True)
    if case == "restore_failed":
        ref_ckpt.save_checkpoint(ref_dir, {"params": ref["p1"], "step": 1}, 1)
        port_ckpt.save_checkpoint(port_dir, {"params": params_from_jax(ref["p1"]), "step": 1}, 1)
        assert truncate_step(ref_dir, 1) > 0 and truncate_step(port_dir, 1) > 0
        return (lambda e: ref_rollover.swap_params(e, ref_dir, step=1),
                lambda e: e.swap_params(port_dir, step=1), True)
    tree = jax.tree.map(np.array, ref["p0"])
    layer = tree["params"]["GraphConvLayer_1"]
    name = "Dense_0" if "Dense_0" in layer else sorted(layer)[0]
    if case == "missing_key":
        leaf = sorted(layer[name])[-1]
        del layer[name][leaf]
    elif case == "changed_shape":
        leaf = sorted(layer[name])[0]
        layer[name][leaf] = layer[name][leaf][..., :-1]
    else:  # nonfinite_params
        jax.tree.leaves(tree)[0].reshape(-1)[0] = np.nan
    port_params = params_from_jax(tree)
    return (lambda e: ref_rollover.swap_params(e, params=tree),
            lambda e: e.swap_params(params=port_params), True)


REJECTIONS = {"no_source": "no_source", "not_found": "not_found",
              "restore_failed": "restore_failed", "missing_key": "structure_mismatch",
              "changed_shape": "structure_mismatch", "nonfinite_params": "nonfinite_params"}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_early_rejections_match_the_reference(ref, tmp_path, case):
    ref_call, port_call, with_ckpt = _reject_case(case, ref, tmp_path)
    ref_eng = _ref_engine(ref)
    engine, batcher, _ = _port(ref, tmp_path, ckpt=with_ckpt)
    try:
        full, ptrs = engine.full_logits(), _ptrs(engine)
        served = _served_every_bucket(engine)
        ref_full = ref_eng.full_logits()
        with pytest.raises(RefSwapRejected) as want:
            ref_call(ref_eng)
        with pytest.raises(SwapRejected) as got:
            port_call(engine)
        keys = ("reason", "adopted", "rolled_back", "step")
        assert {k: got.value.context.get(k) for k in keys} == {
            k: want.value.context.get(k) for k in keys}
        assert got.value.context["reason"] == REJECTIONS[case]
        assert got.value.record()["error"] == "swap_rejected"
        assert len(ref_eng.lineage) == 1 and len(engine.lineage) == 1 + with_ckpt
        got_rec, want_rec = engine.lineage[-1], ref_eng.lineage[-1]
        assert {k: got_rec.get(k) for k in keys} == {k: want_rec.get(k) for k in keys}
        assert set(got_rec) == set(want_rec)
        json.dumps(engine.lineage)
        # nothing moved on either side
        np.testing.assert_array_equal(_bits(engine.full_logits()), _bits(full))
        for (ids, out), (_, again) in zip(served, _served_every_bucket(engine)):
            np.testing.assert_array_equal(_bits(again), _bits(out))
        assert _ptrs(engine) == ptrs
        np.testing.assert_array_equal(ref_eng.full_logits(), ref_full)
        assert engine.registry.snapshot()["counters"]["serve.swap_rejected"] == 1
    finally:
        batcher.stop()


def _port_only(case, engine):
    """The port's call of a rejection the reference decides after its first
    forward (so cannot reach on the installed JAX)."""
    if case == "nonfinite_logits":
        # finite weights whose logits overflow float32
        params = {k: v * 1e30 for k, v in engine.model.state_dict().items()}
        return lambda: engine.swap_params(params=params)
    if case == "parity":
        real = engine._bucket_rows

        def drifted(slot, params=None):
            return real(slot, params) + 1e-3

        def call():
            engine._bucket_rows = drifted
            try:
                engine.swap_params(step=1)
            finally:
                del engine._bucket_rows
        return call

    def boom():
        raise RuntimeError("fault injected mid-swap")

    engine.pre_swap = boom
    return lambda: engine.swap_params(step=1)


@pytest.mark.parametrize("case", ("nonfinite_logits", "parity", "fault"))
def test_late_rejections_roll_back(ref, tmp_path, case):
    engine, batcher, ckpt_dir = _port(ref, tmp_path)
    batcher.stop()
    full, ptrs = engine.full_logits(), _ptrs(engine)
    state = {k: v.clone() for k, v in engine.model.state_dict().items()}
    call = _port_only(case, engine)
    with pytest.raises(SwapRejected) as info:
        call()
    ctx = info.value.context
    assert ctx["reason"] == case and ctx["rolled_back"] and not ctx["adopted"]
    assert engine.lineage[-1]["reason"] == case and len(engine.lineage) == 2
    assert engine.serving_step == 0
    np.testing.assert_array_equal(_bits(engine.full_logits()), _bits(full))
    assert _ptrs(engine) == ptrs
    for k, v in engine.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    engine.pre_swap = None
    assert engine.swap_params(step=1)["adopted"]  # the engine swaps again afterwards


def test_swap_is_rank_zeros(ref, tmp_path):
    engine, batcher, _ = _port(ref, tmp_path)
    batcher.stop()
    engine.rank = 1
    with pytest.raises(RuntimeError, match="rank 0's"):
        engine.swap_params(step=1)
    engine.rank = 0
    assert len(engine.lineage) == 1


def test_params_mismatch_and_nonfinite_agree_with_the_reference(ref):
    """The structure and non-finite checks decide as the reference's on the
    same trees (the reference's on flax trees, the port's on the state
    dicts ``params_from_jax`` makes of them)."""
    base = ref["p0"]
    live = params_from_jax(base)
    trees = {"same": jax.tree.map(np.array, base)}
    t = jax.tree.map(np.array, base)
    t["params"]["GraphConvLayer_0"] = {k: v for k, v in list(
        t["params"]["GraphConvLayer_0"].items())[:-1]}
    trees["dropped"] = t
    t = jax.tree.map(np.array, base)
    t["params"] = dict(t["params"], GraphConvLayer_1=jax.tree.map(
        lambda a: a[..., :1], t["params"]["GraphConvLayer_1"]))
    trees["narrowed"] = t
    t = jax.tree.map(np.array, base)
    for leaf in jax.tree.leaves(t)[:2]:
        leaf.reshape(-1)[-1] = np.inf
    trees["two_inf"] = t
    for name, tree in trees.items():
        try:
            port_tree = params_from_jax(tree)
        except KeyError:
            port_tree = None
        want_mismatch = ref_rollover.params_mismatch(base, tree) is not None
        got_mismatch = port_tree is None or rollover.params_mismatch(live, port_tree) is not None
        assert got_mismatch == want_mismatch, name
        if not want_mismatch:
            assert (rollover.nonfinite_param_leaves(port_tree)
                    == ref_rollover.nonfinite_param_leaves(tree)), name
    assert rollover.params_mismatch(live, {k: v.double() for k, v in live.items()})
    assert rollover.params_mismatch(live, [1, 2])


SWAP_THREADS = 6


def test_batcher_traffic_across_adopted_and_rejected_swaps(ref, tmp_path):
    """Client threads keep submitting through the batcher while rank 0
    adopts step 1, then rejects a faulted swap: every request is answered,
    each reply is wholly step 0's or step 1's rows, and every request
    submitted after the adoption returned gets step 1's."""
    engine, batcher, _ = _port(ref, tmp_path)
    old = engine.full_logits()
    replies, errors, phase = [], [], {"adopted": False}
    stop = threading.Event()

    def client(seed):
        rng = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                ids = rng.choice(engine.num_nodes, size=int(rng.integers(1, 65)), replace=False)
                after = phase["adopted"]
                replies.append((ids, after, batcher.submit(ids).result(timeout=60)))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(repr(e))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    threads = [threading.Thread(target=client, args=(i,)) for i in range(SWAP_THREADS)]
    try:
        for t in threads:
            t.start()
        while len(replies) < 10:
            threading.Event().wait(0.01)
        assert engine.swap_params(step=1)["adopted"]
        phase["adopted"] = True
        new = engine.full_logits()

        def boom():
            raise RuntimeError("fault injected mid-swap")

        engine.pre_swap = boom
        n = len(replies)
        with pytest.raises(SwapRejected):
            engine.swap_params(step=0)
        while len(replies) < n + 10:
            threading.Event().wait(0.01)
    finally:
        stop.set()
        for t in threads:
            t.join(60)
        sys.setswitchinterval(switch)
        batcher.stop()
    assert not any(t.is_alive() for t in threads) and errors == []
    n_old = n_new = 0
    for ids, after, out in replies:
        r, s = engine.rank_slot(ids)
        is_new = np.array_equal(_bits(out), _bits(new[r, s]))
        is_old = np.array_equal(_bits(out), _bits(old[r, s]))
        assert is_new != is_old, "a reply mixes step 0's and step 1's rows"
        assert is_new or not after, "a request submitted after the adoption got step 0"
        n_old, n_new = n_old + is_old, n_new + is_new
    assert n_old and n_new
    assert np.array_equal(_bits(engine.full_logits()), _bits(new))
