"""The port's training against the JAX package's, one rank, same graph,
same initial weights (carried across by ``params_from_jax``).

The JAX side runs its composed path on the CPU; the port runs its autograd
Functions with the kernels' plain versions (the unweighted GCN takes the
fused-backward kernel pair's route, the weighted GCN the composed route).
Hidden width 160 makes ``map_feature_chunks`` cut two chunks (128 + 32).
GAT and the graph transformer (4 heads each) run the same cases: GAT's
head groups are one 160-wide head each, the graph transformer's attention
(head width 40) is the dense plain version and takes the vertex mask
(``vmask_batch_args``).

Tolerances (f32): the step-0 loss and every parameter gradient at
rtol=atol=1e-4; after 5 Adam steps at lr 5e-3, the five losses at
rtol=atol=1e-4 and the parameters at rtol=atol=1e-3. The parameters get the
looser bound because Adam's early updates are about ±lr per coordinate
whatever the gradient's size, so a gradient near 0 summed in another order
can move its coordinate by up to 2·lr.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from dgraph_tpu.comm import Communicator
from dgraph_tpu.data import DistributedGraph as JaxGraph
from dgraph_tpu.models import GAT as JaxGAT
from dgraph_tpu.models import GCN as JaxGCN
from dgraph_tpu.models import GraphSAGE as JaxSAGE
from dgraph_tpu.models import GraphTransformer as JaxGT
from dgraph_tpu.train.loop import masked_cross_entropy as jax_masked_ce
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.data import DistributedGraph, synthetic
from dgraph_tpu_torch.models import GAT, GCN, GraphSAGE, GraphTransformer
from dgraph_tpu_torch.obs.metrics import StepMetrics, step_record
from dgraph_tpu_torch.plan import build_edge_plan, validate_plan
from dgraph_tpu_torch.train import loop
from dgraph_tpu_torch.weights import init_params, params_from_jax, params_to_jax

F_IN, HIDDEN, C = 24, 160, 5
LR = 5e-3
JAX_COMM = Communicator.init_process_group("single")
CASES = ["gcn-weighted", "gcn-unweighted", "sage", "gat", "gt"]
BATCH_ARGS = {"gt": loop.vmask_batch_args}


@pytest.fixture(scope="module")
def graphs():
    sbm = synthetic.sbm_classification_graph(num_nodes=300, num_classes=C,
                                             feat_dim=F_IN, seed=2)
    args = (sbm["edge_index"], sbm["features"], sbm["labels"], sbm["masks"], 1)
    ours = DistributedGraph.from_global(*args, partition_method="random",
                                        add_symmetric_norm=True)
    ref = JaxGraph.from_global(*args, partition_method="random",
                               add_symmetric_norm=True, tune="off")
    return ours, ref


def _models(case):
    if case == "sage":
        return JaxSAGE(HIDDEN, C, comm=JAX_COMM), GraphSAGE(F_IN, HIDDEN, C, SingleComm())
    if case == "gat":
        return JaxGAT(HIDDEN, C, comm=JAX_COMM), GAT(F_IN, HIDDEN, C, SingleComm())
    if case == "gt":
        return (JaxGT(HIDDEN, C, comm=JAX_COMM, num_layers=2),
                GraphTransformer(F_IN, HIDDEN, C, SingleComm(), num_layers=2))
    return JaxGCN(HIDDEN, C, comm=JAX_COMM), GCN(F_IN, HIDDEN, C, SingleComm())


def _setup(graphs, case):
    """(flax params, the JAX loss of them, the torch model loaded with the
    same params, the torch batch with its leading rank axis)."""
    ours, ref = graphs
    jmodel, tmodel = _models(case)
    jargs = (jnp.asarray(ref.features[0]), jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan))
    batch = {"x": ours.features, "y": ours.labels, "mask": ours.masks["train"]}
    if case == "gcn-weighted":
        jargs += (jnp.asarray(ref.edge_weight[0]),)
        batch["edge_weight"] = ours.edge_weight
    if case == "gt":
        jargs += (jnp.asarray(ref.vertex_mask[0]),)
        batch["vmask"] = ours.vertex_mask
    params = jmodel.init(jax.random.key(0), *jargs)
    y, mask = jnp.asarray(ref.labels[0]), jnp.asarray(ref.masks["train"][0])

    def jax_loss(p):
        return jax_masked_ce(jmodel.apply(p, *jargs), y, mask, None)

    tmodel.load_state_dict(params_from_jax(params))
    return params, jax_loss, tmodel, batch


def _assert_trees_close(got: dict, want: dict, tol: float):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path], np.float32),
                                   np.asarray(w, np.float32), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", CASES)
def test_step0_loss_and_gradients_match_flax(graphs, case):
    ours, _ = graphs
    params, jax_loss, tmodel, batch = _setup(graphs, case)
    want_loss, want_grads = jax.value_and_grad(jax_loss)(params)
    b = {k: v[0] for k, v in batch.items()}
    loss = loop.masked_cross_entropy(
        loop.model_apply(tmodel, b, ours.plan.shard(0), BATCH_ARGS.get(case)), b["y"], b["mask"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4, atol=1e-4)
    grads = params_to_jax({k: p.grad for k, p in tmodel.named_parameters()})
    _assert_trees_close(grads, want_grads, 1e-4)


@pytest.mark.parametrize("case", CASES)
def test_five_adam_steps_match_optax(graphs, case):
    """make_train_step + torch Adam against jax.value_and_grad + optax.adam
    (bench.py:509-525's loop), both at lr 5e-3 with optax's defaults."""
    ours, _ = graphs
    params, jax_loss, tmodel, batch = _setup(graphs, case)
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    want_losses, grads0 = [], None
    for _ in range(5):
        loss, grads = jax.value_and_grad(jax_loss)(params)
        grads0 = grads if grads0 is None else grads0
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))
    step = loop.make_train_step(tmodel, torch.optim.Adam(tmodel.parameters(), lr=LR),
                                ours.plan, batch_args=BATCH_ARGS.get(case))
    got_losses = [float(step(batch)["loss"]) for _ in range(5)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4, atol=1e-4)
    assert got_losses[-1] < got_losses[0]
    got = params_to_jax(tmodel.state_dict())
    if case == "gt":
        _exclude_key_bias(got, params, grads0)
    _assert_trees_close(got, params, 1e-3)


def _exclude_key_bias(got: dict, want: dict, grads0: dict):
    """Leave the graph transformer's key bias (qkv.bias[L:2L]) out of the
    tree comparison: its gradient is analytically zero (the softmax over
    keys ignores a shift of every key's logit by q·b_k), so both sides'
    step-0 gradients there are rounding noise, which Adam normalises into
    updates of up to about lr a step in directions that differ between the
    two summation orders. The real check is that the step-0 gradient there
    is below 1e-6 on the flax side (the port's step-0 gradients are held to
    flax's in test_step0_loss_and_gradients_match_flax); the coordinates
    are then set equal."""
    k = slice(HIDDEN, 2 * HIDDEN)
    for layer in ("gps_0", "gps_1"):
        assert np.abs(np.asarray(grads0["params"][layer]["qkv"]["bias"])[k]).max() < 1e-6
        got["params"][layer]["qkv"]["bias"][k] = np.asarray(
            want["params"][layer]["qkv"]["bias"])[k]


def test_step_metrics_and_record(graphs):
    ours, _ = graphs
    model = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=1)
    batch = dict(ours.batch("train"), y=ours.labels)
    step = loop.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                ours.plan, step_metrics=True)
    m = step(batch)
    assert isinstance(m, StepMetrics)
    rec = step_record(m, step=3, wall_ms=1.23456)
    assert rec["kind"] == "step" and rec["step"] == 3 and rec["wall_ms"] == 1.235
    assert rec["mask_count"] == float(ours.masks["train"].sum())
    assert rec["grad_norm"] > 0 and 0 <= rec["accuracy"] <= 1
    assert StepMetrics.from_record(rec).loss == rec["loss"]
    assert step_record({"loss": torch.tensor(2.0)}, step=0) == {
        "kind": "step", "schema": 1, "loss": 2.0, "step": 0}


def test_nonfinite_guard_skips_the_update(graphs):
    ours, _ = graphs
    model = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = loop.make_train_step(model, torch.optim.Adam(model.parameters(), lr=LR),
                                ours.plan, nonfinite_guard=True)
    x = ours.features.clone()
    x[0, 3, 0] = float("nan")
    m = step(dict(ours.batch("train"), x=x, y=ours.labels))
    assert float(m["nonfinite_skipped"]) == 1.0
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())
    m = step(dict(ours.batch("train"), y=ours.labels))
    assert float(m["nonfinite_skipped"]) == 0.0
    assert not torch.equal(before["Dense_0.weight"], model.state_dict()["Dense_0.weight"])


def test_eval_step_and_fit(graphs):
    ours, _ = graphs
    model = GCN(F_IN, HIDDEN, C, SingleComm())
    model, history = loop.fit(model, ours, num_epochs=4, device="cpu")
    assert [h["epoch"] for h in history] == [0, 1, 2, 3]
    assert history[-1]["loss"] < history[0]["loss"]
    ev = loop.make_eval_step(model, ours.plan)(dict(ours.batch("val"), y=ours.labels))
    assert set(ev) == {"loss", "accuracy"} and np.isfinite(float(ev["loss"]))


def test_multi_rank_training_is_a_later_slice(graphs):
    """A per-replica batch at one rank is one replica of one rank: its
    ``[1, 1, ...]`` leaves give the step of the ``[1, ...]`` batch, and a
    batch without the replica axis raises (tests/test_torch_replica.py
    trains on replica groups); a plan of 2 ranks needs a communicator of 2
    ranks (tests/test_torch_dist.py trains on one)."""
    ours, _ = graphs
    batch = dict(ours.batch("train"), y=ours.labels)
    losses = []
    for per_replica in (False, True):
        model = init_params(GCN(F_IN, HIDDEN, C, SingleComm()), seed=1)
        step = loop.make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                    ours.plan, per_replica_batch=per_replica)
        b = {k: v[None] for k, v in batch.items()} if per_replica else batch
        losses += [float(step(b)["loss"]) for _ in range(2)]  # two steps each
    assert losses[:2] == losses[2:]
    with pytest.raises(ValueError, match="ranks, the plan has 1"):
        step(batch)
    model = GCN(F_IN, HIDDEN, C, SingleComm())
    opt = torch.optim.Adam(model.parameters())
    plan2, _ = build_edge_plan(ours.edge_index, np.arange(ours.num_nodes) * 2 // ours.num_nodes,
                               world_size=2)
    with pytest.raises(ValueError, match="DistComm of 2 ranks"):
        loop.make_train_step(model, opt, plan2)
    with pytest.raises(ValueError, match="DistComm of 2 ranks"):
        loop.make_eval_step(model, plan2, comm=SingleComm())


def test_masked_bce_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(20, 7)).astype(np.float32)
    labels = (rng.random((20, 7)) > 0.5).astype(np.float32)
    mask = (rng.random(20) > 0.3).astype(np.float32)
    from dgraph_tpu.train.loop import masked_bce_multilabel

    want = masked_bce_multilabel(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask), None)
    got = loop.masked_bce_multilabel(torch.from_numpy(logits), torch.from_numpy(labels),
                                     torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_params_to_jax_inverts_params_from_jax(graphs):
    _, ref = graphs
    params = JaxGCN(HIDDEN, C, comm=JAX_COMM).init(
        jax.random.key(3), jnp.asarray(ref.features[0]),
        jax.tree.map(lambda a: jnp.asarray(a[0]), ref.plan))
    back = params_to_jax(params_from_jax(params))
    _assert_trees_close(back, jax.tree.map(np.asarray, params), 0.0)


def test_validate_plan_checks_masked_owner_ids(graphs):
    """The sorted owner-side take reads the plan's ids as they are: a
    masked edge with an in-range owner id is refused."""
    ours, _ = graphs
    plan = ours.plan
    validate_plan(plan)
    masked = int(torch.nonzero(plan.edge_mask[0] == 0)[0, 0])
    dst = plan.dst_index.clone()
    dst[0, masked] = plan.n_dst_pad - 1
    import dataclasses

    bad = dataclasses.replace(plan, dst_index=dst)
    with pytest.raises(ValueError, match="masked edges"):
        validate_plan(bad)


def test_train_cli_on_cpu(tmp_path):
    """python -m dgraph_tpu_torch.train --device cpu: one step record per
    step, the test accuracy and the mean step time."""
    out = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.train", "--device", "cpu", "--epochs", "3",
         "--data.num_nodes", "300", "--hidden", "32", "--log_path", str(tmp_path / "log.jsonl")],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    steps = [r for r in recs if r.get("kind") == "step"]
    assert [r["step"] for r in steps] == [0, 1, 2]
    assert "val_acc" in steps[0] and "val_acc" in steps[-1]
    assert "test_acc" in recs[-2] and recs[-1]["avg_epoch_ms_excl_first"] > 0
    assert (tmp_path / "log.jsonl").read_text().count("\n") == len(recs)


@pytest.mark.parametrize("model", ["gat", "gt"])
def test_train_cli_trains_gat_and_gt_on_cpu(model):
    """python -m dgraph_tpu_torch.train --model gat|gt --device cpu: two
    epochs on a tiny graph, finite losses, the GT batches carrying vmask."""
    from dgraph_tpu_torch.models import GAT, GraphTransformer
    from dgraph_tpu_torch.train.__main__ import main, parse_config

    cfg = parse_config(["--model", model, "--device", "cpu", "--epochs", "2",
                        "--data.num_nodes", "200", "--hidden", "32", "--log_path", ""])
    out = main(cfg)
    t = out["training"]
    assert isinstance(t.model, GAT if model == "gat" else GraphTransformer)
    assert torch.equal(t.batches["train"]["vmask"], t.graph.vertex_mask)
    assert [r["step"] for r in out["records"]] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["val_loss"]) for r in out["records"])


def test_train_cli_refuses_unported_models():
    """The graph transformer trains on one rank: above one, main and
    build_training raise before any work, naming the slice that brings it.
    GAT trains over ranks."""
    from dgraph_tpu_torch.train.__main__ import (
        Config, build_training, check_model, main, parse_config,
    )

    cfg = parse_config(["--model", "gat", "--device", "cpu", "--data.num_nodes", "50"])
    assert cfg.data.num_nodes == 50 and cfg.device == "cpu"
    check_model("gat", 4)
    for model in ("gt", "graph_transformer"):
        with pytest.raises(NotImplementedError, match="slice"):
            main(Config(model=model, world_size=2, device="cpu"))
    with pytest.raises(ValueError, match="main\\(\\) launches the ranks"):
        build_training(Config(world_size=2, device="cpu"))
    with pytest.raises(SystemExit, match="unknown model"):
        build_training(Config(model="rgat", device="cpu"))


def test_world_size_zero_means_every_visible_card(monkeypatch):
    """``--world_size 0`` is every visible card, as the reference's 0 is
    every device (experiments/ogb_gcn.py:137), and one rank with
    ``--device cpu``: with four cards reported, main launches four ranks
    (the launch is recorded, nothing is spawned)."""
    from dgraph_tpu_torch import config as tcfg
    from dgraph_tpu_torch.comm import dist
    from dgraph_tpu_torch.train import __main__ as tmain

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmain.resolve_world_size(0) == 4
    assert tmain.resolve_world_size(0, "cpu") == 1
    assert tmain.resolve_world_size(2) == 2
    assert tmain.Config().world_size == 1  # the default is unchanged

    launched = []

    def fake_launch(fn, world, *args, **kwargs):
        launched.append(world)
        return [{"records": []} for _ in range(world)]

    monkeypatch.setattr(dist, "launch", fake_launch)
    monkeypatch.setattr(tcfg, "default_device", lambda *a, **k: torch.device("cpu"))
    out = tmain.main(tmain.Config(world_size=0, epochs=1))
    assert launched == [4] and len(out["ranks"]) == 4
