"""Rank functions of the multi-rank CPU tests (``test_torch_dist.py``,
``test_torch_partition.py``).

Each runs in a process that ``dgraph_tpu_torch.comm.dist.launch`` spawns, so
this module imports torch and the port only, never JAX: the test process
computes the JAX side and hands the inputs over as numpy arrays in a pickle.
Every function returns numpy arrays.
"""

from __future__ import annotations

import itertools
import pickle

import numpy as np
import torch

from dgraph_tpu_torch import config
from dgraph_tpu_torch.comm import DistComm
from dgraph_tpu_torch.comm import collectives as coll
from dgraph_tpu_torch.data import DistributedGraph
from dgraph_tpu_torch.models import GAT, GCN, GraphSAGE
from dgraph_tpu_torch.models.gcn import GraphConvLayer
from dgraph_tpu_torch.models.message_passing import MessagePassing
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.plan import build_edge_plan
from dgraph_tpu_torch.train import loop

IMPLS = ("all_to_all", "pallas_p2p", "ppermute", "overlap", "sched")
# the lossy wire formats every lowering runs under (the identity 'fp32' too,
# against the run without a format)
WIRE_FORMATS = ("bf16", "fp8")
# the lowerings MessagePassing runs under (pinned; the plan carries the split)
MP_IMPLS = ("all_to_all", "ppermute", "overlap")


def _halo_case(group, case: dict) -> dict:
    """Every lowering's halo buffer, halo_scatter_sum and both VJPs on this
    rank, for one graph ('sched' on the halo-side inputs of its own,
    ``h_sched``/``ct_halo_sched``), and the plan's schedule id; then the
    same under each wire format (``out[(fmt, impl)]``): 'fp32' with the
    codec's calls counted (``fp32_codec_calls``), then WIRE_FORMATS
    (``codec_calls`` after them)."""
    from dgraph_tpu_torch.wire import codec

    r = group.rank
    plan, _ = build_edge_plan(case["edges"], case["part"], world_size=group.world_size,
                              overlap=True)
    plan = plan.shard(r)
    n_pad, sched = plan.n_src_pad, plan.halo_schedule
    out = {"deltas": np.asarray(plan.halo_deltas), "schedule_id": sched.schedule_id}

    def legs(impl, fmt=None):
        own = "_sched" if impl == "sched" else ""
        x = torch.from_numpy(case["xs"][r]).requires_grad_()
        buf = coll.halo_exchange(x, plan.halo, group, plan.halo_deltas, impl, sched, fmt)
        (buf * torch.from_numpy(case["ct_halo" + own][r])).sum().backward()
        h = torch.from_numpy(case["h" + own][r]).requires_grad_()
        back = coll.halo_scatter_sum(h, plan.halo, n_pad, group, plan.halo_deltas, impl, sched,
                                     fmt)
        (back * torch.from_numpy(case["ct_owner"][r])).sum().backward()
        return [a.detach().numpy() for a in (buf, x.grad, back, h.grad)]

    for impl in IMPLS:
        out[impl] = legs(impl)
    codec.reset_calls()
    for impl in IMPLS:
        out[("fp32", impl)] = legs(impl, "fp32")
    out["fp32_codec_calls"] = dict(codec.CALLS)
    for fmt in WIRE_FORMATS:
        for impl in IMPLS:
            out[(fmt, impl)] = legs(impl, fmt)
    out["codec_calls"] = dict(codec.CALLS)
    # the overlap pair with its rounds left in flight, a view taken before
    # the wait
    x, h = torch.from_numpy(case["xs"][r]), torch.from_numpy(case["h"][r])
    pend = coll.halo_exchange_overlap(x, plan.halo, group, plan.halo_deltas)[:, :5]
    buf = pend.wait()
    back = coll.halo_scatter_sum_overlap(h, plan.halo, n_pad, group, plan.halo_deltas).wait()
    out["overlap_pending"] = [buf.numpy(), back.numpy()]
    return out


def mp_layer(full: torch.Tensor, plan) -> torch.Tensor:
    """The MessagePassing cases' layer: each edge's halo-side row of
    ``[local ; halo]`` summed into its dst vertex (masked edges add 0)."""
    idx = plan.src_index.long().clamp(max=full.shape[0] - 1)
    m = full.index_select(0, idx) * plan.edge_mask[:, None]
    return local_ops.segment_sum(m, plan.dst_index, plan.n_dst_pad)


def _message_passing(group, case: dict) -> dict:
    """MessagePassing with :func:`mp_layer` on this rank under each of
    MP_IMPLS (the lowering it resolved beside its output), then under each
    with the fp8 wire pin (``("fp8", impl)``: the lowering and the wire
    format resolved, the output)."""
    r, W = group.rank, group.world_size
    plan = build_edge_plan(case["edges"], case["part"], world_size=W, overlap=True)[0].shard(r)
    x = torch.from_numpy(case["x"][r])
    mp = MessagePassing(mp_layer, DistComm(group))
    out = {}
    try:
        for impl in MP_IMPLS:
            config.halo_impl = impl
            out[impl] = (coll.resolve_plan_impl(plan, group), mp(x, plan).numpy())
        config.wire_format = "fp8"
        for impl in MP_IMPLS:
            config.halo_impl = impl
            out[("fp8", impl)] = (coll.resolve_plan_impl(plan, group),
                                  coll.resolve_plan_wire_format(plan, group), mp(x, plan).numpy())
    finally:
        config.halo_impl, config.wire_format = "auto", "auto"
    return out


def _message_passing_sched(group, case: dict) -> tuple:
    """MessagePassing under the 'sched' pin on this rank: the plan carries a
    schedule, so the lowering resolves 'sched', and the communicator's
    ``halo_exchange`` (which takes no schedule, as the reference's) raises.
    Returns the lowering resolved and the error."""
    r, W = group.rank, group.world_size
    plan = build_edge_plan(case["edges"], case["part"], world_size=W)[0].shard(r)
    mp = MessagePassing(mp_layer, DistComm(group))
    config.halo_impl = "sched"
    try:
        mp(torch.from_numpy(case["x"][r]), plan)
        return coll.resolve_plan_impl(plan, group), None
    except ValueError as e:
        return coll.resolve_plan_impl(plan, group), str(e)
    finally:
        config.halo_impl = "auto"


def _facade(group, case: dict) -> dict:
    """The communicator's ``put`` of this rank's ``[W, S, F]`` stack and its
    ``gather_concat`` of (x, x) on this rank."""
    r, W = group.rank, group.world_size
    plan = build_edge_plan(case["edges"], case["part"], world_size=W)[0].shard(r)
    comm, x = DistComm(group), torch.from_numpy(case["x"][r])
    return {"put": comm.put(torch.from_numpy(case["put"][r])).numpy(),
            "gather_concat": comm.gather_concat(x, x, plan).numpy()}


def _model_rank(group, g: dict) -> dict:
    """Step 0 of GAT, GCN or GraphSAGE (``g["model"]``) on this rank under the
    lowering ``g["impl"]`` pinned (the graph built under the pin, so
    'overlap' and 'pallas_p2p' attach the split; 'pallas_p2p' runs kernel
    5's plain version) and the wire format ``g["wire"]`` pinned (default
    'auto'): the lowering and the wire format resolved, whether the split
    route ran, the logits, the global loss and the summed gradients."""
    r, W = group.rank, group.world_size
    config.halo_impl, config.wire_format = g["impl"], g.get("wire", "auto")
    config.use_pallas_p2p = True if g["impl"] == "pallas_p2p" else None
    try:
        comm = DistComm(group)
        graph = DistributedGraph.from_global(
            g["edges"], g["features"], g["labels"], g["masks"], W, partition_method="random",
            add_symmetric_norm=g["model"] == "gcn")
        F = g["features"].shape[1]
        if g["model"] == "gat":
            model = GAT(F, g["hidden"], g["classes"], comm, num_layers=2, num_heads=g["heads"])
        elif g["model"] == "gcn":
            model = GCN(F, g["hidden"], g["classes"], comm)
        else:
            model = GraphSAGE(F, g["hidden"], g["classes"], comm)
        model.load_state_dict({k: torch.from_numpy(v) for k, v in g["params"].items()})
        plan = graph.plan.shard(r)
        b = graph.rank_batch("train", r)
        logits = loop.model_apply(model, b, plan)
        count = coll.all_reduce_sum(b["mask"].sum(), group)
        loss = loop.masked_cross_entropy(logits, b["y"], b["mask"], count=count)
        loss.backward()
        comm.grad_sync(list(model.parameters()))
        return {"impl": coll.resolve_plan_impl(plan, group), "split": comm.split_active(plan),
                "wire": coll.resolve_plan_wire_format(plan, group),
                "logits": logits.detach().numpy(),
                "loss": float(coll.all_reduce_sum(loss.detach(), group)),
                "grads": {k: p.grad.numpy().copy() for k, p in model.named_parameters()}}
    finally:
        config.halo_impl, config.wire_format, config.use_pallas_p2p = "auto", "auto", None


def _split_ops(group, case: dict) -> dict:
    """The split ops against the unsplit ones on this rank (port against
    port): the split neighbour sum (``gather_scatter_overlap``) against
    ``scatter_sum(gather(x) * w)``, and a GraphConvLayer on a plan built as
    bipartite (the separable split branch) against the same layer under the
    all_to_all lowering."""
    r, W, part = group.rank, group.world_size, case["part"]
    comm = DistComm(group)
    view = build_edge_plan(case["edges"], part, world_size=W, overlap=True)[0].shard(r)
    bip = build_edge_plan(case["edges"], part, part, world_size=W, overlap=True)[0].shard(r)
    x = torch.from_numpy(case["x"][r])
    w = torch.linspace(0.5, 1.5, view.e_pad)
    torch.manual_seed(0)
    layer = GraphConvLayer(x.shape[1], 8, comm)
    config.halo_impl = "all_to_all"
    buf = coll.halo_exchange(x, view.halo, group, view.halo_deltas, "all_to_all")
    out = {"gso": coll.gather_scatter_overlap(x, buf, view, w),
           "gs": coll.scatter_sum(coll.gather(x, view, "src", group) * w[:, None], view,
                                  "dst", group),
           "layer_unsplit": layer(x, bip, w[:bip.e_pad])}
    config.halo_impl, config.use_pallas_p2p = "pallas_p2p", True
    out["split"] = comm.split_active(bip) and not bip.homogeneous
    out["layer_split"] = layer(x, bip, w[:bip.e_pad])
    config.halo_impl, config.use_pallas_p2p = "auto", None
    return {k: v.detach().numpy() if torch.is_tensor(v) else v for k, v in out.items()}


def _gcn_rank(group, g: dict) -> dict:
    """The GCN on the p2p split route: logits, global loss and summed
    gradients at step 0, then 5 Adam steps."""
    config.halo_impl, config.use_pallas_p2p = "pallas_p2p", True
    comm = DistComm(group)
    graph = DistributedGraph.from_global(
        g["edges"], g["features"], g["labels"], g["masks"], group.world_size,
        partition_method="random", add_symmetric_norm=True, overlap=True)
    model = GCN(g["features"].shape[1], g["hidden"], g["classes"], comm)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in g["params"].items()})
    r = group.rank
    plan = graph.plan.shard(r)
    b = graph.rank_batch("train", r)
    split = comm.split_active(plan)
    logits = loop.model_apply(model, b, plan)
    count = coll.all_reduce_sum(b["mask"].sum(), group)
    loss = loop.masked_cross_entropy(logits, b["y"], b["mask"], count=count)
    loss.backward()
    comm.grad_sync(list(model.parameters()))
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    global_loss = float(coll.all_reduce_sum(loss.detach(), group))

    model.load_state_dict({k: torch.from_numpy(v) for k, v in g["params"].items()})
    step = loop.make_train_step(model, torch.optim.Adam(model.parameters(), lr=g["lr"]),
                                graph.plan, comm=comm)
    batch = dict(graph.batch("train"), y=graph.labels)
    losses = [float(step(batch)["loss"]) for _ in range(5)]
    return {"split": split, "logits": logits.detach().numpy(), "loss": global_loss,
            "grads": grads, "losses": losses,
            "params": {k: v.detach().numpy() for k, v in model.state_dict().items()}}


def run_cases(group, path: str) -> dict:
    """All of one world size's cases (one spawn per world size)."""
    with open(path, "rb") as f:
        inputs = pickle.load(f)
    out = {"halo": [_halo_case(group, c) for c in inputs["halo"]],
           "split_ops": _split_ops(group, inputs["halo"][0]),
           "message_passing": _message_passing(group, inputs["halo"][0]),
           "message_passing_sched": _message_passing_sched(group, inputs["halo"][0]),
           "facade": _facade(group, inputs["halo"][0]),
           "models": [_model_rank(group, g) for g in inputs["models"]]}
    if "gcn" in inputs:
        out["gcn"] = _gcn_rank(group, inputs["gcn"])
    return out


def cli_step0(group, cfg: dict) -> dict:
    """Step 0 of the training CLI's model and graph at ``cfg`` (a Config as
    a dict) on this rank: the global loss, the summed gradients and the
    rank's partition, which every rank builds on its own."""
    from dgraph_tpu_torch.train import __main__ as cli

    c = cli.Config(**dict(cfg, data=cli.DataConfig(**cfg["data"])))
    t = cli.build_training(c, comm=DistComm(group))
    loss = float(t.train_step(t.batches["train"])["loss"])
    return {"loss": loss, "partition": np.asarray(t.graph.ren.partition),
            "perm": np.asarray(t.graph.ren.perm),
            "grads": {k: p.grad.numpy().copy() for k, p in t.model.named_parameters()}}


def fail_on_rank1(group):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    if group.rank == 1:
        raise ValueError("rank 1 gives up")
    group.barrier()


def halo_impl_seen(group):
    """The launcher's ``DGRAPH_TPU_HALO_IMPL`` as this rank sees it: the
    variable and the ``config`` flag read from it."""
    import os

    return os.environ.get("DGRAPH_TPU_HALO_IMPL"), config.halo_impl


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of an f32 or bf16 tensor (``torch.equal`` holds
    ``-0.0 == 0.0`` and ``NaN != NaN``; these compare as stored)."""
    return t.view(torch.int32 if t.element_size() == 4 else torch.int16)


def p2p_parity(group) -> list:
    """Kernel 5 on this rank's card against its plain version (bit for bit,
    two launches equal): both types, both directions, with and without a
    mask, F in {1, 33, 256}, aligned and one element off; and uint8 tiles
    with no mask, rows of 37 and 260 bytes. The tiles hold
    negative values, NaN and -inf, so a masked row comes out as ``x * 0``
    (-0.0, NaN) as in the ``all_to_all`` lowering, where a select would
    give +0.0. Returns the cases that failed."""
    from dgraph_tpu_torch.ops import p2p

    W, dev = group.world_size, group.device
    deltas = (1,) if W == 2 else (1, 3)
    gen = torch.Generator(device=dev).manual_seed(group.rank)
    bad = []
    for F, dtype, sign, masked, off in itertools.product(
            (1, 33, 256), (torch.float32, torch.bfloat16), (1, -1), (True, False), (0, 1)):
        n, S = len(deltas), 200
        raw = torch.randn(n * S * F + off, generator=gen, device=dev)
        raw[::7], raw[3::11] = float("nan"), float("-inf")
        raw = raw.to(dtype)
        blocks = raw[off:].view(n, S, F)
        mask = (torch.rand(n, S, generator=gen, device=dev) > 0.3).float() if masked else None
        kw = dict(sign=sign, mask=mask, group=group)
        got = p2p.p2p_transport(blocks, deltas, W, S, **kw)
        want = p2p.p2p_transport_plain(blocks, deltas, W, S, **kw)
        again = p2p.p2p_transport(blocks, deltas, W, S, **kw)
        if not (torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))):
            bad.append((F, str(dtype), sign, masked, off))
    # uint8 byte tiles (the wire codecs' payloads), no mask: rows of 260
    # bytes (a tile's run 16-byte aligned) and 37, aligned and one byte off
    for F, sign, off in itertools.product((37, 260), (1, -1), (0, 1)):
        n, S = len(deltas), 200
        raw = torch.randint(0, 256, (n * S * F + off,), generator=gen, device=dev,
                            dtype=torch.uint8)
        blocks = raw[off:].view(n, S, F)
        kw = dict(sign=sign, group=group)
        got = p2p.p2p_transport(blocks, deltas, W, S, **kw)
        want = p2p.p2p_transport_plain(blocks, deltas, W, S, **kw)
        if not (got.dtype == torch.uint8 and torch.equal(got, want)
                and torch.equal(got, p2p.p2p_transport(blocks, deltas, W, S, **kw))):
            bad.append((F, "torch.uint8", sign, False, off))
    return bad


def p2p_mutant_parity(group) -> list:
    """Kernel 6 on this rank's card: ``None`` bit-equal to kernel 5 and to
    kernel 5's plain version, each mutation bit-equal to its plain version
    (two launches equal), both types, both directions, with and without a
    mask, F in {1, 33, 256}, aligned and one element off, tiles holding
    NaN, -inf and negative values. Returns the cases that failed."""
    from dgraph_tpu_torch.analysis.kernel import disjoint_deltas
    from dgraph_tpu_torch.ops import p2p

    W, dev = group.world_size, group.device
    gen = torch.Generator(device=dev).manual_seed(50 + group.rank)
    bad = []
    for mutation, F, dtype, sign, masked, off in itertools.product(
            p2p.MUTATIONS, (1, 33, 256), (torch.float32, torch.bfloat16), (1, -1),
            (True, False), (0, 1)):
        # where two senders write one row the card's outcome is a race
        deltas = disjoint_deltas(W, mutation)
        n, S = len(deltas), 200
        raw = torch.randn(n * S * F + off, generator=gen, device=dev)
        raw[::7], raw[3::11] = float("nan"), float("-inf")
        raw = raw.to(dtype)
        blocks = raw[off:].view(n, S, F)
        mask = (torch.rand(n, S, generator=gen, device=dev) > 0.3).float() if masked else None
        kw = dict(sign=sign, mask=mask, group=group)
        got = p2p.p2p_transport_mutant(blocks, deltas, W, S, mutation=mutation, **kw)
        want = p2p.p2p_transport_mutant_plain(blocks, deltas, W, S, mutation=mutation, **kw)
        again = p2p.p2p_transport_mutant(blocks, deltas, W, S, mutation=mutation, **kw)
        same = torch.equal(bits(got), bits(want)) and torch.equal(bits(got), bits(again))
        if mutation is None:
            k5 = p2p.p2p_transport(blocks, deltas, W, S, **kw)
            same = same and torch.equal(bits(got), bits(k5))
        if not same:
            bad.append((mutation, F, str(dtype), sign, masked, off))
    return bad


def analysis_case(group, w, labels: tuple, cases: tuple) -> dict:
    """One rank of ``test_torch_analysis_kernel.py``: the verifier's rank
    (the audit programs under the recorder, the landing check on the plain
    versions), then kernel 6's plain versions: ``None`` against kernel 5's
    plain version bit for bit (tiles with NaN, -inf and negative values,
    masked and not), and the record of each seeded fault's call."""
    from dgraph_tpu_torch.analysis import kernel
    from dgraph_tpu_torch.ops import p2p

    out = kernel._verifier_rank(group, w, labels, cases)
    W, S, F = group.world_size, 6, 5
    gen = torch.Generator().manual_seed(70 + group.rank)
    same, records = [], []
    for mutation in p2p.MUTATIONS:
        deltas = kernel.disjoint_deltas(W, mutation)
        raw = torch.randn(len(deltas) * S * F, generator=gen)
        raw[::7], raw[3::11] = float("nan"), float("-inf")
        blocks = raw.view(len(deltas), S, F)
        for sign, masked in itertools.product((1, -1), (True, False)):
            mask = (torch.rand(len(deltas), S, generator=gen) > 0.3).float() if masked else None
            kw = dict(sign=sign, mask=mask, group=group)
            with p2p.record_transports() as log:
                got = p2p.p2p_transport_mutant(blocks, deltas, W, S, mutation=mutation, **kw)
            if mutation is None:
                want = p2p.p2p_transport_plain(blocks, deltas, W, S, **kw)
                same.append(torch.equal(bits(got), bits(want)))
            records.extend(log)
    out.update(plain_none_equal=same, mutant_records=records)
    return out


def resolved_lowering(epoch, t) -> tuple:
    """``on_step`` of the training CLI's runs in the tests: the lowering this
    rank resolved and whether it took the split route."""
    return coll.resolve_plan_impl(t.plan, t.comm.group), t.comm.split_active(t.plan)


def graphcast_step0(group, case: dict) -> dict:
    """GraphCast's forward and step-0 gradients on this rank under each of
    IMPLS pinned (the graphs built under the pin, so 'overlap' and
    'pallas_p2p' attach the split; 'pallas_p2p' runs kernel 5's plain
    version): {impl: (the lowering each plan resolved, this rank's output
    shard, the global loss, the summed gradients, the calls of kernel 5's
    wrapper)}. ``case``: the graphs' arguments, the model's widths, its
    state_dict and the input and target of every rank (``[W, n_grid_pad,
    C]``)."""
    from dgraph_tpu_torch.models.graphcast import GraphCast, build_graphcast_graphs
    from dgraph_tpu_torch.models.graphcast.graph import rank_inputs
    from dgraph_tpu_torch.ops import p2p
    from dgraph_tpu_torch.train.graphcast import masked_mse

    r, W = group.rank, group.world_size
    comm = DistComm(group)
    out, calls, transport = {}, [], p2p.p2p_transport

    def counted(*args, **kw):
        calls.append(1)
        return transport(*args, **kw)

    p2p.p2p_transport = counted
    try:
        for impl in IMPLS:
            calls.clear()
            config.halo_impl = impl
            config.use_pallas_p2p = True if impl == "pallas_p2p" else None
            graphs = build_graphcast_graphs(*case["graph"], W)
            statics, plans, mask = rank_inputs(graphs, r, "cpu")
            model = GraphCast(comm=comm, **case["model"])
            model.load_state_dict({k: torch.from_numpy(v) for k, v in case["params"].items()})
            pred = model(torch.from_numpy(case["x"][r]), statics, plans)
            count = coll.all_reduce_sum(mask.sum(), group)
            loss = masked_mse(pred, torch.from_numpy(case["y"][r]), mask, count)
            loss.backward()
            comm.grad_sync(list(model.parameters()))
            out[impl] = ({k: coll.resolve_plan_impl(p, group) for k, p in plans.items()},
                         pred.detach().numpy(), float(coll.all_reduce_sum(loss.detach(), group)),
                         {k: p.grad.numpy().copy() for k, p in model.named_parameters()},
                         len(calls))
    finally:
        config.halo_impl, config.use_pallas_p2p = "auto", None
        p2p.p2p_transport = transport
    return out
