"""The CUDA kernels against their plain versions, on the card, and the
autograd Functions' backward kernels against the same Functions on the CPU.

Every test here needs a CUDA device and skips without one (the kernels have
no interpret mode). On a GPU host, where JAX need not be installed, run
them without the suite's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are small multiples of 1/4 (weights of 1/4), which bf16 holds
exactly and whose sums f32 holds exactly: the hub's 2000-term sums then
have no rounding error in either order (the plain version sums with
atomics, in an order that changes from run to run), so the stated
tolerances (f32 rtol=atol=1e-5; bf16, compared in f32, rtol=atol=2e-2)
bound only real disagreement.
"""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch.ops import kernels
from dgraph_tpu_torch.ops import segment as seg

pytestmark = pytest.mark.cuda

N = 3000
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ids(dev, seed=0):
    rng = np.random.default_rng(seed)
    real = rng.choice(np.arange(0, N, 2), 12000)  # odd segments empty
    hub = np.full(2000, 8)
    pad = np.full(300, N)  # padded owner ids, dropped
    ids = np.concatenate([np.sort(np.concatenate([real, hub])), pad]).astype(np.int32)
    return torch.from_numpy(ids).to(dev)


def _quarters(*shape, dev, lo=-8, hi=9):
    return torch.randint(lo, hi, shape, device=dev).float() / 4


def _close(got, want):
    tol = TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


# kernel 2 sums contiguous rows of F <= 64 (f32) / 16 (bf16) on its narrow
# path, wider or strided rows on the warp-per-row path
@pytest.mark.parametrize("F", [1, 2, 4, 8, 16, 33, 128, 256])
@pytest.mark.parametrize("input_op", ["none", "relu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segment_sum_kernel(dev, dtype, input_op, F):
    ids = _ids(dev)
    data = _quarters(ids.shape[0], F, dev=dev).to(dtype)
    before = seg.sorted_segment_sum.launches
    got = seg.sorted_segment_sum(data, ids, N, input_op=input_op)
    torch.cuda.synchronize()
    assert seg.sorted_segment_sum.launches == before + 1
    _close(got, seg.sorted_segment_sum_plain(data, ids, N, input_op=input_op))


@pytest.mark.parametrize("F", [1, 33, 128, 256])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segment_sum_bias_relu_kernel(dev, dtype, weighted, F):
    ids = _ids(dev, seed=1)
    E = ids.shape[0]
    data = _quarters(E, F, dev=dev).to(dtype)
    bias = _quarters(N, F, dev=dev).to(dtype)
    w = _quarters(E, dev=dev, lo=0, hi=5) if weighted else None
    before = seg.sorted_segment_sum_bias_relu.launches
    got = seg.sorted_segment_sum_bias_relu(data, ids, bias, N, edge_weight=w)
    torch.cuda.synchronize()
    assert seg.sorted_segment_sum_bias_relu.launches == before + 1
    _close(got, seg.sorted_segment_sum_bias_relu_plain(data, ids, bias, N, edge_weight=w))


@pytest.mark.parametrize("offset", [0, 1])
def test_strided_column_slices(dev, offset):
    """Column slices of wider tensors (the GCN's per-chunk bias), aligned
    (vector loads) and shifted by one column (scalar path)."""
    ids = _ids(dev, seed=2)
    wide = _quarters(ids.shape[0], 300, dev=dev)
    bias_wide = _quarters(N, 300, dev=dev)
    d, b = wide[:, offset:offset + 128], bias_wide[:, 128 + offset:256 + offset]
    _close(seg.sorted_segment_sum_bias_relu(d, ids, b, N),
           seg.sorted_segment_sum_bias_relu_plain(d, ids, b, N))
    _close(seg.sorted_segment_sum(d, ids, N), seg.sorted_segment_sum_plain(d, ids, N))


@pytest.mark.parametrize("F", [1, 4, 16, 128])
@pytest.mark.parametrize("layout", ["contiguous", "unaligned", "column_slice"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segment_sum_hub(dev, dtype, layout, F):
    """One row of 12,000 edges between short rows: the narrow path sums it
    across several shared-memory chunks with the whole warp, staged with
    vector loads (contiguous) or scalar ones (contiguous rows that start
    off a 16-byte boundary); a column slice takes the warp-per-row path.
    Exact values (multiples of 1/4), so plain and kernel agree in any
    order."""
    rng = np.random.default_rng(5)
    short = np.sort(rng.integers(0, N, 6000))
    ids = np.sort(np.concatenate([short, np.full(12000, 1234), np.full(40, N)]))
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    E = ids.shape[0]
    wide = _quarters(E, F + 3, dev=dev).to(dtype)
    data = {"contiguous": wide[:, :F].contiguous(),
            "unaligned": wide.flatten()[1:1 + E * F].view(E, F),
            "column_slice": wide[:, 1:F + 1]}[layout]
    got = seg.sorted_segment_sum(data, ids, N)
    _close(got, seg.sorted_segment_sum_plain(data, ids, N))
    assert torch.equal(got, seg.sorted_segment_sum(data, ids, N))
    assert float(got[1234].float().abs().sum()) > 0


@pytest.mark.parametrize("input_op", ["none", "relu"])
@pytest.mark.parametrize("dtype,F", [(torch.float32, f) for f in (1, 2, 4, 8, 16, 32, 64)]
                         + [(torch.bfloat16, f) for f in (1, 2, 4, 8, 16)])
def test_narrow_sum_launches_give_equal_bits(dev, dtype, F, input_op):
    """Random values, whose sums round (so the values are held to plain by
    the tests above, on exact inputs): the narrow path's order of summation
    is fixed by the offsets alone, so two launches give the same bits."""
    ids = _ids(dev, seed=6)
    data = torch.randn(ids.shape[0], F, device=dev).to(dtype)
    a = seg.sorted_segment_sum(data, ids, N, input_op=input_op)
    b = seg.sorted_segment_sum(data, ids, N, input_op=input_op)
    assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       b.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


def test_kernels_are_deterministic(dev):
    ids = _ids(dev, seed=3)
    data = torch.randn(ids.shape[0], 128, device=dev)
    bias = torch.randn(N, 128, device=dev)
    a = seg.sorted_segment_sum_bias_relu(data, ids, bias, N)
    b = seg.sorted_segment_sum_bias_relu(data, ids, bias, N)
    assert torch.equal(a, b)
    assert torch.equal(seg.sorted_segment_sum(data, ids, N),
                       seg.sorted_segment_sum(data, ids, N))


def test_all_ids_out_of_range_gives_zeros(dev):
    ids = torch.full((500,), N, dtype=torch.int32, device=dev)
    data = torch.randn(500, 16, device=dev)
    assert torch.equal(seg.sorted_segment_sum(data, ids, N),
                       torch.zeros(N, 16, device=dev))


# --- the hub route: rows of more than HUB_DEGREE edges, summed in chunks ---

HUB_N = 3000
HUB_FORMS = ("sum", "sum relu", "bias_relu w", "bias_relu unw", "act w", "act unw")


def _hub_form(form, data, ids, bias, w, n):
    """(kernel call, plain call, wrapper) of one form of kernels 1, 1a, 2."""
    kernel, _, tag = form.partition(" ")
    if kernel == "sum":
        op = "relu" if tag == "relu" else "none"
        return (lambda: seg.sorted_segment_sum(data, ids, n, input_op=op),
                lambda: seg.sorted_segment_sum_plain(data, ids, n, input_op=op),
                seg.sorted_segment_sum)
    ew = w if tag == "w" else None
    wrapper = seg.sorted_segment_sum_act if kernel == "act" else seg.sorted_segment_sum_bias_relu
    plain = (seg.sorted_segment_sum_act_plain if kernel == "act"
             else seg.sorted_segment_sum_bias_relu_plain)
    return (lambda: wrapper(data, ids, bias, n, edge_weight=ew),
            lambda: plain(data, ids, bias, n, edge_weight=ew), wrapper)


@pytest.mark.parametrize("F", [1, 4, 16, 33, 128])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "unaligned"])
@pytest.mark.parametrize("form", HUB_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_route_edge_cases_match_plain(dev, dtype, form, layout, F):
    """Hubs of HUB_DEGREE + 1 edges beside a row of exactly HUB_DEGREE, of a
    multiple of HUB_CHUNK and one more, as the first row and as the last
    real row before padded ids, three in one narrow block
    (``kernel_ab.hub_edge_case_ids``), as contiguous rows, strided column
    slices and unaligned rows: every call takes the hub route, launches
    once, matches plain on exact values and repeats its bits."""
    from dgraph_tpu_torch.ops.kernel_ab import hub_edge_case_ids

    ids = torch.from_numpy(hub_edge_case_ids(HUB_N, seg.HUB_DEGREE, seg.HUB_CHUNK)).to(dev)
    E = ids.shape[0]
    wide = _quarters(E, F + 5, dev=dev).to(dtype)
    table = _quarters(HUB_N, 2 * F + 1, dev=dev).to(dtype)
    data, bias = {"contiguous": (wide[:, :F].contiguous(), table[:, :F].contiguous()),
                  "strided": (wide[:, :F], table[:, F:2 * F]),
                  "unaligned": (wide[:, 1:F + 1], table[:, 1:F + 1])}[layout]
    run, plain, wrapper = _hub_form(form, data, ids, bias, _quarters(E, dev=dev, lo=0, hi=5),
                                    HUB_N)
    launches, hubs = wrapper.launches, wrapper.hub_calls
    got, again = run(), run()
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.hub_calls) == (launches + 2, hubs + 2)
    _close(got, plain())
    assert torch.equal(got, again)


@pytest.mark.parametrize("F", [1, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_route_runs_on_skewed_ids_and_not_on_the_sbm_plan(dev, dtype, F):
    """Power-law ids (a row of about 46,000 edges at the arxiv shape, here
    a tenth of it) take the hub route in every form; the SBM graph's plan
    (largest degree about 30) never does."""
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.ops.kernel_ab import power_law_ids

    n, e = 16_934, 233_267
    ids = torch.from_numpy(power_law_ids(n, e, e + 100)).to(dev)
    sbm = synthetic.sbm_classification_graph(num_nodes=2000, num_classes=5, feat_dim=8, seed=2)
    g = DistributedGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                     sbm["masks"], world_size=1, partition_method="random")
    plan = g.plan.shard(0).to(dev)
    for case_ids, rows, hub in ((ids, n, True), (plan.dst_index, plan.n_dst_pad, False)):
        E = case_ids.shape[0]
        data = _quarters(E, F, dev=dev).to(dtype)
        bias = _quarters(rows, F, dev=dev).to(dtype)
        for form in HUB_FORMS:
            run, plain, wrapper = _hub_form(form, data, case_ids, bias,
                                            _quarters(E, dev=dev, lo=0, hi=5), rows)
            before = wrapper.hub_calls
            _close(run(), plain())
            assert wrapper.hub_calls == before + hub, (form, hub)


@pytest.mark.parametrize("F", [1, 33, 128, 256])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_segment_sum_act_kernel(dev, dtype, weighted, F):
    ids = _ids(dev, seed=4)
    E = ids.shape[0]
    data = _quarters(E, F, dev=dev).to(dtype)
    bias = _quarters(N, F, dev=dev).to(dtype)
    w = _quarters(E, dev=dev, lo=0, hi=5) if weighted else None
    before = seg.sorted_segment_sum_act.launches
    got = seg.sorted_segment_sum_act(data, ids, bias, N, edge_weight=w)
    torch.cuda.synchronize()
    assert seg.sorted_segment_sum_act.launches == before + 1
    assert got.dtype == torch.float32
    want = seg.sorted_segment_sum_act_plain(data, ids, bias, N, edge_weight=w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("F", [1, 33, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_bwd_gd_kernel(dev, dtype, F):
    ids = _ids(dev, seed=5)
    E = ids.shape[0]
    data = _quarters(E, F, dev=dev).to(dtype)
    g = _quarters(N, F, dev=dev).to(dtype)
    bias = _quarters(N, F, dev=dev).to(dtype)
    before = seg.fused_bwd_gd.launches
    got = seg.fused_bwd_gd(data, g, bias, ids)
    torch.cuda.synchronize()
    assert seg.fused_bwd_gd.launches == before + 1
    assert torch.equal(got, seg.fused_bwd_gd_plain(data, g, bias, ids))


@pytest.mark.parametrize("F", [1, 33, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sorted_row_gather_kernel(dev, dtype, F):
    ids = _ids(dev, seed=6)
    x = torch.randn(N, F, device=dev).to(dtype)
    before = seg.sorted_row_gather.launches
    got = seg.sorted_row_gather(x, ids)
    torch.cuda.synchronize()
    assert seg.sorted_row_gather.launches == before + 1
    assert torch.equal(got, seg.sorted_row_gather_plain(x, ids))


@pytest.mark.parametrize("offset", [0, 1])
def test_gathers_take_strided_column_slices(dev, offset):
    ids = _ids(dev, seed=7)
    wide = torch.randn(ids.shape[0], 300, device=dev)
    table = torch.randn(N, 300, device=dev)
    d, g, b = wide[:, offset:offset + 128], table[:, offset:offset + 128], table[:, 128:256]
    assert torch.equal(seg.sorted_row_gather(g, ids), seg.sorted_row_gather_plain(g, ids))
    assert torch.equal(seg.fused_bwd_gd(d, g, b, ids), seg.fused_bwd_gd_plain(d, g, b, ids))


def _grads_on(device, fn, *tensors):
    """fn's output and the gradients of sum(out * cotangent) for copies of
    ``tensors`` on ``device`` (the cotangent, multiples of 1/4 like the
    inputs, is made on the CPU from a seed)."""
    leaves = [t.detach().to(device).requires_grad_() for t in tensors]
    out = fn(*leaves)
    gen = torch.Generator().manual_seed(0)
    cot = (torch.randint(-8, 9, out.shape, generator=gen).float() / 4).to(out.dtype)
    out.backward(cot.to(device))
    return [out.detach().cpu()] + [t.grad.cpu() for t in leaves]


@pytest.mark.parametrize("route", ["pair", "composed", "weighted"])
def test_fused_op_backward_on_the_card_matches_the_cpu(dev, route):
    """Grads flow through every Function on the card (the forward-only
    restriction is gone), and each backward route's kernels give the CPU
    plain path's gradients: f32 rtol=atol=1e-5."""
    ids = _ids(dev, seed=8)
    E = ids.shape[0]
    mv = 0 if route == "composed" else 2
    cpu = torch.device("cpu")
    data, bias = _quarters(E, 128, dev=cpu), _quarters(N, 128, dev=cpu)
    w = _quarters(E, dev=cpu, lo=0, hi=5) if route == "weighted" else None
    seg.reset_launch_counts()

    def fn(d, b, *ww):
        return seg.sorted_segment_sum_bias_relu(d, ids.to(d.device), b, N,
                                                edge_weight=ww[0] if ww else None, gather_mv=mv)

    args = (data, bias) + ((w,) if w is not None else ())
    got = _grads_on(dev, fn, *args)
    want = _grads_on(torch.device("cpu"), fn, *args)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    counts = seg.launch_counts()
    assert counts["sorted_segment_sum_bias_relu"] == 1
    pair = route == "pair"
    assert counts["fused_bwd_gd"] == counts["sorted_segment_sum_act"] == int(pair)
    assert counts["sorted_segment_sum"] == int(not pair)


@pytest.mark.parametrize("gather_flag", [None, True])
def test_gather_and_sum_backward_on_the_card_match_the_cpu(dev, gather_flag):
    from dgraph_tpu_torch import config

    ids = _ids(dev, seed=9)
    x, data = _quarters(N, 64, dev="cpu"), _quarters(ids.shape[0], 64, dev="cpu")
    config.use_pallas_gather = gather_flag
    try:
        seg.reset_launch_counts()
        for fn, arg in ((lambda t: seg.sorted_row_gather(t, ids.to(t.device)), x),
                        (lambda t: seg.sorted_segment_sum(t, ids.to(t.device), N,
                                                          input_op="relu", gather_mv=2), data)):
            for a, b in zip(_grads_on(dev, fn, arg), _grads_on(torch.device("cpu"), fn, arg)):
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        counts = seg.launch_counts()
    finally:
        config.use_pallas_gather = None
    # row gather fwd + the sum's bwd take (flag on); the sum's fwd + the gather's bwd
    assert counts["sorted_row_gather"] == (2 if gather_flag else 1)
    assert counts["sorted_segment_sum"] == 2


def test_rejects_unsupported_dtype(dev):
    ids = _ids(dev)
    with pytest.raises(TypeError):
        seg.sorted_segment_sum(torch.zeros(ids.shape[0], 4, dtype=torch.float64,
                                           device=dev), ids, N)


@pytest.mark.parametrize("gather_flag", [None, True])
@pytest.mark.parametrize("case", ["gcn-weighted", "gcn-unweighted", "sage"])
def test_models_train_on_the_card_like_on_the_cpu(dev, case, gather_flag):
    """One train step of each model on the card: the loss and every
    parameter gradient match the same step on the CPU (f32, rtol=atol=1e-4:
    the card sums in other orders), and the step launches the path's
    kernels."""
    import copy

    from dgraph_tpu_torch import config
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.models import GCN, GraphSAGE
    from dgraph_tpu_torch.train.loop import make_train_step
    from dgraph_tpu_torch.weights import init_params

    sbm = synthetic.sbm_classification_graph(num_nodes=400, num_classes=5, feat_dim=24, seed=2)
    g = DistributedGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                     sbm["masks"], 1, partition_method="random",
                                     add_symmetric_norm=True)
    batch = dict(g.batch("train"), y=g.labels)
    if case != "gcn-weighted":
        del batch["edge_weight"]
    model = GraphSAGE(24, 160, 5, SingleComm()) if case == "sage" else GCN(24, 160, 5, SingleComm())
    init_params(model, seed=1)
    results = {}
    config.use_pallas_gather = gather_flag
    try:
        for device in (torch.device("cpu"), dev):
            m = copy.deepcopy(model).to(device)
            step = make_train_step(m, torch.optim.Adam(m.parameters(), lr=1e-3), g.plan.to(device))
            seg.reset_launch_counts()
            loss = step({k: v.to(device) for k, v in batch.items()})["loss"]
            results[device.type] = (float(loss), {k: p.grad.cpu() for k, p in m.named_parameters()},
                                    seg.launch_counts())
    finally:
        config.use_pallas_gather = None
    (loss_cpu, grads_cpu, _), (loss_gpu, grads_gpu, counts) = results["cpu"], results["cuda"]
    assert abs(loss_cpu - loss_gpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for k, want in grads_cpu.items():
        torch.testing.assert_close(grads_gpu[k], want, rtol=1e-4, atol=1e-4, msg=k)
    if case == "sage":
        assert counts["sorted_segment_sum"] > 0
    else:
        assert counts["sorted_segment_sum_bias_relu"] == 4
        pair = case == "gcn-unweighted"
        assert counts["fused_bwd_gd"] == counts["sorted_segment_sum_act"] == 4 * pair
    assert (counts["sorted_row_gather"] > 0) == (gather_flag is True and case != "gcn-unweighted")


# --- flash attention (ops.attention) -------------------------------------------
#
# Inputs are unit normals; f32 compares at rtol=atol=1e-4 (the kernels and
# the plain version sum up to T products in other orders), bf16 outputs at
# rtol=atol=2e-2 (both compute in f32 and round once to bf16).

ATT_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _attention_counts() -> dict:
    from dgraph_tpu_torch.ops import attention as att, kernels

    return {k: v for k, v in kernels.launch_counts().items() if k in att.KERNELS}


def _att_close(got, want):
    tol = ATT_TOL[want.dtype]
    assert got.dtype == want.dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def _att_inputs(T, H, D, dtype, dev, seed=0):
    """q, k, v and an output cotangent [T, H, D], made on the CPU from a seed."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(T, H, D, generator=gen).to(dev, dtype) for _ in range(4)]


def _att_mask(kind, T, dev):
    """None, a kv_mask with a padded tail of 37, or one with every key masked."""
    if kind == "none":
        return None
    m = torch.ones(T)
    m[T - 37 if kind == "tail" else 0:] = 0
    return m.to(dev)


@pytest.mark.parametrize("mask", ["none", "tail", "all"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [200, 256])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(dev, dtype, D, T, causal, mask):
    """Each of the three kernels against its plain version on the same
    inputs (the backward kernels read the plain forward's lse and di), one
    launch each, and the same bits on a second launch."""
    from dgraph_tpu_torch.ops import attention as att

    q, k, v, do = _att_inputs(T, 2, D, dtype, dev)
    kw = dict(causal=causal, kv_mask=_att_mask(mask, T, dev))
    kernels.reset_launch_counts()
    out, lse = att.flash_attention_fwd(q, k, v, **kw)
    out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
    _att_close(out, out_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    di = att.row_dot(out_p, do)
    dk, dv = att.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, **kw)
    for got, want in zip((dk, dv), att.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, di, **kw)):
        _att_close(got, want)
    dq = att.flash_attention_bwd_dq(q, k, v, do, lse_p, di, **kw)
    _att_close(dq, att.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, di, **kw))
    torch.cuda.synchronize()
    assert _attention_counts() == {"flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
                                   "flash_attention_bwd_dq": 1}
    again = att.flash_attention_fwd(q, k, v, **kw)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert all(torch.equal(a, b) for a, b in
               zip(att.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, **kw), (dk, dv)))
    assert torch.equal(att.flash_attention_bwd_dq(q, k, v, do, lse_p, di, **kw), dq)
    if mask == "all":
        assert not out.any() and not dk.any() and not dv.any() and not dq.any()


@pytest.mark.parametrize("mask", ["none", "tail", "all"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [32, 128])
def test_flash_attention_gradients_match_autograd_of_the_plain_version(dev, D, causal, mask):
    """The autograd Function (forward kernel, di, dK/dV and dQ kernels)
    against autograd through ``dense_attention`` on the card, f32, T = 200."""
    from dgraph_tpu_torch.ops import attention as att

    T = 200
    q, k, v, cot = _att_inputs(T, 2, D, torch.float32, dev, seed=1)
    m = _att_mask(mask, T, dev)
    results = []
    for fn in (att.flash_attention, att.dense_attention):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves, causal=causal, kv_mask=m)
        out.backward(cot)
        results.append([out.detach()] + [t.grad for t in leaves])
    for got, want in zip(*results):
        _att_close(got, want)


@pytest.mark.parametrize("dtype,pad,in_place", [
    (torch.float32, 4, True), (torch.bfloat16, 8, True), (torch.bfloat16, 4, False)])
def test_flash_attention_reads_strided_operands(dev, dtype, pad, in_place):
    """q, k, v as column slices of one [T, 3L + pad] tensor (the LM's
    layout) go to the kernels in place where the row stride meets the
    dtype's rule (f32: whole groups of 4 elements, so 3L + 4 reads in place;
    bf16, TMA's: whole 16-byte groups, so 3L + 8 does and 3L + 4 is
    copied); a slice off by one column is copied first. The three kernels'
    results are the contiguous inputs' bit for bit (in f32 the backward
    kernels' pre-passes read the slices in place)."""
    from dgraph_tpu_torch.ops import attention as att

    T, H, D = 300, 4, 64
    wide = torch.randn(T, 3 * H * D + pad, device=dev).to(dtype)
    do = torch.randn(T, H, D, device=dev).to(dtype)
    for off in (0, 1):
        q, k, v = (t.reshape(T, H, D) for t in
                   wide[:, off:off + 3 * H * D].split(H * D, dim=-1))
        assert (att._operand(q) is q) == (in_place and off == 0)
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        got = att.flash_attention_fwd(q, k, v, causal=True)
        want = att.flash_attention_fwd(qc, kc, vc, causal=True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        di = att.row_dot(want[0], do)
        assert torch.equal(att.flash_attention_bwd_dq(q, k, v, do, want[1], di, causal=True),
                           att.flash_attention_bwd_dq(qc, kc, vc, do, want[1], di, causal=True))
        assert all(torch.equal(a, b) for a, b in zip(
            att.flash_attention_bwd_dkv(q, k, v, do, want[1], di, causal=True),
            att.flash_attention_bwd_dkv(qc, kc, vc, do, want[1], di, causal=True)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 63, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_bf16_tensor_core_route_at_tile_edges(dev, D, T, causal):
    """The bf16 forward, dK/dV and dQ (wgmma on TMA-staged tiles: 128 query
    or key rows a block, 64 a warpgroup, 64-query tiles in dK/dV, 64-key
    tiles in dQ) against their plain versions at T around those tiles and,
    from T = 40 on, with a padded tail of 37; two launches give the same
    bits."""
    from dgraph_tpu_torch.ops import attention as att

    q, k, v, do = _att_inputs(T, 2, D, torch.bfloat16, dev, seed=T)
    for mask in ("none",) if T < 40 else ("none", "tail"):
        kw = dict(causal=causal, kv_mask=_att_mask(mask, T, dev))
        out, lse = att.flash_attention_fwd(q, k, v, **kw)
        out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
        _att_close(out, out_p)
        torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
        di = att.row_dot(out_p, do)
        dk, dv = att.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, **kw)
        for got, want in zip((dk, dv),
                             att.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, di, **kw)):
            _att_close(got, want)
        dq = att.flash_attention_bwd_dq(q, k, v, do, lse_p, di, **kw)
        _att_close(dq, att.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, di, **kw))
        again = att.flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
        assert all(torch.equal(a, b) for a, b in
                   zip(att.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, **kw), (dk, dv)))
        assert torch.equal(att.flash_attention_bwd_dq(q, k, v, do, lse_p, di, **kw), dq)


# the f32 forward's limit at lm_flash (chip_smoke.py F32_FWD_TOL): split TF32
# keeps about 2^-21 of each product
F32_FWD_TOL = 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_f32_forward_split_tf32_at_tile_edges(dev, D, T, causal):
    """The f32 forward (split TF32 on the tensor cores: 128 query rows a
    block, 64 a warpgroup, 32-key tiles) against its plain version within
    F32_FWD_TOL at T around those tiles and, from T = 40 on, with a padded
    tail of 37 and with every key masked; two launches give the same bits.
    Odd T runs one head (a size-1 head dimension in the tensor maps)."""
    from dgraph_tpu_torch.ops import attention as att

    q, k, v, _ = _att_inputs(T, 1 if T % 2 else 2, D, torch.float32, dev, seed=T)
    for mask in ("none",) if T < 40 else ("none", "tail", "all"):
        kw = dict(causal=causal, kv_mask=_att_mask(mask, T, dev))
        out, lse = att.flash_attention_fwd(q, k, v, **kw)
        out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
        torch.testing.assert_close(out, out_p, rtol=0, atol=F32_FWD_TOL)
        torch.testing.assert_close(lse, lse_p, rtol=0, atol=F32_FWD_TOL)
        again = att.flash_attention_fwd(q, k, v, **kw)
        assert torch.equal(again[0], out) and torch.equal(again[1], lse)
        if mask == "all":
            assert not out.any() and not lse.any()


# the f32 backward's limit (chip_smoke.py F32_BWD_TOL); at these lengths the
# f32 plain version is accurate enough to be the reference
F32_BWD_TOL = 1e-5


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 63, 64, 65, 127, 128, 129, 200])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_f32_backward_split_tf32_at_tile_edges(dev, D, T, causal):
    """The f32 dK/dV and dQ (split TF32 on the tensor cores: 128 key or
    query rows a block, 64 a warpgroup, 32-row streamed tiles) against their
    plain versions within F32_BWD_TOL at T around those tiles and, from T =
    40 on, with a padded tail of 37 and with every key masked (zero
    gradients); two launches give the same bits. Odd T runs one head (a
    size-1 head dimension in the tensor maps)."""
    from dgraph_tpu_torch.ops import attention as att

    q, k, v, do = _att_inputs(T, 1 if T % 2 else 2, D, torch.float32, dev, seed=T)
    for mask in ("none",) if T < 40 else ("none", "tail", "all"):
        kw = dict(causal=causal, kv_mask=_att_mask(mask, T, dev))
        out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
        args = (q, k, v, do, lse_p, att.row_dot(out_p, do))
        got = (*att.flash_attention_bwd_dkv(*args, **kw), att.flash_attention_bwd_dq(*args, **kw))
        want = (*att.flash_attention_bwd_dkv_plain(*args, **kw),
                att.flash_attention_bwd_dq_plain(*args, **kw))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=F32_BWD_TOL)
        again = (*att.flash_attention_bwd_dkv(*args, **kw), att.flash_attention_bwd_dq(*args, **kw))
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        if mask == "all":
            assert not any(g.any() for g in got)


def test_flash_attention_rejects_what_the_kernels_do_not_take(dev):
    from dgraph_tpu_torch.ops import attention as att

    q = torch.randn(64, 2, 48, device=dev)
    with pytest.raises(ValueError, match="head width"):
        att.flash_attention_fwd(q, q, q)
    q = torch.randn(64, 2, 32, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError):
        att.flash_attention_fwd(q, q, q)


def _lm_step(cfg, device):
    """Loss, gradients and attention launches of one train.lm step."""
    from dgraph_tpu_torch.ops import attention as att
    from dgraph_tpu_torch.train import lm

    t = lm.build_lm(cfg, device=device)
    toks = t.next_batch()
    kernels.reset_launch_counts()
    loss = float(t.train_step(toks)["loss"])
    counts = _attention_counts()
    return loss, {k: p.grad.cpu() for k, p in t.model.named_parameters()}, counts, t


def test_lm_flash_step_on_the_card_matches_the_cpu(dev):
    """One lm_flash step (T = 8192, L = 512, H = 4, D = 128) at one layer:
    the loss and every gradient match the CPU plain path (rtol=atol=1e-4),
    the step launches each attention kernel once, an eval forward only the
    forward kernel."""
    from dgraph_tpu_torch.ops import attention as att
    from dgraph_tpu_torch.train import lm

    cfg = lm.Config(seq_len=8192, latent=512, num_heads=4, num_layers=1, vocab=64,
                    attn_impl="ulysses", world_size=1)
    loss_gpu, grads_gpu, counts, t = _lm_step(cfg, dev)
    assert counts == {"flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
                      "flash_attention_bwd_dq": 1}
    kernels.reset_launch_counts()
    t.eval_step(t.next_batch())
    assert _attention_counts() == {"flash_attention_fwd": 1, "flash_attention_bwd_dkv": 0,
                                   "flash_attention_bwd_dq": 0}
    loss_cpu, grads_cpu, _, _ = _lm_step(cfg, torch.device("cpu"))
    assert abs(loss_cpu - loss_gpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for k, want in grads_cpu.items():
        torch.testing.assert_close(grads_gpu[k], want, rtol=1e-4, atol=1e-4, msg=k)


def test_no_attention_on_the_card_goes_through_a_plain_version(dev, monkeypatch):
    """Every plain attention function raises on a CUDA tensor; a train step
    and an eval forward of the LM on the card still run."""
    from dgraph_tpu_torch.ops import attention as att
    from dgraph_tpu_torch.train import lm

    for name in ("dense_attention", "flash_attention_fwd_plain",
                 "flash_attention_bwd_dkv_plain", "flash_attention_bwd_dq_plain"):
        plain = getattr(att, name)

        def refuse(q, *a, _plain=plain, _name=name, **kw):
            if q.is_cuda:
                raise AssertionError(f"{_name} ran on a CUDA tensor")
            return _plain(q, *a, **kw)

        monkeypatch.setattr(att, name, refuse)
    cfg = lm.Config(seq_len=1024, latent=256, num_heads=2, num_layers=2, world_size=1)
    loss, _, counts, t = _lm_step(cfg, dev)
    assert np.isfinite(loss)
    assert counts == {"flash_attention_fwd": 2, "flash_attention_bwd_dkv": 2,
                      "flash_attention_bwd_dq": 2}
    assert np.isfinite(float(t.eval_step(t.next_batch())))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_graph_transformer_attention_at_head_width_32(dev, dtype):
    """The graph transformer's attention: D = 32, 4 heads, non-causal, a
    key mask with padded slots inside the tiles and the last one (arxiv's
    padded slot), q, k and v column slices of one [T, 3L] qkv tensor read
    in place. The three kernels match their plain versions, and the
    autograd Function's output and qkv gradient match autograd of
    dense_attention; padded query rows come out zero."""
    from dgraph_tpu_torch.ops import attention as att

    T, H, D = 1000, 4, 32
    L = H * D
    gen = torch.Generator().manual_seed(3)
    qkv = torch.randn(T, 3 * L, generator=gen).to(dev, dtype)
    do = torch.randn(T, H, D, generator=gen).to(dev, dtype)
    mask = torch.ones(T, device=dev)
    mask[[100, 517, T - 1]] = 0
    q, k, v = (t.view(T, H, D) for t in qkv.split(L, dim=-1))
    assert att._operand(q) is q
    kw = dict(causal=False, kv_mask=mask)
    kernels.reset_launch_counts()
    out, lse = att.flash_attention_fwd(q, k, v, **kw)
    out_p, lse_p = att.flash_attention_fwd_plain(q, k, v, **kw)
    _att_close(out, out_p)
    torch.testing.assert_close(lse, lse_p, rtol=1e-4, atol=1e-4)
    di = att.row_dot(out_p, do)
    for got, want in zip(att.flash_attention_bwd_dkv(q, k, v, do, lse_p, di, **kw),
                         att.flash_attention_bwd_dkv_plain(q, k, v, do, lse_p, di, **kw)):
        _att_close(got, want)
    _att_close(att.flash_attention_bwd_dq(q, k, v, do, lse_p, di, **kw),
               att.flash_attention_bwd_dq_plain(q, k, v, do, lse_p, di, **kw))
    assert _attention_counts() == {"flash_attention_fwd": 1, "flash_attention_bwd_dkv": 1,
                                   "flash_attention_bwd_dq": 1}
    results = []
    for fn in (att.flash_attention, att.dense_attention):
        leaf = qkv.clone().requires_grad_()
        qs, ks, vs = (t.view(T, H, D) for t in leaf.split(L, dim=-1))
        o = fn(qs, ks, vs, **kw)
        o.backward(do)
        results.append((o.detach(), leaf.grad))
    (o_k, g_k), (o_p, g_p) = results
    assert torch.equal(o_k[mask == 0], torch.zeros_like(o_k[mask == 0]))
    _att_close(o_k, o_p)
    _att_close(g_k, g_p)


@pytest.mark.parametrize("model", ["gat", "gt"])
def test_gat_and_gt_train_on_the_card_like_on_the_cpu(dev, model):
    """One step of ``python -m dgraph_tpu_torch.train --model gat|gt`` at
    the CLI's widths (F = 128, hidden 128, 4 heads, C = 40) on a 997-vertex
    SBM graph (one padded slot): the loss and every gradient match the same
    step on the CPU (rtol=atol=1e-4), and the step launches the path's
    kernels: GT the three attention kernels once a layer and kernel 2 three
    times a layer; GAT kernel 2 six times a head group and layer."""
    from dgraph_tpu_torch.train.__main__ import Config, DataConfig, build_training

    cfg = Config(model=model, hidden=128, num_layers=2,
                 data=DataConfig(num_nodes=997, num_classes=40, feat_dim=128, avg_degree=13.77))
    results = {}
    for device in ("cpu", "cuda"):
        t = build_training(cfg, device=device)
        kernels.reset_launch_counts()
        loss = float(t.train_step(t.batches["train"])["loss"])
        results[device] = (loss, {k: p.grad.cpu() for k, p in t.model.named_parameters()},
                           kernels.launch_counts())
    (loss_cpu, grads_cpu, _), (loss_gpu, grads_gpu, counts) = results["cpu"], results["cuda"]
    assert abs(loss_cpu - loss_gpu) <= 1e-4 * max(1.0, abs(loss_cpu))
    for k, want in grads_cpu.items():
        torch.testing.assert_close(grads_gpu[k], want, rtol=1e-4, atol=1e-4, msg=k)
    want = dict.fromkeys(kernels.KERNELS, 0)
    if model == "gt":
        want.update(flash_attention_fwd=2, flash_attention_bwd_dkv=2, flash_attention_bwd_dq=2,
                    sorted_segment_sum=6)
    else:
        want.update(sorted_segment_sum=48)
    assert {k: counts[k] for k in want} == want


def test_graph_transformer_refuses_head_widths_the_kernels_lack(dev):
    """On the card a head width outside HEAD_DIMS raises the kernels' own
    ValueError; no dense fallback runs."""
    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.data import DistributedGraph, synthetic
    from dgraph_tpu_torch.models import GraphTransformer
    from dgraph_tpu_torch.weights import init_params

    sbm = synthetic.sbm_classification_graph(num_nodes=200, seed=1)
    g = DistributedGraph.from_global(sbm["edge_index"], sbm["features"], sbm["labels"],
                                     sbm["masks"], 1, partition_method="random")
    model = init_params(GraphTransformer(sbm["features"].shape[1], 160, 4, SingleComm(),
                                         num_layers=1, num_heads=4)).to(dev)  # D = 40
    with pytest.raises(ValueError, match="head width D in"):
        model(g.features[0].to(dev), g.plan.shard(0).to(dev), g.vertex_mask[0].to(dev))


@pytest.mark.parametrize("W", [2, 4])
def test_p2p_transport_bitwise_equal_plain_across_ranks(dev, W):
    """Kernel 5 on W ranks sharing the card (CUDA IPC) against its plain
    version, the masked send stack through gloo's all_to_all."""
    import torch_dist_ranks
    from dgraph_tpu_torch.comm.dist import launch

    assert launch(torch_dist_ranks.p2p_parity, W, device="cuda", timeout=300) == [[]] * W


@pytest.mark.parametrize("W", [2, 4])
def test_p2p_transport_mutant_bitwise_equal_plain_across_ranks(dev, W):
    """Kernel 6 on W ranks sharing the card: ``None`` bit-equal to kernel 5
    and to its plain version, each seeded fault bit-equal to its plain
    version."""
    import torch_dist_ranks
    from dgraph_tpu_torch.comm.dist import launch

    assert launch(torch_dist_ranks.p2p_mutant_parity, W, device="cuda", timeout=300) == [[]] * W


def test_p2p_landing_buffer_mapped_under_inference_mode_stays_writable(dev):
    """A landing buffer that kernel 5 first maps under ``inference_mode`` (a
    serving forward) is reused outside it: its tensors must be normal ones,
    which the protocol's zeroing can write (two ranks on the card)."""
    import torch_serve_ranks
    from dgraph_tpu_torch.comm.dist import launch

    assert launch(torch_serve_ranks.landing_after_inference, 2, device="cuda",
                  timeout=300) == [True, True]
