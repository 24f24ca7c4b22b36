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


@pytest.mark.parametrize("F", [1, 33, 128, 256])
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
