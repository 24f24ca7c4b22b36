"""The CUDA segment kernels against their plain versions, on the card.

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


def test_forward_only_on_cuda(dev):
    ids = _ids(dev)
    data = torch.randn(ids.shape[0], 8, device=dev, requires_grad=True)
    bias = torch.randn(N, 8, device=dev)
    with pytest.raises(NotImplementedError, match="training slice"):
        seg.sorted_segment_sum(data, ids, N)
    with pytest.raises(NotImplementedError, match="training slice"):
        seg.sorted_segment_sum_bias_relu(data, ids, bias, N)
    with torch.inference_mode():
        seg.sorted_segment_sum(data, ids, N)


def test_rejects_unsupported_dtype(dev):
    ids = _ids(dev)
    with pytest.raises(TypeError):
        seg.sorted_segment_sum(torch.zeros(ids.shape[0], 4, dtype=torch.float64,
                                           device=dev), ids, N)
