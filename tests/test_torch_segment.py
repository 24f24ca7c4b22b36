"""The port's sorted-segment reductions against the JAX Pallas kernels.

The JAX kernels run in interpret mode, as ``tests/test_pallas_segment.py``
runs them on the CPU; the port's wrappers, given CPU tensors, run their
plain versions (the CUDA kernels themselves are held against those plain
versions on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``).

Inputs are made with numpy from a seed and cover the plan's padded owner ids
(``n_owner_pad``, out of range), empty segments, a hub vertex whose degree
exceeds the TPU kernel's edge block, and F in {1, 33, 128}.
Tolerances: f32 rtol=atol=1e-5 (the two sum in different orders); bf16,
compared in f32, rtol=atol=2e-2 (one bf16 ulp of the output is 2^-8).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dgraph_tpu.ops import local as jax_local
from dgraph_tpu.ops.pallas_segment import (
    max_chunks_hint,
    sorted_segment_sum as jax_sorted_segment_sum,
    sorted_segment_sum_bias_relu as jax_sorted_segment_sum_bias_relu,
)
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.ops import segment as seg

BLOCK_E, BLOCK_N = 128, 64
N = 150  # owner vertices; the padded edges carry id N (plan.py:1173-1178)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sorted_ids(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.choice(np.arange(0, N, 2), 500)  # odd segments stay empty
    hub = np.full(300, 8)  # degree 300+ > BLOCK_E
    pad = np.full(40, N)  # padded edges: owner id n_owner_pad, dropped
    return np.concatenate([np.sort(np.concatenate([real, hub])), pad]).astype(np.int32)


IDS = _sorted_ids()
E = IDS.shape[0]
MC = max_chunks_hint(IDS, N, block_e=BLOCK_E, block_n=BLOCK_N)


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype`` (bf16
    is rounded once, by JAX, and carried across exactly through f32)."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(arr, jdt)
    return j, torch.tensor(np.asarray(j, np.float32)).to(tdt)


def _close(got: torch.Tensor, want, dtype: str):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("F", [1, 33, 128])
@pytest.mark.parametrize("input_op", ["none", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_segment_sum_matches_pallas(dtype, input_op, F):
    rng = np.random.default_rng(F)
    jd, td = _pair(rng.normal(size=(E, F)).astype(np.float32), dtype)
    want = jax_sorted_segment_sum(
        jd, jnp.asarray(IDS), N, max_chunks_per_block=MC, block_e=BLOCK_E,
        block_n=BLOCK_N, interpret=True, input_op=input_op,
        precision="default" if dtype == "bfloat16" else "highest",
    )
    got = seg.sorted_segment_sum(td, torch.from_numpy(IDS), N, input_op=input_op)
    assert got.dtype == td.dtype and got.shape == (N, F)
    _close(got, want, dtype)


@pytest.mark.parametrize("F", [1, 33, 128])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_segment_sum_bias_relu_matches_pallas(dtype, weighted, F):
    rng = np.random.default_rng(100 + F)
    jd, td = _pair(rng.normal(size=(E, F)).astype(np.float32), dtype)
    jb, tb = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    w = rng.random(E).astype(np.float32) if weighted else None
    want = jax_sorted_segment_sum_bias_relu(
        jd, jnp.asarray(IDS), jb, N,
        edge_weight=None if w is None else jnp.asarray(w),
        max_chunks_per_block=MC, block_e=BLOCK_E, block_n=BLOCK_N,
        interpret=True, precision="default" if dtype == "bfloat16" else "highest",
    )
    got = seg.sorted_segment_sum_bias_relu(
        td, torch.from_numpy(IDS), tb, N,
        edge_weight=None if w is None else torch.from_numpy(w),
    )
    assert got.dtype == td.dtype and got.shape == (N, F)
    _close(got, want, dtype)


def test_dispatch_casts_f32_bias_to_bf16_data():
    """The bias is rounded to the data dtype at the dispatch point, as the
    reference's local.py:197-200 does before its kernel."""
    rng = np.random.default_rng(7)
    jd, td = _pair(rng.normal(size=(E, 128)).astype(np.float32), "bfloat16")
    bias = rng.normal(size=(N, 128)).astype(np.float32)
    want = jax_sorted_segment_sum_bias_relu(
        jd, jnp.asarray(IDS), jnp.asarray(bias).astype(jnp.bfloat16), N,
        max_chunks_per_block=MC, block_e=BLOCK_E, block_n=BLOCK_N,
        interpret=True, precision="default",
    )
    got = local_ops.sorted_segment_sum_bias_relu_any(
        td, torch.from_numpy(IDS), torch.from_numpy(bias), N)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unsorted_segment_sum_accumulates_in_f32(dtype):
    """ops.local.segment_sum (any id order, OOB dropped) against the
    reference's f32-accumulating segment sum; a bf16 running sum would
    stall on the hub's 300 ones."""
    rng = np.random.default_rng(3)
    ids = rng.permutation(IDS)
    ones = np.ones((E, 1), np.float32)
    jd, td = _pair(ones, dtype)
    want = jax_local.segment_sum(jd, jnp.asarray(ids), N)
    got = local_ops.segment_sum(td, torch.from_numpy(ids), N)
    _close(got, want, dtype)
    assert float(got[8, 0]) >= 300


def test_row_take_fill_matches_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(20, 5)).astype(np.float32)
    idx = np.array([0, 19, 20, -1, 7, 25], np.int32)
    want = jax_local.row_take(jnp.asarray(x), jnp.asarray(idx), oob="fill")
    got = local_ops.row_take(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plain_path_is_differentiable_on_cpu():
    """On CPU tensors the wrappers run the plain versions, which autograd
    differentiates: d(sum)/d(data) is g[ids] with OOB rows zero."""
    rng = np.random.default_rng(5)
    data = torch.from_numpy(rng.normal(size=(E, 4)).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.normal(size=(N, 4)).astype(np.float32))
    out = seg.sorted_segment_sum(data, torch.from_numpy(IDS), N)
    (out * g).sum().backward()
    want = np.zeros((E, 4), np.float32)
    valid = IDS < N
    want[valid] = g.numpy()[IDS[valid]]
    np.testing.assert_allclose(data.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cpu_calls_are_not_kernel_launches():
    seg.reset_launch_counts()
    x = torch.zeros(E, 3)
    ids = torch.from_numpy(IDS)
    seg.sorted_segment_sum(x, ids, N)
    seg.sorted_segment_sum_bias_relu(x, ids, torch.zeros(N, 3), N)
    assert seg.launch_counts() == {"sorted_segment_sum": 0,
                                   "sorted_segment_sum_bias_relu": 0}
