"""The port's backward routes against the JAX Pallas kernels' VJPs.

The JAX kernels run in interpret mode, as ``tests/test_pallas_segment.py``
runs them on the CPU: ``jax.grad`` of the fused op with ``gather_mv > 0``
runs ``_fused_bwd_kernel`` and the ``epilogue="act"`` pass (unweighted) or
the composed backward (weighted, or ``gather_mv = 0``). The port, given CPU
tensors, runs the same autograd Functions it runs on the card, with each
kernel's plain version in place of the kernel.

Inputs are made with numpy from a seed, with the plan's padded owner ids
(out of range), empty segments and a hub vertex whose degree exceeds the
TPU kernel's edge block. Tolerances: f32 rtol=atol=1e-5 (the two sum in
different orders); bf16, compared in f32, rtol=atol=2e-2 (one bf16 ulp of
an output is 2^-8 of it).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dgraph_tpu.ops import local as jax_local
from dgraph_tpu.ops.pallas_segment import (
    _make_fused_bwd,
    max_chunks_hint,
    max_vblocks_hint,
    sorted_row_gather as jax_sorted_row_gather,
    sorted_segment_sum as jax_sorted_segment_sum,
    sorted_segment_sum_bias_relu as jax_sorted_segment_sum_bias_relu,
)
from dgraph_tpu_torch import config
from dgraph_tpu_torch.ops import local as local_ops
from dgraph_tpu_torch.ops import segment as seg

BLOCK_E, BLOCK_N = 128, 64
N = 150
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _sorted_ids(seed=0):
    rng = np.random.default_rng(seed)
    real = rng.choice(np.arange(0, N, 2), 500)  # odd segments stay empty
    hub = np.full(300, 8)  # degree 300 > BLOCK_E
    pad = np.full(40, N)  # padded edges: owner id n_owner_pad
    return np.concatenate([np.sort(np.concatenate([real, hub])), pad]).astype(np.int32)


IDS = _sorted_ids()
E = IDS.shape[0]
MC = max_chunks_hint(IDS, N, block_e=BLOCK_E, block_n=BLOCK_N)
MV = max_vblocks_hint(IDS, N, block_e=BLOCK_E, block_n=BLOCK_N)


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(arr, jdt)
    return j, torch.tensor(np.asarray(j, np.float32)).to(tdt)


def _close(got, want, dtype, name=""):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=name)


def _prec(dtype):
    return "default" if dtype == "bfloat16" else "highest"


@pytest.mark.parametrize("F", [33, 128])
@pytest.mark.parametrize("route", ["pair", "composed", "weighted"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_op_gradients_match_pallas(dtype, route, F):
    """d_data, d_bias (and d_w) of the fused op on each backward route."""
    rng = np.random.default_rng(F + len(route))
    jd, td = _pair(rng.normal(size=(E, F)).astype(np.float32), dtype)
    jb, tb = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    w = rng.random(E).astype(np.float32) if route == "weighted" else None
    mv = 0 if route == "composed" else MV

    def f(d, b, ww):
        return jax_sorted_segment_sum_bias_relu(
            d, jnp.asarray(IDS), b, N, edge_weight=ww, max_chunks_per_block=MC,
            block_e=BLOCK_E, block_n=BLOCK_N, interpret=True, gather_mv=mv,
            precision=_prec(dtype))

    jw = None if w is None else jnp.asarray(w)
    _, vjp = jax.vjp(f, jd, jb, jw)
    want = vjp(jg)

    td.requires_grad_()
    tb.requires_grad_()
    tw = None if w is None else torch.from_numpy(w).requires_grad_()
    out = seg.sorted_segment_sum_bias_relu(td, torch.from_numpy(IDS), tb, N,
                                           edge_weight=tw, gather_mv=mv)
    out.backward(tg)
    _close(td.grad, want[0], dtype, "d_data")
    _close(tb.grad, want[1], dtype, "d_bias")
    if w is not None:
        _close(tw.grad, want[2], dtype, "d_w")
    # masked edges take no gradient
    assert not td.grad[IDS >= N].any()


def test_backward_routes_pick_the_reference_kernels(monkeypatch):
    """Unweighted with gather_mv > 0 runs the pair (fused_bwd_gd + the act
    sum); gather_mv = 0 or a weight runs the composed route (two row takes
    and a sorted sum), as pallas_segment.py:414-473 routes them."""
    calls = []
    for name in ("fused_bwd_gd", "sorted_segment_sum_act", "take_sorted", "_segment_sum"):
        orig = getattr(seg, name)
        monkeypatch.setattr(seg, name, lambda *a, _o=orig, _n=name, **k: (calls.append(_n), _o(*a, **k))[1])
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(IDS)
    for mv, w in ((MV, None), (0, None), (MV, torch.rand(E))):
        calls.clear()
        d = torch.from_numpy(rng.normal(size=(E, 8)).astype(np.float32)).requires_grad_()
        b = torch.zeros(N, 8, requires_grad=True)
        seg.sorted_segment_sum_bias_relu(d, ids, b, N, edge_weight=w, gather_mv=mv).sum().backward()
        if mv and w is None:
            assert calls == ["fused_bwd_gd", "sorted_segment_sum_act"]
        else:
            assert calls == ["take_sorted", "take_sorted", "_segment_sum"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_bwd_kernel_matches_plain(dtype):
    """_fused_bwd_kernel (interpret) against fused_bwd_gd_plain and the
    wrapper on CPU tensors."""
    rng = np.random.default_rng(1)
    F = 128
    jd, td = _pair(rng.normal(size=(E, F)).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    jb, tb = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    want = _make_fused_bwd(N, MV, BLOCK_E, BLOCK_N, True, _prec(dtype))(
        jd, jg, jb, jnp.asarray(IDS))
    got = seg.fused_bwd_gd(td, tg, tb, torch.from_numpy(IDS))
    assert got.dtype == td.dtype and got.shape == (E, F)
    _close(got, want, dtype)
    _close(seg.fused_bwd_gd_plain(td, tg, tb, torch.from_numpy(IDS)), want, dtype)


def test_act_sum_counts_active_edges():
    """sorted_segment_sum_act: f32 counts of w·1[data + bias[v] > 0], a
    hub's count past bf16's 256 kept exact."""
    ids = torch.from_numpy(IDS)
    data = torch.ones(E, 3, dtype=torch.bfloat16)
    bias = torch.zeros(N, 3, dtype=torch.bfloat16)
    bias[:, 2] = -2  # pre = -1: never active
    out = seg.sorted_segment_sum_act(data, ids, bias, N)
    assert out.dtype == torch.float32
    deg = np.bincount(IDS[IDS < N], minlength=N).astype(np.float32)
    np.testing.assert_array_equal(out[:, 0].numpy(), deg)
    np.testing.assert_array_equal(out[:, 2].numpy(), np.zeros(N, np.float32))
    assert deg[8] > 300


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_row_gather_and_vjp_match_pallas(dtype):
    rng = np.random.default_rng(2)
    F = 64
    jx, tx = _pair(rng.normal(size=(N, F)).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=(E, F)).astype(np.float32), dtype)

    def f(x):
        return jax_sorted_row_gather(x, jnp.asarray(IDS), max_vblocks=MV, block_e=BLOCK_E,
                                     block_n=BLOCK_N, scatter_mc=MC, interpret=True,
                                     precision=_prec(dtype))

    want, vjp = jax.vjp(f, jx)
    tx.requires_grad_()
    got = seg.sorted_row_gather(tx, torch.from_numpy(IDS))
    _close(got, want, dtype, "x[ids]")
    assert not got[IDS >= N].any()
    got.backward(tg)
    _close(tx.grad, vjp(jg)[0], dtype, "dx")


@pytest.mark.parametrize("input_op", ["none", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_segment_sum_vjp_matches_pallas(dtype, input_op):
    """_make_sss's VJP: g[ids] (zero for dropped rows), times 1[data > 0]
    for the relu input op — with the gather flag on too, when the take is
    the sorted-row-gather kernel's plain version."""
    rng = np.random.default_rng(3)
    jd, td = _pair(rng.normal(size=(E, 33)).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=(N, 33)).astype(np.float32), dtype)

    def f(d):
        return jax_sorted_segment_sum(d, jnp.asarray(IDS), N, max_chunks_per_block=MC,
                                      block_e=BLOCK_E, block_n=BLOCK_N, interpret=True,
                                      input_op=input_op, precision=_prec(dtype))

    _, vjp = jax.vjp(f, jd)
    want = vjp(jg)[0]
    for flag in (None, True):
        config.use_pallas_gather = flag
        try:
            d = td.clone().requires_grad_()
            seg.sorted_segment_sum(d, torch.from_numpy(IDS), N, input_op=input_op,
                                   gather_mv=MV).backward(tg)
        finally:
            config.use_pallas_gather = None
        _close(d.grad, want, dtype, f"gather flag {flag}")


def _take_case(seed=4):
    rng = np.random.default_rng(seed)
    n_rows, F = 40, 6
    x = rng.normal(size=(n_rows, F)).astype(np.float32)
    g = rng.normal(size=(E, F)).astype(np.float32)
    return n_rows, x, g


def test_take_rows_sorted_vjp_matches_reference():
    n_rows, x, g = _take_case()
    ids = np.minimum(IDS // 4, n_rows).astype(np.int32)  # sorted, tail out of range

    def f(xx):
        return jax_local.take_rows(xx, jnp.asarray(ids), indices_are_sorted=True)

    _, vjp = jax.vjp(f, jnp.asarray(x))
    want = vjp(jnp.asarray(g))[0]
    for flag in (None, True):
        config.use_pallas_gather = flag
        try:
            tx = torch.from_numpy(x).requires_grad_()
            out = local_ops.take_rows(tx, torch.from_numpy(ids), indices_are_sorted=True,
                                      gather_mv=MV)
            out.backward(torch.from_numpy(g))
        finally:
            config.use_pallas_gather = None
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(f(jnp.asarray(x))))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_sort_route_take_and_sum_vjps_match_reference():
    """take_rows_sort_route with the edge mask folded into the ids has the
    reference's gradient of ``taken * edge_mask``; segment_sum_sort_route's
    backward is the row take by the original ids."""
    rng = np.random.default_rng(5)
    n_rows, x, g = _take_case(5)
    idx = rng.integers(0, n_rows, E).astype(np.int32)
    mask = (rng.random(E) > 0.2).astype(np.float32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    sids = idx[perm]
    hints = (BLOCK_E, BLOCK_N, max_chunks_hint(sids, n_rows, BLOCK_E, BLOCK_N))

    def f(xx):
        t = jax_local.take_rows_sort_route(xx, jnp.asarray(idx), jnp.asarray(perm),
                                           jnp.asarray(sids), pallas_hints=hints)
        return t * jnp.asarray(mask)[:, None]

    _, vjp = jax.vjp(f, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    folded = torch.where(torch.from_numpy(mask) > 0, torch.from_numpy(idx), n_rows)
    out = local_ops.take_rows_sort_route(tx, folded, torch.from_numpy(perm),
                                         torch.from_numpy(sids))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(f(jnp.asarray(x))))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                               rtol=1e-5, atol=1e-5)

    def s(d):
        return jax_local.segment_sum_sort_route(d, jnp.asarray(idx), jnp.asarray(perm),
                                                jnp.asarray(sids), n_rows, pallas_hints=hints)

    gs = rng.normal(size=(n_rows, 6)).astype(np.float32)
    _, vjp_s = jax.vjp(s, jnp.asarray(g))
    td = torch.from_numpy(g).requires_grad_()
    got = local_ops.segment_sum_sort_route(td, torch.from_numpy(idx), torch.from_numpy(perm),
                                           torch.from_numpy(sids), n_rows)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(s(jnp.asarray(g))),
                               rtol=1e-5, atol=1e-5)
    got.backward(torch.from_numpy(gs))
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(vjp_s(jnp.asarray(gs))[0]),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unsorted_segment_sum_vjp_is_row_take(dtype):
    rng = np.random.default_rng(6)
    ids = rng.permutation(IDS)
    jd, td = _pair(rng.normal(size=(E, 5)).astype(np.float32), dtype)
    jg, tg = _pair(rng.normal(size=(N, 5)).astype(np.float32), dtype)
    _, vjp = jax.vjp(lambda d: jax_local.segment_sum(d, jnp.asarray(ids), N), jd)
    td.requires_grad_()
    local_ops.segment_sum(td, torch.from_numpy(ids), N).backward(tg)
    _close(td.grad, vjp(jg)[0], dtype)


def test_gather_flag_reads_the_reference_env_name(monkeypatch):
    """DGRAPH_TPU_PALLAS_GATHER: explicit opt-in; unset (auto) is off."""
    import importlib

    try:
        monkeypatch.delenv("DGRAPH_TPU_PALLAS_GATHER", raising=False)
        assert importlib.reload(config).pallas_gather_enabled() is False
        monkeypatch.setenv("DGRAPH_TPU_PALLAS_GATHER", "1")
        assert importlib.reload(config).pallas_gather_enabled() is True
        monkeypatch.setenv("DGRAPH_TPU_PALLAS_GATHER", "0")
        assert importlib.reload(config).pallas_gather_enabled() is False
    finally:
        monkeypatch.delenv("DGRAPH_TPU_PALLAS_GATHER", raising=False)
        importlib.reload(config)


def test_backward_kernels_count_no_launch_on_cpu():
    seg.reset_launch_counts()
    d = torch.randn(E, 4, requires_grad=True)
    b = torch.zeros(N, 4, requires_grad=True)
    seg.sorted_segment_sum_bias_relu(d, torch.from_numpy(IDS), b, N, gather_mv=MV).sum().backward()
    assert set(seg.launch_counts().values()) == {0}
