"""The port's full-sequence attention against the JAX package's.

``flash_attention`` on the CPU is the plain version (the dense oracle with
autograd through it); it is held against ``dgraph_tpu.parallel.sequence.
dense_attention`` and ``jax.grad`` of it, and against the Pallas library's
``mha_reference`` with the ``SegmentIds`` that ``_flash_dense`` builds. The
three kernels' plain versions (forward with its logsumexp, dK/dV, dQ) and
the autograd Function that chains them (the card's route, run here with the
plain versions) are held against the same JAX gradients.

Inputs are numpy normals from a seed, f32. Tolerance rtol=atol=1e-5 for
every comparison: both sides compute in f32 and differ only in summation
order (sums of at most 200 terms of size about 1).

In bf16 the forward and dK/dV plain versions round P, Pᵀ and dSᵀ to bf16
before their products, where the Pallas kernels round them
(flash_attention.py:471, :900, :918); they are held against the Pallas
kernels themselves, run in interpret mode, at rtol=atol=2e-2: both sides
round each output once from f32 and round P at the same points, so they
differ by about one bf16 step of the output (2⁻⁷ relative) plus f32 order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu import flash_attention as fa

from dgraph_tpu.parallel import sequence as jseq
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.ops import attention as att
from dgraph_tpu_torch.parallel import sequence as tseq

TOL = 1e-5
H = 2


def _inputs(T, D, masked, seed=0):
    """q, k, v, the output cotangent [T, H, D] and a kv_mask with a padded
    tail (or None), as numpy f32."""
    rng = np.random.default_rng(seed)
    q, k, v, cot = (rng.standard_normal((T, H, D)).astype(np.float32) for _ in range(4))
    mask = (np.arange(T) < T - 37).astype(np.float32) if masked else None
    return q, k, v, cot, mask


def _segment_ids(mask):
    """The library's SegmentIds as ``_flash_dense`` builds them
    (sequence.py:297-300): padding is segment 1. None without a mask."""
    if mask is None:
        return None
    ids = jnp.asarray((mask <= 0).astype(np.int32))[None]
    return fa.SegmentIds(q=ids, kv=ids)


def _jax_out_and_grads(fn, q, k, v, cot):
    out, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(out)] + [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _torch_out_and_grads(fn, q, k, v, cot):
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(cot))
    return [out.detach().numpy()] + [t.grad.numpy() for t in leaves]


def _assert_all_close(got, want, tol=TOL):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("T", [128, 200])
@pytest.mark.parametrize("D", [32, 128])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_matches_jax_dense_attention(causal, masked, D, T):
    q, k, v, cot, mask = _inputs(T, D, masked)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = _jax_out_and_grads(
        lambda a, b, c: jseq.dense_attention(a, b, c, causal=causal, kv_mask=jm), q, k, v, cot)
    got = _torch_out_and_grads(
        lambda a, b, c: att.flash_attention(a, b, c, causal=causal, kv_mask=tm), q, k, v, cot)
    _assert_all_close(got, want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_route_on_plain_versions_matches_jax_grad(causal, masked):
    """The card's route — forward with lse, di, dK/dV, dQ — with each kernel
    replaced by its plain version (a CPU tensor), against jax.grad of the
    dense oracle; the lse against the library reference's m + log(l)."""
    T, D = 200, 64
    q, k, v, cot, mask = _inputs(T, D, masked, seed=1)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = _jax_out_and_grads(
        lambda a, b, c: jseq.dense_attention(a, b, c, causal=causal, kv_mask=jm), q, k, v, cot)
    got = _torch_out_and_grads(
        lambda a, b, c: att._FlashAttention.apply(a, b, c, tm, causal, None), q, k, v, cot)
    _assert_all_close(got, want)

    _, lse = att.flash_attention_fwd(*(torch.from_numpy(a) for a in (q, k, v)),
                                     causal=causal, kv_mask=tm)
    to_k = lambda a: jnp.asarray(a).transpose(1, 0, 2)[None]
    _, l, m = fa.mha_reference_no_custom_vjp(
        to_k(q), to_k(k), to_k(v), None, _segment_ids(mask), causal=causal,
        sm_scale=1 / np.sqrt(D), save_residuals=True)
    want_lse = np.asarray(m + jnp.log(l))[0]  # [H, T]
    real = np.ones(T, bool) if mask is None else mask > 0
    np.testing.assert_allclose(lse.numpy()[:, real], want_lse[:, real], rtol=TOL, atol=TOL)
    assert np.all(lse.numpy()[:, ~real] == 0.0)  # padded rows are empty rows


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_matches_library_mha_reference_with_segment_ids(causal, masked):
    """The Pallas library's reference with the SegmentIds ``_flash_dense``
    builds (sequence.py:297-300: padding is segment 1), padded rows zeroed
    as ``_flash_dense`` zeroes them."""
    T, D = 128, 128
    q, k, v, _, mask = _inputs(T, D, masked, seed=2)
    to_k = lambda a: jnp.asarray(a).transpose(1, 0, 2)[None]
    ref = fa.mha_reference(to_k(q), to_k(k), to_k(v), None, _segment_ids(mask), causal=causal,
                           sm_scale=float(1 / np.sqrt(D)))
    want = np.asarray(ref[0].transpose(1, 0, 2))
    if mask is not None:
        want = want * (mask > 0)[:, None, None]
    got = att.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                              kv_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("route", ["plain", "kernel-route"])
@pytest.mark.parametrize("causal", [False, True])
def test_every_key_masked_gives_zero_rows_and_gradients(causal, route):
    """A kv_mask with no real position: every row is empty. The dense oracle
    gives zeros (its uniform softmax over NEG_BIG logits is re-zeroed), the
    port gives zeros and zero gradients by either route, and lse is 0."""
    T, D = 96, 32
    q, k, v, cot, _ = _inputs(T, D, masked=False, seed=3)
    mask = np.zeros(T, np.float32)
    want = _jax_out_and_grads(
        lambda a, b, c: jseq.dense_attention(a, b, c, causal=causal,
                                             kv_mask=jnp.asarray(mask)), q, k, v, cot)
    tm = torch.from_numpy(mask)
    fn = ((lambda a, b, c: att.flash_attention(a, b, c, causal=causal, kv_mask=tm))
          if route == "plain" else
          (lambda a, b, c: att._FlashAttention.apply(a, b, c, tm, causal, None)))
    got = _torch_out_and_grads(fn, q, k, v, cot)
    _assert_all_close(got, want)
    for g in got:
        assert not np.any(g)
    _, lse = att.flash_attention_fwd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                           causal=causal, kv_mask=tm)
    assert torch.equal(lse, torch.zeros(H, T))


def test_seq_attention_validates_impl_and_runs_one_attention():
    q, k, v, _, mask = _inputs(64, 32, masked=True, seed=4)
    tq, tk, tv, tm = (torch.from_numpy(a) for a in (q, k, v, mask))
    comm = SingleComm()
    want = att.dense_attention(tq, tk, tv, causal=True, kv_mask=tm)
    for impl in ("ring", "ulysses"):
        assert torch.equal(comm.seq_attention(tq, tk, tv, causal=True, kv_mask=tm, impl=impl),
                           want)
    with pytest.raises(ValueError, match="unknown seq_attention impl"):
        comm.seq_attention(tq, tk, tv, impl="bogus")


def test_parallel_sequence_subset():
    assert tseq.NEG_BIG == jseq.NEG_BIG
    assert tseq.dense_attention is att.dense_attention
    out = torch.ones(5, 2, 3)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0, 0.0])
    got = tseq._zero_padded_rows(out, mask)
    want = jseq._zero_padded_rows(jnp.ones((5, 2, 3)), jnp.asarray(mask.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_strided_operands_give_the_contiguous_result():
    """q, k, v as column slices of one [T, 3L] tensor (the LM's layout)."""
    T, D = 96, 32
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((T, 3 * H * D)).astype(np.float32))
    q, k, v = (t.reshape(T, H, D) for t in qkv.split(H * D, dim=-1))
    assert q.stride() == (3 * H * D, D, 1)
    got = att.flash_attention_fwd(q, k, v, causal=True)
    want = att.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_wrappers_on_cpu_run_the_plain_versions_and_count_nothing():
    from dgraph_tpu_torch.ops import kernels, p2p, segment

    kernels.reset_launch_counts()
    q, k, v, cot, _ = _inputs(64, 32, masked=False, seed=6)
    _torch_out_and_grads(lambda a, b, c: att._FlashAttention.apply(a, b, c, None, True, None),
                         q, k, v, cot)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.KERNELS, 0),
                                       **{f"{k}.hub_calls": 0 for k in segment.HUB_ROUTE}}
    assert set(kernels.KERNELS) == set(segment.KERNELS) | set(att.KERNELS) | set(p2p.KERNELS)
    assert len(kernels.KERNELS) == 10


BF16_TOL = 2e-2


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128])
def test_bf16_plain_versions_match_the_pallas_kernels(causal, D):
    """The bf16 plain versions against Pallas' TPU flash attention in
    interpret mode (its forward, and its dQ, dK and dV from ``jax.vjp``) on
    the same bf16 inputs. dV and dQ are the products whose rounding points
    the two share exactly (normalised Pᵀ, and dS, in bf16): rounding there
    brings each plain version closer to the Pallas kernel than the f32 Pᵀ or
    dS formula. For dQ closer is measured by the mean absolute error: its
    largest error is one bf16 step of the output in both formulas."""
    T = 256
    q, k, v, cot, _ = _inputs(T, D, masked=False, seed=7)
    to_k = lambda a: jnp.asarray(a).astype(jnp.bfloat16).transpose(1, 0, 2)[None]
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(lambda a, b, c: fa.flash_attention(
            a, b, c, causal=causal, sm_scale=float(1 / np.sqrt(D))), to_k(q), to_k(k), to_k(v))
        dq, dk, dv = vjp(to_k(cot))
    back = lambda x: np.asarray(x[0].astype(jnp.float32)).transpose(1, 0, 2)
    tq, tk, tv, tc = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, cot))
    out_p, lse = att.flash_attention_fwd_plain(tq, tk, tv, causal=causal)
    di = att.row_dot(out_p, tc)
    dk_p, dv_p = att.flash_attention_bwd_dkv_plain(tq, tk, tv, tc, lse, di, causal=causal)
    dq_p = att.flash_attention_bwd_dq_plain(tq, tk, tv, tc, lse, di, causal=causal)
    for name, got, want in (("out", out_p, out), ("dq", dq_p, dq), ("dk", dk_p, dk),
                            ("dv", dv_p, dv)):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), back(want), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=name)
    p = att._probs(tq, tk, lse, 1 / np.sqrt(D), causal, None)
    dv_f32p = torch.einsum("hts,thd->shd", p, tc.float()).to(torch.bfloat16)
    dq_f32ds = _dq_plain_f32_formula(tq, tk, tv, tc, lse, di, causal, 1 / np.sqrt(D), None)
    err = lambda a, want: np.abs(a.float().numpy() - back(want))
    assert err(dv_p, dv).max() < err(dv_f32p, dv).max()
    assert err(dq_p, dq).mean() < err(dq_f32ds, dq).mean()


def _fwd_plain_f32_formula(q, k, v, causal, scale, kv_mask):
    """The f32 forward plain version as it was before P was rounded."""
    T = q.shape[0]
    s = torch.einsum("thd,shd->hts", q.float(), k.float()) * scale
    allowed = att._allowed(T, causal, kv_mask, q.device)
    s = s.masked_fill(~allowed, -np.inf)
    lse = torch.logsumexp(s, dim=-1)
    lse = torch.where(torch.isneginf(lse), 0.0, lse)
    p = torch.where(allowed, torch.exp(s - lse[..., None]), 0.0)
    return torch.einsum("hts,shd->thd", p, v.float()).to(q.dtype), lse


def _dkv_plain_f32_formula(q, k, v, do, lse, di, causal, scale, kv_mask):
    """The f32 dK/dV plain version as it was before Pᵀ and dSᵀ were rounded."""
    p = att._probs(q, k, lse, scale, causal, kv_mask)
    dof = do.float()
    dv = torch.einsum("hts,thd->shd", p, dof)
    dp = torch.einsum("thd,shd->hts", dof, v.float())
    ds = (dp - di[..., None]) * p * scale
    dk = torch.einsum("hts,thd->shd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _dq_plain_f32_formula(q, k, v, do, lse, di, causal, scale, kv_mask):
    """The dQ plain version as it was before dS was rounded."""
    p = att._probs(q, k, lse, scale, causal, kv_mask)
    dp = torch.einsum("thd,shd->hts", do.float(), v.float())
    ds = (dp - di[..., None]) * p * scale
    return torch.einsum("hts,shd->thd", ds, k.float()).to(q.dtype)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_f32_plain_versions_are_unchanged(causal, masked):
    """In f32 the rounding is the identity: the forward, dK/dV and dQ plain
    versions give the bits of their formulas before it."""
    T, D = 200, 64
    q, k, v, cot, mask = (None if a is None else torch.from_numpy(a)
                          for a in _inputs(T, D, masked, seed=8))
    scale = 1 / np.sqrt(D)
    out, lse = att.flash_attention_fwd_plain(q, k, v, causal=causal, kv_mask=mask)
    want = _fwd_plain_f32_formula(q, k, v, causal, scale, mask)
    assert torch.equal(out, want[0]) and torch.equal(lse, want[1])
    di = att.row_dot(out, cot)
    got = att.flash_attention_bwd_dkv_plain(q, k, v, cot, lse, di, causal=causal, kv_mask=mask)
    for a, b in zip(got, _dkv_plain_f32_formula(q, k, v, cot, lse, di, causal, scale, mask)):
        assert torch.equal(a, b)
    dq = att.flash_attention_bwd_dq_plain(q, k, v, cot, lse, di, causal=causal, kv_mask=mask)
    assert torch.equal(dq, _dq_plain_f32_formula(q, k, v, cot, lse, di, causal, scale, mask))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_operand_rule_passes_lm_slices_and_copies_the_rest(dtype):
    """``_operand``'s in-place rule. In bf16 it is TMA's (strides in whole
    8-element groups, a 16-byte aligned base): the LM's q, k and v (column
    slices of one [T, 3L] tensor, row stride 1536, head stride 128, base
    offsets 0, 1 KB and 2 KB) pass as they are; a slice at an odd element
    offset, or a row stride that is a multiple of 4 but not of 8, is
    copied. f32 keeps its rule of 4-element groups."""
    T, H, D = 16, 4, 128
    L = H * D
    qkv = torch.zeros(T, 3 * L, dtype=dtype)
    for i in range(3):
        t = qkv[:, i * L:(i + 1) * L].reshape(T, H, D)
        assert t.stride() == (3 * L, D, 1)
        assert att._operand(t) is t
    odd = qkv[:, 3:3 + L].reshape(T, H, D)
    copied = att._operand(odd)
    assert copied is not odd and copied.is_contiguous() and torch.equal(copied, odd)
    wide = torch.zeros(T, L + 4, dtype=dtype)[:, :L].reshape(T, H, D)  # row stride L + 4
    assert (att._operand(wide) is wide) == (dtype == torch.float32)


@pytest.mark.parametrize("T", [1, 33, 200])
def test_split_tf32_scratches_are_sized_for_f32_only(T):
    """The f32 kernels' scratch, where their pre-passes write operands split
    into TF32, T_pad = T rounded up to 32: the forward's 4·H·T_pad·D floats
    (K hi, K lo, V^T hi, V^T lo), dK/dV's 8·H·T_pad·D (Q and dO hi and lo,
    as rows and transposed), dQ's 6·H·T_pad·D (K and V as rows, K
    transposed); None in bf16, whose kernels read the operands in place."""
    H, D = 2, 64
    t_pad = -(-T // 32) * 32
    fwd = att._split_scratch(T, H, D, torch.float32, "cpu")
    dkv = att._bwd_scratch("dkv", T, H, D, torch.float32, "cpu")
    dq = att._bwd_scratch("dq", T, H, D, torch.float32, "cpu")
    assert fwd.dtype == dkv.dtype == dq.dtype == torch.float32
    assert (fwd.numel(), dkv.numel(), dq.numel()) == tuple(n * H * t_pad * D for n in (4, 8, 6))
    assert att._split_scratch(T, H, D, torch.bfloat16, "cpu") is None
    assert all(att._bwd_scratch(kind, T, H, D, torch.bfloat16, "cpu") is None
               for kind in ("dkv", "dq"))
