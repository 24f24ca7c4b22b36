"""The port's wire codecs (``dgraph_tpu_torch.wire``) against the JAX
package's (``dgraph_tpu.wire``), on the CPU.

- The registry: names, ``to_dict``, ``format_id``, byte pricing and round
  trip bounds equal to the reference's.
- The resolution ladder: the reference's ``(name, source)`` on a table of
  pin / record / plan cases, with one warning for a tier that degrades.
- The codecs: the port's numpy reference codec (bit arithmetic, no
  ``ml_dtypes``) gives the reference's ``np_encode`` bytes, which are the
  jax ``make_wire_transform``'s called eagerly; the torch codec gives the
  bytes of that jax codec compiled (``jax.jit``), as every reference
  lowering runs it: XLA compiles the fp8 scale's ``amax / 448`` as ``amax
  * f32(1/448)``, which ``np_encode(compiled=True)`` computes too. Both
  decode to the reference's values bit for bit: f32 and bf16 activations,
  F = 6 and 33, seeded rows with zero rows, rows whose small entries fall
  in e4m3's subnormal range, negative zeros, NaN and infinities. Rows of
  f32 subnormals are held to ``np_encode`` only: XLA's CPU flushes f32
  subnormals to zero, numpy does not (the reference's codecs disagree
  there).
- ``encode_compensated`` equal to the reference's (numpy and jax).
- Hub-row dedup on the reference's fixtures: the same plan, stats and
  verifier verdicts, the vacuity mutants RED with the reference's messages.
- The selftest CLI GREEN, and each of its mutants RED.
- ``plan_wire_format``: the port's plan stamps what the reference's stamps,
  under each pin.
- Kernel 5's wrapper refuses a mask with uint8 tiles.

Every comparison is exact (bit patterns) unless a line says otherwise.
"""

import dataclasses
import json
import logging
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dgraph_tpu import config as jcfg
from dgraph_tpu import plan as jplan
from dgraph_tpu.wire import codec as jcodec
from dgraph_tpu.wire import dedup as jdedup
from dgraph_tpu.wire import spec as jspec
from dgraph_tpu.wire.__main__ import _dedup_fixture
from dgraph_tpu_torch import config as tcfg
from dgraph_tpu_torch import plan as tplan
from dgraph_tpu_torch.wire import codec, dedup, spec

DELTAS = (1, 2)


@pytest.fixture
def wire_flags():
    """Save and restore both packages' wire flags."""
    saved = [(c, c.wire_format, c.tuned_wire_format) for c in (jcfg, tcfg)]
    yield
    for c, wf, tuned in saved:
        c.set_flags(wire_format=wf, tuned_wire_format=tuned)


def _pin(wire_format="auto", tuned=None):
    for c in (jcfg, tcfg):
        c.set_flags(wire_format=wire_format, tuned_wire_format=tuned)


# --- registry -----------------------------------------------------------------


def test_registry_ids_and_pricing_equal_the_reference():
    assert spec.WIRE_FORMAT_NAMES == jspec.WIRE_FORMAT_NAMES == ("fp32", "bf16", "fp8")
    assert spec.WIRE_FORMAT_VERSION == jspec.WIRE_FORMAT_VERSION
    assert (spec.E4M3_MAX, spec.FP8_SCALE_BYTES) == (jspec.E4M3_MAX, jspec.FP8_SCALE_BYTES)
    for name in spec.WIRE_FORMAT_NAMES:
        ours, ref = spec.get_format(name), jspec.get_format(name)
        assert ours.to_dict() == ref.to_dict()
        assert ours.format_id == ref.format_id
        assert spec.WireFormat.from_dict(json.loads(json.dumps(ours.to_dict()))) == ours
        assert spec.np_roundtrip_bound(name) == jspec.np_roundtrip_bound(name)
        for F, b in ((6, 4), (128, 4), (256, 2)):
            assert ours.wire_row_bytes(F, b) == ref.wire_row_bytes(F, b)
            assert ours.wire_feat_dim(F) == ref.wire_feat_dim(F)
            assert ours.compression_ratio(F, b) == ref.compression_ratio(F, b)
    with pytest.raises(ValueError, match="unknown wire format"):
        spec.get_format("int4")


def test_delta_skip_rows_equal_the_reference():
    rows = ((0, 64, 1, 2), (1, 0, 1, 0), (2, 1, 0, 1), (0, 2, 1, 0))
    assert spec.delta_skip_rows(rows, 4, 64) == jspec.delta_skip_rows(rows, 4, 64)


# --- the resolution ladder ----------------------------------------------------

LADDER = [
    # (pin, record, plan format, fp8_ok)
    ("bf16", None, "fp32", True),
    ("bf16", "fp32", "fp8", True),
    ("auto", "fp8", "fp32", True),
    ("auto", "bf16", "fp8", True),
    ("auto", None, "bf16", True),
    ("auto", None, "fp8", True),
    ("auto", None, "fp32", True),
    ("fp32", None, "bf16", True),
    ("", None, "fp32", True),
    ("fp8", "bf16", "fp32", False),
    ("fp8", None, "fp8", False),
    ("not-a-format", None, "bf16", True),
    ("auto", "int4", "fp32", True),
]


@pytest.mark.parametrize("pin, record, plan_format, fp8_ok", LADDER)
def test_resolver_ladder_equals_the_reference(wire_flags, pin, record, plan_format, fp8_ok):
    _pin(pin, record)
    got = spec.resolve_wire_format(4, DELTAS, plan_format=plan_format, fp8_ok=fp8_ok)
    assert got == jspec.resolve_wire_format(4, DELTAS, plan_format=plan_format, fp8_ok=fp8_ok)
    assert spec.resolve_wire_format(1, (), plan_format=plan_format) == ("fp32", "plan")


def test_resolver_degrades_with_one_warning(wire_flags, caplog):
    _pin("int4")
    spec._degrade_warned.clear()
    with caplog.at_level(logging.WARNING, logger="dgraph_tpu_torch.wire"):
        assert spec.resolve_wire_format(4, DELTAS, plan_format="bf16") == ("bf16", "plan")
        assert len(caplog.records) == 1
        assert spec.resolve_wire_format(4, DELTAS, plan_format="bf16") == ("bf16", "plan")
        assert len(caplog.records) == 1, "a repeated resolution warned again"
    _pin("fp8")
    spec._degrade_warned.clear()
    assert spec.resolve_wire_format(4, DELTAS, fp8_ok=False) == ("fp32", "default")
    assert spec.fp8_available() == hasattr(torch, "float8_e4m3fn")


# --- the codecs ---------------------------------------------------------------


def _rows(F: int, seed: int) -> np.ndarray:
    """Seeded f32 rows: normal rows, a zero row, a row of negative zeros,
    rows of 1e-4 and 1e4 scale, rows whose small entries land in e4m3's
    subnormal range after the row scale, and rows with NaN, -NaN, +-inf
    and a value past e4m3's range at scale 1 (a NaN row keeps scale 1)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(24, F)).astype(np.float32)
    x[1] = 0.0
    x[2] = -0.0
    x[3] *= 1e-4
    x[4] *= 1e4
    x[5, 1:] *= 1e-3  # e4m3 subnormals: |x / scale| < 2**-6
    x[6, 0], x[6, 1:] = 300.0, rng.normal(size=F - 1) * 1e-2
    x[7, 0] = np.nan
    x[8, 1] = -np.nan
    x[9, 2] = np.inf
    x[10, 0] = -np.inf
    x[11, 0], x[11, 1] = np.nan, 600.0
    return x


def _bytes(a) -> bytes:
    a = a.contiguous().view(torch.uint8) if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).tobytes()


def _bf16_tensor(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(spec.np_bf16_bits(x).view(np.int16)).view(torch.bfloat16)


@pytest.mark.parametrize("F", [6, 33])
@pytest.mark.parametrize("fmt", ["bf16", "fp8"])
@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_codecs_give_the_reference_bytes(fmt, act, F):
    x = _rows(F, seed=F)
    if act == "bfloat16":
        xt = _bf16_tensor(x)
        x = xt.float().numpy()  # the activations' values, exactly
        xj = jnp.asarray(x).astype(jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    enc, dec = codec.make_wire_transform(fmt, getattr(torch, act))
    jenc, jdec = jcodec.make_wire_transform(fmt, act)
    if jenc is None:  # bf16 on bf16: the identity in both
        assert enc is None and dec is None
        return
    eager = np.asarray(jenc(xj))
    assert _bytes(eager) == _bytes(jspec.np_encode(np.asarray(xj), fmt))
    assert _bytes(spec.np_encode(x, fmt)) == _bytes(eager), "numpy codec != np_encode"
    compiled = np.asarray(jax.jit(jenc)(xj))
    got = enc(xt)
    assert tuple(got.shape) == compiled.shape
    assert _bytes(got) == _bytes(compiled), "torch codec != the compiled reference's bytes"
    assert _bytes(spec.np_encode(x, fmt, compiled=True)) == _bytes(compiled)
    if fmt == "fp8":  # the two scales do differ: the comparison sees which
        assert _bytes(eager) != _bytes(compiled)
    for wire in (compiled, eager):
        back, jback = dec(torch.from_numpy(wire.view(np.uint8).copy()).view(got.dtype)), np.asarray(
            jax.jit(jdec)(jnp.asarray(wire)))
        assert str(back.dtype).split(".")[-1] == str(jback.dtype)
        assert _bytes(back) == _bytes(jback), "decode != the reference's"
        if act == "float32":  # numpy holds a bf16 operand as its uint16 bits
            bits = wire.view(np.uint16) if fmt == "bf16" else wire
            assert _bytes(spec.np_decode(bits, fmt)) == _bytes(jback)


@pytest.mark.parametrize("fmt", ["bf16", "fp8"])
def test_codecs_on_f32_subnormal_rows_give_np_encode_bytes(fmt):
    """Rows of f32 subnormals (and one mixed with a normal value): the port
    against the reference's numpy codec, which does not flush them."""
    x = np.array([[1e-42, 0.0, -2e-45, 5e-39], [1e-40, -1e-41, 3.0, 0.0]], np.float32)
    want = jspec.np_encode(x, fmt)
    enc, dec = codec.make_wire_transform(fmt, torch.float32)
    assert _bytes(spec.np_encode(x, fmt)) == _bytes(want)
    got = enc(torch.from_numpy(x))
    assert _bytes(got) == _bytes(spec.np_encode(x, fmt, compiled=True))
    assert _bytes(dec(got)) == _bytes(spec.np_decode(spec.np_encode(x, fmt, compiled=True), fmt))
    bits = want.view(np.uint16) if fmt == "bf16" else want
    assert _bytes(spec.np_decode(bits, fmt)) == _bytes(jspec.np_decode(want, fmt))


def test_codec_identity_cases_and_counts():
    codec.reset_calls()
    assert codec.make_wire_transform("fp32", torch.float32) == (None, None)
    assert codec.make_wire_transform("fp32", torch.bfloat16) == (None, None)
    assert codec.make_wire_transform("bf16", torch.bfloat16) == (None, None)
    enc, dec = codec.make_wire_transform("fp8", torch.float32)
    y = enc(torch.zeros(3, 6))
    assert y.dtype == torch.uint8 and tuple(y.shape) == (3, 10)
    # an all-zero wire row (rows no put reaches) decodes to +0.0
    z = dec(torch.zeros(2, 10, dtype=torch.uint8))
    assert torch.equal(z.view(torch.int32), torch.zeros(2, 6, dtype=torch.int32))
    assert codec.CALLS == {"encode": 1, "decode": 1}
    assert codec.wire_operand("fp8", 256, torch.float32) == (260, torch.uint8)
    assert codec.wire_operand("bf16", 6, torch.float32) == (6, torch.bfloat16)
    with pytest.raises(ValueError, match="unknown wire format"):
        codec.make_wire_transform("int4", torch.float32)


@pytest.mark.parametrize("fmt", ["fp32", "bf16", "fp8"])
def test_encode_compensated_equals_the_reference(fmt):
    """The torch ``encode_compensated`` against the reference's compiled
    (``jax.jit``), six steps, each fed the same residual: the wire bytes
    equal; the residual is the reference's formula ``(x + r) -
    decode(wire)`` bit for bit (numpy, two roundings), and within one ulp
    of ``x + r`` of the compiled one, where XLA contracts the decode's multiply and the
    subtraction into one fused multiply-add."""
    rng = np.random.default_rng(5)
    steps = rng.uniform(0.5, 1.5, size=(6, 4, 6)).astype(np.float32)
    jfn = jax.jit(lambda x, r: jcodec.encode_compensated(x, r, fmt))
    resid = np.zeros((4, 6), np.float32)
    for x in steps:
        y_t, resid_t = codec.encode_compensated(torch.from_numpy(x), torch.from_numpy(resid), fmt)
        y_j, resid_j = jfn(jnp.asarray(x), jnp.asarray(resid))
        assert _bytes(y_t) == _bytes(np.asarray(y_j))
        wire = y_t.view(torch.int16).numpy().view(np.uint16) if fmt == "bf16" else y_t.numpy()
        want = (x + resid) - spec.np_decode(wire, fmt)
        assert _bytes(resid_t) == _bytes(want)
        np.testing.assert_allclose(resid_t.numpy(), np.asarray(resid_j), rtol=0,
                                   atol=float(np.spacing(np.abs(x + resid).max())))
        resid = resid_t.numpy()


def test_np_encode_compensated_equals_the_reference():
    rng = np.random.default_rng(6)
    for fmt in ("bf16", "fp8"):
        resid_p = resid_r = None
        for x in rng.normal(size=(5, 3, 6)).astype(np.float32):
            y_p, resid_p = spec.np_encode_compensated(x, resid_p, fmt)
            y_r, resid_r = jspec.np_encode_compensated(x, resid_r, fmt)
            assert _bytes(y_p) == _bytes(y_r) and _bytes(resid_p) == _bytes(resid_r)
        y_p, r_p = spec.np_encode_compensated(x, None, fmt, _drop_residual=True)
        y_r, r_r = jspec.np_encode_compensated(x, None, fmt, _drop_residual=True)
        assert _bytes(y_p) == _bytes(y_r) and not r_p.any() and not r_r.any()


# --- hub-row dedup -------------------------------------------------------------


def _star(W=4, V=16, E=64, seed=0):
    rng = np.random.default_rng(seed)
    edges = np.stack([np.zeros(E, np.int64), rng.integers(0, V, E)])
    part = np.sort(rng.integers(0, W, V)).astype(np.int32)
    plan, _ = jplan.build_edge_plan(edges, part, world_size=W, edge_owner="dst")
    return np.asarray(plan.halo.send_idx), np.asarray(plan.halo.send_mask), plan.halo.s_pad


def _hubless(W=4, S=3):
    idx, msk = np.zeros((W, W, S), np.int32), np.zeros((W, W, S), np.float32)
    for s in range(W):
        for d in range(W):
            if s != d:
                idx[s, d] = [10 * s + 2 * d, 10 * s + 2 * d + 1, 0]
                msk[s, d] = [1, 1, 0]
    return idx, msk, S


@pytest.mark.parametrize("fixture", ["selftest", "star", "hubless"])
def test_dedup_plan_equals_the_reference(fixture):
    idx, msk, s_pad = {"selftest": _dedup_fixture, "star": _star, "hubless": _hubless}[fixture]()
    ours = dedup.build_dedup_plan(idx, msk, s_pad=s_pad)
    ref = jdedup.build_dedup_plan(idx, msk, s_pad=s_pad)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.direct_schedule.schedule_id == ref.direct_schedule.schedule_id
    assert dedup.verify_dedup_coverage(ours, idx, msk) == [] == jdedup.verify_dedup_coverage(
        ref, idx, msk)
    assert dedup.dedup_stats(ours, idx, msk) == jdedup.dedup_stats(ref, idx, msk)
    assert [dataclasses.asdict(h) for h in dedup.detect_hub_rows(idx, msk)] == [
        dataclasses.asdict(h) for h in jdedup.detect_hub_rows(idx, msk)]


def _mutants(mod, plan):
    """The selftest's three delivery mutants of ``plan`` built with
    ``mod``'s RelayTransfer: a duplicated relay, a dropped needer, a
    non-causal carrier."""
    R = mod.RelayTransfer
    return {
        "duplicated": dataclasses.replace(plan, relay_rounds=plan.relay_rounds + (
            (R(carrier=1, dst=2, src=0, row=5),),)),
        "dropped": dataclasses.replace(plan, relay_rounds=plan.relay_rounds[:1]),
        "noncausal": dataclasses.replace(plan, relay_rounds=(
            (R(carrier=2, dst=3, src=0, row=5),), (R(carrier=1, dst=2, src=0, row=5),))),
    }


def test_dedup_mutants_red_with_the_reference_verdicts():
    idx, msk, s_pad = _dedup_fixture()
    ours = _mutants(dedup, dedup.build_dedup_plan(idx, msk, s_pad=s_pad))
    ref = _mutants(jdedup, jdedup.build_dedup_plan(idx, msk, s_pad=s_pad))
    for name in ours:
        got = dedup.verify_dedup_coverage(ours[name], idx, msk)
        assert got, f"mutant {name} stayed GREEN"
        assert got == jdedup.verify_dedup_coverage(ref[name], idx, msk), name


def test_codec_mutants_red():
    """The selftest's codec mutants, directly: a decode that disagrees with
    its encode scale blows the round-trip bound; compensation that drops its
    residual drifts past four bounds in 64 steps where the carried one stays
    within two."""
    x = np.random.default_rng(0).standard_normal((6, 16)).astype(np.float32)
    bad = spec.np_decode(spec.np_encode(x, "fp8", _scale_gain=2.0), "fp8")
    assert np.max(np.abs(bad - x)) > spec.np_roundtrip_bound("fp8") * np.max(np.abs(x))
    v = x[:3]
    for fmt in ("bf16", "fp8"):
        bound, acc, acc_drop, resid = spec.np_roundtrip_bound(fmt), 0 * v, 0 * v, None
        for _ in range(64):
            y, resid = spec.np_encode_compensated(v, resid, fmt)
            acc = acc + spec.np_decode(y, fmt)
            acc_drop = acc_drop + spec.np_decode(
                spec.np_encode_compensated(v, None, fmt, _drop_residual=True)[0], fmt)
        rowmax = float(np.max(np.abs(v)))
        assert np.max(np.abs(acc - 64 * v)) <= 2 * bound * rowmax
        assert np.max(np.abs(acc_drop - 64 * v)) > 4 * bound * rowmax


def test_selftest_cli_green_and_equal_to_the_reference():
    got = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.wire", "--selftest", "true"],
                         capture_output=True, text=True, timeout=120, check=True).stdout
    ours = json.loads(got.strip().splitlines()[-1])
    from dgraph_tpu.wire.__main__ import _selftest

    ref = _selftest()
    assert ours == dict(ref, failures=[]) and ours["ok"]
    assert ours["failures"] == ref["failures"] == []


# --- the plan attachment -------------------------------------------------------


@pytest.mark.parametrize("pin", ["auto", "fp32", "bf16", "fp8", "not-a-format"])
@pytest.mark.parametrize("W", [1, 4])
def test_plan_wire_format_stamps_the_reference(wire_flags, pin, W):
    rng = np.random.default_rng(7)
    edges = rng.integers(0, 96, size=(2, 600))
    part = np.sort(rng.integers(0, W, 96)).astype(np.int32)
    _pin(pin)
    ours, _ = tplan.build_edge_plan(edges, part, world_size=W)
    ref, _ = jplan.build_edge_plan(edges, part, world_size=W, use_native=False)
    assert ours.wire_format == ref.wire_format
    assert ours.shard(0).wire_format == ours.wire_format
    assert tplan.plan_wire_format(W, ours.halo_deltas) == jplan.plan_wire_format(
        W, tuple(ref.halo_deltas))
    if W == 4 and pin in ("bf16", "fp8"):
        assert ours.wire_format == pin
        from dgraph_tpu_torch.comm import collectives

        _pin("auto")  # the plan tier carries the stamped format
        assert collectives.resolve_plan_wire_format(ours.shard(0), object()) == pin
        assert collectives.resolve_plan_wire_format(ours.shard(0), None) == "fp32"


# --- kernel 5 -----------------------------------------------------------------


def test_transport_refuses_a_mask_with_uint8_tiles():
    from dgraph_tpu_torch.ops import p2p

    group = type("G", (), {"world_size": 2, "rank": 0})()
    tiles = torch.zeros(1, 8, 10, dtype=torch.uint8)
    with pytest.raises(ValueError, match="mask=None only"):
        p2p.p2p_transport(tiles, (1,), 2, 8, mask=torch.ones(1, 8), group=group)
    with pytest.raises(TypeError, match="kernel 6 takes float32 or bfloat16"):
        p2p.p2p_transport_mutant(tiles, (1,), 2, 8, group=group)
    with pytest.raises(RuntimeError, match="no CUDA kernel"):
        p2p._check_cuda(tiles)
