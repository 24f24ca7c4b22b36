"""The port's sequence-transformer LM against the JAX package's, one rank.

The flax ``SeqTransformerLM`` runs under ``Communicator.init_process_group(
"single")`` (its ``seq_attention`` is the dense oracle on the CPU); the port
runs the same weights, carried across by ``params_from_jax``, with the
attention's plain version. Tokens are the induction corpus of
``experiments/long_context_lm.py`` drawn from a seeded numpy generator.

Tolerances (f32, rtol=atol): logits, the step-0 loss and every gradient
1e-4 (both sides compute in f32 and differ in summation order only); five
Adam steps against optax, the losses 1e-4 and the parameters 1e-3 (Adam's
first updates are about ±lr per coordinate whatever the gradient's size, so
a gradient near 0 summed in another order can move its coordinate by up to
2·lr).
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
from dgraph_tpu.models.transformer import SeqTransformerLM as JaxLM
from dgraph_tpu_torch.comm import SingleComm
from dgraph_tpu_torch.models import SeqTransformerLM, TransformerBlock
from dgraph_tpu_torch.train import lm
from dgraph_tpu_torch.weights import init_params, params_from_jax, params_to_jax

T, VOCAB, LATENT, HEADS, LAYERS = 128, 16, 64, 4, 2
LR = 3e-3
JAX_COMM = Communicator.init_process_group("single")


def _models(seed=0):
    """(flax params, the flax model, the port's model loaded with them)."""
    jmodel = JaxLM(vocab=VOCAB, latent=LATENT, num_layers=LAYERS, num_heads=HEADS,
                   max_len=T, comm=JAX_COMM)
    toks = jnp.zeros((T,), jnp.int32)
    params = jmodel.init(jax.random.key(seed), toks, jnp.arange(T, dtype=jnp.int32))
    tmodel = SeqTransformerLM(vocab=VOCAB, latent=LATENT, num_layers=LAYERS, num_heads=HEADS,
                              max_len=T, comm=SingleComm())
    tmodel.load_state_dict(params_from_jax(params))
    return params, jmodel, tmodel


def _tokens(seed=0):
    return lm.induction_batch(np.random.default_rng(seed), T, VOCAB)


def _jax_loss(jmodel, params, toks):
    """``long_context_lm.py:95-122`` at one rank: next-token targets wrap
    around, and the last position (whose target is the wrapped first token)
    is masked."""
    toks = jnp.asarray(toks)
    logits = jmodel.apply(params, toks, jnp.arange(T, dtype=jnp.int32))
    targets = jnp.concatenate([toks[1:], toks[:1]])
    ll = jnp.take_along_axis(jax.nn.log_softmax(logits), targets[:, None], axis=1)[:, 0]
    return -(ll * (jnp.arange(T) < T - 1)).sum() / (T - 1)


def _assert_trees_close(got: dict, want: dict, tol: float):
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert flat_got.keys() == flat_want.keys()
    for path, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(flat_got[path], np.float32),
                                   np.asarray(w, np.float32), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_logits_match_flax():
    params, jmodel, tmodel = _models()
    toks = _tokens()
    want = jmodel.apply(params, jnp.asarray(toks), jnp.arange(T, dtype=jnp.int32))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(toks), torch.arange(T, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (T, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_submodule_names_and_layer_norm_epsilon_follow_flax():
    params, _, tmodel = _models()
    assert set(params_from_jax(params)) == set(tmodel.state_dict())
    assert tmodel.block_0.ln_attn.eps == tmodel.ln_out.eps == 1e-6


def test_params_to_jax_round_trip():
    """Embedding tables and LayerNorm scales go back as they are, Dense
    kernels transposed; with the module, a 2-D ``weight`` that is an
    embedding goes back as ``embedding``."""
    params, _, tmodel = _models(seed=3)
    back = params_to_jax(tmodel.state_dict(), tmodel)
    _assert_trees_close(back, jax.tree.map(np.asarray, params), 0.0)
    leaves = back["params"]
    assert set(leaves["tok_embed"]) == {"embedding"}
    assert set(leaves["block_1"]["ln_ffn"]) == {"scale", "bias"}
    assert leaves["block_0"]["qkv"]["kernel"].shape == (LATENT, 3 * LATENT)


def test_step0_loss_and_gradients_match_flax():
    params, jmodel, tmodel = _models()
    toks = _tokens(seed=1)
    want_loss, want_grads = jax.value_and_grad(lambda p: _jax_loss(jmodel, p, toks))(params)
    loss = lm.lm_loss(tmodel(torch.from_numpy(toks), torch.arange(T, dtype=torch.int32)),
                      torch.from_numpy(toks))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4, atol=1e-4)
    grads = params_to_jax({k: p.grad for k, p in tmodel.named_parameters()}, tmodel)
    _assert_trees_close(grads, want_grads, 1e-4)


def test_five_adam_steps_of_train_lm_match_optax():
    """``train.lm``'s step (its batch stream, loss and Adam) against
    ``long_context_lm.py``'s loop (:126-171 at one rank): the same induction
    batches from ``default_rng(seed)`` after the initialisation draw, Adam at
    lr 3e-3 with optax's defaults."""
    params, jmodel, _ = _models()
    cfg = lm.Config(seq_len=T, vocab=VOCAB, latent=LATENT, num_layers=LAYERS,
                    num_heads=HEADS, lr=LR, seed=5, device="cpu")
    t = lm.build_lm(cfg)
    t.model.load_state_dict(params_from_jax(params))

    rng = np.random.default_rng(cfg.seed)
    lm.induction_batch(rng, T, VOCAB)  # the reference's initialisation draw
    opt = optax.adam(LR)
    opt_state = opt.init(params)
    want_losses = []
    for _ in range(5):
        toks = lm.induction_batch(rng, T, VOCAB)
        loss, grads = jax.value_and_grad(lambda p: _jax_loss(jmodel, p, toks))(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want_losses.append(float(loss))

    got_losses = [float(t.train_step(t.next_batch())["loss"]) for _ in range(5)]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4, atol=1e-4)
    assert got_losses[-1] < got_losses[0]
    got = params_to_jax(t.model.state_dict(), t.model)
    # The key third of each qkv bias adds q·b_k to every logit of a row, which
    # the softmax cancels: its gradient is 0 up to rounding, and Adam turns
    # that noise into steps of about ±lr. Held to the most 5 such steps can
    # move it apart (2·lr each); every other parameter to 1e-3.
    for i in range(LAYERS):
        b_got = got["params"][f"block_{i}"]["qkv"]["bias"]
        b_want = np.asarray(params["params"][f"block_{i}"]["qkv"]["bias"])
        keys = slice(LATENT, 2 * LATENT)
        np.testing.assert_allclose(b_got[keys], b_want[keys], rtol=0, atol=10 * LR)
        b_got[keys] = b_want[keys]
    _assert_trees_close(got, params, 1e-3)


def test_induction_batches_follow_the_reference_draws():
    cfg = lm.Config(seq_len=T, vocab=VOCAB, latent=LATENT, seed=7, device="cpu")
    t = lm.build_lm(cfg)
    rng = np.random.default_rng(7)
    rng.integers(1, VOCAB, T // 2)  # the initialisation draw (long_context_lm.py:126)
    for _ in range(3):
        half = rng.integers(1, VOCAB, T // 2)
        got = t.next_batch()
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.concatenate([half, half]))


def test_eval_step_and_step_metrics():
    cfg = lm.Config(seq_len=T, vocab=VOCAB, latent=LATENT, device="cpu", step_metrics=True)
    t = lm.build_lm(cfg)
    toks = t.next_batch()
    m = t.train_step(toks)
    rec = m.record(step=0)
    assert rec["grad_norm"] > 0 and np.isfinite(rec["loss"])
    assert np.isfinite(float(t.eval_step(toks)))


def test_init_params_follows_flax_initialisers():
    model = init_params(SeqTransformerLM(vocab=VOCAB, latent=LATENT, num_layers=1, max_len=T,
                                         comm=SingleComm()), seed=0)
    emb = model.tok_embed.weight.detach()
    assert abs(float(emb.std()) - LATENT ** -0.5) < 0.3 * LATENT ** -0.5
    assert torch.equal(model.block_0.ln_attn.weight, torch.ones(LATENT))
    assert torch.equal(model.block_0.ln_attn.bias, torch.zeros(LATENT))
    w = model.block_0.qkv.weight.detach()
    assert float(w.abs().max()) <= 2 * LATENT ** -0.5 / 0.87962566103423978 + 1e-6
    again = init_params(SeqTransformerLM(vocab=VOCAB, latent=LATENT, num_layers=1, max_len=T,
                                         comm=SingleComm()), seed=0)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))


def test_moe_and_multi_rank_raise():
    with pytest.raises(ValueError, match="moe_k > 0 needs a sharded communicator"):
        TransformerBlock(LATENT, HEADS, SingleComm(), moe_k=1)
    with pytest.raises(ValueError, match="moe_k > 0"):
        lm.build_lm(lm.Config(seq_len=T, moe_k=2, device="cpu"))
    with pytest.raises(NotImplementedError, match="multi-rank slice"):
        lm.build_lm(lm.Config(seq_len=T, world_size=2, device="cpu"))
    with pytest.raises(SystemExit, match="must be even"):
        lm.build_lm(lm.Config(seq_len=T + 1, device="cpu"))
    if not torch.cuda.is_available():  # the entry point refuses the CPU unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            lm.build_lm(lm.Config(seq_len=T))


def test_train_lm_cli_on_cpu(tmp_path):
    """python -m dgraph_tpu_torch.train.lm --device cpu: one step record per
    logged step with the reference's fields, appended to --log_path."""
    log = tmp_path / "lm.jsonl"
    out = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.train.lm", "--device", "cpu", "--seq_len", "64",
         "--latent", "32", "--steps", "3", "--log_every", "1", "--attn_impl", "ulysses",
         "--world_size", "1", "--log_path", str(log)],
        capture_output=True, text=True, timeout=300, check=True,
    ).stdout
    recs = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [r["step"] for r in recs] == [0, 1, 2]
    for r in recs:
        assert r["kind"] == "step" and r["seq_len"] == 64 and r["world"] == 1
        assert r["uniform_nats"] == pytest.approx(np.log(64)) and r["ms_per_step"] > 0
    assert log.read_text().count("\n") == 3
