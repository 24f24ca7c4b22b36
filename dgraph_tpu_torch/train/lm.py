"""``python -m dgraph_tpu_torch.train.lm`` — long-context causal LM training.

Counterpart of ``experiments/long_context_lm.py`` (``main``, :54-176) at world
size 1: trains :class:`~dgraph_tpu_torch.models.SeqTransformerLM` on the
synthetic induction corpus (the second half of each sequence repeats the
first, so only exact attention over the full sequence gets below the unigram
floor) with Adam at ``--lr``. Batches come from ``np.random.default_rng(seed)``
exactly as the reference draws them (:88-93), including the one draw it
spends on initialisation, so both see the same sequence at every step. The
loss scores all T - 1 next-token predictions (:95-122 at one rank: the
targets wrap and the last position is masked). Writes one step record (the
reference's ``StepMetrics`` schema with ``uniform_nats``, ``seq_len``,
``world`` and ``ms_per_step``) every ``--log_every`` steps and at the last,
to stdout and appended to ``--log_path``. Runs on ``cuda`` unless
``--device cpu``; with no card it raises.

    python -m dgraph_tpu_torch.train.lm --seq_len 8192 --latent 512 --num_heads 4 \\
        --attn_impl ulysses --world_size 1
    python -m dgraph_tpu_torch.train.lm --device cpu --seq_len 256 --steps 5

At one rank ``--attn_impl ring`` and ``ulysses`` are both one full-sequence
attention (the flash kernels on a card). World sizes above 1 and the MoE FFN
(``--moe_k > 0``) come with the multi-rank slice of the port and raise here.
The reference's start-up record is not written.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class Config:
    """Causal LM on synthetic induction data, one card."""

    seq_len: int = 2048
    vocab: int = 64
    latent: int = 128
    num_layers: int = 2
    num_heads: int = 4
    steps: int = 200
    lr: float = 3e-3
    world_size: Optional[int] = None  # None = one rank here
    attn_impl: str = "ring"  # 'ring' or 'ulysses': one full-sequence attention at one rank
    moe_k: int = 0  # > 0 needs a sharded communicator: raises here
    moe_aux_weight: float = 0.01  # the reference's flag; read only with moe_k > 0
    seed: int = 0
    log_path: str = "logs/long_context_lm_torch.jsonl"
    log_every: int = 20
    step_metrics: bool = False  # grad norm in each record
    device: str = ""  # "" = cuda (raises with no card); "cpu" for the plain path


def induction_batch(rng: np.random.Generator, seq_len: int, vocab: int) -> np.ndarray:
    """One ``[seq_len]`` int32 sequence whose second half repeats its first
    (``long_context_lm.py:91-93``)."""
    half = rng.integers(1, vocab, seq_len // 2)
    return np.concatenate([half, half]).astype(np.int32)


def lm_loss(logits, tokens):
    """Mean next-token negative log-likelihood over the T - 1 real
    predictions: the targets are the tokens shifted left with the first
    wrapped to the end, and that last position is masked
    (``long_context_lm.py:95-122`` at one rank)."""
    import torch

    T = tokens.shape[0]
    targets = torch.roll(tokens.long(), -1)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(1, targets[:, None])[:, 0]
    valid = torch.arange(T, device=ll.device) < T - 1
    return -(ll * valid).sum() / (T - 1)


def build_lm(cfg: Config, device=None) -> types.SimpleNamespace:
    """Seeded model, Adam, the batch stream and the train/eval steps on
    ``device`` (default ``cfg.device``, else ``cuda``; raises with no card
    before any work). ``next_batch()`` returns the next ``[T]`` int32 token
    tensor on the device; the initialisation draw is already spent."""
    import torch

    from dgraph_tpu_torch.comm import SingleComm
    from dgraph_tpu_torch.config import default_device
    from dgraph_tpu_torch.models import SeqTransformerLM
    from dgraph_tpu_torch.train.loop import _global_norm
    from dgraph_tpu_torch.obs.metrics import StepMetrics
    from dgraph_tpu_torch.weights import init_params

    dev = default_device(device if device is not None else (cfg.device or None))
    W = cfg.world_size or 1
    if W != 1:
        raise NotImplementedError(
            f"world_size={W}: training above one rank is the multi-rank slice of the port")
    T = cfg.seq_len
    if T % W or T % 2:
        raise SystemExit(
            f"seq_len {T} must be even (induction corpus halves) and divide by "
            f"world_size {W}")
    model = SeqTransformerLM(
        vocab=cfg.vocab, latent=cfg.latent, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, max_len=T, comm=SingleComm(), attn_impl=cfg.attn_impl,
        moe_k=cfg.moe_k,
    )
    init_params(model, seed=cfg.seed).to(dev)
    optimizer = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    params = [p for p in model.parameters() if p.requires_grad]
    pos = torch.arange(T, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(cfg.seed)
    induction_batch(rng, T, cfg.vocab)  # the reference's initialisation draw

    def next_batch():
        return torch.from_numpy(induction_batch(rng, T, cfg.vocab)).to(dev)

    def train_step(tokens) -> StepMetrics:
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens, pos), tokens)
        loss.backward()
        with torch.no_grad():
            gn = _global_norm(params) if cfg.step_metrics else None
            optimizer.step()
        return StepMetrics(loss=loss.detach(), grad_norm=gn)

    def eval_step(tokens):
        with torch.no_grad():
            return lm_loss(model(tokens, pos), tokens)

    return types.SimpleNamespace(device=dev, model=model, optimizer=optimizer,
                                 positions=pos, next_batch=next_batch,
                                 train_step=train_step, eval_step=eval_step)


def main(cfg: Config, *, on_step: Optional[Callable] = None) -> dict:
    """Train ``cfg.steps`` steps. ``on_step(step, training, tokens)`` runs
    after each step (its gradients are still on the parameters). Returns
    {"records", "step_ms", "training"}: the logged records and the host-clock
    time of every step, each ended by a device synchronize."""
    import torch

    from dgraph_tpu_torch.train.__main__ import _Log

    t = build_lm(cfg)
    log = _Log(cfg.log_path)
    uniform = float(np.log(cfg.vocab))
    records, step_ms = [], []

    def sync():
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    t0 = time.perf_counter()
    for i in range(cfg.steps):
        tokens = t.next_batch()
        sync()
        ts = time.perf_counter()
        sm = t.train_step(tokens)
        sync()
        step_ms.append((time.perf_counter() - ts) * 1e3)
        if i % cfg.log_every == 0 or i == cfg.steps - 1:
            rec = sm.record(step=i, uniform_nats=uniform, seq_len=cfg.seq_len, world=1,
                            ms_per_step=(time.perf_counter() - t0) / (i + 1) * 1e3)
            log.write(rec)
            records.append(rec)
        if on_step is not None:
            on_step(i, t, tokens)
    return {"records": records, "step_ms": step_ms, "training": t}


if __name__ == "__main__":
    from dgraph_tpu_torch.utils.cli import parse_config

    main(parse_config(Config))
