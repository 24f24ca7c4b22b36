"""Sequence attention — the single-rank subset of
``dgraph_tpu/parallel/sequence.py``.

At one rank every attention is one full-sequence attention: the dense oracle
:func:`dense_attention` (with ``NEG_BIG`` masking and
:func:`_zero_padded_rows`) as the plain version, and the flash kernels of
:mod:`dgraph_tpu_torch.ops.attention` on a card. ``ring_attention`` and
``ulysses_attention`` for more than one rank come with the multi-rank
communicator.
"""

from dgraph_tpu_torch.ops.attention import NEG_BIG, _zero_padded_rows, dense_attention

__all__ = ["NEG_BIG", "_zero_padded_rows", "dense_attention"]
