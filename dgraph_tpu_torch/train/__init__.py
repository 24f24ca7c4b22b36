"""Training: the full-graph train loop and ``python -m dgraph_tpu_torch.train``;
the sequence LM's ``python -m dgraph_tpu_torch.train.lm``; GraphCast's
``python -m dgraph_tpu_torch.train.graphcast`` with its schedule
(``schedules``) and EMA track (``ema``)."""
