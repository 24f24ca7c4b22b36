"""Training: the full-graph train loop and ``python -m dgraph_tpu_torch.train``;
the sequence LM's ``python -m dgraph_tpu_torch.train.lm``."""
