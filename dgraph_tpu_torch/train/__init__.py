"""Training: the full-graph train loop and ``python -m dgraph_tpu_torch.train``."""
