"""Online GNN inference serving over a partitioned graph.

- :mod:`~dgraph_tpu_torch.serve.bucketing` — request sizes padded up a small
  geometric ladder of buckets, each warmed ahead of time;
- :mod:`~dgraph_tpu_torch.serve.engine` — :class:`ServeEngine`: one full
  forward per request under ``torch.inference_mode()``, then the row gather;
  over W graph ranks rank 0 dispatches and the others ``follow()``;
- :mod:`~dgraph_tpu_torch.serve.batcher` — :class:`MicroBatcher`: bounded
  queue, bounded delay, deadlines;
- :mod:`~dgraph_tpu_torch.serve.errors` — the structured rejections.

``build_serving`` and the CLI live in ``serve/__main__.py`` (``python -m
dgraph_tpu_torch.serve``), as in the reference.
"""
