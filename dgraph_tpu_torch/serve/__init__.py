"""Online GNN inference serving over a partitioned graph.

- :mod:`~dgraph_tpu_torch.serve.bucketing` — request sizes padded up a small
  geometric ladder of buckets, each warmed ahead of time;
- :mod:`~dgraph_tpu_torch.serve.engine` — :class:`ServeEngine`: one full
  forward per request under ``torch.inference_mode()``, then the row gather;
  over W graph ranks rank 0 dispatches and the others ``follow()``;
- :mod:`~dgraph_tpu_torch.serve.batcher` — :class:`MicroBatcher`: bounded
  queue, bounded delay, deadlines; the active engine resolved once a flush;
- :mod:`~dgraph_tpu_torch.serve.rollover` — ``swap_params``: a checkpoint
  hot swap (restore, stage, validate, adopt or roll back; over W ranks
  every rank together);
- :mod:`~dgraph_tpu_torch.serve.registry` — :class:`ModelRegistry`: named
  engines with one active, which the batcher flips between batches;
- :mod:`~dgraph_tpu_torch.serve.deltas` — live graph growth: appends staged
  on disk and written into reserved pad slots, a background re-plan into the
  next generation, adopted by one pointer write and a registry flip;
- :mod:`~dgraph_tpu_torch.serve.errors` — the structured rejections.

``build_serving`` and the CLI live in ``serve/__main__.py`` (``python -m
dgraph_tpu_torch.serve``), as in the reference.
"""
