"""dgraph_tpu_torch — the PyTorch and CUDA port of ``dgraph_tpu`` for NVIDIA Hopper.

The JAX package ``dgraph_tpu`` stays the reference; this package is its
counterpart module by module (``dgraph_tpu/plan.py`` <-> ``plan.py`` and so
on), written in PyTorch idiom: ``nn.Module`` models, plain functions on
tensors, an explicit ``device`` and explicit ``torch.Generator`` seeds.

It imports neither ``jax`` nor ``dgraph_tpu``: whatever it needs from the
reference's numpy-only modules (partitioners, the plan builder, synthetic
data, serving errors and bucketing) it keeps as its own copy.

Every Pallas kernel on a ported path (the sorted-id kernels of GNN serving
and training, Pallas' flash attention of the sequence LM, the one-sided
halo transport of multi-rank training) is a hand-written
CUDA kernel for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and
bound with ``ctypes`` (``ops/_build.py``). On CPU tensors the kernel wrappers
run their plain PyTorch versions; on CUDA tensors they launch the kernel or
raise.

Entry points (``serve.build_serving``, ``serve.ServeEngine``, ``python -m
dgraph_tpu_torch.serve``, ``python -m dgraph_tpu_torch.train`` and ``python
-m dgraph_tpu_torch.train.lm``) run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit device they raise. Above
one rank each rank is a process (``comm.dist``), spawned by the entry point
or joined under ``torchrun``.
"""

__version__ = "0.1.0"
