"""Static analysis of the port — counterpart of ``dgraph_tpu/analysis/``.

- :mod:`dgraph_tpu_torch.analysis.kernel` — the **put-discipline
  verifier** of the one-sided halo transport: the reference's DMA rules
  (paired send and receive waits, wait-before-reuse, destination rows
  provably ``[me*S, (me+1)*S)``, the memory contract) on the recorded
  protocol of every transport call and its destinations, vacuity guards
  that seed each fault, and a landing check that launches kernels 5 and 6
  on the card (their plain versions on the CPU).
- :mod:`dgraph_tpu_torch.analysis.lint` — the **contract linter**:
  stdlib-``ast`` rules over ``dgraph_tpu_torch/`` and ``chip_smoke.py``
  (no jax import, deterministic plan builds, paired autograd Functions, no
  collective under a rank branch), with the reference's registry and
  pragma.
- :mod:`dgraph_tpu_torch.analysis.host` — the **host-side concurrency &
  durability auditor**: lock discipline, lock order, durable writes,
  pointer flips and chaos coverage over the port's threaded host code.
- :mod:`dgraph_tpu_torch.analysis.trace` — the canonical audit workload
  and the programs the kernel tier runs.

CLI::

    python -m dgraph_tpu_torch.analysis              # lint + host + kernel audit
    python -m dgraph_tpu_torch.analysis --selftest   # plus every vacuity guard
    python -m dgraph_tpu_torch.analysis.kernel --device cpu

The reference's trace, HLO and SPMD tiers audit jaxprs and StableHLO,
which the port does not have; a collective-schedule audit takes their
place in a later slice (ROADMAP). Importing the package registers the host
rules in ``lint.RULES`` (one registry, one pragma).
"""

from __future__ import annotations

from dgraph_tpu_torch.analysis import host  # noqa: F401  (registers host rules)

__all__ = ["host", "kernel", "lint", "trace"]
