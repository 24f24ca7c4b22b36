"""Every CUDA kernel of the port in one registry: the sorted-id kernels
(:mod:`~dgraph_tpu_torch.ops.segment`), the flash-attention kernels
(:mod:`~dgraph_tpu_torch.ops.attention`), and the one-sided halo transport
and its fault-seeded copy (:mod:`~dgraph_tpu_torch.ops.p2p`), each a
``Kernel(wrapper, plain, replaces, source)``, with their launch counts."""

from __future__ import annotations

from dgraph_tpu_torch.ops import attention, p2p, segment

KERNELS = {**segment.KERNELS, **attention.KERNELS, **p2p.KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.wrapper.launches = 0


def launch_counts() -> dict:
    return {name: k.wrapper.launches for name, k in KERNELS.items()}
