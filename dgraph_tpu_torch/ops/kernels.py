"""Every CUDA kernel of the port in one registry: the sorted-id kernels
(:mod:`~dgraph_tpu_torch.ops.segment`), the flash-attention kernels
(:mod:`~dgraph_tpu_torch.ops.attention`), and the one-sided halo transport
and its fault-seeded copy (:mod:`~dgraph_tpu_torch.ops.p2p`), each a
``Kernel(wrapper, plain, replaces, source)``, with their launch counts and
the sorted segment sums' hub-route calls."""

from __future__ import annotations

from dgraph_tpu_torch.ops import attention, p2p, segment

KERNELS = {**segment.KERNELS, **attention.KERNELS, **p2p.KERNELS}


def reset_launch_counts() -> None:
    """Zero every wrapper's launches, kernel 5's launches on uint8 tiles
    (``p2p.p2p_transport.byte_launches``) and the hub-route calls."""
    for k in KERNELS.values():
        k.wrapper.launches = 0
    p2p.p2p_transport.byte_launches = 0
    segment.reset_launch_counts()


def launch_counts() -> dict:
    """Each wrapper's launches, then the sorted-segment wrappers' hub-route
    calls (``segment.hub_calls``)."""
    return {**{name: k.wrapper.launches for name, k in KERNELS.items()}, **segment.hub_calls()}
