"""Kernel 5: the one-sided halo transport, its wrapper, plain version and
symmetric landing buffers.

Counterpart of ``dgraph_tpu/ops/pallas_p2p.py`` (``_transport_kernel`` :102,
public ``p2p_transport`` :217). :func:`p2p_transport` delivers tile ``k`` of
``blocks [n, S, F]`` (times ``mask[k]`` per row, when given) into rank
``(me + sign*deltas[k]) % W``'s ``[W*S, F]`` halo buffer at rows
``[me*S, (me+1)*S)`` and returns this rank's buffer: rows ``[p*S, (p+1)*S)``
hold what peer ``p`` put, rows no put reaches are 0 — the layout and values
of the ``all_to_all`` lowering.

On a CUDA tensor it launches ``csrc/p2p_transport.cu``, whose stores land in
the peers' buffers through CUDA IPC, and synchronises on the host where the
TPU kernel waits on semaphores inside the kernel:

1. zero this rank's landing buffer and synchronise the card (the buffer's
   last clone is done, and the zeros are down before any peer writes);
2. host barrier: every peer's buffer is ready;
3. launch the kernel;
4. synchronise the card, host barrier: every put has landed;
5. return a clone of the buffer (the next call reuses it; autograd keeps
   the output).

No kernel waits on another process: ranks that share a card time-slice it.
The landing buffers come from ``cudaMalloc`` in the source (an IPC handle
covers a whole allocation, and PyTorch's caching allocator shares them
between tensors), one per (rows, F, dtype, direction), exchanged once over
the group's host process group and kept for the life of the process. On a CPU tensor the wrapper runs
:func:`p2p_transport_plain`, the function's definition: a masked ``[W, S,
F]`` send stack through the group's ``all_to_all``.

Not differentiable by itself: ``comm.collectives`` pairs the two directions
(``sign=+1`` the exchange, ``sign=-1`` its transpose) as autograd Functions.
"""

from __future__ import annotations

import ctypes
import dataclasses
import time

import torch
import torch.distributed as dist

from dgraph_tpu_torch.ops import _build
from dgraph_tpu_torch.ops.segment import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_IPC_HANDLE_BYTES = 64


def send_stack(blocks, deltas, W, sign, me, mask) -> torch.Tensor:
    """``[W, S, F]``: tile k (times its mask rows) at row ``(me +
    sign*deltas[k]) % W``, zeros elsewhere."""
    n, S, F = blocks.shape
    if mask is not None:
        blocks = blocks * mask[..., None].to(blocks.dtype)
    stack = blocks.new_zeros((W, S, F))
    rows = torch.tensor([(me + sign * d) % W for d in deltas], device=blocks.device)
    return stack.index_copy(0, rows, blocks)


def all_to_all(send: torch.Tensor, group) -> torch.Tensor:
    """The group's ``all_to_all`` of a ``[W, ...]`` stack (block ``p`` to
    rank ``p``; block ``p`` of the result from rank ``p``). On a gloo group
    a CUDA payload is copied to the host and back (ranks sharing a card)."""
    from dgraph_tpu_torch.comm.dist import log_staged_once

    staged = group.staged(send)
    if staged:
        log_staged_once("all_to_all")
    src = send.cpu() if staged else send.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group.pg)
    return out.to(send.device) if staged else out


def p2p_transport_plain(blocks, deltas, W, S, *, sign=1, mask=None, group) -> torch.Tensor:
    """Plain version of :func:`p2p_transport` (``pallas_p2p.py:228-231``):
    the masked send stack through the group's ``all_to_all``."""
    send = send_stack(blocks, deltas, W, sign, group.rank, mask)
    return all_to_all(send, group).reshape(W * S, -1)


@dataclasses.dataclass
class Landing:
    """One symmetric landing buffer: this rank's ``[rows, F]`` tensor and
    every rank's buffer as a device pointer and as a tensor (``peers[me]``
    is ``own``; the others are this process's IPC mappings)."""

    own: torch.Tensor
    ptrs: list
    peers: list


_landings: dict = {}


class _CudaArray:
    """A device pointer as ``__cuda_array_interface__`` (torch.as_tensor
    maps it without a copy; bf16 goes as int16 and is viewed back)."""

    def __init__(self, ptr: int, shape: tuple, dtype: torch.dtype):
        self.__cuda_array_interface__ = {
            "shape": shape, "typestr": "<f4" if dtype == torch.float32 else "<i2",
            "data": (ptr, False), "version": 2, "strides": None,
        }


def _as_tensor(ptr: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    t = torch.as_tensor(_CudaArray(ptr, shape, dtype))
    return t if dtype == torch.float32 else t.view(dtype)


def landing_buffer(group, rows: int, F: int, dtype: torch.dtype, sign: int) -> Landing:
    """The rank's landing buffer for ``(rows, F, dtype, sign)``, allocated
    and mapped by every rank of ``group`` at its first use (a collective
    call: the ranks reach it in the same order)."""
    key = (id(group.host_pg), rows, F, dtype, sign)
    land = _landings.get(key)
    if land is not None:
        return land
    lib = _build.load("p2p_transport")
    dev = group.device.index
    ptr = ctypes.c_void_p()
    nbytes = rows * F * torch.tensor([], dtype=dtype).element_size()
    _build.check(lib.dg_p2p_malloc(dev, nbytes, ctypes.byref(ptr)), "cudaMalloc landing buffer")
    handle = ctypes.create_string_buffer(_IPC_HANDLE_BYTES)
    _build.check(lib.dg_p2p_ipc_handle(dev, ptr, handle), "cudaIpcGetMemHandle")
    handles = group.all_gather_object(handle.raw)
    ptrs = []
    for r, h in enumerate(handles):
        if r == group.rank:
            ptrs.append(ptr.value)
            continue
        peer = ctypes.c_void_p()
        rc = lib.dg_p2p_ipc_open(dev, h, ctypes.byref(peer))
        if rc != 0:
            raise RuntimeError(
                f"CUDA IPC is not available: rank {group.rank} could not map rank {r}'s "
                f"landing buffer (cudaIpcOpenMemHandle error {rc}); the pallas_p2p "
                "lowering needs the ranks' processes to share their cards' memory")
        ptrs.append(peer.value)
    peers = [_as_tensor(p, (rows, F), dtype) for p in ptrs]
    land = Landing(own=peers[group.rank], ptrs=ptrs, peers=peers)
    _landings[key] = land
    return land


def _check(blocks, deltas, W, S, mask, group):
    if blocks.dim() != 3 or blocks.shape[0] != len(deltas) or blocks.shape[1] != S:
        raise ValueError(f"blocks must be [{len(deltas)}, {S}, F], got {tuple(blocks.shape)}")
    if mask is not None and (mask.shape != blocks.shape[:2] or mask.device != blocks.device):
        raise ValueError(f"mask must be [{len(deltas)}, {S}] on {blocks.device}")
    if group.world_size != W:
        raise ValueError(f"W={W} but the group has {group.world_size} ranks")


def p2p_transport(
    blocks: torch.Tensor,  # [n, S, F] send tiles, one per live delta
    deltas: tuple,  # the plan's live rank offsets (EdgePlan.halo_deltas)
    W: int,
    S: int,
    *,
    sign: int = 1,  # +1: tile k -> (me + deltas[k]) % W; -1: its transpose
    mask=None,  # [n, S] f32 send mask, or None (tiles already masked)
    group,  # comm.dist.RankGroup
) -> torch.Tensor:
    """``[W*S, F]`` halo buffer of this rank (see the module docstring).
    Counts its launches in ``p2p_transport.launches`` and adds the host
    seconds of each launched call, barrier to barrier, to
    ``p2p_transport.wall_s``."""
    _check(blocks, deltas, W, S, mask, group)
    if blocks.device.type == "cpu":
        return p2p_transport_plain(blocks, deltas, W, S, sign=sign, mask=mask, group=group)
    if blocks.device.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for device {blocks.device}")
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"the transport kernel takes float32 or bfloat16, got {blocks.dtype}")
    blocks = blocks.contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    land = landing_buffer(group, W * S, blocks.shape[2], blocks.dtype, sign)
    t0 = time.perf_counter()
    land.own.zero_()
    torch.cuda.synchronize(blocks.device)
    group.barrier()
    launch_puts(blocks, deltas, W, S, sign, mask, group, land)
    p2p_transport.launches += 1
    torch.cuda.synchronize(blocks.device)
    group.barrier()
    p2p_transport.wall_s += time.perf_counter() - t0
    return land.own.clone()


def launch_puts(blocks, deltas, W, S, sign, mask, group, land: Landing) -> None:
    """Only the kernel launch of :func:`p2p_transport`, on the current
    stream, with no synchronisation and no count (``chip_smoke.py`` times
    the kernel with it): contiguous ``blocks`` and an f32 contiguous
    ``mask`` or None, into ``land``'s peers."""
    n, _, F = blocks.shape
    me, esize = group.rank, blocks.element_size()
    dests = (ctypes.c_void_p * n)(*[land.ptrs[(me + sign * d) % W] + me * S * F * esize
                                    for d in deltas])
    # the vector path once per launch: rows of whole 16-byte vectors and
    # aligned blocks (the landing buffers are 256-byte aligned)
    vec = (F * esize) % 16 == 0 and blocks.data_ptr() % 16 == 0
    rc = _build.load("p2p_transport").dg_p2p_transport(
        blocks.device.index, blocks.data_ptr(), None if mask is None else mask.data_ptr(),
        dests, n, S, F, _DTYPES[blocks.dtype], int(vec),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(rc, "dg_p2p_transport")


p2p_transport.launches = 0
p2p_transport.wall_s = 0.0

KERNELS = {
    "p2p_transport": Kernel(p2p_transport, p2p_transport_plain,
                            "dgraph_tpu/ops/pallas_p2p.py:102",
                            "dgraph_tpu_torch/csrc/p2p_transport.cu"),
}
