"""Kernel 5, the one-sided halo transport, and kernel 6, its fault-seeded
copy: their wrappers, plain versions, symmetric landing buffers, and the
put protocol as data a verifier can read.

Counterpart of ``dgraph_tpu/ops/pallas_p2p.py`` (``_transport_kernel`` :102,
public ``p2p_transport`` :217). :func:`p2p_transport` delivers tile ``k`` of
``blocks [n, S, F]`` (times ``mask[k]`` per row, when given) into rank
``(me + sign*deltas[k]) % W``'s ``[W*S, F]`` halo buffer at rows
``[me*S, (me+1)*S)`` and returns this rank's buffer: rows ``[p*S, (p+1)*S)``
hold what peer ``p`` put, rows no put reaches are 0 — the layout and values
of the ``all_to_all`` lowering.

On a CUDA tensor it launches ``csrc/p2p_transport.cu``, whose stores land in
the peers' buffers through CUDA IPC, and runs :data:`PROTOCOL`, the host
steps that stand where the TPU kernel waits on semaphores inside the kernel:

1. ``zero`` this rank's landing buffer;
2. ``sync`` the card (the buffer's last clone is done, the zeros are down);
3. ``barrier`` (host): every peer's buffer is ready;
4. ``put``: launch the kernel;
5. ``sync`` the card: this rank's puts have landed;
6. ``barrier``: every rank's puts have landed;
7. ``read``: return a clone of the buffer (the next call reuses it;
   autograd keeps the output).

No kernel waits on another process: ranks that share a card time-slice it.
The landing buffers come from ``cudaMalloc`` in the source (an IPC handle
covers a whole allocation, and PyTorch's caching allocator shares them
between tensors), one per (rows, F, dtype, direction), exchanged once over
the group's host process group and kept for the life of the process. On a
CPU tensor the wrapper runs :func:`p2p_transport_plain`, the function's
definition: a masked ``[W, S, F]`` send stack through the group's
``all_to_all``. Where every tile lands is :func:`put_destinations`, which
the launch and ``analysis.kernel`` both call.

Kernel 6 (:func:`p2p_transport_mutant`, the counterpart of the fault-seeded
copy of kernel 5 in ``dgraph_tpu/analysis/kernel.py:569``) runs the same
protocol and computes its destinations inside the kernel from the peers'
base pointers, with one seeded fault (:data:`MUTATIONS`): ``bad_dst_row``
puts tile k at the rows of its source rank ``(me - sign*deltas[k]) % W``
instead of ``me``; ``oversize`` stores ``S + 1`` rows a tile (the extra row
repeats the tile's row 0), into a landing buffer with one guard slot of S
rows. ``None`` is kernel 5, bit for bit. The verifier's landing check is its
caller (``analysis.kernel.audit_landing``).

Inside :func:`record_transports` (entered by ``analysis`` and the tests
only) every call also appends a :class:`TransportRecord`: the steps in the
order run and the destinations over symbolic bases. It observes and changes
nothing: on a CUDA tensor the steps run as always, on a CPU tensor the
value is still the plain version's.

Kernel 5 also moves ``uint8`` tiles, with ``mask=None`` only (a mask with
them raises): the wire codecs' encoded payloads (``[n, S, F+4]`` under
fp8), pre-masked before encoding, moved as bytes (``collectives.py:336-343``
of the reference, whose kernel is dtype-generic). Kernel 6 stays f32 and
bf16.

Not differentiable by itself: ``comm.collectives`` pairs the two directions
(``sign=+1`` the exchange, ``sign=-1`` its transpose) as autograd Functions.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import time
from typing import Optional

import torch
import torch.distributed as dist

from dgraph_tpu_torch.ops import _build
from dgraph_tpu_torch.ops.segment import Kernel

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
# kernel 6's types (no byte tiles)
_MUTANT_DTYPES = (torch.float32, torch.bfloat16)
_TYPESTR = {torch.float32: "<f4", torch.bfloat16: "<i2", torch.uint8: "|u1"}
_IPC_HANDLE_BYTES = 64

PROTOCOL = ("zero", "sync", "barrier", "put", "sync", "barrier", "read")

# kernel 6's seeded faults and their codes in csrc/p2p_transport.cu
MUTATIONS = {None: 0, "bad_dst_row": 1, "oversize": 2}


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


# --- where the puts land ---------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PeerAddress:
    """A symbolic byte address: ``offset`` bytes into rank ``rank``'s
    landing buffer. Adding an int moves the offset, so
    :func:`put_destinations` maps these as it maps device pointers."""

    rank: int
    offset: int = 0

    def __add__(self, nbytes: int) -> "PeerAddress":
        return PeerAddress(self.rank, self.offset + nbytes)


def put_destinations(bases, deltas, W, S, F, esize, me, sign, mutation=None) -> list:
    """Where tile k's first row lands: ``bases[(me + sign*deltas[k]) % W]``
    plus ``me*S`` rows of ``F`` elements of ``esize`` bytes — the reference's
    ``me*S`` landing slot (``pallas_p2p.py:252-254``). ``bases`` are device
    pointers (kernel 5's launch) or :class:`PeerAddress` (the verifier, the
    plain versions). ``mutation="bad_dst_row"`` gives kernel 6's seeded
    fault: the slot of the source rank ``(me - sign*deltas[k]) % W``."""
    out = []
    for d in deltas:
        slot = (me - sign * d) % W if mutation == "bad_dst_row" else me
        out.append(bases[(me + sign * d) % W] + slot * S * F * esize)
    return out


def put_rows(S: int, mutation=None) -> int:
    """Rows each put stores: S, or S + 1 for kernel 6's ``oversize``."""
    return S + 1 if mutation == "oversize" else S


def landing_rows(W: int, S: int, guard: bool) -> int:
    """Rows of a landing buffer: the ``[W*S, F]`` halo buffer, plus one
    guard slot of S rows when ``guard``."""
    return (W + int(guard)) * S


# --- the recorder ----------------------------------------------------------


@dataclasses.dataclass
class TransportRecord:
    """One transport call as the verifier reads it: the kernel
    (``p2p_transport`` or ``p2p_transport_mutant`` with its ``mutation``),
    the call's shape, the protocol's steps in the order run, each put's
    destination over symbolic bases (:class:`PeerAddress`), the elements
    each put stores and the rows of the landing buffer."""

    kernel: str
    mutation: Optional[str]
    rank: int
    world_size: int
    deltas: tuple
    sign: int
    S: int
    F: int
    esize: int
    steps: list
    dests: list
    extent: int
    buffer_rows: int


_logs: list = []


@contextlib.contextmanager
def record_transports():
    """``with record_transports() as log:`` appends a
    :class:`TransportRecord` to ``log`` for every transport call in the
    block (``analysis.kernel`` and the tests enter it)."""
    log: list = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def transport_record(kernel, mutation, *, rank, W, S, F, esize, deltas, sign,
                     guard) -> TransportRecord:
    """The :class:`TransportRecord` of one call, its steps still empty: its
    destinations are :func:`put_destinations` over :class:`PeerAddress`
    bases, with the call's ``mutation``."""
    return TransportRecord(
        kernel=kernel, mutation=mutation, rank=rank, world_size=W, deltas=tuple(deltas),
        sign=sign, S=S, F=F, esize=esize, steps=[],
        dests=put_destinations([PeerAddress(p) for p in range(W)], deltas, W, S, F, esize,
                               rank, sign, mutation),
        extent=put_rows(S, mutation) * F, buffer_rows=landing_rows(W, S, guard))


def _new_record(kernel, mutation, blocks, deltas, W, S, sign, group, guard) -> Optional[list]:
    """The step list of a new record in every active log, or None when no
    recorder is active."""
    if not _logs:
        return None
    rec = transport_record(kernel, mutation, rank=group.rank, W=W, S=S, F=blocks.shape[2],
                           esize=blocks.element_size(), deltas=deltas, sign=sign, guard=guard)
    for log in _logs:
        log.append(rec)
    return rec.steps


def run_protocol(steps, executor, log: Optional[list] = None):
    """Run ``steps`` (names of ``executor``'s methods) in order, appending
    each name to ``log`` first; returns the last step's value."""
    out = None
    for step in steps:
        if log is not None:
            log.append(step)
        out = getattr(executor, step)()
    return out


class ObservedSteps:
    """The steps of a call on a CPU tensor, recorded only: nothing runs but
    ``read``, which returns the plain version's value."""

    def __init__(self, value):
        self.value = value

    def zero(self): pass
    def sync(self): pass
    def barrier(self): pass
    def put(self): pass

    def read(self):
        return self.value


# --- the landing buffers ---------------------------------------------------


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
            "shape": shape, "typestr": _TYPESTR[dtype],
            "data": (ptr, False), "version": 2, "strides": None,
        }


def _as_tensor(ptr: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    t = torch.as_tensor(_CudaArray(ptr, shape, dtype))
    return t if t.dtype == dtype else t.view(dtype)


def landing_buffer(group, rows: int, F: int, dtype: torch.dtype, sign: int) -> Landing:
    """The rank's landing buffer for ``(rows, F, dtype, sign)``, allocated
    and mapped by every rank of ``group`` at its first use (a collective
    call: the ranks reach it in the same order). Per graph group: the key,
    the handles' exchange and the peers' order are the graph group's
    (``host_pg``, graph ranks), so each replica group maps only its own W
    buffers."""
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
    # normal tensors even when the first use is under inference_mode (a
    # serving forward): an inference tensor could not be zeroed after it
    with torch.inference_mode(False):
        peers = [_as_tensor(p, (rows, F), dtype) for p in ptrs]
    land = Landing(own=peers[group.rank], ptrs=ptrs, peers=peers)
    _landings[key] = land
    return land


def bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of an f32, bf16 or uint8 tensor, as int32, int16
    or uint8."""
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()])


class _CudaSteps:
    """The protocol's steps on the card. ``zero`` writes the bit pattern
    ``fill_bits`` (0: zeros); the host seconds from ``zero`` to the last
    ``barrier`` go to ``wrapper.wall_s``."""

    def __init__(self, group, land: Landing, launch, wrapper, fill_bits: int):
        self.group, self.land, self.launch = group, land, launch
        self.wrapper, self.fill_bits = wrapper, fill_bits
        self.t0 = self.t1 = None

    def zero(self):
        self.t0 = time.perf_counter()
        if self.fill_bits:
            bits(self.land.own).fill_(self.fill_bits)
        else:
            self.land.own.zero_()

    def sync(self):
        torch.cuda.synchronize(self.land.own.device)

    def barrier(self):
        self.group.barrier()
        self.t1 = time.perf_counter()

    def put(self):
        self.launch()
        self.wrapper.launches += 1
        if self.land.own.dtype == torch.uint8:
            self.wrapper.byte_launches += 1

    def read(self):
        if self.t0 is not None and self.t1 is not None:
            self.wrapper.wall_s += self.t1 - self.t0
        return self.land.own.clone()


def _check(blocks, deltas, W, S, mask, group, mutation=None, kernel="p2p_transport"):
    if kernel != "p2p_transport" and blocks.dtype not in _MUTANT_DTYPES:
        raise TypeError(f"kernel 6 takes float32 or bfloat16 tiles, got {blocks.dtype}")
    if blocks.dtype == torch.uint8 and mask is not None:
        raise ValueError("uint8 tiles are encoded payloads, masked before encoding: "
                         "kernel 5 moves them with mask=None only")
    if mutation not in MUTATIONS:
        raise ValueError(f"mutation must be one of {sorted(MUTATIONS, key=str)}, got {mutation!r}")
    if blocks.dim() != 3 or blocks.shape[0] != len(deltas) or blocks.shape[1] != S:
        raise ValueError(f"blocks must be [{len(deltas)}, {S}, F], got {tuple(blocks.shape)}")
    if mask is not None and (mask.shape != blocks.shape[:2] or mask.device != blocks.device):
        raise ValueError(f"mask must be [{len(deltas)}, {S}] on {blocks.device}")
    if group.world_size != W:
        raise ValueError(f"W={W} but the group has {group.world_size} ranks")


def _check_cuda(blocks):
    if blocks.device.type != "cuda":
        raise RuntimeError(f"no CUDA kernel for device {blocks.device}")
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"the transport kernels take float32, bfloat16 or uint8 tiles, got "
                        f"{blocks.dtype}")


def _transport(blocks, deltas, W, S, sign, mask, group, *, wrapper, mutation, guard,
               fill_bits=0) -> torch.Tensor:
    """One call on the card through :data:`PROTOCOL`: kernel 5
    (``wrapper`` :func:`p2p_transport`) or kernel 6 with ``mutation``, into
    a landing buffer of :func:`landing_rows` rows; returns a clone of it."""
    _check_cuda(blocks)
    blocks = blocks.contiguous()
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
    land = landing_buffer(group, landing_rows(W, S, guard), blocks.shape[2], blocks.dtype, sign)
    if wrapper is p2p_transport:
        launch = lambda: launch_puts(blocks, deltas, W, S, sign, mask, group, land)  # noqa: E731
    else:
        launch = lambda: launch_mutant_puts(  # noqa: E731
            blocks, deltas, W, S, sign, mask, group, land, mutation)
    log = _new_record(wrapper.__name__, mutation, blocks, deltas, W, S, sign, group, guard)
    return run_protocol(PROTOCOL, _CudaSteps(group, land, launch, wrapper, fill_bits), log)


def p2p_transport(
    blocks: torch.Tensor,  # [n, S, F] send tiles, one per live delta
    deltas: tuple,  # the plan's live rank offsets (EdgePlan.halo_deltas)
    W: int,
    S: int,
    *,
    sign: int = 1,  # +1: tile k -> (me + deltas[k]) % W; -1: its transpose
    mask=None,  # [n, S] f32 send mask, or None (tiles already masked; uint8 tiles)
    group,  # comm.dist.RankGroup
) -> torch.Tensor:
    """``[W*S, F]`` halo buffer of this rank (see the module docstring).
    Counts its launches in ``p2p_transport.launches`` (those on uint8 tiles
    also in ``p2p_transport.byte_launches``) and adds the host seconds of
    each launched call, barrier to barrier, to ``p2p_transport.wall_s``."""
    _check(blocks, deltas, W, S, mask, group)
    if blocks.device.type == "cpu":
        out = p2p_transport_plain(blocks, deltas, W, S, sign=sign, mask=mask, group=group)
        log = _new_record("p2p_transport", None, blocks, deltas, W, S, sign, group, False)
        return out if log is None else run_protocol(PROTOCOL, ObservedSteps(out), log)
    return _transport(blocks, deltas, W, S, sign, mask, group, wrapper=p2p_transport,
                      mutation=None, guard=False)


def _vec_ok(blocks) -> bool:
    """The vector path, chosen once per launch: rows of whole 16-byte
    vectors (uint8 tiles: a tile's whole run, which puts every tile and
    destination on a 16-byte boundary) and aligned blocks (the landing
    buffers are 256-byte aligned)."""
    n, S, F = blocks.shape
    width = S * F if blocks.dtype == torch.uint8 else F * blocks.element_size()
    return width % 16 == 0 and blocks.data_ptr() % 16 == 0


def launch_puts(blocks, deltas, W, S, sign, mask, group, land: Landing) -> None:
    """Only the kernel launch of :func:`p2p_transport`, on the current
    stream, with no synchronisation and no count (``chip_smoke.py`` times
    the kernel with it): contiguous ``blocks`` and an f32 contiguous
    ``mask`` or None, into ``land``'s peers."""
    n, _, F = blocks.shape
    dests = put_destinations(land.ptrs, deltas, W, S, F, blocks.element_size(), group.rank, sign)
    rc = _build.load("p2p_transport").dg_p2p_transport(
        blocks.device.index, blocks.data_ptr(), None if mask is None else mask.data_ptr(),
        (ctypes.c_void_p * n)(*dests), n, S, F, _DTYPES[blocks.dtype], int(_vec_ok(blocks)),
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(rc, "dg_p2p_transport")


p2p_transport.launches = 0
p2p_transport.byte_launches = 0
p2p_transport.wall_s = 0.0


# --- kernel 6 --------------------------------------------------------------


def p2p_transport_mutant_plain(blocks, deltas, W, S, *, sign=1, mask=None, group,
                               mutation=None, guard=None, fill_bits=0) -> torch.Tensor:
    """Plain version of :func:`p2p_transport_mutant`: this rank's landing
    buffer (:func:`landing_rows` rows; ``guard`` None means a guard slot for
    ``oversize`` only) after every rank wrote its tiles where
    :func:`put_destinations` and :func:`put_rows` say, over the rows that
    start as the bit pattern ``fill_bits``. Each rank sends its writes and a
    written-row flag through the group's ``all_to_all``; senders apply in
    rank order. With ``mutation=None`` and ``fill_bits=0`` this equals
    :func:`p2p_transport_plain` bit for bit. Where two senders write one row
    (the mutants' landings can overlap) the card's result is a race and
    this order is only one of its outcomes."""
    guard = mutation == "oversize" if guard is None else guard
    n, _, F = blocks.shape
    rows, ext = landing_rows(W, S, guard), put_rows(S, mutation)
    if mask is not None:
        blocks = blocks * mask[..., None].to(blocks.dtype)
    tiles = blocks[:, torch.arange(ext, device=blocks.device) % S]
    esize = blocks.element_size()
    send = blocks.new_zeros((W, rows, F + 1))
    dests = put_destinations([PeerAddress(p) for p in range(W)], deltas, W, S, F, esize,
                             group.rank, sign, mutation)
    for k, a in enumerate(dests):
        r0 = a.offset // (F * esize)
        if r0 + ext > rows:
            raise ValueError(f"tile {k} ends at row {r0 + ext} of a {rows}-row landing buffer")
        send[a.rank, r0:r0 + ext, :F] = tiles[k]
        send[a.rank, r0:r0 + ext, F] = 1
    recv = all_to_all(send, group)
    out = torch.full((rows, F), fill_bits, dtype=bits(blocks).dtype,
                     device=blocks.device).view(blocks.dtype)
    for s in range(W):
        hit = recv[s, :, F] != 0
        out[hit] = recv[s, hit, :F]
    return out


def p2p_transport_mutant(
    blocks: torch.Tensor,
    deltas: tuple,
    W: int,
    S: int,
    *,
    sign: int = 1,
    mask=None,
    group,
    mutation: Optional[str] = None,  # a key of MUTATIONS
) -> torch.Tensor:
    """Kernel 6: :func:`p2p_transport` with the destinations computed in
    the kernel and one seeded fault (see the module docstring). Returns
    this rank's landing buffer, ``[W*S, F]``, or ``[(W+1)*S, F]`` with the
    guard slot for ``oversize``. f32 and bf16 tiles only. Counts its
    launches in ``p2p_transport_mutant.launches``."""
    _check(blocks, deltas, W, S, mask, group, mutation, "p2p_transport_mutant")
    guard = mutation == "oversize"
    if blocks.device.type == "cpu":
        out = p2p_transport_mutant_plain(blocks, deltas, W, S, sign=sign, mask=mask,
                                         group=group, mutation=mutation)
        log = _new_record("p2p_transport_mutant", mutation, blocks, deltas, W, S, sign, group,
                          guard)
        return out if log is None else run_protocol(PROTOCOL, ObservedSteps(out), log)
    return _transport(blocks, deltas, W, S, sign, mask, group, wrapper=p2p_transport_mutant,
                      mutation=mutation, guard=guard)


def launch_mutant_puts(blocks, deltas, W, S, sign, mask, group, land: Landing,
                       mutation=None) -> None:
    """Only the kernel launch of :func:`p2p_transport_mutant` (as
    :func:`launch_puts`): the kernel takes the peers' base pointers, this
    rank, W, S, sign and the deltas, and computes the destinations."""
    n, _, F = blocks.shape
    rc = _build.load("p2p_transport").dg_p2p_transport_mutant(
        blocks.data_ptr(), None if mask is None else mask.data_ptr(),
        (ctypes.c_void_p * W)(*land.ptrs), (ctypes.c_int * n)(*deltas), n, group.rank, W, S,
        F, sign, _DTYPES[blocks.dtype], int(_vec_ok(blocks)), MUTATIONS[mutation],
        torch.cuda.current_stream(blocks.device).cuda_stream,
    )
    _build.check(rc, "dg_p2p_transport_mutant")


p2p_transport_mutant.launches = 0
p2p_transport_mutant.wall_s = 0.0


def land_tiles(blocks, deltas, W, S, *, sign=1, mask=None, group, kernel="p2p_transport",
               mutation=None, fill_bits=0) -> torch.Tensor:
    """This rank's whole landing buffer, guard slot included (``[(W+1)*S,
    F]``), after one transport whose ``zero`` step writes the bit pattern
    ``fill_bits``: what the landing check reads. On a CUDA tensor kernel 5
    (``kernel="p2p_transport"``) or kernel 6 (``"p2p_transport_mutant"``
    with ``mutation``) runs through :data:`PROTOCOL`; on a CPU tensor the
    plain version of kernel 6 (kernel 5's placement is its ``None``)."""
    _check(blocks, deltas, W, S, mask, group, mutation, kernel)
    if kernel == "p2p_transport" and mutation is not None:
        raise ValueError("kernel 5 has no seeded fault; use kernel='p2p_transport_mutant'")
    if blocks.device.type == "cpu":
        return p2p_transport_mutant_plain(blocks, deltas, W, S, sign=sign, mask=mask,
                                          group=group, mutation=mutation, guard=True,
                                          fill_bits=fill_bits)
    wrapper = {"p2p_transport": p2p_transport,
               "p2p_transport_mutant": p2p_transport_mutant}[kernel]
    return _transport(blocks, deltas, W, S, sign, mask, group, wrapper=wrapper,
                      mutation=mutation, guard=True, fill_bits=fill_bits)


KERNELS = {
    "p2p_transport": Kernel(p2p_transport, p2p_transport_plain,
                            "dgraph_tpu/ops/pallas_p2p.py:102",
                            "dgraph_tpu_torch/csrc/p2p_transport.cu"),
    "p2p_transport_mutant": Kernel(p2p_transport_mutant, p2p_transport_mutant_plain,
                                   "dgraph_tpu/analysis/kernel.py:569",
                                   "dgraph_tpu_torch/csrc/p2p_transport.cu"),
}
