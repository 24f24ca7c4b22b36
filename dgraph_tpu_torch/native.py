"""ctypes loader for the native host toolkit (``csrc/dgraph_host.cpp``).

The port's copy of ``dgraph_tpu/native.py``'s loader and wrappers over its
own copy of the C++ source. At first use ``g++`` (``$CXX`` if set) builds
the source with the reference Makefile's flags into
``dgraph_tpu_torch/_build/``, under a name keyed by a hash of the source,
the compiler and the flags, so an edited source never reuses a stale
library. Every caller keeps a pure-numpy fallback; :func:`available` gates
the dispatch. Only the partition entry points are bound: the source's
native plan build (``plan_core_*``) is not used by the port.

Ranks of one launch partition the same graph each on its own, so they must
all load the same library: the build holds an exclusive file lock, writes
to a temporary name and renames it into place. A process that waits on the
lock finds the finished library and loads it; none sees half a file.

    python -m dgraph_tpu_torch.native     # build, print the library's path
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent
SOURCE = PACKAGE_DIR / "csrc" / "dgraph_host.cpp"
BUILD_DIR = PACKAGE_DIR / "_build"
# csrc/Makefile's CXXFLAGS
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_build_failed = False
build_error = ""  # why the last build or load failed ("" when it did not)


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    """Where the source builds to, keyed by its bytes, the compiler and the flags."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((compiler(), *CXX_FLAGS)).encode())
    return BUILD_DIR / f"libdgraph_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path. Holds an
    exclusive lock on ``BUILD_DIR/dgraph_host.lock`` while it builds, and
    renames the finished file into place. Raises with the compiler's
    output on failure."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "dgraph_host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():  # another process may have built it while we waited
            tmp = out.with_suffix(f".tmp{os.getpid()}.so")
            proc = subprocess.run([compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"{compiler()} failed on {SOURCE.name} "
                                   f"(rc {proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    c = ctypes
    sigs = {
        "greedy_bfs_partition": (
            (i64p, i64p, c.c_int64, c.c_int64, c.c_int32, c.c_uint64, i32p), None),
        "multilevel_partition_c": (
            (i64p, i64p, c.c_int64, c.c_int64, c.c_int32, c.c_uint64, i32p), None),
        "unique_encoded_pairs": ((i64p, i64p, c.c_int64, c.c_int64, i64p), c.c_int64),
        "multilevel_partition_w_c": (
            (i64p, i64p, i64p, c.c_int64, i64p, c.c_int64, c.c_int32, c.c_uint64, i32p),
            None),
        "multilevel_partition_vw_c": (
            (i64p, i64p, c.c_int64, i64p, c.c_int64, c.c_int32, c.c_uint64, i32p), None),
        "cluster_coarsen_c": (
            (i64p, i64p, c.c_int64, c.c_int64, c.c_int64, c.c_uint64, i64p), c.c_int64),
        # int status: 0 ok, -1 the int32 CSR id bound refused
        "refine_unweighted_csr_c": (
            (i64p, i64p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_double, i32p),
            c.c_int32),
        "refine_weighted_csr_c": (
            (i64p, i64p, c.c_int64, c.c_int64, c.c_int32, c.c_int32, c.c_double, i64p,
             i32p), c.c_int32),
        "edge_cut_count": ((i64p, i64p, c.c_int64, i32p), c.c_int64),
    }
    for name, (argtypes, restype) in sigs.items():
        f = getattr(lib, name)
        f.argtypes = list(argtypes)
        f.restype = restype


def _load():
    global _lib, _build_failed, build_error
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _bind(lib)
        except Exception as e:  # noqa: BLE001 - every caller has a numpy fallback
            build_error = f"{type(e).__name__}: {e}"
            _build_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise():
    lib = _load()
    assert lib is not None, "native library unavailable"
    return lib


def greedy_bfs_partition(
    edge_index: np.ndarray, num_nodes: int, world_size: int, seed: int = 0
) -> np.ndarray:
    lib = _lib_or_raise()
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    out = np.empty(num_nodes, np.int32)
    lib.greedy_bfs_partition(src, dst, len(src), num_nodes, world_size, seed, out)
    return out


def multilevel_partition(
    edge_index: np.ndarray, num_nodes: int, world_size: int, seed: int = 0
) -> np.ndarray:
    """METIS-shaped multilevel k-way partition: heavy-edge-matching
    coarsening, weighted greedy initial partition, boundary (FM-lite)
    refinement per uncoarsening level."""
    lib = _lib_or_raise()
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    out = np.empty(num_nodes, np.int32)
    lib.multilevel_partition_c(src, dst, len(src), num_nodes, world_size, seed, out)
    return out


def cluster_coarsen(
    edge_index: np.ndarray, num_nodes: int, max_cluster_weight: int, seed: int = 0,
) -> tuple[np.ndarray, int]:
    """Capped greedy cluster coarsening: (cmap[V] int64 cluster ids,
    num_clusters)."""
    lib = _lib_or_raise()
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    cmap = np.empty(num_nodes, np.int64)
    nc = lib.cluster_coarsen_c(src, dst, len(src), num_nodes, max_cluster_weight, seed, cmap)
    if nc < 0:
        raise ValueError(
            f"cluster_coarsen: {num_nodes} vertices exceed the int32 CSR id bound (2^31-1)")
    return cmap, int(nc)


def multilevel_partition_weighted(
    pair_src: np.ndarray, pair_dst: np.ndarray, pair_w: np.ndarray,
    vertex_w: np.ndarray, num_vertices: int, world_size: int, seed: int = 0,
) -> np.ndarray:
    """Multilevel k-way partition of a weighted graph given as unique
    undirected pairs (u < v) and their weights, balancing summed vertex
    weight."""
    lib = _lib_or_raise()
    out = np.empty(num_vertices, np.int32)
    lib.multilevel_partition_w_c(
        np.ascontiguousarray(pair_src, np.int64), np.ascontiguousarray(pair_dst, np.int64),
        np.ascontiguousarray(pair_w, np.int64), len(pair_src),
        np.ascontiguousarray(vertex_w, np.int64), num_vertices, world_size, seed, out,
    )
    return out


def multilevel_partition_vertex_weighted(
    edge_index: np.ndarray, vertex_w: np.ndarray, num_nodes: int,
    world_size: int, seed: int = 0,
) -> np.ndarray:
    """Multilevel k-way partition of a raw edge list balancing summed
    caller vertex weights (e.g. 1 + alpha * degree to co-balance edges)."""
    lib = _lib_or_raise()
    out = np.empty(num_nodes, np.int32)
    lib.multilevel_partition_vw_c(
        np.ascontiguousarray(edge_index[0], np.int64),
        np.ascontiguousarray(edge_index[1], np.int64), edge_index.shape[1],
        np.ascontiguousarray(vertex_w, np.int64), num_nodes, world_size, seed, out,
    )
    return out


def _check_refine(name: str, num_nodes: int) -> None:
    # the C side would refuse (status -1): fail before the call
    if num_nodes >= 2**31 - 1:
        raise ValueError(
            f"{name}: {num_nodes} vertices exceed the int32 CSR id bound (2^31-1)")


def _refine_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}_c returned status {status} (int32 CSR id bound "
                           "refused); partition left unrefined")


def refine_unweighted_csr(
    edge_index: np.ndarray, num_nodes: int, world_size: int,
    part: np.ndarray, passes: int = 3, imbalance: float = 1.03,
) -> np.ndarray:
    """Greedy boundary refinement on the fine graph (unit weights, one
    int32 CSR). Returns ``part`` (modified in place when it was already a
    contiguous int32 array)."""
    lib = _lib_or_raise()
    _check_refine("refine_unweighted_csr", num_nodes)
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    part = np.ascontiguousarray(part, np.int32)
    _refine_status("refine_unweighted_csr", lib.refine_unweighted_csr_c(
        src, dst, len(src), num_nodes, world_size, passes, imbalance, part))
    return part


def refine_weighted_csr(
    edge_index: np.ndarray, vertex_w: np.ndarray, num_nodes: int,
    world_size: int, part: np.ndarray, passes: int = 3, imbalance: float = 1.03,
) -> np.ndarray:
    """Greedy boundary refinement with a summed vertex-weight balance cap
    (the cut gain stays in unit edge counts)."""
    lib = _lib_or_raise()
    _check_refine("refine_weighted_csr", num_nodes)
    part = np.ascontiguousarray(part, np.int32)
    _refine_status("refine_weighted_csr", lib.refine_weighted_csr_c(
        np.ascontiguousarray(edge_index[0], np.int64),
        np.ascontiguousarray(edge_index[1], np.int64), edge_index.shape[1], num_nodes,
        world_size, passes, imbalance, np.ascontiguousarray(vertex_w, np.int64), part))
    return part


def unique_encoded_pairs(keys: np.ndarray, vals: np.ndarray, stride: int) -> np.ndarray:
    lib = _lib_or_raise()
    keys = np.ascontiguousarray(keys, np.int64)
    vals = np.ascontiguousarray(vals, np.int64)
    out = np.empty(len(keys), np.int64)
    m = lib.unique_encoded_pairs(keys, vals, len(keys), stride, out)
    return out[:m]


def edge_cut_count(edge_index: np.ndarray, partition: np.ndarray) -> int:
    lib = _lib_or_raise()
    src = np.ascontiguousarray(edge_index[0], np.int64)
    dst = np.ascontiguousarray(edge_index[1], np.int64)
    part = np.ascontiguousarray(partition, np.int32)
    return int(lib.edge_cut_count(src, dst, len(src), part))


if __name__ == "__main__":
    print(build())
