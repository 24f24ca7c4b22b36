"""Build and bind the CUDA kernels of ``dgraph_tpu_torch/csrc``.

Each source has a plain C interface. At first use it is compiled by ``nvcc``
for ``sm_90a`` into a shared library under ``dgraph_tpu_torch/_build/`` (git
ignores it), named by a hash of the source and the flags so an edited source
never reuses a stale build, and loaded with ``ctypes``. Nothing here runs at
import time: a machine without ``nvcc`` can import every module, and only a
launch on a CUDA tensor builds.

    python -m dgraph_tpu_torch.ops._build     # build every source, print the times
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# one shared library per source, all built by one nvcc each
SOURCES = {"sorted_segment": "sorted_segment.cu"}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / spills per kernel, kept in the build log
)

_c = ctypes
# argtypes of every exported function: c_void_p for each pointer and the
# stream (a bare int argument would be cut to 32 bits)
SIGNATURES = {
    "sorted_segment": {
        "dg_sorted_segment_sum": (
            _c.c_void_p, _c.c_longlong, _c.c_void_p, _c.c_void_p, _c.c_longlong,
            _c.c_int, _c.c_int, _c.c_int, _c.c_int, _c.c_void_p,
        ),
        "dg_sorted_segment_sum_bias_relu": (
            _c.c_void_p, _c.c_longlong, _c.c_void_p, _c.c_longlong, _c.c_void_p,
            _c.c_void_p, _c.c_void_p, _c.c_longlong, _c.c_int, _c.c_int,
            _c.c_int, _c.c_void_p,
        ),
    },
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    """Where source ``name`` builds to: keyed by the source bytes and flags."""
    src = CSRC_DIR / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def nvcc_command(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / SOURCES[name])]


def build(names=None) -> dict:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` per source, all started together. Returns {name: seconds}
    (0.0 for a library already built). Raises with the compiler's log on
    failure."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(nvcc_command(name, tmp), stdout=log, stderr=subprocess.STDOUT)
        started[name] = (proc, tmp, out, log, time.perf_counter())
    times = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, out, log, t0) in started.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            errors.append(f"nvcc failed for {SOURCES[name]} (rc {rc}):\n"
                          + out.with_suffix(".log").read_text()[-4000:])
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def build_log(name: str) -> str:
    """The compiler's output for ``name`` (ptxas register and spill lines)."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The bound library for source ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


if __name__ == "__main__":
    for n, s in build().items():
        print(f"{n}: {s:.1f} s -> {library_path(n)}")
