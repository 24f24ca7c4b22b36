"""On-disk memmap datasets: a directory of ``.npy`` files opened read-only.

The port's copy of ``open_memmap_dataset`` from
``dgraph_tpu/data/memmap.py`` (what ``ogbn.from_npz`` needs for a
directory), with the same ``dgraph_meta.json`` sidecar check. Nothing is
resident until rows are touched.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, Optional

import numpy as np

_META = "dgraph_meta.json"


def open_memmap_dataset(path: str, names: Optional[Iterable[str]] = None) -> dict:
    """Open a directory of ``.npy`` files read-only as memmaps.

    When the :data:`_META` sidecar is present it is the source of truth: it
    names the arrays (when ``names`` is None) and each opened array is
    validated against its recorded shape and dtype, so a half-written or
    overwritten dataset fails at open time instead of as silent garbage
    mid-training.
    """
    meta = {}
    meta_path = os.path.join(path, _META)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    if names is None:
        names = sorted(meta) if meta else [
            f[: -len(".npy")] for f in sorted(os.listdir(path)) if f.endswith(".npy")
        ]
    arrays = {n: np.load(os.path.join(path, n + ".npy"), mmap_mode="r") for n in names}
    for n, arr in arrays.items():
        if n in meta:
            want = (tuple(meta[n]["shape"]), np.dtype(meta[n]["dtype"]))
            got = (arr.shape, arr.dtype)
            if want != got:
                raise ValueError(
                    f"memmap dataset {path!r}: array {n!r} is {got}, but {_META} records {want}"
                )
    return arrays
