"""The host cell-list radius engine (port of flashmd_tpu/native/__init__.py).

The simulation's neighbour search runs on the GPU (ops/neighborlist.py).
This is the host side: sizing the static neighbour capacity before the
first step, and exact pair lists for term lists and analysis, the jobs the
reference gives torch_cluster's C++ extension. ``radius.cpp`` (the port's
own copy of the JAX package's) is compiled with ``g++`` at first use into
``flashmd_tpu_torch/_build/`` under a name keyed by a hash of the source and
the flags, and loaded with ctypes, as ``ops/_build.py`` does for the CUDA
sources.

A failed build raises with the compiler's output; nothing falls back
quietly. The numpy twins (``_counts_numpy``, ``_pairs_numpy``) run only
where the caller asks for them: ``native=False``, or ``FLASHMD_NO_NATIVE=1``
in the environment (the JAX package's switch) when ``native`` is None.
Both give the same integers and the same pairs, in (src, dst) order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "radius.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# No -march=native: the library may be built on one host and loaded on
# another, and without FMA contraction (ISO C++17 turns it off) the squared
# distances round as numpy's do.
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_loaded: dict = {}


def use_native(native: Optional[bool] = None) -> bool:
    """Whether a call takes the C++ engine: ``native`` where given, else
    unless ``FLASHMD_NO_NATIVE=1``."""
    if native is None:
        return os.environ.get("FLASHMD_NO_NATIVE", "0") != "1"
    return bool(native)


@functools.cache
def library_path() -> Path:
    """The library's path, keyed by the source and the flags as this
    process first reads them (hashed once: every call looks it up)."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libflashmd_radius_{h.hexdigest()[:12]}.so"


def build(force: bool = False) -> dict:
    """Compile ``radius.cpp``; returns {"path", "seconds", "log"}. An
    existing library is reused unless ``force``. Raises RuntimeError with
    the compiler's output when ``g++`` fails or is missing."""
    out = library_path()
    if out.exists() and not force:
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the host radius engine cannot be built (set "
            "FLASHMD_NO_NATIVE=1 or pass native=False for the numpy twin)"
        ) from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": out, "seconds": time.perf_counter() - t0,
            "log": proc.stdout + proc.stderr}


def load() -> ctypes.CDLL:
    """The loaded engine (built on first use)."""
    path = library_path()
    with _LOCK:
        lib = _loaded.get(path)
        if lib is not None:
            return lib
        build()
        lib = ctypes.CDLL(str(path))
        i64 = ctypes.c_int64
        pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        pi = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        lib.flashmd_neighbor_counts.restype = i64
        lib.flashmd_neighbor_counts.argtypes = [pd, i64, ctypes.c_double, pi]
        lib.flashmd_neighbor_counts_pbc.restype = i64
        lib.flashmd_neighbor_counts_pbc.argtypes = [
            pd, i64, ctypes.c_double, pd, pi,
        ]
        lib.flashmd_radius_pairs.restype = i64
        lib.flashmd_radius_pairs.argtypes = [
            pd, i64, ctypes.c_double, i64, pi, pi,
        ]
        _loaded[path] = lib
        return lib


def native_available() -> bool:
    """True where calls take the C++ engine (built here if need be); False
    under ``FLASHMD_NO_NATIVE=1``. A failed build raises."""
    return use_native() and load() is not None


def _positions(pos) -> np.ndarray:
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions must be [A, 3], got {pos.shape}")
    return pos


def _counts_numpy(pos, rcut, cell=None) -> np.ndarray:
    dr = pos[None, :, :] - pos[:, None, :]
    if cell is not None:
        frac = dr @ np.linalg.inv(cell)
        frac -= np.round(frac)
        dr = frac @ cell
    d2 = np.einsum("ijk,ijk->ij", dr, dr)
    np.fill_diagonal(d2, np.inf)
    return (d2 < rcut * rcut).sum(axis=1)


def _pairs_numpy(pos, rcut) -> Tuple[np.ndarray, np.ndarray]:
    dr = pos[None, :, :] - pos[:, None, :]
    d2 = np.einsum("ijk,ijk->ij", dr, dr)
    np.fill_diagonal(d2, np.inf)
    i, j = np.nonzero(d2 < rcut * rcut)
    return i.astype(np.int64), j.astype(np.int64)


def neighbor_counts(pos, rcut: float, cell=None,
                    native: Optional[bool] = None) -> np.ndarray:
    """Per-atom neighbour counts at ``rcut`` (exact, float64): the O(A)
    cell list for open boundaries, minimum image under a [3, 3] ``cell``
    (rows are lattice vectors; triclinic supported)."""
    pos = _positions(pos)
    if cell is not None:
        cell = np.ascontiguousarray(cell, dtype=np.float64)
    if not use_native(native):
        return _counts_numpy(pos, rcut, cell)
    lib = load()
    counts = np.zeros(pos.shape[0], dtype=np.int64)
    if cell is None:
        lib.flashmd_neighbor_counts(pos, pos.shape[0], float(rcut), counts)
    elif lib.flashmd_neighbor_counts_pbc(pos, pos.shape[0], float(rcut),
                                         cell, counts) < 0:
        raise ValueError("Singular cell matrix")
    return counts


def max_neighbor_count(pos, rcut: float, cell=None,
                       native: Optional[bool] = None) -> int:
    """Max per-atom neighbour count: sizes the static capacity K."""
    return int(neighbor_counts(pos, rcut, cell, native).max(initial=0))


def radius_pairs(pos, rcut: float, native: Optional[bool] = None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """All directed pairs (src, dst), src != dst, with d < rcut (open
    boundaries), in (src, dst) order: the host analogue of torch_cluster's
    ``radius_graph`` for term lists and analysis."""
    pos = _positions(pos)
    if not use_native(native):
        return _pairs_numpy(pos, rcut)
    lib = load()
    cap = max(64, pos.shape[0] * 64)
    while True:
        src = np.zeros(cap, dtype=np.int64)
        dst = np.zeros(cap, dtype=np.int64)
        m = lib.flashmd_radius_pairs(pos, pos.shape[0], float(rcut), cap,
                                     src, dst)
        if m <= cap:
            break
        cap = int(m)
    src, dst = src[:m], dst[:m]
    order = np.lexsort((dst, src))
    return src[order], dst[order]
