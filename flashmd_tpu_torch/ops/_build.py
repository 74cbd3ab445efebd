"""Build and load the CUDA kernels of ``flashmd_tpu_torch/csrc``.

``nvcc`` compiles ``csrc/cheb_kernels.cu`` for ``sm_90a`` into a shared
library with a plain C interface, which ``ctypes`` loads. The library
lands in ``flashmd_tpu_torch/_build/`` under a name keyed by the source's
hash, so an edited source is rebuilt and an unchanged one is reused.
Nothing here runs at import: the first CUDA launch builds and loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "cheb_kernels.cu"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pos, x, c, w0, w_lin, out, S, A, F, M, rcut, d_min, bf16, stream
    "cheb_fwd": [_P] * 6 + [_I] * 4 + [_F, _F, _I, _P],
    # pos, g, q, w0, w_lin, gx, S, A, F, M, rcut, d_min, bf16, stream
    "cheb_bwd_gx": [_P] * 6 + [_I] * 4 + [_F, _F, _I, _P],
    # pos, x, g, c2, row_part, col_part, gpos, S, A, F, M, rcut, d_min,
    # bf16, stream
    "cheb_bwd_gd": [_P] * 7 + [_I] * 4 + [_F, _F, _I, _P],
    "cheb_gd_tiles": [_I],
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libcheb_kernels_{digest}.so"


def build(ptxas_verbose: bool = False) -> dict:
    """Compile the kernels; returns {"path", "seconds", "log"}.

    ``ptxas_verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel, in ``log``) and always recompiles."""
    out = library_path()
    if out.exists() and not ptxas_verbose:
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", str(tmp), str(SOURCE),
    ]
    if ptxas_verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": proc.stdout + proc.stderr}


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    path = library_path()
    lib = _loaded.get(path)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[path] = lib
    return lib
