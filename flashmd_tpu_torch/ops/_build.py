"""Build and load the CUDA kernels of ``flashmd_tpu_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per
source, all started together) and links them into one shared library with
a plain C interface, which ``ctypes`` loads. The library lands in
``flashmd_tpu_torch/_build/`` under a name keyed by a hash over all the
sources and the ``csrc/*.cuh`` headers they include, so an edited source or
header is rebuilt and an unchanged set is reused.
Nothing here runs at import: the first CUDA launch builds and loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # pos, x, c, w0, w_lin, cell, inv, out, S, A, F, M, rcut, d_min, tier,
    # stream
    "cheb_fwd": [_P] * 8 + [_I] * 4 + [_F, _F, _I, _P],
    # pos, g, q, w0, w_lin, cell, inv, gx, S, A, F, M, rcut, d_min, tier,
    # stream
    "cheb_bwd_gx": [_P] * 8 + [_I] * 4 + [_F, _F, _I, _P],
    # pos, x, g, c2, cell, inv, row_part, col_part, gpos, S, A, F, M,
    # n_slabs, rcut, d_min, tier, stream
    "cheb_bwd_gd": [_P] * 9 + [_I] * 5 + [_F, _F, _I, _P],
    # pos, x, g, q, c2, w0, w_lin, cell, inv, gx, row_part, col_part, gpos,
    # S, A, F, MQ, M2, n_slabs, rcut, d_min, tier, stream
    "cheb_bwd_gxgd": [_P] * 13 + [_I] * 6 + [_F, _F, _I, _P],
    # pos, x, w0, b0, w1, offset, coeff, out, S, A, F, R, rcut, bf16, stream
    "dense_cfconv_fwd": [_P] * 8 + [_I] * 4 + [_F, _I, _P],
    # pos, x, g, w0, b0, w1, offset, coeff, gd, gpos, gx, S, A, F, R, rcut,
    # bf16, stream
    "dense_cfconv_bwd": [_P] * 11 + [_I] * 4 + [_F, _I, _P],
    "dense_cfconv_smem_bytes": [_I],
    # pos, idx, mask, x, w0, b0, w1, offset, coeff, out, S, A, K, F, R,
    # rcut, bf16, stream
    "cfconv_fwd": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    # pos, idx, mask, csr_offsets, csr_slots, x, g, w0, b0, w1, offset,
    # coeff, gd, wbuf, gpos, gx, S, A, K, F, R, rcut, bf16, stream
    "cfconv_bwd": [_P] * 16 + [_I] * 5 + [_F, _I, _P],
    "cfconv_smem_bytes": [_I],
    # nbr, pos, idx, mask, x, w0, w0t, b0, w1, w1t, offset, coeff, out, ws,
    # S, A, K, Fp, R, Rq, rcut, bf16, stream
    "cfconv_general_fwd": [_I] + [_P] * 13 + [_I] * 6 + [_F, _I, _P],
    # nbr, pos, idx, mask, csr_offsets, csr_slots, x, g, w0, w0t, b0, w1,
    # w1t, offset, coeff, gd, gpos, gx, ws, S, A, K, Fp, R, Rq, rcut, bf16,
    # stream
    "cfconv_general_bwd": [_I] + [_P] * 18 + [_I] * 6 + [_F, _I, _P],
    "cfconv_general_ws_floats": [_I] * 2,
    # kind, Fp, R, Rq
    "cfconv_general_layout": [_I] * 4,
    # kind, Fp, R, Rq
    "cfconv_general_warps": [_I] * 4,
    # Fq, Rq
    "cfconv_general_mma_layout": [_I] * 2,
    # kind, Fq, Rq
    "cfconv_general_mma_warps": [_I] * 3,
}

_loaded: dict = {}


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


@functools.cache
def library_path() -> Path:
    """The library's path, keyed by the sources as this process first
    reads them (hashed once: every wrapper call looks the library up)."""
    h = hashlib.sha256()
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libflashmd_kernels_{h.hexdigest()[:12]}.so"


def _run_all(cmds):
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}"
            )
    return "".join(logs)


def build(ptxas_verbose: bool = False) -> dict:
    """Compile the kernels; returns {"path", "seconds", "log"}.

    ``ptxas_verbose`` adds ``-Xptxas -v`` (registers, shared memory and
    spills per kernel, in ``log``) and always recompiles."""
    out = library_path()
    if out.exists() and not ptxas_verbose:
        return {"path": out, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if ptxas_verbose else []
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    t0 = time.perf_counter()
    log = _run_all([
        [nvcc, *extra, *_FLAGS, "-c", "-o", str(obj), str(src)]
        for src, obj in zip(sources(), objs)
    ])
    tmp = out.with_suffix(f".{tag}")
    log += _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return {"path": out, "seconds": seconds, "log": log}


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
