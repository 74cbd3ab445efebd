"""The exact-filter CFConv kernels at every width: the route between the
tuned kernels and the general-width ones, the zero padding that each takes,
and the general-width wrappers with their launch counts.

The tuned kernels (``csrc/cfconv_kernels.cu``, ``csrc/cfconv_dense_kernels.cu``
on ``csrc/cfconv_tile.cuh``) stage w0 and w1 whole in shared memory and lay
their tiles out for F = 128 filters and at most 64 radial functions. The
JAX kernels read F and R from their operands and take any width, so
``ops/cfconv.py`` and ``ops/cfconv_dense.py`` route each CUDA launch by
:func:`route`, a plain function of (F, R, precision):

* F <= 128 and R <= 64: the tuned kernels. Below F = 128 the wrapper pads
  w0's columns, b0, w1's rows and columns and the features of x and g with
  zeros (:func:`tuned_operands`) and slices the outputs back to F. That is
  exact at both tiers: tanh(0) = 0, a zero stays zero under bf16 rounding,
  and zero products add nothing. It runs (R 128 + 128^2) / (R F + F^2) times
  the useful work (3.1x at F 64, R 50).
* any other width: the general-width kernels of
  ``csrc/cfconv_general_kernels.cu`` (:func:`general_fwd`,
  :func:`general_bwd`), register-tiled float32 FMAs on the CUDA cores at
  both tiers, features in chunks of 64 and R in chunks of 64, the weights
  read through the read-only path. They take the weights zero-padded to
  Fp = F rounded up to 64 and Rq = R rounded up to 64, with the
  transposes of w0 and w1 and the bf16 rounding of the weights made here
  (:func:`general_weights`), and x and g padded to Fp.

Each family counts its own launches: the tuned one on the wrappers'
``launches``, the general one here (``dense_cfconv_fwd_general``, ...,
:func:`launch_counts`). There is no fallback: on CUDA tensors every width
launches a kernel or raises.
"""

from __future__ import annotations

import torch

from ..models.mlp import round_bf16
from ._launch import _ptr, _raise_on, _stream

# The widths the tuned kernels take (F and RMAX of csrc/cfconv_tile.cuh).
TUNED_F = 128
TUNED_R_MAX = 64
# Column and radial-function chunks of the general-width kernels (GW_CW,
# GW_RC of csrc/cfconv_general_kernels.cu).
GENERAL_COLUMNS = 64
GENERAL_RBF_CHUNK = 64


def route(f: int, r: int, precision: str) -> tuple:
    """(family, tier) of a CUDA launch at F filters and R radial functions:
    family "tuned" (F <= 128, R <= 64; zero-padded to F = 128) or
    "general"; tier "fp32" or "bf16" (bf16x3 computes these kernels at
    fp32, as the reference does)."""
    family = "tuned" if f <= TUNED_F and r <= TUNED_R_MAX else "general"
    return family, "bf16" if precision == "bf16" else "fp32"


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pad_features(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with its last axis zero-padded to ``n`` (``t`` itself when it
    has that width already)."""
    f = t.shape[-1]
    if f == n:
        return t
    out = t.new_zeros(*t.shape[:-1], n)
    out[..., :f] = t
    return out


def _pad2(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """``w`` [r, c] zero-padded to [rows, cols]."""
    out = w.new_zeros(rows, cols)
    out[:w.shape[0], :w.shape[1]] = w
    return out


def tuned_operands(feats, w0, b0, w1):
    """(feats, w0, b0, w1) zero-padded to the tuned kernels' F = 128: each
    tensor of ``feats`` (x, g) along its features, w0's columns, b0, w1's
    rows and columns. Unchanged at F = 128."""
    if w1.shape[0] == TUNED_F:
        return list(feats), w0, b0, w1
    return ([pad_features(t, TUNED_F) for t in feats],
            pad_features(w0, TUNED_F), pad_features(b0, TUNED_F),
            _pad2(w1, TUNED_F, TUNED_F))


def general_weights(w0, b0, w1, offset, precision):
    """The general-width kernels' weights: w0 [Rq, Fp], its transpose
    [Fp, Rq], b0 [Fp], w1 and its transpose [Fp, Fp] and the offsets [Rq],
    zero-padded (Fp, Rq: F, R rounded up to 64), w0 and w1 rounded to bf16
    at that tier; each float32 and contiguous."""
    r, f = w0.shape
    fp = _round_up(f, GENERAL_COLUMNS)
    rq = _round_up(r, GENERAL_RBF_CHUNK)
    if precision == "bf16":
        w0, w1 = round_bf16(w0), round_bf16(w1)
    w0p, w1p = _pad2(w0, rq, fp), _pad2(w1, fp, fp)
    return {
        "w0": w0p, "w0t": w0p.T.contiguous(), "b0": pad_features(b0, fp),
        "w1": w1p, "w1t": w1p.T.contiguous(),
        "off": pad_features(offset, rq),
    }


def _workspace(bwd, fp, device):
    from ._build import load

    n = load().cfconv_general_ws_floats(int(bwd), fp)
    if n < 0:
        raise ValueError(f"the general-width CFConv kernels' tile workspace "
                         f"at Fp = {fp} exceeds 2^31 floats")
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _weight_ptrs(wg, coeff):
    return (_ptr(wg["w0"]), _ptr(wg["w0t"]), _ptr(wg["b0"]), _ptr(wg["w1"]),
            _ptr(wg["w1t"]), _ptr(wg["off"]), _ptr(coeff))


def general_fwd(pos, idx, mask, x, w0, b0, w1, offset, coeff, rcut,
                precision):
    """out [S, A, F] of the general-width forward: all pairs when ``idx``
    is None, else over the neighbour matrix idx/mask [S, A, K]. Operands
    checked by the caller."""
    from ._build import load

    s, a, f = x.shape
    r = w0.shape[0]
    nbr = idx is not None
    wg = general_weights(w0, b0, w1, offset, precision)
    fp, rq = wg["w1"].shape[0], wg["off"].shape[0]
    xp = pad_features(x, fp)
    out = torch.empty_like(xp)
    ws = _workspace(False, fp, x.device)
    rc = load().cfconv_general_fwd(
        int(nbr), _ptr(pos), _ptr(idx), _ptr(mask), _ptr(xp),
        *_weight_ptrs(wg, coeff), _ptr(out), _ptr(ws), s, a,
        idx.shape[-1] if nbr else 0, fp, r, rq, float(rcut),
        int(precision == "bf16"), _stream(),
    )
    name = "cfconv_fwd_general" if nbr else "dense_cfconv_fwd_general"
    _raise_on(rc, name)
    _launches[name] += 1
    return out if fp == f else out[..., :f].contiguous()


def general_bwd(pos, idx, mask, csr_offsets, csr_slots, x, g, w0, b0, w1,
                offset, coeff, rcut, precision, need_gx):
    """(gpos [S, A, 3], gx [S, A, F] or None) of the general-width
    backward: all pairs when ``idx`` is None (gd [S, A, A] workspace),
    else over the neighbour matrix with its source CSR (gd [S, A, K]; gx
    over the CSR, W computed again). Operands checked by the caller."""
    from ._build import load

    s, a, f = x.shape
    r = w0.shape[0]
    nbr = idx is not None
    k = idx.shape[-1] if nbr else 0
    wg = general_weights(w0, b0, w1, offset, precision)
    fp, rq = wg["w1"].shape[0], wg["off"].shape[0]
    xp, gp = pad_features(x, fp), pad_features(g, fp)
    gd = torch.empty(s, a, k if nbr else a, dtype=pos.dtype,
                     device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(gp) if need_gx else None
    ws = _workspace(True, fp, x.device)
    rc = load().cfconv_general_bwd(
        int(nbr), _ptr(pos), _ptr(idx), _ptr(mask), _ptr(csr_offsets),
        _ptr(csr_slots), _ptr(xp), _ptr(gp), *_weight_ptrs(wg, coeff),
        _ptr(gd), _ptr(gpos), _ptr(gx), _ptr(ws), s, a, k, fp, r, rq,
        float(rcut), int(precision == "bf16"), _stream(),
    )
    name = "cfconv_bwd_general" if nbr else "dense_cfconv_bwd_general"
    _raise_on(rc, name)
    _launches[name] += 1
    if gx is not None and fp != f:
        gx = gx[..., :f].contiguous()
    return gpos, gx


# Launches of the general-width kernels, one per wrapper call (a backward's
# two or three kernels count as one), by the wrapper that routed them.
_launches = dict.fromkeys(
    ["dense_cfconv_fwd_general", "dense_cfconv_bwd_general",
     "cfconv_fwd_general", "cfconv_bwd_general"], 0)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)
