"""The exact-filter CFConv kernels at every width: the route between the
tuned kernels and the general-width ones, the zero padding that each takes,
and the general-width wrappers with their launch counts.

The tuned kernels (``csrc/cfconv_kernels.cu``, ``csrc/cfconv_dense_kernels.cu``
on ``csrc/cfconv_tile.cuh``) stage w0 and w1 whole in shared memory and lay
their tiles out for F = 128 filters and at most 64 radial functions. The
JAX kernels read F and R from their operands and take any width, so
``ops/cfconv.py`` and ``ops/cfconv_dense.py`` route each CUDA launch by
:func:`route`, a plain function of (F, R, precision), to one of three
families:

* "tuned", F <= 128 and R <= 64: the tuned kernels. Below F = 128 the
  wrapper pads w0's columns, b0, w1's rows and columns and the features of
  x and g with zeros (:func:`tuned_operands`) and slices the outputs back
  to F. That is exact at both tiers: tanh(0) = 0, a zero stays zero under
  bf16 rounding, and zero products add nothing. It runs (R 128 + 128^2) /
  (R F + F^2) times the useful work (3.1x at F 64, R 50).
* "general", any other width: the general-width kernels of
  ``csrc/cfconv_general_kernels.cu`` (:func:`general_fwd`,
  :func:`general_bwd`). At fp32 (and bf16x3, which computes these kernels
  at fp32) register-tiled float32 FMAs on the CUDA cores (8 pairs x 8
  columns a lane), weights zero-padded to Fp = F and Rq = R rounded up to
  64, in one of three layouts (:func:`ffma_layout`, a plain function of
  (F, R) with the kernels' byte counts): "staged", w0 and w1 whole in
  each block's shared memory (F 64 R 300, F 128 R 100); "panels",
  streamed through it in panels that every warp of the block shares
  (``gf_*_kernel`` with PANEL, F 256 R 50); "l2", the first design's
  kernels (``gw_*_kernel``: weights read through L1/L2, the backward's
  transposes too), where a block cannot hold two warps' tiles beside the
  panels (Fp above 576). The forward and the gx pass at Fp 64 run the
  first design's kernels at any layout (their 8 x 4 register tile there
  loses to its 16 warps a block). At bf16 the tensor-core tiles
  (``gw_*_mma_kernel``): mma.sync bf16 products with bf16 weights w0
  [Rq][Fq] and w1 [Fq][Fq] (Fq, Rq: F, R rounded up to 16) staged once per
  block in shared memory, where they and one warp's tiles must fit
  (:func:`mma_layout` "staged", :func:`mma_smem_bytes`).
* "streamed", bf16 at a width whose bf16 weights do not fit there but
  whose tiles do beside two panel buffers (:func:`mma_layout` "panels":
  F 256 R 200, the Open Catalyst SchNet's filter; F 640 R 8; up to F 4,048
  at R 8 and 3,920 at R 200): the same tensor-core tiles with w0 and w1
  streamed from device memory through shared memory in 64 x 64 panels
  that every warp of a block shares (``gp_*_kernel``).
* "wide", bf16 at a width where neither fits (F 4,096 at R 8, say): the
  CUDA-core kernels at bf16 (operands rounded where the twins round them),
  in the fp32 tier's layout at that width.

:func:`general_weights` prepares a family's weights once per parameter set:
the prepared tensors are kept, keyed on the parameters' identity, version
counter (so that an in-place update is seen), shape, dtype and the tier,
for as long as the parameters live; so does :func:`tuned_operands` for
the tuned family's padding below F = 128. x and g are padded to the
family's width on each call.

Each family counts its own launches: the tuned one on the wrappers'
``launches``, the general, streamed and wide ones here
(``dense_cfconv_fwd_general``, ``cfconv_bwd_streamed``, ``cfconv_bwd_wide``,
..., :func:`launch_counts`). There is no fallback: on
CUDA tensors every width launches a kernel or raises.
"""

from __future__ import annotations

import functools
import weakref

import torch

from ..models.mlp import round_bf16
from ._launch import _ptr, _raise_on, _stream

# The widths the tuned kernels take (F and RMAX of csrc/cfconv_tile.cuh).
TUNED_F = 128
TUNED_R_MAX = 64
# Column and radial-function chunks of the general-width CUDA-core kernels
# (GW_CW, GW_RC of csrc/cfconv_general_kernels.cu).
GENERAL_COLUMNS = 64
GENERAL_RBF_CHUNK = 64
# The tensor-core tiles (GM_* and GP_* of
# csrc/cfconv_general_mma_kernels.cu): F and R padded to the mma k-step,
# the W cut staging's row stride, the ring and the rows of a work item, the
# shared memory a block may hold, the two panel buffers of the streamed
# tiles (64 x 64 bf16, row stride 72), and the kernels' tier codes (weights
# staged whole, streamed).
MMA_K = 16
MMA_STAGE_LD = 36
MMA_RING = 64
MMA_ROWS = 4
SMEM_MAX = 232448
MMA_PANEL_BYTES = 2 * 2 * 64 * (64 + 8)
MMA_TIER = 2
STREAMED_TIER = 3
# The CUDA-core tiles' layouts (GF_* of csrc/cfconv_general_kernels.cu):
# columns of a chunk, the two panel buffers' floats (32 rows of 128 + 4
# columns, or 128 rows of 32 + 4), and the fewest warps of the dense
# backward with gx that each layout must hold.
FFMA_CHUNK = 128
FFMA_PANEL_FLOATS = max(32 * (128 + 4), 128 * (32 + 4))
FFMA_STAGED_MIN = 4
FFMA_PANELS_MIN = 2
# Prepared weights kept at most (general_weights).
WEIGHT_CACHE_SIZE = 32


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def mma_smem_bytes(f: int, r: int, layout: str = "staged") -> int:
    """Bytes of shared memory that a block of the tensor-core tiles needs
    at F filters and R radial functions, with one warp (mma_shape of the
    kernels): "staged" (gm_shape), the bf16 weights w0 [Rq][Fq + 8] and w1
    [Fq][Fq + 8]; "panels" (gp_shape), the two panel buffers; then b0 and
    the offsets, and the area of a warp of the dense backward with gx (the
    largest): rbf and activation fragments, the W cut staging, the item's
    gx rows and the ring."""
    fq, rq = _round_up(f, MMA_K), _round_up(r, MMA_K)
    weights = (2 * (rq + fq) * (fq + 8) if layout == "staged"
               else MMA_PANEL_BYTES) + 4 * (fq + rq)
    warp = (32 * rq + 32 * fq + 4 * 16 * MMA_STAGE_LD + 4 * MMA_ROWS * fq
            + 4 * MMA_RING)
    return weights + warp


def mma_layout(f: int, r: int) -> str:
    """The tensor-core tiles' layout at F filters and R radial functions:
    "staged" where :func:`mma_smem_bytes` of the whole weights fits in a
    block's shared memory (``gw_*_mma_kernel``), else "panels" where that
    of the panel buffers does (``gp_*_kernel``), else "none" (the bf16
    tier then runs the CUDA-core kernels). The library's
    ``cfconv_general_mma_layout`` gives the same (0, 1, -1)."""
    for layout in ("staged", "panels"):
        if mma_smem_bytes(f, r, layout) <= SMEM_MAX:
            return layout
    return "none"


def ffma_warp_bytes(f: int) -> int:
    """Bytes of one warp's area of the CUDA-core tiles' dense backward
    with gx at F filters (gf_warp_floats): the rbf / W cut tile [16][min(Fp,
    128)], a0 and (1 - a0^2) [16][Fp] each, per-pair d, cut, dcut [16][4],
    the item's gx rows [4][Fp] and the ring (Fp: F rounded up to 64)."""
    fp = _round_up(f, GENERAL_COLUMNS)
    return 4 * (16 * min(fp, FFMA_CHUNK) + 2 * 16 * fp + 4 * 16
                + MMA_ROWS * fp + MMA_RING)


def ffma_smem_bytes(f: int, r: int, layout: str) -> int:
    """Bytes of shared memory that a block of the CUDA-core tiles' dense
    backward with gx needs at F filters and R radial functions with the
    fewest warps of ``layout`` (gf_layout of the kernels): "staged", w0
    [R rounded up to 4][Fp + 4] and w1 [Fp][Fp + 4] float32, b0 and the
    offsets [Rq], and FFMA_STAGED_MIN warps; "panels", the two panel
    buffers, b0, the offsets and FFMA_PANELS_MIN warps."""
    fp, rq = _round_up(f, GENERAL_COLUMNS), _round_up(r, GENERAL_RBF_CHUNK)
    if layout == "staged":
        weights = (_round_up(r, 4) + fp) * (fp + 4) + fp + rq
        return 4 * weights + FFMA_STAGED_MIN * ffma_warp_bytes(f)
    weights = 2 * FFMA_PANEL_FLOATS + fp + rq
    return 4 * weights + FFMA_PANELS_MIN * ffma_warp_bytes(f)


def ffma_layout(f: int, r: int) -> str:
    """The CUDA-core tiles' layout at F filters and R radial functions (the
    fp32 tier of the general family, and the wide bf16 one): "staged" where
    :func:`ffma_smem_bytes` of that layout fits in a block's shared memory,
    else "panels" where it fits, else "l2" (the first design's kernels).
    The library's ``cfconv_general_layout`` gives the same for the
    backwards; the forward and the gx pass at Fp 64 take "l2" there. The
    wrapper reads it to prepare the transposes that "l2" needs."""
    for layout in ("staged", "panels"):
        if ffma_smem_bytes(f, r, layout) <= SMEM_MAX:
            return layout
    return "l2"


# The family of each tensor-core layout at bf16.
_MMA_FAMILY = {"staged": "general", "panels": "streamed", "none": "wide"}


def route(f: int, r: int, precision: str) -> tuple:
    """(family, tier) of a CUDA launch at F filters and R radial functions:
    family "tuned" (F <= 128, R <= 64; zero-padded to F = 128), "general"
    (the tensor-core tiles with the weights staged at bf16, the CUDA-core
    kernels at fp32), "streamed" (bf16 where :func:`mma_layout` is
    "panels": the tensor-core tiles with the weights streamed) or "wide"
    (bf16 where it is "none": the CUDA-core kernels at bf16); tier "fp32"
    or "bf16" (bf16x3 computes these kernels at fp32, as the reference
    does)."""
    tier = "bf16" if precision == "bf16" else "fp32"
    if f <= TUNED_F and r <= TUNED_R_MAX:
        return "tuned", tier
    if tier == "bf16":
        return _MMA_FAMILY[mma_layout(f, r)], tier
    return "general", tier


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
    rows and columns. Unchanged at F = 128. The padded weights are prepared
    once per parameter set, as :func:`general_weights` prepares the general
    family's (one set for both tiers: the tuned kernels take float32
    weights and round them at bf16 themselves); x and g are padded on each
    call."""
    if w1.shape[0] == TUNED_F:
        return list(feats), w0, b0, w1
    wt = _cached(("tuned",), (w0, b0, w1), lambda: _prepare_tuned(w0, b0, w1))
    return ([pad_features(t, TUNED_F) for t in feats], wt["w0"], wt["b0"],
            wt["w1"])


def _prepare_tuned(w0, b0, w1):
    return {"w0": pad_features(w0, TUNED_F), "b0": pad_features(b0, TUNED_F),
            "w1": _pad2(w1, TUNED_F, TUNED_F)}


def _prepare(w0, b0, w1, offset, precision, tensor_cores):
    r, f = w0.shape
    if tensor_cores:
        fq, rq = _round_up(f, MMA_K), _round_up(r, MMA_K)
        return {
            "w0": _pad2(w0, rq, fq).to(torch.bfloat16),
            "b0": pad_features(b0, fq).contiguous(),
            "w1": _pad2(w1, fq, fq).to(torch.bfloat16),
            "off": pad_features(offset, rq).contiguous(),
        }
    fp = _round_up(f, GENERAL_COLUMNS)
    rq = _round_up(r, GENERAL_RBF_CHUNK)
    if precision == "bf16":
        w0, w1 = round_bf16(w0), round_bf16(w1)
    w0p, w1p = _pad2(w0, rq, fp), _pad2(w1, fp, fp)
    out = {"w0": w0p, "b0": pad_features(b0, fp), "w1": w1p,
           "off": pad_features(offset, rq)}
    if ffma_layout(f, r) == "l2":  # only the first design's backward
        out.update(w0t=w0p.T.contiguous(), w1t=w1p.T.contiguous())
    return out


# Prepared weights: (layout, tier, the parameters' ids) -> (weak references
# to the parameters, their version counters, shapes, dtypes and devices,
# the tensors). An entry goes when one of its parameters dies or a newer
# version of them replaces it, or beyond WEIGHT_CACHE_SIZE entries, the
# oldest first. _prepared counts the preparations (weight_preparations).
_cache: dict = {}
_prepared = 0


def _forget(key, _ref):
    _cache.pop(key, None)


def _cached(kind, params, make):
    """make()'s tensors for the parameter tuple ``params`` under ``kind``
    (layout, tier), from the cache while the parameters are the same
    tensors at the same version counters, shapes, dtypes and devices."""
    global _prepared
    key = (*kind, *map(id, params))
    stamp = tuple((t._version, tuple(t.shape), t.dtype, t.device)
                  for t in params)
    hit = _cache.get(key)
    if (hit is not None and hit[1] == stamp
            and all(ref() is t for ref, t in zip(hit[0], params))):
        return hit[2]
    with torch.no_grad():
        made = make()
    _prepared += 1
    _cache.pop(key, None)
    refs = tuple(weakref.ref(t, functools.partial(_forget, key))
                 for t in params)
    _cache[key] = (refs, stamp, made)
    while len(_cache) > WEIGHT_CACHE_SIZE:
        _cache.pop(next(iter(_cache)), None)
    return made


def general_weights(w0, b0, w1, offset, precision, tensor_cores=False):
    """The general-width kernels' weights, each contiguous. For the
    CUDA-core kernels (default): w0 [Rq, Fp] float32, b0 [Fp], w1 [Fp, Fp]
    and the offsets [Rq], zero-padded (Fp, Rq: F, R rounded up to 64), w0
    and w1 rounded to bf16 at that tier; where :func:`ffma_layout` is "l2"
    also their transposes w0t [Fp, Rq] and w1t [Fp, Fp], which only the
    first design's backward reads. With ``tensor_cores`` (the bf16 tier's tiles): w0 [Rq,
    Fq] and w1 [Fq, Fq] in bfloat16 (round to nearest even), b0 [Fq] and
    the offsets [Rq] float32, zero-padded (Fq, Rq: F, R rounded up to 16).

    Made once per parameter set and tier: a call with the same tensors, at
    the same version counters, returns the tensors that the first made."""
    return _cached((bool(tensor_cores), precision == "bf16"),
                   (w0, b0, w1, offset),
                   lambda: _prepare(w0, b0, w1, offset, precision,
                                    tensor_cores))


def weight_preparations() -> int:
    """How many times weights have been prepared (:func:`general_weights`,
    :func:`tuned_operands`)."""
    return _prepared


def _workspace(bwd, fp, device):
    from ._build import load

    n = load().cfconv_general_ws_floats(int(bwd), fp)
    if n < 0:
        raise ValueError(f"the general-width CFConv kernels' tile workspace "
                         f"at Fp = {fp} exceeds 2^31 floats")
    return torch.empty(n, dtype=torch.float32, device=device) if n else None


def _weight_ptrs(wg, coeff):
    return (_ptr(wg["w0"]), _ptr(wg.get("w0t")), _ptr(wg["b0"]),
            _ptr(wg["w1"]), _ptr(wg.get("w1t")), _ptr(wg["off"]),
            _ptr(coeff))


def _family(f, r, precision):
    """(family, tensor_cores, tier code) of a general-width launch."""
    family, tier = route(f, r, precision)
    if family == "streamed":
        return family, True, STREAMED_TIER
    mma = family == "general" and tier == "bf16"
    return family, mma, MMA_TIER if mma else int(tier == "bf16")


def general_fwd(pos, idx, mask, x, w0, b0, w1, offset, coeff, rcut,
                precision):
    """out [S, A, F] of the general-width forward: all pairs when ``idx``
    is None, else over the neighbour matrix idx/mask [S, A, K]. Operands
    checked by the caller."""
    from ._build import load

    s, a, f = x.shape
    r = w0.shape[0]
    nbr = idx is not None
    family, mma, tier = _family(f, r, precision)
    wg = general_weights(w0, b0, w1, offset, precision, tensor_cores=mma)
    fp, rq = wg["w1"].shape[0], wg["off"].shape[0]
    xp = pad_features(x, fp)
    out = torch.empty_like(xp)
    ws = None if mma else _workspace(False, fp, x.device)
    rc = load().cfconv_general_fwd(
        int(nbr), _ptr(pos), _ptr(idx), _ptr(mask), _ptr(xp),
        *_weight_ptrs(wg, coeff), _ptr(out), _ptr(ws), s, a,
        idx.shape[-1] if nbr else 0, fp, r, rq, float(rcut), tier,
        _stream(),
    )
    name = f"{'cfconv' if nbr else 'dense_cfconv'}_fwd_{family}"
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
    family, mma, tier = _family(f, r, precision)
    wg = general_weights(w0, b0, w1, offset, precision, tensor_cores=mma)
    fp, rq = wg["w1"].shape[0], wg["off"].shape[0]
    xp, gp = pad_features(x, fp), pad_features(g, fp)
    gd = torch.empty(s, a, k if nbr else a, dtype=pos.dtype,
                     device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(gp) if need_gx else None
    ws = None if mma else _workspace(True, fp, x.device)
    rc = load().cfconv_general_bwd(
        int(nbr), _ptr(pos), _ptr(idx), _ptr(mask), _ptr(csr_offsets),
        _ptr(csr_slots), _ptr(xp), _ptr(gp), *_weight_ptrs(wg, coeff),
        _ptr(gd), _ptr(gpos), _ptr(gx), _ptr(ws), s, a, k, fp, r, rq,
        float(rcut), tier, _stream(),
    )
    name = f"{'cfconv' if nbr else 'dense_cfconv'}_bwd_{family}"
    _raise_on(rc, name)
    _launches[name] += 1
    if gx is not None and fp != f:
        gx = gx[..., :f].contiguous()
    return gpos, gx


# Launches of the general-width kernels, one per wrapper call (a backward's
# two or three kernels count as one), by the wrapper that routed them and
# the family (general, streamed, wide).
_launches = dict.fromkeys(
    [f"{path}_{kind}_{family}" for family in ("general", "streamed", "wide")
     for path in ("dense_cfconv", "cfconv") for kind in ("fwd", "bwd")], 0)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)
