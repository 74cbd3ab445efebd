"""Chebyshev CFConv kernels: wrappers, plain PyTorch twins, launch counts.

Port of flashmd_tpu/ops/pallas/cheb_kernel.py. The CUDA sources are in
``flashmd_tpu_torch/csrc/cheb_kernels.cu`` (built by ``ops/_build.py``):

=================  ==========================================================
wrapper            replaces (flashmd_tpu/ops/pallas/cheb_kernel.py)
=================  ==========================================================
cheb_conv_fwd      ``_cheb_fwd_kernel`` (:394), via ``cheb_conv_fwd_pallas``
cheb_conv_bwd_gx   ``_cheb_bwd_kernel`` (:476), ``need_gd=False``
cheb_conv_bwd_gd   ``_cheb_bwd_kernel`` (:476), ``need_gx=False`` (stacked
                   or one block's operands)
cheb_conv_bwd_gxgd ``_cheb_bwd_kernel`` (:476), ``need_gx=True,
                   need_gd=True``: the per-block backward
=================  ==========================================================

At bf16 and bf16x3 the kernels take their order products on the tensor
cores and skip the pair fragments that add nothing: ``cheb_bwd_gd`` runs
16 x 8 fragments with a pair within the cutoff off the diagonal (exact:
W is zero elsewhere); ``cheb_fwd``, ``cheb_bwd_gx`` and ``cheb_bwd_gxgd``
run 16 x 16 fragments with a pair at z != 1 (exact: both bases vanish at
z == 1; the diagonal, at z = -1, runs) and their linear term only where
low != 0. At fp32 all four take float32 FMAs on the CUDA cores over the
same pairs one by one (z != 1; d < rcut off the diagonal for gd alone),
compacted per row on the card; ``cheb_bwd_gxgd`` runs the pairs at z != 1
and weighs their gd by the keep mask. The column partials of
``cheb_bwd_gd`` and ``cheb_bwd_gxgd`` take ``gd_slabs(A, F, precision)``
slabs (none for ``cheb_bwd_gxgd`` at fp32 with F <= 128: one launch, no
reduce).

Every operand carries the batch as its leading axis: ``pos [S, A, 3]``,
``x``/``g`` ``[S, A, F]``; coefficient tables are ``[M, F]``. The batch is
the kernels' grid axis.

Periodic cells: every wrapper and twin takes ``cell`` (None, ``[3, 3]`` or
per molecule ``[S, 3, 3]``; rows are lattice vectors) and switches the pair
geometry to the minimum image (reference ``_tile_rel``, :204-257):
frac = rel @ inv, rel -= round(frac) @ cell, written out per component in
the reference's index order and rounded half to even. ``inv`` (the
cell's inverse, ``[S, 3, 3]``) may be passed in so that a force evaluation
computes it once; it is computed here otherwise.

Dispatch: a wrapper takes its plain twin only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; there is no fallback. The
wrappers count their launches per kernel, the cell variants and the
fp32 and bf16x3 tiers apart (``cheb_fwd`` is bf16, ``cheb_fwd_cell``,
``cheb_fwd_fp32``, ``cheb_fwd_cell_bf16x3``, ...): ``launch_counts()``.

Precision tiers, at the same places in each kernel and its twin; the
recurrence and all accumulation stay float32:

* ``fp32``: float32 products.
* ``bf16``: product operands rounded to bf16.
* ``bf16x3``: each product operand split into bf16 hi and lo parts, the
  product taken as hi @ hi + lo @ hi + hi @ lo (``_launch._dot``, the
  reference's ``_mxu_dot``, cheb_kernel.py:352-380), near float32.
"""

from __future__ import annotations

import torch

from ..models.mlp import check_precision
from ._launch import (
    TIER_CODES,
    _check,
    _dot,
    _ptr,
    _raise_on,
    _same_device,
    _stream,
)
from .neighborlist import _cell_operands, pair_rel


# ---------------------------------------------------------------------------
# Coefficient transforms and pair geometry shared by twins and wrappers
# ---------------------------------------------------------------------------


def _to_that_basis(c: torch.Tensor) -> torch.Tensor:
    """Re-express the gx series on the That = (1-z) T_k basis
    (reference _to_that_basis, cheb_kernel.py:319-349, without its chain-
    stride padding): sum_k q_k That_k = (1-z)^2 sum_m c_m T_m, with

        q_0 = c_0 - c_1/2,  q_1 = c_1 - c_0 - c_2/2,
        q_k = c_k - (c_{k-1} + c_{k+1})/2  (k >= 2).

    c [M, F] -> q [M + 1, F]."""
    m, f = c.shape
    rows = m + 1
    zeros = torch.zeros(rows + 1 - m, f, dtype=c.dtype, device=c.device)
    cz = torch.cat([c, zeros], dim=0)  # c_k for k = 0..rows
    up = cz[1:rows + 1] * 0.5
    down = torch.cat([zeros[:1], cz[0:1], cz[1:rows - 1] * 0.5], dim=0)
    return cz[:rows] - up - down


def _geometry(rel, rcut, d_min):
    d = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    z = torch.clamp((d - d_min) * (2.0 / (rcut - d_min)) - 1.0, -1.0, 1.0)
    return d, z


def pair_geometry(pos: torch.Tensor, rcut: float, d_min: float = 0.0,
                  cell=None, inv=None):
    """d, z [S, A, A] from exact per-coordinate differences, minimum-imaged
    under a cell (reference _pair_z, models/cheb.py:469-487)."""
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device, inv)
    return _geometry(pair_rel(pos, cell, inv), rcut, d_min)


def _low_matrix(d: torch.Tensor, d_min: float) -> torch.Tensor:
    """low = min(d - d_min, 0), zero on the diagonal (reference
    models/cheb._low_matrix :554)."""
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    low = torch.clamp(d - d_min, max=0.0)
    return torch.where(eye, torch.zeros_like(d), low)


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def cheb_conv_fwd_plain(c, w0, pos, x, rcut, precision, d_min=0.0,
                        w_lin=None, cell=None, inv=None):
    """out = sum_m c_m (Ttil_m @ x) - w0 x + w_lin (low @ x); mirrors
    ``_cheb_forward_only`` plus the ``low`` term (models/cheb.py:574-630).
    The tier applies to Ttil_m and x (then low and x), as in the
    reference's ``chain_matvec`` (:422) and ``low`` term (:471); c_m
    multiplies after the product."""
    d, z = pair_geometry(pos, rcut, d_min, cell, inv)
    u2 = torch.square(1.0 - z)
    two_z = 2.0 * z
    t_prev, t_cur = u2, u2 * z
    out = c[0] * _dot(t_prev, x, precision)
    if c.shape[0] > 1:
        out = out + c[1] * _dot(t_cur, x, precision)
    for m in range(2, c.shape[0]):
        t_prev, t_cur = t_cur, two_z * t_cur - t_prev
        out = out + c[m] * _dot(t_cur, x, precision)
    if w_lin is not None:
        out = out + w_lin * _dot(_low_matrix(d, d_min), x, precision)
    return out - w0 * x


def cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, precision, d_min=0.0,
                           w_lin=None, cell=None, inv=None):
    """gx = sum_k That_k @ (q_k g) - w0 g + low @ (w_lin g), q =
    _to_that_basis(c): the kernel's own basis. The tier applies to That_k
    and q_k g (then low and w_lin g), as in the reference's ``chain_gx``
    (:529) and ``low`` term (:616)."""
    q = _to_that_basis(c)
    d, z = pair_geometry(pos, rcut, d_min, cell, inv)
    u = 1.0 - z
    two_z = 2.0 * z
    h_prev, h_cur = u, u * z
    gx = _dot(h_prev, q[0] * g, precision)
    gx = gx + _dot(h_cur, q[1] * g, precision)
    for k in range(2, q.shape[0]):
        h_prev, h_cur = h_cur, two_z * h_cur - h_prev
        gx = gx + _dot(h_cur, q[k] * g, precision)
    if w_lin is not None:
        gx = gx + _dot(_low_matrix(d, d_min), w_lin * g, precision)
    return gx - w0 * g


def cheb_conv_bwd_gd_plain(c2, pos, x, g, rcut, precision, d_min=0.0,
                           cell=None, inv=None):
    """Position gradient of the distance-gradient series, plain T basis:
    gd = (1-z) sum_m T_m ((c2_m g) @ x^T), W = gd/d on live pairs,
    gpos = pos rowsum(W) - W pos + pos colsum(W) - W^T pos. Under a cell
    the pair shifts break that identity, so W contracts the minimum-image
    rel directly: gpos_i = -sum_j (W_ij + W_ji) rel_ij (reference
    models/cheb.py:751-756). The tier applies to c2_m g and x, as in the
    reference's ``chain_gd`` (:537); the basis multiplies the product
    afterwards in float32."""
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device, inv)
    rel = pair_rel(pos, cell, inv)
    d, z = _geometry(rel, rcut, d_min)
    two_z = 2.0 * z
    xt = x.transpose(1, 2)

    def u_m(m):
        return _dot(c2[m] * g, xt, precision)

    p_prev, p_cur = torch.ones_like(z), z
    gd = p_prev * u_m(0)
    if c2.shape[0] > 1:
        gd = gd + p_cur * u_m(1)
    for m in range(2, c2.shape[0]):
        p_prev, p_cur = p_cur, two_z * p_cur - p_prev
        gd = gd + p_cur * u_m(m)
    return _gpos_of_gd((1.0 - z) * gd, pos, rel, d, rcut, cell)


def _gpos_of_gd(gd, pos, rel, d, rcut, cell):
    """gpos from the distance gradient gd [S, A, A] (the (1-z) factor
    applied): W = gd/d on live pairs, gpos = pos rowsum(W) - W pos + pos
    colsum(W) - W^T pos; under a cell the pair shifts break that identity,
    so W contracts the minimum-image rel directly: gpos_i = -sum_j (W_ij +
    W_ji) rel_ij (reference models/cheb.py:751-756)."""
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    gd = torch.where((d < rcut) & ~eye, gd, torch.zeros_like(gd))
    ws = (gd + gd.transpose(1, 2)) / d
    if cell is not None:
        return -torch.sum(ws[..., None] * rel, dim=2)
    return pos * torch.sum(ws, dim=2, keepdim=True) - ws @ pos


def cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, g, rcut, precision,
                             d_min=0.0, w_lin=None, cell=None, inv=None):
    """Both halves of one block's backward from ONE recurrence on That_m =
    (1-z) T_m (reference _cheb_bwd, models/cheb.py:686-723, on the
    kernels' own bases): gx as cheb_conv_bwd_gx_plain (orders of q =
    _to_that_basis(c)), gd = sum_m That_m ((c2_m g) @ x^T) (orders of c2),
    into gpos as cheb_conv_bwd_gd_plain. Returns (gpos, gx). The tier
    applies to That_k and q_k g (and low, w_lin g) for gx, c2_m g and x for
    gd."""
    q = _to_that_basis(c)
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device, inv)
    rel = pair_rel(pos, cell, inv)
    d, z = _geometry(rel, rcut, d_min)
    two_z = 2.0 * z
    xt = x.transpose(1, 2)
    n_q, n_d = q.shape[0], c2.shape[0]
    h_prev, h_cur = 1.0 - z, (1.0 - z) * z
    gx = gd = 0.0
    for m in range(max(n_q, n_d)):
        if m == 0:
            h = h_prev
        elif m == 1:
            h = h_cur
        else:
            h_prev, h_cur = h_cur, two_z * h_cur - h_prev
            h = h_cur
        if m < n_q:
            gx = gx + _dot(h, q[m] * g, precision)
        if m < n_d:
            gd = gd + h * _dot(c2[m] * g, xt, precision)
    if w_lin is not None:
        gx = gx + _dot(_low_matrix(d, d_min), w_lin * g, precision)
    return _gpos_of_gd(gd, pos, rel, d, rcut, cell), gx - w0 * g


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _cell_args(cell, inv, s, pos, tensors):
    """The checked (cell, inv) operands of a launch, appended to
    ``tensors``; (None, None) for open boundaries."""
    cell, inv = _cell_operands(cell, s, pos.device, inv)
    if cell is not None:
        _check("cell", cell, (s, 3, 3))
        _check("inv", inv, (s, 3, 3))
        tensors += [cell, inv]
    return cell, inv


def _count(name, cell, precision):
    """One launch of ``name``'s variant: "_cell" under a cell, then the
    tier's suffix ("" at bf16)."""
    name += "" if cell is None else "_cell"
    _launches[name + _TIER_SUFFIX[precision]] += 1


def gd_slabs(a: int, f: int, precision: str) -> int:
    """Slabs of the column partials col_part [S, slabs, A, 3] of
    ``cheb_bwd_gd`` and ``cheb_bwd_gxgd``: at fp32 one per 128-feature
    chunk after the first (whose part goes to row_part), at bf16 and
    bf16x3 one per 16-row strip. The kernels refuse any other count."""
    if precision == "fp32":
        return -(-f // 128) - 1
    return -(-a // 16)


def cheb_conv_fwd(c, w0, pos, x, rcut, precision, d_min=0.0, w_lin=None,
                  cell=None, inv=None):
    """Forward Chebyshev CFConv, [S, A, F] (see module docstring)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_fwd_plain(c, w0, pos, x, rcut, precision, d_min,
                                   w_lin, cell, inv)
    from ._build import load

    s, a, f = x.shape
    m = c.shape[0]
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    _check("c", c, (m, f))
    _check("w0", w0, (f,))
    tensors = [pos, x, c, w0]
    if w_lin is not None:
        _check("w_lin", w_lin, (f,))
        tensors.append(w_lin)
    cell, inv = _cell_args(cell, inv, s, pos, tensors)
    _same_device(*tensors)
    out = torch.empty_like(x)
    rc = load().cheb_fwd(
        _ptr(pos), _ptr(x), _ptr(c), _ptr(w0), _ptr(w_lin), _ptr(cell),
        _ptr(inv), _ptr(out), s, a, f, m, float(rcut), float(d_min),
        TIER_CODES[precision], _stream(),
    )
    _raise_on(rc, "cheb_fwd")
    _count("cheb_fwd", cell, precision)
    return out


def cheb_conv_bwd_gx(c, w0, pos, g, rcut, precision, d_min=0.0, w_lin=None,
                     cell=None, inv=None):
    """gx-only backward, [S, A, F]; ``c`` is the forward series [M, F]
    (re-expressed on the That basis here)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, precision, d_min,
                                      w_lin, cell, inv)
    from ._build import load

    s, a, f = g.shape
    _check("c", c, (c.shape[0], f))
    q = _to_that_basis(c)
    _check("pos", pos, (s, a, 3))
    _check("g", g, (s, a, f))
    _check("w0", w0, (f,))
    tensors = [pos, g, q, w0]
    if w_lin is not None:
        _check("w_lin", w_lin, (f,))
        tensors.append(w_lin)
    cell, inv = _cell_args(cell, inv, s, pos, tensors)
    _same_device(*tensors)
    gx = torch.empty_like(g)
    rc = load().cheb_bwd_gx(
        _ptr(pos), _ptr(g), _ptr(q), _ptr(w0), _ptr(w_lin), _ptr(cell),
        _ptr(inv), _ptr(gx), s, a, f, q.shape[0], float(rcut), float(d_min),
        TIER_CODES[precision], _stream(),
    )
    _raise_on(rc, "cheb_bwd_gx")
    _count("cheb_bwd_gx", cell, precision)
    return gx


def cheb_conv_bwd_gd(c2, pos, x, g, rcut, precision, d_min=0.0, cell=None,
                     inv=None):
    """Distance-gradient backward over block-stacked operands
    (c2 [M2, B*F], x/g [S, A, B*F]) -> gpos [S, A, 3]."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_bwd_gd_plain(c2, pos, x, g, rcut, precision, d_min,
                                      cell, inv)
    from ._build import load

    lib = load()
    s, a, f = x.shape
    m = c2.shape[0]
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    _check("g", g, (s, a, f))
    _check("c2", c2, (m, f))
    tensors = [pos, x, g, c2]
    cell, inv = _cell_args(cell, inv, s, pos, tensors)
    _same_device(*tensors)
    n_slabs = gd_slabs(a, f, precision)
    row_part = torch.empty(s, a, 3, dtype=torch.float32, device=pos.device)
    col_part = torch.empty(s, n_slabs, a, 3, dtype=torch.float32,
                           device=pos.device)
    gpos = torch.empty_like(pos)
    rc = lib.cheb_bwd_gd(
        _ptr(pos), _ptr(x), _ptr(g), _ptr(c2), _ptr(cell), _ptr(inv),
        _ptr(row_part), _ptr(col_part), _ptr(gpos), s, a, f, m, n_slabs,
        float(rcut), float(d_min), TIER_CODES[precision], _stream(),
    )
    _raise_on(rc, "cheb_bwd_gd")
    _count("cheb_bwd_gd", cell, precision)
    return gpos


def cheb_conv_bwd_gxgd(c, c2, w0, pos, x, g, rcut, precision, d_min=0.0,
                       w_lin=None, cell=None, inv=None):
    """One block's whole backward in one launch -> (gpos [S, A, 3], gx
    [S, A, F]); ``c`` [M1, F] is the forward series (re-expressed on the
    That basis here), ``c2`` [M2, F] the derivative series, x/g [S, A, F]."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, g, rcut,
                                        precision, d_min, w_lin, cell, inv)
    from ._build import load

    lib = load()
    s, a, f = x.shape
    _check("c", c, (c.shape[0], f))
    q = _to_that_basis(c)
    m2 = c2.shape[0]
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    _check("g", g, (s, a, f))
    _check("c2", c2, (m2, f))
    _check("w0", w0, (f,))
    tensors = [pos, x, g, q, c2, w0]
    if w_lin is not None:
        _check("w_lin", w_lin, (f,))
        tensors.append(w_lin)
    cell, inv = _cell_args(cell, inv, s, pos, tensors)
    _same_device(*tensors)
    n_slabs = gd_slabs(a, f, precision)
    gx = torch.empty_like(g)
    row_part = torch.empty(s, a, 3, dtype=torch.float32, device=pos.device)
    col_part = torch.empty(s, n_slabs, a, 3, dtype=torch.float32,
                           device=pos.device)
    gpos = torch.empty_like(pos)
    rc = lib.cheb_bwd_gxgd(
        _ptr(pos), _ptr(x), _ptr(g), _ptr(q), _ptr(c2), _ptr(w0),
        _ptr(w_lin), _ptr(cell), _ptr(inv), _ptr(gx), _ptr(row_part),
        _ptr(col_part), _ptr(gpos), s, a, f, q.shape[0], m2, n_slabs,
        float(rcut), float(d_min), TIER_CODES[precision], _stream(),
    )
    _raise_on(rc, "cheb_bwd_gxgd")
    _count("cheb_bwd_gxgd", cell, precision)
    return gpos, gx


KERNELS = {
    "cheb_fwd": cheb_conv_fwd,
    "cheb_bwd_gx": cheb_conv_bwd_gx,
    "cheb_bwd_gd": cheb_conv_bwd_gd,
    "cheb_bwd_gxgd": cheb_conv_bwd_gxgd,
}
# Launches per kernel: the open variants under their names, the cell
# variants under name + "_cell", each at bf16 as it is and at the fp32 and
# bf16x3 tiers + "_fp32" and "_bf16x3".
_TIER_SUFFIX = {"bf16": "", "fp32": "_fp32", "bf16x3": "_bf16x3"}
_VARIANTS = [*KERNELS, *(n + "_cell" for n in KERNELS)]
_launches = dict.fromkeys(
    [n + sfx for sfx in _TIER_SUFFIX.values() for n in _VARIANTS], 0)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def launch_counts() -> dict:
    return dict(_launches)
