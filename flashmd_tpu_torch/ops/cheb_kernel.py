"""Chebyshev CFConv kernels: wrappers, plain PyTorch twins, launch counts.

Port of flashmd_tpu/ops/pallas/cheb_kernel.py. The CUDA sources are in
``flashmd_tpu_torch/csrc/cheb_kernels.cu`` (built by ``ops/_build.py``):

=================  ==========================================================
wrapper            replaces (flashmd_tpu/ops/pallas/cheb_kernel.py)
=================  ==========================================================
cheb_conv_fwd      ``_cheb_fwd_kernel`` (:394), via ``cheb_conv_fwd_pallas``
cheb_conv_bwd_gx   ``_cheb_bwd_kernel`` (:476), ``need_gd=False``
cheb_conv_bwd_gd   ``_cheb_bwd_kernel`` (:476), ``need_gx=False, stacked``
=================  ==========================================================

Every operand carries the batch as its leading axis: ``pos [S, A, 3]``,
``x``/``g`` ``[S, A, F]``; coefficient tables are ``[M, F]``. The batch is
the kernels' grid axis.

Dispatch: a wrapper takes its plain twin only for tensors on the CPU. For
CUDA tensors it launches its kernel or raises; there is no fallback. Each
wrapper counts its kernel launches in its ``launches`` attribute.

Precision tiers: ``fp32`` and ``bf16`` (product operands rounded to bf16,
recurrence and accumulation in float32, at the same places in the kernel
and its twin). ``bf16x3`` raises.
"""

from __future__ import annotations

import torch

from ..models.mlp import check_precision
from ._launch import _check, _op, _ptr, _raise_on, _same_device, _stream


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


def pair_geometry(pos: torch.Tensor, rcut: float, d_min: float = 0.0):
    """d, z [S, A, A] from exact per-coordinate differences
    (reference _pair_z, models/cheb.py:469-487)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    d = torch.sqrt(torch.sum(rel * rel, dim=-1) + 1e-12)
    z = torch.clamp((d - d_min) * (2.0 / (rcut - d_min)) - 1.0, -1.0, 1.0)
    return d, z


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
                        w_lin=None):
    """out = sum_m c_m (Ttil_m @ x) - w0 x + w_lin (low @ x); mirrors
    ``_cheb_forward_only`` plus the ``low`` term (models/cheb.py:574-630).
    bf16 rounds Ttil_m and x; c_m multiplies after the product."""
    d, z = pair_geometry(pos, rcut, d_min)
    u2 = torch.square(1.0 - z)
    two_z = 2.0 * z
    xo = _op(x, precision)
    t_prev, t_cur = u2, u2 * z
    out = c[0] * (_op(t_prev, precision) @ xo)
    if c.shape[0] > 1:
        out = out + c[1] * (_op(t_cur, precision) @ xo)
    for m in range(2, c.shape[0]):
        t_prev, t_cur = t_cur, two_z * t_cur - t_prev
        out = out + c[m] * (_op(t_cur, precision) @ xo)
    if w_lin is not None:
        out = out + w_lin * (_op(_low_matrix(d, d_min), precision) @ xo)
    return out - w0 * x


def cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, precision, d_min=0.0,
                           w_lin=None):
    """gx = sum_k That_k @ (q_k g) - w0 g + low @ (w_lin g), q =
    _to_that_basis(c): the kernel's own basis. bf16 rounds That_k and
    q_k g (and low, w_lin g)."""
    q = _to_that_basis(c)
    d, z = pair_geometry(pos, rcut, d_min)
    u = 1.0 - z
    two_z = 2.0 * z
    h_prev, h_cur = u, u * z
    gx = _op(h_prev, precision) @ _op(q[0] * g, precision)
    gx = gx + _op(h_cur, precision) @ _op(q[1] * g, precision)
    for k in range(2, q.shape[0]):
        h_prev, h_cur = h_cur, two_z * h_cur - h_prev
        gx = gx + _op(h_cur, precision) @ _op(q[k] * g, precision)
    if w_lin is not None:
        gx = gx + _op(_low_matrix(d, d_min), precision) @ _op(
            w_lin * g, precision
        )
    return gx - w0 * g


def cheb_conv_bwd_gd_plain(c2, pos, x, g, rcut, precision, d_min=0.0):
    """Position gradient of the distance-gradient series, plain T basis:
    gd = (1-z) sum_m T_m ((c2_m g) @ x^T), W = gd/d on live pairs,
    gpos = pos rowsum(W) - W pos + pos colsum(W) - W^T pos. bf16 rounds
    c2_m g and x."""
    d, z = pair_geometry(pos, rcut, d_min)
    two_z = 2.0 * z
    xt = _op(x, precision).transpose(1, 2)

    def u_m(m):
        return _op(c2[m] * g, precision) @ xt

    p_prev, p_cur = torch.ones_like(z), z
    gd = p_prev * u_m(0)
    if c2.shape[0] > 1:
        gd = gd + p_cur * u_m(1)
    for m in range(2, c2.shape[0]):
        p_prev, p_cur = p_cur, two_z * p_cur - p_prev
        gd = gd + p_cur * u_m(m)
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    gd = (1.0 - z) * gd
    gd = torch.where((d < rcut) & ~eye, gd, torch.zeros_like(gd))
    ws = (gd + gd.transpose(1, 2)) / d
    return pos * torch.sum(ws, dim=2, keepdim=True) - ws @ pos


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def cheb_conv_fwd(c, w0, pos, x, rcut, precision, d_min=0.0, w_lin=None):
    """Forward Chebyshev CFConv, [S, A, F] (see module docstring)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_fwd_plain(c, w0, pos, x, rcut, precision, d_min,
                                   w_lin)
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
    _same_device(*tensors)
    out = torch.empty_like(x)
    rc = load().cheb_fwd(
        _ptr(pos), _ptr(x), _ptr(c), _ptr(w0), _ptr(w_lin), _ptr(out),
        s, a, f, m, float(rcut), float(d_min), int(precision == "bf16"),
        _stream(),
    )
    _raise_on(rc, "cheb_fwd")
    cheb_conv_fwd.launches += 1
    return out


def cheb_conv_bwd_gx(c, w0, pos, g, rcut, precision, d_min=0.0, w_lin=None):
    """gx-only backward, [S, A, F]; ``c`` is the forward series [M, F]
    (re-expressed on the That basis here)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_bwd_gx_plain(c, w0, pos, g, rcut, precision, d_min,
                                      w_lin)
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
    _same_device(*tensors)
    gx = torch.empty_like(g)
    rc = load().cheb_bwd_gx(
        _ptr(pos), _ptr(g), _ptr(q), _ptr(w0), _ptr(w_lin), _ptr(gx),
        s, a, f, q.shape[0], float(rcut), float(d_min),
        int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "cheb_bwd_gx")
    cheb_conv_bwd_gx.launches += 1
    return gx


def cheb_conv_bwd_gd(c2, pos, x, g, rcut, precision, d_min=0.0):
    """Distance-gradient backward over block-stacked operands
    (c2 [M2, B*F], x/g [S, A, B*F]) -> gpos [S, A, 3]."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cheb_conv_bwd_gd_plain(c2, pos, x, g, rcut, precision, d_min)
    from ._build import load

    lib = load()
    s, a, f = x.shape
    m = c2.shape[0]
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    _check("g", g, (s, a, f))
    _check("c2", c2, (m, f))
    _same_device(pos, x, g, c2)
    n_tiles = lib.cheb_gd_tiles(a)
    row_part = torch.empty(s, a, 3, dtype=torch.float32, device=pos.device)
    col_part = torch.empty(s, n_tiles, a, 3, dtype=torch.float32,
                           device=pos.device)
    gpos = torch.empty_like(pos)
    rc = lib.cheb_bwd_gd(
        _ptr(pos), _ptr(x), _ptr(g), _ptr(c2), _ptr(row_part),
        _ptr(col_part), _ptr(gpos), s, a, f, m, float(rcut), float(d_min),
        int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "cheb_bwd_gd")
    cheb_conv_bwd_gd.launches += 1
    return gpos


cheb_conv_fwd.launches = 0
cheb_conv_bwd_gx.launches = 0
cheb_conv_bwd_gd.launches = 0

KERNELS = {
    "cheb_fwd": cheb_conv_fwd,
    "cheb_bwd_gx": cheb_conv_bwd_gx,
    "cheb_bwd_gd": cheb_conv_bwd_gd,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
