"""Dense all-pairs exact-filter CFConv: wrappers, plain PyTorch twins,
launch counts and the autograd Function.

Port of flashmd_tpu/ops/pallas/cfconv_dense.py. The CUDA sources are in
``flashmd_tpu_torch/csrc/cfconv_dense_kernels.cu`` (built by
``ops/_build.py``):

=================  ==========================================================
wrapper            replaces (flashmd_tpu/ops/pallas/cfconv_dense.py)
=================  ==========================================================
dense_cfconv_fwd   ``_fwd_kernel`` (:126), via ``dense_cfconv_message``
dense_cfconv_bwd   ``_bwd_kernel`` (:147), its custom VJP
=================  ==========================================================

    out[s, i] = sum_{j != i} W(d_ij) * cut(d_ij) * x[s, j],
    W = tanh(rbf @ w0 + b0) @ w1,  rbf = exp(coeff (d - offset)^2) cut.

Operands carry the batch as their leading axis: ``pos [S, A, 3]``,
``x``/``g`` ``[S, A, F]``; ``w0 [R, F]``, ``b0 [F]``, ``w1 [F, F]``,
``offset [R]``, ``coeff []``.

The backward is written the way the kernel computes it: every output row
is owned by one block. W and cut depend only on d_ij, which is symmetric,
so gx[i] = sum_j W_ij cut_ij g[j]. Every ordered pair runs one MLP
backward on the cotangent g_i x_j cut, as in the reference, giving
gd [S, A, A]; then gpos[i] = -sum_j (gd_ij + gd_ji) u_ij gathers the
reference's scatter to row j (``gpos_ref[0] +=``, cfconv_dense.py:215)
from the transpose. This equals the reference up to summation order, with
the bf16 roundings on the same values.

On the card all four kernels take their filter-MLP products over the
live pairs only (d < rc, i != j): the forward its two, the backward its
four, writing gd = 0 for every other pair; at bf16 on the tensor cores,
at fp32 as register-tiled float32 FMAs on the CUDA cores. That is exact:
W cut vanishes with cut, and ``_pair_gd`` is zero wherever cut and dcut
are.

Widths: on CUDA tensors the wrappers route every (F >= 1, R >= 1) by
``cfconv_general.route(F, R, precision)``: F <= 128 and R <= 64 to the
kernels above (the tuned family, which lays its tiles out for F = 128:
narrower filters are zero-padded to 128, exactly, and the outputs sliced
back), any other width to the general-width kernels of
``csrc/cfconv_general_kernels.cu`` (ops/cfconv_general.py: the tensor
cores at bf16, with the weights staged in shared memory or, where they do
not fit, streamed through it in panels, the "streamed" family; float32
FMAs on the CUDA cores at fp32 and for bf16 widths where neither fits,
the "wide" family).

Dispatch: a wrapper takes its plain twin only for tensors on the CPU. For
CUDA tensors it launches a kernel or raises; there is no fallback. Each
wrapper counts the tuned family's launches in its ``launches`` attribute,
the general, streamed and wide families' in
``cfconv_general.launch_counts()``.

Precision tiers: ``fp32`` and ``bf16`` (operands of the four products
rounded to bf16, everything else float32, at the same places in the
kernels and the twins). ``bf16x3`` takes the fp32 variant, wrapper and
twin: the reference computes this kernel at ``compute_dtype = float32``
with ``HIGHEST`` for every tier but bf16 (cfconv_dense.py:99-103 and :277).
"""

from __future__ import annotations

import math

import torch

from ..models.mlp import check_precision
from ._launch import (RING_MAX, _check, _op, _ptr, _raise_on, _same_device,
                      _stream)
from .cfconv_general import (TUNED_F, general_bwd, general_fwd, route,
                             tuned_operands)

# Molecules per pass of the twins: bounds their [chunk, A, A, F] tensors.
PLAIN_CHUNK = 8


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _pair_geometry(pos, offset, coeff, rcut):
    """rel, d, cut, dcut [S, A, A] (self-pairs masked), e, rbf
    [S, A, A, R] (reference _pair_geometry, cfconv_dense.py:67-94)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]  # [s, i, j] = p_j - p_i
    d = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-12))
    arg = d * (math.pi / rcut)
    eye = torch.eye(d.shape[-1], dtype=torch.bool, device=d.device)
    inside = ((d < rcut) & ~eye).to(d.dtype)
    cut = 0.5 * (torch.cos(arg) + 1.0) * inside
    dcut = (-0.5 * (math.pi / rcut)) * torch.sin(arg) * inside
    e = torch.exp(coeff * torch.square(d[..., None] - offset))
    return rel, d, cut, dcut, e, e * cut[..., None]


def _filter_mlp(rbf, w0, b0, w1, precision):
    """a0 (unrounded), W [S, A, A, F] (reference _filter_mlp3 :97-123)."""
    a0 = torch.tanh(_op(rbf, precision) @ _op(w0, precision) + b0)
    return a0, _op(a0, precision) @ _op(w1, precision)


def _molecule_chunks(n):
    return [slice(s, min(s + PLAIN_CHUNK, n))
            for s in range(0, n, PLAIN_CHUNK)]


def dense_cfconv_fwd_plain(pos, x, w0, b0, w1, offset, coeff, rcut,
                           precision):
    """out [S, A, F], written out over [PLAIN_CHUNK, A, A, F] pair
    tensors."""
    outs = []
    for sl in _molecule_chunks(pos.shape[0]):
        _, _, cut, _, _, rbf = _pair_geometry(pos[sl], offset, coeff, rcut)
        _, w = _filter_mlp(rbf, w0, b0, w1, precision)
        outs.append(torch.sum(w * cut[..., None] * x[sl, None, :, :], dim=2))
    return torch.cat(outs)


def _pair_gd(geometry, x, g, w0, b0, w1, offset, coeff, precision,
             need_gx=True):
    """(gd [S, A, A], gx [S, A, F] or None) from ``_pair_geometry``'s
    output: gd_ij = d(g_i . out_i) / d d_ij for every ordered pair (one MLP
    backward of the cotangent g_i x_j cut each), zero wherever cut and dcut
    are (d >= rc, the diagonal)."""
    _, d, cut, dcut, e, rbf = geometry
    a0, w = _filter_mlp(rbf, w0, b0, w1, precision)
    gi, xj = g[:, :, None, :], x[:, None, :, :]
    cut3 = cut[..., None]
    gx = torch.sum(w * cut3 * g[:, None, :, :], dim=2) if need_gx else None
    s_cut = torch.sum(gi * w * xj, dim=-1)
    ga0 = _op(gi * xj * cut3, precision) @ _op(w1, precision).T
    gt0 = ga0 * (1.0 - a0 * a0)
    grbf = _op(gt0, precision) @ _op(w0, precision).T
    gcut = s_cut + torch.sum(grbf * e, dim=-1)
    ge = grbf * cut3
    gd = torch.sum(ge * e * (2.0 * coeff) * (d[..., None] - offset),
                   dim=-1) + gcut * dcut
    return gd, gx


def _gpos_of_gd(gd, rel, d):
    """gpos[i] = -sum_j (gd_ij + gd_ji) u_ij, [S, A, 3]."""
    gd = gd + gd.transpose(1, 2)
    return -torch.sum(gd[..., None] * (rel / d[..., None]), dim=2)


def dense_cfconv_bwd_plain(pos, x, g, w0, b0, w1, offset, coeff, rcut,
                           precision, need_gx=True):
    """(gpos [S, A, 3], gx [S, A, F] or None): gd per ordered pair, then
    its row-owned gather (module docstring)."""
    gposs, gxs = [], []
    for sl in _molecule_chunks(pos.shape[0]):
        geometry = _pair_geometry(pos[sl], offset, coeff, rcut)
        gd, gx = _pair_gd(geometry, x[sl], g[sl], w0, b0, w1, offset, coeff,
                          precision, need_gx)
        gposs.append(_gpos_of_gd(gd, geometry[0], geometry[1]))
        gxs.append(gx)
    return torch.cat(gposs), (torch.cat(gxs) if need_gx else None)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_weights(w0, b0, w1, offset, coeff, a, f):
    r = w0.shape[0]
    if f < 1 or r < 1 or a > RING_MAX:
        raise ValueError(
            f"dense CFConv kernels take F >= 1, R >= 1 and A <= {RING_MAX} "
            f"(got F={f}, R={r}, A={a})"
        )
    _check("w0", w0, (r, f))
    _check("b0", b0, (f,))
    _check("w1", w1, (f, f))
    _check("offset", offset, (r,))
    _check("coeff", coeff, ())
    return r


def dense_cfconv_fwd(pos, x, w0, b0, w1, offset, coeff, rcut, precision):
    """Forward dense CFConv, [S, A, F] (see module docstring)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return dense_cfconv_fwd_plain(pos, x, w0, b0, w1, offset, coeff, rcut,
                                      precision)
    from ._build import load

    s, a, f = x.shape
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    r = _check_weights(w0, b0, w1, offset, coeff, a, f)
    _same_device(pos, x, w0, b0, w1, offset, coeff)
    if route(f, r, precision)[0] != "tuned":
        return general_fwd(pos, None, None, x, w0, b0, w1, offset, coeff,
                           rcut, precision)
    (x,), w0, b0, w1 = tuned_operands((x,), w0, b0, w1)
    out = torch.empty_like(x)
    rc = load().dense_cfconv_fwd(
        _ptr(pos), _ptr(x), _ptr(w0), _ptr(b0), _ptr(w1), _ptr(offset),
        _ptr(coeff), _ptr(out), s, a, TUNED_F, r, float(rcut),
        int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "dense_cfconv_fwd")
    dense_cfconv_fwd.launches += 1
    return out if f == TUNED_F else out[..., :f].contiguous()


def dense_cfconv_bwd(pos, x, g, w0, b0, w1, offset, coeff, rcut, precision,
                     need_gx=True):
    """(gpos [S, A, 3], gx [S, A, F] or None when ``need_gx`` is False).
    On the card: the pair pass into an [S, A, A] gd workspace, then the
    gpos gather; the two launches count as one."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return dense_cfconv_bwd_plain(pos, x, g, w0, b0, w1, offset, coeff,
                                      rcut, precision, need_gx)
    from ._build import load

    s, a, f = x.shape
    _check("pos", pos, (s, a, 3))
    _check("x", x, (s, a, f))
    _check("g", g, (s, a, f))
    r = _check_weights(w0, b0, w1, offset, coeff, a, f)
    _same_device(pos, x, g, w0, b0, w1, offset, coeff)
    if route(f, r, precision)[0] != "tuned":
        return general_bwd(pos, None, None, None, None, x, g, w0, b0, w1,
                           offset, coeff, rcut, precision, need_gx)
    (x, g), w0, b0, w1 = tuned_operands((x, g), w0, b0, w1)
    gd = torch.empty(s, a, a, dtype=pos.dtype, device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(g) if need_gx else None
    rc = load().dense_cfconv_bwd(
        _ptr(pos), _ptr(x), _ptr(g), _ptr(w0), _ptr(b0), _ptr(w1),
        _ptr(offset), _ptr(coeff), _ptr(gd), _ptr(gpos), _ptr(gx), s, a,
        TUNED_F, r, float(rcut), int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "dense_cfconv_bwd")
    dense_cfconv_bwd.launches += 1
    if gx is not None and f != TUNED_F:
        gx = gx[..., :f].contiguous()
    return gpos, gx


dense_cfconv_fwd.launches = 0
dense_cfconv_bwd.launches = 0

KERNELS = {
    "dense_cfconv_fwd": dense_cfconv_fwd,
    "dense_cfconv_bwd": dense_cfconv_bwd,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _DenseCFConv(torch.autograd.Function):
    """Gradients flow to pos and x only; the weights are frozen at
    simulation time, so their cotangents are None (the reference returns
    zeros, cfconv_dense.py:330-337). The gx half of the backward runs only
    when x needs a gradient (the first block's input derives from the
    embedding alone)."""

    @staticmethod
    def forward(ctx, pos, x, w0, b0, w1, offset, coeff, rcut, precision):
        ctx.save_for_backward(pos, x, w0, b0, w1, offset, coeff)
        ctx.rcut, ctx.precision = rcut, precision
        return dense_cfconv_fwd(pos, x, w0, b0, w1, offset, coeff, rcut,
                                precision)

    @staticmethod
    def backward(ctx, g):
        pos, x, w0, b0, w1, offset, coeff = ctx.saved_tensors
        need_pos, need_x = ctx.needs_input_grad[:2]
        gpos, gx = dense_cfconv_bwd(
            pos, x, g.contiguous(), w0, b0, w1, offset, coeff, ctx.rcut,
            ctx.precision, need_gx=need_x,
        )
        return (gpos if need_pos else None, gx) + (None,) * 7


def dense_cfconv_message(pos, x, w0, b0, w1, offset, coeff, rcut: float,
                         precision: str):
    """Dense all-pairs CFConv message [S, A, F] (reference
    dense_cfconv_message, cfconv_dense.py:221-235, batched)."""
    return _DenseCFConv.apply(pos, x, w0, b0, w1, offset, coeff, float(rcut),
                              precision)
