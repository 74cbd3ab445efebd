"""Neighbour-matrix exact-filter CFConv: wrappers, plain PyTorch twins,
launch counts and the autograd Function.

Port of flashmd_tpu/ops/pallas/cfconv.py. The CUDA sources are in
``flashmd_tpu_torch/csrc/cfconv_kernels.cu`` (built by ``ops/_build.py``):

==========  ==============================================================
wrapper     replaces (flashmd_tpu/ops/pallas/cfconv.py)
==========  ==============================================================
cfconv_fwd  ``_fwd_kernel`` (:137), via ``fused_cfconv_message`` (:252)
cfconv_bwd  ``_bwd_kernel`` (:163), its custom VJP ``_fused_cfconv_bwd``
==========  ==============================================================

    out[s, i] = sum_{k: mask} W(d_ik) * cut(d_ik) * x[s, idx[s, i, k]],
    W = tanh(rbf @ w0 + b0) @ w1,  rbf = exp(coeff (d - offset)^2) cut.

Operands carry the batch as their leading axis: ``pos [S, A, 3]``,
``x``/``g`` ``[S, A, F]``, the neighbour matrix ``idx [S, A, K]`` (int32)
and ``mask [S, A, K]`` (bool) of ops/neighborlist.py; ``w0 [R, F]``,
``b0 [F]``, ``w1 [F, F]``, ``offset [R]``, ``coeff []``. Masked slots (which
hold the row's own index) add exactly zero, as the reference's mask folded
into the one-hot (cfconv.py:86-94).

The backward returns gpos and gx. Per slot it runs one MLP backward on
the cotangent g_i x_j cut, as the reference (rounding points :204-222),
giving gd [S, A, K]; the row side is gpos[i] -= sum_k gd_ik u_ik and the
column side gpos[j] += gd_ik u_ik, gx[j] += g_i W_ik cut_ik over the slots
with idx = j. The twin (``_slot_gd``, then ``_slot_sums``) scatters the
column side with ``index_add_``; the kernels gather it through the source
CSR of the list (neighborlist.py), with no atomics.

On the card every kernel with a filter MLP runs over the live slots only
(mask set and d < rc, voted over all K slots of a row: between rebuilds
the live slots of a row need not be its first): the bf16 ones on the
tensor cores, the fp32 ones as register-tiled float32 FMAs on the CUDA
cores, 16 live slots of a work item's rows at a time. The forward adds
nothing for the others, the backward writes gd = 0 for them: exact, as
the twins' MLP products enter only through cut and dcut, which are zero
there. The forward sums each row's (W cut) x_j in slot order, so a row
with no live slot is exactly zero. The bf16 backward's gx pass computes W
of each live incoming slot again over the source CSR, so it needs no
[S, A, K, F] workspace; the fp32 backward's first pass stores W of each
live slot in that workspace (1.5 GB at S = 128, A = 266, K = 88), which
its gx pass reads back.

Widths: on CUDA tensors the wrappers route every (F >= 1, R >= 1) by
``cfconv_general.route(F, R, precision)``: F <= 128 and R <= 64 to the
kernels above (the tuned family, which lays its tiles out for F = 128:
narrower filters are zero-padded to 128, exactly, and the outputs sliced
back), any other width to the general-width kernels of
``csrc/cfconv_general_kernels.cu`` (ops/cfconv_general.py: the tensor
cores at bf16, with the weights staged in shared memory or, where they do
not fit, streamed through it in panels, the "streamed" family; float32
FMAs on the CUDA cores at fp32 and for bf16 widths where neither fits,
the "wide" family; gx computing W again over
the source CSR).

Dispatch: a wrapper takes its plain twin only for tensors on the CPU. For
CUDA tensors it launches a kernel or raises; there is no fallback. Each
wrapper counts the tuned family's launches in its ``launches`` attribute,
the general, streamed and wide families' in
``cfconv_general.launch_counts()``.

Precision tiers: ``fp32`` and ``bf16`` (operands of the four products
rounded to bf16, everything else float32, at the same places in the
kernels and the twins). ``bf16x3`` takes the fp32 variant, wrapper and
twin: the reference computes this kernel at ``compute_dtype = float32``
with ``HIGHEST`` for every tier but bf16 (cfconv.py:322).
"""

from __future__ import annotations

import math

import torch

from ..models.mlp import check_precision
from ._launch import (RING_MAX, _check, _op, _ptr, _raise_on, _same_device,
                      _stream)
from .cfconv_general import (TUNED_F, general_bwd, general_fwd, route,
                             tuned_operands)

# Molecules per pass of the twins: bounds their [chunk, A, K, F] tensors.
PLAIN_CHUNK = 8


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _gather_rows(t, idx):
    """t [s, A, C] at idx [s, A, K] -> [s, A, K, C]."""
    b = torch.arange(t.shape[0], device=t.device)[:, None, None]
    return t[b, idx.long()]


def _slot_geometry(pos, idx, mask, offset, coeff, rcut):
    """rel [s, A, K, 3], d, cut, dcut [s, A, K] (masked slots zero), e,
    rbf [s, A, K, R] (reference _tile_geometry, cfconv.py:77-108)."""
    rel = _gather_rows(pos, idx) - pos[:, :, None, :]
    d = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-12))
    arg = d * (math.pi / rcut)
    inside = ((d < rcut) & mask).to(d.dtype)
    cut = 0.5 * (torch.cos(arg) + 1.0) * inside
    dcut = (-0.5 * (math.pi / rcut)) * torch.sin(arg) * inside
    e = torch.exp(coeff * torch.square(d[..., None] - offset))
    return rel, d, cut, dcut, e, e * cut[..., None]


def _filter_mlp(rbf, w0, b0, w1, precision):
    """a0 (unrounded), W [s, A, K, F] (reference _filter_mlp :111-134)."""
    a0 = torch.tanh(_op(rbf, precision) @ _op(w0, precision) + b0)
    return a0, _op(a0, precision) @ _op(w1, precision)


def _molecule_chunks(n):
    return [slice(s, min(s + PLAIN_CHUNK, n))
            for s in range(0, n, PLAIN_CHUNK)]


def cfconv_fwd_plain(pos, idx, mask, x, w0, b0, w1, offset, coeff, rcut,
                     precision):
    """out [S, A, F], written out over [PLAIN_CHUNK, A, K, F] slot
    tensors."""
    outs = []
    for sl in _molecule_chunks(pos.shape[0]):
        _, _, cut, _, _, rbf = _slot_geometry(pos[sl], idx[sl], mask[sl],
                                              offset, coeff, rcut)
        _, w = _filter_mlp(rbf, w0, b0, w1, precision)
        xj = _gather_rows(x[sl], idx[sl])
        outs.append(torch.sum(w * cut[..., None] * xj, dim=2))
    return torch.cat(outs)


def _slot_gd(geometry, xj, gi, w0, b0, w1, offset, coeff, precision):
    """(gd [s, A, K], W [s, A, K, F]) from ``_slot_geometry``'s output, the
    partners' x ``xj`` [s, A, K, F] and the rows' g ``gi`` [s, A, 1, F]:
    gd_ik = d(g_i . out_i) / d d_ik per slot (one MLP backward of the
    cotangent g_i x_j cut each), zero wherever cut and dcut are (masked
    slots, d >= rc)."""
    _, d, cut, dcut, e, rbf = geometry
    a0, w = _filter_mlp(rbf, w0, b0, w1, precision)
    cut3 = cut[..., None]
    s_cut = torch.sum(gi * w * xj, dim=-1)
    ga0 = _op(gi * xj * cut3, precision) @ _op(w1, precision).T
    gt0 = ga0 * (1.0 - a0 * a0)
    grbf = _op(gt0, precision) @ _op(w0, precision).T
    gcut = s_cut + torch.sum(grbf * e, dim=-1)
    ge = grbf * cut3
    gd = torch.sum(ge * e * (2.0 * coeff) * (d[..., None] - offset),
                   dim=-1) + gcut * dcut
    return gd, w


def _slot_sums(geometry, idx, gd, w, gi, need_gx):
    """(gpos [s, A, 3], gx [s, A, F] or None) of per-slot gd and W: the row
    side, and the column side scattered to idx with ``index_add_``."""
    rel, d, cut = geometry[:3]
    s, a, k = idx.shape
    # Flat destination rows of the column side.
    col = (torch.arange(s, device=idx.device)[:, None, None] * a
           + idx.long()).reshape(-1)
    gx = None
    if need_gx:
        gx = torch.zeros(s * a, w.shape[-1], dtype=w.dtype, device=w.device)
        gx.index_add_(0, col, (gi * w * cut[..., None]).reshape(s * a * k, -1))
        gx = gx.view(s, a, -1)
    gp = gd[..., None] * (rel / d[..., None])
    gpos = -torch.sum(gp, dim=2).reshape(s * a, 3)
    gpos.index_add_(0, col, gp.reshape(s * a * k, 3))
    return gpos.view(s, a, 3), gx


def cfconv_bwd_plain(pos, idx, mask, x, g, w0, b0, w1, offset, coeff, rcut,
                     precision, need_gx=True):
    """(gpos [S, A, 3], gx [S, A, F] or None): gd per slot, its row side,
    and the column side scattered to idx with ``index_add_``."""
    gposs, gxs = [], []
    for sl in _molecule_chunks(pos.shape[0]):
        ix = idx[sl]
        geometry = _slot_geometry(pos[sl], ix, mask[sl], offset, coeff, rcut)
        gi, xj = g[sl, :, None, :], _gather_rows(x[sl], ix)
        gd, w = _slot_gd(geometry, xj, gi, w0, b0, w1, offset, coeff,
                         precision)
        gpos, gx = _slot_sums(geometry, ix, gd, w, gi, need_gx)
        gposs.append(gpos)
        gxs.append(gx)
    return torch.cat(gposs), (torch.cat(gxs) if need_gx else None)


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _check_operands(pos, idx, mask, x, w0, b0, w1, offset, coeff):
    """(S, A, K, F, R) after the checks every launch needs."""
    s, a, f = x.shape
    k = idx.shape[-1]
    r = w0.shape[0]
    if f < 1 or r < 1:
        raise ValueError(f"neighbour-matrix CFConv kernels take F >= 1 and "
                         f"R >= 1 (got F={f}, R={r})")
    if s * a * k >= 2 ** 31:
        raise ValueError(f"S * A * K = {s * a * k} slots exceed int32")
    if max(a, k) > RING_MAX:
        raise ValueError(f"neighbour-matrix CFConv kernels take A, K <= "
                         f"{RING_MAX} (got A={a}, K={k})")
    _check("pos", pos, (s, a, 3))
    _check("idx", idx, (s, a, k), torch.int32)
    _check("mask", mask, (s, a, k), torch.bool)
    _check("x", x, (s, a, f))
    _check("w0", w0, (r, f))
    _check("b0", b0, (f,))
    _check("w1", w1, (f, f))
    _check("offset", offset, (r,))
    _check("coeff", coeff, ())
    _same_device(pos, idx, mask, x, w0, b0, w1, offset, coeff)
    return s, a, k, f, r


def cfconv_fwd(pos, idx, mask, x, w0, b0, w1, offset, coeff, rcut,
               precision):
    """Forward neighbour-matrix CFConv, [S, A, F] (module docstring)."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cfconv_fwd_plain(pos, idx, mask, x, w0, b0, w1, offset, coeff,
                                rcut, precision)
    from ._build import load

    s, a, k, f, r = _check_operands(pos, idx, mask, x, w0, b0, w1, offset,
                                    coeff)
    if route(f, r, precision)[0] != "tuned":
        return general_fwd(pos, idx, mask, x, w0, b0, w1, offset, coeff,
                           rcut, precision)
    (x,), w0, b0, w1 = tuned_operands((x,), w0, b0, w1)
    out = torch.empty_like(x)
    rc = load().cfconv_fwd(
        _ptr(pos), _ptr(idx), _ptr(mask), _ptr(x), _ptr(w0), _ptr(b0),
        _ptr(w1), _ptr(offset), _ptr(coeff), _ptr(out), s, a, k, TUNED_F, r,
        float(rcut), int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "cfconv_fwd")
    cfconv_fwd.launches += 1
    return out if f == TUNED_F else out[..., :f].contiguous()


def cfconv_bwd(pos, idx, mask, csr_offsets, csr_slots, x, g, w0, b0, w1,
               offset, coeff, rcut, precision, need_gx=True):
    """(gpos [S, A, 3], gx [S, A, F] or None when ``need_gx`` is False).
    ``csr_offsets``/``csr_slots`` are the list's source CSR
    (ops/neighborlist.py); the twin does not need them. On the card: the
    slot pass into an [S, A, K] gd workspace (tuned fp32 with gx: also W
    of each live slot into an [S, A, K, F] one), the gpos pass, and the gx
    pass over the CSR (tuned bf16 and the general family: it computes W
    again); the launches count as one."""
    check_precision(precision)
    if pos.device.type == "cpu":
        return cfconv_bwd_plain(pos, idx, mask, x, g, w0, b0, w1, offset,
                                coeff, rcut, precision, need_gx)
    from ._build import load

    s, a, k, f, r = _check_operands(pos, idx, mask, x, w0, b0, w1, offset,
                                    coeff)
    _check("g", g, (s, a, f))
    _check("csr_offsets", csr_offsets, (s * a + 1,), torch.int32)
    _check("csr_slots", csr_slots, (s * a * k,), torch.int32)
    _same_device(pos, g, csr_offsets, csr_slots)
    if route(f, r, precision)[0] != "tuned":
        return general_bwd(pos, idx, mask, csr_offsets, csr_slots, x, g, w0,
                           b0, w1, offset, coeff, rcut, precision, need_gx)
    (x, g), w0, b0, w1 = tuned_operands((x, g), w0, b0, w1)
    gd = torch.empty(s, a, k, dtype=pos.dtype, device=pos.device)
    gpos = torch.empty_like(pos)
    gx = torch.empty_like(g) if need_gx else None
    wbuf = (torch.empty(s, a, k, TUNED_F, dtype=pos.dtype, device=pos.device)
            if need_gx and precision != "bf16" else None)
    rc = load().cfconv_bwd(
        _ptr(pos), _ptr(idx), _ptr(mask), _ptr(csr_offsets), _ptr(csr_slots),
        _ptr(x), _ptr(g), _ptr(w0), _ptr(b0), _ptr(w1), _ptr(offset),
        _ptr(coeff), _ptr(gd), _ptr(wbuf), _ptr(gpos), _ptr(gx), s, a, k,
        TUNED_F, r, float(rcut), int(precision == "bf16"), _stream(),
    )
    _raise_on(rc, "cfconv_bwd")
    cfconv_bwd.launches += 1
    if gx is not None and f != TUNED_F:
        gx = gx[..., :f].contiguous()
    return gpos, gx


cfconv_fwd.launches = 0
cfconv_bwd.launches = 0

KERNELS = {
    "cfconv_fwd": cfconv_fwd,
    "cfconv_bwd": cfconv_bwd,
}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class _FusedCFConv(torch.autograd.Function):
    """Gradients flow to pos and x only; the weights are frozen at
    simulation time, so their cotangents are None (the reference returns
    zeros, cfconv.py:382-391). The gx pass runs only when x needs a
    gradient (the first block's input derives from the embedding alone)."""

    @staticmethod
    def forward(ctx, pos, x, nbr, w0, b0, w1, offset, coeff, rcut,
                precision):
        ctx.save_for_backward(pos, x, w0, b0, w1, offset, coeff)
        ctx.nbr, ctx.rcut, ctx.precision = nbr, rcut, precision
        return cfconv_fwd(pos, nbr.idx, nbr.mask, x, w0, b0, w1, offset,
                          coeff, rcut, precision)

    @staticmethod
    def backward(ctx, g):
        pos, x, w0, b0, w1, offset, coeff = ctx.saved_tensors
        nbr = ctx.nbr
        need_pos, need_x = ctx.needs_input_grad[:2]
        gpos, gx = cfconv_bwd(
            pos, nbr.idx, nbr.mask, nbr.csr_offsets, nbr.csr_slots, x,
            g.contiguous(), w0, b0, w1, offset, coeff, ctx.rcut,
            ctx.precision, need_gx=need_x,
        )
        return (gpos if need_pos else None, gx) + (None,) * 8


def fused_cfconv_message(pos, x, nbr, w0, b0, w1, offset, coeff,
                         rcut: float, precision: str):
    """Neighbour-matrix CFConv message [S, A, F] over ``nbr`` (a batched
    ops.neighborlist.NeighborMatrix; reference fused_cfconv_message,
    cfconv.py:252-269, batched)."""
    return _FusedCFConv.apply(pos, x, nbr, w0, b0, w1, offset, coeff,
                              float(rcut), precision)
