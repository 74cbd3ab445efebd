"""Chebyshev-tabulated continuous-filter convolution (port of
flashmd_tpu/models/cheb.py).

The frozen filter W'(d) is fitted as a Chebyshev series,

    W'(d)    ~= (1-z)^2 sum_m c[m]  T_m(z)
    dW'/dd   ~= (1-z)   sum_m c2[m] T_m(z)

so that every conv becomes a sweep of dense [A, A] @ [A, F] products
(ops/cheb_kernel.py). Two fits, as in the reference:

* ``fit_chebyshev_filter_host``: float64 numpy at attach
  (``attach_cheb_fit``), by projection (``proj``), one weighted least
  squares (``wls``) or Lawson's reweighting toward the weighted minimax
  (``lawson``), after ``config.cheb_fit_method``;
* ``fit_chebyshev_filter``: float32 on the parameters' device, inside the
  autograd graph, by projection only. ``schnet._cheb_blocks`` runs it when
  the parameters carry no fit, or a fit of other orders than the config's.

Two schedules, as in the reference: the whole stack with the deferred,
block-stacked gd backward (``cheb_stack_apply``), and one conv per block
(``cheb_cfconv_apply``, the reference's ``_cheb_cfconv``), around which the
linear layers stay in autograd. Both carry the precision tier (fp32, bf16,
bf16x3) to every kernel launch, forward and backward; the linear layers
run in float32 at every tier.

GRADIENT CONTRACT (inference only, as in the reference): the convs'
backward propagates cotangents to positions and the input features only;
the Chebyshev coefficients' cotangents are exactly zero, or NaN under
``FLASHMD_CHEB_PARAM_GRAD=poison`` (reference ``_param_cotangent``,
cheb.py:638-652). The stack gives every parameter that cotangent; on the
per-block schedule the linear layers get their real gradients.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
import torch

from ..ops.cheb_kernel import (
    _cell_operands,
    _low_matrix,  # noqa: F401  (re-exported: the reference keeps it here)
    cheb_conv_bwd_gd,
    cheb_conv_bwd_gx,
    cheb_conv_bwd_gxgd,
    cheb_conv_fwd,
)
from .cutoff import CosineCutoff, IdentityCutoff, ShiftedCosineCutoff
from .mlp import check_precision, mlp_apply
from .radial_basis import gaussian_basis_apply

LIN_KEYS = ("lin1_w", "lin2_w", "lin2_b", "lin_w", "lin_b")


def resolved_order_deriv(config) -> int:
    """The derivative series' order of a SchNetConfig: ``cheb_order_deriv``,
    or ``cheb_order`` where that is None (reference schnet.py:373)."""
    return config.cheb_order_deriv or config.cheb_order


def _sigma(rcut: float, d_min: float) -> float:
    if not 0.0 <= d_min < rcut:
        raise ValueError(
            f"cheb_d_min must be in [0, rcut) (got {d_min}, rcut {rcut})"
        )
    return (rcut - d_min) / (2.0 * rcut)


def _require_cheb_eligible_cutoff(cut):
    if not isinstance(cut, CosineCutoff) or cut.cutoff_lower != 0:
        raise NotImplementedError(
            "Chebyshev filter fitting requires CosineCutoff with "
            f"cutoff_lower == 0 (got {cut!r})."
        )


def _cutoff_np(cut, d: np.ndarray) -> np.ndarray:
    """float64 numpy copy of the envelopes' ``__call__`` (models/cutoff.py)
    for the host fit (reference _cutoff_np, cheb.py:246-280)."""
    if isinstance(cut, IdentityCutoff):
        return np.ones_like(d)
    if isinstance(cut, CosineCutoff):
        lo, hi = cut.cutoff_lower, cut.cutoff_upper
        if lo > 0:
            c = 0.5 * (np.cos(np.pi * (2 * (d - lo) / (hi - lo) + 1.0))
                       + 1.0)
            return c * (d < hi) * (d > lo)
        return 0.5 * (np.cos(d * np.pi / hi) + 1.0) * (d < hi)
    if isinstance(cut, ShiftedCosineCutoff):
        hi, width = cut.cutoff_upper, cut.smooth_width
        smooth = 0.5 + 0.5 * np.cos(np.pi * (d - hi + width) / width)
        c = np.where(d > hi - width, smooth, 1.0)
        return np.where(d > hi, 0.0, c)
    raise NotImplementedError(f"host fit: unsupported cutoff {cut!r}")


def chebyshev_nodes(n: int, device=None) -> torch.Tensor:
    """Chebyshev-Gauss nodes on (-1, 1), float32 (reference cheb.py:86-89)."""
    k = torch.arange(n, dtype=torch.float32, device=device)
    return torch.cos(math.pi * (k + 0.5) / n)


def _cut_over_u2(u: torch.Tensor, sigma: float = 0.5) -> torch.Tensor:
    """cutoff(d) / (1-z)^2 = (pi sigma / 2)^2 sinc^2(u sigma / 2) with
    u = 1 - z, free of cancellation as u -> 0 (reference cheb.py:102-115;
    ``torch.sinc`` is the normalised sinc, as ``jnp.sinc``)."""
    return (math.pi * sigma / 2.0) ** 2 * torch.square(
        torch.sinc(u * (sigma / 2.0))
    )


def _project(values: torch.Tensor, order: int, n_nodes: int) -> torch.Tensor:
    """Discrete Chebyshev transform at the Chebyshev-Gauss nodes, values
    [N, F] -> [order, F] (reference cheb.py:118-136): a float32 product,
    which TF32 being off (package ``__init__``) keeps at the reference's
    Precision.HIGHEST."""
    m = torch.arange(order, dtype=torch.float32, device=values.device)
    k = torch.arange(n_nodes, dtype=torch.float32, device=values.device)
    tmk = torch.cos(m[:, None] * math.pi * (k[None, :] + 0.5) / n_nodes)
    c = (2.0 / n_nodes) * (tmk @ values)
    half = torch.ones(order, 1, dtype=c.dtype, device=c.device)
    half[0] = 0.5
    return c * half


def fit_chebyshev_filter(block_params, rbf_params, config, order=64,
                         n_nodes=512, order_deriv=None):
    """The filter's and its distance derivative's series, (c [M1, F], c2
    [M2, F], w0 [F]) in float32 on the parameters' device (reference
    fit_chebyshev_filter, cheb.py:139-227).

    The composed filter (the Gaussian basis with its own cutoff, the filter
    MLP at fp32 whatever ``config.precision``, the analytic conv cutoff) is
    evaluated at the Chebyshev nodes in float32 and projected. The MLP
    factor's derivative is forward mode, as the reference's
    ``vmap(jacfwd)``: node k's output depends on d_k alone, so one jvp with
    a tangent of ones gives dM/dd at every node. Everything stays in the
    autograd graph, so the kernels' cotangent of c, c2 and w0 reaches the
    filter parameters as in the reference.
    """
    _require_cheb_eligible_cutoff(config.cutoff)
    if getattr(config, "cheb_fit_method", "proj") != "proj":
        raise NotImplementedError(
            f"cheb_fit_method={config.cheb_fit_method!r} requires the "
            "host-side fit (models/cheb.attach_cheb_fit, done at model "
            "attach); the in-graph fit implements only the projection."
        )
    order_deriv = order if order_deriv is None else order_deriv
    rcut = float(config.cutoff.cutoff_upper)
    d_min = float(config.cheb_d_min)
    sigma = _sigma(rcut, d_min)
    z = chebyshev_nodes(n_nodes, rbf_params["offset"].device)
    d = d_min + (z + 1.0) * ((rcut - d_min) / 2.0)
    u = 1.0 - z

    def w_of_d(dd):
        rbf = gaussian_basis_apply(rbf_params, config.rbf_config, dd)
        return mlp_apply(block_params["filter"], rbf,
                         activation=config.activation, precision="fp32")

    w, dm = torch.func.jvp(w_of_d, (d,), (torch.ones_like(d),))  # [N, F]
    c = _project(w * _cut_over_u2(u, sigma)[:, None], order, n_nodes)
    # dW'/dd / (1-z) = M' u (pi sigma/2)^2 sinc^2(u sigma/2)
    #                  - M (pi^2 sigma / (2 rcut)) sinc(u sigma)
    h2 = (
        dm * (u * _cut_over_u2(u, sigma))[:, None]
        - w * ((math.pi**2 * sigma / (2.0 * rcut))
               * torch.sinc(u * sigma))[:, None]
    )
    c2 = _project(h2, order_deriv, n_nodes)
    # the self-pair value W'(z=-1) = (1-(-1))^2 sum_m c_m T_m(-1)
    return c, c2, 4.0 * _at_minus_one(c)


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def _lawson_coeffs(target, tmk, weight, iters=30):
    """Lawson's iteratively reweighted least squares toward the weighted
    minimax, max_k weight_k |target_k - (T c)_k| per feature (reference
    cheb.py:285-326, float64 numpy). One iteration is the weighted least
    squares. ``weight`` needs a positive floor (the callers add 0.05):
    the raw basis factor vanishes at z = 1 and leaves the fit free there.

    target [N, F], tmk [M, N], weight [N] -> coefficients [M, F].
    """
    T = tmk.T  # [N, M]
    n, n_feat = target.shape
    out = np.empty((tmk.shape[0], n_feat))
    for f in range(n_feat):
        lw = np.full(n, 1.0 / n)
        t = target[:, f]
        c = None
        for _ in range(iters):
            sw = np.sqrt(lw) * weight
            c, *_ = np.linalg.lstsq(T * sw[:, None], t * sw, rcond=None)
            r = np.abs((t - T @ c) * weight)
            lw = lw * r
            s = lw.sum()
            if s <= 0:  # exact fit: any weighting is optimal
                break
            lw /= s
        out[:, f] = c
    return out


def fit_chebyshev_filter_host(block_params, rbf_params, config, order=64,
                              n_nodes=512, order_deriv=None,
                              extra_weight=None, device="cpu"):
    """float64 host fit of the filter and its distance derivative
    (reference cheb.py:329-428), by ``config.cheb_fit_method``: ``proj``
    (the projection), ``wls`` (one weighted least squares) or ``lawson``
    (30 reweightings). The last two weight the delivered quantity's basis
    factor with a floor, (u^2 + 0.05) for c and (u + 0.05) for c2, times
    ``extra_weight(d)`` (float64 node distances -> [N]) where given.

    Returns float32 tensors on ``device``: (c [M1, F], c2 [M2, F], w0 [F]).
    """
    _require_cheb_eligible_cutoff(config.cutoff)
    if config.activation != "tanh":
        raise NotImplementedError("host fit supports tanh filter activations")
    order_deriv = order if order_deriv is None else order_deriv
    rcut = float(config.cutoff.cutoff_upper)
    d_min = float(config.cheb_d_min)
    sigma = _sigma(rcut, d_min)
    k = np.arange(n_nodes, dtype=np.float64)
    z = np.cos(np.pi * (k + 0.5) / n_nodes)
    d = d_min + (z + 1.0) * ((rcut - d_min) / 2.0)
    u = 1.0 - z

    offset = _np64(rbf_params["offset"])
    coeff = np.float64(_np64(rbf_params["coeff"]))
    layers = [
        {kk: _np64(vv) for kk, vv in layer.items()}
        for layer in block_params["filter"]["layers"]
    ]
    rbf_cut = config.rbf_config.cutoff

    def w_of_d(dd):
        rbf = np.exp(coeff * np.square(dd[:, None] - offset[None, :]))
        rbf = rbf * _cutoff_np(rbf_cut, dd)[:, None]
        x = rbf
        for layer in layers[:-1]:
            x = np.tanh(x @ layer["w"] + layer.get("b", 0.0))
        last = layers[-1]
        return x @ last["w"] + last.get("b", 0.0)

    w = w_of_d(d)
    sinc = np.sinc(u * (sigma / 2.0))
    h = w * ((np.pi * sigma / 2.0) ** 2 * sinc * sinc)[:, None]

    m = np.arange(max(order, order_deriv), dtype=np.float64)
    tmk = np.cos(m[:, None] * np.pi * (k[None, :] + 0.5) / n_nodes)

    eps = 1e-6
    dm = (w_of_d(d + eps) - w_of_d(d - eps)) / (2.0 * eps)
    sinc_full = np.sinc(u * sigma)
    h2 = (
        dm * (u * (np.pi * sigma / 2.0) ** 2 * sinc * sinc)[:, None]
        - w * ((np.pi**2 * sigma / (2.0 * rcut)) * sinc_full)[:, None]
    )
    fit_method = getattr(config, "cheb_fit_method", "proj")
    if fit_method == "proj":
        c = (2.0 / n_nodes) * (tmk[:order] @ h)
        c[0] *= 0.5
        c2 = (2.0 / n_nodes) * (tmk[:order_deriv] @ h2)
        c2[0] *= 0.5
    elif fit_method in ("lawson", "wls"):
        ew = 1.0 if extra_weight is None else extra_weight(d)
        iters = 30 if fit_method == "lawson" else 1
        c = _lawson_coeffs(h, tmk[:order], (u**2 + 0.05) * ew, iters=iters)
        c2 = _lawson_coeffs(h2, tmk[:order_deriv], (u + 0.05) * ew,
                            iters=iters)
    else:
        raise ValueError(
            f"unknown cheb_fit_method {fit_method!r} "
            "(expected 'proj', 'wls', or 'lawson')"
        )

    signs = np.where(np.arange(order) % 2 == 0, 1.0, -1.0)
    w0 = 4.0 * (signs @ c)

    def f32(a):
        return torch.as_tensor(
            np.asarray(a, np.float32), dtype=torch.float32, device=device
        )

    return f32(c), f32(c2), f32(w0)


def attach_cheb_fit(params, config):
    """Copy of the SchNet params with host-fitted coefficients under
    ``params["cheb_fit"]`` (reference cheb.py:431-447), on the device of
    the parameters."""
    device = params["embedding"].device
    fits = tuple(
        fit_chebyshev_filter_host(
            bp, params["rbf"], config, order=config.cheb_order,
            order_deriv=resolved_order_deriv(config), device=device,
        )
        for bp in params["interactions"]
    )
    return {**params, "cheb_fit": fits}


def _at_minus_one(c: torch.Tensor) -> torch.Tensor:
    """A series' sum at z = -1, sum_m (-1)^m c[m] -> [F], as
    T_m(-1) = (-1)^m."""
    signs = torch.ones(c.shape[0], dtype=c.dtype, device=c.device)
    signs[1::2] = -1.0
    return signs @ c


def _lin_slope(c2: torch.Tensor) -> torch.Tensor:
    """dW'/dd at the fit-domain floor, 2 sum_m (-1)^m c2[m] -> [F]
    (reference cheb.py:547)."""
    return 2.0 * _at_minus_one(c2)


def _param_cotangent(t: torch.Tensor) -> torch.Tensor:
    if os.environ.get("FLASHMD_CHEB_PARAM_GRAD", "zero") == "poison":
        return torch.full_like(t, float("nan"))
    return torch.zeros_like(t)


class _ChebConv(torch.autograd.Function):
    """One block's Chebyshev CFConv (reference custom VJP _cheb_cfconv,
    cheb.py:563-772). Forward: the cheb_fwd kernel. Backward with
    ``need_gx``: gx and gpos in one cheb_bwd_gxgd launch; without it (block
    1, whose input is the position-independent embedding): the gd-only
    kernel on this block's [S, A, F] operands, gx zeros. c, c2 and w0 get
    the contract's cotangent; ``cell``/``inv`` ([S, 3, 3] or None) none."""

    @staticmethod
    def forward(ctx, rcut, precision, need_gx, d_min, cell, inv, c, c2, w0,
                pos, x):
        w_lin = _lin_slope(c2) if d_min > 0 else None
        out = cheb_conv_fwd(c, w0, pos, x, rcut, precision, d_min, w_lin,
                            cell, inv)
        ctx.rcut, ctx.precision, ctx.d_min = rcut, precision, d_min
        ctx.need_gx, ctx.w_lin = need_gx, w_lin
        ctx.cell, ctx.inv = cell, inv
        ctx.save_for_backward(c, c2, w0, pos, x)
        return out

    @staticmethod
    def backward(ctx, g):
        c, c2, w0, pos, x = ctx.saved_tensors
        g = g.contiguous()
        args = (ctx.rcut, ctx.precision, ctx.d_min)
        if ctx.need_gx:
            gpos, gx = cheb_conv_bwd_gxgd(c, c2, w0, pos, x, g, *args,
                                          ctx.w_lin, ctx.cell, ctx.inv)
        else:
            gpos = cheb_conv_bwd_gd(c2, pos, x, g, *args, ctx.cell, ctx.inv)
            gx = torch.zeros_like(x)
        needs = ctx.needs_input_grad
        return (
            None, None, None, None, None, None,
            *(_param_cotangent(t) if needs[6 + i] else None
              for i, t in enumerate((c, c2, w0))),
            gpos if needs[9] else None,
            gx if needs[10] else None,
        )


def cheb_cfconv_apply(c, c2, w0, pos, x, rcut, precision="bf16",
                      need_gx=True, cell=None, d_min=0.0, inv=None):
    """One block's conv, [S, A, F] (reference cheb_cfconv_apply,
    cheb.py:497-544): c [M1, F], c2 [M2, F], w0 [F], pos [S, A, 3], x
    [S, A, F]. ``need_gx=False`` drops the gx half of the backward (block
    1). ``cell`` None, [3, 3] or [S, 3, 3]; ``inv``, its inverse, may be
    passed so that a force evaluation computes it once."""
    check_precision(precision)
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device, inv)
    return _ChebConv.apply(float(rcut), precision, bool(need_gx),
                           float(d_min), cell, inv, c, c2, w0, pos, x)


class _ChebStack(torch.autograd.Function):
    """Whole interaction stack with the deferred, block-stacked gd
    backward (reference _cheb_stack_fwd/_cheb_stack_bwd, cheb.py:837-907).

    Forward per block: lin1 -> cheb_fwd kernel -> lin2 -> tanh -> lin,
    residual. Backward: the hand-rolled chain rule through the blocks,
    the gx-only kernel for blocks 1..B-1 (block 0's input is the
    position-independent embedding) and ONE gd kernel over the stacked
    [S, A, B*F] operands. The linear layers run in float32: the
    reference's DEFAULT-precision dot is float32 everywhere but on the
    TPU's matrix unit.

    ``cell`` is None or [S, 3, 3] with its inverse ``inv``, both computed
    once per force evaluation (by ``cheb_stack_apply``) and handed to every
    launch, forward and backward; the cell gets no gradient (reference
    _cell_cotangent, cheb.py:633-635).
    """

    @staticmethod
    def forward(ctx, rcut, precision, d_min, n_blocks, cell, inv, pos, x0,
                *flat):
        fits, lins = _unflatten(flat, n_blocks)
        w_lins = [
            _lin_slope(c2) if d_min > 0 else None for (_, c2, _) in fits
        ]
        x = x0
        hs, ts = [], []
        for (c, _c2, w0), lp, w_lin in zip(fits, lins, w_lins):
            h = x @ lp["lin1_w"]
            agg = cheb_conv_fwd(c, w0, pos, h, rcut, precision, d_min, w_lin,
                                cell, inv)
            t = torch.tanh(agg @ lp["lin2_w"] + lp["lin2_b"])
            x = x + t @ lp["lin_w"] + lp["lin_b"]
            hs.append(h)
            ts.append(t)
        ctx.rcut, ctx.precision, ctx.d_min = rcut, precision, d_min
        ctx.n_blocks = n_blocks
        ctx.w_lins = w_lins
        ctx.cell, ctx.inv = cell, inv
        ctx.save_for_backward(pos, *hs, *ts, *flat)
        return x

    @staticmethod
    def backward(ctx, g_out):
        nb = ctx.n_blocks
        saved = ctx.saved_tensors
        pos = saved[0]
        hs = saved[1:1 + nb]
        ts = saved[1 + nb:1 + 2 * nb]
        flat = saved[1 + 2 * nb:]
        fits, lins = _unflatten(flat, nb)
        rcut, precision, d_min = ctx.rcut, ctx.precision, ctx.d_min
        g = g_out
        g_aggs = [None] * nb
        for b in range(nb - 1, -1, -1):
            c, _c2, w0 = fits[b]
            lp = lins[b]
            gt = g @ lp["lin_w"].T
            gy = gt * (1.0 - ts[b] * ts[b])
            g_agg = gy @ lp["lin2_w"].T
            g_aggs[b] = g_agg
            if b > 0:
                gh = cheb_conv_bwd_gx(
                    c, w0, pos, g_agg, rcut, precision, d_min, ctx.w_lins[b],
                    ctx.cell, ctx.inv,
                )
                g = g + gh @ lp["lin1_w"].T
        c2_cat = torch.cat([f[1] for f in fits], dim=1)
        x_cat = torch.cat(hs, dim=-1)
        g_cat = torch.cat(g_aggs, dim=-1)
        gpos = cheb_conv_bwd_gd(c2_cat, pos, x_cat, g_cat, rcut, precision,
                                d_min, ctx.cell, ctx.inv)
        needs = ctx.needs_input_grad
        param_grads = tuple(
            _param_cotangent(t) if needs[8 + i] else None
            for i, t in enumerate(flat)
        )
        return (
            None, None, None, None, None, None,
            gpos if needs[6] else None,
            g if needs[7] else None,
            *param_grads,
        )


def _flatten(fits, lins):
    flat = []
    for (c, c2, w0), lp in zip(fits, lins):
        flat += [c, c2, w0] + [lp[k] for k in LIN_KEYS]
    return flat


def _unflatten(flat, n_blocks):
    per = 3 + len(LIN_KEYS)
    fits, lins = [], []
    for b in range(n_blocks):
        chunk = flat[b * per:(b + 1) * per]
        fits.append(tuple(chunk[:3]))
        lins.append(dict(zip(LIN_KEYS, chunk[3:])))
    return fits, lins


def cheb_stack_apply(fits: Sequence, lins: Sequence, pos, x0, rcut,
                     precision="bf16", cell=None, d_min=0.0):
    """Run the full interaction stack (reference cheb.py:798-826).

    fits: per-block (c [M1, F], c2 [M2, F], w0 [F]); every block shares
    M2. lins: per-block dicts with lin1_w, lin2_w, lin2_b, lin_w, lin_b.
    pos [S, A, 3]; x0 [S, A, H]; ``cell`` None (open boundaries), [3, 3]
    (shared) or [S, 3, 3] (per molecule) switches every conv to the
    minimum image. Returns [S, A, H].
    """
    check_precision(precision)
    if len({f[1].shape[0] for f in fits}) != 1:
        raise ValueError(
            "cheb_stack_apply requires every block to share the "
            "derivative-series order."
        )
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device)
    return _ChebStack.apply(
        float(rcut), precision, float(d_min), len(fits), cell, inv, pos, x0,
        *_flatten(fits, lins),
    )
