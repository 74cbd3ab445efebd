"""Chebyshev-tabulated continuous-filter convolution (port of
flashmd_tpu/models/cheb.py).

The frozen filter W'(d) is fitted once on the host in float64,

    W'(d)    ~= (1-z)^2 sum_m c[m]  T_m(z)
    dW'/dd   ~= (1-z)   sum_m c2[m] T_m(z)

so that every conv becomes a sweep of dense [A, A] @ [A, F] products
(ops/cheb_kernel.py). Only the host fit (``proj`` method) is ported; the
in-jit fit is not, because attach always fits on the host.

GRADIENT CONTRACT (inference only, as in the reference): the stack's
backward propagates cotangents to positions and the input features only;
every parameter cotangent is exactly zero, or NaN under
``FLASHMD_CHEB_PARAM_GRAD=poison`` (reference ``_param_cotangent``,
cheb.py:638-652).
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np
import torch

from ..ops.cheb_kernel import (
    _low_matrix,  # noqa: F401  (re-exported: the reference keeps it here)
    cheb_conv_bwd_gd,
    cheb_conv_bwd_gx,
    cheb_conv_fwd,
)
from .cutoff import CosineCutoff
from .mlp import check_precision

LIN_KEYS = ("lin1_w", "lin2_w", "lin2_b", "lin_w", "lin_b")


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


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float64)


def fit_chebyshev_filter_host(block_params, rbf_params, config, order=64,
                              n_nodes=512, order_deriv=None, device="cpu"):
    """float64 host fit of the filter and its distance derivative
    (reference cheb.py:329-428, ``proj`` method only).

    Returns float32 tensors on ``device``: (c [M1, F], c2 [M2, F], w0 [F]).
    """
    _require_cheb_eligible_cutoff(config.cutoff)
    if getattr(config, "cheb_fit_method", "proj") != "proj":
        raise NotImplementedError(
            f"cheb_fit_method={config.cheb_fit_method!r} is not ported; "
            "flashmd_tpu_torch fits by projection ('proj') only"
        )
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

    def cutoff_np(dd):
        return (
            0.5 * (np.cos(dd * np.pi / rbf_cut.cutoff_upper) + 1.0)
            * (dd < rbf_cut.cutoff_upper)
        )

    def w_of_d(dd):
        rbf = np.exp(coeff * np.square(dd[:, None] - offset[None, :]))
        rbf = rbf * cutoff_np(dd)[:, None]
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
    c = (2.0 / n_nodes) * (tmk[:order] @ h)
    c[0] *= 0.5
    c2 = (2.0 / n_nodes) * (tmk[:order_deriv] @ h2)
    c2[0] *= 0.5

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
            order_deriv=config.cheb_order_deriv, device=device,
        )
        for bp in params["interactions"]
    )
    return {**params, "cheb_fit": fits}


def _lin_slope(c2: torch.Tensor) -> torch.Tensor:
    """dW'/dd at the fit-domain floor, 2 sum_m (-1)^m c2[m] -> [F]
    (reference cheb.py:547)."""
    signs = torch.ones(c2.shape[0], dtype=c2.dtype, device=c2.device)
    signs[1::2] = -1.0
    return 2.0 * (signs @ c2)


def _param_cotangent(t: torch.Tensor) -> torch.Tensor:
    if os.environ.get("FLASHMD_CHEB_PARAM_GRAD", "zero") == "poison":
        return torch.full_like(t, float("nan"))
    return torch.zeros_like(t)


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
    """

    @staticmethod
    def forward(ctx, rcut, precision, d_min, n_blocks, pos, x0, *flat):
        fits, lins = _unflatten(flat, n_blocks)
        w_lins = [
            _lin_slope(c2) if d_min > 0 else None for (_, c2, _) in fits
        ]
        x = x0
        hs, ts = [], []
        for (c, _c2, w0), lp, w_lin in zip(fits, lins, w_lins):
            h = x @ lp["lin1_w"]
            agg = cheb_conv_fwd(c, w0, pos, h, rcut, precision, d_min, w_lin)
            t = torch.tanh(agg @ lp["lin2_w"] + lp["lin2_b"])
            x = x + t @ lp["lin_w"] + lp["lin_b"]
            hs.append(h)
            ts.append(t)
        ctx.rcut, ctx.precision, ctx.d_min = rcut, precision, d_min
        ctx.n_blocks = n_blocks
        ctx.w_lins = w_lins
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
                    c, w0, pos, g_agg, rcut, precision, d_min, ctx.w_lins[b]
                )
                g = g + gh @ lp["lin1_w"].T
        c2_cat = torch.cat([f[1] for f in fits], dim=1)
        x_cat = torch.cat(hs, dim=-1)
        g_cat = torch.cat(g_aggs, dim=-1)
        gpos = cheb_conv_bwd_gd(c2_cat, pos, x_cat, g_cat, rcut, precision,
                                d_min)
        needs = ctx.needs_input_grad
        param_grads = tuple(
            _param_cotangent(t) if needs[6 + i] else None
            for i, t in enumerate(flat)
        )
        return (
            None, None, None, None,
            gpos if needs[4] else None,
            g if needs[5] else None,
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
                     precision="bf16", d_min=0.0):
    """Run the full interaction stack (reference cheb.py:798-826).

    fits: per-block (c [M1, F], c2 [M2, F], w0 [F]); every block shares
    M2. lins: per-block dicts with lin1_w, lin2_w, lin2_b, lin_w, lin_b.
    pos [S, A, 3]; x0 [S, A, H]. Returns [S, A, H].
    """
    check_precision(precision)
    if len({f[1].shape[0] for f in fits}) != 1:
        raise ValueError(
            "cheb_stack_apply requires every block to share the "
            "derivative-series order."
        )
    return _ChebStack.apply(
        float(rcut), precision, float(d_min), len(fits), pos, x0,
        *_flatten(fits, lins),
    )
