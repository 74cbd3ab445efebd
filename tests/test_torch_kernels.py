"""Port parity: the Chebyshev kernels' plain PyTorch twins
(flashmd_tpu_torch/ops/cheb_kernel.py) against the JAX package.

fp32: each twin vs its Pallas kernel called directly, in interpreter mode
(conftest sets FLASHMD_PALLAS_INTERPRET=1), at the JAX suite's own kernel
tolerances (tests/ops/test_cheb_kernel.py: 2e-5 forward, 1e-4 backward).
Interpret mode computes "bf16" at fp32 on the CPU, so the bf16 twins are
compared with the pure-jnp branch of models/cheb.py instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.ops.pallas.cheb_kernel import (
    _to_that_basis as j_to_that_basis,
    cheb_conv_bwd_pallas,
    cheb_conv_fwd_pallas,
)
from flashmd_tpu_torch.models.cheb import _lin_slope, fit_chebyshev_filter_host
from flashmd_tpu_torch.models.convert import config_from_kwargs
from flashmd_tpu_torch.ops import cheb_kernel as ck

RCUT = 4.0
F = 16
M1, M2 = 12, 16
S = 2


def _coeffs(seed=0, f=F):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(M1, f)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, f)) / M2).astype(np.float32)
    w0 = rng.normal(size=(f,)).astype(np.float32)
    return c, c2, w0


def _inputs(a, seed=1, f=F):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 6.0, (S, a, 3)).astype(np.float32)
    x = rng.normal(size=(S, a, f)).astype(np.float32)
    g = rng.normal(size=(S, a, f)).astype(np.float32)
    return pos, x, g


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _per_mol(fn, *arrays):
    """Run a per-molecule JAX function over the leading S axis."""
    return np.stack(
        [np.asarray(fn(*(jnp.asarray(a[s]) for a in arrays)))
         for s in range(S)]
    )


@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("a", [23, 48])
def test_fwd_twin_matches_pallas_fp32(a, d_min):
    c, c2, w0 = _coeffs()
    pos, x, _ = _inputs(a)
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    jw_lin = None if w_lin is None else jnp.asarray(w_lin.numpy())
    ref = _per_mol(
        lambda p, xx: cheb_conv_fwd_pallas(
            jnp.asarray(c), jnp.asarray(w0), p, xx, RCUT, "fp32",
            d_min=d_min, w_lin=jw_lin,
        ),
        pos, x,
    )
    out = ck.cheb_conv_fwd(_t(c), _t(w0), _t(pos), _t(x), RCUT, "fp32",
                           d_min, w_lin)
    # 2e-5: the JAX suite's forward kernel tolerance (summation order).
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("a", [23, 48])
def test_bwd_gx_twin_matches_pallas_fp32(a, d_min):
    c, c2, w0 = _coeffs(seed=2)
    pos, x, g = _inputs(a, seed=3)
    ref = _per_mol(
        lambda p, xx, gg: cheb_conv_bwd_pallas(
            jnp.asarray(c), jnp.asarray(c2), jnp.asarray(w0), p, xx, gg,
            RCUT, "fp32", need_gx=True, need_gd=False, d_min=d_min,
        )[1],
        pos, x, g,
    )
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    out = ck.cheb_conv_bwd_gx(_t(c), _t(w0), _t(pos), _t(g), RCUT, "fp32",
                              d_min, w_lin)
    # 1e-4: the JAX suite's backward kernel tolerance.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("a", [23, 48])
def test_bwd_gd_stacked_twin_matches_pallas_fp32(a, d_min):
    nb = 2
    c2_cat = np.concatenate([_coeffs(seed=4 + b)[1] for b in range(nb)], 1)
    pos, x_cat, g_cat = _inputs(a, seed=5, f=nb * F)
    fdim = nb * F
    ref = _per_mol(
        lambda p, xx, gg: cheb_conv_bwd_pallas(
            jnp.zeros((1, fdim), jnp.float32), jnp.asarray(c2_cat),
            jnp.zeros((fdim,), jnp.float32), p, xx, gg, RCUT, "fp32",
            need_gx=False, need_gd=True, d_min=d_min, stacked=True,
        )[0],
        pos, x_cat, g_cat,
    )
    out = ck.cheb_conv_bwd_gd(_t(c2_cat), _t(pos), _t(x_cat), _t(g_cat),
                              RCUT, "fp32", d_min)
    # 1e-4: the JAX suite's backward kernel tolerance.
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_bf16_twins_match_jnp_branch(d_min):
    """bf16 twins vs the pure-jnp _cheb_fwd/_cheb_bwd (cheb.py:619-629,
    672-737). The forward rounds at the same places (Ttil_m, x): only the
    summation order differs, 1e-5 of the output's scale. The backward
    twins round on the kernels' own bases (That_k and q_k g for gx; c2_m g
    for gd) where the jnp branch rounds g, then c_m g, on the Ttil basis:
    two extra bf16 roundings of 2^-9 each, 1e-2 of the output's scale."""
    a = 48
    c, c2, w0 = _coeffs(seed=6)
    pos, x, g = _inputs(a, seed=7)
    jc, jc2, jw0 = (jnp.asarray(v) for v in (c, c2, w0))
    fwd = _per_mol(
        lambda p, xx: jcheb._cheb_fwd(jc, jc2, jw0, p, xx, None, RCUT,
                                      "bf16", True, d_min)[0],
        pos, x,
    )
    bwd = [
        jcheb._cheb_bwd(RCUT, "bf16", True, d_min,
                        (jc, jc2, jw0, jnp.asarray(pos[s]),
                         jnp.asarray(x[s]), None), jnp.asarray(g[s]))
        for s in range(S)
    ]
    gpos_ref = np.stack([np.asarray(b[3]) for b in bwd])
    gx_ref = np.stack([np.asarray(b[4]) for b in bwd])

    tc, tc2, tw0 = _t(c), _t(c2), _t(w0)
    w_lin = _lin_slope(tc2) if d_min > 0 else None
    out = ck.cheb_conv_fwd(tc, tw0, _t(pos), _t(x), RCUT, "bf16", d_min,
                           w_lin).numpy()
    gx = ck.cheb_conv_bwd_gx(tc, tw0, _t(pos), _t(g), RCUT, "bf16", d_min,
                             w_lin).numpy()
    gpos = ck.cheb_conv_bwd_gd(tc2, _t(pos), _t(x), _t(g), RCUT, "bf16",
                               d_min).numpy()

    def rel(a_, b_):
        return np.abs(a_ - b_).max() / np.abs(b_).max()

    assert rel(out, fwd) <= 1e-5
    assert rel(gx, gx_ref) <= 1e-2
    assert rel(gpos, gpos_ref) <= 1e-2


def test_to_that_basis_matches_reference():
    """The port drops the chain-stride padding; the rows it keeps are the
    reference's, exactly."""
    c, _, _ = _coeffs(seed=8)
    q = ck._to_that_basis(_t(c)).numpy()
    q_ref = np.asarray(j_to_that_basis(jnp.asarray(c), 1))
    assert q.shape == (M1 + 1, F)
    np.testing.assert_array_equal(q, q_ref)


@pytest.mark.parametrize("d_min,order_deriv", [(0.0, None), (2.0, 24)])
def test_host_fit_bit_identical(d_min, order_deriv):
    jcfg = JSchNetConfig(
        hidden_channels=F, embedding_size=4, num_filters=F, num_rbf=9,
        num_interactions=1, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), cheb_d_min=d_min,
        message_passing="cheb", cheb_order=M1, cheb_order_deriv=order_deriv,
    )
    params = jinit_schnet(jax.random.PRNGKey(0), jcfg)
    ref = jcheb.fit_chebyshev_filter_host(
        params["interactions"][0], params["rbf"], jcfg, order=M1,
        order_deriv=order_deriv,
    )
    np_params = jax.tree.map(np.asarray, params)
    cfg = config_from_kwargs(
        {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    )
    out = fit_chebyshev_filter_host(
        np_params["interactions"][0], np_params["rbf"], cfg, order=M1,
        order_deriv=order_deriv,
    )
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_precision_tiers():
    c, _, w0 = _coeffs()
    pos, x, _ = _inputs(23)
    with pytest.raises(NotImplementedError):
        ck.cheb_conv_fwd(_t(c), _t(w0), _t(pos), _t(x), RCUT, "bf16x3")
    with pytest.raises(ValueError):
        ck.cheb_conv_fwd(_t(c), _t(w0), _t(pos), _t(x), RCUT, "fp16")


def test_cpu_tensors_never_count_launches():
    """On the CPU the wrapper takes the plain twin, which is no launch."""
    c, _, w0 = _coeffs()
    pos, x, _ = _inputs(23)
    ck.reset_launch_counts()
    ck.cheb_conv_fwd(_t(c), _t(w0), _t(pos), _t(x), RCUT, "fp32")
    assert ck.launch_counts() == {
        "cheb_fwd": 0, "cheb_bwd_gx": 0, "cheb_bwd_gd": 0
    }
