"""The invariant that lets the tensor-core dense kernels skip dead pairs.

``dense_cfconv_bwd`` at bf16 compacts the live pairs of its rows (d < rc,
i != j, in range) and runs the four filter-MLP products over those only,
writing gd = 0 for every other pair of the [S, A, A] workspace, which the
gpos gather then reads; ``dense_cfconv_fwd`` at bf16 runs its two products
over the same live pairs only. That is exact because the twin's per-pair
distance gradient, and its message W cut x_j, vanish wherever cut and dcut
do. Here, on the CPU, at fp32 and bf16: the twin's gd
(``cfconv_dense._pair_gd``) is exactly zero on every pair at d >= rc, on
the diagonal and on padding atoms parked beyond the cutoff (as a padded
tile's slots carry no pair); a copy of the backward twin with every MLP
product of those pairs zeroed gives gpos and gx equal (torch.equal) to
``dense_cfconv_bwd_plain``, with and without gx, and a copy of the forward
twin with their W zeroed gives ``dense_cfconv_fwd_plain``'s output, on
two-cluster positions with a ragged atom count (not a multiple of 16).

``dense_cfconv_bwd`` at fp32 runs the same live pairs (the bf16 kernel's
ring) through float32 FMAs on the CUDA cores: a ring-order emulation that
runs the MLP backward only on each row's live pairs, in column order,
writes gd = 0 on every other pair and sums gx per row in ring order
equals ``dense_cfconv_bwd_plain`` at fp32 within 1e-5 of max|twin|, and
the reference's ``_dense_cfconv_bwd`` (Pallas, interpreted) within 1e-5,
with gx and without, on the clusters with a lone atom (a row with no
live pair). ``dense_cfconv_fwd`` at fp32 runs the backward's ring and
first two products: its emulation (each row's live pairs in column order,
out summed per row in ring order) equals ``dense_cfconv_fwd_plain`` at
fp32 and the reference's ``_dense_cfconv_fwd`` (Pallas, interpreted)
within 1e-5 of max|twin|, on the lone-atom clusters, ragged and padded.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.ops.pallas.cfconv_dense import (_dense_cfconv_bwd,
                                                 _dense_cfconv_fwd)
from flashmd_tpu_torch.ops import cfconv_dense as cd
from flashmd_tpu_torch.ops._launch import _op
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
A = 45  # not a multiple of 16
F = 16
R = 9
S = 2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clusters(seed=0, a=A):
    """[S, a, 3]: two compact clusters 3 RCUT apart, split at atom 21 (not
    on a tile boundary): live pairs within each, none across."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=1.0, size=(S, a, 3)).astype(np.float32)
    pos[:, 21:, 0] += 3 * RCUT
    return pos + 5.0


def _operands(a=A, seed=1):
    rng = np.random.default_rng(seed)
    offset = np.linspace(0.0, RCUT, R).astype(np.float32)
    return (
        _t(rng.normal(size=(S, a, F)).astype(np.float32)),
        _t(rng.normal(size=(S, a, F)).astype(np.float32)),
        (_t((rng.normal(size=(R, F)) / np.sqrt(R)).astype(np.float32)),
         _t((0.1 * rng.normal(size=F)).astype(np.float32)),
         _t((rng.normal(size=(F, F)) / np.sqrt(F)).astype(np.float32)),
         _t(offset),
         torch.tensor(-0.5 / float(offset[1] - offset[0]) ** 2)),
    )


def _padded(pos, n_pad=3):
    """pos with n_pad atoms appended on a line 3 RCUT beyond every atom
    and 2 RCUT apart: no pair of theirs lies within the cutoff."""
    far = pos.max(axis=(0, 1))[0] + 3 * RCUT
    extra = np.zeros((S, n_pad, 3), np.float32)
    extra[:, :, 0] = far + 2 * RCUT * np.arange(n_pad)
    return np.concatenate([pos, extra], axis=1)


def _dead(pos):
    """[S, A, A] bool: pairs the kernel does not run (d >= rc or i == j)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    d = torch.sqrt(torch.clamp(torch.sum(rel * rel, dim=-1), min=1e-12))
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    return (d >= RCUT) | eye


def _gd_skipping(geometry, x, g, w0, b0, w1, offset, coeff, precision,
                 dead, need_gx):
    """cfconv_dense._pair_gd with every MLP product of the dead pairs
    zeroed (rbf @ w0, a0 @ w1, (g_i x_j cut) @ w1^T, gt0 @ w0^T)."""
    _, d, cut, dcut, e, rbf = geometry
    keep = ~dead[..., None]

    def run(t):
        return torch.where(keep, t, torch.zeros_like(t))

    a0 = torch.tanh(run(_op(rbf, precision) @ _op(w0, precision)) + b0)
    w = run(_op(a0, precision) @ _op(w1, precision))
    gi, xj = g[:, :, None, :], x[:, None, :, :]
    cut3 = cut[..., None]
    gx = torch.sum(w * cut3 * g[:, None, :, :], dim=2) if need_gx else None
    s_cut = torch.sum(gi * w * xj, dim=-1)
    ga0 = run(_op(gi * xj * cut3, precision) @ _op(w1, precision).T)
    gt0 = ga0 * (1.0 - a0 * a0)
    grbf = run(_op(gt0, precision) @ _op(w0, precision).T)
    gcut = s_cut + torch.sum(grbf * e, dim=-1)
    ge = grbf * cut3
    gd = torch.sum(ge * e * (2.0 * coeff) * (d[..., None] - offset),
                   dim=-1) + gcut * dcut
    return gd, gx


@pytest.mark.parametrize("padded", [False, True], ids=["ragged", "padded"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_twin_gd_is_zero_on_dead_pairs(precision, padded):
    pos = _clusters()
    if padded:
        pos = _padded(pos)
    pos = _t(pos)
    a = pos.shape[1]
    x, g, (w0, b0, w1, offset, coeff) = _operands(a)
    dead = _dead(pos)
    eye = torch.eye(a, dtype=torch.bool)
    # dead pairs off the diagonal, across the clusters; live pairs within
    assert bool((dead & ~eye).any()) and bool((~dead).any())
    geometry = cd._pair_geometry(pos, offset, coeff, RCUT)
    gd, _ = cd._pair_gd(geometry, x, g, w0, b0, w1, offset, coeff,
                        precision)
    assert bool((gd[dead] == 0.0).all())
    assert bool((gd[~dead] != 0.0).any())
    if padded:
        assert bool(dead[:, A:, :].all()) and bool(dead[:, :, A:].all())


@pytest.mark.parametrize("need_gx", [True, False], ids=["gx", "no_gx"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_skipping_dead_pairs_is_exact(precision, need_gx):
    pos = _t(_clusters(seed=2))
    x, g, (w0, b0, w1, offset, coeff) = _operands(seed=3)
    dead = _dead(pos)
    geometry = cd._pair_geometry(pos, offset, coeff, RCUT)
    gd, gx = _gd_skipping(geometry, x, g, w0, b0, w1, offset, coeff,
                          precision, dead, need_gx)
    gpos = cd._gpos_of_gd(gd, geometry[0], geometry[1])
    gpos_ref, gx_ref = cd.dense_cfconv_bwd_plain(
        pos, x, g, w0, b0, w1, offset, coeff, RCUT, precision, need_gx)
    assert torch.equal(gpos, gpos_ref)
    if need_gx:
        assert torch.equal(gx, gx_ref)
    else:
        assert gx is None and gx_ref is None


@pytest.mark.parametrize("padded", [False, True], ids=["ragged", "padded"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_skipping_dead_pairs_is_exact(precision, padded):
    """dense_cfconv_fwd_plain with both MLP products of the dead pairs
    zeroed (rbf @ w0, a0 @ w1) equals the twin bitwise."""
    pos = _clusters(seed=4)
    if padded:
        pos = _padded(pos)
    pos = _t(pos)
    x, _, (w0, b0, w1, offset, coeff) = _operands(pos.shape[1], seed=5)
    keep = ~_dead(pos)[..., None]

    def run(t):
        return torch.where(keep, t, torch.zeros_like(t))

    _, _, cut, _, _, rbf = cd._pair_geometry(pos, offset, coeff, RCUT)
    a0 = torch.tanh(run(_op(rbf, precision) @ _op(w0, precision)) + b0)
    w = run(_op(a0, precision) @ _op(w1, precision))
    out = torch.sum(w * cut[..., None] * x[:, None, :, :], dim=2)
    ref = cd.dense_cfconv_fwd_plain(pos, x, w0, b0, w1, offset, coeff, RCUT,
                                    precision)
    assert torch.equal(out, ref)
    assert bool((ref != 0.0).any())


def _with_a_lone_atom(pos):
    """The clusters with their last atom moved 3 RCUT along y: no pair of
    its row is live."""
    pos = pos.copy()
    pos[:, -1, 1] += 3 * RCUT
    return pos


def _ring_order_bwd(pos, x, g, w0, b0, w1, offset, coeff, need_gx):
    """The fp32 kernel's pairs in plain float32: each row's live pairs (d <
    rc, i != j), in column order (the ring's), run the MLP backward; gd =
    0 on every other pair; gx of the row summed over its pairs in ring
    order; gpos by the gather of gd (``_gpos_of_gd``)."""
    rel, d, cut, dcut, e, rbf = cd._pair_geometry(pos, offset, coeff, RCUT)
    n_s, a, f = x.shape
    live = (d < RCUT) & ~torch.eye(a, dtype=torch.bool)
    gd = torch.zeros(n_s, a, a)
    gx = torch.zeros_like(x) if need_gx else None
    for s in range(n_s):
        for i in range(a):
            js = torch.nonzero(live[s, i])[:, 0]
            if js.numel() == 0:
                continue
            ct = cut[s, i, js][:, None]
            a0 = torch.tanh(rbf[s, i, js] @ w0 + b0)
            w = a0 @ w1
            if need_gx:
                acc = torch.zeros(f)
                for p, j in enumerate(js):
                    acc = acc + (w[p] * ct[p]) * g[s, j]
                gx[s, i] = acc
            s_cut = torch.sum((g[s, i] * w) * x[s, js], dim=1)
            ga0 = ((g[s, i] * x[s, js]) * ct) @ w1.T
            grbf = (ga0 * (1.0 - a0 * a0)) @ w0.T
            ee = e[s, i, js]
            dr = d[s, i, js][:, None] - offset
            se = torch.sum(grbf * ee, dim=1)
            sg = torch.sum(grbf * ee * dr, dim=1)
            gd[s, i, js] = (ct[:, 0] * (2.0 * coeff) * sg
                            + (s_cut + se) * dcut[s, i, js])
    return cd._gpos_of_gd(gd, rel, d), gx


def _close(out, ref, bound=1e-5):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() <= bound * np.abs(ref).max()


@pytest.mark.parametrize("need_gx", [True, False], ids=["gx", "no_gx"])
def test_ring_order_matches_the_twin_and_pallas(need_gx):
    """The fp32 live-pair kernel's emulation against the fp32 twin and the
    reference's Pallas backward (interpreted), within 1e-5 of max|ref|."""
    pos = _t(_with_a_lone_atom(_clusters(seed=6)))
    x, g, (w0, b0, w1, offset, coeff) = _operands(seed=7)
    eye = torch.eye(A, dtype=torch.bool)
    assert not bool(((~_dead(pos)) & ~eye)[:, -1].any())  # the lone row
    gpos, gx = _ring_order_bwd(pos, x, g, w0, b0, w1, offset, coeff,
                               need_gx)
    gpos_ref, gx_ref = cd.dense_cfconv_bwd_plain(
        pos, x, g, w0, b0, w1, offset, coeff, RCUT, "fp32", need_gx)
    assert _close(gpos.numpy(), gpos_ref.numpy())
    assert (gx is None) == (gx_ref is None) == (not need_gx)
    if need_gx:
        assert _close(gx.numpy(), gx_ref.numpy())
    weights = tuple(jnp.asarray(v.numpy()) for v in (w0, b0, w1))
    rbf = (jnp.asarray(offset.numpy()), jnp.asarray(coeff.numpy()))
    for s in range(S):
        jgpos, jgx = _dense_cfconv_bwd(
            RCUT, 8, "fp32",
            (jnp.asarray(pos[s].numpy()), jnp.asarray(x[s].numpy()),
             *weights, rbf),
            jnp.asarray(g[s].numpy()))[:2]
        assert _close(gpos[s].numpy(), jgpos)
        if need_gx:
            assert _close(gx[s].numpy(), jgx)


def _ring_order_fwd(pos, x, w0, b0, w1, offset, coeff):
    """The fp32 forward kernel's pairs in plain float32: each row's live
    pairs (d < rc, i != j), in column order (the ring's), run the two
    products; out of the row is the sum of (W cut) x_j in ring order, zero
    for a row with no live pair."""
    _, d, cut, _, _, rbf = cd._pair_geometry(pos, offset, coeff, RCUT)
    n_s, a, f = x.shape
    live = (d < RCUT) & ~torch.eye(a, dtype=torch.bool)
    out = torch.zeros_like(x)
    for s in range(n_s):
        for i in range(a):
            js = torch.nonzero(live[s, i])[:, 0]
            if js.numel() == 0:
                continue
            w = torch.tanh(rbf[s, i, js] @ w0 + b0) @ w1
            acc = torch.zeros(f)
            for p, j in enumerate(js):
                acc = acc + (w[p] * cut[s, i, j]) * x[s, j]
            out[s, i] = acc
    return out


@pytest.mark.parametrize("padded", [False, True], ids=["ragged", "padded"])
def test_forward_ring_order_matches_the_twin_and_pallas(padded):
    """The fp32 live-pair forward's emulation against the fp32 twin and
    the reference's Pallas forward (interpreted), within 1e-5 of
    max|ref|; the lone row's out is exactly zero in all three."""
    pos = _with_a_lone_atom(_clusters(seed=8))
    if padded:
        pos = _padded(pos)
    pos = _t(pos)
    a = pos.shape[1]
    x, _, (w0, b0, w1, offset, coeff) = _operands(a, seed=9)
    out = _ring_order_fwd(pos, x, w0, b0, w1, offset, coeff)
    ref = cd.dense_cfconv_fwd_plain(pos, x, w0, b0, w1, offset, coeff, RCUT,
                                    "fp32")
    assert _close(out.numpy(), ref.numpy())
    assert float(out[:, A - 1].abs().max()) == 0.0
    assert float(ref[:, A - 1].abs().max()) == 0.0
    weights = tuple(jnp.asarray(v.numpy()) for v in (w0, b0, w1))
    rbf = (jnp.asarray(offset.numpy()), jnp.asarray(coeff.numpy()))
    for s in range(S):
        jout, _ = _dense_cfconv_fwd(
            jnp.asarray(pos[s].numpy()), jnp.asarray(x[s].numpy()), *weights,
            rbf, RCUT, 8, "fp32")
        assert _close(out[s].numpy(), jout)
