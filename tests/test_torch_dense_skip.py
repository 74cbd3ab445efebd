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
"""

import numpy as np
import pytest
import torch

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
