"""The invariant that lets the tensor-core neighbour-matrix kernels skip
dead slots.

``cfconv_fwd`` and ``cfconv_bwd`` at bf16 vote the live slots of their
rows (mask set and d < rc, over all K slots of a row) and run the filter
MLP's products over those only: the forward adds nothing for the other
slots, the backward writes gd = 0 for them into its [S, A, K] workspace;
its gx pass runs the two forward products over the live incoming slots
of the source CSR only. That is exact because the twins' message, per-slot
distance gradient and gx message vanish wherever cut and dcut do. Here,
on the CPU, at fp32 and bf16, on a symmetric list and on an overflowed
(asymmetric) one, fresh or stale (the atoms moved after the build, so a
row's live slots are not all its first), with a ragged atom count: the
twin's gd (``cfconv._slot_gd``) is exactly zero on every masked slot
(which holds the row's own index, at d = 1e-6 < rc) and every slot at
d >= rc; a copy of the backward twin with every MLP product of those
slots zeroed gives gpos and gx equal (torch.equal) to
``cfconv_bwd_plain``, with and without gx; and a copy of the forward twin
with both of its products zeroed there gives out equal to
``cfconv_fwd_plain``.
"""

import numpy as np
import pytest
import torch

from flashmd_tpu_torch.ops import cfconv as cf
from flashmd_tpu_torch.ops._launch import _op
from flashmd_tpu_torch.ops.neighborlist import batched_radius_neighbor_matrix
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
SKIN = 1.0
A = 45  # not a multiple of 16
F = 16
R = 9
S = 2
# capacity 32 holds every neighbour (symmetric list); 8 overflows
CAPACITY = {"symmetric": 32, "overflowed": 8}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(kind, stale, seed=0):
    """(positions [S, A, 3], the list built at RCUT + SKIN before the
    atoms moved, if ``stale``): atoms uniform in a cube, about 12 of them
    within RCUT + SKIN of an inner atom."""
    rng = np.random.default_rng(seed)
    side = (A / 0.0229) ** (1 / 3)
    pos = (side * rng.random((S, A, 3))).astype(np.float32)
    nbr = batched_radius_neighbor_matrix(_t(pos), RCUT + SKIN,
                                         CAPACITY[kind])
    if stale:
        pos = pos + (0.5 * rng.normal(size=pos.shape)).astype(np.float32)
    return _t(pos), nbr


def _operands(seed=1):
    rng = np.random.default_rng(seed)
    offset = np.linspace(0.0, RCUT, R).astype(np.float32)
    return (
        _t(rng.normal(size=(S, A, F)).astype(np.float32)),
        _t(rng.normal(size=(S, A, F)).astype(np.float32)),
        (_t((rng.normal(size=(R, F)) / np.sqrt(R)).astype(np.float32)),
         _t((0.1 * rng.normal(size=F)).astype(np.float32)),
         _t((rng.normal(size=(F, F)) / np.sqrt(F)).astype(np.float32)),
         _t(offset),
         torch.tensor(-0.5 / float(offset[1] - offset[0]) ** 2)),
    )


def _geometry(pos, nbr, offset, coeff):
    """(the twin's slot geometry, dead [S, A, K]: masked or d >= rc)."""
    geometry = cf._slot_geometry(pos, nbr.idx, nbr.mask, offset, coeff, RCUT)
    return geometry, ~nbr.mask | (geometry[1] >= RCUT)


def _check_layout(nbr, kind, stale, dead):
    """The case holds what it is meant to: masked slots, listed slots at
    d >= rc, an overflow only where asked for, and after a move a row
    whose live slots do not all come first."""
    assert (int(nbr.n_max.max()) > CAPACITY[kind]) == (kind == "overflowed")
    assert bool((~nbr.mask).any())
    assert bool((nbr.mask & dead).any()) and bool((~dead).any())
    dead_before = torch.cumsum(dead.int(), dim=-1) > 0
    assert bool((~dead & dead_before).any()) == stale


def _slot_gd_skipping(geometry, xj, gi, w0, b0, w1, offset, coeff, precision,
                      dead):
    """cfconv._slot_gd with every MLP product of the dead slots zeroed
    (rbf @ w0, a0 @ w1, (g_i x_j cut) @ w1^T, gt0 @ w0^T)."""
    _, d, cut, dcut, e, rbf = geometry
    keep = ~dead[..., None]

    def run(t):
        return torch.where(keep, t, torch.zeros_like(t))

    a0 = torch.tanh(run(_op(rbf, precision) @ _op(w0, precision)) + b0)
    w = run(_op(a0, precision) @ _op(w1, precision))
    cut3 = cut[..., None]
    s_cut = torch.sum(gi * w * xj, dim=-1)
    ga0 = run(_op(gi * xj * cut3, precision) @ _op(w1, precision).T)
    gt0 = ga0 * (1.0 - a0 * a0)
    grbf = run(_op(gt0, precision) @ _op(w0, precision).T)
    gcut = s_cut + torch.sum(grbf * e, dim=-1)
    ge = grbf * cut3
    gd = torch.sum(ge * e * (2.0 * coeff) * (d[..., None] - offset),
                   dim=-1) + gcut * dcut
    return gd, w


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_twin_gd_is_zero_on_dead_slots(precision, kind, stale):
    pos, nbr = _case(kind, stale)
    x, g, (w0, b0, w1, offset, coeff) = _operands()
    geometry, dead = _geometry(pos, nbr, offset, coeff)
    _check_layout(nbr, kind, stale, dead)
    xj = cf._gather_rows(x, nbr.idx)
    gd, _ = cf._slot_gd(geometry, xj, g[:, :, None, :], w0, b0, w1, offset,
                        coeff, precision)
    assert bool((gd[dead] == 0.0).all())
    assert bool((gd[~dead] != 0.0).any())
    # masked slots hold the row's own index, inside the cutoff by d alone
    assert bool((geometry[1][~nbr.mask] < RCUT).all())


@pytest.mark.parametrize("need_gx", [True, False], ids=["gx", "no_gx"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_skipping_dead_slots_is_exact(precision, kind, stale, need_gx):
    pos, nbr = _case(kind, stale, seed=2)
    x, g, (w0, b0, w1, offset, coeff) = _operands(seed=3)
    geometry, dead = _geometry(pos, nbr, offset, coeff)
    _check_layout(nbr, kind, stale, dead)
    gi, xj = g[:, :, None, :], cf._gather_rows(x, nbr.idx)
    gd, w = _slot_gd_skipping(geometry, xj, gi, w0, b0, w1, offset, coeff,
                              precision, dead)
    gpos, gx = cf._slot_sums(geometry, nbr.idx, gd, w, gi, need_gx)
    gpos_ref, gx_ref = cf.cfconv_bwd_plain(
        pos, nbr.idx, nbr.mask, x, g, w0, b0, w1, offset, coeff, RCUT,
        precision, need_gx)
    assert torch.equal(gpos, gpos_ref)
    if need_gx:
        assert torch.equal(gx, gx_ref)
    else:
        assert gx is None and gx_ref is None


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forward_skipping_dead_slots_is_exact(precision, kind, stale):
    """cfconv_fwd_plain with both MLP products of the dead slots zeroed
    (rbf @ w0, a0 @ w1) equals the twin bitwise."""
    pos, nbr = _case(kind, stale, seed=4)
    x, _, (w0, b0, w1, offset, coeff) = _operands(seed=5)
    geometry, dead = _geometry(pos, nbr, offset, coeff)
    _check_layout(nbr, kind, stale, dead)
    keep = ~dead[..., None]

    def run(t):
        return torch.where(keep, t, torch.zeros_like(t))

    _, _, cut, _, _, rbf = geometry
    a0 = torch.tanh(run(_op(rbf, precision) @ _op(w0, precision)) + b0)
    w = run(_op(a0, precision) @ _op(w1, precision))
    out = torch.sum(w * cut[..., None] * cf._gather_rows(x, nbr.idx), dim=2)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, w0, b0, w1, offset,
                              coeff, RCUT, precision)
    assert torch.equal(out, ref)
    assert bool((ref != 0.0).any())
