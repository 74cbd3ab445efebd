"""The invariant that lets the tensor-core gd kernel skip dead fragments.

``cheb_bwd_gd`` at bf16 and bf16x3 takes its pairs in 16 x 8 fragments
(the mma.m16n8k16 accumulator tile) and runs no product for a fragment
that holds no live pair (d < rcut, i != j, in range). That is exact only
because a dead pair's W is zero by the keep mask whatever its gd. Here, on
the CPU: a copy of the twin's order loop with U_m zeroed on every dead
fragment gives gpos equal (torch.equal) to ``cheb_conv_bwd_gd_plain``, at
every tier, open and under a cell, on positions with dead fragments and
an atom count that is not a multiple of 16; a pair just beyond the cutoff
contributes exactly nothing; and the twin on those positions is held to
the JAX package's Pallas kernel (interpreted, fp32) as the other parity
tests hold it.

The fp32 tier runs on the CUDA cores over single pairs (compacted per
row): U_m zeroed on every pair outside the keep mask, pair by pair, gives
gpos equal to the fp32 twin, on the clusters with a lone atom (a row with
no live pair) open and under the cell; and the kernel's order of
operations, each row's W_ij + W_ji from one filter Wf = sum_m T_m c2_m of
the pair contracted with g_i x_j + g_j x_i, its gradient -sum_j W rel_ij
owned by the row, agrees with the twin at the card's bound (1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.ops.pallas.cheb_kernel import cheb_conv_bwd_pallas
from flashmd_tpu_torch.ops import cheb_kernel as ck
from flashmd_tpu_torch.ops._launch import _dot
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
D_MIN = 1.2
A = 45  # not a multiple of 16 or 8
F = 16
M2 = 8
# rows = lattice vectors; smallest perpendicular width ~29.9 > 2 RCUT +
# both clusters' extent, so the minimum image is sound
CELL = np.array([[30.0, 0.0, 0.0], [3.0, 30.0, 0.0], [1.5, 1.5, 30.0]],
                np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clusters(seed=0, s=2):
    """[S, A, 3]: two compact clusters 3 RCUT apart, split at atom 21 (not
    on a fragment boundary), so some fragments are all dead, some all
    live and some mixed."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=1.0, size=(s, A, 3)).astype(np.float32)
    pos[:, 21:, 0] += 3 * RCUT
    return pos + 5.0


def _operands(seed=1, s=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, A, F)).astype(np.float32)
    g = rng.normal(size=(s, A, F)).astype(np.float32)
    c2 = (rng.normal(size=(M2, F)) / M2).astype(np.float32)
    return _t(x), _t(g), _t(c2)


def _cell(periodic, s=2):
    return _t(np.stack([CELL] * s)) if periodic else None


def _live_fragments(live):
    """[S, A, A] bool: the pair's 16 x 8 fragment (rows x columns, padded
    to the grain) holds a live pair."""
    s, a, _ = live.shape
    rp, cp = -(-a // 16) * 16, -(-a // 8) * 8
    pad = torch.zeros(s, rp, cp, dtype=torch.bool)
    pad[:, :a, :a] = live
    frag = pad.view(s, rp // 16, 16, cp // 8, 8).any(4).any(2)
    return (frag.repeat_interleave(16, 1).repeat_interleave(8, 2)
            [:, :a, :a])


def _geometry(pos, cell):
    cell, inv = ck._cell_operands(cell, pos.shape[0], pos.device)
    rel = ck.pair_rel(pos, cell, inv)
    d, z = ck._geometry(rel, RCUT, D_MIN)
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    return cell, rel, d, z, (d < RCUT) & ~eye


def _gd_skipping_dead_fragments(c2, pos, x, g, precision, cell,
                                pairwise=False):
    """cheb_conv_bwd_gd_plain's order loop with U_m zeroed on every
    fragment that holds no live pair (``pairwise``: on every pair that is
    not live), as the kernels skip them."""
    cell, rel, d, z, live = _geometry(pos, cell)
    on = live if pairwise else _live_fragments(live)
    two_z = 2.0 * z
    xt = x.transpose(1, 2)

    def u_m(m):
        u = _dot(c2[m] * g, xt, precision)
        return torch.where(on, u, torch.zeros_like(u))

    p_prev, p_cur = torch.ones_like(z), z
    gd = p_prev * u_m(0)
    if c2.shape[0] > 1:
        gd = gd + p_cur * u_m(1)
    for m in range(2, c2.shape[0]):
        p_prev, p_cur = p_cur, two_z * p_cur - p_prev
        gd = gd + p_cur * u_m(m)
    return ck._gpos_of_gd((1.0 - z) * gd, pos, rel, d, RCUT, cell)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_skipping_dead_fragments_is_exact(periodic, precision):
    pos = _t(_clusters())
    x, g, c2 = _operands()
    cell = _cell(periodic)
    live = _geometry(pos, cell)[4]
    frag = _live_fragments(live)
    # the positions have dead fragments, live ones, and live fragments
    # that hold dead pairs (computed by the kernel, then masked)
    assert bool((~frag).any()) and bool(frag.any())
    assert bool((frag & ~live).any())
    ref = ck.cheb_conv_bwd_gd_plain(c2, pos, x, g, RCUT, precision, D_MIN,
                                    cell)
    assert float(ref.abs().max()) > 0.0
    out = _gd_skipping_dead_fragments(c2, pos, x, g, precision, cell)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_pair_beyond_cutoff_contributes_nothing(periodic, precision):
    """Two atoms a float32 step beyond the cutoff: the pair is dead, its
    fragment is dead, gpos is exactly zero; a step inside, it is not."""
    x, g, c2 = _operands(seed=2, s=1)
    x, g = x[:, :2].contiguous(), g[:, :2].contiguous()
    cell = _cell(periodic, s=1)
    rc = np.float32(RCUT)
    for d, live in ((np.nextafter(rc, np.float32(np.inf)), False),
                    (np.nextafter(rc, np.float32(0.0)), True)):
        pos = torch.tensor([[[0.0, 0.0, 0.0], [float(d), 0.0, 0.0]]])
        assert bool(_geometry(pos, cell)[4].any()) == live
        assert bool(_live_fragments(_geometry(pos, cell)[4]).any()) == live
        gpos = ck.cheb_conv_bwd_gd_plain(c2, pos, x, g, RCUT, precision,
                                         D_MIN, cell)
        assert bool((gpos != 0).any()) == live


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_gd_twin_matches_pallas_on_dead_fragments(periodic):
    """The fp32 twin on the clustered positions against the reference's
    gd-only Pallas kernel (interpreted), at the JAX suite's backward
    tolerance (1e-4)."""
    pos = _clusters(seed=3)
    x, g, c2 = _operands(seed=4)
    cell = CELL if periodic else None
    ref = np.stack([
        np.asarray(cheb_conv_bwd_pallas(
            jnp.zeros((1, F), jnp.float32), jnp.asarray(c2.numpy()),
            jnp.zeros((F,), jnp.float32), jnp.asarray(pos[s]),
            jnp.asarray(x[s].numpy()), jnp.asarray(g[s].numpy()), RCUT,
            "fp32", need_gx=False, need_gd=True, d_min=D_MIN,
            cell=None if cell is None else jnp.asarray(cell))[0])
        for s in range(pos.shape[0])
    ])
    out = ck.cheb_conv_bwd_gd(c2, _t(pos), x, g, RCUT, "fp32", D_MIN,
                              _cell(periodic))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def _clusters_with_a_lone_atom():
    """The clusters with their last atom moved half the cell away along y:
    no pair of its row is live, open or under the cell."""
    pos = _clusters()
    pos[:, -1, 1] += 15.0
    return pos


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_skipping_dead_pairs_is_exact(periodic):
    """The fp32 kernel's rule, pair by pair: U_m zeroed on every pair
    outside the keep mask gives the fp32 twin's gpos exactly, on a row
    with no live pair beside rows with live and dead pairs."""
    pos = _t(_clusters_with_a_lone_atom())
    x, g, c2 = _operands()
    cell = _cell(periodic)
    live = _geometry(pos, cell)[4]
    assert not bool(live[:, -1].any()) and not bool(live[:, :, -1].any())
    assert bool(live.any(2)[:, :-1].all())
    assert bool((~live).any(2).all())
    ref = ck.cheb_conv_bwd_gd_plain(c2, pos, x, g, RCUT, "fp32", D_MIN,
                                    cell)
    assert float(ref[:, -1].abs().max()) == 0.0
    out = _gd_skipping_dead_fragments(c2, pos, x, g, "fp32", cell,
                                      pairwise=True)
    assert torch.equal(out, ref)


def _live_pair_order(c2, pos, x, g, cell):
    """The fp32 kernel's order of operations in plain float32: per live
    pair of row i the filter Wf = sum_m T_m c2_m (the recurrence stepped
    per order), W_ij + W_ji = (1-z) / d sum_f Wf (g_i x_j + g_j x_i), and
    gpos_i = -sum_j (W_ij + W_ji) rel_ij over the row's pairs in column
    order."""
    cell, rel, d, z, live = _geometry(pos, cell)
    gpos = torch.zeros_like(pos)
    for s in range(pos.shape[0]):
        for i in range(pos.shape[1]):
            js = torch.nonzero(live[s, i])[:, 0]
            zj = z[s, i, js][:, None]
            ta, tb = torch.ones_like(zj), zj
            wf = ta * c2[0]
            for m in range(1, c2.shape[0]):
                wf = wf + tb * c2[m]
                ta, tb = tb, 2.0 * zj * tb - ta
            sym = g[s, i] * x[s, js] + g[s, js] * x[s, i]
            w = (1.0 - z[s, i, js]) * (wf * sym).sum(1) / d[s, i, js]
            gpos[s, i] = -(w[:, None] * rel[s, i, js]).sum(0)
    return gpos


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_live_pair_order_matches_the_twin(periodic):
    """The fp32 kernel's per-row gradient from one filter per pair agrees
    with the twin's W + W^T sums within 1e-4 of max|twin|."""
    pos = _t(_clusters_with_a_lone_atom())
    x, g, c2 = _operands(seed=9)
    cell = _cell(periodic)
    got = _live_pair_order(c2, pos, x, g, cell)
    ref = ck.cheb_conv_bwd_gd_plain(c2, pos, x, g, RCUT, "fp32", D_MIN,
                                    cell)
    assert float((got - ref).abs().max() / ref.abs().max()) <= 1e-4
