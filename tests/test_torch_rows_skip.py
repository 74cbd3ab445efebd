"""The invariant that lets the tensor-core fwd/gx and gx+gd kernels skip
fragments.

``cheb_fwd``, ``cheb_bwd_gx`` and ``cheb_bwd_gxgd`` at bf16 and bf16x3
take their pairs in 16 x 16 fragments (the A operand of mma.m16n8k16) and
run no order product for a fragment whose every pair has z == 1 (both
bases' seeds, (1-z)^2 and (1-z), are then exactly zero), and the linear
term only on fragments that hold a pair with low = min(d - d_min, 0) !=
0. Here, on the CPU: copies of the three twins' order loops with every
product of such a fragment zeroed (for gx+gd, both the gx product and the
gd term of each order) give outputs equal (torch.equal) to
``cheb_conv_fwd_plain``, ``cheb_conv_bwd_gx_plain`` and
``cheb_conv_bwd_gxgd_plain`` (gpos and gx), at every tier, open and under
a triclinic cell, on two-cluster positions with all-dead, all-live and mixed
fragments, an atom count and a feature width that are not multiples of
16, and pairs below d_min; the gd kernel's rule (a live pair off the
diagonal) instead drops the diagonal's share and breaks equality, so the
z == 1 rule is what holds; and the fp32 twins on those positions are held
to the JAX package's Pallas kernels (interpreted) as the other parity
tests hold them.

The fp32 tier of ``cheb_fwd``, ``cheb_bwd_gx`` and ``cheb_bwd_gxgd`` runs on
the CUDA cores over single pairs (compacted per row): the same copies with
the products of every pair at z == 1 zeroed pair by pair (the linear term
riding on the live pairs; for gx+gd also the gd terms outside the keep
mask) equal the fp32 twins, on the clusters with a lone atom (a row whose
only live pair is its diagonal) open and under the cell, for gx+gd at
d_min 0 and 2.0 and beside a pair at d < rcut whose z rounds to exactly
1.0f (in gd's keep mask, dropped by the kernel: exact, as its W carries 1
- z = 0); the pair-granular gd rule drops the diagonal there too; the
kernel's order of operations, the filter Wf = sum_m Ttil_m c_m of each
pair summed against x (or g) row by row, and for gx+gd two filters from
one recurrence with gd as W_ij + W_ji owned by the row, agrees with the
twin at the card's bounds; and the gx+gd twin on those positions agrees
with the Pallas kernel (interpreted).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.ops.pallas.cheb_kernel import (
    cheb_conv_bwd_pallas,
    cheb_conv_fwd_pallas,
)
from flashmd_tpu_torch.models.cheb import _lin_slope
from flashmd_tpu_torch.ops import cheb_kernel as ck
from flashmd_tpu_torch.ops._launch import _dot
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
D_MIN = 1.2
A = 45  # not a multiple of 16
F = 20  # not a multiple of 16
M1, M2 = 8, 10
FRAG = 16
# rows = lattice vectors; smallest perpendicular width ~29.9 > 2 RCUT +
# both clusters' extent, so the minimum image is sound
CELL = np.array([[30.0, 0.0, 0.0], [3.0, 30.0, 0.0], [1.5, 1.5, 30.0]],
                np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clusters(seed=0, s=2):
    """[S, A, 3]: two compact clusters 3 RCUT apart, split at atom 21 (not
    on a fragment boundary): fragments within a cluster are all live,
    those across the two are all dead, those over the split are mixed;
    some pairs lie below D_MIN."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(scale=0.5, size=(s, A, 3)).astype(np.float32)
    pos[:, 21:, 0] += 3 * RCUT
    return pos + 5.0


def _sparse(s=2):
    """[S, A, 3] on a grid of spacing 1.2 RCUT: no pair within the cutoff
    but the diagonal."""
    i = np.arange(A)
    grid = np.stack([i % 4, (i // 4) % 4, i // 16], -1).astype(np.float32)
    return np.broadcast_to(1.2 * RCUT * grid + 1.0, (s, A, 3)).copy()


def _operands(seed=1, s=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(s, A, F)).astype(np.float32)
    c = (rng.normal(size=(M1, F)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, F)) / M2).astype(np.float32)
    w0 = rng.normal(size=(F,)).astype(np.float32)
    return _t(x), _t(c), _t(c2), _t(w0)


def _cotangent(seed=5, s=2):
    """g [S, A, F], the gx+gd kernel's second operand."""
    rng = np.random.default_rng(seed)
    return _t(rng.normal(size=(s, A, F)).astype(np.float32))


def _cell(periodic, s=2):
    return _t(np.stack([CELL] * s)) if periodic else None


def _fragments(mask):
    """[S, A, A] bool: the pair's 16 x 16 fragment (padded to the grain)
    holds a True entry of ``mask``."""
    s, a, _ = mask.shape
    n = -(-a // FRAG) * FRAG
    pad = torch.zeros(s, n, n, dtype=torch.bool)
    pad[:, :a, :a] = mask
    frag = pad.view(s, n // FRAG, FRAG, n // FRAG, FRAG).any(4).any(2)
    return (frag.repeat_interleave(FRAG, 1).repeat_interleave(FRAG, 2)
            [:, :a, :a])


def _runs(pos, cell, rule, grain=FRAG):
    """(d, z, pairs whose order products run, pairs whose linear term
    runs), by 16 x 16 fragment (the tensor-core kernel) or, with grain 1,
    pair by pair (the fp32 kernel, whose linear term rides on its live
    pairs). ``rule`` "z": z != 1 (the kernels'); "gd": d < rcut off the
    diagonal (the gd kernels')."""
    d, z = ck.pair_geometry(pos, RCUT, D_MIN, cell)
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    live = (z != 1.0) if rule == "z" else (d < RCUT) & ~eye
    if grain == 1:
        return d, z, live, live
    return (d, z, _fragments(live),
            _fragments(ck._low_matrix(d, D_MIN) != 0.0))


def _masked(t, on):
    return torch.where(on, t, torch.zeros_like(t))


def _fwd_skipping(c, w0, pos, x, precision, w_lin, cell, rule="z",
                  grain=FRAG):
    """cheb_conv_fwd_plain's order loop with the products of the fragments
    (grain 1: pairs) that do not run zeroed."""
    d, z, on, on_low = _runs(pos, cell, rule, grain)
    u2 = torch.square(1.0 - z)
    two_z = 2.0 * z
    t_prev, t_cur = u2, u2 * z
    out = c[0] * _dot(_masked(t_prev, on), x, precision)
    if c.shape[0] > 1:
        out = out + c[1] * _dot(_masked(t_cur, on), x, precision)
    for m in range(2, c.shape[0]):
        t_prev, t_cur = t_cur, two_z * t_cur - t_prev
        out = out + c[m] * _dot(_masked(t_cur, on), x, precision)
    if w_lin is not None:
        low = _masked(ck._low_matrix(d, D_MIN), on_low)
        out = out + w_lin * _dot(low, x, precision)
    return out - w0 * x


def _gx_skipping(c, w0, pos, g, precision, w_lin, cell, rule="z",
                 grain=FRAG):
    """cheb_conv_bwd_gx_plain's order loop with the products of the
    fragments (grain 1: pairs) that do not run zeroed."""
    q = ck._to_that_basis(c)
    d, z, on, on_low = _runs(pos, cell, rule, grain)
    u = 1.0 - z
    two_z = 2.0 * z
    h_prev, h_cur = u, u * z
    gx = _dot(_masked(h_prev, on), q[0] * g, precision)
    gx = gx + _dot(_masked(h_cur, on), q[1] * g, precision)
    for k in range(2, q.shape[0]):
        h_prev, h_cur = h_cur, two_z * h_cur - h_prev
        gx = gx + _dot(_masked(h_cur, on), q[k] * g, precision)
    if w_lin is not None:
        low = _masked(ck._low_matrix(d, D_MIN), on_low)
        gx = gx + _dot(low, w_lin * g, precision)
    return gx - w0 * g


def _gxgd_skipping(c, c2, w0, pos, x, g, precision, w_lin, cell):
    """cheb_conv_bwd_gxgd_plain's order loop with both products of the
    fragments that do not run zeroed (the z == 1 rule)."""
    q = ck._to_that_basis(c)
    d, z, on, on_low = _runs(pos, cell, "z")
    cell, inv = ck._cell_operands(cell, pos.shape[0], pos.device)
    rel = ck.pair_rel(pos, cell, inv)
    two_z = 2.0 * z
    xt = x.transpose(1, 2)
    n_q, n_d = q.shape[0], c2.shape[0]
    h_prev, h_cur = 1.0 - z, (1.0 - z) * z
    gx = gd = 0.0
    for m in range(max(n_q, n_d)):
        if m == 0:
            h = h_prev
        elif m == 1:
            h = h_cur
        else:
            h_prev, h_cur = h_cur, two_z * h_cur - h_prev
            h = h_cur
        if m < n_q:
            gx = gx + _dot(_masked(h, on), q[m] * g, precision)
        if m < n_d:
            gd = gd + _masked(h, on) * _dot(c2[m] * g, xt, precision)
    if w_lin is not None:
        low = _masked(ck._low_matrix(d, D_MIN), on_low)
        gx = gx + _dot(low, w_lin * g, precision)
    return ck._gpos_of_gd(gd, pos, rel, d, RCUT, cell), gx - w0 * g


KERNELS = {
    "fwd": (_fwd_skipping, ck.cheb_conv_fwd_plain),
    "gx": (_gx_skipping, ck.cheb_conv_bwd_gx_plain),
}


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
@pytest.mark.parametrize("kernel", ["fwd", "gx", "gxgd"])
def test_skipping_dead_fragments_is_exact(kernel, periodic, precision):
    pos = _t(_clusters())
    x, c, c2, w0 = _operands()
    w_lin = _lin_slope(c2)
    cell = _cell(periodic)
    d, z, on, on_low = _runs(pos, cell, "z")
    every = _fragments(z == 1.0)  # a fragment holding a dead pair
    # all-dead, all-live and mixed fragments; a live linear term
    assert bool((~on).any()) and bool((on & ~every).any())
    assert bool((on & every).any())
    assert bool(on_low.any())
    if kernel == "gxgd":
        g = _cotangent()
        args = (c, c2, w0, pos, x, g)
        ref = ck.cheb_conv_bwd_gxgd_plain(*args, RCUT, precision, D_MIN,
                                          w_lin, cell)
        out = _gxgd_skipping(*args, precision, w_lin, cell)
        assert all(torch.equal(o, r) for o, r in zip(out, ref))
        return
    skip, plain = KERNELS[kernel]
    ref = plain(c, w0, pos, x, RCUT, precision, D_MIN, w_lin, cell)
    out = skip(c, w0, pos, x, precision, w_lin, cell)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "bf16x3"])
@pytest.mark.parametrize("kernel", ["fwd", "gx"])
def test_gd_rule_drops_the_diagonal(kernel, precision):
    """On positions where no pair but the diagonal is within the cutoff,
    every fragment runs under the z != 1 rule only where it holds the
    diagonal, and the result equals the twin; the gd kernel's rule (a
    live pair off the diagonal) runs none, dropping sum_m c_m Ttil_m(-1)
    x[i], and differs from it."""
    pos = _t(_sparse())
    x, c, c2, w0 = _operands(seed=2)
    w_lin = _lin_slope(c2)
    skip, plain = KERNELS[kernel]
    ref = plain(c, w0, pos, x, RCUT, precision, D_MIN, w_lin, None)
    assert torch.equal(skip(c, w0, pos, x, precision, w_lin, None), ref)
    dropped = skip(c, w0, pos, x, precision, w_lin, None, rule="gd")
    assert torch.equal(dropped, -w0 * x)
    assert not torch.equal(dropped, ref)


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
@pytest.mark.parametrize("kernel", ["fwd", "gx", "gxgd"])
def test_twins_match_pallas_on_dead_fragments(kernel, periodic):
    """The fp32 twins on the clustered positions, with pairs below d_min,
    against the reference's Pallas kernels (interpreted), at the JAX
    suite's tolerances (2e-5 forward, 1e-4 backward)."""
    pos = _clusters(seed=3)
    x, c, c2, w0 = _operands(seed=4)
    cell = CELL if periodic else None
    jcell = None if cell is None else jnp.asarray(cell)
    w_lin = _lin_slope(c2)
    jc, jc2, jw0 = (jnp.asarray(v.numpy()) for v in (c, c2, w0))
    if kernel == "fwd":
        ref = np.stack([np.asarray(cheb_conv_fwd_pallas(
            jc, jw0, jnp.asarray(pos[s]), jnp.asarray(x[s].numpy()), RCUT,
            "fp32", cell=jcell, d_min=D_MIN,
            w_lin=jnp.asarray(w_lin.numpy()))) for s in range(pos.shape[0])])
        out = ck.cheb_conv_fwd(c, w0, _t(pos), x, RCUT, "fp32", D_MIN, w_lin,
                               _cell(periodic))
        np.testing.assert_allclose(out.numpy(), ref, rtol=2e-5, atol=2e-5)
        return
    if kernel == "gxgd":
        # the Pallas kernel runs the gd series in chains: 16 orders
        rng = np.random.default_rng(6)
        c2 = _t((rng.normal(size=(16, F)) / 16).astype(np.float32))
        jc2, w_lin = jnp.asarray(c2.numpy()), _lin_slope(c2)
        g = _cotangent(seed=7)
        refs = [cheb_conv_bwd_pallas(
            jc, jc2, jw0, jnp.asarray(pos[s]), jnp.asarray(x[s].numpy()),
            jnp.asarray(g[s].numpy()), RCUT, "fp32", need_gx=True,
            need_gd=True, cell=jcell, d_min=D_MIN)
            for s in range(pos.shape[0])]
        out = ck.cheb_conv_bwd_gxgd(c, c2, w0, _t(pos), x, g, RCUT, "fp32",
                                    D_MIN, w_lin, _cell(periodic))
        # max|port - jax| / max|jax| (chip_smoke's metric): gpos sums
        # every live pair of a cluster and reaches ~7 here, where an
        # element-wise 1e-4 would bound the summation order's ulps tighter
        # than the JAX suite does
        for k in range(2):
            ref = np.stack([np.asarray(r[k]) for r in refs])
            err = np.abs(out[k].numpy() - ref).max()
            assert err <= 1e-4 * np.abs(ref).max()
        return
    ref = np.stack([np.asarray(cheb_conv_bwd_pallas(
        jc, jc2, jw0, jnp.asarray(pos[s]), jnp.asarray(x[s].numpy()),
        jnp.asarray(x[s].numpy()), RCUT, "fp32", need_gx=True, need_gd=False,
        cell=jcell, d_min=D_MIN)[1]) for s in range(pos.shape[0])])
    out = ck.cheb_conv_bwd_gx(c, w0, _t(pos), x, RCUT, "fp32", D_MIN, w_lin,
                              _cell(periodic))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def _clusters_with_a_lone_atom():
    """The clusters with their last atom moved half the cell away along y:
    its row's only pair within the cutoff is its diagonal, open and under
    the cell."""
    pos = _clusters()
    pos[:, -1, 1] += 15.0
    return pos


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
@pytest.mark.parametrize("kernel", ["fwd", "gx"])
def test_skipping_dead_pairs_is_exact(kernel, periodic):
    """The fp32 kernels' rule, pair by pair: every product of a pair at z
    == 1 zeroed (with its linear term) gives the fp32 twin's output
    exactly, on rows whose pairs are all dead but the diagonal, rows with
    live and dead pairs, and pairs below d_min."""
    pos = _t(_clusters_with_a_lone_atom())
    x, c, c2, w0 = _operands()
    w_lin = _lin_slope(c2)
    cell = _cell(periodic)
    d, z, on, _ = _runs(pos, cell, "z", grain=1)
    eye = torch.eye(A, dtype=torch.bool)
    assert not bool((on & ~eye)[:, -1].any())  # the lone atom's row
    assert bool((on & ~eye).any(2)[:, :-1].all())
    assert bool((~on).any(2).all())  # every row holds dead pairs
    assert bool(((d < D_MIN) & ~eye).any())
    skip, plain = KERNELS[kernel]
    ref = plain(c, w0, pos, x, RCUT, "fp32", D_MIN, w_lin, cell)
    assert torch.equal(skip(c, w0, pos, x, "fp32", w_lin, cell, grain=1),
                       ref)


@pytest.mark.parametrize("kernel", ["fwd", "gx"])
def test_pair_rule_keeps_the_diagonal(kernel):
    """Pair by pair on positions where no pair but the diagonal is within
    the cutoff: the z != 1 rule runs the diagonal alone and equals the
    fp32 twin; the gd kernels' rule (a live pair off the diagonal) runs
    nothing, drops sum_m c_m Ttil_m(-1) x[i] and differs from it."""
    pos = _t(_sparse())
    x, c, c2, w0 = _operands(seed=2)
    w_lin = _lin_slope(c2)
    skip, plain = KERNELS[kernel]
    ref = plain(c, w0, pos, x, RCUT, "fp32", D_MIN, w_lin, None)
    assert torch.equal(skip(c, w0, pos, x, "fp32", w_lin, None, grain=1),
                       ref)
    dropped = skip(c, w0, pos, x, "fp32", w_lin, None, rule="gd", grain=1)
    assert torch.equal(dropped, -w0 * x)
    assert not torch.equal(dropped, ref)


def _live_pair_order(c, w0, pos, x, seed, w_lin, cell):
    """The fp32 kernel's order of operations in plain float32: per pair
    with z != 1 the filter Wf = sum_m T_m c_m (T_0 = seed(z), T_1 = seed z,
    the recurrence stepped per order) plus low w_lin, then each row's sum
    of Wf * x over its pairs in column order, less w0 x[i]."""
    d, z = ck.pair_geometry(pos, RCUT, D_MIN, cell)
    out = torch.empty_like(x)
    for s in range(pos.shape[0]):
        for i in range(pos.shape[1]):
            js = torch.nonzero(z[s, i] != 1.0)[:, 0]
            zj = z[s, i, js][:, None]
            ta, tb = seed(zj), seed(zj) * zj
            wf = ta * c[0]
            for m in range(1, c.shape[0]):
                wf = wf + tb * c[m]
                ta, tb = tb, 2.0 * zj * tb - ta
            if w_lin is not None:
                low = torch.clamp(d[s, i, js] - D_MIN, max=0.0)
                low = torch.where(js == i, torch.zeros_like(low), low)
                wf = wf + low[:, None] * w_lin
            out[s, i] = (wf * x[s, js]).sum(0) - w0 * x[s, i]
    return out


@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
@pytest.mark.parametrize("kernel", ["fwd", "gx"])
def test_live_pair_order_matches_the_twin(kernel, periodic):
    """The fp32 kernels sum the coefficient series per pair before the
    operand (the twins: the operand product per order); on the clusters
    with a lone atom the two orders agree within the card's bounds (1e-5
    forward, 1e-4 gx of max|twin|)."""
    pos = _t(_clusters_with_a_lone_atom())
    x, c, c2, w0 = _operands(seed=8)
    w_lin = _lin_slope(c2)
    cell = _cell(periodic)
    if kernel == "fwd":
        got = _live_pair_order(c, w0, pos, x, lambda z: (1.0 - z) ** 2,
                               w_lin, cell)
        ref = ck.cheb_conv_fwd_plain(c, w0, pos, x, RCUT, "fp32", D_MIN,
                                     w_lin, cell)
        bound = 1e-5
    else:
        got = _live_pair_order(ck._to_that_basis(c), w0, pos, x,
                               lambda z: 1.0 - z, w_lin, cell)
        ref = ck.cheb_conv_bwd_gx_plain(c, w0, pos, x, RCUT, "fp32", D_MIN,
                                        w_lin, cell)
        bound = 1e-4
    assert float((got - ref).abs().max() / ref.abs().max()) <= bound


# The fp32 gx+gd kernel (cheb_gxgd_ffma_kernel) runs the pairs of its ring,
# z != 1 (gx's live set, with the diagonal), and weighs their gd by the
# keep mask (d < rcut off the diagonal). A pair at d < rcut whose z rounds
# to exactly 1.0f is in the keep mask but not in the ring. At d_min 0 and
# this cutoff such a pair exists (_hazard_pair finds it, the tests assert
# it); at d_min 2.0 and RCUT none does: d - d_min then loses more to
# rounding than the scale 2 / (rcut - d_min) can gain.
HAZARD_RCUT = float(np.float32(3.6052))


def _hazard_pair(rcut, d_min, base=(5.0, 12.0, 22.0)):
    """Two atoms [2, 3], dx apart along x, whose pair lies at d < rcut with
    z == 1.0f exactly (searched over dx within 200 steps of 2^-21 below
    rcut); None if there is none."""
    base = np.asarray(base, np.float32)
    for k in range(1, 200):
        dx = np.float32(rcut) - np.float32(k * 2.0 ** -21)
        pair = np.stack([base, base + np.array([dx, 0.0, 0.0], np.float32)])
        d, z = ck.pair_geometry(_t(pair[None]), rcut, d_min)
        if float(d[0, 0, 1]) < rcut and float(z[0, 0, 1]) == 1.0:
            return pair
    return None


def _gxgd_case(d_min):
    """(pos, rcut): the clusters with a lone atom (index A - 1); at d_min 0
    two atoms appended whose pair sits at d < HAZARD_RCUT with z == 1.0f,
    far from the others (also under the cell)."""
    pos = _clusters_with_a_lone_atom()
    if d_min > 0.0:
        return _t(pos), RCUT
    pair = _hazard_pair(HAZARD_RCUT, d_min)
    assert pair is not None
    pos = np.concatenate(
        [pos, np.broadcast_to(pair, (pos.shape[0], 2, 3))], axis=1)
    return _t(pos), HAZARD_RCUT


def _gxgd_operands(a, seed):
    """x, g [2, a, F], c [M1, F] (so q has M1 + 1 orders), c2 [M2, F],
    w0 [F]."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, a, F)).astype(np.float32)
    g = rng.normal(size=(2, a, F)).astype(np.float32)
    c = (rng.normal(size=(M1, F)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, F)) / M2).astype(np.float32)
    w0 = rng.normal(size=(F,)).astype(np.float32)
    return _t(x), _t(g), _t(c), _t(c2), _t(w0)


def _gxgd_live_pairs(c, c2, w0, pos, x, g, rcut, d_min, w_lin, cell):
    """cheb_conv_bwd_gxgd_plain's order loop at fp32 with, pair by pair,
    the products the fp32 kernel does not run zeroed: gx's (and the linear
    term's) of every pair at z == 1, gd's of every pair at z == 1 or
    outside the keep mask."""
    q = ck._to_that_basis(c)
    cell, inv = ck._cell_operands(cell, pos.shape[0], pos.device)
    rel = ck.pair_rel(pos, cell, inv)
    d, z = ck._geometry(rel, rcut, d_min)
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    on_x = z != 1.0
    on_d = on_x & (d < rcut) & ~eye
    two_z = 2.0 * z
    xt = x.transpose(1, 2)
    h_prev, h_cur = 1.0 - z, (1.0 - z) * z
    gx = gd = 0.0
    for m in range(max(q.shape[0], c2.shape[0])):
        if m == 0:
            h = h_prev
        elif m == 1:
            h = h_cur
        else:
            h_prev, h_cur = h_cur, two_z * h_cur - h_prev
            h = h_cur
        if m < q.shape[0]:
            gx = gx + _dot(_masked(h, on_x), q[m] * g, "fp32")
        if m < c2.shape[0]:
            gd = gd + _masked(h, on_d) * _dot(c2[m] * g, xt, "fp32")
    if w_lin is not None:
        low = _masked(ck._low_matrix(d, d_min), on_x)
        gx = gx + _dot(low, w_lin * g, "fp32")
    return ck._gpos_of_gd(gd, pos, rel, d, rcut, cell), gx - w0 * g


@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_gxgd_skipping_dead_pairs_is_exact(periodic, d_min):
    """The fp32 gx+gd kernel's rule, pair by pair, gives the fp32 twin's
    gpos and gx exactly (torch.equal): on the lone atom's row (its
    diagonal alone at z != 1), rows with live and dead pairs, pairs below
    d_min 2.0 (the linear term) and, at d_min 0, the pair at d < rcut with
    z == 1.0f that the kernel drops from gd's keep mask."""
    pos, rcut = _gxgd_case(d_min)
    x, g, c, c2, w0 = _gxgd_operands(pos.shape[1], seed=10)
    w_lin = _lin_slope(c2) if d_min > 0 else None
    cell = _cell(periodic)
    d, z = ck.pair_geometry(pos, rcut, d_min, cell)
    eye = torch.eye(pos.shape[1], dtype=torch.bool)
    on = z != 1.0
    assert not bool((on & ~eye)[:, A - 1].any())  # the lone atom's row
    assert bool((on & ~eye).any(2)[:, :A - 1].all())
    assert bool((~on).any(2).all())  # every row holds dead pairs
    if d_min > 0:
        assert bool(((d < d_min) & ~eye).any())
    else:
        hazard = (d < rcut) & (z == 1.0)
        assert bool(hazard[:, A, A + 1].all())
        assert bool(hazard[:, A + 1, A].all())
    ref = ck.cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, g, rcut, "fp32",
                                      d_min, w_lin, cell)
    out = _gxgd_live_pairs(c, c2, w0, pos, x, g, rcut, d_min, w_lin, cell)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))
    assert bool((ref[0] != 0.0).any())


def _gxgd_live_pair_order(c, c2, w0, pos, x, g, rcut, d_min, w_lin, cell):
    """The fp32 gx+gd kernel's order of operations in plain float32: per
    pair with z != 1 of row i, in column order, one recurrence T_m (T_0 =
    1, T_1 = z) gives Wq = (1 - z) sum_k T_k q_k + low w_lin and Wc =
    sum_m T_m c2_m; gx_i = sum_p Wq g_j - w0 g_i; W = (1 - z) / d sum_f Wc
    (g_i x_j + g_j x_i) on the pairs in the keep mask (0 on the others),
    gpos_i = -sum_p W rel_p."""
    q = ck._to_that_basis(c)
    cell, inv = ck._cell_operands(cell, pos.shape[0], pos.device)
    rel = ck.pair_rel(pos, cell, inv)
    d, z = ck._geometry(rel, rcut, d_min)
    gx = torch.empty_like(g)
    gpos = torch.zeros_like(pos)
    for s in range(pos.shape[0]):
        for i in range(pos.shape[1]):
            js = torch.nonzero(z[s, i] != 1.0)[:, 0]
            zj = z[s, i, js][:, None]

            def series(coef):
                ta, tb = torch.ones_like(zj), zj
                wf = ta * coef[0]
                for m in range(1, coef.shape[0]):
                    wf = wf + tb * coef[m]
                    ta, tb = tb, 2.0 * zj * tb - ta
                return wf

            wq = (1.0 - zj) * series(q)
            if w_lin is not None:
                low = torch.clamp(d[s, i, js] - d_min, max=0.0)
                low = torch.where(js == i, torch.zeros_like(low), low)
                wq = wq + low[:, None] * w_lin
            gx[s, i] = (wq * g[s, js]).sum(0) - w0 * g[s, i]
            sym = g[s, i] * x[s, js] + g[s, js] * x[s, i]
            dj = d[s, i, js]
            keep = (dj < rcut) & (js != i)
            w = (1.0 - z[s, i, js]) * (series(c2) * sym).sum(1) / dj
            w = torch.where(keep, w, torch.zeros_like(w))
            gpos[s, i] = -(w[:, None] * rel[s, i, js]).sum(0)
    return gpos, gx


@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_gxgd_live_pair_order_matches_the_twin(periodic, d_min):
    """The fp32 gx+gd kernel's per-pair filters (gd as W_ij + W_ji from
    one Wc, each row owning its gradient; gx summed per row in ring order)
    agree with the twin within 1e-4 of max|twin| (the card's bound)."""
    pos, rcut = _gxgd_case(d_min)
    x, g, c, c2, w0 = _gxgd_operands(pos.shape[1], seed=11)
    w_lin = _lin_slope(c2) if d_min > 0 else None
    cell = _cell(periodic)
    got = _gxgd_live_pair_order(c, c2, w0, pos, x, g, rcut, d_min, w_lin,
                                cell)
    ref = ck.cheb_conv_bwd_gxgd_plain(c, c2, w0, pos, x, g, rcut, "fp32",
                                      d_min, w_lin, cell)
    for o, r in zip(got, ref):
        assert float((o - r).abs().max() / r.abs().max()) <= 1e-4


@pytest.mark.parametrize("d_min", [0.0, 2.0])
@pytest.mark.parametrize("periodic", [False, True], ids=["open", "cell"])
def test_gxgd_twin_matches_pallas_on_live_pairs(periodic, d_min):
    """The fp32 gx+gd twin on those positions (the lone atom, and at d_min
    0 the pair at z == 1.0f) against the reference's Pallas kernel with
    need_gx and need_gd (interpreted), at 1e-4 of max|jax|; the gd series
    at 16 orders, one Pallas chain."""
    pos, rcut = _gxgd_case(d_min)
    x, g, c, _, w0 = _gxgd_operands(pos.shape[1], seed=12)
    rng = np.random.default_rng(13)
    c2 = _t((rng.normal(size=(16, F)) / 16).astype(np.float32))
    w_lin = _lin_slope(c2) if d_min > 0 else None
    cell = CELL if periodic else None
    jc, jc2, jw0 = (jnp.asarray(v.numpy()) for v in (c, c2, w0))
    refs = [cheb_conv_bwd_pallas(
        jc, jc2, jw0, jnp.asarray(pos[s].numpy()), jnp.asarray(x[s].numpy()),
        jnp.asarray(g[s].numpy()), rcut, "fp32", need_gx=True, need_gd=True,
        cell=None if cell is None else jnp.asarray(cell), d_min=d_min)
        for s in range(pos.shape[0])]
    out = ck.cheb_conv_bwd_gxgd(c, c2, w0, pos, x, g, rcut, "fp32", d_min,
                                w_lin, _cell(periodic))
    for k in range(2):
        ref = np.stack([np.asarray(r[k]) for r in refs])
        err = np.abs(out[k].numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max()
