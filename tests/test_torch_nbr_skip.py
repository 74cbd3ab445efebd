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

``cfconv_bwd`` at fp32 runs the same live slots (the bf16 first pass's
ring) through float32 FMAs on the CUDA cores, stores W of each live slot
for the gx pass (``gx_kernel``, which reads it back over the source CSR
where its own pair geometry says live) and gathers gpos's column side
over the CSR (``gpos_kernel``): a ring-order emulation of those three
passes equals ``cfconv_bwd_plain`` at fp32 within 1e-5 of max|twin| and
the reference's ``_bwd_kernel`` (Pallas, interpreted) within 1e-5, with
and without gx, on stale and overflowed lists with a row that has no live
slot; and the slots whose W the first pass writes are exactly the ones
whose geometry, taken the gx pass's way, is live.

``cfconv_fwd`` at fp32 (and bf16x3) runs the bf16 forward's live slots
through the same float32 tiles, each row's (W cut) x_j summed in ring
order, which is slot order within the row: a ring-order emulation of it
equals ``cfconv_fwd_plain`` at fp32 and the reference's ``_fwd_kernel``
(Pallas, interpreted) within 1e-5 of max|ref|, on symmetric and
overflowed lists, fresh and stale, and the row with no live slot is
exactly zero in all three.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.ops.pallas.cfconv import (_fused_cfconv_bwd,
                                           _fused_cfconv_fwd)
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


def _lone_case(kind, stale, seed):
    """_case with the last atom of each molecule 3 RCUT + SKIN away from
    every other (moved before the build of a fresh list, after that of a
    stale one): its row has no live slot."""
    rng = np.random.default_rng(seed)
    side = (A / 0.0229) ** (1 / 3)
    pos = (side * rng.random((S, A, 3))).astype(np.float32)

    def move(p):
        p = p.copy()
        p[:, -1, 1] = p[:, :, 1].max(axis=1) + 3 * RCUT + SKIN
        return p

    if not stale:
        pos = move(pos)
    nbr = batched_radius_neighbor_matrix(_t(pos), RCUT + SKIN,
                                         CAPACITY[kind])
    if stale:
        pos = move(pos + (0.5 * rng.normal(size=pos.shape)).astype(
            np.float32))
    return _t(pos), nbr


def _pair_live(pi, pj):
    """The kernels' pair_geom in float32 for rel = pj - pi: (live at
    RCUT, d, cut)."""
    rel = (pj - pi).astype(np.float32)
    d2 = rel[..., 0] * rel[..., 0] + rel[..., 1] * rel[..., 1]
    d2 = (d2 + rel[..., 2] * rel[..., 2]).astype(np.float32)
    d = np.sqrt(np.maximum(d2, np.float32(1e-12))).astype(np.float32)
    return d < RCUT, d


def _ring_order_bwd(pos, nbr, x, g, w0, b0, w1, offset, coeff, need_gx):
    """The fp32 kernels' three passes in plain float32. First pass: each
    row's live slots (mask set and d < rc), in slot order (the ring's),
    run the MLP backward: gd per slot (0 on every other slot) and, with
    gx, W of the slot into a workspace (NaN elsewhere). gpos: the row side
    over the row's mask slots, then the column side over the atom's CSR
    entries in order (gpos_kernel). gx: over the atom's CSR entries in
    order, (W cut) g_i where the entry's geometry, p_a - p_i, is live
    (gx_kernel)."""
    rel, d, cut, dcut, e, rbf = cf._slot_geometry(pos, nbr.idx, nbr.mask,
                                                  offset, coeff, RCUT)
    n_s, a, k = nbr.idx.shape
    f = x.shape[-1]
    live = nbr.mask & (d < RCUT)
    gd = torch.zeros(n_s, a, k)
    wbuf = torch.full((n_s, a, k, f), float("nan"))
    for s in range(n_s):
        for i in range(a):
            ks = torch.nonzero(live[s, i])[:, 0]
            if ks.numel() == 0:
                continue
            js = nbr.idx[s, i, ks].long()
            ct = cut[s, i, ks][:, None]
            a0 = torch.tanh(rbf[s, i, ks] @ w0 + b0)
            w = a0 @ w1
            wbuf[s, i, ks] = w
            s_cut = torch.sum((g[s, i] * w) * x[s, js], dim=1)
            ga0 = ((g[s, i] * x[s, js]) * ct) @ w1.T
            grbf = (ga0 * (1.0 - a0 * a0)) @ w0.T
            ee = e[s, i, ks]
            dr = d[s, i, ks][:, None] - offset
            se = torch.sum(grbf * ee, dim=1)
            sg = torch.sum(grbf * ee * dr, dim=1)
            gd[s, i, ks] = (ct[:, 0] * (2.0 * coeff) * sg
                            + (s_cut + se) * dcut[s, i, ks])
    flat_pos = pos.reshape(-1, 3)
    offsets, slots = nbr.csr_offsets.long(), nbr.csr_slots.long()
    gpos = torch.zeros(n_s, a, 3)
    gx = torch.zeros_like(x) if need_gx else None
    for s in range(n_s):
        for i in range(a):
            u = rel[s, i] / d[s, i][:, None]
            row = -torch.sum((gd[s, i] * nbr.mask[s, i])[:, None] * u, dim=0)
            acc = torch.zeros(f)
            for entry in slots[offsets[s * a + i]:offsets[s * a + i + 1]]:
                owner = int(entry) // k
                r = flat_pos[s * a + i] - flat_pos[owner]
                dd = torch.sqrt(torch.clamp(torch.sum(r * r), min=1e-12))
                row = row + gd.reshape(-1)[entry] * (r / dd)
                if need_gx and bool(dd < RCUT):
                    c = 0.5 * (torch.cos(dd * (np.pi / RCUT)) + 1.0)
                    acc = acc + (wbuf.reshape(-1, f)[entry] * c) * \
                        g.reshape(-1, f)[owner]
            gpos[s, i] = row
            if need_gx:
                gx[s, i] = acc
    return gpos, gx, wbuf


def _ring_order_fwd(pos, nbr, x, w0, b0, w1, offset, coeff):
    """The fp32 forward kernel in plain float32: each row's live slots
    (mask set and d < rc), in slot order (the ring's), run the two
    products; out of the row is the running sum of (W cut) x_j in that
    order, zero for a row with no live slot."""
    _, d, cut, _, _, rbf = cf._slot_geometry(pos, nbr.idx, nbr.mask, offset,
                                             coeff, RCUT)
    n_s, a, _ = nbr.idx.shape
    live = nbr.mask & (d < RCUT)
    out = torch.zeros_like(x)
    for s in range(n_s):
        for i in range(a):
            ks = torch.nonzero(live[s, i])[:, 0]
            if ks.numel() == 0:
                continue
            w = torch.tanh(rbf[s, i, ks] @ w0 + b0) @ w1
            acc = torch.zeros(x.shape[-1])
            for p, k in enumerate(ks):
                acc = acc + (w[p] * cut[s, i, k]) * x[s, nbr.idx[s, i, k]]
            out[s, i] = acc
    return out


def _close(out, ref, bound=1e-5):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() <= bound * np.abs(ref).max()


@pytest.mark.parametrize("need_gx", [True, False], ids=["gx", "no_gx"])
@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
def test_ring_order_matches_the_twin_and_pallas(kind, stale, need_gx):
    """The fp32 live-slot backward's emulation against the fp32 twin and
    the reference's Pallas backward (interpreted), within 1e-5 of
    max|ref|, on a list whose last row has no live slot."""
    pos, nbr = _lone_case(kind, stale, seed=6)
    x, g, (w0, b0, w1, offset, coeff) = _operands(seed=7)
    geometry, dead = _geometry(pos, nbr, offset, coeff)
    assert bool(dead[:, -1].all())  # the lone row
    assert (int(nbr.n_max.max()) > CAPACITY[kind]) == (kind == "overflowed")
    gpos, gx, _ = _ring_order_bwd(pos, nbr, x, g, w0, b0, w1, offset, coeff,
                                  need_gx)
    gpos_ref, gx_ref = cf.cfconv_bwd_plain(
        pos, nbr.idx, nbr.mask, x, g, w0, b0, w1, offset, coeff, RCUT,
        "fp32", need_gx)
    assert _close(gpos.numpy(), gpos_ref.numpy())
    assert (gx is None) == (gx_ref is None) == (not need_gx)
    if need_gx:
        assert _close(gx.numpy(), gx_ref.numpy())
    rbf = (jnp.asarray(offset.numpy()), jnp.asarray(coeff.numpy()))
    for s in range(S):
        residuals = (jnp.asarray(pos[s].numpy()),
                     jnp.asarray(nbr.idx[s].numpy()),
                     jnp.asarray(nbr.mask[s].numpy().astype(np.float32)),
                     jnp.asarray(x[s].numpy()),
                     *(jnp.asarray(v.numpy()) for v in (w0, b0, w1)), rbf)
        cts = _fused_cfconv_bwd(RCUT, 8, "fp32", residuals,
                                jnp.asarray(g[s].numpy()))
        assert _close(gpos[s].numpy(), cts[0])
        if need_gx:
            assert _close(gx[s].numpy(), cts[3])


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
def test_forward_ring_order_matches_the_twin_and_pallas(kind, stale):
    """The fp32 live-slot forward's emulation against the fp32 twin and
    the reference's Pallas forward (interpreted), within 1e-5 of
    max|ref|; the last row of each molecule has no live slot, and its out
    is exactly zero in all three."""
    pos, nbr = _lone_case(kind, stale, seed=10)
    x, _, (w0, b0, w1, offset, coeff) = _operands(seed=11)
    _, dead = _geometry(pos, nbr, offset, coeff)
    assert bool(dead[:, -1].all())  # the lone row
    assert (int(nbr.n_max.max()) > CAPACITY[kind]) == (kind == "overflowed")
    out = _ring_order_fwd(pos, nbr, x, w0, b0, w1, offset, coeff)
    ref = cf.cfconv_fwd_plain(pos, nbr.idx, nbr.mask, x, w0, b0, w1, offset,
                              coeff, RCUT, "fp32")
    assert _close(out.numpy(), ref.numpy())
    assert not bool(out[:, -1].any()) and not bool(ref[:, -1].any())
    weights = tuple(jnp.asarray(v.numpy()) for v in (w0, b0, w1))
    rbf = (jnp.asarray(offset.numpy()), jnp.asarray(coeff.numpy()))
    for s in range(S):
        jout, _ = _fused_cfconv_fwd(
            jnp.asarray(pos[s].numpy()), jnp.asarray(nbr.idx[s].numpy()),
            jnp.asarray(nbr.mask[s].numpy().astype(np.float32)),
            jnp.asarray(x[s].numpy()), *weights, rbf, RCUT, 8, "fp32")
        assert _close(out[s].numpy(), jout)
        assert not bool(np.asarray(jout)[-1].any())


@pytest.mark.parametrize("stale", [False, True], ids=["fresh", "stale"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
def test_w_is_written_where_gx_reads_it(kind, stale):
    """The slots whose W the fp32 first pass stores (its vote: mask set
    and d < rc, rel = p_j - p_i) are exactly the CSR entries that gx_kernel
    reads (its geometry, rel = p_a - p_i of each entry's owner i): the
    masked slots (the row's own index at d = 1e-6) are in neither, and the
    emulation's workspace holds a finite W there and NaN elsewhere."""
    pos, nbr = _lone_case(kind, stale, seed=8)
    x, g, (w0, b0, w1, offset, coeff) = _operands(seed=9)
    p = pos.numpy()
    n_s, a, k = nbr.idx.shape
    idx, mask = nbr.idx.numpy(), nbr.mask.numpy()
    rows = np.arange(a)[None, :, None]
    assert bool((idx[~mask] == np.broadcast_to(rows, idx.shape)[~mask]).all())
    b = np.arange(n_s)[:, None, None]
    vote, _ = _pair_live(p[:, :, None, :], p[b, idx])
    written = set(np.flatnonzero(mask & vote).tolist())
    offsets, slots = nbr.csr_offsets.numpy(), nbr.csr_slots.numpy()
    flat = p.reshape(-1, 3)
    read = set()
    for atom in range(n_s * a):
        for entry in slots[offsets[atom]:offsets[atom + 1]]:
            ok, _ = _pair_live(flat[entry // k], flat[atom])
            if ok:
                read.add(int(entry))
    assert written == read and len(written) > 0
    assert not (set(np.flatnonzero(~mask).tolist()) & read)
    _, _, wbuf = _ring_order_bwd(pos, nbr, x, g, w0, b0, w1, offset, coeff,
                                 True)
    finite = torch.isfinite(wbuf).all(dim=-1).reshape(-1).numpy()
    assert set(np.flatnonzero(finite).tolist()) == written
