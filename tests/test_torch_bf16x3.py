"""Port parity for the near-fp32 ``bf16x3`` tier of the Chebyshev path.

The zoo's default orders and its fidelity-frontier warning against the JAX
zoo; the port's hi/lo split and three-pass product against the reference's
``_split_bf16`` / ``_mxu_dot``; each bf16x3 twin against its Pallas kernel
called in interpreter mode at ``"bf16x3"`` (conftest sets
FLASHMD_PALLAS_INTERPRET=1; the interpreter splits the operands as the TPU
kernel does); the whole force field at bf16x3 against the JAX one on
both cheb schedules, open and periodic; and the exact-filter paths, whose
bf16x3 is their fp32 variant.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.ops.pallas.cheb_kernel import (
    _mxu_dot,
    _split_bf16 as j_split_bf16,
    cheb_conv_bwd_pallas,
    cheb_conv_fwd_pallas,
)
from flashmd_tpu_torch.models.cheb import _lin_slope, attach_cheb_fit
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops import cheb_kernel as ck
from flashmd_tpu_torch.ops._launch import _dot, _split_bf16
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
F = 16
M1, M2 = 8, 12
S = 1  # molecules of the kernel-level inputs
A = 48
BATCH = 2  # molecules of the force-field tests
L = 9.0
# rows = lattice vectors; smallest perpendicular width 8.93 > 2 rcut
TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.0, 9.0, 0.0], [0.5, 0.5, 9.0]],
                     np.float32)
# bf16x3 twin vs the Pallas kernel at bf16x3, ||twin - ref|| / ||ref||
# (Frobenius norms). Both take the same three bf16 products of hi/lo
# splits; they differ in float32 summation order and in the float32 basis
# values that are split (the Pallas kernel steps its recurrence by its
# chain stride, the twin by one order), which now and then moves a lo part
# by one bf16 step. Those sparse moves make a max-norm ratio noisy, so the
# norm is held: 9.9e-8-5.2e-7 here. The fp32 twin misses the splits'
# dropped bits in every product and lies at 2.2e-6-5.0e-6 from the same
# Pallas output, so the bound also shows that the splits are taken. The
# orders stay low (8, 12): interpreted Pallas costs time per order.
TWIN_BOUND = 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _nrel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _zoo_config(module_fn, **kw):
    """(order, order_deriv, d_min) of a zoo config, a symmetric order's
    derivative order (None in both packages' configs) resolved to the
    order, and the frontier warnings its call emitted."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ff, _ = module_fn(batch_size=1, **kw)
    cfg = ff.schnet_config
    frontier = [str(w.message) for w in caught
                if "fidelity frontier" in str(w.message)]
    deriv = cfg.cheb_order_deriv
    return (cfg.cheb_order, cfg.cheb_order if deriv is None else deriv,
            cfg.cheb_d_min), frontier


# (n_atoms, cheb_order, cheb_order_deriv): the all-default orders, each
# explicit order alone and both; at 24 beads, between the bf16x3 frontier
# (266) and the bf16 one (532), and past both.
ZOO_CASES = [(24, None, None), (24, 40, None), (24, None, 80), (24, 40, 56),
             (300, None, None), (533, None, None)]


@pytest.mark.parametrize("precision", ["bf16x3", "bf16"])
def test_zoo_configs_match_reference(precision):
    """The port's zoo picks the JAX zoo's (order, order_deriv, d_min) for
    each case, and warns exactly where it warns."""
    for n_atoms, order, deriv in ZOO_CASES:
        kw = dict(n_atoms=n_atoms, precision=precision, cheb_order=order,
                  cheb_order_deriv=deriv, num_interactions=1,
                  neighbor_capacity=16)
        ref, ref_warn = _zoo_config(jcgschnet, message_passing="cheb", **kw)
        got, got_warn = _zoo_config(cgschnet_1enh_like, device="cpu",
                                    message_passing="cheb", **kw)
        assert got == ref, (n_atoms, order, deriv)
        assert len(got_warn) == len(ref_warn), (n_atoms, order, deriv)
    assert _zoo_config(cgschnet_1enh_like, n_atoms=266, precision=precision,
                       num_interactions=1, neighbor_capacity=16,
                       message_passing="cheb", device="cpu")[0] == (
        (64, 96, 2.0) if precision == "bf16x3" else (48, 64, 2.0))


@pytest.mark.parametrize("precision,frontier", [("bf16x3", 266),
                                                ("bf16", 532)])
def test_zoo_warns_past_frontier(precision, frontier):
    """One bead past the measured frontier both zoos warn once, with the
    same frontier in the message; at the frontier, or with an explicit
    order, neither does."""
    kw = dict(precision=precision, num_interactions=1, neighbor_capacity=16)
    for n_atoms, order, expect in ((frontier + 1, None, 1),
                                   (frontier, None, 0),
                                   (frontier + 1, 64, 0)):
        _, ref = _zoo_config(jcgschnet, message_passing="cheb",
                             n_atoms=n_atoms, cheb_order=order, **kw)
        _, got = _zoo_config(cgschnet_1enh_like, device="cpu",
                             message_passing="cheb", n_atoms=n_atoms,
                             cheb_order=order, **kw)
        assert len(ref) == len(got) == expect, (n_atoms, order)
        for r, g in zip(ref, got):
            head = f"(A={frontier} for precision={precision!r})"
            assert head in r and head in g


def test_split_and_product_match_reference():
    """The split is bit-identical to the reference's; the three-pass
    product matches _mxu_dot(a, b, "bf16x3") to float32 summation order."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(37, 53)).astype(np.float32)
    b = rng.normal(size=(53, 29)).astype(np.float32)
    hi, lo = _split_bf16(_t(a))
    j_hi, j_lo = j_split_bf16(jnp.asarray(a))
    np.testing.assert_array_equal(
        hi.numpy(), np.asarray(j_hi.astype(jnp.float32)))
    np.testing.assert_array_equal(
        lo.numpy(), np.asarray(j_lo.astype(jnp.float32)))
    ref = np.asarray(_mxu_dot(jnp.asarray(a), jnp.asarray(b), "bf16x3"))
    got = _dot(_t(a), _t(b), "bf16x3").numpy()
    assert _rel(got, ref) <= 1e-7
    # the split is taken: a plain float32 product is farther off
    assert _rel(_t(a).numpy() @ b, ref) > 1e-7


def _coeffs(seed):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(M1, F)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, F)) / M2).astype(np.float32)
    w0 = rng.normal(size=(F,)).astype(np.float32)
    return c, c2, w0


def _inputs(seed, f=F):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-L / 2, L / 2, (S, A, 3)).astype(np.float32)
    x = rng.normal(size=(S, A, f)).astype(np.float32)
    g = rng.normal(size=(S, A, f)).astype(np.float32)
    return pos, x, g


def _per_mol(fn, cell, *arrays):
    """Outputs of a per-molecule JAX function over the leading S axis,
    each stacked."""
    outs = [fn(None if cell is None else jnp.asarray(cell),
               *(jnp.asarray(a[s]) for a in arrays)) for s in range(S)]
    if not isinstance(outs[0], tuple):
        return np.stack([np.asarray(o) for o in outs])
    return tuple(np.stack([np.asarray(o[k]) for o in outs])
                 for k in range(len(outs[0])))


def _twin_and_reference(kernel, cell, d_min):
    """(twin at a tier -> outputs, Pallas bf16x3 outputs) of one kernel."""
    c, c2, w0 = _coeffs(seed=10)
    pos, x, g = _inputs(seed=11)
    tcell = None if cell is None else _t(cell)
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    jc, jc2, jw0 = (jnp.asarray(v) for v in (c, c2, w0))
    if kernel == "fwd":
        jw_lin = None if w_lin is None else jnp.asarray(w_lin.numpy())
        ref = (_per_mol(lambda cl, p, xx: cheb_conv_fwd_pallas(
            jc, jw0, p, xx, RCUT, "bf16x3", cell=cl, d_min=d_min,
            w_lin=jw_lin), cell, pos, x),)
        return (lambda tier: (ck.cheb_conv_fwd_plain(
            _t(c), _t(w0), _t(pos), _t(x), RCUT, tier, d_min, w_lin,
            tcell),), ref)
    if kernel == "gx":
        ref = (_per_mol(lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jc, jc2, jw0, p, xx, gg, RCUT, "bf16x3", need_gx=True,
            need_gd=False, cell=cl, d_min=d_min)[1], cell, pos, x, g),)
        return (lambda tier: (ck.cheb_conv_bwd_gx_plain(
            _t(c), _t(w0), _t(pos), _t(g), RCUT, tier, d_min, w_lin,
            tcell),), ref)
    if kernel == "gd":
        # block-stacked operands of two blocks, as the stack's gd launch
        c2_cat = np.concatenate([c2, _coeffs(seed=12)[1]], axis=1)
        pos, x, g = _inputs(seed=13, f=2 * F)
        ref = (_per_mol(lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jnp.zeros((1, 2 * F), jnp.float32), jnp.asarray(c2_cat),
            jnp.zeros((2 * F,), jnp.float32), p, xx, gg, RCUT, "bf16x3",
            need_gx=False, need_gd=True, cell=cl, d_min=d_min,
            stacked=True)[0], cell, pos, x, g),)
        return (lambda tier: (ck.cheb_conv_bwd_gd_plain(
            _t(c2_cat), _t(pos), _t(x), _t(g), RCUT, tier, d_min,
            tcell),), ref)
    ref = _per_mol(lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
        jc, jc2, jw0, p, xx, gg, RCUT, "bf16x3", need_gx=True, need_gd=True,
        cell=cl, d_min=d_min), cell, pos, x, g)
    return (lambda tier: ck.cheb_conv_bwd_gxgd_plain(
        _t(c), _t(c2), _t(w0), _t(pos), _t(x), _t(g), RCUT, tier, d_min,
        w_lin, tcell), ref)


@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("cell", [None, TRICLINIC], ids=["open", "cell"])
@pytest.mark.parametrize("kernel", ["fwd", "gx", "gd", "gxgd"])
def test_bf16x3_twins_match_pallas(kernel, cell, d_min):
    """Each bf16x3 twin (fwd; gx-only; stacked gd-only; gx+gd, whose
    outputs are (gpos, gx)) against its Pallas kernel at "bf16x3", within
    TWIN_BOUND; the fp32 twin on the same inputs lies outside it."""
    twin, ref = _twin_and_reference(kernel, cell, d_min)
    x3 = [o.numpy() for o in twin("bf16x3")]
    fp32 = [o.numpy() for o in twin("fp32")]
    assert max(_nrel(o, r) for o, r in zip(x3, ref)) <= TWIN_BOUND
    assert min(_nrel(o, r) for o, r in zip(fp32, ref)) > TWIN_BOUND


@functools.cache
def _carried_pair(precision):
    """A small 2-block zoo model in JAX and the same weights in the port,
    both with their host fits attached: orders (12, 16) on d_min 2.0,
    below the tier's (64, 96) to keep the JAX trace short, with the
    sub-floor linear term on. Built once per module (the tests derive
    their variants by ``replace``)."""
    jff, jcfgs = jcgschnet(
        n_atoms=32, batch_size=BATCH, num_interactions=2,
        precision=precision,
        message_passing="cheb", neighbor_capacity=32, cheb_order=12,
        cheb_order_deriv=16, cheb_d_min=2.0,
    )
    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    np_params.pop("cheb_fit", None)
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    )
    jff = jff.replace(schnet_params=jcheb.attach_cheb_fit(
        jff.schnet_params, jff.schnet_config))
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    return jff, jcfgs, ff


# The 32-bead chain spans ~31 A; cells of 24 A (half width 12 > rcut 10)
# wrap its far pairs into the cutoff.
BIG_CELLS = np.stack([24.0 * np.eye(3, dtype=np.float32),
                      np.array([[24.0, 0.0, 0.0], [3.0, 24.0, 0.0],
                                [2.0, 2.0, 24.0]], np.float32)])


@pytest.mark.parametrize("periodic", [False, True],
                         ids=["open", "periodic"])
@pytest.mark.parametrize("stack", ["1", "0"], ids=["stacked", "per-block"])
def test_bf16x3_forces_match_jax(stack, periodic, monkeypatch):
    """The port's bf16x3 network forces (priors removed, so max|F| is the
    network's own) on both cheb schedules against the JAX ones on the
    CPU, whose jnp branch computes the HIGH dots in float32: 1e-4 of
    max|F|, as the fp32 parity tests (the splits' own error is ~1e-6 of
    max|F|, the rest summation order)."""
    monkeypatch.setenv("FLASHMD_CHEB_STACK", stack)
    jff, jcfgs, ff = _carried_pair("bf16x3")
    jff, ff = jff.replace(priors={}), ff.replace(priors={})
    cell = BIG_CELLS if periodic else None
    pos_np = np.stack([c.pos for c in jcfgs]).astype(np.float32)
    je, jf, _ = jcompute_energy_forces(
        jff, jnp.asarray(pos_np), jnp.asarray(jcfgs[0].atom_types),
        cell=None if cell is None else jnp.asarray(cell),
    )
    e, f, _ = compute_energy_forces(
        ff, _t(pos_np), torch.tensor(jcfgs[0].atom_types).long(),
        cell=None if cell is None else _t(cell),
    )
    jf = np.asarray(jf)
    assert np.abs(f.numpy() - jf).max() <= 1e-4 * np.abs(jf).max()
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("message_passing", ["dense", "pallas"])
def test_exact_filter_bf16x3_is_fp32(message_passing):
    """The exact-filter paths compute bf16x3 in float32, as the reference
    (compute_dtype float32 at HIGHEST for every tier but bf16): forces
    equal to the fp32 tier's, bit for bit."""
    forces = {}
    for precision in ("fp32", "bf16x3"):
        ff, cfgs = cgschnet_1enh_like(
            n_atoms=24, batch_size=2, num_interactions=2,
            precision=precision, message_passing=message_passing,
            neighbor_capacity=24, device="cpu",
        )
        pos = _t(np.stack([c.pos for c in cfgs]).astype(np.float32))
        forces[precision] = compute_energy_forces(
            ff, pos, torch.tensor(cfgs[0].atom_types).long())[1]
    assert torch.equal(forces["bf16x3"], forces["fp32"])
