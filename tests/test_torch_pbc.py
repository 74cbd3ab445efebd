"""Port parity for the periodic-cell Chebyshev path: the minimum-image
twins of the three cheb kernels, the cell through the force field and the
engine, and the refusals, against the JAX package on identical inputs.

fp32 twins are held against the Pallas kernels called directly in
interpreter mode (the JAX suite's tolerances, tests/ops/test_cheb_kernel.py:
2e-5 forward, 1e-4 backward); bf16 twins against the pure-jnp branch of
models/cheb.py. Positions are uniform in a box of L = 9 with rcut 4, so
many pairs wrap; every comparison also checks that the cell changes the
answer.
"""

import dataclasses
import functools

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
from flashmd_tpu.ops.neighborlist import _inv_3x3 as j_inv_3x3
from flashmd_tpu.ops.neighborlist import min_cell_width as jmin_cell_width
from flashmd_tpu.ops.pallas.cheb_kernel import (
    cheb_conv_bwd_pallas,
    cheb_conv_fwd_pallas,
)
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration, collate
from flashmd_tpu_torch.models.cheb import _lin_slope, attach_cheb_fit
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import (
    ForceField,
    compute_energy_forces,
)
from flashmd_tpu_torch.models.schnet import SchNetConfig, init_schnet
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops import cheb_kernel as ck
from flashmd_tpu_torch.ops import neighborlist as nl
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

L = 9.0
RCUT = 4.0
F = 16
M1, M2 = 12, 16
S = 2
A = 48
CUBIC = L * np.eye(3, dtype=np.float32)
# rows = lattice vectors; smallest perpendicular width 8.93 > 2 rcut
TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.0, 9.0, 0.0], [0.5, 0.5, 9.0]],
                     np.float32)
CELLS = {
    "cubic": CUBIC,  # one [3, 3] cell for the batch
    "triclinic": TRICLINIC,
    "per_molecule": np.stack([CUBIC, TRICLINIC]),  # [S, 3, 3]
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _coeffs(seed=0, f=F):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(M1, f)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, f)) / M2).astype(np.float32)
    w0 = rng.normal(size=(f,)).astype(np.float32)
    return c, c2, w0


def _inputs(seed=1, f=F):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, L, (S, A, 3)).astype(np.float32)
    x = rng.normal(size=(S, A, f)).astype(np.float32)
    g = rng.normal(size=(S, A, f)).astype(np.float32)
    return pos, x, g


def _mol_cells(cell):
    """The [S, 3, 3] cells of a [3, 3] or [S, 3, 3] cell."""
    return np.broadcast_to(cell, (S, 3, 3))


def _per_mol(fn, cell, *arrays):
    """A per-molecule JAX function over the leading S axis, each molecule
    with its own [3, 3] cell."""
    cells = _mol_cells(cell)
    return np.stack([
        np.asarray(fn(jnp.asarray(cells[s]),
                      *(jnp.asarray(a[s]) for a in arrays)))
        for s in range(S)
    ])


def _assert_cell_matters(out, open_):
    assert not np.allclose(out, open_, rtol=1e-3, atol=1e-3)


def test_inverse_and_width_match_reference():
    cells = np.stack([CUBIC, TRICLINIC, 60.0 * np.eye(3, dtype=np.float32)])
    inv = nl._inv_3x3(_t(cells)).numpy()
    ref = np.stack([np.asarray(j_inv_3x3(jnp.asarray(c))) for c in cells])
    np.testing.assert_allclose(inv, ref, rtol=1e-6, atol=1e-7)
    for c in cells:
        assert nl.min_cell_width(c) == jmin_cell_width(c)


@pytest.mark.parametrize("cell_kind", list(CELLS))
@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_fwd_cell_twin_matches_pallas_fp32(cell_kind, d_min):
    cell = CELLS[cell_kind]
    c, c2, w0 = _coeffs()
    pos, x, _ = _inputs()
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    jw_lin = None if w_lin is None else jnp.asarray(w_lin.numpy())
    ref = _per_mol(
        lambda cl, p, xx: cheb_conv_fwd_pallas(
            jnp.asarray(c), jnp.asarray(w0), p, xx, RCUT, "fp32", cell=cl,
            d_min=d_min, w_lin=jw_lin,
        ),
        cell, pos, x,
    )
    args = (_t(c), _t(w0), _t(pos), _t(x), RCUT, "fp32", d_min, w_lin)
    out = ck.cheb_conv_fwd(*args, cell=_t(cell)).numpy()
    # 2e-5: the JAX suite's forward kernel tolerance (summation order).
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
    _assert_cell_matters(out, ck.cheb_conv_fwd(*args).numpy())


@pytest.mark.parametrize("cell_kind", list(CELLS))
@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_bwd_gx_cell_twin_matches_pallas_fp32(cell_kind, d_min):
    cell = CELLS[cell_kind]
    c, c2, w0 = _coeffs(seed=2)
    pos, x, g = _inputs(seed=3)
    ref = _per_mol(
        lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jnp.asarray(c), jnp.asarray(c2), jnp.asarray(w0), p, xx, gg,
            RCUT, "fp32", need_gx=True, need_gd=False, cell=cl, d_min=d_min,
        )[1],
        cell, pos, x, g,
    )
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    args = (_t(c), _t(w0), _t(pos), _t(g), RCUT, "fp32", d_min, w_lin)
    out = ck.cheb_conv_bwd_gx(*args, cell=_t(cell)).numpy()
    # 1e-4: the JAX suite's backward kernel tolerance.
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    _assert_cell_matters(out, ck.cheb_conv_bwd_gx(*args).numpy())


@pytest.mark.parametrize("cell_kind", list(CELLS))
@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_bwd_gd_stacked_cell_twin_matches_pallas_fp32(cell_kind, d_min):
    cell = CELLS[cell_kind]
    nb = 2
    c2_cat = np.concatenate([_coeffs(seed=4 + b)[1] for b in range(nb)], 1)
    pos, x_cat, g_cat = _inputs(seed=5, f=nb * F)
    fdim = nb * F
    ref = _per_mol(
        lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jnp.zeros((1, fdim), jnp.float32), jnp.asarray(c2_cat),
            jnp.zeros((fdim,), jnp.float32), p, xx, gg, RCUT, "fp32",
            need_gx=False, need_gd=True, cell=cl, d_min=d_min, stacked=True,
        )[0],
        cell, pos, x_cat, g_cat,
    )
    args = (_t(c2_cat), _t(pos), _t(x_cat), _t(g_cat), RCUT, "fp32", d_min)
    # the inverse may be handed in, as the stack does
    cells = _t(np.ascontiguousarray(_mol_cells(cell)))
    out = ck.cheb_conv_bwd_gd(*args, cell=cells,
                              inv=nl._inv_3x3(cells)).numpy()
    # 1e-4: the JAX suite's backward kernel tolerance.
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    _assert_cell_matters(out, ck.cheb_conv_bwd_gd(*args).numpy())


@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_bf16_cell_twins_match_jnp_branch(d_min):
    """bf16 twins under a per-molecule cell vs the pure-jnp _cheb_fwd /
    _cheb_bwd with the same cells (cheb.py:607-772), at the bounds of the
    open test (test_torch_kernels.test_bf16_twins_match_jnp_branch): the
    forward rounds at the same places, so only the summation order
    differs; the backward twins round on the kernels' own bases (That_k
    and q_k g; c2_m g) where the jnp branch rounds g, then c_m g, on the
    Ttil basis. Measured here: backward 1.9e-3 to 4.0e-3 of the output's
    scale with the cell and without it alike."""
    cell = CELLS["per_molecule"]
    c, c2, w0 = _coeffs(seed=6)
    pos, x, g = _inputs(seed=7)
    jc, jc2, jw0 = (jnp.asarray(v) for v in (c, c2, w0))
    fwd = _per_mol(
        lambda cl, p, xx: jcheb._cheb_fwd(jc, jc2, jw0, p, xx, cl, RCUT,
                                          "bf16", True, d_min)[0],
        cell, pos, x,
    )
    bwd = [
        jcheb._cheb_bwd(RCUT, "bf16", True, d_min,
                        (jc, jc2, jw0, jnp.asarray(pos[s]),
                         jnp.asarray(x[s]), jnp.asarray(cell[s])),
                        jnp.asarray(g[s]))
        for s in range(S)
    ]
    gpos_ref = np.stack([np.asarray(b[3]) for b in bwd])
    gx_ref = np.stack([np.asarray(b[4]) for b in bwd])

    tc, tc2, tw0, tcell = _t(c), _t(c2), _t(w0), _t(cell)
    w_lin = _lin_slope(tc2) if d_min > 0 else None
    out = ck.cheb_conv_fwd(tc, tw0, _t(pos), _t(x), RCUT, "bf16", d_min,
                           w_lin, cell=tcell).numpy()
    gx = ck.cheb_conv_bwd_gx(tc, tw0, _t(pos), _t(g), RCUT, "bf16", d_min,
                             w_lin, cell=tcell).numpy()
    gpos = ck.cheb_conv_bwd_gd(tc2, _t(pos), _t(x), _t(g), RCUT, "bf16",
                               d_min, cell=tcell).numpy()

    def rel(a_, b_):
        return np.abs(a_ - b_).max() / np.abs(b_).max()

    assert rel(out, fwd) <= 1e-5
    assert rel(gx, gx_ref) <= 1e-2
    assert rel(gpos, gpos_ref) <= 1e-2


@functools.cache
def _carried_pair(precision, cheb_order, **kw):
    """A small zoo model in JAX and the same weights in the port, built
    once per module and argument tuple (tests derive variants by
    ``replace``)."""
    jff, jcfgs = jcgschnet(
        n_atoms=32, batch_size=S, num_interactions=2, precision=precision,
        message_passing="cheb", neighbor_capacity=32, cheb_order=cheb_order,
        **kw,
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
BIG_CUBIC = 24.0 * np.eye(3, dtype=np.float32)
BIG_TRICLINIC = np.array([[24.0, 0.0, 0.0], [3.0, 24.0, 0.0],
                          [2.0, 2.0, 24.0]], np.float32)


@pytest.mark.parametrize(
    "precision,cheb_order,tol,cell,priors",
    [
        # fp32 with an explicit small order: summation order only, on the
        # network alone (the priors never see the cell).
        ("fp32", 16, 1e-4, BIG_CUBIC, False),
        ("fp32", 16, 1e-4, np.stack([BIG_CUBIC, BIG_TRICLINIC]), False),
        # bf16 defaults (48, 64, d_min 2) with the priors, as
        # test_torch_models.test_force_evaluation_matches_jax: the port
        # rounds bf16 operands on the kernels' bases, JAX on the Ttil
        # basis (network alone: 3.0e-3 with the cell, 2.4e-3 without).
        ("bf16", None, 2e-3, np.stack([BIG_TRICLINIC, BIG_CUBIC]), True),
    ],
    ids=["fp32-shared", "fp32-per-molecule", "bf16-per-molecule"],
)
def test_periodic_forces_match_jax(precision, cheb_order, tol, cell, priors):
    """Forces and energies of compute_energy_forces(..., cell=...) against
    JAX on carried weights."""
    jff, jcfgs, ff = _carried_pair(precision, cheb_order)
    if not priors:
        jff, ff = jff.replace(priors={}), ff.replace(priors={})
    pos_np = np.stack([c.pos for c in jcfgs]).astype(np.float32)
    types = torch.tensor(jcfgs[0].atom_types).long()
    je, jf, _ = jcompute_energy_forces(
        jff, jnp.asarray(pos_np), jnp.asarray(jcfgs[0].atom_types),
        cell=jnp.asarray(cell),
    )
    e, f, _ = compute_energy_forces(ff, _t(pos_np), types, cell=_t(cell))
    jf = np.asarray(jf)
    assert np.abs(f.numpy() - jf).max() <= tol * np.abs(jf).max()
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=tol, atol=tol)
    _, f_open, _ = compute_energy_forces(ff, _t(pos_np), types)
    _assert_cell_matters(f.numpy(), f_open.numpy())


# tests/models/test_pbc.py:27-64: atom 1 sees atom 0 only across a face.
SMALL_L, SMALL_RCUT = 5.0, 2.0


def _small_cheb_ff():
    cfg = SchNetConfig(
        hidden_channels=32, embedding_size=4, num_filters=32,
        num_interactions=2, num_rbf=16, cutoff=CosineCutoff(0.0, SMALL_RCUT),
        output_hidden_layer_widths=(16,), message_passing="cheb",
        cheb_order=96, precision="fp32",
    )
    params = init_schnet(cfg, torch.Generator().manual_seed(0), "cpu")
    return ForceField(schnet_params=attach_cheb_fit(params, cfg), priors={},
                      schnet_config=cfg)


def _small_setup():
    pos = torch.tensor([[[0.2, 2.5, 2.5], [4.8, 2.5, 2.5],
                         [2.5, 2.5, 2.5]]])
    return pos, torch.tensor([0, 1, 2]), SMALL_L * torch.eye(3)


def test_cheb_periodic_matches_unwrapped_image():
    """cheb + cell vs cheb open-boundary on the image-equivalent geometry
    (tests/models/test_pbc.py:123-141): the same tabulated filter on both
    sides, so only float32 arithmetic differs; without the cell the
    boundary pair is missed."""
    ff = _small_cheb_ff()
    pos, types, cell = _small_setup()
    e_p, f_p, _ = compute_energy_forces(ff, pos, types, cell=cell)
    pos_img = pos.clone()
    pos_img[0, 1, 0] -= SMALL_L
    e_o, f_o, _ = compute_energy_forces(ff, pos_img, types)
    np.testing.assert_allclose(e_p.numpy(), e_o.numpy(), rtol=1e-5)
    np.testing.assert_allclose(f_p.numpy(), f_o.numpy(), rtol=1e-4,
                               atol=1e-5)
    e_open, _, _ = compute_energy_forces(ff, pos, types)
    assert not np.allclose(e_p.numpy(), e_open.numpy())


def test_cheb_translation_invariance_under_pbc():
    """tests/models/test_pbc.py:159-167, in the port."""
    ff = _small_cheb_ff()
    pos, types, cell = _small_setup()
    e_p, _, _ = compute_energy_forces(ff, pos, types, cell=cell)
    shifted = (pos + 1.3) % SMALL_L
    e_s, _, _ = compute_energy_forces(ff, shifted, types, cell=cell)
    np.testing.assert_allclose(e_p.numpy(), e_s.numpy(), rtol=1e-5)


def test_refusals():
    """dense and pallas refuse cells; unsound cells raise on a direct call
    and at attach; collation refuses inconsistent and malformed cells."""
    ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=S,
                                  num_interactions=1, message_passing="cheb",
                                  device="cpu")
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    system = collate(cfgs, device="cpu")
    sound = 21.0 * torch.eye(3)
    for mp in ("dense", "pallas"):
        other = ff.replace(schnet_config=dataclasses.replace(
            ff.schnet_config, message_passing=mp))
        with pytest.raises(NotImplementedError, match="Periodic cells"):
            compute_energy_forces(other, system.pos, system.atom_types,
                                  cell=sound)
    with pytest.raises(ValueError, match="Minimum-image"):
        compute_energy_forces(ff, system.pos, system.atom_types,
                              cell=19.0 * torch.eye(3))
    with pytest.raises(ValueError, match="Minimum-image"):
        compute_energy_forces(ff, system.pos, system.atom_types,
                              cell=torch.stack([sound, 19.0 * torch.eye(3)]))
    compute_energy_forces(ff, system.pos, system.atom_types, cell=sound)

    def with_cells(*cells):
        return [dataclasses.replace(c, cell=cl) for c, cl in zip(cfgs, cells)]

    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=2,
                             save_interval=1, device="cpu")
    with pytest.raises(ValueError, match="attach_model_and_configurations"):
        sim.attach_model_and_configurations(
            ff, with_cells(np.eye(3) * 21.0, np.eye(3) * 19.0), beta=1.0)
    dense = ff.replace(schnet_config=dataclasses.replace(
        ff.schnet_config, message_passing="dense"))
    with pytest.raises(NotImplementedError, match="Periodic cells"):
        sim.attach_model_and_configurations(
            dense, with_cells(np.eye(3) * 21.0, np.eye(3) * 21.0), beta=1.0)
    with pytest.raises(ValueError, match="Inconsistent cell"):
        collate(with_cells(np.eye(3) * 21.0, None), device="cpu")
    with pytest.raises(ValueError, match=r"cell must be \[3, 3\]"):
        Configuration(pos=cfgs[0].pos, atom_types=cfgs[0].atom_types,
                      cell=np.eye(2))


def test_collate_stacks_cells():
    _, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=S,
                                 num_interactions=1, message_passing="cheb",
                                 device="cpu")
    cells = [np.eye(3) * 21.0, TRICLINIC.astype(np.float64) * 3.0]
    system = collate([dataclasses.replace(c, cell=cl)
                      for c, cl in zip(cfgs, cells)], device="cpu")
    assert system.cell.dtype == torch.float32
    assert system.cell.shape == (S, 3, 3)
    np.testing.assert_array_equal(system.cell.numpy(),
                                  np.stack(cells).astype(np.float32))
    np.testing.assert_array_equal(system.cell_host, np.stack(cells))
    assert collate(cfgs, device="cpu").cell is None


def test_baoab_steps_with_cell_match_jax_with_injected_noise():
    """A few BAOAB steps under per-molecule cells, step-exact against JAX
    with the reference's own noise (pattern of test_torch_simulation)."""
    n_steps = 4
    jff, jcfgs = jcgschnet(
        n_atoms=24, batch_size=S, num_interactions=2, precision="fp32",
        message_passing="cheb", neighbor_capacity=24, cheb_order=16,
    )
    rng = np.random.default_rng(4)
    # The 24-bead chain spans ~30 A: 21 A cells (half width 10.5 > rcut 10)
    # fold its far pairs into the cutoff.
    cells = [np.eye(3) * 21.0, np.array([[21.0, 0, 0], [2.0, 21.0, 0],
                                         [1.0, 1.0, 21.5]])]
    jcfgs = [
        dataclasses.replace(c, velocities=rng.normal(scale=0.5,
                                                     size=c.pos.shape),
                            cell=cl)
        for c, cl in zip(jcfgs, cells)
    ]
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=n_steps,
                  save_interval=n_steps, random_seed=3)
    jsim = JLangevinSimulation(gptq=None, **kwargs)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)

    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    np_params.pop("cheb_fit", None)
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    )
    cfgs = [
        Configuration(pos=c.pos, atom_types=c.atom_types, masses=c.masses,
                      velocities=c.velocities, cell=c.cell)
        for c in jcfgs
    ]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)

    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                     jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._baoab)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        # the cells change the start forces (pairs fold into the cutoff)
        open_forces = compute_energy_forces(
            sim.model, sim.initial_system.pos, sim.initial_system.atom_types
        )[1]
        _assert_cell_matters(carry["forces"].numpy(), open_forces.numpy())
        for _ in range(n_steps):
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._baoab(carry, torch.tensor(np.asarray(xi)))
    # 1e-4 A at fp32, as test_torch_simulation: summation order only.
    np.testing.assert_allclose(carry["pos"].numpy(),
                               np.asarray(jcarry["pos"]), rtol=0, atol=1e-4)
    assert np.abs(carry["vel"].numpy() - np.asarray(jcarry["vel"])).max() \
        <= 1e-3 * np.abs(np.asarray(jcarry["vel"])).max()
