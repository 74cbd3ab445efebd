"""Port parity of mixed-size batches: molecules of different sizes in one
padded batch, one network over all of them, each with its own priors.

The JAX package's mixed path (tests/test_mixed_batch.py: sizes (7, 12),
hidden 16, 2 blocks) is the reference: the same weights are carried into
the port with ``forcefield_from_numpy``, and the port is held against it
on the collation, the padded and stacked priors, the energies, forces and
components of every message-passing path (the kernels' plain twins on the
CPU, the JAX Pallas kernels interpreted), the integrators with the
reference's draws injected, the files, the refusals and the reading of a
JAX mixed run's specialized dump. Padding must add exactly nothing: the
padded rows' forces are exactly zero, and every integrator leaves them
bitwise where they started.

Tolerances (float32 on both sides): energies and forces 1e-4 of their
largest magnitude, the port's force-field tolerance against JAX
(tests/test_torch_models.py); collation and prior leaves exact; prior
energies 1e-6 relative (elementwise float32 terms summed in another
order).
"""

import contextlib
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.data.system import collate_padded as jcollate_padded
from flashmd_tpu.models.checkpoint_io import (
    save_native_model as jsave_native_model,
)
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.forcefield import (
    stack_forcefields as jstack_forcefields,
)
from flashmd_tpu.prior.priors import densify_repulsion as jdensify
from flashmd_tpu.prior.priors import pad_prior as jpad_prior
from flashmd_tpu.prior.priors import prior_energy as jprior_energy
from flashmd_tpu.prior.priors import stack_priors as jstack_priors
from flashmd_tpu.simulation import LangevinSimulation as JLangevin
from flashmd_tpu_torch.data.system import (
    Configuration,
    collate,
    collate_padded,
)
from flashmd_tpu_torch.models.checkpoint_io import (
    load_native_configurations,
    load_native_model,
)
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import (
    compute_energy_forces,
    stack_forcefields,
)
from flashmd_tpu_torch.prior.priors import (
    Prior,
    pad_prior,
    prior_energy,
    stack_priors,
)
from flashmd_tpu_torch.simulation import (
    LangevinSimulation,
    NVESimulation,
    OverdampedSimulation,
    PTSimulation,
)
from tests.test_mixed_batch import SIZES, _molecule, _schnet
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4
PATHS = ("xla", "dense", "pallas", "cheb")


def _config_kwargs(config):
    return {f.name: getattr(config, f.name)
            for f in dataclasses.fields(config)}


def _port_config(c: JConfiguration) -> Configuration:
    return Configuration(pos=c.pos, atom_types=c.atom_types,
                         masses=c.masses, velocities=c.velocities)


def _carry(jff):
    """The port's field of a JAX field, bit-identical weights (the JAX
    Chebyshev fits included)."""
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        {k: jax.tree.map(np.asarray, p) for k, p in jff.priors.items()},
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity,
    )
    assert ff.batched_priors == jff.batched_priors
    return ff


@functools.cache
def molecules():
    """The JAX suite's two molecules (bonds, term-list repulsion, and
    dihedrals of which the 7-bead one has none), each with its term-list
    repulsion also densified, as JAX and port configurations."""
    jcfgs, jpriors = [], []
    for i, a in enumerate(SIZES):
        cfg, priors = _molecule(a, seed=10 + i)
        priors["dense_repulsion"] = jdensify(priors["repulsion"], a)
        jcfgs.append(cfg)
        jpriors.append(priors)
    return jcfgs, jpriors


@functools.cache
def fields(mp):
    """(JAX per-molecule fields, JAX stacked field, port per-molecule
    fields, port stacked field carried from the JAX one) on path ``mp``
    at fp32."""
    params, config = _schnet()
    config = dataclasses.replace(config, message_passing=mp,
                                 cheb_order=16, cheb_order_deriv=16)
    if mp == "cheb":
        from flashmd_tpu.models.cheb import attach_cheb_fit

        params = attach_cheb_fit(params, config)
    _, jpriors = molecules()
    jffs = [JForceField(schnet_params=params, priors=p, schnet_config=config,
                        neighbor_capacity=max(SIZES)) for p in jpriors]
    jmixed = jstack_forcefields(jffs)
    return jffs, jmixed, [_carry(f) for f in jffs], _carry(jmixed)


def _jax_forces(jff, jsys):
    return jax.jit(lambda p: jcompute_energy_forces(
        jff, p, jsys.atom_types, atom_mask=jsys.atom_mask))(jsys.pos)


# ---------------------------------------------------------------------------
# Collation
# ---------------------------------------------------------------------------

def test_collate_padded_matches_jax():
    jcfgs, _ = molecules()
    rng = np.random.default_rng(2)
    jcfgs = [dataclasses.replace(c, velocities=rng.normal(size=c.pos.shape))
             for c in jcfgs]
    jsys = jcollate_padded(jcfgs, beta=[1.5, 2.0])
    sys_ = collate_padded([_port_config(c) for c in jcfgs], beta=[1.5, 2.0],
                          device="cpu")
    for name in ("pos", "atom_types", "masses", "atom_mask", "beta",
                 "velocities"):
        ours, ref = getattr(sys_, name).numpy(), np.asarray(getattr(jsys,
                                                                    name))
        assert ours.shape == ref.shape, name
        np.testing.assert_array_equal(ours, ref, err_msg=name)
    assert sys_.atom_mask.dtype == torch.float32
    assert sys_.cell is None and sys_.term_lists == {}
    # the ladder: padded atoms pad_spacing apart, and far from every real
    # atom (pad_spacing from the molecule's mean)
    pos0 = sys_.pos[0].double().numpy()
    d = np.linalg.norm(pos0[:, None] - pos0[None, :], axis=-1)
    np.fill_diagonal(d, np.inf)
    a0 = SIZES[0]
    assert d[a0:, a0:].min() >= 1e4 - 1e-2
    assert d[a0:, :a0].min() > 1e3


def test_collate_padded_refusals_match_jax():
    jcfgs, _ = molecules()
    cases = [
        (dict(cell=np.eye(3) * 20.0), NotImplementedError, "periodic"),
        (dict(exc_pair_index=np.array([[0], [1]])), NotImplementedError,
         "exc_pair_index"),
    ]
    for change, exc, match in cases:
        bad = dataclasses.replace(jcfgs[0], **change)
        with pytest.raises(exc, match=match):
            jcollate_padded([bad, jcfgs[1]])
        port = dataclasses.replace(_port_config(jcfgs[0]), **change)
        port.__post_init__()
        with pytest.raises(exc, match=match):
            collate_padded([port, _port_config(jcfgs[1])], device="cpu")
    with pytest.raises(ValueError, match="empty"):
        collate_padded([], device="cpu")


def test_masses_on_every_configuration_or_none():
    """The port's fix of the reference's fault: a configuration without
    masses beside one with them raises (the reference gives its atoms
    mass 1.0, data/system.py:444, :486); all or none collate."""
    jcfgs, _ = molecules()
    with_m = [_port_config(c) for c in jcfgs]
    without = [dataclasses.replace(c, masses=None) for c in with_m]
    for mixed in ([with_m[0], without[1]], [without[0], with_m[1]]):
        with pytest.raises(ValueError, match="Inconsistent mass"):
            collate_padded(mixed, device="cpu")
    # the reference collates the same batch with mass 1.0 in its place
    ref = jcollate_padded([jcfgs[0], dataclasses.replace(jcfgs[1],
                                                         masses=None)])
    assert np.all(np.asarray(ref.masses[1]) == 1.0)
    assert torch.all(collate_padded(without, device="cpu").masses == 1.0)
    masses = collate_padded(with_m, device="cpu").masses
    np.testing.assert_array_equal(masses[1].numpy(),
                                  jcfgs[1].masses.astype(np.float32))


# ---------------------------------------------------------------------------
# Priors
# ---------------------------------------------------------------------------

def _port_prior(jp) -> Prior:
    jp = jax.tree.map(np.asarray, jp)
    return Prior(
        index_mapping=torch.as_tensor(np.array(jp.index_mapping),
                                      dtype=torch.int64),
        params={k: torch.as_tensor(np.array(v)) for k, v in jp.params.items()},
        kind=jp.kind, name=jp.name, feature=jp.feature,
        term_mask=(None if jp.term_mask is None
                   else torch.as_tensor(jp.term_mask)),
    )


def _assert_same_prior(ours: Prior, ref):
    assert (ours.kind, ours.name, ours.feature) == (ref.kind, ref.name,
                                                    ref.feature)
    np.testing.assert_array_equal(ours.index_mapping.numpy(),
                                  np.asarray(ref.index_mapping))
    assert ours.params.keys() == ref.params.keys()
    for k, v in ours.params.items():
        assert v.shape == ref.params[k].shape, k
        np.testing.assert_array_equal(v.numpy(), np.asarray(ref.params[k]))
    if ref.term_mask is None:
        assert ours.term_mask is None
    else:
        np.testing.assert_array_equal(ours.term_mask.numpy(),
                                      np.asarray(ref.term_mask))


@pytest.mark.parametrize("name", ["bonds", "repulsion", "dihedrals",
                                  "dense_repulsion"])
def test_pad_and_stack_priors_match_jax(name):
    """pad_prior (first-term copies; consecutive atoms and zero
    parameters for the 7-bead molecule's empty dihedral list) and
    stack_priors (dense sigma6 zero-extended) give JAX's leaves, and the
    stacked prior JAX's per-molecule energies on the padded positions."""
    jcfgs, jpriors = molecules()
    jps = [p[name] for p in jpriors]
    if name != "dense_repulsion":
        for jp in jps:
            n = jp.n_terms + 5
            _assert_same_prior(pad_prior(_port_prior(jp), n),
                               jpad_prior(jp, n))
    jstacked = jstack_priors(jps)
    stacked = stack_priors([_port_prior(jp) for jp in jps])
    assert stacked.batched
    _assert_same_prior(stacked, jstacked)
    jsys = jcollate_padded(jcfgs)
    ref = jax.vmap(jprior_energy)(jstacked, jsys.pos)
    ours = prior_energy(stacked, torch.tensor(np.asarray(jsys.pos)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


def test_padding_adds_exactly_nothing_to_a_prior():
    """A prior padded with masked terms gives the unpadded energy and an
    exactly equal gradient, every kind of the molecules and a polynomial
    one (whose ``ks`` the port pads along the term axis)."""
    jcfgs, jpriors = molecules()
    pos = torch.tensor(jcfgs[1].pos[None], dtype=torch.float32)
    priors = {k: _port_prior(p) for k, p in jpriors[1].items()
              if k != "dense_repulsion"}
    angles = np.stack([np.arange(10), np.arange(1, 11), np.arange(2, 12)])
    rng = np.random.default_rng(3)
    priors["poly"] = Prior(
        index_mapping=torch.as_tensor(angles), kind="polynomial",
        name="angles", feature="angle_cos",
        params={"ks": torch.tensor(rng.normal(size=(4, 10)),
                                   dtype=torch.float32),
                "v_0": torch.tensor(rng.normal(size=10),
                                    dtype=torch.float32)})
    for name, prior in priors.items():
        padded = pad_prior(prior, prior.n_terms + 4)
        grads = []
        for p in (prior, padded):
            q = pos.clone().requires_grad_(True)
            e = prior_energy(p, q)
            (g,) = torch.autograd.grad(e.sum(), q)
            grads.append((e.detach(), g))
        torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-6,
                                   atol=0, msg=name)
        assert torch.equal(grads[0][1], grads[1][1]), name


# ---------------------------------------------------------------------------
# Force fields
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mp", PATHS)
def test_mixed_forces_match_jax(mp):
    """Energies, forces and components of the stacked field on the padded
    batch against JAX's; the padded rows' forces exactly zero; the JAX
    stack carried and the port's own stack of the carried per-molecule
    fields give the same forces."""
    jffs, jmixed, ffs, mixed = fields(mp)
    jcfgs, _ = molecules()
    jsys = jcollate_padded(jcfgs, beta=1.0)
    je, jf, jcomps = _jax_forces(jmixed, jsys)
    sys_ = collate_padded([_port_config(c) for c in jcfgs], beta=1.0,
                          device="cpu")
    e, f, comps = compute_energy_forces(mixed, sys_.pos, sys_.atom_types,
                                        atom_mask=sys_.atom_mask)
    jf = np.asarray(jf)
    assert f.shape == jf.shape
    assert np.abs(f.numpy() - jf).max() <= TOL * np.abs(jf).max()
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=TOL,
                               atol=TOL)
    assert set(comps) == set(jcomps)
    for k, v in comps.items():
        ref = np.asarray(jcomps[k])
        assert np.abs(v.numpy() - ref).max() <= TOL * max(
            np.abs(ref).max(), 1.0), k
    a0 = SIZES[0]
    assert torch.all(f[0, a0:] == 0.0)
    own = stack_forcefields(ffs)
    assert own.batched_priors and own.neighbor_capacity == max(SIZES)
    _, f_own, _ = compute_energy_forces(own, sys_.pos, sys_.atom_types,
                                        atom_mask=sys_.atom_mask)
    assert torch.equal(f_own, f)


@pytest.mark.parametrize("mp", PATHS)
def test_mixed_matches_each_molecule_alone(mp):
    """Each molecule's rows of the mixed batch against its own
    homogeneous evaluation in the port (the JAX suite's
    test_mixed_matches_separate_runs, its bounds)."""
    _, _, ffs, mixed = fields(mp)
    jcfgs, _ = molecules()
    cfgs = [_port_config(c) for c in jcfgs]
    sys_ = collate_padded(cfgs, beta=1.0, device="cpu")
    e, f, comps = compute_energy_forces(mixed, sys_.pos, sys_.atom_types,
                                        atom_mask=sys_.atom_mask)
    for s, (cfg, ff) in enumerate(zip(cfgs, ffs)):
        one = collate([cfg], beta=1.0, device="cpu")
        e1, f1, c1 = compute_energy_forces(ff, one.pos, one.atom_types)
        a = cfg.n_atoms
        np.testing.assert_allclose(float(e[s]), float(e1[0]), rtol=2e-5)
        np.testing.assert_allclose(f[s, :a].numpy(), f1[0].numpy(),
                                   rtol=5e-4, atol=1e-5)
        for k in c1:
            np.testing.assert_allclose(float(comps[k][s]), float(c1[k][0]),
                                       rtol=2e-5, atol=1e-6, err_msg=k)


def test_force_field_refusals_match_jax():
    """The reference's refusals: [A] types on a batched-prior field, a
    mask or mapped types with a cell, differing networks or exclusions
    in stack_forcefields."""
    jffs, jmixed, ffs, mixed = fields("xla")
    jcfgs, _ = molecules()
    jsys = jcollate_padded(jcfgs)
    sys_ = collate_padded([_port_config(c) for c in jcfgs], device="cpu")
    with pytest.raises(ValueError, match="per-sim") as ref:
        jcompute_energy_forces(jmixed, jsys.pos, jsys.atom_types[0])
    with pytest.raises(ValueError, match="per-sim") as ours:
        compute_energy_forces(mixed, sys_.pos, sys_.atom_types[0])
    assert str(ours.value) == str(ref.value)
    cell = np.eye(3) * 50.0
    with pytest.raises(NotImplementedError, match="periodic") as ref:
        jcompute_energy_forces(jmixed, jsys.pos, jsys.atom_types,
                               cell=jnp.asarray(cell, jnp.float32),
                               atom_mask=jsys.atom_mask)
    with pytest.raises(NotImplementedError, match="periodic") as ours:
        compute_energy_forces(mixed, sys_.pos, sys_.atom_types,
                              cell=torch.tensor(cell, dtype=torch.float32),
                              atom_mask=sys_.atom_mask)
    assert str(ours.value) == str(ref.value)
    other = ffs[1].replace(schnet_params=jax.tree.map(
        lambda t: t + 1.0, ffs[1].schnet_params))
    with pytest.raises(ValueError, match="identical SchNet parameters"):
        stack_forcefields([ffs[0], other])
    with pytest.raises(NotImplementedError, match="exc_pair_index"):
        stack_forcefields([ffs[0].replace(
            exc_pair_index=torch.tensor([[0], [1]])), ffs[1]])
    with pytest.raises(ValueError, match="unbatched"):
        stack_forcefields([mixed, ffs[0]])
    with pytest.raises(ValueError, match="keysets"):
        stack_forcefields([ffs[0], ffs[1].replace(priors={})])


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

KW = dict(dt=2e-3, n_timesteps=5, save_interval=5, random_seed=3)


def _jax_noise(jcarry):
    _, sub = jax.random.split(jcarry["key"])
    return jax.random.normal(sub, jcarry["pos"].shape, jnp.float32)


def test_baoab_step_matches_jax_with_injected_noise():
    """Five BAOAB steps of the cheb mixed batch (velocities sampled and
    masked, the noise scale masked) against JAX with its draws injected;
    the padding does not move."""
    jffs, _, ffs, _ = fields("cheb")
    jcfgs, _ = molecules()
    jsim = JLangevin(friction=1.0, gptq=None, **KW)
    jsim.attach_model_and_configurations(jffs, jcfgs, beta=1.5)
    sim = LangevinSimulation(friction=1.0, gptq=None, device="cpu", **KW)
    sim.attach_model_and_configurations(
        ffs, [_port_config(c) for c in jcfgs], beta=1.5)
    np.testing.assert_array_equal(sim.beta_mass_ratio.numpy(),
                                  np.asarray(jsim.beta_mass_ratio))
    a0 = SIZES[0]
    assert torch.all(sim.initial_system.velocities[0, a0:] == 0.0)
    assert torch.all(sim.beta_mass_ratio[0, a0:] == 0.0)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._timestep)
    # the JAX velocities come from its own generator: start from them
    start = sim.initial_system
    start.velocities = torch.tensor(np.asarray(jsim.initial_system.velocities))
    with torch.no_grad():
        carry = sim._init_carry(start)
        for t in range(5):
            xi = _jax_noise(jcarry)
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, torch.tensor(np.asarray(xi)),
                                         t)
    np.testing.assert_allclose(carry["pos"].numpy(), np.asarray(jcarry["pos"]),
                               rtol=0, atol=1e-4)
    jv = np.asarray(jcarry["vel"])
    assert np.abs(carry["vel"].numpy() - jv).max() <= 1e-3 * np.abs(jv).max()
    assert torch.equal(carry["pos"][0, a0:], start.pos[0, a0:])
    assert torch.all(carry["vel"][0, a0:] == 0.0)


@pytest.mark.parametrize("mp", PATHS)
def test_langevin_run_freezes_the_padding(mp, tmp_path):
    """40 Langevin steps of the mixed batch through simulate(): finite,
    the padded rows of every frame bitwise the initial ladder, the real
    atoms moved, no blow-up from the far-away padding, the mask written
    once, equal to JAX's for the same configurations; and the kinetic
    energy per real degree of freedom as the JAX suite gates it."""
    _, _, ffs, _ = fields(mp)
    jcfgs, _ = molecules()
    cfgs = [_port_config(c) for c in jcfgs]
    sim = LangevinSimulation(
        friction=1.0, dt=2e-3, n_timesteps=40, save_interval=10,
        random_seed=7, save_energies=True, gptq=None, device="cpu",
        filename="mixed", output_dir=str(tmp_path))
    sim.attach_model_and_configurations(ffs, cfgs, beta=1.5)
    sim.simulate()
    coords = sim.coords  # [S, frames, A, 3]
    assert coords.shape == (2, 4, max(SIZES), 3)
    assert np.all(np.isfinite(coords))
    mask = np.load(tmp_path / "mixed_atom_mask.npy")
    assert mask.dtype == np.float32
    np.testing.assert_array_equal(
        mask, np.asarray(jcollate_padded(jcfgs).atom_mask))
    a0 = SIZES[0]
    pad0 = sim.initial_system.pos[0, a0:].numpy()
    np.testing.assert_array_equal(coords[0, :, a0:],
                                  np.broadcast_to(pad0, coords[0, :, a0:]
                                                  .shape))
    assert np.abs(coords[0, -1, :a0] - coords[0, 0, :a0]).max() > 1e-4
    ke = sim.simulated_kinetic_energies  # [frames, S]
    for s, a in enumerate(SIZES):
        expect = 1.5 * a / 1.5
        assert 0.4 * expect < ke[:, s].mean() < 1.9 * expect
    assert os.path.isfile(tmp_path / "mixed_specialized_model_and_config.pkl")


@pytest.mark.parametrize("cls", [NVESimulation, OverdampedSimulation])
def test_nve_and_overdamped_freeze_the_padding(cls):
    """Velocity Verlet (padding at rest, zero force) and overdamped
    dynamics (zero diffusion on the padding) leave the padded rows
    bitwise in place; against JAX's steps with its draws injected."""
    from flashmd_tpu.simulation import NVESimulation as JNVE
    from flashmd_tpu.simulation import OverdampedSimulation as JOver

    jffs, _, ffs, _ = fields("xla")
    jcfgs, _ = molecules()
    cfgs = [_port_config(c) for c in jcfgs]
    extra = {} if cls is NVESimulation else {"friction": 1.0}
    jcls = JNVE if cls is NVESimulation else JOver
    jsim = jcls(gptq=None, **extra, **KW)
    sim = cls(gptq=None, device="cpu", **extra, **KW)
    for s, fs, cs in ((jsim, jffs, jcfgs), (sim, ffs, cfgs)):
        with (pytest.warns(UserWarning, match="Masses were provided")
              if cls is OverdampedSimulation else contextlib.nullcontext()):
            s.attach_model_and_configurations(fs, cs, beta=1.5)
    start = sim.initial_system
    if cls is NVESimulation:
        start.velocities = torch.tensor(
            np.asarray(jsim.initial_system.velocities))
    else:
        np.testing.assert_array_equal(sim.diffusion.numpy(),
                                      np.asarray(jsim.diffusion))
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._timestep)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        carry = sim._init_carry(start)
        for t in range(5):
            xi, _ = sim._step_draws(gen, t)
            if cls is OverdampedSimulation:
                xi = torch.tensor(np.asarray(_jax_noise(jcarry)))
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, xi, t)
    np.testing.assert_allclose(carry["pos"].numpy(), np.asarray(jcarry["pos"]),
                               rtol=0, atol=1e-4)
    a0 = SIZES[0]
    assert torch.equal(carry["pos"][0, a0:], start.pos[0, a0:])
    assert torch.all(carry["forces"][0, a0:] == 0.0)
    sim.simulate()
    assert np.array_equal(sim.coords[0, :, a0:],
                          np.broadcast_to(start.pos[0, a0:].numpy(),
                                          sim.coords[0, :, a0:].shape))


def test_frame_spread_counts_real_atoms_only():
    """The blow-up statistic of a mixed batch over its real atoms, against
    JAX's masked one on the same positions."""
    jffs, _, ffs, _ = fields("xla")
    jcfgs, _ = molecules()
    jsim = JLangevin(friction=1.0, gptq=None, **KW)
    jsim.attach_model_and_configurations(jffs, jcfgs, beta=1.5)
    sim = LangevinSimulation(friction=1.0, gptq=None, device="cpu", **KW)
    sim.attach_model_and_configurations(
        ffs, [_port_config(c) for c in jcfgs], beta=1.5)
    pos = sim.initial_system.pos
    jout = jsim._frame_outputs({"pos": jnp.asarray(pos.numpy()),
                                "vel": jnp.zeros(pos.shape),
                                "potential": jnp.zeros(2),
                                "forces": jnp.zeros(pos.shape)})
    out = sim._frame_outputs({"pos": pos, "potential": torch.zeros(2)})
    np.testing.assert_allclose(out["pos_spread"].numpy(),
                               np.asarray(jout["pos_spread"]), rtol=1e-6)
    assert float(out["pos_spread"].max()) < 10.0  # the ladder is 1e4 away


def test_components_match_jax():
    """The energy and force components at a save point of the cheb mixed
    batch (the atom mask and [S, A] types through one more evaluation)
    against JAX's ``_component_outputs``; the padded rows of each force
    component exactly 0."""
    from flashmd_tpu.simulation import NVESimulation as JNVE

    jffs, _, ffs, _ = fields("cheb")
    jcfgs, _ = molecules()
    kw = dict(gptq=None, save_energy_components=True,
              energy_components=["SchNet", "dihedrals"],
              save_force_components=True,
              force_components=["SchNet", "dense_repulsion"], **KW)
    jsim = JNVE(**kw)
    jsim.attach_model_and_configurations(jffs, jcfgs, beta=1.5)
    sim = NVESimulation(device="cpu", **kw)
    sim.attach_model_and_configurations(
        ffs, [_port_config(c) for c in jcfgs], beta=1.5)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(0))
    jout = jax.jit(jsim._component_outputs)(jcarry)
    with torch.no_grad():
        out = sim._component_outputs(sim._init_carry(sim.initial_system))
    assert sorted(out) == sorted(jout)
    for k, v in out.items():
        ref = np.asarray(jout[k])
        assert v.shape == ref.shape, k
        assert np.abs(v.numpy() - ref).max() <= TOL * max(
            np.abs(ref).max(), 1.0), k
        if k.startswith("force_component"):
            assert torch.all(v[0, SIZES[0]:] == 0.0), k


def test_engine_refusals_match_jax():
    """A single field over configurations of different sizes, a field
    list of the wrong length, a stacked field of another batch size and
    parallel tempering with a field list raise as in JAX."""
    from flashmd_tpu.simulation import PTSimulation as JPT

    jffs, jmixed, ffs, mixed = fields("xla")
    jcfgs, _ = molecules()
    cfgs = [_port_config(c) for c in jcfgs]
    cases = [
        ((jffs[0], jcfgs), (ffs[0], cfgs), ValueError, "per-molecule"),
        (([jffs[0]], jcfgs), ([ffs[0]], cfgs), ValueError,
         "one per configuration"),
        ((jmixed, jcfgs + jcfgs[:1]), (mixed, cfgs + cfgs[:1]), ValueError,
         "carries 2 molecules"),
    ]
    for (jm, jc), (m, c), exc, match in cases:
        with pytest.raises(exc, match=match) as ref:
            JLangevin(friction=1.0, **KW).attach_model_and_configurations(
                jm, jc, beta=1.0)
        with pytest.raises(exc, match=match) as ours:
            LangevinSimulation(friction=1.0, device="cpu", **KW) \
                .attach_model_and_configurations(m, c, beta=1.0)
        assert str(ours.value) == str(ref.value)
    with pytest.raises(NotImplementedError, match="mixed-size") as ref:
        JPT(friction=1.0, **KW).attach_model_and_configurations(
            jffs, jcfgs, [1.0, 0.5])
    with pytest.raises(NotImplementedError, match="mixed-size") as ours:
        PTSimulation(friction=1.0, device="cpu", **KW) \
            .attach_model_and_configurations(ffs, cfgs, [1.0, 0.5])
    assert str(ours.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def test_jax_mixed_dump_read_by_the_port(tmp_path):
    """A JAX mixed run's specialized dump (its stacked ForceField with
    batched priors, the configurations of both sizes) read by the port:
    equal forces to the JAX field on the padded batch; the port's own
    dump of the same run reads back to bitwise the same forces."""
    jffs, _, ffs, _ = fields("cheb")
    jcfgs, _ = molecules()
    jsim = JLangevin(friction=1.0, gptq=None, filename="jmixed",
                     output_dir=str(tmp_path), **KW)
    jsim.attach_model_and_configurations(jffs, jcfgs, beta=1.5)
    dump = tmp_path / "jmixed_specialized_model_and_config.pkl"
    ff = load_native_model(str(dump), device="cpu")
    cfgs = load_native_configurations(str(dump))
    assert ff.batched_priors and [c.n_atoms for c in cfgs] == list(SIZES)
    jsys = jcollate_padded(jcfgs)
    _, jf, _ = _jax_forces(jsim.model, jsys)
    sys_ = collate_padded(cfgs, device="cpu")
    _, f, _ = compute_energy_forces(ff, sys_.pos, sys_.atom_types,
                                    atom_mask=sys_.atom_mask)
    jf = np.asarray(jf)
    assert np.abs(f.numpy() - jf).max() <= TOL * np.abs(jf).max()
    # the port's own mixed run writes a dump that reads back the same
    sim = LangevinSimulation(friction=1.0, gptq=None, device="cpu",
                             filename="mixed", output_dir=str(tmp_path),
                             **KW)
    sim.attach_model_and_configurations(ffs, cfgs, beta=1.5)
    ours = load_native_model(
        str(tmp_path / "mixed_specialized_model_and_config.pkl"),
        device="cpu")
    assert ours.batched_priors
    _, f_ours, _ = compute_energy_forces(ours, sys_.pos, sys_.atom_types,
                                         atom_mask=sys_.atom_mask)
    _, f_sim, _ = compute_energy_forces(sim.model, sys_.pos, sys_.atom_types,
                                        atom_mask=sys_.atom_mask)
    assert torch.equal(f_ours, f_sim)
    # and a JAX native model file of a stacked field
    jsave_native_model(jsim.model, str(tmp_path / "model.pkl"))
    assert load_native_model(str(tmp_path / "model.pkl"),
                             device="cpu").batched_priors
