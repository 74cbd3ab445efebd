"""Port parity and physics of the NVE and overdamped integrators and of the
engine's save-point record: steps against the JAX package with the
reference's own draws injected, the JAX suite's integrator and pair-floor
tests run against the port with their bounds, the divergence guard's
message against JAX's, and the frame statistics against JAX's
``_frame_outputs``."""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.simulation import NVESimulation as JNVESimulation
from flashmd_tpu.simulation import (
    OverdampedSimulation as JOverdampedSimulation,
)
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import ForceField
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.prior.priors import Prior
from flashmd_tpu_torch.simulation import (
    LangevinSimulation,
    NVESimulation,
    OverdampedSimulation,
)
from flashmd_tpu_torch.simulation.base import fetch_frames
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S = 2
N_STEPS = 5
KW = dict(dt=0.004, n_timesteps=N_STEPS, save_interval=N_STEPS,
          random_seed=3)


# ---------------------------------------------------------------------------
# Helpers shared with tests/test_torch_parallel_tempering.py
# ---------------------------------------------------------------------------

def harmonic_ff(n_atoms: int, k: float = 1.0, x0: float = 1.0) -> ForceField:
    """Pure-prior force field: a chain of harmonic bonds (no SchNet), the
    JAX suite's ``harmonic_ff`` through the port's ``Prior``."""
    mapping = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)])
    n = mapping.shape[1]
    prior = Prior(
        index_mapping=torch.as_tensor(mapping, dtype=torch.int64),
        params={"x0": torch.full((n,), x0), "k": torch.full((n,), k)},
        kind="harmonic_bonds", name="bonds", feature="distance",
    )
    return ForceField(schnet_params=None, priors={"bonds": prior})


def chain_configs(n_sims: int, n_atoms: int, spacing: float = 1.0):
    """The JAX suite's ``chain_configs``, as port configurations."""
    rng = np.random.default_rng(0)
    cfgs = []
    for _ in range(n_sims):
        pos = np.zeros((n_atoms, 3))
        pos[:, 0] = np.arange(n_atoms) * spacing
        pos += rng.normal(scale=0.05, size=pos.shape)
        cfgs.append(Configuration(pos=pos,
                                  atom_types=np.zeros(n_atoms, dtype=int),
                                  masses=np.ones(n_atoms)))
    return cfgs


def jax_harmonic_ff(n_atoms: int, k: float = 1.0):
    """``harmonic_ff`` in the JAX package."""
    from flashmd_tpu.models.forcefield import ForceField as JForceField
    from flashmd_tpu.prior.priors import Prior as JPrior

    mapping = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)])
    n = mapping.shape[1]
    return JForceField(schnet_params=None, priors={"bonds": JPrior(
        index_mapping=jnp.asarray(mapping, jnp.int32),
        params={"x0": jnp.ones(n), "k": jnp.full((n,), k)},
        kind="harmonic_bonds", name="bonds", feature="distance")})


def with_velocities(cfgs, seed=4):
    rng = np.random.default_rng(seed)
    return [dataclasses.replace(c, velocities=rng.normal(
        scale=0.5, size=c.pos.shape)) for c in cfgs]


@functools.cache
def jax_cheb_field(n_atoms=24, batch=S, cheb_d_min=None):
    """The 24-bead, 2-block cheb fp32 field of the JAX zoo with its
    configurations (velocities given), and the same field in the port;
    built once per argument tuple (callers derive variants by
    ``replace``)."""
    jff, jcfgs = jcgschnet(
        n_atoms=n_atoms, batch_size=batch, num_interactions=2,
        precision="fp32", message_passing="cheb", neighbor_capacity=24,
        cheb_order=16, cheb_d_min=cheb_d_min,
    )
    jcfgs = with_velocities(jcfgs)
    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    np_params.pop("cheb_fit", None)
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    )
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities,
                          cell=c.cell)
            for c in jcfgs]
    return jff, jcfgs, ff, cfgs


def assert_state_close(carry, jcarry, vel=True):
    # 1e-4 A at fp32: summation order of the force evaluations only.
    np.testing.assert_allclose(carry["pos"].numpy(),
                               np.asarray(jcarry["pos"]), rtol=0, atol=1e-4)
    if vel:
        jv = np.asarray(jcarry["vel"])
        assert np.abs(carry["vel"].numpy() - jv).max() \
            <= 1e-3 * np.abs(jv).max()


# ---------------------------------------------------------------------------
# Steps against JAX
# ---------------------------------------------------------------------------

def test_nve_steps_match_jax():
    jff, jcfgs, ff, cfgs = jax_cheb_field()
    jsim = JNVESimulation(gptq=None, **KW)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    sim = NVESimulation(device="cpu", gptq=None, **KW)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._timestep)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for t in range(N_STEPS):
            xi, u = sim._step_draws(gen, t)
            assert xi is None and u is None  # NVE draws nothing
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, xi, t)
    assert gen.initial_seed() == 0 and torch.equal(
        gen.get_state(), torch.Generator().manual_seed(0).get_state())
    assert_state_close(carry, jcarry)


def test_overdamped_steps_match_jax():
    jff, jcfgs, ff, cfgs = jax_cheb_field()
    kw = dict(friction=1.0, **KW)
    jsim = JOverdampedSimulation(gptq=None, **kw)
    sim = OverdampedSimulation(device="cpu", gptq=None, **kw)
    with pytest.warns(UserWarning, match="Masses were provided"):
        jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    with pytest.warns(UserWarning, match="Masses were provided"):
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    np.testing.assert_allclose(sim.diffusion.numpy(),
                               np.asarray(jsim.diffusion), rtol=1e-7)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._timestep)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for t in range(N_STEPS):
            # the reference's own draw (langevin.py:187-191)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["pos"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, torch.tensor(np.asarray(xi)),
                                         t)
    assert_state_close(carry, jcarry, vel=False)


def test_frame_statistics_match_jax():
    """pos_spread and the pair floor on the same positions under cells,
    against JAX's _frame_outputs; the kinetic-energy frame of NVE."""
    jff, jcfgs, ff, cfgs = jax_cheb_field(cheb_d_min=2.0)
    rng = np.random.default_rng(5)
    cells = [np.diag(rng.uniform(26.0, 30.0, 3)) for _ in jcfgs]
    jcfgs = [dataclasses.replace(c, cell=cl) for c, cl in zip(jcfgs, cells)]
    cfgs = [dataclasses.replace(c, cell=cl) for c, cl in zip(cfgs, cells)]
    kw = dict(save_energies=True, **KW)
    jsim = JNVESimulation(gptq=None, **kw)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    sim = NVESimulation(device="cpu", gptq=None, **kw)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert sim.initial_pos_spread == pytest.approx(jsim.initial_pos_spread,
                                                   rel=1e-12)
    # positions that wrap: shifted by a box length and jittered
    pos = np.stack([c.pos for c in cfgs]) + rng.normal(size=(S, 24, 3))
    pos[:, ::3, 0] += cells[0][0, 0]
    vel = rng.normal(size=pos.shape)
    jout = jsim._frame_outputs({"pos": jnp.asarray(pos, jnp.float32),
                                "vel": jnp.asarray(vel, jnp.float32),
                                "potential": jnp.zeros(S),
                                "forces": jnp.zeros(pos.shape)})
    out = sim._frame_outputs({"pos": torch.tensor(pos, dtype=torch.float32),
                              "vel": torch.tensor(vel, dtype=torch.float32),
                              "potential": torch.zeros(S)})
    for key in ("pos_spread", "pair_d_min", "kinetic_energy"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-6, err_msg=key)
    assert float(out["pair_d_min"]) < 2.0  # the jitter crosses the floor


def test_fetch_frames_is_exact():
    frames = {"a": torch.randn(3, 2, 5), "b": torch.arange(6, dtype=torch.int32),
              "c": torch.tensor(1.5)}
    host = fetch_frames(frames)
    for k, v in frames.items():
        assert host[k].dtype == v.numpy().dtype and host[k].flags.writeable
        np.testing.assert_array_equal(host[k], v.numpy())


# ---------------------------------------------------------------------------
# The JAX suite's physics and bookkeeping tests, run against the port
# (tests/simulation/test_integrators.py), with their bounds
# ---------------------------------------------------------------------------

def test_nve_conserves_energy():
    sim = NVESimulation(dt=1e-3, n_timesteps=200, save_interval=10,
                        save_energies=True, random_seed=1, device="cpu")
    sim.attach_model_and_configurations(harmonic_ff(5), chain_configs(4, 5),
                                        beta=1.0)
    sim.simulate()
    assert sim.simulated_potential.shape == (20, 4)
    assert np.all(np.isfinite(sim.simulated_potential))


def test_nve_total_energy_drift_small():
    sim = NVESimulation(dt=5e-4, n_timesteps=400, save_interval=10,
                        save_energies=True, random_seed=3, device="cpu")
    sim.attach_model_and_configurations(harmonic_ff(6), chain_configs(2, 6),
                                        beta=2.0)
    sim.simulate()
    total = sim.simulated_potential + sim.simulated_kinetic_energies
    drift = np.abs(total - total[0]).max()
    assert drift < 5e-3 * np.abs(total[0]).max() + 5e-3


def test_langevin_equipartition():
    """Thermostat statistics: <KE> per DOF ~ 1/(2 beta)."""
    beta, n_atoms, n_sims = 2.0, 8, 16
    sim = LangevinSimulation(friction=5.0, dt=0.02, n_timesteps=3000,
                             save_interval=50, save_energies=True,
                             random_seed=7, device="cpu")
    sim.attach_model_and_configurations(
        harmonic_ff(n_atoms), chain_configs(n_sims, n_atoms), beta=beta)
    sim.simulate()
    ke = sim.simulated_kinetic_energies
    ke_mean = ke[ke.shape[0] // 2:].mean()
    expected = 3 * n_atoms / (2 * beta)
    assert abs(ke_mean - expected) / expected < 0.1


def test_overdamped_runs_and_moves():
    sim = OverdampedSimulation(friction=1.0, dt=1e-4, n_timesteps=100,
                               save_interval=10, random_seed=5, device="cpu")
    with pytest.warns(UserWarning, match="Masses were provided"):
        sim.attach_model_and_configurations(harmonic_ff(4),
                                            chain_configs(3, 4), beta=1.0)
    sim.simulate()
    coords = sim.simulated_coords
    assert coords.shape == (10, 3, 4, 3)
    assert not np.allclose(coords[0], coords[-1])
    assert sim.simulated_kinetic_energies is None


def test_divergence_guard_raises():
    sim = NVESimulation(dt=10.0, n_timesteps=100, save_interval=10,
                        random_seed=2, device="cpu")
    sim.attach_model_and_configurations(harmonic_ff(5, k=50.0),
                                        chain_configs(2, 5), beta=1.0)
    with pytest.raises(RuntimeError, match="blew up"):
        sim.simulate()


def test_divergence_guard_names_the_reference_timestep():
    """With the same start velocities the port's message names the save
    point the reference names (its per-launch check, base.py:1150-1161)."""
    from flashmd_tpu.data.system import Configuration as JConfiguration

    cfgs = with_velocities(chain_configs(2, 5))
    jff = jax_harmonic_ff(5, k=50.0)
    jcfgs = [JConfiguration(pos=c.pos, atom_types=c.atom_types,
                            masses=c.masses, velocities=c.velocities)
             for c in cfgs]
    kw = dict(dt=0.11, n_timesteps=200, save_interval=10, random_seed=2)
    jsim = JNVESimulation(gptq=None, **kw)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.0)
    with pytest.raises(RuntimeError, match="blew up") as jerr:
        jsim.simulate()
    sim = NVESimulation(device="cpu", **kw)
    sim.attach_model_and_configurations(harmonic_ff(5, k=50.0), cfgs,
                                        beta=1.0)
    with pytest.raises(RuntimeError, match="blew up") as err:
        sim.simulate()
    # a save point past the first: the run grows for several frames
    assert str(err.value) == str(jerr.value) == (
        "Simulation of trajectory blew up at #timestep=80")


def test_save_interval_validation():
    with pytest.raises(ValueError):
        LangevinSimulation(n_timesteps=100, save_interval=33, device="cpu")
    with pytest.raises(ValueError):
        NVESimulation(n_timesteps=100, save_interval=33, device="cpu")


def test_simulate_is_bitwise_repeatable():
    def run(cls, **kw):
        sim = cls(dt=1e-3, n_timesteps=50, save_interval=10, random_seed=42,
                  device="cpu", **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            sim.attach_model_and_configurations(harmonic_ff(4),
                                                chain_configs(2, 4), beta=1.0)
        sim.simulate()
        return sim.simulated_coords

    for cls, kw in ((LangevinSimulation, {"friction": 1.0}),
                    (OverdampedSimulation, {"friction": 1.0}),
                    (NVESimulation, {})):
        np.testing.assert_array_equal(run(cls, **kw), run(cls, **kw))


# ---------------------------------------------------------------------------
# The pair-floor guard (tests/simulation/test_pair_floor.py)
# ---------------------------------------------------------------------------

def _floor_sim(cheb_d_min, beta=2.0, dt=1e-4):
    ff, configs = cgschnet_1enh_like(
        n_atoms=16, batch_size=2, num_interactions=1, precision="fp32",
        neighbor_capacity=15, cutoff_upper=6.0, message_passing="cheb",
        cheb_order=32, cheb_d_min=cheb_d_min, device="cpu",
    )
    sim = LangevinSimulation(dt=dt, friction=1.0, n_timesteps=20,
                             save_interval=10, random_seed=3, device="cpu",
                             gptq=None)
    sim.attach_model_and_configurations(ff, configs, beta=beta)
    return sim


def test_floor_violation_warns():
    """A fit floor above the chain's pair distances (about 3.8 A bonds)
    fires the guard."""
    sim = _floor_sim(cheb_d_min=5.0)
    with pytest.warns(RuntimeWarning, match="fit-domain floor"):
        sim.simulate()


def test_sound_floor_is_silent_and_sampled():
    sim = _floor_sim(cheb_d_min=1.0)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        sim.simulate()
    assert np.all(np.isfinite(sim.simulated_coords))
    d = sim.simulated_frames["pair_d_min"]
    assert d.shape == (2,) and np.all(d > 1.0)


def test_full_domain_has_no_pair_floor_output():
    sim = _floor_sim(cheb_d_min=0.0)
    with torch.no_grad():
        out = sim._frame_outputs(sim._init_carry(sim.initial_system))
    assert "pair_d_min" not in out
