"""Port parity of the host-side pieces around a molecule: pair exclusions
on configurations (checks, batch consistency, collation, the engine's
binding check) and the fields of carried priors (V0, term_mask), against
the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.data.system import (
    validate_configurations as jvalidate_configurations,
)
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.prior.priors import Prior as JPrior
from flashmd_tpu.prior.priors import prior_energy as jprior_energy
from flashmd_tpu_torch.data.system import (
    Configuration,
    collate,
    validate_configurations,
)
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.prior.priors import prior_energy
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = 24


def _mol(exc=None, classes=(Configuration, JConfiguration)):
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(A, 3)) * 5.0
    types = np.arange(A) % 4
    return [cls(pos=pos, atom_types=types, exc_pair_index=exc)
            for cls in classes]


@pytest.mark.parametrize(
    "exc",
    [
        np.array([[0, 1, 2], [5, 6, 7]]),   # [2, P]
        np.array([[0, 5], [1, 6], [2, 7]]),  # [P, 2], transposed on entry
        np.zeros((2, 0), np.int64),          # no pairs
    ],
    ids=["2xP", "Px2", "empty"],
)
def test_configuration_takes_exclusions_as_jax(exc):
    port, ref = _mol(exc)
    assert port.exc_pair_index.dtype == np.int64
    assert port.exc_pair_index.shape[0] == 2
    np.testing.assert_array_equal(port.exc_pair_index, ref.exc_pair_index)


@pytest.mark.parametrize(
    "exc,match",
    [
        (np.array([[0, A], [1, 2]]), "outside"),
        (np.array([[-1, 0], [1, 2]]), "outside"),
        (np.array([[0, 1, 2]]), r"\[2, P\]"),
        (np.zeros((3, 3), np.int64), r"\[2, P\]"),
    ],
    ids=["past-end", "negative", "1xP", "3x3"],
)
def test_configuration_refuses_bad_exclusions_as_jax(exc, match):
    for cls in (Configuration, JConfiguration):
        with pytest.raises(ValueError, match=match):
            _mol(exc, classes=(cls,))


def test_validate_configurations_raises_on_mismatched_exclusions():
    exc = np.array([[0, 1], [5, 6]])
    for cls, validate in ((Configuration, validate_configurations),
                          (JConfiguration, jvalidate_configurations)):
        a, = _mol(exc, classes=(cls,))
        b, = _mol(exc + 1, classes=(cls,))
        c, = _mol(None, classes=(cls,))
        validate([a, dataclasses.replace(a)])
        for other in (b, c):
            with pytest.raises(ValueError, match="exc_pair_index"):
                validate([a, other])


def _cheb_pair_with_exclusions():
    ff, cfgs = cgschnet_1enh_like(n_atoms=A, batch_size=2,
                                  num_interactions=1, message_passing="cheb",
                                  device="cpu")
    exc = np.array([[0, 3], [10, 14]])
    return ff, [dataclasses.replace(c, exc_pair_index=exc) for c in cfgs], exc


def test_collate_accepts_exclusions():
    _, cfgs, _ = _cheb_pair_with_exclusions()
    system = collate(cfgs, device="cpu")
    assert system.pos.shape == (2, A, 3)


def test_attach_requires_the_model_to_bind_exclusions():
    """As the reference's _check_exclusion_binding: an unbound model
    raises; one that carries the exclusions attaches (the pallas path
    honours them)."""
    ff, cfgs, exc = _cheb_pair_with_exclusions()
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=2,
                             save_interval=1, device="cpu")
    with pytest.raises(ValueError, match="exc_pair_index"):
        sim.attach_model_and_configurations(ff, cfgs, beta=1.0)
    pallas = ff.replace(
        schnet_config=dataclasses.replace(ff.schnet_config,
                                          message_passing="pallas"),
        exc_pair_index=torch.as_tensor(exc),
    )
    sim.attach_model_and_configurations(pallas, cfgs, beta=1.0)
    assert sim.initial_system.n_sims == 2


def _carry(priors):
    """The port's force field of a small JAX zoo model's network with
    ``priors`` (name -> JAX Prior or dict) in place of its own."""
    jff, _ = jcgschnet(n_atoms=A, batch_size=1, num_interactions=1,
                       message_passing="cheb")
    return forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        {k: p if isinstance(p, dict) else jax.tree.map(np.asarray, p)
         for k, p in priors.items()},
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    ), jff


def test_harmonic_prior_v0_matches_jax():
    """A carried V0 enters the energy as in the reference."""
    rng = np.random.default_rng(1)
    pos = rng.normal(size=(2, 6, 3)).astype(np.float32) * 2.0
    idx = np.array([[0, 1, 2, 3, 4], [1, 2, 3, 4, 5]], np.int32)
    params = {"x0": rng.uniform(1, 2, 5).astype(np.float32),
              "k": rng.uniform(1, 3, 5).astype(np.float32),
              "V0": rng.normal(size=5).astype(np.float32)}
    jprior = JPrior(index_mapping=jnp.asarray(idx),
                    params={k: jnp.asarray(v) for k, v in params.items()},
                    kind="harmonic_bonds", name="bonds", feature="distance")
    ref = np.array([float(jprior_energy(jprior, jnp.asarray(p)))
                    for p in pos])
    ff, _ = _carry({"bonds": jprior})
    out = prior_energy(ff.priors["bonds"], torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-5)
    without = jprior.replace(params={**jprior.params,
                                     "V0": jnp.zeros(5, jnp.float32)})
    ff0, _ = _carry({"bonds": without})
    e0 = prior_energy(ff0.priors["bonds"], torch.from_numpy(pos)).numpy()
    # float32 energies of a few tens: the difference keeps ~1e-5 absolute
    np.testing.assert_allclose(out - e0, params["V0"].sum(), rtol=0,
                               atol=1e-4)


def test_prior_with_term_mask_raises():
    """A padded prior (term_mask) carries, as an object or a dict, and
    counts only its real terms, as in JAX; a stacked (per-molecule)
    prior carries into a field with ``batched_priors`` and matches JAX's
    energies per molecule; that field raises on [A] types, as in JAX."""
    from flashmd_tpu.prior.priors import pad_prior as jpad_prior
    from flashmd_tpu.prior.priors import stack_priors as jstack_priors
    from flashmd_tpu_torch.models.forcefield import compute_energy_forces

    _, jff = _carry({})
    bonds = jff.priors["bonds"]
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(2, A, 3)).astype(np.float32) * 3.0
    mask = jnp.asarray(rng.integers(0, 2, bonds.n_terms), jnp.float32)
    masked = bonds.replace(term_mask=mask)
    as_dict = {"index_mapping": bonds.index_mapping, "params": bonds.params,
               "kind": bonds.kind, "name": bonds.name,
               "feature": bonds.feature, "term_mask": mask}
    ref = np.array([float(jprior_energy(masked, jnp.asarray(p)))
                    for p in pos])
    for prior in (masked, as_dict):
        ff, _ = _carry({"bonds": prior})
        out = prior_energy(ff.priors["bonds"], torch.from_numpy(pos))
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    # one molecule's bonds and a shorter copy, stacked (padded, masked)
    short = bonds.replace(index_mapping=bonds.index_mapping[:, :7],
                          params={k: v[:7] for k, v in bonds.params.items()})
    stacked = jstack_priors([bonds, short])
    np.testing.assert_array_equal(np.asarray(stacked.term_mask[1]),
                                  np.asarray(jpad_prior(
                                      short, bonds.n_terms).term_mask))
    ref = np.asarray(jax.vmap(jprior_energy)(stacked, jnp.asarray(pos)))
    carried = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        {"bonds": jax.tree.map(np.asarray, stacked)},
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    )
    assert carried.batched_priors
    out = prior_energy(carried.priors["bonds"], torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match="per-sim"):
        compute_energy_forces(carried, torch.from_numpy(pos),
                              torch.zeros(A, dtype=torch.int64))
