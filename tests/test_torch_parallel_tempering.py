"""Port parity of parallel tempering: steps with exchanges against the JAX
package with the reference's normal and uniform draws injected, the
on-device exchange against JAX's on the same carry and uniforms (bitwise
permutation, counters and int32 matrix), the complete neighbour-state
permutation with the source CSR built again (xla under a cell, pallas
open), and the JAX suite's bookkeeping tests
(tests/simulation/test_parallel_tempering.py) run against the port."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.simulation import PTSimulation as JPTSimulation
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import ForceField
from flashmd_tpu_torch.models.schnet import SchNetConfig, init_schnet
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops.neighborlist import source_csr
from flashmd_tpu_torch.simulation import PTSimulation

from .test_torch_integrators import (
    assert_state_close,
    chain_configs,
    harmonic_ff,
    jax_cheb_field,
    jax_harmonic_ff,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

BETAS = [1.67, 1.42, 1.16]


def make_pt(**over):
    kwargs = dict(friction=1.0, dt=5e-3, n_timesteps=200, save_interval=10,
                  exchange_interval=20, save_energies=True, random_seed=11,
                  device="cpu")
    kwargs.update(over)
    return PTSimulation(**kwargs)


# ---------------------------------------------------------------------------
# Against JAX
# ---------------------------------------------------------------------------

def test_pt_steps_match_jax_with_injected_draws():
    """20 steps, an exchange after every 5th: BAOAB with JAX's normal
    draws and the exchange with its uniform draws (langevin.py:97,
    parallel_tempering.py:207-216), in the order the reference splits its
    key."""
    jff, jcfgs, ff, cfgs = jax_cheb_field()
    kw = dict(friction=1.0, dt=0.004, n_timesteps=20, save_interval=20,
              exchange_interval=5, random_seed=3)
    jsim = JPTSimulation(gptq=None, **kw)
    jsim.attach_model_and_configurations(jff, jcfgs, BETAS)
    sim = PTSimulation(device="cpu", gptq=None, **kw)
    sim.attach_model_and_configurations(ff, cfgs, BETAS)
    np.testing.assert_array_equal(sim.initial_system.beta.numpy(),
                                  np.asarray(jsim.initial_system.beta))
    n_pairs = sim._subroutine_draw_shape()
    assert n_pairs == (jsim._pairs_a.shape[1],)

    key = jax.random.PRNGKey(3)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system, key)
    jstep = jax.jit(jsim._step_with_hooks)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for t in range(20):
            key, sub = jax.random.split(key)
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            u = None
            if sim._subroutine_due(t):
                key, sub = jax.random.split(key)
                u = torch.tensor(np.asarray(
                    jax.random.uniform(sub, n_pairs, jnp.float32)))
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(
                carry, torch.tensor(np.asarray(xi)), t, u)
    np.testing.assert_array_equal(np.asarray(jcarry["key"]), key)
    assert_state_close(carry, jcarry)
    for name in ("acceptance_matrix", "n_exchange_approved",
                 "n_exchange_attempted", "exchange_parity"):
        np.testing.assert_array_equal(carry[name].numpy(),
                                      np.asarray(jcarry[name]), err_msg=name)
    assert int(carry["n_exchange_attempted"]) == 4 * 2
    assert int(carry["n_exchange_approved"]) > 0


@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("n_replicas", [2, 3, 4])
def test_device_subroutine_matches_jax(n_replicas, parity):
    """One exchange on the same carry and uniforms: the permutation (read
    off a slot-id entry that both permute by the batch rule), positions,
    forces, counters and the int32 matrix bitwise, the rescaled
    velocities to 1e-6. Four replicas pad the odd group with (0, 0)."""
    n_ind, n_atoms = 3, 4
    betas = list(np.linspace(2.0, 1.0, n_replicas))
    cfgs = chain_configs(n_ind, n_atoms)
    jcfgs = [JConfiguration(pos=c.pos, atom_types=c.atom_types,
                            masses=c.masses) for c in cfgs]
    jsim = JPTSimulation(gptq=None, friction=1.0, dt=5e-3, n_timesteps=20,
                         save_interval=10, exchange_interval=10)
    jsim.attach_model_and_configurations(jax_harmonic_ff(n_atoms), jcfgs,
                                         betas)
    sim = make_pt(n_timesteps=20, exchange_interval=10)
    sim.attach_model_and_configurations(harmonic_ff(n_atoms), cfgs, betas)
    n_sims = n_ind * n_replicas
    rng = np.random.default_rng(10 * n_replicas + parity)
    state = {
        "pos": rng.normal(size=(n_sims, n_atoms, 3)),
        "vel": rng.normal(size=(n_sims, n_atoms, 3)),
        "forces": rng.normal(size=(n_sims, n_atoms, 3)),
        "potential": rng.normal(scale=4.0, size=n_sims),
        "slot_id": np.arange(n_sims),
    }
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    jcarry = jsim._init_carry(jsim.initial_system, key)
    jcarry.update({k: jnp.asarray(v, jnp.float32) for k, v in state.items()})
    jcarry["exchange_parity"] = jnp.asarray(parity, jnp.int32)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
    carry.update({k: torch.tensor(v, dtype=torch.float32)
                  for k, v in state.items()})
    carry["exchange_parity"] = torch.tensor(parity, dtype=torch.int32)

    _, sub = jax.random.split(key)
    u = jax.random.uniform(sub, sim._subroutine_draw_shape(), jnp.float32)
    jnew = jsim._device_subroutine(jcarry)
    new = sim._device_subroutine(carry, torch.tensor(np.asarray(u)))

    perm = new["slot_id"].numpy()
    np.testing.assert_array_equal(perm, np.asarray(jnew["slot_id"]))
    assert sorted(perm) == list(range(n_sims))
    for name in ("pos", "forces", "potential", "acceptance_matrix",
                 "n_exchange_approved", "n_exchange_attempted",
                 "exchange_parity"):
        np.testing.assert_array_equal(new[name].numpy(),
                                      np.asarray(jnew[name]), err_msg=name)
    assert new["acceptance_matrix"].dtype == torch.int32
    np.testing.assert_allclose(new["vel"].numpy(), np.asarray(jnew["vel"]),
                               rtol=1e-6)
    # the attempts of this parity's group, counted once in the matrix
    acc = new["acceptance_matrix"].numpy()
    assert acc.sum() == int(new["n_exchange_attempted"]) \
        == int(sim._pairs_valid[parity].sum())


# ---------------------------------------------------------------------------
# The complete neighbour state (tests/simulation/test_parallel_tempering.py
# :173-226), on xla under a cell and on pallas (open)
# ---------------------------------------------------------------------------

L_BOX, RCUT_PBC, A_PBC = 7.0, 2.0, 8


def _xla_cell_case():
    cfg = SchNetConfig(hidden_channels=16, embedding_size=4, num_filters=16,
                       num_interactions=2, num_rbf=8,
                       cutoff=CosineCutoff(0.0, RCUT_PBC),
                       output_hidden_layer_widths=(8,),
                       message_passing="xla")
    params = init_schnet(cfg, torch.Generator().manual_seed(3), "cpu")
    ff = ForceField(schnet_params=params, priors={}, schnet_config=cfg,
                    neighbor_capacity=A_PBC)
    rng = np.random.default_rng(9)
    types = rng.integers(0, 4, size=A_PBC)
    cfgs = [Configuration(pos=rng.uniform(0.0, L_BOX, size=(A_PBC, 3)),
                          atom_types=types, masses=np.ones(A_PBC),
                          cell=np.eye(3) * L_BOX) for _ in range(2)]
    pos = rng.uniform(0.0, L_BOX, size=(4, A_PBC, 3))
    return ff, cfgs, pos


def _pallas_case():
    ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=2,
                                  num_interactions=1, precision="fp32",
                                  message_passing="pallas", device="cpu")
    rng = np.random.default_rng(17)
    pos = np.stack([c.pos for c in cfgs] * 2)
    return ff, cfgs, pos + rng.normal(scale=0.3, size=pos.shape)


@pytest.mark.parametrize("case", ["xla_cell", "pallas"])
def test_exchange_permutes_complete_neighbor_state(case):
    """After a guaranteed exchange every per-slot neighbour entry (idx,
    mask, n_max, shifts, the Verlet reference positions) has followed its
    replica, the source CSR is that of the permuted list (and not the
    stale one), and forces from the permuted carry equal those of a fresh
    build at the permuted positions, bitwise."""
    ff, cfgs, pos = {"xla_cell": _xla_cell_case,
                     "pallas": _pallas_case}[case]()
    sim = make_pt(neighbor_rebuild_interval=5, neighbor_skin=0.5,
                  exchange_interval=10, n_timesteps=20, gptq=None)
    sim.attach_model_and_configurations(ff, cfgs, [2.0, 1.0])
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        # distinct geometry per slot: replicas of one configuration start
        # identical, which would make the swap unobservable
        carry["pos"] = torch.tensor(pos, dtype=torch.float32)
        carry = sim._rebuild_neighbors(carry)
        carry["potential"], carry["forces"], _ = sim._forces(carry,
                                                             carry["pos"])
        # slots 0/1 (beta 2) vs 2/3 (beta 1), paired by configuration:
        # exp((U_a - U_b)(beta_a - beta_b)) >> 1 accepts both swaps
        carry["potential"] = torch.tensor([100.0, 100.0, 0.0, 0.0])
        nbr = carry["nbr"]
        if case == "xla_cell":
            assert not torch.equal(nbr.shifts[0], nbr.shifts[2])
        new = sim._device_subroutine(
            carry, torch.rand(sim._subroutine_draw_shape()))
        perm = [2, 3, 0, 1]
        assert torch.equal(new["pos"], carry["pos"][perm])
        assert torch.equal(new["nbr_ref_pos"], carry["nbr_ref_pos"][perm])
        for leaf in ("idx", "mask", "n_max", "shifts"):
            if getattr(nbr, leaf) is not None:
                assert torch.equal(getattr(new["nbr"], leaf),
                                   getattr(nbr, leaf)[perm]), leaf
        offsets, slots = source_csr(new["nbr"].idx, new["nbr"].mask)
        assert torch.equal(new["nbr"].csr_offsets, offsets)
        assert torch.equal(new["nbr"].csr_slots, slots)
        assert not torch.equal(new["nbr"].csr_slots, nbr.csr_slots)

        fresh = sim._rebuild_neighbors(dict(new))
        for leaf in ("idx", "mask", "shifts", "csr_offsets", "csr_slots"):
            a, b = getattr(new["nbr"], leaf), getattr(fresh["nbr"], leaf)
            assert (a is None and b is None) or torch.equal(a, b), leaf
        _, f_carry, _ = sim._forces(new, new["pos"])
        _, f_fresh, _ = sim._forces(fresh, fresh["pos"])
    assert torch.equal(f_carry, f_fresh)


# ---------------------------------------------------------------------------
# Bookkeeping (tests/simulation/test_parallel_tempering.py), on the port
# ---------------------------------------------------------------------------

def test_replication_layout():
    sim = make_pt()
    sim.attach_model_and_configurations(harmonic_ff(5), chain_configs(4, 5),
                                        BETAS)
    assert (sim.n_sims, sim.n_replicas, sim.n_indep_sims) == (12, 3, 4)
    np.testing.assert_allclose(sim.initial_system.beta.numpy(),
                               np.repeat(BETAS, 4), rtol=1e-7)


def test_betas_must_decrease_and_fields_are_single():
    sim = make_pt()
    with pytest.raises(ValueError, match="increasing temperature"):
        sim.attach_model_and_configurations(
            harmonic_ff(5), chain_configs(2, 5), [1.16, 1.42, 1.67])
    with pytest.raises(ValueError):
        sim.attach_model_and_configurations(harmonic_ff(5),
                                            chain_configs(2, 5), 1.0)
    with pytest.raises(NotImplementedError, match="mixed-size"):
        sim.attach_model_and_configurations(
            [harmonic_ff(5)] * 2, chain_configs(2, 5), BETAS)


def test_get_replica_info():
    sim = make_pt()
    sim.attach_model_and_configurations(harmonic_ff(5), chain_configs(3, 5),
                                        BETAS)
    info = sim.get_replica_info(1)
    np.testing.assert_array_equal(info["indices_in_the_output"], [3, 4, 5])
    assert info["beta"] == BETAS[1]
    with pytest.raises(ValueError):
        sim.get_replica_info(7)


def test_two_replica_exchange():
    sim = make_pt(n_timesteps=100, exchange_interval=10)
    sim.attach_model_and_configurations(harmonic_ff(5), chain_configs(2, 5),
                                        [2.0, 1.0])
    sim.simulate()
    assert int(sim.final_carry["n_exchange_attempted"]) == 10 * 2


def test_exchange_happens_and_is_recorded(tmp_path):
    """200 steps / 20 = 10 exchanges of 4 pairs each (one even group (0,
    1) and one odd (1, 2)); the int32 matrix on the device counts every
    attempt once across the diagonal, and each of the two exports (every
    100 steps) writes its own segment's counts as float32."""
    sim = make_pt(export_interval=100, filename="pt",
                  output_dir=str(tmp_path))
    sim.attach_model_and_configurations(harmonic_ff(6), chain_configs(4, 6),
                                        BETAS)
    sim.simulate()
    attempted = int(sim.final_carry["n_exchange_attempted"])
    approved = int(sim.final_carry["n_exchange_approved"])
    assert attempted == 10 * 4
    assert 0 < approved <= attempted
    total = sim.final_carry["acceptance_matrix"].numpy()
    assert total.dtype == np.int32
    assert total.sum() == attempted and np.triu(total).sum() == approved
    acc = sim.simulated_acceptance  # [exports, R, R], per export
    assert acc.shape == (2, 3, 3) and acc.dtype == np.float32
    assert np.trace(acc, axis1=1, axis2=2).max() == 0
    # the first export holds steps 1-100: 5 exchanges of 4 pairs
    assert acc[0].sum() == 5 * 4
    np.testing.assert_array_equal(acc.sum(axis=0), total)
    for i in range(2):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"pt_acceptance_{i:04d}.npy"), acc[i])
    assert sim.summary() == {"attempted": attempted, "approved": approved}
    assert sim.simulated_kinetic_energies.shape == (20, 12)


def test_pt_bitwise_repeatable():
    def run():
        sim = make_pt(n_timesteps=60, exchange_interval=10)
        sim.attach_model_and_configurations(harmonic_ff(5),
                                            chain_configs(3, 5), BETAS)
        sim.simulate()
        return sim.simulated_coords, sim.simulated_acceptance

    (c1, a1), (c2, a2) = run(), run()
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)
