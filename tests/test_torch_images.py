"""Port parity for periodic neighbour lists and image replication: the
minimum-image and image-replicated builds of ops/neighborlist.py against
the JAX package's (idx and mask exactly, shifts to 1e-5), the numpy shift
set and the wrap, the force field's and the engine's switch to images on
the exact xla path, and port versions of tests/models/test_pbc_images.py's
invariants. Also the port's fixes of the reference's faults 1 and 2
(ROADMAP queue C): a bound shift set is checked against the search radius
it must cover, and image shifts on a path other than xla raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.ops import neighborlist as jnl
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import (
    ForceField,
    compute_energy_forces,
    with_image_replication,
)
from flashmd_tpu_torch.models.schnet import SchNetConfig, init_schnet
from flashmd_tpu_torch.ops import neighborlist as nl
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

RCUT = 4.0
S = 2
L = 9.0
TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.0, 9.0, 0.0], [0.5, 0.5, 9.0]],
                     np.float32)
SMALL = 5.0  # < 2 RCUT: the minimum image is unsound
SMALL_TRICLINIC = np.array([[5.0, 0.0, 0.0], [1.0, 5.5, 0.0],
                            [0.5, 0.5, 6.0]], np.float32)


def _assert_same_list(port, ref):
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.n_max.numpy(), np.asarray(ref.n_max))
    np.testing.assert_allclose(port.shifts.numpy(), np.asarray(ref.shifts),
                               rtol=0, atol=1e-5)
    assert not port.shifts[~port.mask].any()


def _pos(a, box, seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5 * box, 1.5 * box, (s, a, 3)).astype(np.float32)


@pytest.mark.parametrize("cell", ["cubic", "triclinic", "per_molecule"])
def test_shift_set_and_wrap_match_jax(cell):
    cells = {"cubic": SMALL * np.eye(3), "triclinic": SMALL_TRICLINIC,
             "per_molecule": np.stack([SMALL * np.eye(3), SMALL_TRICLINIC])}
    c = cells[cell]
    for rc in (RCUT, 2.5 * SMALL):
        np.testing.assert_array_equal(nl.compute_image_shifts(c, rc),
                                      jnl.compute_image_shifts(c, rc))
    pos = _pos(12, SMALL)
    cs = np.broadcast_to(c, (S, 3, 3)).astype(np.float32)
    ref = np.stack([np.asarray(jnl.wrap_positions(jnp.asarray(p),
                                                  jnp.asarray(one)))
                    for p, one in zip(pos, cs)])
    out = nl.wrap_positions(torch.tensor(pos),
                            torch.tensor(c, dtype=torch.float32))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("capacity", [24, 6])
@pytest.mark.parametrize("cell", ["cubic", "triclinic", "per_molecule"])
def test_min_image_lists_match_jax(cell, capacity):
    """The minimum-image build at a capacity holding every neighbour and
    at an overflowed one, with excluded pairs."""
    cells = {"cubic": L * np.eye(3, dtype=np.float32),
             "triclinic": TRICLINIC,
             "per_molecule": np.stack([L * np.eye(3, dtype=np.float32),
                                       TRICLINIC])}
    c = cells[cell]
    pos = _pos(30, L, seed=1)
    excl = np.random.default_rng(2).integers(0, 30, (2, 20))
    for ep in (None, excl):
        ref = jnl.batched_radius_neighbor_matrix(
            jnp.asarray(pos), RCUT, capacity, cell=jnp.asarray(c),
            exclude_pairs=None if ep is None else jnp.asarray(ep))
        port = nl.batched_radius_neighbor_matrix(
            torch.tensor(pos), RCUT, capacity, cell=torch.tensor(c),
            exclude_pairs=None if ep is None else torch.tensor(ep))
        _assert_same_list(port, ref)
        assert (int(port.n_max.max()) > capacity) == (capacity == 6)
    assert port.shifts.abs().max() > 0  # pairs wrap
    # the single-molecule build
    one = c if c.ndim == 2 else c[0]
    ref = jnl.radius_neighbor_matrix(jnp.asarray(pos[0]), RCUT, capacity,
                                     cell=jnp.asarray(one))
    port = nl.radius_neighbor_matrix(torch.tensor(pos[0]), RCUT, capacity,
                                     cell=torch.tensor(one))
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(port.shifts.numpy(), np.asarray(ref.shifts),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["cubic", "per_molecule", "exclusions",
                                  "lattice", "overflow"])
def test_image_lists_match_jax(case):
    """The image-replication build over M A columns. "lattice" puts atoms
    on a grid whose coordinates and images are exact in float32, so many
    distances tie exactly: the order must keep the lower column first on
    both sides (lax.top_k's rule)."""
    c = (np.stack([SMALL * np.eye(3), SMALL_TRICLINIC])
         if case == "per_molecule" else SMALL * np.eye(3)).astype(np.float32)
    pos = _pos(10, SMALL, seed=3)
    if case == "lattice":
        g = np.arange(2, dtype=np.float32) * 2.5
        pos = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
            1, 8, 3).repeat(S, 0)
    excl = (np.random.default_rng(4).integers(0, 10, (2, 8))
            if case == "exclusions" else None)
    capacity = 16 if case == "overflow" else 96
    images = nl.compute_image_shifts(c, RCUT)
    ref = jnl.batched_radius_neighbor_matrix(
        jnp.asarray(pos), RCUT, capacity, cell=jnp.asarray(c),
        exclude_pairs=None if excl is None else jnp.asarray(excl),
        images=images)
    port = nl.batched_radius_neighbor_matrix(
        torch.tensor(pos), RCUT, capacity, cell=torch.tensor(c),
        exclude_pairs=None if excl is None else torch.tensor(excl),
        images=images)
    _assert_same_list(port, ref)
    assert (int(port.n_max.max()) > capacity) == (case == "overflow")
    # the CSR keeps every slot of a source repeated within a row
    assert int(port.csr_offsets[-1]) == int(port.mask.sum())


# --------------------------------------------------------------------------
# tests/models/test_pbc_images.py's invariants, in the port
# --------------------------------------------------------------------------

A_SMALL = 6


def _schnet_ff(capacity=64):
    cfg = SchNetConfig(
        hidden_channels=16, embedding_size=4, num_filters=16,
        num_interactions=2, num_rbf=8, cutoff=CosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), message_passing="xla",
        precision="fp32",
    )
    params = init_schnet(cfg, torch.Generator().manual_seed(3), "cpu")
    return ForceField(schnet_params=params, priors={}, schnet_config=cfg,
                      neighbor_capacity=capacity)


def _small_system(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, SMALL, (A_SMALL, 3))
    types = rng.integers(0, 4, A_SMALL)
    return pos, types, np.eye(3) * SMALL


def _forces(ff, pos, types, cell):
    return compute_energy_forces(
        ff, torch.tensor(pos, dtype=torch.float32)[None],
        torch.tensor(types), cell=torch.tensor(cell, dtype=torch.float32))


def test_image_shift_set_properties():
    shifts = nl.compute_image_shifts(np.eye(3) * SMALL, RCUT)
    assert shifts.shape == (27, 3) and np.all(shifts[0] == 0)
    assert len({tuple(s) for s in shifts.tolist()}) == 27
    # the radius the set covers: one image along each axis reaches 5
    assert nl.image_shift_radius(shifts, np.eye(3) * SMALL) == pytest.approx(
        SMALL)
    assert nl.image_shift_radius(shifts, np.eye(3) * 3.0) == pytest.approx(
        3.0)


def test_images_reduce_to_min_image_in_valid_regime():
    """In a box where the minimum image is sound the replication build
    gives the same neighbour distances per atom and the same model
    energies and forces."""
    rng = np.random.default_rng(4)
    box = 12.0
    pos = torch.tensor(rng.uniform(0, box, (1, 20, 3)), dtype=torch.float32)
    cell = torch.eye(3) * box
    nl.validate_min_image(cell, RCUT)
    nbr_mi = nl.batched_radius_neighbor_matrix(pos, RCUT, 16, cell=cell)
    shifts = nl.compute_image_shifts(np.eye(3) * box, RCUT)
    nbr_im = nl.batched_radius_neighbor_matrix(pos, RCUT, 16, cell=cell,
                                               images=shifts)
    assert torch.equal(nbr_mi.n_max, nbr_im.n_max)

    def dists(nbr):
        rel = pos[0][nbr.idx[0].long()] + nbr.shifts[0] - pos[0][:, None]
        d = torch.linalg.vector_norm(rel, dim=-1)
        return np.sort(np.where(nbr.mask[0].numpy(), d.numpy(), 1e9))

    np.testing.assert_allclose(dists(nbr_mi), dists(nbr_im), rtol=1e-6,
                               atol=1e-6)
    ff = _schnet_ff(capacity=32)
    types = torch.tensor(rng.integers(0, 4, 20))
    e_mi, f_mi, _ = compute_energy_forces(ff, pos, types, cell=cell)
    e_im, f_im, _ = compute_energy_forces(
        with_image_replication(ff, cell), pos, types, cell=cell)
    torch.testing.assert_close(e_im, e_mi, rtol=1e-6, atol=1e-5)
    torch.testing.assert_close(f_im, f_mi, rtol=1e-5, atol=1e-5)


def test_supercell_invariance():
    """E(2x2x2 supercell, minimum image) == 8 E(small cell, image
    replication); forces equal on every copy (test_pbc_images.py:120)."""
    pos, types, cell = _small_system()
    reps = [(i, j, k) for i in range(2) for j in range(2) for k in range(2)]
    pos_super = np.concatenate([pos + np.asarray(r, float) * SMALL
                                for r in reps])
    cell_super = np.eye(3) * (2 * SMALL)
    nl.validate_min_image(cell_super, RCUT)
    ff = _schnet_ff(capacity=64)
    e_small, f_small, _ = _forces(with_image_replication(ff, cell), pos,
                                  types, cell)
    e_super, f_super, _ = _forces(ff, pos_super,
                                  np.concatenate([types] * 8), cell_super)
    np.testing.assert_allclose(float(e_super[0]), 8 * float(e_small[0]),
                               rtol=5e-5)
    f_super = f_super[0].numpy().reshape(8, A_SMALL, 3)
    for r in range(8):
        np.testing.assert_allclose(f_super[r], f_small[0].numpy(),
                                   rtol=5e-4, atol=1e-5)


def test_self_image_pairs_counted():
    """A single atom in a 3 A box interacts with its six face images
    (the edge images sit at 4.24 > rcut)."""
    pos = torch.zeros(1, 1, 3)
    shifts = nl.compute_image_shifts(np.eye(3) * 3.0, RCUT)
    nbr = nl.batched_radius_neighbor_matrix(pos, RCUT, 32,
                                            cell=torch.eye(3) * 3.0,
                                            images=shifts)
    assert int(nbr.n_max[0]) == 6
    assert torch.all(nbr.idx[nbr.mask] == 0)
    ff = _schnet_ff(capacity=32)
    types = torch.zeros(1, dtype=torch.long)
    e_img = compute_energy_forces(with_image_replication(ff, np.eye(3) * 3.0),
                                  pos, types, cell=torch.eye(3) * 3.0)[0]
    e_alone = compute_energy_forces(ff, pos, types)[0]
    assert float((e_img - e_alone).abs()) > 1e-4


def _run_config(seed=7):
    pos, types, cell = _small_system(seed)
    return [Configuration(pos=pos, atom_types=types,
                          masses=np.ones(A_SMALL), cell=cell)]


def test_attach_auto_switches_to_images():
    """Engine attach: a sub-minimum-image cell on the xla path switches to
    replication with the skin (and runs); the cheb path still refuses."""
    sim = LangevinSimulation(
        dt=1e-3, friction=1.0, n_timesteps=20, save_interval=10,
        random_seed=5, neighbor_skin=0.5, neighbor_rebuild_interval=5,
        device="cpu", gptq=None,
    )
    sim.attach_model_and_configurations(_schnet_ff(), _run_config(),
                                        beta=1.0)
    assert sim.model.pbc_images is not None
    assert nl.image_shift_radius(sim.model.pbc_images,
                                 np.eye(3) * SMALL) > RCUT + 0.5
    coords = sim.simulate()
    assert coords.shape == (1, 2, A_SMALL, 3) and np.isfinite(coords).all()
    ff_cheb = _schnet_ff()
    ff_cheb = ff_cheb.replace(schnet_config=dataclasses.replace(
        ff_cheb.schnet_config, message_passing="cheb"))
    sim2 = LangevinSimulation(dt=1e-3, friction=1.0, n_timesteps=20,
                              save_interval=10, random_seed=5, device="cpu",
                              gptq=None)
    with pytest.raises(ValueError, match="[Mm]inimum-image"):
        sim2.attach_model_and_configurations(ff_cheb, _run_config(),
                                             beta=1.0)


def test_direct_api_small_cell_still_refused_without_images():
    pos, types, cell = _small_system()
    with pytest.raises(ValueError, match="[Mm]inimum-image"):
        _forces(_schnet_ff(), pos, types, cell)


def test_with_image_replication_refuses_cheb():
    ff = _schnet_ff()
    ff = ff.replace(schnet_config=dataclasses.replace(
        ff.schnet_config, message_passing="cheb"))
    with pytest.raises(NotImplementedError, match="xla"):
        with_image_replication(ff, np.eye(3) * SMALL)


def test_bound_images_must_cover_the_search_radius():
    """Port fix of the reference's fault 1 (ROADMAP queue C;
    flashmd_tpu/simulation/base.py:413 returns early whenever pbc_images
    is set, and with_image_replication defaults to skin 0): shifts bound
    at rcut cover 5 A in this cell, so an engine with skin 1.0 (search
    radius 5.0) raises instead of running on a list that misses images;
    at skin 0.5 it attaches. compute_energy_forces holds a bound set to
    rcut in the cell it is given."""
    ff = with_image_replication(_schnet_ff(), np.eye(3) * SMALL, skin=0.0)
    sim = LangevinSimulation(dt=1e-3, friction=1.0, n_timesteps=2,
                             save_interval=1, neighbor_skin=1.0,
                             device="cpu", gptq=None)
    with pytest.raises(ValueError, match="Image replication is unsound"):
        sim.attach_model_and_configurations(ff, _run_config(), beta=1.0)
    sim = LangevinSimulation(dt=1e-3, friction=1.0, n_timesteps=2,
                             save_interval=1, neighbor_skin=0.5,
                             device="cpu", gptq=None)
    sim.attach_model_and_configurations(ff, _run_config(), beta=1.0)
    assert sim.model.pbc_images == ff.pbc_images
    pos, types, _ = _small_system()
    with pytest.raises(ValueError, match="Image replication is unsound"):
        _forces(ff, pos % 3.0, types, np.eye(3) * 3.0)


# --------------------------------------------------------------------------
# the engine against the reference's
# --------------------------------------------------------------------------


def _config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("box", [12.0, 7.0])
def test_baoab_steps_under_cells_match_jax(box):
    """Three BAOAB steps of an xla field with the Verlet list rebuilt under
    the cell each step, with the reference's own noise: in a 12 A box
    (minimum image at rcut + skin = 5) and a 7 A box, where both engines
    switch to image replication at attach."""
    jff, jcfgs = jcgschnet(n_atoms=24, batch_size=S, num_interactions=2,
                           precision="fp32", message_passing="xla",
                           cutoff_upper=RCUT, neighbor_capacity=64)
    rng = np.random.default_rng(4)
    jcfgs = [dataclasses.replace(c, pos=c.pos * 0.4, cell=np.eye(3) * box,
                                 velocities=rng.normal(scale=0.5,
                                                       size=c.pos.shape))
             for c in jcfgs]
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=3, save_interval=3,
                  random_seed=3, neighbor_skin=1.0)
    jsim = JLangevinSimulation(gptq=None, **kwargs)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity,
    )
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities,
                          neighbor_lists=c.neighbor_lists, cell=c.cell)
            for c in jcfgs]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert sim.model.pbc_images == jsim.model.pbc_images
    assert (sim.model.pbc_images is None) == (box == 12.0)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jrebuild = jax.jit(jsim._rebuild_neighbors)
    jstep = jax.jit(jsim._baoab)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for t in range(3):
            jcarry = jrebuild(jcarry)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._step_with_hooks(carry, torch.tensor(np.asarray(xi)),
                                         t)
    np.testing.assert_array_equal(carry["nbr"].idx.numpy(),
                                  np.asarray(jcarry["nbr_idx"]))

    def rel(out, ref):
        ref = np.asarray(ref)
        return np.abs(out.numpy() - ref).max() / np.abs(ref).max()

    assert rel(carry["forces"], jcarry["forces"]) <= 1e-5
    assert rel(carry["pos"], jcarry["pos"]) <= 1e-5
    assert int(carry["nbr_n_max"]) == int(jcarry["nbr_n_max"])
