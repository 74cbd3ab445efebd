"""Port parity of the export loop and the engine's options: the files
(names, shapes, dtypes, and contents on the noise-free fields) against the
JAX package's, the launches and their per-launch guard, pipelined exports
against the synchronous order, checkpoints and resume (the generator's
stream continued bitwise; a JAX-written checkpoint read), parallel
tempering's per-export acceptance, the energy and force components, the
specialized dump, the profiler window, the option checks' messages, the
``gptq`` default and ``dtype="double"``."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.simulation import LangevinSimulation as JLangevinSimulation
from flashmd_tpu.simulation import NVESimulation as JNVESimulation
from flashmd_tpu.simulation import PTSimulation as JPTSimulation
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.checkpoint_io import (
    load_native_configurations,
    load_native_model,
)
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import (
    compute_energy_forces,
    validate_quantized,
)
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.simulation import (
    LangevinSimulation,
    NVESimulation,
    PTSimulation,
)

from .test_torch_integrators import (
    chain_configs,
    harmonic_ff,
    jax_cheb_field,
    jax_harmonic_ff,
    with_velocities,
)
from .test_torch_threads import one_torch_thread  # noqa: F401

BETAS = [1.67, 1.42, 1.16]
# NVE on the harmonic chain: noise-free, so both packages' files agree
EXPORT_KW = dict(dt=1e-3, n_timesteps=60, save_interval=5, export_interval=20,
                 filename="t", save_forces=True, save_energies=True,
                 create_checkpoints=True, random_seed=3, print_shape=True)


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    """JAX at its default 32-bit types in this module, whatever another
    test file of the same process set (some enable x64 at import)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def as_jax(cfgs):
    return [JConfiguration(pos=c.pos, atom_types=c.atom_types,
                           masses=c.masses, velocities=c.velocities,
                           cell=c.cell) for c in cfgs]


def files(directory):
    """Output files by name, without the log and the dump (whose bytes
    hold times or package-specific formats)."""
    return sorted(p.name for p in pathlib.Path(directory).iterdir()
                  if not p.name.endswith(("_log.txt", ".pkl", ".log")))


@pytest.fixture(scope="module")
def harmonic_runs(tmp_path_factory):
    """The same NVE run of the harmonic chain through both packages, with
    every file the export loop writes."""
    root = tmp_path_factory.mktemp("harmonic")
    cfgs = with_velocities(chain_configs(2, 4), seed=1)
    jsim = JNVESimulation(output_dir=str(root / "jax"), **EXPORT_KW)
    jsim.attach_model_and_configurations(jax_harmonic_ff(4), as_jax(cfgs),
                                         beta=1.0)
    jsim.simulate()
    sim = NVESimulation(output_dir=str(root / "port"), device="cpu",
                        **EXPORT_KW)
    sim.attach_model_and_configurations(harmonic_ff(4), cfgs, beta=1.0)
    sim.simulate()
    return root / "port", root / "jax", sim


def test_file_names_match_jax(harmonic_runs):
    port, jax_dir, _ = harmonic_runs
    assert files(port) == files(jax_dir)
    names = files(port)
    for kind in ("coords", "forces", "potential", "kineticenergy",
                 "checkpoint"):
        for i in range(3):
            ext = "npz" if kind == "checkpoint" else "npy"
            assert f"t_{kind}_{i:04d}.{ext}" in names
    assert "t_checkpoint_init.npz" in names
    for name in ("t_log.txt", "t_print_shape.log",
                 "t_specialized_model_and_config.pkl"):
        assert (port / name).exists()


@pytest.mark.parametrize("kind", ["coords", "forces", "potential",
                                  "kineticenergy"])
def test_npy_contents_match_jax(harmonic_runs, kind):
    """(S, frames, ...) layout, dtype and values within 1e-5 relative."""
    port, jax_dir, _ = harmonic_runs
    for i in range(3):
        a = np.load(port / f"t_{kind}_{i:04d}.npy")
        b = np.load(jax_dir / f"t_{kind}_{i:04d}.npy")
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.shape[:2] == (2, 4)
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()


def test_checkpoints_match_jax(harmonic_runs):
    """The reference's keys with their meaning; the generator's state
    under ``rng_state`` where the JAX package keeps ``rng_key``."""
    port, jax_dir, sim = harmonic_runs
    for key in ("init", "0000", "0001", "0002"):
        a = np.load(port / f"t_checkpoint_{key}.npz")
        b = np.load(jax_dir / f"t_checkpoint_{key}.npz")
        assert set(a.files) - {"rng_state"} == set(b.files) - {"rng_key"}
        assert a["rng_state"].dtype == np.uint8
        for k in set(a.files) - {"rng_state"}:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            assert np.abs(a[k] - b[k]).max() <= 1e-5 * max(
                np.abs(b[k]).max(), 1.0), k
    final = np.load(port / "t_checkpoint_0002.npz")
    assert int(final["current_timestep"]) == 3  # an export index
    np.testing.assert_array_equal(final["pos"],
                                  sim.final_carry["pos"].numpy())


def test_shape_log_matches_jax_layout(harmonic_runs):
    """The same sections and frame entries (shapes as found on the first
    launch; the JAX package reads them off its traced program)."""
    port, jax_dir, _ = harmonic_runs

    def sections(path):
        out, cur = {}, None
        for line in path.read_text().splitlines()[2:]:
            if line.startswith("=="):
                cur = out.setdefault(line, [])
            else:
                cur.append(line.strip())
        return out

    a, b = sections(port / "t_print_shape.log"), sections(
        jax_dir / "t_print_shape.log")
    assert list(a) == list(b)
    frames = "== frame outputs (per save point) =="
    assert a[frames] == b[frames]


def test_in_memory_results(harmonic_runs):
    _, jax_dir, sim = harmonic_runs
    coords = np.concatenate([np.load(jax_dir / f"t_coords_{i:04d}.npy")
                             for i in range(3)], axis=1)
    assert sim.coords.shape == coords.shape == (2, 12, 4, 3)
    assert sim.simulated_forces.shape == (12, 2, 4, 3)
    sim2 = NVESimulation(dt=1e-3, n_timesteps=10, save_interval=5,
                         save_forces=True, save_energies=True, device="cpu")
    sim2.attach_model_and_configurations(harmonic_ff(4), chain_configs(2, 4),
                                         beta=1.0)
    sim2.simulate()
    sim2.reshape_output()
    assert sim2.simulated_coords.shape == (2, 2, 4, 3)
    assert sim2.simulated_forces.shape == (2, 2, 4, 3)
    assert sim2.simulated_potential.shape == (2, 2)


# ---------------------------------------------------------------------------
# Launches, pipelining, hooks
# ---------------------------------------------------------------------------

def _langevin(out=None, n_atoms=4, **over):
    kw = dict(friction=1.0, dt=1e-3, save_interval=5, random_seed=11,
              device="cpu")
    if out is not None:
        kw.update(filename="t", output_dir=str(out))
    kw.update(over)
    sim = LangevinSimulation(**kw)
    sim.attach_model_and_configurations(harmonic_ff(n_atoms),
                                        chain_configs(2, n_atoms), beta=1.0)
    return sim


def _assert_same_files(a, b):
    names = files(a)
    assert names == files(b)
    for name in names:
        if name.endswith(".npy"):
            x, y = np.load(a / name), np.load(b / name)
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        elif name.endswith(".npz"):
            x, y = np.load(a / name), np.load(b / name)
            assert sorted(x.files) == sorted(y.files)
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])


def test_pipelined_exports_match_synchronous(tmp_path):
    """A no-op host subroutine makes the loop synchronous without changing
    the physics: files, checkpoints (with the generator's state) and
    trajectories are bitwise those of the pipelined order."""
    runs = {}
    for tag, extra in (("pipelined", {}), ("synchronous", dict(
            sim_subroutine=lambda carry: carry, sim_subroutine_interval=20))):
        out = tmp_path / tag
        sim = _langevin(out, n_timesteps=60, export_interval=20,
                        save_forces=True, save_energies=True,
                        create_checkpoints=True, **extra)
        sim.simulate()
        runs[tag] = (out, sim.simulated_coords)
    np.testing.assert_array_equal(runs["pipelined"][1],
                                  runs["synchronous"][1])
    _assert_same_files(runs["pipelined"][0], runs["synchronous"][0])
    assert any(n.endswith(".npz") for n in files(runs["pipelined"][0]))


def _count_launches(sim):
    sizes = []
    orig = sim._launch

    def counting(carry, gen, step, n_frames, halfway):
        sizes.append(n_frames)
        return orig(carry, gen, step, n_frames, halfway)

    sim._launch = counting
    return sizes


def test_launch_cap_preserves_trajectory():
    """One 120-step export: uncapped, one 12-frame launch; capped at 50
    steps, 5 + 5 + 2 frames; the trajectory bitwise the same."""
    out = {}
    for cap in (None, 50):
        sim = _langevin(n_timesteps=120, save_interval=10,
                        max_steps_per_launch=cap, random_seed=42)
        sizes = _count_launches(sim)
        sim.simulate()
        out[cap] = (sim.simulated_coords, sizes)
    assert out[None][1] == [12]
    assert out[50][1] == [5, 5, 2]
    np.testing.assert_array_equal(out[None][0], out[50][0])


def test_launches_split_each_export_segment(tmp_path):
    sim = NVESimulation(n_timesteps=100, save_interval=10, export_interval=40,
                        filename="x", output_dir=str(tmp_path),
                        max_steps_per_launch=25, device="cpu")
    # segments of 4, 4 and 2 frames, each cut into launches of 2 frames
    assert sim._launch_sizes() == [(2, False), (2, True), (2, False),
                                   (2, True), (2, True)]
    sim.max_steps_per_launch = 5  # below one save interval: one frame
    assert sim._launch_sizes()[:2] == [(1, False), (1, False)]


@pytest.mark.parametrize("cap", [0, -3])
def test_launch_cap_validation(cap):
    with pytest.raises(ValueError, match="max_steps_per_launch"):
        LangevinSimulation(n_timesteps=100, save_interval=10,
                           max_steps_per_launch=cap, device="cpu")
    with pytest.raises(ValueError, match="max_steps_per_launch"):
        JLangevinSimulation(n_timesteps=100, save_interval=10,
                            max_steps_per_launch=cap)


def test_save_subroutine_called_and_mutation_propagates(tmp_path):
    """save_subroutine(carry, n) runs at each export with the live carry,
    and what it changes reaches the next launch (the loop is synchronous
    while it is set)."""
    calls = []

    def freeze(carry, n):
        calls.append(n)
        carry["vel"] = torch.zeros_like(carry["vel"])
        carry["pos"] = torch.zeros_like(carry["pos"])

    def run(hook):
        sim = _langevin(tmp_path / str(hook), n_atoms=3, n_timesteps=40,
                        export_interval=20, random_seed=7,
                        save_subroutine=freeze if hook else None)
        sim.simulate()
        return sim.simulated_coords

    base = run(False)
    mutated = run(True)
    assert calls == [4, 8]  # one call per export, n = frames so far
    np.testing.assert_array_equal(mutated[:4], base[:4])
    assert not np.allclose(mutated[4:], base[4:])


def test_guard_raises_within_a_launch_of_the_blow_up():
    """NVE at an absurd dt blows up in the first save interval: the guard
    raises after at most one more launch was dispatched, not at the end
    of the run, naming the step where the JAX package names it."""
    kw = dict(dt=10.0, n_timesteps=1000, save_interval=10,
              max_steps_per_launch=10, random_seed=2)
    sim = NVESimulation(device="cpu", **kw)
    sim.attach_model_and_configurations(harmonic_ff(5, k=50.0),
                                        chain_configs(2, 5), beta=1.0)
    sizes = _count_launches(sim)
    with pytest.raises(RuntimeError, match="blew up at #timestep=10"):
        sim.simulate()
    assert len(sizes) == 2


# ---------------------------------------------------------------------------
# Checkpoints and resume
# ---------------------------------------------------------------------------

def test_resume_continues_rng_stream(tmp_path):
    """2N steps straight and N steps resumed to 2N from the checkpoint:
    the generator's stream continues, so the files are bitwise equal."""
    kw = dict(export_interval=25, create_checkpoints=True, random_seed=9)
    a = _langevin(tmp_path / "a", n_timesteps=50, **kw)
    a.simulate()
    b1 = _langevin(tmp_path / "b", n_timesteps=25, **kw)
    b1.simulate()
    ck = np.load(tmp_path / "b" / "t_checkpoint_0000.npz")
    fresh = torch.Generator().manual_seed(9).get_state().numpy()
    assert not np.array_equal(ck["rng_state"], fresh)
    b2 = _langevin(tmp_path / "b", n_timesteps=50, read_checkpoint_file=True,
                   **kw)
    assert b2.current_timestep == 1
    b2.simulate()
    for name in ("t_coords_0000.npy", "t_coords_0001.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "a" / name),
                                      np.load(tmp_path / "b" / name))
    np.testing.assert_array_equal(a.simulated_coords[5:],
                                  b2.simulated_coords)
    with pytest.raises(ValueError, match="already exists"):
        _langevin(tmp_path / "a", n_timesteps=50, **kw)


def test_resume_past_the_end_raises(tmp_path):
    kw = dict(export_interval=20, create_checkpoints=True)
    _langevin(tmp_path, n_timesteps=20, **kw).simulate()
    sim = _langevin(tmp_path, n_timesteps=20, read_checkpoint_file=True,
                    **kw)
    with pytest.raises(ValueError, match="already been running for 20"):
        sim.simulate()


def _pt(out, **over):
    kw = dict(friction=1.0, dt=5e-3, n_timesteps=200, save_interval=10,
              exchange_interval=20, export_interval=100, random_seed=11,
              filename="pt", output_dir=str(out), create_checkpoints=True)
    kw.update(over)
    return kw


def test_pt_resume_matches_uninterrupted(tmp_path):
    """200 steps straight and 100 resumed to 200: coordinates, acceptance
    files and the cumulative counters bitwise equal (each segment holds
    an odd number of exchanges, so the parity must be restored)."""
    sims = {}
    for tag, n, extra in (("a", 200, {}), ("b1", 100, {}),
                          ("b2", 200, dict(read_checkpoint_file=True))):
        out = tmp_path / tag[0]
        sim = PTSimulation(device="cpu", **_pt(out, n_timesteps=n, **extra))
        sim.attach_model_and_configurations(harmonic_ff(6),
                                            chain_configs(4, 6), BETAS)
        sim.simulate()
        sims[tag] = sim
    ck = np.load(tmp_path / "b" / "pt_checkpoint_0000.npz")
    assert int(ck["carry__exchange_parity"]) == 1
    assert int(ck["carry__n_exchange_attempted"]) == 5 * 4
    for name in ("pt_coords_0001.npy", "pt_acceptance_0001.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "a" / name),
                                      np.load(tmp_path / "b" / name))
    for key in ("n_exchange_attempted", "n_exchange_approved"):
        assert torch.equal(sims["a"].final_carry[key],
                           sims["b2"].final_carry[key])


def test_pt_acceptance_deltas_reset_per_export(tmp_path):
    """Each export's npy counts its own segment (float32, as the
    reference's); the deltas sum to the cumulative int32 matrix."""
    sim = PTSimulation(device="cpu", **_pt(tmp_path, export_interval=40))
    sim.attach_model_and_configurations(harmonic_ff(6), chain_configs(4, 6),
                                        BETAS)
    sim.simulate()
    acc = [np.load(tmp_path / f"pt_acceptance_{i:04d}.npy") for i in range(5)]
    assert all(a.dtype == np.float32 and a.shape == (3, 3) for a in acc)
    # 40 steps = 2 exchanges of 4 pairs in each export
    assert [a.sum() for a in acc] == [8.0] * 5
    np.testing.assert_array_equal(
        np.sum(acc, axis=0), sim.final_carry["acceptance_matrix"].numpy())


def test_resume_from_a_jax_checkpoint(tmp_path):
    """A PT checkpoint the JAX package wrote: positions, velocities,
    export index, intervals and PT counters resume exactly; its rng_key
    cannot seed a torch.Generator, so the run warns and draws from
    random_seed."""
    jsim = JPTSimulation(**_pt(tmp_path, n_timesteps=100))
    jsim.attach_model_and_configurations(jax_harmonic_ff(6),
                                         as_jax(chain_configs(4, 6)), BETAS)
    jsim.simulate()
    path = tmp_path / "pt_checkpoint_0000.npz"
    ck = np.load(path)
    with pytest.warns(UserWarning) as record:
        sim = PTSimulation(device="cpu", **_pt(
            tmp_path, n_timesteps=200, read_checkpoint_file=str(path),
            export_interval=50))  # the checkpoint's interval wins
    messages = " ".join(str(w.message) for w in record)
    assert "rng_key" in messages and "export_interval" in messages
    assert sim.current_timestep == 1 and sim.export_interval == 100
    sim.attach_model_and_configurations(harmonic_ff(6), chain_configs(4, 6),
                                        BETAS)
    np.testing.assert_array_equal(sim.initial_system.pos.numpy(), ck["pos"])
    np.testing.assert_array_equal(sim.initial_system.velocities.numpy(),
                                  ck["velocities"])
    with torch.no_grad():
        carry = sim._restore_carry_extra(sim._init_carry(sim.initial_system))
    for name in ("exchange_parity", "n_exchange_approved",
                 "n_exchange_attempted"):
        assert int(carry[name]) == int(ck[f"carry__{name}"])
    sim.simulate()
    assert int(sim.final_carry["n_exchange_attempted"]) == 10 * 4
    assert (tmp_path / "pt_coords_0001.npy").exists()


def test_foreign_carry_entries_warn(tmp_path):
    sim = PTSimulation(device="cpu", **_pt(tmp_path, n_timesteps=100))
    sim.attach_model_and_configurations(harmonic_ff(6), chain_configs(4, 6),
                                        BETAS)
    sim.simulate()
    sim2 = LangevinSimulation(friction=1.0, dt=5e-3, n_timesteps=200,
                              save_interval=10, export_interval=100,
                              filename="pt", output_dir=str(tmp_path),
                              read_checkpoint_file=True, device="cpu")
    sim2.attach_model_and_configurations(harmonic_ff(6), chain_configs(12, 6),
                                         beta=1.0)
    with pytest.warns(UserWarning, match="no match in this simulation"):
        sim2.simulate()


# ---------------------------------------------------------------------------
# Components, the dump, the profiler, logging, neighbour lists
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cheb_field():
    return jax_cheb_field()


def test_components_match_jax(cheb_field, tmp_path):
    """Energy and force components at the same carry against JAX's
    ``_component_outputs`` (fp32; summation order only), and the files in
    the JAX package's npz layout."""
    jff, jcfgs, ff, cfgs = cheb_field
    kw = dict(dt=0.004, n_timesteps=4, save_interval=2, gptq=None,
              save_energy_components=True, energy_components=["SchNet",
                                                              "bonds"],
              save_force_components=True, force_components=["SchNet",
                                                            "repulsion"],
              export_interval=4, filename="c")
    jsim = JNVESimulation(**{k: v for k, v in kw.items()
                             if k not in ("export_interval", "filename")})
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    sim = NVESimulation(device="cpu", output_dir=str(tmp_path / "port"),
                        **kw)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(0))
    jout = jax.jit(jsim._component_outputs)(jcarry)
    with torch.no_grad():
        out = sim._component_outputs(sim._init_carry(sim.initial_system))
    assert sorted(out) == sorted(jout)
    for k, v in out.items():
        ref = np.asarray(jout[k])
        assert v.shape == ref.shape
        assert np.abs(v.numpy() - ref).max() <= 1e-4 * np.abs(ref).max(), k
    with torch.no_grad():
        _, forces, comps = compute_energy_forces(
            sim.model, sim.initial_system.pos, sim.initial_system.atom_types)
    np.testing.assert_allclose(out["energy_component/bonds"].numpy(),
                               comps["bonds"].numpy(), rtol=1e-6)
    sim.simulate()
    # the JAX package's npz layout: one (S, frames, ...) array per name
    for name, keys, tail in (("energy", ["SchNet", "bonds"], ()),
                             ("force", ["SchNet", "repulsion"], (24, 3))):
        z = np.load(tmp_path / "port" / f"c_{name}_components_0000.npz")
        assert sorted(z.files) == keys
        for k in keys:
            assert z[k].shape == (2, 2) + tail and z[k].dtype == np.float32


def test_specialized_dump_round_trips(tmp_path):
    """The attached model (gptq's bf16, the Chebyshev fit) and the
    configurations come back from the dump, and give the same forces."""
    ff, cfgs = cgschnet_1enh_like(n_atoms=20, batch_size=2,
                                  num_interactions=1, precision="fp32",
                                  message_passing="cheb", device="cpu")
    sim = LangevinSimulation(friction=1.0, dt=1e-3, n_timesteps=10,
                             save_interval=5, filename="dumped",
                             output_dir=str(tmp_path), device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    path = str(tmp_path / "dumped_specialized_model_and_config.pkl")
    model = load_native_model(path, device="cpu")
    assert "cheb_fit" in model.schnet_params
    assert model.schnet_config == sim.model.schnet_config
    assert model.schnet_config.precision == "bf16"
    back = load_native_configurations(path)
    assert len(back) == len(cfgs)
    np.testing.assert_array_equal(back[0].pos, cfgs[0].pos)
    system = sim.initial_system
    with torch.no_grad():
        _, f0, _ = compute_energy_forces(sim.model, system.pos,
                                         system.atom_types)
        _, f1, _ = compute_energy_forces(model, system.pos,
                                         system.atom_types)
    assert torch.equal(f0, f1)


def test_profiler_window_writes_trace(tmp_path):
    sim = _langevin(tmp_path, n_timesteps=40, export_interval=20,
                    profile_start_step=20, profile_end_step=40)
    sim.simulate()
    assert list((tmp_path / "t_trace").glob("*.json"))


def test_logging_writes_the_log_file(tmp_path):
    sim = _langevin(tmp_path, n_timesteps=40, export_interval=20,
                    log_interval=20)
    sim.simulate()
    text = (tmp_path / "t_log.txt").read_text()
    assert "Generating 2 simulations" in text
    assert "4/8 time points saved" in text and "8/8 time points" in text
    assert "Simulation Complete" in text


def test_neighbor_list_dump_layout(tmp_path):
    """dump_neighbor_list(_last_n) on the xla path: the JAX package's file
    (the last n frames' idx and mask, [n, S, A, K], not swapped), in the
    dtypes of its neighbour build."""
    from flashmd_tpu.models.forcefield import (
        build_neighbors as jbuild_neighbors,
    )
    from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet

    jff, jcfgs = jcgschnet(n_atoms=12, batch_size=2, num_interactions=1,
                           precision="fp32", message_passing="xla",
                           neighbor_capacity=12)
    ff, cfgs = cgschnet_1enh_like(n_atoms=12, batch_size=2,
                                  num_interactions=1, message_passing="xla",
                                  neighbor_capacity=12, device="cpu")
    sim = NVESimulation(dt=1e-3, n_timesteps=8, save_interval=2,
                        export_interval=8, filename="n",
                        output_dir=str(tmp_path), dump_neighbor_list=True,
                        dump_neighbor_list_last_n=3, device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.0)
    sim.simulate()
    z = np.load(tmp_path / "n_neighbor_list_0000.npz")
    assert sorted(z.files) == ["idx", "mask"]
    jnbr = jbuild_neighbors(jff, np.stack([c.pos for c in jcfgs]))
    for k, ref in (("idx", jnbr.idx), ("mask", jnbr.mask)):
        assert z[k].shape == (3, 2, 12, 12)
        assert z[k].dtype == np.asarray(ref).dtype
    assert "nbr_idx" not in sim.simulated_frames


# ---------------------------------------------------------------------------
# Options: messages, gptq, dtype
# ---------------------------------------------------------------------------

OPTION_ERRORS = {
    "export_without_filename": dict(n_timesteps=100, save_interval=10,
                                    export_interval=50),
    "log_without_filename": dict(n_timesteps=100, save_interval=10,
                                 log_interval=20),
    "log_not_multiple": dict(n_timesteps=100, save_interval=10,
                             log_interval=15, log_type="print"),
    "too_many_files": dict(n_timesteps=100000, save_interval=1,
                           export_interval=10, filename="f"),
    "export_not_multiple": dict(n_timesteps=100, save_interval=10,
                                export_interval=25, filename="f"),
    "subroutine_without_interval": dict(sim_subroutine=print),
    "interval_without_subroutine": dict(sim_subroutine_interval=10),
    "force_components_missing": dict(save_force_components=True),
    "energy_components_missing": dict(save_energy_components=True),
    "log_type": dict(log_type="stream"),
    "dtype": dict(dtype="half"),
    "gptq": dict(gptq="int4"),
}


@pytest.mark.parametrize("case", sorted(OPTION_ERRORS))
def test_option_checks_match_jax(case, tmp_path):
    kw = dict(OPTION_ERRORS[case], output_dir=str(tmp_path))
    with pytest.raises(Exception) as jerr:
        JLangevinSimulation(**kw)
    with pytest.raises(Exception) as err:
        LangevinSimulation(device="cpu", **kw)
    assert type(err.value) is type(jerr.value)
    assert str(err.value) == str(jerr.value)


def test_existing_output_is_refused(tmp_path):
    (tmp_path / "f_coords_0000.npy").write_bytes(b"")
    with pytest.raises(ValueError, match="already exists"):
        LangevinSimulation(filename="f", output_dir=str(tmp_path),
                           device="cpu")


def test_default_gptq_attaches_bf16_as_jax(cheb_field):
    """The reference's default gptq="w16a16" on an fp32 field: both
    packages attach bf16, and their first forces agree within the CPU
    bf16 bound."""
    jff, jcfgs, ff, cfgs = cheb_field
    jsim = JLangevinSimulation()
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    sim = LangevinSimulation(device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert sim.gptq == jsim.gptq == "w16a16"
    assert ff.schnet_config.precision == "fp32"
    assert sim.model.schnet_config.precision == "bf16"
    assert jsim.model.schnet_config.precision == "bf16"
    validate_quantized(sim.model)
    jf = np.asarray(jax.jit(jsim._init_carry)(
        jsim.initial_system, jax.random.PRNGKey(0))["forces"])
    with torch.no_grad():
        f = sim._init_carry(sim.initial_system)["forces"].numpy()
    assert np.abs(f - jf).max() <= 2e-3 * np.abs(jf).max()


def test_validate_quantized():
    ff, _ = cgschnet_1enh_like(n_atoms=12, batch_size=1, num_interactions=1,
                               precision="fp32", message_passing="cheb",
                               device="cpu")
    with pytest.raises(RuntimeError, match="precision='fp32'"):
        validate_quantized(ff)
    validate_quantized(harmonic_ff(3))


@pytest.fixture
def x64():
    """JAX's dtype="double" turns x64 on for the process: turn it off."""
    prev = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", prev)


def _double_fields(path):
    if path == "prior":
        cfgs = with_velocities(chain_configs(2, 4), seed=1)
        return jax_harmonic_ff(4), as_jax(cfgs), harmonic_ff(4), cfgs
    from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet

    jff, jcfgs = jcgschnet(n_atoms=12, batch_size=2, num_interactions=1,
                           precision="fp32", message_passing=path,
                           neighbor_capacity=12, cheb_order=16)
    jcfgs = with_velocities(jcfgs)
    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    np_params.pop("cheb_fit", None)
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)}, device="cpu")
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities)
            for c in jcfgs]
    return jff, jcfgs, ff, cfgs


@pytest.mark.parametrize("path,bound", [("prior", 1e-12), ("dense", 1e-5),
                                        ("cheb", 1e-5), ("xla", 1e-7)])
def test_double_matches_jax_x64(path, bound, x64):
    """dtype="double": the integrator state in float64 in both packages;
    the priors compute in float64, the kernel paths in float32 on
    positions cast as the JAX package's kernel calls cast them, and the
    xla path promotes its float32 weights (both packages keep a few
    float32 operands there). First forces relative to max|F|; on the
    pure prior, 10 NVE steps."""
    jff, jcfgs, ff, cfgs = _double_fields(path)
    kw = dict(dt=1e-3, n_timesteps=10, save_interval=5, dtype="double",
              gptq=None)
    jsim = JNVESimulation(**kw)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.0)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(0))
    sim = NVESimulation(device="cpu", **kw)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.0)
    assert sim.initial_system.pos.dtype == torch.float64
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
    jf = np.asarray(jcarry["forces"])
    assert carry["forces"].dtype == torch.float64 and jf.dtype == np.float64
    assert np.abs(carry["forces"].numpy() - jf).max() <= bound * np.abs(
        jf).max()
    sim.simulate()
    assert sim.simulated_coords.dtype == np.float64
    if path == "prior":
        jsim.simulate()
        jc = np.concatenate(jsim.simulated_coords)
        assert np.abs(sim.simulated_coords - jc).max() <= 1e-12


def test_port_runs_without_tqdm_or_yaml():
    """The card has neither: with both unimportable, every module of the
    package imports, a run exports through the no-op progress bar, and
    the command line parses a YAML config and writes its echo with the
    port's own YAML code."""
    code = (
        "import sys\n"
        "sys.modules['tqdm'] = None\n"
        "sys.modules['yaml'] = None\n"
        "import importlib, pkgutil, tempfile\n"
        "import flashmd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import numpy as np, torch\n"
        "from flashmd_tpu_torch.data.system import Configuration\n"
        "from flashmd_tpu_torch.models.forcefield import ForceField\n"
        "from flashmd_tpu_torch.prior.priors import Prior\n"
        "from flashmd_tpu_torch.simulation import NVESimulation\n"
        "bonds = Prior(index_mapping=torch.tensor([[0, 1], [1, 2]]),\n"
        "              params={'x0': torch.ones(2), 'k': torch.ones(2)},\n"
        "              kind='harmonic_bonds', name='bonds',\n"
        "              feature='distance')\n"
        "ff = ForceField(schnet_params=None, priors={'bonds': bonds})\n"
        "pos = np.eye(3) + 0.1\n"
        "cfg = Configuration(pos=pos, atom_types=np.zeros(3, dtype=int),\n"
        "                    masses=np.ones(3))\n"
        "d = tempfile.mkdtemp()\n"
        "sim = NVESimulation(n_timesteps=4, save_interval=2, filename='t',\n"
        "                    output_dir=d, export_interval=2, device='cpu')\n"
        "sim.attach_model_and_configurations(ff, [cfg], beta=1.0)\n"
        "sim.simulate()\n"
        "import os\n"
        "assert os.path.exists(os.path.join(d, 't_coords_0001.npy'))\n"
        "from flashmd_tpu_torch.models.checkpoint_io import (\n"
        "    save_native_configurations, save_native_model)\n"
        "from flashmd_tpu_torch.simulation.scripts import nve_verlet_main\n"
        "from flashmd_tpu_torch.utils.io import load_yaml\n"
        "save_native_model(ff, os.path.join(d, 'm.pkl'))\n"
        "save_native_configurations([cfg], os.path.join(d, 's.pkl'))\n"
        "open(os.path.join(d, 'c.yaml'), 'w').write(\n"
        "    '# a config\\nsimulation:\\n  n_timesteps: 4\\n'\n"
        "    '  save_interval: 2\\n  dt: 1.0e-3\\n  filename: e\\n'\n"
        "    f'  output_dir: {d}\\n  device: cpu\\nbetas: [1.0]\\n'\n"
        "    f'model_file: {d}/m.pkl\\nstructure_file: {d}/s.pkl\\n')\n"
        "sys.argv = ['nve', '--config', os.path.join(d, 'c.yaml')]\n"
        "nve_verlet_main()\n"
        "echo = load_yaml(os.path.join(d, 'e_config.yaml'))\n"
        "assert echo['simulation']['dt'] == 0.001, echo\n"
        "assert echo['betas'] == [1.0] and echo['profile'] == '', echo\n"
        "assert os.path.exists(os.path.join(d, 'e_coords_0000.npy'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flashmd_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
