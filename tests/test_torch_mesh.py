"""Replica sharding of the port (flashmd_tpu_torch/parallel/mesh.py and its
hooks in the engine, parallel tempering and the command line) on the CPU.

Two gloo ranks, spawned once for the module as tests/simulation/
test_multihost.py spawns its workers, run every sharded case; each test
holds rank 0's result against the same run in one process without a mesh,
with the JAX suite's bounds (tests/simulation/test_parallel.py): Langevin
rtol 1e-6 / atol 1e-7, parallel tempering rtol 1e-5 / atol 1e-6 with the
acceptance counts and matrix exactly equal. NVE on the two ranks is held
against the JAX package's NVE on its 8-device CPU mesh, on weights carried
across, within the port's fp32 parity bound (positions 1e-4 A, velocities
1e-3 of their largest; tests/test_torch_integrators.py). The workers import
neither JAX nor the JAX package.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models.forcefield import ForceField
from flashmd_tpu_torch.parallel import mesh as mesh_mod
from flashmd_tpu_torch.prior.priors import Prior
from flashmd_tpu_torch.simulation import (
    LangevinSimulation,
    NVESimulation,
    PTSimulation,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
CASES = ("langevin", "pt", "pt_list", "mixed", "export", "nve")


# ---------------------------------------------------------------------------
# Inputs, built alike by the workers and the single-process references
# ---------------------------------------------------------------------------

def chain_ff(n_atoms: int) -> ForceField:
    """The JAX suite's ``harmonic_ff``: a chain of harmonic bonds."""
    mapping = np.stack([np.arange(n_atoms - 1), np.arange(1, n_atoms)])
    n = mapping.shape[1]
    return ForceField(schnet_params=None, priors={"bonds": Prior(
        index_mapping=torch.as_tensor(mapping, dtype=torch.int64),
        params={"x0": torch.ones(n), "k": torch.ones(n)},
        kind="harmonic_bonds", name="bonds", feature="distance")})


def chain_configs(n_sims: int, n_atoms: int):
    """The JAX suite's ``chain_configs``."""
    rng = np.random.default_rng(0)
    cfgs = []
    for _ in range(n_sims):
        pos = np.zeros((n_atoms, 3))
        pos[:, 0] = np.arange(n_atoms)
        pos += rng.normal(scale=0.05, size=pos.shape)
        cfgs.append(Configuration(pos=pos,
                                  atom_types=np.zeros(n_atoms, dtype=int),
                                  masses=np.ones(n_atoms)))
    return cfgs


def zoo(n_atoms, batch, message_passing, **kw):
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    return cgschnet_1enh_like(n_atoms=n_atoms, batch_size=batch,
                              num_interactions=2, precision="fp32",
                              message_passing=message_passing, device="cpu",
                              **kw)


def run_case(case, mesh, out_dir):
    """Run ``case`` with ``mesh`` (None: one process); the arrays that the
    tests compare, on every rank."""
    common = dict(device="cpu", gptq=None, mesh=mesh)
    if case == "langevin":  # the JAX suite's test_sharded_langevin
        sim = LangevinSimulation(friction=1.0, dt=1e-3, n_timesteps=40,
                                 save_interval=10, random_seed=21, **common)
        sim.attach_model_and_configurations(chain_ff(4), chain_configs(8, 4),
                                            beta=1.0)
    elif case in ("pt", "pt_list"):
        if case == "pt":
            ff, cfgs = chain_ff(5), chain_configs(2, 5)
            betas, dt, steps, save, every = ([1.67, 1.45, 1.28, 1.16], 5e-3,
                                             200, 50, 10)
        else:
            ff, cfgs = zoo(16, 2, "xla", neighbor_capacity=16)
            betas, dt, steps, save, every = [1.0, 0.99], 0.004, 40, 10, 5
        sim = PTSimulation(friction=1.0, dt=dt, n_timesteps=steps,
                           save_interval=save, exchange_interval=every,
                           random_seed=11, neighbor_rebuild_interval=2,
                           **common)
        sim.attach_model_and_configurations(ff, cfgs, betas)
    elif case == "mixed":
        ffs, cfgs = [], []
        for a in (8, 14):
            ff, c = zoo(a, 1, "cheb", cheb_order=16, cheb_d_min=1.0)
            ffs += [ff, ff]
            cfgs += c * 2
        sim = LangevinSimulation(friction=1.0, dt=0.004, n_timesteps=40,
                                 save_interval=10, random_seed=5, **common)
        sim.attach_model_and_configurations(ffs, cfgs, beta=1.67)
    elif case == "export":
        sim = LangevinSimulation(
            friction=1.0, dt=5e-3, n_timesteps=60, save_interval=10,
            export_interval=30, log_interval=10, random_seed=3,
            save_forces=True, save_energies=True, create_checkpoints=True,
            print_shape=True, filename="run", output_dir=out_dir, **common)
        sim.attach_model_and_configurations(chain_ff(6), chain_configs(4, 6),
                                            beta=1.67)
    elif case == "nve":
        from flashmd_tpu_torch.models.checkpoint_io import (
            load_native_configurations,
            load_native_model,
        )

        ff = load_native_model(os.path.join(out_dir, "nve_model.pkl"),
                               device="cpu")
        cfgs = load_native_configurations(
            os.path.join(out_dir, "nve_structures.pkl"))
        sim = NVESimulation(dt=0.004, n_timesteps=20, save_interval=10,
                            random_seed=3, **common)
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    sim.simulate()
    carry = sim.final_carry
    out = {"coords": sim.coords, "potential": sim.simulated_potential,
           "pos": carry["pos"].numpy(), "vel": carry["vel"].numpy()}
    if "nbr" in carry:
        out["nbr_idx"] = carry["nbr"].idx.numpy()
        out["nbr_n_max"] = carry["nbr_n_max"].numpy()
    if isinstance(sim, PTSimulation):
        for k in ("n_exchange_approved", "n_exchange_attempted",
                  "acceptance_matrix"):
            out[k] = carry[k].numpy()
        out["acceptance"] = sim.simulated_acceptance
    return out


def _rank_main(rank, world, port, out_dir):
    """One spawned rank: every case sharded over the gloo world; rank 0
    saves the results, each rank the count of its numpy file writes."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    mesh_mod.initialize_distributed(
        backend="gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank)
    saves = []
    real_save, real_savez = np.save, np.savez
    np.save = lambda *a, **k: (saves.append(a[0]), real_save(*a, **k))
    np.savez = lambda *a, **k: (saves.append(a[0]), real_savez(*a, **k))
    mesh = mesh_mod.make_replica_mesh()
    for case in CASES:
        d = os.path.join(out_dir, "sharded")
        os.makedirs(d, exist_ok=True)
        out = run_case(case, mesh, out_dir if case == "nve" else d)
        if rank == 0:
            real_savez(os.path.join(out_dir, f"{case}.npz"), **out)
    real_savez(os.path.join(out_dir, f"saves_{rank}.npz"),
               files=np.asarray([str(f) for f in saves] or [""]))
    rows = torch.arange(8.0).reshape(4, 2)[mesh.rows(4)]
    fetched = mesh_mod.fetch_to_host({"rows": rows,
                                      "step": torch.tensor(3)},
                                     mesh)
    real_savez(os.path.join(out_dir, f"fetch_{rank}.npz"), **fetched)
    torch.distributed.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# The two ranks, once for the module
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def nve_reference():
    """The JAX package's NVE on its 8-device CPU mesh (the zoo's 16-bead,
    2-block fp32 xla field, batch 8, velocities given), and the same
    weights and structures as the port's native files."""
    import jax

    from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
    from flashmd_tpu.parallel.mesh import make_replica_mesh as jmesh
    from flashmd_tpu.simulation import NVESimulation as JNVESimulation
    from flashmd_tpu_torch.models.convert import forcefield_from_numpy

    jff, jcfgs = jcgschnet(n_atoms=16, batch_size=8, num_interactions=2,
                           precision="fp32", message_passing="xla",
                           neighbor_capacity=16)
    rng = np.random.default_rng(4)
    jcfgs = [dataclasses.replace(c, velocities=rng.normal(
        scale=0.5, size=c.pos.shape)) for c in jcfgs]
    jsim = JNVESimulation(dt=0.004, n_timesteps=20, save_interval=10,
                          random_seed=3, gptq=None, mesh=jmesh())
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    jsim.simulate()
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu", neighbor_capacity=jff.neighbor_capacity)
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities)
            for c in jcfgs]
    return ff, cfgs, jsim


@pytest.fixture(scope="module")
def sharded(tmp_path_factory, nve_reference):
    """Rank 0's results of every case on two gloo ranks, and each rank's
    numpy file writes."""
    from flashmd_tpu_torch.models.checkpoint_io import (
        save_native_configurations,
        save_native_model,
    )

    out = tmp_path_factory.mktemp("mesh")
    ff, cfgs, _ = nve_reference
    save_native_model(ff, str(out / "nve_model.pkl"))
    save_native_configurations(cfgs, str(out / "nve_structures.pkl"))
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    code = ("import sys; from tests.test_torch_mesh import _rank_main; "
            "_rank_main(*sys.argv[1:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(WORLD), str(port),
         str(out)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    results = {c: dict(np.load(out / f"{c}.npz")) for c in CASES}
    saves = [list(np.load(out / f"saves_{r}.npz")["files"])
             for r in range(WORLD)]
    return results, saves, out


def _reference(case, out_dir=None):
    return run_case(case, None, str(out_dir) if out_dir else None)


def _assert_close(got, want, rtol, atol, keys=("coords", "pos", "vel")):
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def test_two_rank_langevin_matches_single_process(sharded):
    got, want = sharded[0]["langevin"], _reference("langevin")
    _assert_close(got, want, 1e-6, 1e-7)
    np.testing.assert_allclose(got["potential"], want["potential"],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("case", ["pt", "pt_list"])
def test_two_rank_pt_matches_single_process(sharded, case):
    """4 betas x 2 configurations over 200 steps on the harmonic chain
    (the JAX suite's long horizon), and 2 x 2 slots on the xla SchNet
    field, whose exchange moves the neighbour list across ranks and whose
    frames reduce the list's running maxima (count and Verlet
    displacement, rebuilt every 2 steps) over them."""
    got, want = sharded[0][case], _reference(case)
    _assert_close(got, want, 1e-5, 1e-6)
    for k in ("n_exchange_approved", "n_exchange_attempted",
              "acceptance_matrix", "acceptance"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["n_exchange_approved"] > 0
    if case == "pt_list":
        np.testing.assert_array_equal(got["nbr_idx"], want["nbr_idx"])
        assert got["nbr_n_max"] == want["nbr_n_max"]


def test_two_rank_mixed_batch_matches_single_process(sharded):
    """2 x 8 + 2 x 14 beads on the cheb path: rank 0 holds both small
    molecules (padded to 14), rank 1 the large ones; the stacked priors
    and the atom mask are sharded with the batch."""
    got, want = sharded[0]["mixed"], _reference("mixed")
    _assert_close(got, want, 1e-6, 1e-7)


def test_two_rank_export_writes_once_on_rank_zero(sharded, tmp_path):
    """Every file of the sharded run is written by rank 0 alone, and the
    files equal those of the same run in one process."""
    _, saves, out = sharded
    sharded_dir = out / "sharded"
    want = _reference("export", tmp_path)
    assert saves[1] == [""], f"rank 1 wrote {saves[1]}"
    rank0 = sorted(os.path.basename(f) for f in saves[0]
                   if os.path.dirname(f) == str(sharded_dir))
    names = sorted(f for f in os.listdir(tmp_path))
    got_names = sorted(f for f in os.listdir(sharded_dir)
                       if f.startswith("run"))
    assert got_names == names
    assert len(rank0) == len(set(rank0))  # each file once
    assert {"run_coords_0000.npy", "run_checkpoint_0001.npz",
            "run_checkpoint_init.npz", "run_log.txt"} <= set(names)
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(sharded_dir / name),
                                          np.load(tmp_path / name))
        elif name.endswith(".npz"):
            a, b = np.load(sharded_dir / name), np.load(tmp_path / name)
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=name)
    np.testing.assert_array_equal(sharded[0]["export"]["coords"],
                                  want["coords"])


def test_fetch_to_host_gives_every_rank_the_whole_batch(sharded):
    out = sharded[2]
    for r in range(WORLD):
        got = np.load(out / f"fetch_{r}.npz")
        np.testing.assert_array_equal(got["rows"],
                                      np.arange(8.0).reshape(4, 2))
        assert got["step"] == 3


def test_two_rank_nve_matches_jax_mesh(sharded, nve_reference):
    _, _, jsim = nve_reference
    got = sharded[0]["nve"]
    jcoords = np.swapaxes(np.concatenate(jsim.simulated_coords, axis=0),
                          0, 1)
    np.testing.assert_allclose(got["coords"], jcoords, rtol=0, atol=1e-4)
    jv = np.asarray(jsim.final_carry["vel"])
    assert np.abs(got["vel"] - jv).max() <= 1e-3 * np.abs(jv).max()


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------

def test_initialize_distributed_single_process_noop(monkeypatch):
    """No kwargs and no launcher in the environment: a no-op returning
    False. Lone coordinator-style variables do not count."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "SLURM_NTASKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "localhost")
    monkeypatch.setenv("SLURM_JOB_ID", "424242")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert mesh_mod.initialize_distributed() is False
    assert not torch.distributed.is_initialized()


def _boom(**kwargs):
    raise RuntimeError("rendezvous unreachable")


@pytest.mark.parametrize("env", [
    {},  # explicit kwargs
    {"WORLD_SIZE": "2"},
    {"MASTER_ADDR": "localhost", "RANK": "0"},  # torchrun, one process
])
def test_initialize_distributed_failures_propagate(monkeypatch, env):
    """Explicit kwargs, or an environment that shows a launcher: the
    process group's failure propagates, whatever the backend."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.distributed, "init_process_group", _boom)
    kwargs = ({} if env else dict(backend="gloo", world_size=2, rank=0,
                                  init_method="tcp://localhost:1"))
    with pytest.raises(RuntimeError, match="rendezvous unreachable"):
        mesh_mod.initialize_distributed(**kwargs)


def test_mesh_requests_beyond_the_world_raise():
    with pytest.raises(ValueError, match="the world holds 1"):
        mesh_mod.make_replica_mesh(2)
    mesh = mesh_mod.as_mesh("auto")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh_mod.as_mesh(mesh) is mesh and mesh_mod.as_mesh(None) is None
    assert mesh_mod.is_io_process()
    assert not mesh_mod.mesh_is_multiprocess(mesh)


def test_shard_carry_rejects_indivisible_and_slices_rows():
    mesh = mesh_mod.ReplicaMesh(rank=1, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.shard_carry({"pos": torch.zeros(3, 4, 3)}, mesh)
    carry = {"pos": torch.arange(24.0).reshape(4, 2, 3),
             "acc": torch.ones(2, 2), "step": torch.tensor(3)}
    out = mesh_mod.shard_carry(carry, mesh)
    assert torch.equal(out["pos"], carry["pos"][2:])
    assert out["acc"] is carry["acc"] and out["step"] is carry["step"]


def test_simulation_with_mesh_rejects_indivisible_batch():
    mesh = mesh_mod.ReplicaMesh(rank=0, size=2, device=torch.device("cpu"))
    sim = LangevinSimulation(friction=1.0, dt=1e-3, n_timesteps=10,
                             save_interval=5, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="not divisible"):
        sim.attach_model_and_configurations(chain_ff(4), chain_configs(3, 4),
                                            beta=1.0)


def test_one_process_mesh_is_bitwise_the_run_without():
    got = run_case("pt", "auto", None)
    want = _reference("pt")
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_cli_mesh_auto_runs_on_one_rank(tmp_path, caplog):
    """``--simulation.mesh auto`` through the port's command line, one
    process: a mesh of one rank, no warning, a run."""
    from flashmd_tpu_torch.models.checkpoint_io import (
        save_native_configurations,
        save_native_model,
    )
    from flashmd_tpu_torch.simulation import cli

    ff, cfgs = zoo(16, 2, "xla", neighbor_capacity=16)
    save_native_model(ff, str(tmp_path / "model.pkl"))
    save_native_configurations(cfgs, str(tmp_path / "structures.pkl"))
    args = ["--model_file", str(tmp_path / "model.pkl"),
            "--structure_file", str(tmp_path / "structures.pkl"),
            "--betas", "1.67", "--simulation.device", "cpu",
            "--simulation.mesh", "auto", "--simulation.n_timesteps", "10",
            "--simulation.save_interval", "5", "--disable_optim"]
    with caplog.at_level("WARNING", logger="flashmd_tpu_torch"):
        model, cfgs, betas, sim, _ = cli.parse_simulation_config(
            LangevinSimulation, args=args)
    assert "mesh" not in caplog.text and "Ignoring" not in caplog.text
    assert (sim.mesh.rank, sim.mesh.size) == (0, 1)
    sim.attach_model_and_configurations(model, cfgs, betas)
    assert np.isfinite(sim.simulate()).all()
