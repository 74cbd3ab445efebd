"""Port parity for the engine: BAOAB steps against the JAX package with
the reference's own noise injected, the CPU simulate() loop, collation,
and the port's independence from JAX."""

import dataclasses
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration, collate
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S = 2
N_STEPS = 5


def _with_velocities(cfgs, seed=4):
    rng = np.random.default_rng(seed)
    return [
        dataclasses.replace(c, velocities=rng.normal(scale=0.5,
                                                     size=c.pos.shape))
        for c in cfgs
    ]


def test_baoab_steps_match_jax_with_injected_noise():
    jff, jcfgs = jcgschnet(
        n_atoms=24, batch_size=S, num_interactions=2, precision="fp32",
        message_passing="cheb", neighbor_capacity=24, cheb_order=16,
    )
    jcfgs = _with_velocities(jcfgs)
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=N_STEPS,
                  save_interval=N_STEPS, random_seed=3)
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
                      velocities=c.velocities)
        for c in jcfgs
    ]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    np.testing.assert_array_equal(
        sim.initial_system.velocities.numpy(),
        np.asarray(jsim.initial_system.velocities),
    )

    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                     jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._baoab)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for _ in range(N_STEPS):
            # the reference's own draw (langevin.py:97, 104-106)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._baoab(carry, torch.tensor(np.asarray(xi)))
    # 1e-4 A at fp32: summation order of the two force evaluations only.
    np.testing.assert_allclose(carry["pos"].numpy(),
                               np.asarray(jcarry["pos"]), rtol=0, atol=1e-4)
    assert np.abs(carry["vel"].numpy() - np.asarray(jcarry["vel"])).max() \
        <= 1e-3 * np.abs(np.asarray(jcarry["vel"])).max()


def test_simulate_on_cpu():
    ff, cfgs = cgschnet_1enh_like(n_atoms=20, batch_size=S,
                                  num_interactions=1, message_passing="cheb",
                                  device="cpu")
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=8,
                             save_interval=4, random_seed=5, device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    coords = sim.simulate()
    assert coords.shape == (S, 2, 20, 3)
    assert np.isfinite(coords).all()
    assert np.isfinite(sim.simulated_potential).all()
    m = sim.get_throughput_metrics()
    assert m["second_half_steps"] == 4 and m["n_sims"] == S
    assert m["throughput"] > 0
    with pytest.raises(RuntimeError):
        sim.simulate()


def test_collate_honours_velocities_and_beta():
    rng = np.random.default_rng(0)
    cfgs = [
        Configuration(pos=rng.normal(size=(5, 3)), atom_types=np.arange(5),
                      masses=np.ones(5), velocities=rng.normal(size=(5, 3)))
        for _ in range(3)
    ]
    system = collate(cfgs, beta=[1.0, 2.0, 3.0], device="cpu")
    assert system.pos.dtype == torch.float32 and system.pos.shape == (3, 5, 3)
    np.testing.assert_array_equal(
        system.velocities.numpy(),
        np.stack([c.velocities for c in cfgs]).astype(np.float32),
    )
    np.testing.assert_array_equal(system.beta.numpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError):
        collate(cfgs, beta=-1.0, device="cpu")
    cfgs[1] = dataclasses.replace(cfgs[1], velocities=None)
    assert collate(cfgs, device="cpu").velocities is None


def test_port_imports_no_jax():
    """flashmd_tpu_torch and every submodule import without jax (and so
    without flashmd_tpu, whose modules import jax at the top)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import flashmd_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flashmd_tpu.'))]\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
