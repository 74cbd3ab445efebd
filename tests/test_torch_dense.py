"""Port parity for the dense all-pairs exact-filter CFConv path
(``message_passing="dense"``): the plain twins of
flashmd_tpu_torch/ops/cfconv_dense.py, the autograd Function, the SchNet
dense branch and BAOAB steps, each against the JAX package on identical
inputs made with numpy; the path's refusals; the entry points' default
device; and the dense modules' independence from JAX.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels of
ops/pallas/cfconv_dense.py in interpreter mode. Tolerances, on
max|port - jax| / max|jax| (2e-3 of max|F| for forces):
  * fp32: 1e-5 (summation order only);
  * bf16: 2e-3. The port rounds at the same places as the reference, the
    backward included (one MLP backward per ordered pair); bf16 also
    truncates on the TPU where the CPU rounds (ROADMAP queue C).
"""

import dataclasses
import inspect
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.ops.pallas.cfconv_dense import (
    dense_cfconv_message as jdense_cfconv_message,
)
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration, collate
from flashmd_tpu_torch.models.convert import (
    config_from_kwargs,
    forcefield_from_numpy,
)
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops import cfconv_dense as cd
from flashmd_tpu_torch.simulation.base import Simulation
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = 29  # JAX pads to a multiple of 8: padding is exercised
F = 16
R = 9
S = 2
RCUT = 4.0
TOL = {"fp32": 1e-5, "bf16": 2e-3}


def _rel(out, ref):
    ref = np.asarray(ref)
    return np.abs(np.asarray(out) - ref).max() / np.abs(ref).max()


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    offset = np.linspace(0.0, RCUT, R).astype(np.float32)
    return {
        # a box of side 6 around rc = 4: pairs inside and outside the cutoff
        "pos": rng.uniform(0.0, 6.0, (S, A, 3)).astype(np.float32),
        "x": rng.normal(size=(S, A, F)).astype(np.float32),
        "g": rng.normal(size=(S, A, F)).astype(np.float32),
        "w0": (rng.normal(size=(R, F)) / np.sqrt(R)).astype(np.float32),
        "b0": (0.1 * rng.normal(size=F)).astype(np.float32),
        "w1": (rng.normal(size=(F, F)) / np.sqrt(F)).astype(np.float32),
        "offset": offset,
        "coeff": np.float32(-0.5 / float(offset[1] - offset[0]) ** 2),
    }


def _jax_message(t, precision):
    def one(p, x):
        return jdense_cfconv_message(
            p, x, jnp.asarray(t["w0"]), jnp.asarray(t["b0"]),
            jnp.asarray(t["w1"]),
            (jnp.asarray(t["offset"]), jnp.asarray(t["coeff"])),
            RCUT, 8, precision,
        )

    return jax.vmap(one)


def _print_bf16_readings(what, port, ref_bf16, ref_fp32):
    """The bf16 readings kept in PERF.md (``pytest -s -k bf16``)."""
    print(f"\n{what}: max|d|/max|ref|: port bf16 vs jax bf16 "
          f"{_rel(port, ref_bf16):.3e}, port bf16 vs jax fp32 "
          f"{_rel(port, ref_fp32):.3e}, jax bf16 vs jax fp32 "
          f"{_rel(ref_bf16, ref_fp32):.3e}")


def _torch(t):
    return {k: torch.tensor(v) for k, v in t.items()}


def _weights(tt):
    return (tt["w0"], tt["b0"], tt["w1"], tt["offset"], tt["coeff"])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_fwd_matches_jax(precision):
    t = _inputs()
    ref = _jax_message(t, precision)(jnp.asarray(t["pos"]),
                                     jnp.asarray(t["x"]))
    tt = _torch(t)
    out = cd.dense_cfconv_fwd(tt["pos"], tt["x"], *_weights(tt), RCUT,
                              precision)
    assert out.shape == (S, A, F)
    assert _rel(out.numpy(), ref) <= TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_bwd_matches_jax_vjp(precision):
    t = _inputs(1)
    _, vjp = jax.vjp(_jax_message(t, precision), jnp.asarray(t["pos"]),
                     jnp.asarray(t["x"]))
    gpos_ref, gx_ref = vjp(jnp.asarray(t["g"]))
    tt = _torch(t)
    gpos, gx = cd.dense_cfconv_bwd_plain(tt["pos"], tt["x"], tt["g"],
                                         *_weights(tt), RCUT, precision)
    assert _rel(gx.numpy(), gx_ref) <= TOL[precision]
    assert _rel(gpos.numpy(), gpos_ref) <= TOL[precision]
    if precision == "bf16":
        _, vjp = jax.vjp(_jax_message(t, "fp32"), jnp.asarray(t["pos"]),
                         jnp.asarray(t["x"]))
        _print_bf16_readings("gpos", gpos.numpy(), gpos_ref,
                             vjp(jnp.asarray(t["g"]))[0])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_function_grad_matches_plain_bwd(precision):
    """torch.autograd.grad through dense_cfconv_message gives the plain
    backward exactly; with x frozen, gx is skipped and gpos unchanged."""
    tt = _torch(_inputs(2))
    pos = tt["pos"].clone().requires_grad_(True)
    x = tt["x"].clone().requires_grad_(True)
    out = cd.dense_cfconv_message(pos, x, *_weights(tt), RCUT, precision)
    gpos, gx = torch.autograd.grad(out, (pos, x), tt["g"])
    gpos_p, gx_p = cd.dense_cfconv_bwd_plain(tt["pos"], tt["x"], tt["g"],
                                             *_weights(tt), RCUT, precision)
    torch.testing.assert_close(gpos, gpos_p, rtol=0, atol=0)
    torch.testing.assert_close(gx, gx_p, rtol=0, atol=0)
    pos2 = tt["pos"].clone().requires_grad_(True)
    out = cd.dense_cfconv_message(pos2, tt["x"], *_weights(tt), RCUT,
                                  precision)
    (gpos2,) = torch.autograd.grad(out, (pos2,), tt["g"])
    torch.testing.assert_close(gpos2, gpos_p, rtol=0, atol=0)


def _config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_schnet(precision):
    jcfg = JSchNetConfig(
        hidden_channels=F, embedding_size=6, num_filters=F, num_rbf=R,
        num_interactions=2, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), precision=precision,
        message_passing="dense",
    )
    params = jinit_schnet(jax.random.PRNGKey(5), jcfg)
    return JForceField(schnet_params=params, priors={}, schnet_config=jcfg)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_schnet_dense_energy_forces_match_jax(precision):
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.0, 6.0, (S, A, 3)).astype(np.float32)
    types = rng.integers(0, 6, A)

    def jax_energy_forces(prec):
        jff = _jax_schnet(prec)
        return jax.jit(
            lambda p: jcompute_energy_forces(jff, p, jnp.asarray(types))
        )(jnp.asarray(pos))[:2]

    je, jf = jax_energy_forces(precision)
    jff = _jax_schnet(precision)
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, jff.schnet_params), {},
        _config_kwargs(jff.schnet_config), device="cpu",
    )
    assert ff.schnet_config.message_passing == "dense"
    e, f, _ = compute_energy_forces(ff, torch.tensor(pos),
                                    torch.tensor(types))
    assert f.shape == (S, A, 3) and e.shape == (S,)
    assert _rel(e.numpy(), je) <= TOL[precision]
    assert _rel(f.numpy(), jf) <= TOL[precision]
    if precision == "bf16":
        _print_bf16_readings("forces", f.numpy(), jf,
                             jax_energy_forces("fp32")[1])


def test_baoab_steps_dense_match_jax_with_injected_noise():
    jff, jcfgs = jcgschnet(
        n_atoms=24, batch_size=S, num_interactions=2, precision="fp32",
        message_passing="dense", neighbor_capacity=24,
    )
    rng = np.random.default_rng(4)
    jcfgs = [dataclasses.replace(c, velocities=rng.normal(
        scale=0.5, size=c.pos.shape)) for c in jcfgs]
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=3, save_interval=3,
                  random_seed=3)
    jsim = JLangevinSimulation(gptq=None, **kwargs)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)

    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        _config_kwargs(jff.schnet_config), device="cpu",
    )
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities)
            for c in jcfgs]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert "cheb_fit" not in sim.model.schnet_params

    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                     jax.random.PRNGKey(3))
    jstep = jax.jit(jsim._baoab)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for _ in range(3):
            # the reference's own draw (langevin.py:97, 104-106)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            carry = sim._baoab(carry, torch.tensor(np.asarray(xi)))
    # fp32: 1e-5 of the largest force, position and velocity
    assert _rel(carry["forces"].numpy(), jcarry["forces"]) <= 1e-5
    assert _rel(carry["pos"].numpy(), jcarry["pos"]) <= 1e-5
    assert _rel(carry["vel"].numpy(), jcarry["vel"]) <= 1e-5


def _small_dense(device="cpu", **kw):
    return cgschnet_1enh_like(n_atoms=12, batch_size=2, num_interactions=1,
                              message_passing="dense", device=device, **kw)


def test_zoo_dense_weights_config_and_simulate():
    """The dense zoo model has the cheb model's weights from the same seed;
    the config carries across; attach fits nothing; simulate() runs."""
    ff, cfgs = _small_dense()
    ff_cheb, _ = cgschnet_1enh_like(n_atoms=12, batch_size=2,
                                    num_interactions=1,
                                    message_passing="cheb", device="cpu")
    flat = jax.tree_util.tree_leaves(ff.schnet_params)
    flat_cheb = jax.tree_util.tree_leaves(ff_cheb.schnet_params)
    assert len(flat) == len(flat_cheb)
    for a, b in zip(flat, flat_cheb):
        assert torch.equal(a, b)
    assert config_from_kwargs(
        _config_kwargs(ff.schnet_config)).message_passing == "dense"
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert "cheb_fit" not in sim.model.schnet_params
    coords = sim.simulate()
    assert coords.shape == (2, 2, 12, 3) and np.isfinite(coords).all()


def test_dense_refusals():
    ff, cfgs = _small_dense()
    system = collate(cfgs, device="cpu")
    with pytest.raises(NotImplementedError, match="exc_pair_index"):
        compute_energy_forces(ff.replace(exc_pair_index=torch.zeros(2, 1)),
                              system.pos, system.atom_types)
    with pytest.raises(NotImplementedError, match="Periodic cells"):
        compute_energy_forces(ff, system.pos, system.atom_types,
                              cell=10.0 * torch.eye(3))
    lower = dataclasses.replace(ff.schnet_config,
                                cutoff=CosineCutoff(0.5, 10.0))
    with pytest.raises(NotImplementedError, match="cutoff_lower"):
        compute_energy_forces(ff.replace(schnet_config=lower), system.pos,
                              system.atom_types)


def test_dense_modules_import_no_jax():
    code = (
        "import sys\n"
        "import flashmd_tpu_torch.ops.cfconv_dense\n"
        "import flashmd_tpu_torch.models.schnet\n"
        "import flashmd_tpu_torch.models.forcefield\n"
        "import flashmd_tpu_torch.simulation.langevin\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flashmd_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_default_to_the_card():
    """No device given: the card. Without one, placing a tensor there
    raises instead of carrying on on the CPU."""
    assert Simulation().device.type == "cuda"
    assert LangevinSimulation(friction=1.0).device.type == "cuda"
    for fn in (cgschnet_1enh_like, forcefield_from_numpy, collate):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        ff, _ = _small_dense(device=torch.device("cuda"))
        assert ff.schnet_params["embedding"].device.type == "cuda"
        ff, _ = cgschnet_1enh_like(n_atoms=12, batch_size=1,
                                   num_interactions=1,
                                   message_passing="cheb")
        assert ff.schnet_params["embedding"].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            cgschnet_1enh_like(n_atoms=12, batch_size=1, num_interactions=1,
                               message_passing="cheb")
        _, cfgs = _small_dense()
        with pytest.raises((AssertionError, RuntimeError)):
            collate(cfgs)
