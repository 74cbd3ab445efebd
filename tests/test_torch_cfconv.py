"""Port parity for the neighbour-matrix exact-filter CFConv path
(``message_passing="pallas"``): the plain twins of
flashmd_tpu_torch/ops/cfconv.py, the autograd Function, the SchNet pallas
branch, the force field's pair exclusions and BAOAB steps with the Verlet
list, each against the JAX package on identical inputs made with numpy;
the overflow and skin warnings; the path's refusals; the zoo's capacity
rule; and the new modules' independence from JAX.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels of
ops/pallas/cfconv.py in interpreter mode. The lists are symmetric (the
capacity holds every neighbour) or overflowed (each row keeps its nearest
K: an asymmetric list, whose column side is not the row side's mirror).
Tolerances, on max|port - jax| / max|jax|:
  * fp32: 1e-5 (summation order only);
  * bf16: 2e-3. The port rounds at the same places as the reference;
    bf16 also truncates on the TPU where the CPU rounds (ROADMAP queue C).
"""

import dataclasses
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
from flashmd_tpu.ops.neighborlist import (
    batched_radius_neighbor_matrix as jbatched,
)
from flashmd_tpu.ops.pallas.cfconv import (
    fused_cfconv_message as jfused_cfconv_message,
)
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration, collate
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops import cfconv as cf
from flashmd_tpu_torch.ops.neighborlist import batched_radius_neighbor_matrix
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = 29  # JAX pads to a multiple of 8: padding is exercised
F = 16
R = 9
S = 2
RCUT = 4.0
# 32 > A holds every neighbour (and pads); 8 overflows.
CAPACITY = {"symmetric": 32, "overflowed": 8}
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


def _lists(t, capacity):
    """(JAX list, port list) of the inputs' positions at rc + 0.5."""
    jn = jbatched(jnp.asarray(t["pos"]), RCUT + 0.5, capacity)
    tn = batched_radius_neighbor_matrix(torch.tensor(t["pos"]), RCUT + 0.5,
                                        capacity)
    overflow = int(tn.n_max.max()) > capacity
    assert overflow == (capacity == CAPACITY["overflowed"])
    return jn, tn


def _jax_message(t, jn, precision):
    def one(p, idx, mask, x):
        return jfused_cfconv_message(
            p, idx, mask.astype(jnp.float32), x, jnp.asarray(t["w0"]),
            jnp.asarray(t["b0"]), jnp.asarray(t["w1"]),
            (jnp.asarray(t["offset"]), jnp.asarray(t["coeff"])), RCUT, 8,
            precision,
        )

    return lambda p, x: jax.vmap(one)(p, jn.idx, jn.mask, x)


def _torch(t):
    return {k: torch.tensor(v) for k, v in t.items()}


def _weights(tt):
    return (tt["w0"], tt["b0"], tt["w1"], tt["offset"], tt["coeff"])


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_plain_fwd_matches_jax(precision):
    t = _inputs()
    jn, tn = _lists(t, CAPACITY["symmetric"])
    ref = _jax_message(t, jn, precision)(jnp.asarray(t["pos"]),
                                         jnp.asarray(t["x"]))
    tt = _torch(t)
    out = cf.cfconv_fwd(tt["pos"], tn.idx, tn.mask, tt["x"], *_weights(tt),
                        RCUT, precision)
    assert out.shape == (S, A, F)
    assert _rel(out.numpy(), ref) <= TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["symmetric", "overflowed"])
def test_plain_bwd_matches_jax_vjp(precision, kind):
    t = _inputs(1)
    jn, tn = _lists(t, CAPACITY[kind])
    _, vjp = jax.vjp(_jax_message(t, jn, precision), jnp.asarray(t["pos"]),
                     jnp.asarray(t["x"]))
    gpos_ref, gx_ref = vjp(jnp.asarray(t["g"]))
    tt = _torch(t)
    gpos, gx = cf.cfconv_bwd(tt["pos"], tn.idx, tn.mask, tn.csr_offsets,
                             tn.csr_slots, tt["x"], tt["g"], *_weights(tt),
                             RCUT, precision)
    assert _rel(gx.numpy(), gx_ref) <= TOL[precision]
    assert _rel(gpos.numpy(), gpos_ref) <= TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_function_grad_matches_plain_bwd(precision):
    """torch.autograd.grad through fused_cfconv_message gives the plain
    backward exactly; with x frozen, gx is skipped and gpos unchanged."""
    t = _inputs(2)
    _, nbr = _lists(t, CAPACITY["overflowed"])
    tt = _torch(t)
    pos = tt["pos"].clone().requires_grad_(True)
    x = tt["x"].clone().requires_grad_(True)
    out = cf.fused_cfconv_message(pos, x, nbr, *_weights(tt), RCUT,
                                  precision)
    gpos, gx = torch.autograd.grad(out, (pos, x), tt["g"])
    gpos_p, gx_p = cf.cfconv_bwd_plain(tt["pos"], nbr.idx, nbr.mask,
                                       tt["x"], tt["g"], *_weights(tt), RCUT,
                                       precision)
    torch.testing.assert_close(gpos, gpos_p, rtol=0, atol=0)
    torch.testing.assert_close(gx, gx_p, rtol=0, atol=0)
    pos2 = tt["pos"].clone().requires_grad_(True)
    out = cf.fused_cfconv_message(pos2, tt["x"], nbr, *_weights(tt), RCUT,
                                  precision)
    (gpos2,) = torch.autograd.grad(out, (pos2,), tt["g"])
    torch.testing.assert_close(gpos2, gpos_p, rtol=0, atol=0)


def _config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _jax_schnet(precision, capacity, exc):
    jcfg = JSchNetConfig(
        hidden_channels=F, embedding_size=6, num_filters=F, num_rbf=R,
        num_interactions=2, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), precision=precision,
        message_passing="pallas",
    )
    params = jinit_schnet(jax.random.PRNGKey(5), jcfg)
    return JForceField(
        schnet_params=params, priors={}, schnet_config=jcfg,
        neighbor_capacity=capacity,
        exc_pair_index=None if exc is None else jnp.asarray(exc),
    )


@pytest.mark.parametrize("precision,exclude", [
    ("fp32", False), ("bf16", False), ("fp32", True),
])
def test_schnet_pallas_energy_forces_match_jax(precision, exclude):
    """Energies and forces of a 2-block pallas SchNet (list built inside
    compute_energy_forces), with and without excluded pairs."""
    rng = np.random.default_rng(6)
    pos = rng.uniform(0.0, 6.0, (S, A, 3)).astype(np.float32)
    types = rng.integers(0, 6, A)
    exc = rng.integers(0, A, (2, 30)) if exclude else None
    jff = _jax_schnet(precision, 16, exc)
    je, jf = jax.jit(
        lambda p: jcompute_energy_forces(jff, p, jnp.asarray(types))
    )(jnp.asarray(pos))[:2]
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, jff.schnet_params), {},
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity, exc_pair_index=exc,
    )
    assert ff.schnet_config.message_passing == "pallas"
    assert ff.neighbor_capacity == 16
    e, f, _ = compute_energy_forces(ff, torch.tensor(pos),
                                    torch.tensor(types))
    assert f.shape == (S, A, 3) and e.shape == (S,)
    assert _rel(e.numpy(), je) <= TOL[precision]
    assert _rel(f.numpy(), jf) <= TOL[precision]
    if exclude:  # the exclusions change the forces
        f_all, = compute_energy_forces(ff.replace(exc_pair_index=None),
                                       torch.tensor(pos),
                                       torch.tensor(types))[1:2]
        assert _rel(f_all.numpy(), f.numpy()) > 1e-3


def _baoab_pair(interval):
    """(JAX simulation, port simulation) on the same weights and start."""
    jff, jcfgs = jcgschnet(
        n_atoms=24, batch_size=S, num_interactions=2, precision="fp32",
        message_passing="pallas", neighbor_capacity=24,
    )
    rng = np.random.default_rng(4)
    jcfgs = [dataclasses.replace(c, velocities=rng.normal(
        scale=0.5, size=c.pos.shape)) for c in jcfgs]
    kwargs = dict(dt=0.004, friction=1.0, n_timesteps=4, save_interval=4,
                  random_seed=3, neighbor_skin=1.0,
                  neighbor_rebuild_interval=interval)
    jsim = JLangevinSimulation(gptq=None, **kwargs)
    jsim.attach_model_and_configurations(jff, jcfgs, beta=1.67)
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity,
    )
    cfgs = [Configuration(pos=c.pos, atom_types=c.atom_types,
                          masses=c.masses, velocities=c.velocities)
            for c in jcfgs]
    sim = LangevinSimulation(device="cpu", gptq=None, **kwargs)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    return jsim, sim


@pytest.mark.parametrize("interval", [1, 2])
def test_baoab_steps_pallas_match_jax_with_injected_noise(interval):
    """Four steps with the Verlet list rebuilt from the positions at the
    start of a step (every step, or every second with the displacement
    tracked), as the reference's _step_with_hooks (base.py:697-716)."""
    jsim, sim = _baoab_pair(interval)
    jcarry = jax.jit(jsim._init_carry)(jsim.initial_system,
                                       jax.random.PRNGKey(3))
    jrebuild = jax.jit(jsim._rebuild_neighbors)
    jstep = jax.jit(jsim._baoab)
    with torch.no_grad():
        carry = sim._init_carry(sim.initial_system)
        for t in range(4):
            if t % interval == 0:
                jcarry = jrebuild(jcarry)
            # the reference's own draw (langevin.py:97, 104-106)
            _, sub = jax.random.split(jcarry["key"])
            xi = jax.random.normal(sub, jcarry["vel"].shape, jnp.float32)
            jcarry = jstep(jcarry)
            if interval > 1:
                jcarry = jsim._track_neighbor_displacement(jcarry)
            carry = sim._step_with_hooks(carry, torch.tensor(np.asarray(xi)),
                                         t)
    np.testing.assert_array_equal(carry["nbr"].idx.numpy(),
                                  np.asarray(jcarry["nbr_idx"]))
    # fp32: 1e-5 of the largest force, position and velocity
    assert _rel(carry["forces"].numpy(), jcarry["forces"]) <= 1e-5
    assert _rel(carry["pos"].numpy(), jcarry["pos"]) <= 1e-5
    assert _rel(carry["vel"].numpy(), jcarry["vel"]) <= 1e-5
    assert int(carry["nbr_n_max"]) == int(jcarry["nbr_n_max"])
    if interval > 1:
        assert abs(float(carry["nbr_disp_max"])
                   - float(jcarry["nbr_disp_max"])) <= 1e-5


def _small_pallas(device="cpu", **kw):
    return cgschnet_1enh_like(n_atoms=24, batch_size=2, num_interactions=1,
                              message_passing="pallas", device=device, **kw)


def test_simulate_warns_on_overflow_and_stale_skin():
    ff, cfgs = _small_pallas()
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device="cpu",
                             neighbor_capacity=4)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    assert sim.model.neighbor_capacity == 4
    with pytest.warns(RuntimeWarning, match="Neighbor capacity overflow"):
        coords = sim.simulate()
    assert coords.shape == (2, 2, 24, 3) and np.isfinite(coords).all()
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=5, device="cpu",
                             neighbor_skin=1e-6, neighbor_rebuild_interval=2)
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    with pytest.warns(RuntimeWarning, match="Verlet-skin soundness"):
        sim.simulate()


def test_zoo_capacity_rule_and_weights():
    """The zoo's capacity rule gives the reference's K (88 at 266 beads);
    the pallas model has the cheb model's weights from the same seed."""
    ff, _ = cgschnet_1enh_like(batch_size=1, num_interactions=1,
                               message_passing="pallas", device="cpu")
    jff, _ = jcgschnet(batch_size=1, num_interactions=1,
                       message_passing="pallas")
    assert ff.neighbor_capacity == jff.neighbor_capacity == 88
    ff_small, _ = _small_pallas(neighbor_capacity=12)
    assert ff_small.neighbor_capacity == 12
    ff_cheb, _ = cgschnet_1enh_like(n_atoms=24, batch_size=2,
                                    num_interactions=1,
                                    message_passing="cheb", device="cpu")
    flat = jax.tree_util.tree_leaves(ff_small.schnet_params)
    flat_cheb = jax.tree_util.tree_leaves(ff_cheb.schnet_params)
    assert len(flat) == len(flat_cheb)
    for a, b in zip(flat, flat_cheb):
        assert torch.equal(a, b)


def test_pallas_refusals():
    ff, cfgs = _small_pallas()
    system = collate(cfgs, device="cpu")
    with pytest.raises(NotImplementedError, match="Periodic cells"):
        compute_energy_forces(ff, system.pos, system.atom_types,
                              cell=10.0 * torch.eye(3))
    lower = dataclasses.replace(ff.schnet_config,
                                cutoff=CosineCutoff(0.5, 10.0))
    with pytest.raises(NotImplementedError, match="cutoff_lower"):
        compute_energy_forces(ff.replace(schnet_config=lower), system.pos,
                              system.atom_types)
    excl = torch.tensor([[0], [5]])
    for mp in ("cheb", "dense"):
        other = dataclasses.replace(ff.schnet_config, message_passing=mp)
        with pytest.raises(NotImplementedError, match="exc_pair_index"):
            compute_energy_forces(
                ff.replace(schnet_config=other, exc_pair_index=excl),
                system.pos, system.atom_types)
    # honoured on the pallas path
    compute_energy_forces(ff.replace(exc_pair_index=excl), system.pos,
                          system.atom_types)


def test_pallas_modules_import_no_jax():
    code = (
        "import sys\n"
        "import flashmd_tpu_torch.ops.neighborlist\n"
        "import flashmd_tpu_torch.ops.cfconv\n"
        "import flashmd_tpu_torch.models.schnet\n"
        "import flashmd_tpu_torch.models.forcefield\n"
        "import flashmd_tpu_torch.models.zoo\n"
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
