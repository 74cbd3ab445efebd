"""Port parity of the Chebyshev fit in all its forms against the JAX
package, on a narrow 2-block SchNet (hidden and filters 16, 12 RBF, rcut
10) whose JAX weights are carried into the port, on the JAX zoo's
24-bead chain at two molecules:

* ``chebyshev_nodes``: within one float32 ulp of 1 (1.2e-7); the two
  libraries' float32 cosines differ in the last bit at a few nodes;
* ``fit_chebyshev_filter`` (the in-graph fit): c, c2, w0 within 2e-6 of
  the JAX fit's max (measured 3e-7: the nodes' last bits and float32
  summation order), and within 1e-5 of the port's own float64 host fit;
  the asymmetric fit is the truncation of the symmetric one, as in the
  JAX suite (1e-6 relative, 1e-7 absolute);
* the host fit at ``wls`` (with an ``extra_weight``) and ``lawson``:
  bitwise the JAX package's (the same float64 numpy on the same weights);
* both guards raise as the JAX package's do;
* ``compute_energy_forces`` with no fit and with a stale fit (the port
  refits in the graph, the JAX package in jit), on both schedules: fp32
  within 1e-4 of max|F|; bf16 within 5e-3, as this narrow model's bf16
  forces differ by 2.6e-3 of max|F| between the packages with both host
  fits attached too (the port rounds to bf16 on the kernels' bases, JAX
  on the Ttil basis), and within 1e-4 of the port's own attached run
  (measured 2.3e-5: the fits differ by ~1e-6); the stale run bitwise the
  unattached;
* the filter parameters' cotangents on the unattached path: exactly zero
  under FLASHMD_CHEB_PARAM_GRAD=zero, NaN under ``poison``, in both;
* the first forces of a ``LangevinSimulation`` attached with ``wls``:
  its fits bitwise JAX's, fp32 forces within 1e-4 of max|F|;
* the zoo's ``cheb_fit_method`` and its positional order,
  ``Configuration.from_points`` and the compile options of
  ``Simulation``, against the JAX package's.
"""

import dataclasses
import functools
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.data.system import make_term_list as jmake_term_list
from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.models.schnet import schnet_energy as jschnet_energy
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.models.zoo import random_cg_protein as jrandom_cg_protein
from flashmd_tpu.simulation.base import Simulation as JSimulation
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration, make_term_list
from flashmd_tpu_torch.models import cheb
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.schnet import schnet_energy
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.simulation.base import Simulation
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.test_torch_threads import one_torch_thread  # noqa: F401

F = 16
RCUT = 10.0
N_ATOMS = 24
ORDERS = (16, 16)
D_MIN = 2.0
NODE_TOL = 1.2e-7
FIT_TOL = 2e-6
HOST_TOL = 1e-5
FORCE_TOL = {"fp32": 1e-4, "bf16": 5e-3}
ATTACHED_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _jconfig(precision="fp32", orders=ORDERS, d_min=D_MIN, method="proj"):
    return JSchNetConfig(
        hidden_channels=F, embedding_size=25, num_filters=F, num_rbf=12,
        num_interactions=2, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(16,), precision=precision,
        message_passing="cheb", cheb_order=orders[0],
        cheb_order_deriv=orders[1], cheb_d_min=d_min,
        cheb_fit_method=method,
    )


def _kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@functools.cache
def _pair():
    """The JAX field (no fit attached), the same weights in the port, and
    two molecules of the JAX zoo's chain (float32 [S, A, 3], types [A])."""
    jcfg = _jconfig()
    params = jinit_schnet(jax.random.PRNGKey(3), jcfg)
    jff = JForceField(schnet_params=params, priors={}, schnet_config=jcfg,
                      neighbor_capacity=N_ATOMS)
    ff = forcefield_from_numpy(jax.tree.map(np.asarray, params), {},
                               _kwargs(jcfg), device="cpu",
                               neighbor_capacity=N_ATOMS)
    base = jrandom_cg_protein(n_atoms=N_ATOMS, seed=0)
    rng = np.random.default_rng(5)
    pos = np.stack([base.pos + rng.normal(scale=0.05, size=base.pos.shape)
                    for _ in range(2)]).astype(np.float32)
    return jff, ff, pos, base.atom_types


def _variant(jff, ff, **kw):
    """Both fields with their configs changed alike."""
    jcfg = dataclasses.replace(jff.schnet_config, **kw)
    cfg = dataclasses.replace(ff.schnet_config, **kw)
    return jff.replace(schnet_config=jcfg), ff.replace(schnet_config=cfg)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


_jfit = jax.jit(jcheb.fit_chebyshev_filter,
                static_argnames=("config", "order", "order_deriv"))


@pytest.mark.parametrize("n", [7, 64, 512])
def test_chebyshev_nodes_match_jax(n):
    z = cheb.chebyshev_nodes(n)
    assert z.dtype == torch.float32 and z.shape == (n,)
    np.testing.assert_allclose(z.numpy(), np.asarray(jcheb.chebyshev_nodes(n)),
                               rtol=0, atol=NODE_TOL)


@pytest.mark.parametrize("d_min", [0.0, D_MIN])
@pytest.mark.parametrize("orders", [(16, 16), (12, 20)])
def test_fit_matches_jax(orders, d_min):
    """Each block's in-graph fit against the JAX package's in-jit fit
    (FIT_TOL of its max) and against the port's float64 host fit
    (HOST_TOL)."""
    jff, ff, _, _ = _pair()
    jff, ff = _variant(jff, ff, cheb_d_min=d_min)
    for b in range(2):
        args = dict(order=orders[0], order_deriv=orders[1])
        out = cheb.fit_chebyshev_filter(
            ff.schnet_params["interactions"][b], ff.schnet_params["rbf"],
            ff.schnet_config, **args)
        ref = _jfit(jff.schnet_params["interactions"][b],
                    jff.schnet_params["rbf"], jff.schnet_config, **args)
        host = cheb.fit_chebyshev_filter_host(
            ff.schnet_params["interactions"][b], ff.schnet_params["rbf"],
            ff.schnet_config, **args)
        shapes = [(orders[0], F), (orders[1], F), (F,)]
        for o, r, h, shape in zip(out, ref, host, shapes):
            assert o.dtype == torch.float32 and o.shape == shape
            assert _rel(o.detach(), r) <= FIT_TOL
            assert _rel(o.detach(), h) <= HOST_TOL


def test_asymmetric_fit_is_truncation():
    """The JAX suite's property (tests/ops/test_cheb_kernel.py:261-289) on
    the port: the (16, 32) fit is the leading rows of the symmetric 32
    fit, and w0 follows the truncated forward series."""
    _, ff, _, _ = _pair()
    bp, rbf = ff.schnet_params["interactions"][0], ff.schnet_params["rbf"]
    cfg = ff.schnet_config
    c_full, c2_full, _ = cheb.fit_chebyshev_filter(bp, rbf, cfg, order=32)
    c_a, c2_a, w0_a = cheb.fit_chebyshev_filter(bp, rbf, cfg, order=16,
                                                order_deriv=32)
    np.testing.assert_allclose(c_a.numpy(), c_full[:16].numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(c2_a.numpy(), c2_full.numpy(), rtol=1e-6,
                               atol=1e-7)
    signs = np.where(np.arange(16) % 2 == 0, 1.0, -1.0)
    np.testing.assert_allclose(w0_a.numpy(), 4.0 * (signs @ c_a.numpy()),
                               rtol=1e-5)


@pytest.mark.parametrize("method,extra", [("wls", True), ("lawson", False)])
def test_host_fit_methods_bitwise_jax(method, extra):
    """wls (one weighted least squares, here with a pair-density weight)
    and lawson (30 reweightings) on both packages' host fits: the same
    float64 numpy on the same weights, so bitwise equal after the float32
    cast; their coefficients differ from proj's, whose L1 norm they stay
    within 3x of."""
    jff, ff, _, _ = _pair()
    jff, ff = _variant(jff, ff, cheb_fit_method=method)
    weight = (lambda d: np.sqrt(d / RCUT)) if extra else None
    for b in range(2):
        args = dict(order=12, order_deriv=16, extra_weight=weight)
        out = cheb.fit_chebyshev_filter_host(
            ff.schnet_params["interactions"][b], ff.schnet_params["rbf"],
            ff.schnet_config, **args)
        ref = jcheb.fit_chebyshev_filter_host(
            jff.schnet_params["interactions"][b], jff.schnet_params["rbf"],
            jff.schnet_config, **args)
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        proj = cheb.fit_chebyshev_filter_host(
            ff.schnet_params["interactions"][b], ff.schnet_params["rbf"],
            dataclasses.replace(ff.schnet_config, cheb_fit_method="proj"),
            order=12, order_deriv=16)
        for o, p in zip(out[:2], proj[:2]):
            assert not torch.equal(o, p)
            assert o.abs().sum() <= 3.0 * p.abs().sum()


def test_guards_match_jax():
    """The in-graph fit refuses a host-only method, and the host fit an
    unknown one, with the JAX package's errors."""
    jff, ff, _, _ = _pair()
    for method, fit, jfit, err, match in (
        ("lawson", cheb.fit_chebyshev_filter, jcheb.fit_chebyshev_filter,
         NotImplementedError, "host-side fit"),
        ("minimax", cheb.fit_chebyshev_filter_host,
         jcheb.fit_chebyshev_filter_host, ValueError, "cheb_fit_method"),
    ):
        jv, v = _variant(jff, ff, cheb_fit_method=method)
        with pytest.raises(err, match=match):
            fit(v.schnet_params["interactions"][0], v.schnet_params["rbf"],
                v.schnet_config, order=8)
        with pytest.raises(err, match=match):
            jfit(jv.schnet_params["interactions"][0],
                 jv.schnet_params["rbf"], jv.schnet_config, order=8)


@functools.cache
def _jax_forces(precision):
    """The JAX package's network forces with no fit attached (in-jit fit
    on its CPU branch)."""
    jff, _, pos, types = _pair()
    jff, _ = _variant(jff, _pair()[1], precision=precision)
    e, f, _ = jax.jit(lambda p: jcompute_energy_forces(
        jff, p, jnp.asarray(types)))(jnp.asarray(pos))
    return np.asarray(e), np.asarray(f)


@pytest.mark.parametrize("stack", ["1", "0"], ids=["stacked", "per-block"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_unattached_and_stale_forces_match_jax(precision, stack,
                                               monkeypatch):
    """No fit attached, and a fit of other orders (12, 12) attached: the
    port fits in the graph; forces and energies against the JAX package's
    in-jit fit at FORCE_TOL and the port's attached host fit at
    ATTACHED_TOL, the stale run bitwise the unattached one."""
    monkeypatch.setenv("FLASHMD_CHEB_STACK", stack)
    jff, ff, pos, types = _pair()
    _, ff = _variant(jff, ff, precision=precision)
    stale_cfg = dataclasses.replace(ff.schnet_config, cheb_order=12,
                                    cheb_order_deriv=12)
    stale = ff.replace(schnet_params=cheb.attach_cheb_fit(ff.schnet_params,
                                                          stale_cfg))
    assert "cheb_fit" not in ff.schnet_params
    pos_t, types_t = torch.from_numpy(pos), torch.from_numpy(types).long()
    e, f, _ = compute_energy_forces(ff, pos_t, types_t)
    e_s, f_s, _ = compute_energy_forces(stale, pos_t, types_t)
    assert torch.equal(f, f_s) and torch.equal(e, e_s)
    attached = ff.replace(schnet_params=cheb.attach_cheb_fit(
        ff.schnet_params, ff.schnet_config))
    f_a = compute_energy_forces(attached, pos_t, types_t)[1]
    assert float((f - f_a).abs().max()) <= ATTACHED_TOL * float(
        f_a.abs().max())
    je, jf = _jax_forces(precision)
    tol = FORCE_TOL[precision]
    assert np.abs(f.numpy() - jf).max() <= tol * np.abs(jf).max()
    np.testing.assert_allclose(e.numpy(), je, rtol=tol, atol=tol)


def _filter_leaves(params):
    return [leaf for bp in params["interactions"]
            for layer in bp["filter"]["layers"] for leaf in layer.values()]


@functools.cache
def _jax_filter_grads(mode):
    """jax.grad of the first molecule's energy for the filter parameters,
    traced under FLASHMD_CHEB_PARAM_GRAD=``mode`` (set by the caller)."""
    jff, _, pos, types = _pair()
    grads = jax.jit(jax.grad(lambda p: jschnet_energy(
        p, jff.schnet_config, jnp.asarray(pos[0]), jnp.asarray(types),
        None)))(jff.schnet_params)
    return [np.asarray(g) for g in _filter_leaves(grads)]


@pytest.mark.parametrize("stack", ["1", "0"], ids=["stacked", "per-block"])
@pytest.mark.parametrize("mode", ["zero", "poison"])
def test_filter_cotangents_on_the_unattached_path(mode, stack, monkeypatch):
    """The energy's gradient reaches the filter parameters through the
    in-graph fit with the kernels' cotangent of c, c2 and w0: exactly 0
    under FLASHMD_CHEB_PARAM_GRAD=zero and NaN under poison, as
    jax.grad gives them through the JAX package's in-jit fit."""
    monkeypatch.setenv("FLASHMD_CHEB_PARAM_GRAD", mode)
    monkeypatch.setenv("FLASHMD_CHEB_STACK", stack)
    _, ff, pos, types = _pair()
    jleaves = _jax_filter_grads(mode)
    params = jax.tree.map(lambda t: t, ff.schnet_params)  # a new tree
    leaves = _filter_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    try:
        schnet_energy(params, ff.schnet_config, torch.from_numpy(pos[:1]),
                      torch.from_numpy(types).long(), None).sum().backward()
        grads = [leaf.grad.numpy() for leaf in leaves]
    finally:
        for leaf in leaves:
            leaf.requires_grad_(False)
            leaf.grad = None
    assert len(grads) == len(jleaves) > 0
    for g, jg in zip(grads, jleaves):
        assert g.shape == jg.shape
        if mode == "zero":
            assert not g.any() and not jg.any()
        else:
            assert np.isnan(g).all() and np.isnan(jg).all()


def _configurations(cls, term_list):
    _, _, pos, types = _pair()
    masses = np.linspace(0.2, 0.4, N_ATOMS)
    bonds = np.stack([np.arange(N_ATOMS - 1), np.arange(1, N_ATOMS)])
    return [cls(pos=p, atom_types=types, masses=masses,
                neighbor_lists={"bonds": term_list(bonds, tag="bonds",
                                                   order=2)})
            for p in pos.astype(np.float64)]


def test_langevin_attached_with_wls_first_forces_match_jax():
    """A LangevinSimulation attached with cheb_fit_method="wls" fits on the
    host at attach: its fits bitwise the JAX engine's, and the first force
    evaluation within 1e-4 of max|F| (fp32)."""
    jff, ff, _, _ = _pair()
    jff, ff = _variant(jff, ff, cheb_fit_method="wls")
    kw = dict(friction=1.0, dt=0.002, n_timesteps=10, save_interval=5,
              random_seed=1, gptq=None)
    sim = LangevinSimulation(device="cpu", **kw)
    sim.attach_model_and_configurations(
        ff, _configurations(Configuration, make_term_list), beta=1.67)
    jsim = JLangevinSimulation(**kw)
    jsim.attach_model_and_configurations(
        jff, _configurations(JConfiguration, jmake_term_list), beta=1.67)
    fits = sim.model.schnet_params["cheb_fit"]
    jfits = jsim.model.schnet_params["cheb_fit"]
    for fit, jfit in zip(fits, jfits):
        for o, r in zip(fit, jfit):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    with torch.no_grad():
        f = sim._init_carry(sim.initial_system)["forces"].numpy()
    jf = np.asarray(jax.jit(jsim._init_carry)(
        jsim.initial_system, jax.random.PRNGKey(0))["forces"])
    assert np.abs(f - jf).max() <= 1e-4 * np.abs(jf).max()


def test_zoo_fit_method_and_positional_order():
    """The port's zoo takes the JAX zoo's arguments in the JAX order, with
    ``device`` last, so that a positional call binds alike; the fit method
    defaults to proj and passes through."""
    names = list(inspect.signature(cgschnet_1enh_like).parameters)
    jnames = list(inspect.signature(jcgschnet).parameters)
    assert names == jnames + ["device"]
    args = (N_ATOMS, 1, RCUT, 1, "fp32", 16, "cheb", 0, 12, 12, 0.0, "wls")
    ff, _ = cgschnet_1enh_like(*args, device="cpu")
    jff, _ = jcgschnet(*args)
    assert ff.neighbor_capacity == jff.neighbor_capacity == 16
    for name in ("precision", "message_passing", "cheb_order",
                 "cheb_order_deriv", "cheb_d_min", "cheb_fit_method"):
        assert getattr(ff.schnet_config, name) == getattr(
            jff.schnet_config, name), name
    default, _ = cgschnet_1enh_like(n_atoms=N_ATOMS, batch_size=1,
                                    num_interactions=1, device="cpu")
    assert default.schnet_config.cheb_fit_method == "proj"


def test_configuration_from_points_matches_jax():
    rng = np.random.default_rng(2)
    kw = dict(
        pos=rng.normal(size=(5, 3)).astype(np.float32).tolist(),
        atom_types=[1, 2, 3, 2, 1], masses=[1.0, 2.0, 3.0, 2.0, 1.0],
        velocities=rng.normal(size=(5, 3)), cell=10.0 * np.eye(3),
        exc_pair_index=[[0, 1], [2, 3], [1, 4]], tag="points",
    )
    bonds = np.array([[0, 1, 2], [1, 2, 3]])
    cfg = Configuration.from_points(
        neighbor_lists={"bonds": make_term_list(bonds, tag="bonds")}, **kw)
    jcfg = JConfiguration.from_points(
        neighbor_lists={"bonds": jmake_term_list(bonds, tag="bonds")}, **kw)
    for name in ("pos", "atom_types", "masses", "velocities", "cell",
                 "exc_pair_index"):
        got, ref = getattr(cfg, name), getattr(jcfg, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        np.testing.assert_array_equal(got, ref)
    assert cfg.tag == jcfg.tag == "points"
    np.testing.assert_array_equal(cfg.neighbor_lists["bonds"].index_mapping,
                                  jcfg.neighbor_lists["bonds"].index_mapping)
    bare = Configuration.from_points(kw["pos"], kw["atom_types"])
    assert bare.masses is None and bare.neighbor_lists == {}


def test_simulation_accepts_the_compile_options():
    """compile, compile_mode, force_compile and compile_model: the JAX
    package's defaults, accepted and without effect on the run."""
    names = ("compile", "compile_mode", "force_compile", "compile_model")
    params = inspect.signature(Simulation.__init__).parameters
    jparams = inspect.signature(JSimulation.__init__).parameters
    for name in names:
        assert params[name].default == jparams[name].default, name
    sim = LangevinSimulation(friction=1.0, device="cpu", compile=False,
                             compile_mode="max-autotune", force_compile=True,
                             compile_model=False)
    assert sim.device == torch.device("cpu")
