"""The port's public surface against the JAX package's: SchNetConfig's
fields, order and defaults (``max_num_neighbors``, ``aggr``, the "xla"
default path, the derivative order left None and resolved where it is
read), ``GaussianBasisConfig.trainable``, the neighbour lists'
``self_interaction`` and the geometry helpers' ``cell_shifts``, and a walk
over every module both packages have that compares each public function's
parameters and each dataclass's fields: names, order and defaults.

The walk sets aside, and documents here, the only differences that stay:
the port's own parameters where the JAX function lacks them
(PORT_ONLY_PARAMS: the device, the seeded generator in place of a key,
the host checks, the native engine switch, the mesh, a precomputed inverse
cell, a torch dtype) and fields (PORT_ONLY_FIELDS), the JAX package's key
and dtype parameters where the port's function lacks them
(JAX_ONLY_PARAMS: the port draws from a torch.Generator and keeps
float32), and the defaults of a device or dtype that both have (the card
against JAX's platform choice, torch's dtypes against jnp's). Tolerances: lists exact
(idx, mask, n_max), shifts 1e-5; distances 1e-6 relative; the xla field
on a self-inclusive list: energies 1e-5 of max against JAX's xla, forces
1e-4 of max against JAX's pallas path (interpret mode), since JAX's xla
forces are NaN there (its square root at d = 0); the port's pallas twins
against JAX's pallas path 1e-4.
"""

import dataclasses
import importlib
import inspect
import io
import pickle
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flashmd_tpu
import flashmd_tpu_torch
from flashmd_tpu.models import checkpoint_io as jcio
from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.radial_basis import (
    GaussianBasisConfig as JGaussianBasisConfig,
)
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.ops import geometry as jgeo
from flashmd_tpu.ops import neighborlist as jnl
from flashmd_tpu_torch.models import checkpoint_io as cio
from flashmd_tpu_torch.models.cheb import attach_cheb_fit, resolved_order_deriv
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.cutoff import CosineCutoff
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.radial_basis import GaussianBasisConfig
from flashmd_tpu_torch.models.schnet import SchNetConfig, init_schnet
from flashmd_tpu_torch.ops import geometry as geo
from flashmd_tpu_torch.ops import neighborlist as nl
from tests.test_torch_host import NOT_PORTED
from tests.test_torch_threads import one_torch_thread  # noqa: F401

PORT_ONLY_PARAMS = {"device", "generator", "check_cell", "native", "mesh",
                    "inv", "dtype"}
JAX_ONLY_PARAMS = {"key", "dtype"}
LIBRARY_DEFAULTS = {"device", "dtype"}
PORT_ONLY_FIELDS = {
    # the batched list's source CSR (ops/neighborlist.py)
    "NeighborMatrix": {"csr_offsets", "csr_slots"},
    # the cells as float64 numpy on the host, validated without the card
    "System": {"cell_host"},
}
S, A, RCUT, K = 2, 18, 4.0, 24
F, R = 16, 6


@pytest.fixture(autouse=True)
def _float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _modules(package):
    out = {}
    for info in pkgutil.walk_packages(package.__path__,
                                      package.__name__ + "."):
        if ".pallas" in info.name:  # the TPU kernels: ops/cfconv*.py etc.
            continue
        out[info.name[len(package.__name__):]] = importlib.import_module(
            info.name)
    return out


COMMON = sorted(set(_modules(flashmd_tpu)) & set(_modules(flashmd_tpu_torch)))


def _default(value):
    """A default as comparable across the packages: envelopes by class
    name and fields."""
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return type(value).__name__, dataclasses.asdict(value)
    return value


def _signature(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _params(params, own_only, other):
    """(name, kind, default) of each parameter but those of ``own_only``
    that the other package's function lacks. Both packages' device and
    dtype defaults are their own (the card, a library's dtype), so those
    two compare by name and place only."""
    if params is None:
        return None
    return [(p.name, p.kind,
             None if p.name in LIBRARY_DEFAULTS else _default(p.default))
            for p in params.values()
            if not (p.name in own_only and p.name not in (other or {}))]


def _fields(cls):
    drop = PORT_ONLY_FIELDS.get(cls.__name__, set())
    return [(f.name, _default(f.default),
             f.default_factory is not dataclasses.MISSING)
            for f in dataclasses.fields(cls) if f.name not in drop]


def _differences(name, jobj, pobj):
    if dataclasses.is_dataclass(jobj):
        if _fields(jobj) != _fields(pobj):
            return [f"{name}: fields {_fields(jobj)} != {_fields(pobj)}"]
        return []
    if isinstance(jobj, type):
        out = []
        for attr, jv in vars(jobj).items():
            if (attr.startswith("_") and attr != "__init__") or (
                    not callable(jv)):
                continue
            out += _differences(f"{name}.{attr}", jv, getattr(pobj, attr))
        return out
    js, ps = _signature(jobj), _signature(pobj)
    jp = _params(js, JAX_ONLY_PARAMS, ps)
    pp = _params(ps, PORT_ONLY_PARAMS, js)
    return [] if jp == pp else [f"{name}: {jp} != {pp}"]


@pytest.mark.parametrize("module", COMMON)
def test_public_signatures_match_jax(module):
    """Every public function, class and dataclass that the JAX module
    defines exists in the port's module with the same parameters (names,
    kinds, order, defaults) or fields, up to the documented port-only and
    JAX-only ones."""
    jmod = importlib.import_module("flashmd_tpu" + module)
    pmod = importlib.import_module("flashmd_tpu_torch" + module)
    skip = NOT_PORTED.get("flashmd_tpu_torch" + module, set())
    diffs = []
    for name, jobj in vars(jmod).items():
        if (name.startswith("_") or name in skip or not callable(jobj)
                or getattr(jobj, "__module__", None) != jmod.__name__):
            continue
        assert hasattr(pmod, name), f"flashmd_tpu_torch{module} lacks {name}"
        diffs += _differences(name, jobj, getattr(pmod, name))
    assert not diffs, "\n".join(diffs)


def test_the_walk_covers_the_packages():
    assert len(COMMON) >= 29
    for module in (".models.schnet", ".ops.neighborlist", ".ops.geometry",
                   ".models.radial_basis", ".prior.priors"):
        assert module in COMMON


# ---------------------------------------------------------------------------
# SchNetConfig and GaussianBasisConfig
# ---------------------------------------------------------------------------


def test_config_binds_positionally_as_jax():
    args = (16, 20, 16, 2, 8, JCosineCutoff(0.0, RCUT), None, (16,), "tanh",
            32, "add", "bf16", "cheb", 24, None, 1.0, "wls", "none")
    jcfg = JSchNetConfig(*args)
    cfg = SchNetConfig(*args[:5], CosineCutoff(0.0, RCUT), *args[6:])
    for f in dataclasses.fields(cfg):
        if f.name in ("cutoff", "rbf_cutoff"):
            assert _default(getattr(cfg, f.name)) == _default(
                getattr(jcfg, f.name))
        else:
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name


def test_aggr_and_max_num_neighbors_match_jax():
    cfg = SchNetConfig(aggr="add", max_num_neighbors=32)
    jcfg = JSchNetConfig(aggr="add", max_num_neighbors=32)
    assert (cfg.aggr, cfg.max_num_neighbors) == (
        jcfg.aggr, jcfg.max_num_neighbors) == ("add", 32)
    for aggr in ("mean", "max"):
        with pytest.raises(NotImplementedError) as got:
            SchNetConfig(aggr=aggr)
        with pytest.raises(NotImplementedError) as ref:
            JSchNetConfig(aggr=aggr)
        assert str(got.value) == str(ref.value)


def test_replace_keeps_the_orders_coupled_as_jax():
    cfg = SchNetConfig(message_passing="cheb", cheb_order=64,
                       hidden_channels=8, num_filters=8, num_rbf=5,
                       embedding_size=4, output_hidden_layer_widths=(8,),
                       num_interactions=1)
    jcfg = JSchNetConfig(message_passing="cheb", cheb_order=64)
    assert cfg.cheb_order_deriv is None and jcfg.cheb_order_deriv is None
    for kw in ({"cheb_order": 32}, {"cheb_order": 40, "cheb_order_deriv": 48},
               {"cheb_order_deriv": 72}):
        new = dataclasses.replace(cfg, **kw)
        jnew = dataclasses.replace(jcfg, **kw)
        assert new.cheb_order_deriv == jnew.cheb_order_deriv
        assert resolved_order_deriv(new) == (jnew.cheb_order_deriv
                                             or jnew.cheb_order)
        params = init_schnet(new, torch.Generator().manual_seed(0), "cpu")
        (c, c2, _), = attach_cheb_fit(params, new)["cheb_fit"]
        assert (c.shape[0], c2.shape[0]) == (new.cheb_order,
                                             resolved_order_deriv(new))


def test_gaussian_basis_trainable_matches_jax():
    """A metadata flag, as in the JAX package; the native reader keeps it,
    and a JAX native model file keeps the config's reference fields."""
    cfg, jcfg = GaussianBasisConfig(4.0, 9, True), JGaussianBasisConfig(
        4.0, 9, True)
    assert (cfg.trainable, cfg.num_rbf, _default(cfg.cutoff)) == (
        jcfg.trainable, jcfg.num_rbf, _default(jcfg.cutoff))
    assert GaussianBasisConfig().trainable is False
    obj = cio._NativeUnpickler(io.BytesIO(pickle.dumps(jcfg))).load()
    assert cio._from_jax(obj) == cfg


def test_native_files_keep_the_reference_fields(tmp_path):
    jcfg = JSchNetConfig(hidden_channels=8, num_filters=8, num_rbf=5,
                         embedding_size=4, output_hidden_layer_widths=(8,),
                         num_interactions=1, max_num_neighbors=32)
    params = jinit_schnet(jax.random.PRNGKey(0), jcfg)
    jcio.save_native_model(JForceField(schnet_params=params, priors={},
                                       schnet_config=jcfg),
                           str(tmp_path / "jax.pkl"))
    ff = cio.load_native_model(str(tmp_path / "jax.pkl"), device="cpu")
    cfg = ff.schnet_config
    assert (cfg.max_num_neighbors, cfg.aggr, cfg.message_passing,
            cfg.cheb_order_deriv) == (32, "add", "xla", None)
    cio.save_native_model(ff, str(tmp_path / "port.pkl"))
    again = cio.load_native_model(str(tmp_path / "port.pkl"), device="cpu")
    assert again.schnet_config == cfg


# ---------------------------------------------------------------------------
# self_interaction
# ---------------------------------------------------------------------------


def _pos(seed=0, s=S, width=6.0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, width, (s, A, 3)).astype(np.float32)


def _assert_same_list(port, ref):
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.n_max.numpy(), np.asarray(ref.n_max))
    if ref.shifts is not None:
        np.testing.assert_allclose(port.shifts.numpy(),
                                   np.asarray(ref.shifts), atol=1e-5)


@pytest.mark.parametrize("layout", ["open", "cell", "images"])
def test_self_interaction_lists_match_jax(layout):
    """The self pairs at d = 0 enter the list; under image replication the
    zero-shift self pair is the only one left out without
    self_interaction. Positional binding as in the JAX package."""
    pos = _pos()
    cell = images = None
    if layout == "cell":
        cell = np.eye(3, dtype=np.float32) * 9.0
    elif layout == "images":
        cell = np.eye(3, dtype=np.float32) * 3.0
        images = jnl.compute_image_shifts(cell, RCUT)
    for self_interaction in (True, False):
        ref = jnl.batched_radius_neighbor_matrix(
            jnp.asarray(pos), RCUT, 3 * K,
            None if cell is None else jnp.asarray(cell), self_interaction,
            images=images)
        port = nl.batched_radius_neighbor_matrix(
            torch.tensor(pos), RCUT, 3 * K,
            None if cell is None else torch.tensor(cell), self_interaction,
            images=images)
        _assert_same_list(port, ref)
        one = nl.radius_neighbor_matrix(
            torch.tensor(pos[0]), RCUT, 3 * K,
            None if cell is None else torch.tensor(cell), self_interaction,
            images=images)
        _assert_same_list(one, jax.tree.map(lambda t: t[0], ref))
        rows = torch.arange(A)[:, None]
        self_slots = (port.idx == rows) & port.mask
        if layout == "images":
            zero = (port.shifts.abs().sum(-1) == 0) & self_slots
            assert bool(zero.any(-1).all()) == self_interaction
        else:
            assert bool(self_slots.any(-1).all()) == self_interaction
            assert bool(self_slots.any()) == self_interaction


def _jax_field(message_passing):
    jcfg = JSchNetConfig(
        hidden_channels=F, embedding_size=6, num_filters=F, num_rbf=R,
        num_interactions=2, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), message_passing=message_passing)
    params = jinit_schnet(jax.random.PRNGKey(5), jcfg)
    return JForceField(schnet_params=params, priors={}, schnet_config=jcfg,
                       neighbor_capacity=K)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("message_passing", ["xla", "pallas"])
def test_self_inclusive_list_forces(message_passing):
    """The field on a self-inclusive list. JAX's xla forces are NaN there
    (the square root's derivative at d = 0: a reference fault the port
    does not copy): the port's xla energies are held against JAX's xla
    ones and its forces against JAX's pallas path, which clamps d. The
    port's pallas twins against JAX's pallas path on the same list."""
    pos = _pos(3)
    types = np.random.default_rng(4).integers(0, 6, A)
    jff = _jax_field("pallas")
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, jff.schnet_params), {},
        {**{f.name: getattr(jff.schnet_config, f.name)
            for f in dataclasses.fields(jff.schnet_config)},
         "message_passing": message_passing},
        device="cpu", neighbor_capacity=K)
    jnbr = jnl.batched_radius_neighbor_matrix(jnp.asarray(pos), RCUT, K,
                                              None, True)
    nbr = nl.batched_radius_neighbor_matrix(torch.tensor(pos), RCUT, K,
                                            None, True)
    assert bool(((nbr.idx == torch.arange(A)[:, None]) & nbr.mask).any())
    e, f, _ = compute_energy_forces(ff, torch.tensor(pos),
                                    torch.tensor(types), nbr)
    je, jf = jcompute_energy_forces(jff, jnp.asarray(pos),
                                    jnp.asarray(types), jnbr)[:2]
    assert np.isfinite(f.numpy()).all()
    assert _rel(f.numpy(), jf) <= 1e-4
    assert _rel(e.numpy(), je) <= 1e-5
    if message_passing == "xla":
        jx = jff.replace(schnet_config=dataclasses.replace(
            jff.schnet_config, message_passing="xla"))
        jxe, jxf = jcompute_energy_forces(jx, jnp.asarray(pos),
                                          jnp.asarray(types), jnbr)[:2]
        assert _rel(e.numpy(), jxe) <= 1e-5
        assert not np.isfinite(np.asarray(jxf)).all()


# ---------------------------------------------------------------------------
# cell_shifts
# ---------------------------------------------------------------------------


def test_geometry_cell_shifts_match_jax():
    """Distances add the shifts; the angle helpers take them and read
    nothing of them, as in the JAX package. The priors module re-exports
    the same functions."""
    from flashmd_tpu_torch.prior import priors

    pos = _pos(5)
    rng = np.random.default_rng(6)
    pairs = rng.integers(0, A, (2, 11))
    triples = rng.integers(0, A, (3, 7))
    shifts = rng.normal(size=(S, 11, 3)).astype(np.float32)
    tshifts = rng.normal(size=(S, 7, 3)).astype(np.float32)
    d = geo.compute_distances(torch.tensor(pos), torch.tensor(pairs),
                              torch.tensor(shifts))
    for s in range(S):
        ref = jgeo.compute_distances(jnp.asarray(pos[s]), jnp.asarray(pairs),
                                     jnp.asarray(shifts[s]))
        np.testing.assert_allclose(d[s].numpy(), np.asarray(ref), rtol=1e-6)
    for fn in ("compute_angles_raw", "compute_angles_cos"):
        got = getattr(geo, fn)(torch.tensor(pos), torch.tensor(triples),
                               torch.tensor(tshifts))
        plain = getattr(geo, fn)(torch.tensor(pos), torch.tensor(triples))
        assert torch.equal(got, plain)
        for s in range(S):
            ref = getattr(jgeo, fn)(jnp.asarray(pos[s]),
                                    jnp.asarray(triples),
                                    jnp.asarray(tshifts[s]))
            np.testing.assert_allclose(got[s].numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-6)
        assert getattr(priors, fn) is getattr(geo, fn)
    assert priors.compute_distances is geo.compute_distances
