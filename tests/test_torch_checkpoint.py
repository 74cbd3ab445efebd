"""Port parity for checkpoint ingestion (flashmd_tpu_torch/models/
checkpoint_io.py, models/frontier.py, the activations and TypesMLP heads
of models/mlp.py and models/schnet.py) against the JAX package.

Every case writes its inputs with ``tests/helpers/synthetic_checkpoint.py``
(the reference's pickled module layout, written with torch alone) and
reads them with both packages. Tolerances:
  * extraction: the numpy trees, tables, configs and structures equal
    (atol 0);
  * fp32 xla forces: 1e-6 of max|F| (summation order), as
    tests/test_torch_xla.py; energies in float64 against the helper's
    float64 ground truths at rtol 1e-9, as tests/models/test_checkpoint_io.py;
  * MLPs: 1e-6 (fp32), 2e-3 (bf16) of max|y|.
The default (cheb) conversion and its frontier: tests/test_torch_frontier.py.
"""

import collections
import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import checkpoint_io as jcio
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.mlp import init_mlp as jinit_mlp
from flashmd_tpu.models.mlp import init_types_mlp as jinit_types_mlp
from flashmd_tpu.models.mlp import mlp_apply as jmlp_apply
from flashmd_tpu.models.mlp import types_mlp_apply as jtypes_mlp_apply
from flashmd_tpu.native import max_neighbor_count as jmax_neighbor_count
from flashmd_tpu_torch.data.system import validate_term_list
from flashmd_tpu_torch.models import checkpoint_io as cio
from flashmd_tpu_torch.models.cheb import attach_cheb_fit
from flashmd_tpu_torch.models.convert import _tree_to_torch
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.mlp import (
    init_types_mlp,
    mlp_apply,
    types_mlp_apply,
)
from flashmd_tpu_torch.ops.neighborlist import max_neighbor_count
from tests.helpers import synthetic_checkpoint as sc
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = sc.A
VARIANTS = {
    "plain": {},
    "energy_out": {"entry_wrapper": "energy"},
    "types_mlp_shared": {"output_network": "types_mlp_shared"},
    "types_mlp_species": {"output_network": "types_mlp_species"},
    "exc_pairs": {"exc_pairs": np.array([[0, 1, 2], [3, 4, 5]])},
    "sparse_priors": {"sparse_priors": True},
    "general_priors": {"general_priors": True},
}
FORCE_TOL = 1e-6


@pytest.fixture(autouse=True)
def _float32_jax():
    """JAX at its default 32-bit types during each test, whatever another
    test file of the same process set (some enable x64 at import)."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _rel(out, ref):
    out = out.detach().cpu().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """variant -> the helper's output, each in its own directory."""
    return {name: sc.build_synthetic_checkpoint(
                tmp_path_factory.mktemp(name), **kw)
            for name, kw in VARIANTS.items()}


def _load_both(info):
    return (cio.load_reference_checkpoint(info["model_path"]),
            cio.load_reference_configurations(info["structures_path"]),
            jcio.load_reference_checkpoint(info["model_path"]),
            jcio.load_reference_configurations(info["structures_path"]))


def _assert_tree_equal(port, ref, where="params"):
    if isinstance(ref, dict):
        assert set(port) == set(ref), where
        for k in ref:
            _assert_tree_equal(port[k], ref[k], f"{where}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert len(port) == len(ref), where
        for i, (p, r) in enumerate(zip(port, ref)):
            _assert_tree_equal(p, r, f"{where}[{i}]")
    else:
        assert port.dtype == np.asarray(ref).dtype, where
        np.testing.assert_array_equal(port, np.asarray(ref), err_msg=where)


def _assert_config_equal(cfg, jcfg):
    """Every field of the port's config equals the reference config's
    field of that name (envelopes by class and fields)."""
    for f in dataclasses.fields(cfg):
        port, ref = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("cutoff", "rbf_cutoff"):
            assert type(port).__name__ == type(ref).__name__
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        else:
            assert port == ref, f.name


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_extraction_matches_jax(written, variant):
    ref, cfgs, jref, jcfgs = _load_both(written[variant])
    _assert_tree_equal(ref.schnet_params, jref.schnet_params)
    _assert_config_equal(ref.schnet_config, jref.schnet_config)
    assert len(ref.priors) == len(jref.priors)
    for p, jp in zip(ref.priors, jref.priors):
        assert (p.kind, p.name, p.order, p.n_degs) == (
            jp.kind, jp.name, jp.order, jp.n_degs)
        _assert_tree_equal(p.tables, jp.tables, p.name)
    assert len(cfgs) == len(jcfgs) == 2
    for c, jc in zip(cfgs, jcfgs):
        for f in ("pos", "atom_types", "masses", "velocities", "cell",
                  "exc_pair_index"):
            a, b = getattr(c, f), getattr(jc, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        assert c.tag == jc.tag
        assert set(c.neighbor_lists) == set(jc.neighbor_lists)
        for k, tl in c.neighbor_lists.items():
            jtl = jc.neighbor_lists[k]
            assert validate_term_list(tl)
            np.testing.assert_array_equal(tl.index_mapping,
                                          jtl.index_mapping)
            assert (tl.tag, tl.order, tl.rcut, tl.self_interaction) == (
                jtl.tag, jtl.order, jtl.rcut, jtl.self_interaction)


def _port_forces(ff, info, dtype=torch.float32):
    pos = torch.tensor(info["pos"], dtype=dtype)[None]
    return compute_energy_forces(ff, pos, torch.tensor(info["types"]))


def _jax_forces(jff, info):
    pos = jnp.asarray(info["pos"], jnp.float32)[None]
    return jcompute_energy_forces(jff, pos,
                                  jnp.asarray(info["types"], jnp.int32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fp32_forces_match_jax(written, variant):
    info = written[variant]
    ref, cfgs, jref, jcfgs = _load_both(info)
    ff = cio.build_forcefield(ref, cfgs[0], optimize=False, device="cpu")
    jff = jcio.build_forcefield(jref, jcfgs[0], optimize=False)
    assert ff.neighbor_capacity == jff.neighbor_capacity
    assert set(ff.priors) == set(jff.priors)
    for k, p in ff.priors.items():
        assert p.kind == jff.priors[k].kind
    e, f, comps = _port_forces(ff, info)
    je, jf, jcomps = _jax_forces(jff, info)
    assert _rel(f, jf) <= FORCE_TOL
    assert _rel(e, je) <= FORCE_TOL
    for k in jcomps:
        assert _rel(comps[k], jcomps[k]) <= FORCE_TOL, k


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_float64_energies_match_ground_truth(written, variant):
    info = written[variant]
    ref = cio.load_reference_checkpoint(info["model_path"])
    cfgs = cio.load_reference_configurations(info["structures_path"])
    ff = cio.build_forcefield(ref, cfgs[0], dtype=torch.float64,
                              neighbor_capacity=A, optimize=False,
                              device="cpu")
    _, forces, comps = _port_forces(ff, info, torch.float64)
    np.testing.assert_allclose(float(comps["SchNet"][0]), info["e_schnet"],
                               rtol=1e-9)
    np.testing.assert_allclose(float(comps["bonds"][0]), info["e_bonds"],
                               rtol=1e-9)
    np.testing.assert_allclose(float(comps["repulsion"][0]), info["e_rep"],
                               rtol=1e-9)
    if variant == "general_priors":
        np.testing.assert_allclose(float(comps["cbonds"][0]),
                                   info["e_gbonds"], rtol=1e-9)
        np.testing.assert_allclose(float(comps["cangles"][0]),
                                   info["e_gangles"], rtol=1e-9)
    assert bool(torch.isfinite(forces).all())


@pytest.mark.parametrize("activation", ["tanh", "relu", "silu", "identity"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_activations_match_jax(activation, precision):
    params = jinit_mlp(jax.random.PRNGKey(3), [9, 16, 16, 4])
    x = np.random.default_rng(0).normal(size=(2, 7, 9)).astype(np.float32)
    ref = jmlp_apply(params, jnp.asarray(x), activation, precision)
    out = mlp_apply(_tree_to_torch(jax.tree.map(np.asarray, params), "cpu"),
                    torch.tensor(x), activation, precision)
    tol = 1e-6 if precision == "fp32" else 2e-3
    assert _rel(out, ref) <= tol


@pytest.mark.parametrize("layout", ["shared", "species"])
def test_types_mlp_matches_jax(layout):
    rng = np.random.default_rng(1)
    types = rng.integers(0, 5, 11)
    species = None if layout == "shared" else types
    params = jinit_types_mlp(jax.random.PRNGKey(5), [8, 6, 1],
                             species=species)
    x = rng.normal(size=(3, 11, 8)).astype(np.float32)
    ref = jax.vmap(lambda xs: jtypes_mlp_apply(
        params, xs, jnp.asarray(types), "silu"))(jnp.asarray(x))
    port = {"species": None if species is None
            else torch.tensor(np.asarray(params["species"])),
            "mlps": _tree_to_torch(jax.tree.map(np.asarray,
                                                params["mlps"]), "cpu")}
    out = types_mlp_apply(port, torch.tensor(x), torch.tensor(types), "silu")
    assert out.shape == (3, 11, 1)
    assert _rel(out, ref) <= 1e-6
    # the port's own bank has the reference's layout
    own = init_types_mlp([8, 6, 1], torch.Generator().manual_seed(0), "cpu",
                         species=species)
    assert len(own["mlps"]) == len(params["mlps"])
    if species is not None:
        np.testing.assert_array_equal(own["species"].numpy(),
                                      np.asarray(params["species"]))
    for mine, theirs in zip(own["mlps"][0]["layers"],
                            params["mlps"][0]["layers"]):
        assert {k: tuple(v.shape) for k, v in mine.items()} == {
            k: tuple(v.shape) for k, v in theirs.items()}


def test_unconvertible_entry_is_hard_error(tmp_path):
    info = sc.build_synthetic_checkpoint(
        tmp_path, extra_entries={"mystery": "MysteryPrior"})
    with pytest.raises(ValueError, match="mystery.*not convertible"):
        cio.load_reference_checkpoint(info["model_path"])
    ref = cio.load_reference_checkpoint(info["model_path"],
                                        allow_unconvertible=True)
    jref = jcio.load_reference_checkpoint(info["model_path"],
                                          allow_unconvertible=True)
    assert [p.kind for p in ref.priors] == [p.kind for p in jref.priors]


def test_missing_prior_neighbor_list_is_hard_error(written):
    ref = cio.load_reference_checkpoint(written["plain"]["model_path"])
    cfg = cio.load_reference_configurations(
        written["plain"]["structures_path"])[0]
    del cfg.neighbor_lists["dihedrals"]
    with pytest.raises(ValueError, match="dihedrals.*no matching"):
        cio.build_forcefield(ref, cfg, optimize=False, device="cpu")
    ff = cio.build_forcefield(ref, cfg, optimize=False, device="cpu",
                              allow_missing_priors=True)
    assert set(ff.priors) == {"bonds", "repulsion"}


def test_specialized_tuple_and_single_entries(written, tmp_path):
    """A (model, configurations) tuple reads its model; a bare SchNet and
    a bare prior read as the reference does."""
    sc.make_fake_reference_modules()
    try:
        model = torch.load(written["plain"]["model_path"],
                           weights_only=False)
        torch.save((model, []), tmp_path / "specialized.pt")
        schnet = model.model.models["SchNet"].model
        torch.save(schnet, tmp_path / "schnet.pt")
        torch.save(model.model.models["bonds"].model, tmp_path / "bonds.pt")
    finally:
        sc.unregister_fake_modules()
    for name in ("specialized", "schnet", "bonds"):
        path = str(tmp_path / f"{name}.pt")
        ref, jref = (cio.load_reference_checkpoint(path),
                     jcio.load_reference_checkpoint(path))
        assert (ref.schnet_params is None) == (jref.schnet_params is None)
        if ref.schnet_params is not None:
            _assert_tree_equal(ref.schnet_params, jref.schnet_params)
        assert [(p.kind, p.name) for p in ref.priors] == [
            (p.kind, p.name) for p in jref.priors]


def _repulsion_everywhere(cfg):
    """The structure with a fully connected repulsion list, each pair
    beyond the bonded one in both directions: 72 terms, above 4 A."""
    ii, jj = np.triu_indices(cfg.n_atoms, k=2)
    pairs = np.stack([np.concatenate([ii, jj]), np.concatenate([jj, ii])])
    lists = dict(cfg.neighbor_lists)
    lists["repulsion"] = dataclasses.replace(
        lists["repulsion"], index_mapping=pairs.astype(np.int32))
    return dataclasses.replace(cfg, neighbor_lists=lists)


def test_repulsion_densify_rule_matches_jax(written):
    """A repulsion list above 4 A terms is evaluated densely, as in JAX;
    the helper's own (A - 2 terms) stays a term list."""
    info = written["plain"]
    ref, cfgs, jref, jcfgs = _load_both(info)
    for dense in (False, True):
        cfg, jcfg = cfgs[0], jcfgs[0]
        if dense:
            cfg, jcfg = _repulsion_everywhere(cfg), _repulsion_everywhere(
                jcfg)
        ff = cio.build_forcefield(ref, cfg, optimize=False, device="cpu")
        jff = jcio.build_forcefield(jref, jcfg, optimize=False)
        kind = ff.priors["repulsion"].kind
        assert kind == jff.priors["repulsion"].kind == (
            "repulsion_dense" if dense else "repulsion")
        assert _rel(_port_forces(ff, info)[1], _jax_forces(jff, info)[1]) \
            <= FORCE_TOL


@pytest.mark.parametrize("cell", [None, "cubic", "triclinic"])
def test_max_neighbor_count_with_cell_matches_jax(cell):
    pos = np.random.default_rng(2).uniform(0.0, 9.0, (40, 3))
    cells = {None: None, "cubic": 9.0 * np.eye(3),
             "triclinic": np.array([[9.0, 0, 0], [1.5, 9.0, 0],
                                    [0.5, 1.0, 9.0]])}
    c = cells[cell]
    for rc in (2.0, 3.5, 4.4):
        assert max_neighbor_count(pos, rc, cell=c) == jmax_neighbor_count(
            pos, rc, cell=c)


def test_capacity_rule_matches_jax(written):
    """No capacity given: the max neighbour count at rcut + 1 (minimum
    image under a cell) x 1.35, aligned to 8, at most A."""
    ref, cfgs, jref, jcfgs = _load_both(written["plain"])
    for cell in (None, 6.0 * np.eye(3)):
        c = dataclasses.replace(cfgs[0], cell=cell)
        jc = dataclasses.replace(jcfgs[0], cell=cell)
        ff = cio.build_forcefield(ref, c, optimize=False, device="cpu")
        jff = jcio.build_forcefield(jref, jc, optimize=False)
        assert ff.neighbor_capacity == jff.neighbor_capacity


def test_native_round_trip(written, tmp_path):
    info = written["types_mlp_species"]
    ref = cio.load_reference_checkpoint(info["model_path"])
    cfgs = cio.load_reference_configurations(info["structures_path"])
    cio.save_native_model(ref, str(tmp_path / "ref.pkl"))
    ref2 = cio.load_native_model(str(tmp_path / "ref.pkl"))
    _assert_tree_equal(ref2.schnet_params, ref.schnet_params)
    assert ref2.schnet_config == ref.schnet_config
    for p, q in zip(ref.priors, ref2.priors):
        assert (p.kind, p.name, p.order) == (q.kind, q.name, q.order)
        _assert_tree_equal(q.tables, p.tables)

    ff = cio.build_forcefield(ref, cfgs[0], device="cpu")
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    cio.save_native_model(ff, str(tmp_path / "ff.pkl"))
    ff2 = cio.load_native_model(str(tmp_path / "ff.pkl"), device="cpu")
    assert ff2.schnet_config == ff.schnet_config
    assert ff2.neighbor_capacity == ff.neighbor_capacity
    assert torch.equal(_port_forces(ff2, info)[1], _port_forces(ff, info)[1])

    cio.save_native_configurations(cfgs, str(tmp_path / "structures.pkl"))
    cfgs2 = cio.load_native_configurations(str(tmp_path / "structures.pkl"))
    for c, c2 in zip(cfgs, cfgs2):
        np.testing.assert_array_equal(c.pos, c2.pos)
        np.testing.assert_array_equal(c.atom_types, c2.atom_types)
        assert c.neighbor_lists.keys() == c2.neighbor_lists.keys()
        for k in c.neighbor_lists:
            np.testing.assert_array_equal(
                c.neighbor_lists[k].index_mapping,
                c2.neighbor_lists[k].index_mapping)


def test_jax_native_files_are_refused(written, tmp_path):
    """A native file of the JAX package is read without importing any of
    its classes (the same ReferenceModel and configurations as the port
    reads from the checkpoint itself); a file naming any other class of
    either package, or any other global, is refused by name."""
    info = written["plain"]
    ref, cfgs, jref, jcfgs = _load_both(info)
    jcio.save_native_model(jref, str(tmp_path / "jax_model.pkl"))
    jcio.save_native_configurations(jcfgs, str(tmp_path / "jax_structures.pkl"))
    ref2 = cio.load_native_model(str(tmp_path / "jax_model.pkl"))
    _assert_tree_equal(ref2.schnet_params, ref.schnet_params)
    assert ref2.schnet_config == ref.schnet_config
    assert len(ref2.priors) == len(ref.priors)
    for p, q in zip(ref.priors, ref2.priors):
        assert (q.kind, q.name, q.order, q.n_degs) == (
            p.kind, p.name, p.order, p.n_degs)
        _assert_tree_equal(q.tables, p.tables, p.name)
    cfgs2 = cio.load_native_configurations(str(tmp_path / "jax_structures.pkl"))
    assert len(cfgs2) == len(cfgs)
    for c, c2 in zip(cfgs, cfgs2):
        np.testing.assert_array_equal(c2.pos, c.pos)
        np.testing.assert_array_equal(c2.atom_types, c.atom_types)
        np.testing.assert_array_equal(c2.exc_pair_index, c.exc_pair_index)
    for name, obj in (("collections.OrderedDict", collections.OrderedDict()),
                      ("flashmd_tpu.models.checkpoint_io.build_forcefield",
                       jcio.build_forcefield)):
        with open(tmp_path / "other.pkl", "wb") as f:
            pickle.dump({"format": cio.NATIVE_MODEL_FORMAT, "x": obj}, f)
        with pytest.raises(pickle.UnpicklingError, match=f"refusing {name}"):
            cio.load_native_model(str(tmp_path / "other.pkl"))


def _with_activation(info, path, activation):
    """The helper's checkpoint with every Tanh module replaced."""
    sc.make_fake_reference_modules()
    try:
        model = torch.load(info["model_path"], weights_only=False)
        for mod in model.modules():
            for name, child in list(mod.named_children()):
                if isinstance(child, torch.nn.Tanh):
                    setattr(mod, name, activation())
        torch.save(model, path)
    finally:
        sc.unregister_fake_modules()
    return str(path)


@pytest.mark.parametrize("activation", [torch.nn.SiLU, torch.nn.ReLU],
                         ids=["silu", "relu"])
def test_non_tanh_checkpoint_routes_to_xla(written, tmp_path, activation):
    """Reference fault 4: a non-tanh checkpoint with a zero-lower cosine
    cutoff is routed to cheb by the reference's optimize=True, whose host
    fit then refuses it. The port routes it to the exact xla path, where
    it runs and matches the reference's own xla evaluation."""
    info = written["plain"]
    path = _with_activation(info, tmp_path / "model_and_prior.pt",
                            activation)
    name = activation.__name__.lower()
    jref = jcio.load_reference_checkpoint(path)
    jcfgs = jcio.load_reference_configurations(info["structures_path"])
    assert jref.schnet_config.activation == name
    assert jcio.optimized_schnet_config(
        jref.schnet_config).message_passing == "cheb"
    with pytest.raises(NotImplementedError, match="tanh"):
        jcio.build_forcefield(jref, jcfgs[0])

    ref = cio.load_reference_checkpoint(path)
    cfgs = cio.load_reference_configurations(info["structures_path"])
    assert ref.schnet_config.activation == name
    ff = cio.build_forcefield(ref, cfgs[0], device="cpu")
    assert (ff.schnet_config.message_passing,
            ff.schnet_config.precision) == ("xla", "fp32")
    with pytest.raises(NotImplementedError, match="activation"):
        dataclasses.replace(ff.schnet_config, message_passing="cheb")
    jff = jcio.build_forcefield(jref, jcfgs[0], optimize=False)
    _, f, _ = _port_forces(ff, info)
    _, jf, _ = _jax_forces(jff, info)
    assert _rel(f, jf) <= FORCE_TOL
