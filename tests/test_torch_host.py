"""Port parity of the host utilities (ROADMAP A18): the key registry, the
host cell-list radius engine (flashmd_tpu_torch/native), the edge and term
lists of ops/neighborlist.py, prior sparsification and fitting, the ASE
converter, the Hub loader, the trajectory renderer and the package
re-exports, each against its flashmd_tpu counterpart on the same inputs.

Tolerances: none. Keys, counts, pairs, edges, term sets, tables, the
fitted parameters and the checkpoint trees are compared exactly, and a
run through the package root's names bitwise with the same run through
the module paths.

The JAX package's C++ engine sizes its cells ``floor(span / rcut) + 1``
per axis, which can make them narrower than rcut, so its 27-cell stencil
misses pairs on dense inputs (22 of 3,000 atoms undercounted at 30 A /
4 A). The port's copy makes every cell at least rcut wide; it equals the
numpy twins of both packages everywhere, and the JAX engine wherever that
one is exact (the JAX suite's own inputs).
"""

import ast
import dataclasses
import importlib
import os
import sys
import types

import numpy as np
import pytest
import torch

import flashmd_tpu_torch as fm
from flashmd_tpu_torch import native
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.simulation import LangevinSimulation
from tests.test_torch_mesh import chain_configs, chain_ff
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_keys_equal_jax():
    from flashmd_tpu.data import keys as jkeys
    from flashmd_tpu_torch.data import keys

    names = [n for n in vars(jkeys) if n.isupper()]
    assert len(names) > 20
    for n in names:
        assert getattr(keys, n) == getattr(jkeys, n), n
    assert [n for n in vars(keys) if n.isupper()] == names


# ---------------------------------------------------------------------------
# The radius engine
# ---------------------------------------------------------------------------

def _cloud(n, box, seed):
    return np.random.default_rng(seed).uniform(0, box, (n, 3))


INPUTS = {
    # (positions, rcut, cell)
    "jax_suite_open": (_cloud(300, 20.0, 0), 3.0, None),
    "dense_open": (_cloud(3000, 30.0, 1), 4.0, None),
    "cubic": (_cloud(2000, 25.0, 2), 3.0, np.diag([25.0, 25.0, 25.0])),
    "triclinic": (_cloud(1500, 20.0, 3), 3.0,
                  np.array([[20.0, 0, 0], [3.0, 20.0, 0], [1.0, 2.0, 20.0]])),
}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_native_counts_equal_numpy_twins(name):
    from flashmd_tpu.native import _counts_numpy as jcounts_numpy

    pos, rcut, cell = INPUTS[name]
    got = native.neighbor_counts(pos, rcut, cell)
    np.testing.assert_array_equal(got, native.neighbor_counts(
        pos, rcut, cell, native=False))
    np.testing.assert_array_equal(got, jcounts_numpy(pos, rcut, cell))
    assert native.max_neighbor_count(pos, rcut, cell) == got.max()


@pytest.mark.parametrize("name", ["jax_suite_open", "dense_open"])
def test_native_pairs_equal_numpy_twin_in_order(name):
    pos, rcut, _ = INPUTS[name]
    src, dst = native.radius_pairs(pos, rcut)
    tsrc, tdst = native.radius_pairs(pos, rcut, native=False)
    np.testing.assert_array_equal(src, tsrc)
    np.testing.assert_array_equal(dst, tdst)
    assert src.dtype == dst.dtype == np.int64
    np.testing.assert_array_equal(np.bincount(src, minlength=len(pos)),
                                  native.neighbor_counts(pos, rcut))


def test_native_equals_jax_engine_where_that_is_exact():
    from flashmd_tpu.native import neighbor_counts as jcounts
    from flashmd_tpu.native import radius_pairs as jpairs

    for name in ("jax_suite_open", "cubic", "triclinic"):
        pos, rcut, cell = INPUTS[name]
        np.testing.assert_array_equal(native.neighbor_counts(pos, rcut, cell),
                                      jcounts(pos, rcut, cell))
    pos, rcut, _ = INPUTS["jax_suite_open"]
    js, jd = jpairs(pos, rcut)
    src, dst = native.radius_pairs(pos, rcut)
    assert set(zip(js.tolist(), jd.tolist())) == set(zip(src.tolist(),
                                                         dst.tolist()))


def test_jax_engine_cell_width_fault_not_copied():
    """The JAX engine undercounts the dense cloud; the port does not."""
    from flashmd_tpu.native import _counts_numpy as jcounts_numpy
    from flashmd_tpu.native import native_available as jnative_available
    from flashmd_tpu.native import neighbor_counts as jcounts

    pos, rcut, _ = INPUTS["dense_open"]
    want = jcounts_numpy(pos, rcut)
    if jnative_available():
        assert (jcounts(pos, rcut) < want).any()
    np.testing.assert_array_equal(native.neighbor_counts(pos, rcut), want)


def test_native_edge_cases():
    one = np.zeros((1, 3))
    assert native.max_neighbor_count(one, 2.0) == 0
    assert native.radius_pairs(one, 2.0)[0].size == 0
    two = np.array([[0.0, 0, 0], [0.5, 0, 0]])  # zero span along y and z
    np.testing.assert_array_equal(native.neighbor_counts(two, 1.0), [1, 1])
    with pytest.raises(ValueError, match="Singular cell"):
        native.neighbor_counts(two, 1.0, cell=np.zeros((3, 3)))
    with pytest.raises(ValueError, match=r"\[A, 3\]"):
        native.neighbor_counts(np.zeros((4, 2)), 1.0)


def test_native_selection_and_build():
    assert native.native_available()
    assert native.library_path().exists()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    from flashmd_tpu_torch.ops import neighborlist

    assert neighborlist.max_neighbor_count is native.max_neighbor_count


def test_no_native_env_takes_numpy(monkeypatch):
    monkeypatch.setenv("FLASHMD_NO_NATIVE", "1")
    assert not native.native_available()
    assert not native.use_native() and native.use_native(True)
    monkeypatch.setattr(native, "load", lambda: pytest.fail("built"))
    pos, rcut, _ = INPUTS["jax_suite_open"]
    assert native.max_neighbor_count(pos, rcut) > 0


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "radius.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.library_path.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g[+][+] failed.*\n.*error"):
            native.neighbor_counts(np.zeros((2, 3)), 1.0)
    finally:
        monkeypatch.undo()
        native.library_path.cache_clear()
    # the numpy twin stays available on request
    np.testing.assert_array_equal(
        native.neighbor_counts(np.zeros((2, 3)), 1.0, native=False), [1, 1])


# ---------------------------------------------------------------------------
# Edge and term lists
# ---------------------------------------------------------------------------

def test_neighbor_matrix_to_edges_equals_jax():
    import jax.numpy as jnp

    from flashmd_tpu.ops.neighborlist import (
        neighbor_matrix_to_edges as jedges,
    )
    from flashmd_tpu.ops.neighborlist import (
        radius_neighbor_matrix as jradius,
    )
    from flashmd_tpu_torch.ops import (
        EdgeList,
        neighbor_matrix_to_edges,
        radius_neighbor_matrix,
    )

    pos = _cloud(40, 8.0, 5)
    nm = radius_neighbor_matrix(torch.as_tensor(pos, dtype=torch.float32),
                                3.0, 16)
    jnm = jradius(jnp.asarray(pos, jnp.float32), 3.0, 16)
    np.testing.assert_array_equal(nm.idx.numpy(), np.asarray(jnm.idx))
    edges, jedge = neighbor_matrix_to_edges(nm), jedges(jnm)
    assert isinstance(edges, EdgeList)
    for f in EdgeList._fields:
        np.testing.assert_array_equal(getattr(edges, f).numpy(),
                                      np.asarray(getattr(jedge, f)), f)
    assert edges.receivers.dtype == torch.int32


@pytest.mark.parametrize("self_interaction", [False, True])
def test_configuration2term_list_gives_jax_terms(self_interaction):
    from flashmd_tpu.ops.neighborlist import (
        configuration2term_list as jterms,
    )
    from flashmd_tpu_torch.ops import configuration2term_list

    pos = _cloud(200, 15.0, 6)
    got = configuration2term_list(torch.as_tensor(pos), 3.0,
                                  self_interaction=self_interaction)
    want = jterms(pos, 3.0, self_interaction=self_interaction)
    assert (got.tag, got.order, got.rcut, got.self_interaction) == (
        want.tag, want.order, want.rcut, want.self_interaction)
    assert got.index_mapping.dtype == np.asarray(want.index_mapping).dtype
    assert set(map(tuple, got.index_mapping.T.tolist())) == set(
        map(tuple, np.asarray(want.index_mapping).T.tolist()))
    assert got.n_terms == want.n_terms


# ---------------------------------------------------------------------------
# Priors: sparsify and fitting
# ---------------------------------------------------------------------------

def test_sparsify_repulsion_equals_jax_on_a_carried_prior():
    import jax

    from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
    from flashmd_tpu.prior.sparsify import sparsify_repulsion as jsparsify
    from flashmd_tpu_torch.models.convert import forcefield_from_numpy
    from flashmd_tpu_torch.prior import sparsify_repulsion
    from flashmd_tpu_torch.prior.priors import densify_repulsion

    jff, _ = jcgschnet(n_atoms=24, batch_size=1, num_interactions=1,
                       precision="fp32", neighbor_capacity=24)
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, dict(jff.schnet_params)),
        jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)}, device="cpu")
    dense = ff.priors["repulsion"]
    assert dense.kind == "repulsion_dense"
    got, want = sparsify_repulsion(dense), jsparsify(jff.priors["repulsion"])
    np.testing.assert_array_equal(got.index_mapping.numpy(),
                                  np.asarray(want.index_mapping))
    np.testing.assert_array_equal(got.params["sigma"].numpy(),
                                  np.asarray(want.params["sigma"]))
    assert (got.kind, got.name, got.feature) == (want.kind, want.name,
                                                 want.feature)
    back = densify_repulsion(got, 24)
    assert torch.equal(back.params["sigma6"], dense.params["sigma6"])
    with pytest.raises(ValueError, match="repulsion_dense"):
        sparsify_repulsion(got)


@pytest.mark.parametrize("shape,order", [((5, 5), None), ((4, 4, 4, 3), 3)])
def test_tables_equal_jax(shape, order):
    from flashmd_tpu.prior.sparsify import sparse_to_table as jto_table
    from flashmd_tpu.prior.sparsify import table_to_sparse as jto_sparse
    from flashmd_tpu_torch.prior import sparse_to_table, table_to_sparse

    rng = np.random.default_rng(7)
    lead = shape[:order or len(shape)]
    table = np.zeros(shape)
    present = rng.uniform(size=lead) < 0.3
    table[present] = rng.normal(size=(present.sum(),)
                                + shape[len(lead):])
    idx, vals = table_to_sparse(table, order)
    jidx, jvals = jto_sparse(table, order)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)
    back = sparse_to_table(idx, vals, shape)
    np.testing.assert_array_equal(back, jto_table(jidx, jvals, shape))
    np.testing.assert_array_equal(back, table)


def _fit_inputs():
    rng = np.random.default_rng(8)
    x = np.linspace(0.5, 2.5, 200)
    theta = np.linspace(-np.pi, np.pi, 300)
    return {
        "harmonic": (x, 55.0 * (x - 1.4) ** 2 - 2.0
                     + rng.normal(scale=0.01, size=x.size)),
        "values": (rng.uniform(1.0, 5.0, 5000),),
        "bins": (np.linspace(2.0, 8.0, 20),),
        "fourier": (theta, 0.3 + 0.8 * np.sin(theta) - 0.4 * np.sin(3 * theta)
                    + 0.5 * np.cos(2 * theta)
                    + rng.normal(scale=0.02, size=theta.size)),
    }


def test_fits_equal_jax_bitwise():
    from flashmd_tpu.prior import fitting as jfit
    from flashmd_tpu_torch.prior import fitting

    args = _fit_inputs()
    calls = [
        ("fit_harmonic_from_potential_estimates", args["harmonic"], {}),
        ("fit_repulsion_from_values", args["values"], {}),
        ("fit_repulsion_from_values", args["values"], {"cutoff": 3.0}),
        ("fit_repulsion_from_potential_estimates", args["bins"], {}),
        ("fit_fourier_from_potential_estimates", args["fourier"], {}),
        ("fit_fourier_from_potential_estimates", args["fourier"],
         {"metric": "r2"}),
        ("fit_fourier_from_potential_estimates", args["fourier"],
         {"constrain_deg": 2}),
    ]
    for name, a, kw in calls:
        got, want = getattr(fitting, name)(*a, **kw), getattr(jfit, name)(
            *a, **kw)
        assert got == want, name
    theta = args["fourier"][0]
    np.testing.assert_array_equal(
        fitting.fourier_compute_np(theta, 0.1, [0.2, 0.3], [0.4, 0.5]),
        jfit.fourier_compute_np(theta, 0.1, [0.2, 0.3], [0.4, 0.5]))


# ---------------------------------------------------------------------------
# ASE, the Hub, the renderer
# ---------------------------------------------------------------------------

class _FakeAtoms:
    """The ``ase.Atoms`` surface the converters call (ase is absent)."""

    def __init__(self, pos, numbers, masses, cell=None, pbc=False,
                 symbols="H2O"):
        self._pos, self._numbers, self._masses = pos, numbers, masses
        self._cell = cell
        self.pbc = np.asarray([pbc] * 3)
        self.symbols = symbols

    def get_positions(self):
        return np.asarray(self._pos)

    def get_atomic_numbers(self):
        return np.asarray(self._numbers)

    def get_masses(self):
        return np.asarray(self._masses)

    def get_cell(self):
        return self._cell


@pytest.mark.parametrize("pbc", [False, True])
def test_ase2configuration_equals_jax(pbc):
    from flashmd_tpu.data.ase_io import ase2configuration as jase2cfg
    from flashmd_tpu_torch.data.ase_io import ase2configuration

    atoms = _FakeAtoms(_cloud(4, 12.0, 9), [6, 6, 8, 1],
                       [12.0, 12.0, 16.0, 1.0],
                       cell=np.diag([12.0, 13.0, 14.0]), pbc=pbc,
                       symbols="C2OH")
    got, want = ase2configuration(atoms), jase2cfg(atoms)
    assert isinstance(got, Configuration)
    for f in ("pos", "atom_types", "masses", "cell"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, f)
            assert a.dtype == b.dtype, f
    assert got.tag == want.tag == "C2OH"


def _tree_equal(a, b):
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        for f in dataclasses.fields(a):
            _tree_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert a == b


@pytest.fixture(scope="module")
def hub_ckpt(tmp_path_factory):
    from tests.helpers.synthetic_checkpoint import build_synthetic_checkpoint

    return build_synthetic_checkpoint(tmp_path_factory.mktemp("hub"))


@pytest.fixture
def fake_hf(monkeypatch, hub_ckpt):
    calls = []

    def hf_hub_download(repo_id, filename, cache_dir=None, revision=None):
        calls.append(dict(repo_id=repo_id, filename=filename,
                          cache_dir=cache_dir, revision=revision))
        return str(hub_ckpt["model_path"] if filename == "model_and_prior.pt"
                   else hub_ckpt["structures_path"])

    mod = types.ModuleType("huggingface_hub")
    mod.hf_hub_download = hf_hub_download
    monkeypatch.setitem(sys.modules, "huggingface_hub", mod)
    return calls


def test_from_pretrained_reads_the_checkpoint(fake_hf, hub_ckpt):
    from flashmd_tpu_torch import hub
    from flashmd_tpu_torch.models.checkpoint_io import (
        ReferenceModel,
        load_reference_checkpoint,
    )

    ref = hub.from_pretrained(repo_id="someone/cg-model", revision="abc")
    assert isinstance(ref, ReferenceModel) and ref.schnet_params is not None
    _tree_equal(ref, load_reference_checkpoint(hub_ckpt["model_path"]))
    assert fake_hf == [dict(repo_id="someone/cg-model",
                            filename="model_and_prior.pt", cache_dir=None,
                            revision="abc")]
    path = hub.download_file(filename="1enh_configurations.pt")
    assert path == type(path)(hub_ckpt["structures_path"])
    assert fake_hf[1]["filename"] == "1enh_configurations.pt"


def test_hub_without_the_dependency_says_what_to_install(monkeypatch):
    from flashmd_tpu import hub as jhub
    from flashmd_tpu_torch import hub

    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    for fn, jfn in ((hub.from_pretrained, jhub.from_pretrained),
                    (hub.download_file, jhub.download_file)):
        with pytest.raises(ImportError) as got:
            fn()
        with pytest.raises(ImportError) as want:
            jfn()
        assert str(got.value) == str(want.value)
        assert "huggingface_hub" in str(got.value)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A port Langevin run with two coordinate files."""
    out = tmp_path_factory.mktemp("render")
    ff, cfgs = chain_ff(6), chain_configs(2, 6)
    sim = LangevinSimulation(friction=1.0, dt=5e-3, n_timesteps=40,
                             save_interval=5, export_interval=20,
                             random_seed=3, device="cpu", gptq=None,
                             filename="demo", output_dir=str(out))
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    sim.simulate()
    return str(out / "demo"), sim


def test_load_coords_reads_the_port_files(exported):
    from flashmd_tpu.utils.render import load_coords as jload_coords
    from flashmd_tpu_torch.utils.render import load_coords

    prefix, sim = exported
    coords = load_coords(prefix)
    assert coords.shape == (2, 8, 6, 3)
    np.testing.assert_array_equal(coords, sim.coords)
    np.testing.assert_array_equal(coords, jload_coords(prefix))
    with pytest.raises(FileNotFoundError):
        load_coords(prefix + "_nope")


def test_render_png_gif_and_main(exported, tmp_path):
    pytest.importorskip("matplotlib")
    from flashmd_tpu_torch.utils.render import (
        load_coords,
        main,
        render_gif,
        render_png,
    )

    prefix, _ = exported
    coords = load_coords(prefix)
    png = render_png(coords, str(tmp_path / "f.png"), sim=1, frame=-1)
    gif = render_gif(coords, str(tmp_path / "t.gif"), sim=0, stride=2, fps=4)
    assert (tmp_path / "f.png").stat().st_size > 0
    assert (tmp_path / "t.gif").stat().st_size > 0
    assert png.endswith(".png") and gif.endswith(".gif")
    assert main([prefix, "--png", str(tmp_path / "c.png"), "--frame",
                 "0"]) == 0
    assert (tmp_path / "c.png").exists()
    with pytest.raises(SystemExit):
        main([prefix, "--sim", "9", "--png", str(tmp_path / "x.png")])
    with pytest.raises(SystemExit):
        main([prefix])


def test_render_console_script_is_declared():
    text = open(os.path.join(ROOT, "pyproject.toml")).read()
    assert ('flashmd-torch-render = "flashmd_tpu_torch.utils.render:main"'
            in text)


# ---------------------------------------------------------------------------
# Package re-exports
# ---------------------------------------------------------------------------

# The JAX package's public names that the port deliberately does not have:
# an XLA precision helper (the port fixes TF32 off in
# flashmd_tpu_torch/__init__.py).
NOT_PORTED = {
    "flashmd_tpu_torch.models.mlp": {"dot_precision"},
}
# Names once on that list that the port now has: the in-graph Chebyshev
# fit and its nodes, beside the host fit's methods.
PORTED_SINCE = {
    "flashmd_tpu_torch.models.cheb": {"fit_chebyshev_filter",
                                      "chebyshev_nodes"},
}


def _init_names(package):
    """The names an ``__init__.py`` imports, a star import expanded."""
    path = os.path.join(ROOT, *package.split("."), "__init__.py")
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "*":
                    mod = importlib.import_module(
                        f"{package}.{node.module}")
                    names |= {n for n in vars(mod) if not n.startswith("_")
                              and n.isupper()}
                else:
                    names.add(alias.asname or alias.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
    return names


@pytest.mark.parametrize("sub", ["", ".data", ".models", ".ops", ".prior",
                                 ".utils", ".simulation", ".parallel"])
def test_init_exports_every_jax_name(sub):
    jnames = _init_names("flashmd_tpu" + sub)
    port = importlib.import_module("flashmd_tpu_torch" + sub)
    missing = {n for n in jnames if not hasattr(port, n)}
    assert not missing, f"flashmd_tpu_torch{sub} lacks {sorted(missing)}"


@pytest.mark.parametrize("module", [
    "hub", "data.keys", "data.ase_io", "native", "ops.neighborlist",
    "prior.sparsify", "prior.fitting", "utils.render", "parallel.mesh"])
def test_module_has_every_jax_public_name(module):
    """The modules of this slice: every public function, class and
    constant that the JAX module defines exists in the port's."""
    jmod = importlib.import_module(f"flashmd_tpu.{module}")
    port = importlib.import_module(f"flashmd_tpu_torch.{module}")
    names = {n for n, v in vars(jmod).items() if not n.startswith("_") and (
        (n.isupper() and not callable(v))
        or getattr(v, "__module__", None) == jmod.__name__)}
    assert names
    missing = {n for n in names if not hasattr(port, n)}
    assert not missing, f"flashmd_tpu_torch.{module} lacks {sorted(missing)}"


@pytest.mark.parametrize("module", sorted({*NOT_PORTED, *PORTED_SINCE}))
def test_deliberately_not_ported_names(module):
    """The names on NOT_PORTED are the JAX module's and not the port's;
    those on PORTED_SINCE are both modules', and the port's config and
    host fit take every fit method of the JAX package."""
    jmod = importlib.import_module(module.replace("flashmd_tpu_torch",
                                                  "flashmd_tpu"))
    port = importlib.import_module(module)
    for name in NOT_PORTED.get(module, ()):
        assert hasattr(jmod, name) and not hasattr(port, name), name
    for name in PORTED_SINCE.get(module, ()):
        assert hasattr(jmod, name) and hasattr(port, name), name
    if module in PORTED_SINCE:
        from flashmd_tpu_torch.models.schnet import SchNetConfig, init_schnet

        for method in ("proj", "wls", "lawson"):
            cfg = SchNetConfig(hidden_channels=4, num_filters=4, num_rbf=5,
                               num_interactions=1, embedding_size=3,
                               output_hidden_layer_widths=(4,),
                               cheb_order=6, cheb_fit_method=method)
            params = init_schnet(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
            c, c2, w0 = port.fit_chebyshev_filter_host(
                params["interactions"][0], params["rbf"], cfg, order=6,
                n_nodes=32)
            assert c.shape == c2.shape == (6, 4) and w0.shape == (4,)


def test_package_import_is_light():
    """Importing the package and every subpackage pulls in no optional
    dependency, no JAX, no process group and builds nothing."""
    import subprocess

    code = (
        "import sys, flashmd_tpu_torch, flashmd_tpu_torch.data, "
        "flashmd_tpu_torch.models, flashmd_tpu_torch.ops, "
        "flashmd_tpu_torch.prior, flashmd_tpu_torch.utils, "
        "flashmd_tpu_torch.parallel.mesh, flashmd_tpu_torch.hub, "
        "flashmd_tpu_torch.data.ase_io, flashmd_tpu_torch.utils.render, "
        "flashmd_tpu_torch.native\n"
        "import torch.distributed as d\n"
        "bad = [m for m in ('matplotlib', 'huggingface_hub', 'ase', 'jax', "
        "'flashmd_tpu') if m in sys.modules]\n"
        "print(bad, d.is_initialized(), "
        "flashmd_tpu_torch.native._loaded)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False {}"


def test_root_names_run_equals_module_paths():
    """A small Langevin run built from the package root's names equals the
    same run built from the module paths, bitwise."""
    from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

    def run(names):
        ff, cfgs = cgschnet_1enh_like(n_atoms=12, batch_size=2,
                                      num_interactions=1, precision="fp32",
                                      message_passing="xla",
                                      neighbor_capacity=12, device="cpu")
        ff = names.ForceField(schnet_params=ff.schnet_params,
                              priors={k: names.Prior(**vars(p))
                                      for k, p in ff.priors.items()},
                              schnet_config=ff.schnet_config,
                              neighbor_capacity=ff.neighbor_capacity)
        cfgs = [names.Configuration(pos=c.pos, atom_types=c.atom_types,
                                    masses=c.masses) for c in cfgs]
        sim = names.LangevinSimulation(friction=1.0, dt=0.004,
                                       n_timesteps=10, save_interval=5,
                                       random_seed=4, device="cpu",
                                       gptq=None)
        sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
        return sim.simulate()

    from flashmd_tpu_torch.data import system
    from flashmd_tpu_torch.models import forcefield
    from flashmd_tpu_torch.prior import priors
    from flashmd_tpu_torch.simulation import langevin

    paths = types.SimpleNamespace(
        ForceField=forcefield.ForceField, Prior=priors.Prior,
        Configuration=system.Configuration,
        LangevinSimulation=langevin.LangevinSimulation)
    np.testing.assert_array_equal(run(fm), run(paths))
    assert fm.ForceField is forcefield.ForceField
    assert fm.LangevinSimulation is langevin.LangevinSimulation
