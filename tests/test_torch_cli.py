"""Port parity of the command line (flashmd_tpu_torch/simulation/cli.py and
scripts.py), its YAML reader and writer (utils/io.py) and its reader of the
JAX package's native files (models/checkpoint_io.py) against the JAX
package, on the zoo's 16-bead, 2-block fp32 model with capacity 8, written
by the JAX package as tests/simulation/test_cli.py writes it. Both packages
parse the same YAML with the same arguments. Tolerances:
  * simulation options, betas, configurations (pos/types/masses), configs,
    native-file contents and the config echo: exact;
  * the attached fp32 xla field's first force evaluation: 1e-5 of max|F|
    (float32 summation order only);
  * the YAML reader: equal to yaml.safe_load; the writer: byte-equal to
    yaml.safe_dump(default_flow_style=False, sort_keys=False) on printable
    ASCII scalars, read back equal by yaml.safe_load on any.
"""

import dataclasses
import math
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from flashmd_tpu.data.system import Configuration as JConfiguration
from flashmd_tpu.models import checkpoint_io as jcio
from flashmd_tpu.models.cheb import attach_cheb_fit as jattach_cheb_fit
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.simulation import cli as jcli
from flashmd_tpu.simulation import scripts as jscripts
from flashmd_tpu.simulation.langevin import (
    LangevinSimulation as JLangevinSimulation,
)
from flashmd_tpu_torch.data.system import Configuration
from flashmd_tpu_torch.models import checkpoint_io as cio
from flashmd_tpu_torch.simulation import cli, scripts
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from flashmd_tpu_torch.utils.io import format_yaml, load_yaml, parse_yaml
from tests.helpers import synthetic_checkpoint as sc
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORCE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX package's native model and structures, a config that names
    them (with a JAX-only option and ``device: cuda``, as a reference
    config has), and the JAX CLI's echo of it."""
    tmp = tmp_path_factory.mktemp("cli")
    jff, jcfgs = jcgschnet(n_atoms=16, batch_size=3, num_interactions=2,
                           precision="fp32", neighbor_capacity=8)
    jcio.save_native_model(jff, str(tmp / "model.pkl"))
    jcio.save_native_configurations(jcfgs, str(tmp / "structures.pkl"))
    cfg = {
        "simulation": {
            "friction": 1.0, "n_timesteps": 40, "dt": 0.002,
            "save_interval": 10, "random_seed": 7, "dtype": "single",
            "filename": "cli_demo", "output_dir": str(tmp / "out"),
            "device": "cuda", "compile_mode": "default",
        },
        "betas": [1.67],
        "model_file": str(tmp / "model.pkl"),
        "structure_file": str(tmp / "structures.pkl"),
    }
    cfg_path = tmp / "config.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    jcli.parse_simulation_config(
        JLangevinSimulation,
        args=["--config", str(cfg_path), "--simulation.filename", "echo"])
    return {"tmp": tmp, "config": cfg_path, "jff": jff, "jcfgs": jcfgs,
            "echo": tmp / "out" / "echo_config.yaml"}


def _parse_both(files, name, extra=(), config=None):
    """Both CLIs on one YAML and one argument list; each run writes under
    its own filename."""
    args = ["--config", str(config or files["config"]),
            "--simulation.device", "cpu", *extra]
    port = cli.parse_simulation_config(
        LangevinSimulation, args=args + ["--simulation.filename",
                                         f"port_{name}"])
    ref = jcli.parse_simulation_config(
        JLangevinSimulation, args=args + ["--simulation.filename",
                                          f"jax_{name}"])
    return port, ref


def _assert_same_options(sim, jsim):
    """Every option both classes take, as the simulations hold it."""
    shared = (set(cli._simulation_kwargs(type(sim)))
              & set(jcli._simulation_kwargs(type(jsim))))
    compared = 0
    for name in sorted(shared - {"device", "filename"}):
        if hasattr(sim, name) and hasattr(jsim, name):
            value, ref = getattr(sim, name), getattr(jsim, name)
            if name == "dtype":  # torch.float32 / jnp.float32
                value, ref = str(value).split(".")[-1], np.dtype(ref).name
            assert value == ref, name
            compared += 1
    assert compared >= 20
    assert sim.device == torch.device("cpu")
    assert os.path.basename(sim.filename).startswith("port_")


def _assert_same_configurations(data, jdata):
    assert len(data) == len(jdata)
    for c, jc in zip(data, jdata):
        for field in ("pos", "atom_types", "masses"):
            np.testing.assert_array_equal(getattr(c, field),
                                          np.asarray(getattr(jc, field)))
        assert c.neighbor_lists.keys() == jc.neighbor_lists.keys()
        for k, tl in c.neighbor_lists.items():
            np.testing.assert_array_equal(
                tl.index_mapping, np.asarray(jc.neighbor_lists[k].index_mapping))


# name -> (arguments, environment): tests/simulation/test_cli.py's cases
PARSE_CASES = {
    "config": ([], {}),
    "overrides": (["--simulation.n_timesteps", "80",
                   "--simulation.save_energies", "true",
                   "--simulation.dt", "1e-3"], {}),
    "trim": (["--batch_size", "2"], {}),
    "duplicate": (["--batch_size", "7"], {}),
    "disable_optim": (["--disable_optim"], {}),
    "mlcg_flag": ([], {"MLCG_USE_CSR": "0"}),
    "message_passing": ([], {"FLASHMD_TPU_MESSAGE_PASSING": "cheb"}),
    "cheb_dmin": ([], {"FLASHMD_TPU_CHEB_DMIN": "1.25"}),
    "cheb_dmin_auto": ([], {"FLASHMD_TPU_CHEB_DMIN": "auto"}),
    "cheb_dmin_auto_disabled": (["--disable_optim"],
                                {"FLASHMD_TPU_CHEB_DMIN": "auto"}),
}


@pytest.mark.parametrize("case", list(PARSE_CASES))
def test_parse_matches_jax(files, case, monkeypatch):
    """The JAX package's own native files and YAML through both CLIs: the
    same options, betas, configurations, model path and fit domain, and
    the same echo apart from the filename."""
    args, env = PARSE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    (model, data, betas, sim, profile), (jmodel, jdata, jbetas, jsim,
                                         jprofile) = _parse_both(
        files, case, args)
    assert (betas, profile) == (jbetas, jprofile) == (1.67, "")
    _assert_same_options(sim, jsim)
    _assert_same_configurations(data, jdata)
    cfg, jcfg = model.schnet_config, jmodel.schnet_config
    assert (cfg.message_passing, cfg.precision, cfg.cheb_d_min) == (
        jcfg.message_passing, jcfg.precision, jcfg.cheb_d_min)
    assert ("cheb_fit" in model.schnet_params) == (
        "cheb_fit" in jmodel.schnet_params)
    if case == "cheb_dmin_auto":
        assert 0.0 < cfg.cheb_d_min < cfg.cutoff.cutoff_upper
    out = files["tmp"] / "out"
    echo = (out / f"port_{case}_config.yaml").read_text()
    assert echo.replace(f"port_{case}", f"jax_{case}") == (
        out / f"jax_{case}_config.yaml").read_text()
    parsed = load_yaml(out / f"port_{case}_config.yaml")
    assert parsed == yaml.safe_load(echo)
    assert parsed["simulation"]["filename"] == f"port_{case}"


def test_first_force_evaluation_matches_jax(files):
    """The native fp32 field attached by both engines: the forces of the
    first step's carry within 1e-5 of max|F|."""
    (model, data, betas, sim, _), (jmodel, jdata, jbetas, jsim, _) = (
        _parse_both(files, "forces", ["--simulation.gptq", "null"]))
    assert sim.gptq is None and jsim.gptq is None
    sim.attach_model_and_configurations(model, data, betas)
    jsim.attach_model_and_configurations(jmodel, jdata, jbetas)
    assert sim.model.schnet_config.precision == "fp32"
    with torch.no_grad():
        f = sim._init_carry(sim.initial_system)["forces"].numpy()
    jf = np.asarray(jax.jit(jsim._init_carry)(
        jsim.initial_system, jax.random.PRNGKey(0))["forces"])
    assert np.abs(f - jf).max() <= FORCE_TOL * np.abs(jf).max()


@pytest.mark.parametrize("mesh", [None, 1, 2, "auto"])
def test_jax_only_options_warn(files, tmp_path, mesh, caplog):
    """The compile options are accepted and do nothing, as in the JAX
    package: a YAML that sets ``compile_mode`` runs with no unknown-option
    warning, and ``--simulation.compile_mode default`` parses to the value
    the JAX parser gives it. ``mesh`` is an option of the port (replica
    sharding over the ranks of the process group): in one process without
    a group, ``1`` and ``auto`` give a mesh of one rank, and ``2`` raises,
    as the world holds one process."""
    cfg = yaml.safe_load(open(files["config"]))
    assert cfg["simulation"]["compile_mode"] == "default"
    if mesh is not None:
        cfg["simulation"]["mesh"] = mesh
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    args = ["--config", str(path), "--simulation.device", "cpu"]
    if mesh == 2:
        with pytest.raises(ValueError, match="the world holds 1"):
            cli.parse_simulation_config(LangevinSimulation, args=args)
        return
    with caplog.at_level("WARNING", logger="flashmd_tpu_torch"):
        _, _, _, sim, _ = cli.parse_simulation_config(LangevinSimulation,
                                                      args=args)
    assert "Ignoring unknown simulation options" not in caplog.text
    assert "multi-GPU" not in caplog.text
    if mesh is None:
        assert sim.mesh is None
    else:
        assert (sim.mesh.rank, sim.mesh.size) == (0, 1)
    flag = ["--simulation.compile_mode", "default"]
    parsed = vars(cli.build_parser(LangevinSimulation).parse_args(flag))
    jparsed = vars(jcli.build_parser(JLangevinSimulation).parse_args(flag))
    assert parsed["simulation.compile_mode"] == "default"
    assert parsed["simulation.compile_mode"] == (
        jparsed["simulation.compile_mode"])


def _dmin_refusal_input(kind, files, tmp_path):
    if kind == "periodic":
        periodic = [dataclasses.replace(c, cell=np.eye(3) * 50.0)
                    for c in files["jcfgs"][:1]]
        jcio.save_native_configurations(periodic,
                                        str(tmp_path / "periodic.pkl"))
        return tmp_path / "periodic.pkl"
    pos = (np.zeros((1, 3)) if kind == "one_atom"
           else np.array([[0.0, 0.0, 0.0], [30.0, 0.0, 0.0]]))
    return [dict(pos=pos, atom_types=np.zeros(len(pos), np.int32),
                 masses=np.ones(len(pos)))]


@pytest.mark.parametrize("kind", ["periodic", "one_atom", "sparse"])
def test_cheb_dmin_auto_refusals_match_jax(files, tmp_path, kind,
                                           monkeypatch):
    """FLASHMD_TPU_CHEB_DMIN=auto refuses periodic structures (through the
    CLI), structures with no pair and a floor at the cutoff, with the JAX
    package's message."""
    inp = _dmin_refusal_input(kind, files, tmp_path)
    errors = []
    if kind == "periodic":
        cfg = yaml.safe_load(open(files["config"]))
        cfg["structure_file"] = str(inp)
        path = tmp_path / "config.yaml"
        path.write_text(yaml.safe_dump(cfg))
        monkeypatch.setenv("FLASHMD_TPU_CHEB_DMIN", "auto")
        for parse, cls in ((cli.parse_simulation_config, LangevinSimulation),
                           (jcli.parse_simulation_config,
                            JLangevinSimulation)):
            with pytest.raises(ValueError, match="periodic") as e:
                parse(cls, args=["--config", str(path),
                                 "--simulation.device", "cpu"])
            errors.append(str(e.value))
    else:
        for derive, config in ((cli._auto_cheb_d_min, Configuration),
                               (jcli._auto_cheb_d_min, JConfiguration)):
            with pytest.raises(ValueError) as e:
                derive([config(**kw) for kw in inp], rcut=10.0)
            errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_apply_batch_size_matches_jax():
    items = [1, 2, 3]
    for n in (None, 1, 3, 7):
        assert cli.apply_batch_size(items, n) == jcli.apply_batch_size(
            items, n)
    for n in (-1, 0):
        with pytest.raises(ValueError, match="must be positive"):
            cli.apply_batch_size(items, n)
        with pytest.raises(ValueError, match="must be positive"):
            jcli.apply_batch_size(items, n)


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
        port = port.numpy() if isinstance(port, torch.Tensor) else port
        np.testing.assert_array_equal(port, np.asarray(ref), err_msg=where)


def _assert_forcefield_equal(ff, jff):
    _assert_tree_equal(ff.schnet_params, jff.schnet_params)
    for f in dataclasses.fields(ff.schnet_config):
        port, ref = (getattr(ff.schnet_config, f.name),
                     getattr(jff.schnet_config, f.name))
        if f.name in ("cutoff", "rbf_cutoff"):
            assert (type(port).__name__, dataclasses.asdict(port)) == (
                type(ref).__name__, dataclasses.asdict(ref))
        else:
            assert port == ref, f.name
    assert ff.priors.keys() == jff.priors.keys()
    for k, p in ff.priors.items():
        jp = jff.priors[k]
        assert (p.kind, p.name, p.feature, p.term_mask) == (
            jp.kind, jp.name, jp.feature, None)
        _assert_tree_equal(p.index_mapping, jp.index_mapping, k)
        _assert_tree_equal(p.params, jp.params, k)
    assert (ff.neighbor_capacity, ff.exc_pair_index, ff.pbc_images) == (
        jff.neighbor_capacity, None, None)


@pytest.mark.parametrize("kind", ["forcefield", "structures", "dump"])
def test_native_reader_matches_jax(files, tmp_path, kind, monkeypatch):
    """The JAX package's native files as the port reads them: the same
    weights, config, priors and structures (TermList arrays are JAX arrays
    in the file); a specialized dump with its Chebyshev fit; and the
    FLASHMD_TPU_CHEB_DMIN override that strips a baked fit, as JAX's."""
    jff, jcfgs = files["jff"], files["jcfgs"]
    if kind == "forcefield":
        ff = cio.load_native_model(str(files["tmp"] / "model.pkl"),
                                   device="cpu")
        _assert_forcefield_equal(ff, jax.tree.map(np.asarray, jff))
        return
    if kind == "structures":
        cfgs = cio.load_native_configurations(
            str(files["tmp"] / "structures.pkl"))
        _assert_same_configurations(cfgs, jcfgs)
        for c, jc in zip(cfgs, jcfgs):
            assert (c.velocities, c.cell, c.exc_pair_index, c.tag) == (
                None, None, None, jc.tag)
            for k, tl in c.neighbor_lists.items():
                jtl = jc.neighbor_lists[k]
                assert isinstance(tl.index_mapping, np.ndarray)
                assert (tl.tag, tl.order, tl.rcut, tl.self_interaction) == (
                    jtl.tag, jtl.order, jtl.rcut, jtl.self_interaction)
        return
    jff, jcfgs = jcgschnet(n_atoms=16, batch_size=1, num_interactions=2,
                           precision="bf16", message_passing="cheb",
                           cheb_order=8, neighbor_capacity=8)
    jff = jff.replace(schnet_params=jattach_cheb_fit(jff.schnet_params,
                                                     jff.schnet_config))
    dump = tmp_path / "dump.pkl"
    jcio.save_specialized_dump(jff, jcfgs, str(dump))
    ff = cio.load_native_model(str(dump), device="cpu")
    _assert_forcefield_equal(ff, jax.tree.map(np.asarray, jff))
    _assert_same_configurations(cio.load_native_configurations(str(dump)),
                                jcfgs)
    cfg = yaml.safe_load(open(files["config"]))
    cfg["model_file"] = cfg["structure_file"] = str(dump)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    monkeypatch.setenv("FLASHMD_TPU_CHEB_DMIN", "1.25")
    (model, *_), (jmodel, *_) = _parse_both(files, "strip", config=path)
    assert model.schnet_config.cheb_d_min == jmodel.schnet_config.cheb_d_min
    assert model.schnet_config.cheb_d_min == 1.25
    assert "cheb_fit" not in model.schnet_params
    assert "cheb_fit" not in jmodel.schnet_params


class _Hostile:
    def __init__(self, fn, *args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("fn,args", [
    (os.system, ("true",)), (eval, ("1",)), (jax.device_put, (1,)),
    (jcgschnet, ()),
], ids=["os.system", "eval", "jax", "flashmd_tpu"])
def test_hostile_native_files_are_refused(tmp_path, fn, args):
    """A native file that names any other global is refused by name,
    before anything runs."""
    path = tmp_path / "hostile.pkl"
    with open(path, "wb") as f:
        pickle.dump([_Hostile(fn, *args)], f)
    name = f"{fn.__module__}.{fn.__qualname__}"
    for load in (cio.load_native_model, cio.load_native_configurations):
        with pytest.raises(pickle.UnpicklingError,
                           match=f"refusing {name}"):
            load(str(path))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ckpt")
    info = sc.build_synthetic_checkpoint(tmp)
    cfg = {"simulation": {"n_timesteps": 4, "save_interval": 2},
           "betas": [1.67], "model_file": info["model_path"],
           "structure_file": info["structures_path"]}
    path = tmp / "config.yaml"
    path.write_text(format_yaml(cfg))
    return path


@pytest.mark.parametrize("disable_optim", [False, True],
                         ids=["default", "disable_optim"])
def test_reference_checkpoint_binding(checkpoint, disable_optim,
                                      monkeypatch):
    """A reference model_and_prior.pt through the CLI: build_forcefield on
    the simulation's device with optimize=not --disable_optim and the
    unique structures to tune on, whatever --batch_size duplicates."""
    calls = []
    real = cli.build_forcefield

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(cli, "build_forcefield", record)
    args = ["--config", str(checkpoint), "--simulation.device", "cpu",
            "--batch_size", "5"] + (["--disable_optim"] if disable_optim
                                    else [])
    model, data, _, sim, _ = cli.parse_simulation_config(
        LangevinSimulation, args=args)
    assert len(calls) == 1 and len(data) == 5
    (ref, first), kw = calls[0]
    assert isinstance(ref, cio.ReferenceModel) and first is data[0]
    assert kw["optimize"] is (not disable_optim)
    assert kw["device"] == "cpu" and kw["allow_missing_priors"] is False
    tune = kw["tune_configurations"]
    assert len(tune) == 2
    np.testing.assert_array_equal(tune[0].pos, data[2].pos)
    cfg = model.schnet_config
    assert (cfg.message_passing, cfg.precision) == (
        ("xla", "fp32") if disable_optim else ("cheb", "bf16"))
    assert sim.gptq == (None if disable_optim else "w16a16")


def test_langevin_main_files_match_jax(files, tmp_path, monkeypatch):
    """nvt_langevin_main of both packages on one config (40 steps): the
    same file names and the same npy shapes and dtypes. The model file is
    the zoo field's priors alone, a JAX native file too: the network's
    parity is the force test's, and without it the JAX engine's first
    evaluation costs no eager compile of the network."""
    jcio.save_native_model(
        files["jff"].replace(schnet_params=None, schnet_config=None),
        str(tmp_path / "priors.pkl"))
    cfg = yaml.safe_load(open(files["config"]))
    cfg["model_file"] = str(tmp_path / "priors.pkl")
    cfg["simulation"].update(
        filename="run", save_forces=True, save_energies=True,
        export_interval=20, create_checkpoints=True, log_type="write")
    dirs = {}
    monkeypatch.setattr(jscripts, "_enable_compilation_cache", lambda: None)
    for pkg, main in (("port", scripts.nvt_langevin_main),
                      ("jax", jscripts.nvt_langevin_main)):
        dirs[pkg] = tmp_path / pkg
        cfg["simulation"]["output_dir"] = str(dirs[pkg])
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        monkeypatch.setattr(sys, "argv", [pkg, "--config", str(path),
                                          "--simulation.device", "cpu"])
        sim = main()
        assert sim.get_throughput_metrics() is not None
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"]))
    for name in ("run_coords_0000.npy", "run_coords_0001.npy",
                 "run_checkpoint_0001.npz", "run_log.txt",
                 "run_config.yaml", "run_specialized_model_and_config.pkl"):
        assert name in names
    for name in names:
        if name.endswith(".npy"):
            a, b = (np.load(d / name) for d in (dirs["port"], dirs["jax"]))
            assert (a.shape, a.dtype) == (b.shape, b.dtype), name
    assert np.load(dirs["port"] / "run_coords_0001.npy").shape == (
        3, 2, 16, 3)


# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["langevin", "parallel_tempering", "echo"])
def test_yaml_reader_matches_safe_load(files, name):
    path = (files["echo"] if name == "echo"
            else os.path.join(ROOT, "examples", f"{name}.yaml"))
    text = open(path).read()
    assert parse_yaml(text) == yaml.safe_load(text)
    assert format_yaml(parse_yaml(text)) == yaml.safe_dump(
        yaml.safe_load(text), default_flow_style=False, sort_keys=False)


_WORD = st.from_regex(r"[A-Za-z_/][A-Za-z0-9_./-]{0,10}", fullmatch=True)
# the YAML 1.1 forms PyYAML resolves, and their near misses
_FORMS = st.sampled_from([
    "yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false",
    "False", "FALSE", "on", "On", "ON", "off", "Off", "OFF", "y", "n", "oN",
    "~", "null", "Null", "NULL", "nULL", "0x1f", "-0x1F", "017", "08",
    "0b101", "1_000", "+5", "-0", "1:30", "190:20:30.15", "1e-3", "1.0e-3",
    "1.0e3", "1.0E+3", ".5", "-.5", "1.", "1_0.5", ".inf", "-.inf",
    "+.inf", ".Inf", "3", "-12",
])
_NUMBER = (st.integers(-10 ** 9, 10 ** 9).map(str)
           | st.floats(allow_nan=False, allow_infinity=False).map(repr))
_ASCII = st.characters(min_codepoint=0x20, max_codepoint=0x7E)
_SINGLE = st.text(_ASCII, max_size=12).map(
    lambda s: "'" + s.replace("'", "''") + "'")
_DOUBLE = st.lists(
    st.sampled_from(["a", " ", "#", ":", ",", "'", "\\n", "\\t", "\\\\",
                     '\\"', "\\x41", "\\u00e9", "\\/"]),
    max_size=6).map(lambda parts: '"' + "".join(parts) + '"')
_SCALAR = _WORD | _FORMS | _NUMBER | _SINGLE | _DOUBLE
_KEY = st.from_regex(r"[a-z_][a-z0-9_]{0,7}", fullmatch=True) | _FORMS


@st.composite
def _documents(draw):
    """Config-shaped YAML text of the subset: nested mappings (as the
    ``simulation:`` section), block sequences at the key's indentation or
    deeper, flow sequences, empty values, comments."""
    lines = []

    def mapping(indent, depth):
        pad = " " * indent
        for key in draw(st.lists(_KEY, min_size=1, max_size=5)):
            kinds = ["scalar", "empty", "flow", "block"] + (
                ["mapping"] if depth < 2 else [])
            kind = draw(st.sampled_from(kinds))
            comment = draw(st.sampled_from(["", "  # note", " #x"]))
            if kind == "scalar":
                lines.append(f"{pad}{key}: {draw(_SCALAR)}{comment}")
            elif kind == "empty":
                lines.append(f"{pad}{key}:{comment}")
            elif kind == "flow":
                items = draw(st.lists(_SCALAR, max_size=4))
                lines.append(f"{pad}{key}: [{', '.join(items)}]{comment}")
            elif kind == "block":
                lines.append(f"{pad}{key}:{comment}")
                sub = " " * (indent + draw(st.sampled_from([0, 2])))
                for item in draw(st.lists(_SCALAR, min_size=1, max_size=3)):
                    lines.append(f"{sub}- {item}")
            else:
                lines.append(f"{pad}{key}:{comment}")
                mapping(indent + draw(st.sampled_from([2, 4])), depth + 1)
            if draw(st.booleans()):
                lines.append(draw(st.sampled_from(["", "# note", "   # x"])))

    mapping(0, 0)
    return "\n".join(lines) + "\n"


def _same(a, b):
    """Equality with NaN equal to itself."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return a == b


@settings(max_examples=150, deadline=None, derandomize=True)
@given(text=_documents())
def test_yaml_reader_matches_safe_load_on_generated_documents(text):
    assert _same(parse_yaml(text), yaml.safe_load(text))


_VALUE = (st.none() | st.booleans() | st.integers()
          | st.floats(allow_nan=False) | st.text(_ASCII, max_size=20))
_DATA = st.dictionaries(
    st.text(_ASCII, min_size=1, max_size=12),
    _VALUE | st.lists(_VALUE, max_size=3)
    | st.dictionaries(st.text(_ASCII, min_size=1, max_size=8),
                      _VALUE | st.lists(_VALUE, max_size=3), max_size=4),
    max_size=6)


@settings(max_examples=150, deadline=None, derandomize=True)
@given(data=_DATA)
def test_yaml_writer_matches_safe_dump(data):
    text = format_yaml(data)
    assert text == yaml.safe_dump(data, default_flow_style=False,
                                  sort_keys=False)
    assert _same(yaml.safe_load(text), data)
    assert _same(parse_yaml(text), data)


@pytest.mark.parametrize("value", ["é", "a\nb", "tab\there", "\x00\x1b",
                                   "\u2028", "\U0001F600", "x" * 100 + " y"])
def test_yaml_writer_round_trips_other_strings(value):
    """Strings outside printable ASCII are written double-quoted, long
    ones on one line: what yaml.safe_load reads back is the value."""
    text = format_yaml({"k": value, "l": [value]})
    assert yaml.safe_load(text) == parse_yaml(text) == {"k": value,
                                                        "l": [value]}


@pytest.mark.parametrize("data", [
    {"": 1}, {"a": [[1]]}, {"a": [{"b": 1}]}, {"a": (1, 2)},
    {"a": np.float64(1.0)}, [1],
], ids=["empty_key", "nested_list", "list_of_maps", "tuple", "numpy",
        "top_list"])
def test_yaml_writer_refuses_what_the_reader_cannot_take(data):
    with pytest.raises((ValueError, TypeError)):
        format_yaml(data)


@pytest.mark.parametrize("text,line", [
    ("a: &x 1\n", 1), ("a: 1\nb: *x\n", 2), ("a: !!str 1\n", 1),
    ("a: |\n  x\n", 1), ("a: >\n  x\n", 1), ("a: {b: 1}\n", 1),
    ("a: 'x\n  y'\n", 1), ("a: x\n  y\n", 2), ("a: 1\n---\nb: 2\n", 2),
    ("%YAML 1.1\na: 1\n", 1), ("a: 2001-01-01\n", 1), ("a: [[1]]\n", 1),
    ("a: b: c\n", 1), ("- a: 1\n", 1), ("a:\n  - b: 1\n", 2),
    ("<<: 1\n", 1), ("a: [1, 2\n", 1), ("? a\n", 1), ("a: - b\n", 1),
    ("a: 1\n b: 2\n", 2), ("a:\n\t b: 1\n", 2), ("a: [1, {b: 2}]\n", 1),
    ("a: \"x\\q\"\n", 1), ("a: 'x' y\n", 1),
])
def test_yaml_outside_the_subset_raises(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        parse_yaml(text)
