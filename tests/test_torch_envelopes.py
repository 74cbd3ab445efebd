"""Port parity of the Chebyshev path under every radial-basis envelope
that the JAX package's cheb path takes, on a narrow 2-block SchNet
(hidden and filters 16, 8 RBF, orders (16, 24) on d_min 2.0, rcut 10)
whose JAX weights are carried into the port, on two molecules of the JAX
zoo's 24-bead chain. The basis envelopes: ``IdentityCutoff(0, rc)`` (what
a plain-number cutoff of the reference's GaussianBasis becomes),
``CosineCutoff(0, rc - 1)``, ``CosineCutoff(1, rc)`` and
``ShiftedCosineCutoff(0, rc, 0.5)``; the conv cutoff stays the zero-lower
cosine on rc. Tolerances, each of the JAX side's max:

* the host fit's c, c2 and w0 at ``proj``, ``wls`` and ``lawson``: 1e-6
  (the same float64 numpy on the same weights: equal after the float32
  cast where nothing differs);
* the in-graph fit against JAX's in-jit fit: 1e-5; and against the
  port's own float64 host fit: 1e-5;
* forces through ``compute_energy_forces`` with the host fits attached on
  both sides, on the stacked schedule, and on the per-block one
  (``FLASHMD_CHEB_STACK=0``) for the identity envelope: the network alone
  at fp32 within 1e-5; at bf16 the whole field, the network with the JAX
  zoo's chain priors, within 2e-3. (The network alone differs at bf16 by
  2e-3 to 5e-3 of its own max between the packages under every envelope,
  the plain cosine included: they round to bf16 on different bases.)
* a reference checkpoint whose basis is a plain number (IdentityCutoff),
  ingested by both packages with ``optimize=True`` (the reference-layout
  file of tests/helpers/synthetic_checkpoint.py with its basis envelope
  and ``max_num_neighbors`` replaced here): the same path; the frontier's
  d_min equal, its floor and budget within 5 %, each candidate's error
  within 5 % where truncation decides it (the basis narrowed 100x: both
  then keep the same (m1, m2, d_min)) and within the bf16 floor, absolute,
  where the cheb path's own bf16 rounding does; bf16 forces within 2e-3 at
  the port's orders. The same model through a JAX native file ingests as
  the checkpoint does.
"""

import copy
import dataclasses
import functools
import logging
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from flashmd_tpu.models import checkpoint_io as jcio
from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.cheb import attach_cheb_fit as jattach_cheb_fit
from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.cutoff import IdentityCutoff as JIdentityCutoff
from flashmd_tpu.models.cutoff import (
    ShiftedCosineCutoff as JShiftedCosineCutoff,
)
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.models.zoo import _chain_priors as jchain_priors
from flashmd_tpu.models.zoo import random_cg_protein as jrandom_cg_protein
from flashmd_tpu_torch.models import checkpoint_io as cio
from flashmd_tpu_torch.models import frontier as fr
from flashmd_tpu_torch.models.cheb import (
    attach_cheb_fit,
    fit_chebyshev_filter,
    fit_chebyshev_filter_host,
)
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.cutoff import IdentityCutoff
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from tests.helpers import synthetic_checkpoint as sc
from tests.test_torch_frontier import (
    _frontier_report,
    _jax_frontier,
    _roughen,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

F = 16
N_RBF = 8
RCUT = 10.0
N_ATOMS = 24
ORDERS = (16, 24)
D_MIN = 2.0
ENVELOPES = {
    "identity": JIdentityCutoff(0.0, RCUT),
    "cosine_short": JCosineCutoff(0.0, RCUT - 1.0),
    "cosine_lower": JCosineCutoff(1.0, RCUT),
    "shifted_cosine": JShiftedCosineCutoff(0.0, RCUT, 0.5),
}
HOST_TOL = 1e-6
FIT_TOL = 1e-5
FORCE_TOL = {"fp32": 1e-5, "bf16": 2e-3}
CKPT_BF16_TOL = 2e-3
CKPT_MAX_NEIGHBORS = 32


@pytest.fixture(autouse=True)
def _float32_jax():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


@functools.cache
def _pair(envelope, priors=False):
    """The JAX field (no fit attached) with the basis envelope
    ``envelope``, the same weights in the port, and two molecules of the
    JAX zoo's chain (float32 [S, A, 3], types [A]); with the zoo's chain
    priors where ``priors``."""
    base = jrandom_cg_protein(n_atoms=N_ATOMS, seed=0)
    jpriors = jchain_priors(base, 0) if priors else {}
    with warnings.catch_warnings():
        # a basis bound other than the conv cutoff's warns in both
        warnings.simplefilter("ignore", UserWarning)
        jcfg = JSchNetConfig(
            hidden_channels=F, embedding_size=25, num_filters=F,
            num_interactions=2, num_rbf=N_RBF,
            cutoff=JCosineCutoff(0.0, RCUT), rbf_cutoff=ENVELOPES[envelope],
            output_hidden_layer_widths=(16,), precision="fp32",
            message_passing="cheb", cheb_order=ORDERS[0],
            cheb_order_deriv=ORDERS[1], cheb_d_min=D_MIN,
        )
        params = jinit_schnet(jax.random.PRNGKey(3), jcfg)
        jff = JForceField(schnet_params=params, priors=jpriors,
                          schnet_config=jcfg, neighbor_capacity=N_ATOMS)
        ff = forcefield_from_numpy(jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, jpriors),
                                   _kwargs(jcfg), device="cpu",
                                   neighbor_capacity=N_ATOMS)
    rng = np.random.default_rng(5)
    pos = np.stack([base.pos + rng.normal(scale=0.05, size=base.pos.shape)
                    for _ in range(2)]).astype(np.float32)
    return jff, ff, pos, base.atom_types


def _configs(jff, ff, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return (dataclasses.replace(jff.schnet_config, **kw),
                dataclasses.replace(ff.schnet_config, **kw))


def test_port_config_carries_every_envelope():
    """The port's config takes each envelope on cheb, as the same class
    with the same fields, and its basis offsets are the JAX package's."""
    for name, env in ENVELOPES.items():
        jff, ff, _, _ = _pair(name)
        cfg = ff.schnet_config
        assert cfg.message_passing == "cheb"
        assert type(cfg.rbf_cutoff).__name__ == type(env).__name__
        assert dataclasses.asdict(cfg.rbf_cutoff) == dataclasses.asdict(env)
        np.testing.assert_array_equal(
            ff.schnet_params["rbf"]["offset"].numpy(),
            np.asarray(jff.schnet_params["rbf"]["offset"]))


@pytest.mark.parametrize("method", ["proj", "wls", "lawson"])
@pytest.mark.parametrize("envelope", list(ENVELOPES))
def test_host_fit_matches_jax(envelope, method):
    jff, ff, _, _ = _pair(envelope)
    jcfg, cfg = _configs(jff, ff, cheb_fit_method=method)
    weight = lambda d: 1.0 + 0.1 * d  # noqa: E731
    for b in range(2):
        kw = dict(order=ORDERS[0], order_deriv=ORDERS[1],
                  extra_weight=weight if method == "wls" else None)
        ref = jcheb.fit_chebyshev_filter_host(
            jff.schnet_params["interactions"][b], jff.schnet_params["rbf"],
            jcfg, **kw)
        out = fit_chebyshev_filter_host(
            ff.schnet_params["interactions"][b], ff.schnet_params["rbf"],
            cfg, **kw)
        for o, r in zip(out, ref):
            r = np.asarray(r)
            assert o.shape == r.shape and o.dtype == torch.float32
            assert np.abs(o.numpy() - r).max() <= HOST_TOL * np.abs(r).max()


_jfit = jax.jit(jcheb.fit_chebyshev_filter,
                static_argnames=("config", "order", "order_deriv"))


@pytest.mark.parametrize("envelope", list(ENVELOPES))
def test_in_graph_fit_matches_jax_and_the_host_fit(envelope):
    """The in-graph fit evaluates the basis with its own envelope: against
    JAX's in-jit fit, and against the port's float64 host fit."""
    jff, ff, _, _ = _pair(envelope)
    for b in range(2):
        bp = ff.schnet_params["interactions"][b]
        out = fit_chebyshev_filter(bp, ff.schnet_params["rbf"],
                                   ff.schnet_config, order=ORDERS[0],
                                   order_deriv=ORDERS[1])
        ref = _jfit(jff.schnet_params["interactions"][b],
                    jff.schnet_params["rbf"], jff.schnet_config,
                    order=ORDERS[0], order_deriv=ORDERS[1])
        host = fit_chebyshev_filter_host(bp, ff.schnet_params["rbf"],
                                         ff.schnet_config, order=ORDERS[0],
                                         order_deriv=ORDERS[1])
        for o, r, h in zip(out, ref, host):
            o = o.detach().numpy()
            assert _rel(o, r) <= FIT_TOL
            assert _rel(o, h.numpy()) <= FIT_TOL


def _forces_both(envelope, precision):
    """(port, JAX) forces [S, A, 3]: the network alone at fp32, with the
    chain priors at bf16 (module docstring)."""
    jff, ff, pos, types = _pair(envelope, priors=precision == "bf16")
    jcfg, cfg = _configs(jff, ff, precision=precision)
    jff = jff.replace(schnet_config=jcfg,
                      schnet_params=jattach_cheb_fit(jff.schnet_params,
                                                     jcfg))
    ff = ff.replace(schnet_config=cfg,
                    schnet_params=attach_cheb_fit(ff.schnet_params, cfg))
    _, jf, _ = jax.jit(lambda p: jcompute_energy_forces(
        jff, p, jnp.asarray(types)))(jnp.asarray(pos))
    _, f, _ = compute_energy_forces(ff, torch.from_numpy(pos),
                                    torch.as_tensor(types, dtype=torch.long))
    return f.numpy(), np.asarray(jf)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("envelope", list(ENVELOPES))
def test_forces_match_jax(envelope, precision):
    f, jf = _forces_both(envelope, precision)
    assert np.isfinite(f).all() and f.shape == jf.shape
    assert _rel(f, jf) <= FORCE_TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_per_block_schedule_matches_jax(monkeypatch, precision):
    monkeypatch.setenv("FLASHMD_CHEB_STACK", "0")
    f, jf = _forces_both("identity", precision)
    assert _rel(f, jf) <= FORCE_TOL[precision]


# ---------------------------------------------------------------------------
# A reference checkpoint whose basis cutoff was a plain number
# ---------------------------------------------------------------------------


def _identity_basis_checkpoint(directory):
    """The helper's reference-layout checkpoint, read back with its fake
    reference modules, its SchNet's basis envelope replaced by the
    IdentityCutoff that the reference's GaussianBasis makes of a plain
    number and its max_num_neighbors set, written again; the helper's
    structures and ground truths are kept."""
    info = sc.build_synthetic_checkpoint(directory)
    sc.make_fake_reference_modules()

    class IdentityCutoff(nn.Module):
        def __init__(self, lower, upper):
            super().__init__()
            self.cutoff_lower = lower
            self.cutoff_upper = upper

        def forward(self, d):
            return torch.ones_like(d)

    sc._register(IdentityCutoff, "flashmd.models.cutoff")
    try:
        root = torch.load(info["model_path"], weights_only=False)
        schnet = [m for m in root.modules()
                  if type(m).__name__ == "SchNet"][0]
        schnet.rbf_layer.cutoff = IdentityCutoff(0.0, sc.RCUT)
        schnet.max_num_neighbors = CKPT_MAX_NEIGHBORS
        torch.save(root, info["model_path"])
    finally:
        sc.unregister_fake_modules()
    return info


@pytest.fixture(scope="module")
def identity_checkpoint(tmp_path_factory):
    info = _identity_basis_checkpoint(tmp_path_factory.mktemp("identity"))
    return (info, cio.load_reference_checkpoint(info["model_path"]),
            cio.load_reference_configurations(info["structures_path"]),
            jcio.load_reference_checkpoint(info["model_path"]),
            jcio.load_reference_configurations(info["structures_path"]))


def _ingest(ref, cfgs, caplog):
    """The port's optimize=True field and its frontier report."""
    caplog.clear()
    with caplog.at_level(logging.INFO, logger=fr.__name__):
        ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs,
                                  device="cpu")
    return ff, _frontier_report(caplog)


def _bf16_forces_both(ff, jref, jcfgs, info):
    """(port, JAX) forces of the ingested cheb field and of the JAX
    package's field at the same orders and fit domain, both fits
    attached."""
    cfg = ff.schnet_config
    os.environ["FLASHMD_TPU_AUTOFRONTIER"] = "0"
    try:
        jff = jcio.build_forcefield(jref, jcfgs[0])
    finally:
        del os.environ["FLASHMD_TPU_AUTOFRONTIER"]
    jcfg = dataclasses.replace(jff.schnet_config, cheb_order=cfg.cheb_order,
                               cheb_order_deriv=cfg.cheb_order_deriv,
                               cheb_d_min=cfg.cheb_d_min)
    jff = jff.replace(schnet_config=jcfg,
                      schnet_params=jattach_cheb_fit(jff.schnet_params,
                                                     jcfg))
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params, cfg))
    pos = info["pos"][None].astype(np.float32)
    _, f, _ = compute_energy_forces(ff, torch.from_numpy(pos),
                                    torch.tensor(info["types"]))
    _, jf, _ = jcompute_energy_forces(jff, jnp.asarray(pos),
                                      jnp.asarray(info["types"], jnp.int32))
    return f.numpy(), np.asarray(jf)


@pytest.mark.parametrize("rough", [False, True], ids=["smooth", "rough"])
def test_identity_basis_checkpoint_ingests_on_cheb_as_jax(
        identity_checkpoint, caplog, rough):
    """optimize=True takes a plain-number basis to cheb at bf16 in both
    packages, and the port's frontier measures what the JAX package's
    does: d_min, the bf16 floor and budget, each candidate's error. On the
    helper's smooth filter every candidate's error is the cheb path's own
    bf16 rounding, which the packages round differently (within the
    floor); rough (the basis narrowed 100x): truncation decides every
    candidate, and both keep the same (m1, m2, d_min)."""
    info, ref, cfgs, jref, jcfgs = identity_checkpoint
    assert isinstance(ref.schnet_config.rbf_cutoff, IdentityCutoff)
    assert type(jref.schnet_config.rbf_cutoff).__name__ == "IdentityCutoff"
    assert (ref.schnet_config.max_num_neighbors
            == jref.schnet_config.max_num_neighbors == CKPT_MAX_NEIGHBORS)
    if rough:
        ref = _roughen(copy.deepcopy(ref), 100.0)
        jref = _roughen(copy.deepcopy(jref), 100.0)
    ff, report = _ingest(ref, cfgs, caplog)
    cfg = ff.schnet_config
    assert (cfg.message_passing, cfg.precision) == ("cheb", "bf16")
    assert isinstance(cfg.rbf_cutoff, IdentityCutoff)
    assert cfg.max_num_neighbors == CKPT_MAX_NEIGHBORS
    d_min, floor, errors, chosen = _jax_frontier(jref, jcfgs)
    assert report.d_min == d_min > 0.0
    assert report.floor == pytest.approx(floor, rel=0.05)
    assert report.budget == pytest.approx(1.2 * floor, rel=0.05)
    measured = [c for c in fr.CANDIDATES if c in report.errors]
    assert measured == list(report.errors)
    for cand, err in report.errors.items():
        if cand not in errors:
            continue  # the JAX package stopped at an earlier candidate
        if rough:
            assert errors[cand] > 5 * floor
            assert err == pytest.approx(errors[cand], rel=0.05), cand
        else:
            assert abs(err - errors[cand]) <= floor, cand
    if rough:
        assert report.chosen is None and chosen is None
        assert (cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min) == (
            *fr.FULL_DOMAIN_FALLBACK, 0.0)
    else:
        assert report.chosen == (cfg.cheb_order, cfg.cheb_order_deriv)
        assert cfg.cheb_d_min == d_min
    f, jf = _bf16_forces_both(ff, jref, jcfgs, info)
    assert np.isfinite(f).all()
    assert _rel(f, jf) <= CKPT_BF16_TOL


def test_identity_basis_native_file_ingests_as_the_checkpoint(
        identity_checkpoint, caplog, tmp_path):
    """The same model through the JAX package's native model file, read
    by the port's native-file reader (convert.config_from_kwargs): the
    same config, frontier and fits as the checkpoint's route."""
    info, ref, cfgs, jref, jcfgs = identity_checkpoint
    path = str(tmp_path / "model.pkl")
    jcio.save_native_model(jref, path)
    native = cio.load_native_model(path, device="cpu")
    assert native.schnet_config == ref.schnet_config
    ff, report = _ingest(ref, cfgs, caplog)
    ff_n, report_n = _ingest(native, cfgs, caplog)
    assert ff_n.schnet_config == ff.schnet_config
    assert (report_n.chosen, report_n.d_min) == (report.chosen,
                                                 report.d_min)
    cfg = ff.schnet_config
    fits = attach_cheb_fit(ff.schnet_params, cfg)["cheb_fit"]
    fits_n = attach_cheb_fit(ff_n.schnet_params, cfg)["cheb_fit"]
    for fit, fit_n in zip(fits, fits_n):
        for t, t_n in zip(fit, fit_n):
            assert torch.equal(t, t_n)
