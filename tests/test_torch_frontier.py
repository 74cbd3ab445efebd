"""Port parity for the default conversion of a checkpoint and its
measured Chebyshev frontier (flashmd_tpu_torch/models/frontier.py, the
optimize=True branch of models/checkpoint_io.build_forcefield) against
the JAX package, on the reference-layout checkpoints that
``tests/helpers/synthetic_checkpoint.py`` writes (shared with
tests/test_torch_checkpoint.py). Tolerances:
  * the default (cheb bf16) field: the same path, orders and fit domain;
    forces within 2e-3 of max|F| (the CPU rounds to nearest on both
    sides; the port's twins round on the kernels' bases);
  * the frontier's d_min equal, its bf16 floor and budget within 5 %
    (both on the xla paths); each candidate's error within 5 % relative
    where truncation dominates it (a filter made rough on both sides). On
    the helper's smooth filters every candidate's error is the cheb
    path's own rounding (equal over the candidates), which the two
    packages round differently: there the errors are held within the bf16
    floor, absolute, and the choice must agree.
"""

import dataclasses
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import checkpoint_io as jcio
from flashmd_tpu.models import frontier as jfr
from flashmd_tpu.models.cheb import attach_cheb_fit as jattach_cheb_fit
from flashmd_tpu_torch.models import checkpoint_io as cio
from flashmd_tpu_torch.models import frontier as fr
from flashmd_tpu_torch.models.cheb import attach_cheb_fit
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.simulation.langevin import LangevinSimulation
from tests.helpers import synthetic_checkpoint as sc
from tests.test_torch_checkpoint import (  # noqa: F401  (the fixture)
    _jax_forces,
    _load_both,
    _port_forces,
    _rel,
    written,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

A = sc.A
BF16_FORCE_TOL = 2e-3


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


def _frontier_report(caplog):
    reports = [r.frontier for r in caplog.records if hasattr(r, "frontier")]
    assert len(reports) == 1
    return reports[0]


@pytest.mark.parametrize("variant", ["plain", "types_mlp_species",
                                     "general_priors", "exc_pairs"])
def test_default_conversion_matches_jax(written, variant, caplog):
    """optimize=True: the same path, orders and fit domain as JAX (the
    measured frontier on both structures), and the forces of the two
    fields within the bf16 bound."""
    info = written[variant]
    ref, cfgs, jref, jcfgs = _load_both(info)
    with caplog.at_level(logging.INFO, logger=fr.__name__):
        ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs,
                                  device="cpu")
    jff = jcio.build_forcefield(jref, jcfgs[0], tune_configurations=jcfgs)
    cfg, jcfg = ff.schnet_config, jff.schnet_config
    assert (cfg.message_passing, cfg.precision, cfg.cheb_order,
            cfg.cheb_order_deriv, cfg.cheb_d_min) == (
        jcfg.message_passing, jcfg.precision, jcfg.cheb_order,
        jcfg.cheb_order_deriv, jcfg.cheb_d_min)
    if variant == "exc_pairs":
        assert (cfg.message_passing, cfg.precision) == ("xla", "bf16")
    else:
        assert cfg.message_passing == "cheb"
        assert 0.0 < cfg.cheb_d_min < sc.RCUT
        report = _frontier_report(caplog)
        assert report.chosen == (cfg.cheb_order, cfg.cheb_order_deriv)
        ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params, cfg))
        jff = jff.replace(schnet_params=jattach_cheb_fit(jff.schnet_params,
                                                         jcfg))
    _, f, _ = _port_forces(ff, info)
    _, jf, _ = _jax_forces(jff, info)
    assert _rel(f, jf) <= BF16_FORCE_TOL


def _jax_frontier(jref, jcfgs):
    """The reference frontier's measurement and choice, step by step as
    its select_cheb_frontier takes them (frontier.py:129-217), with the
    numbers kept: (d_min, floor, errors, chosen)."""
    os.environ["FLASHMD_TPU_AUTOFRONTIER"] = "0"
    try:
        jff = jcio.build_forcefield(jref, jcfgs[0])
    finally:
        del os.environ["FLASHMD_TPU_AUTOFRONTIER"]
    pos = jfr._stack_positions(jcfgs, 4)
    types = jnp.asarray(jcfgs[0].atom_types, jnp.int32)
    d_min = jfr.derive_d_min(jcfgs, sc.RCUT)
    cfg = dataclasses.replace(jff.schnet_config, cheb_order=jfr.MAX_ORDER,
                              cheb_order_deriv=jfr.MAX_ORDER,
                              cheb_d_min=d_min)
    f_ref = jfr._schnet_forces(
        jff.schnet_params,
        dataclasses.replace(cfg, precision="fp32", message_passing="xla"),
        pos, types)
    scale = np.abs(f_ref).max()
    f_floor = jfr._schnet_forces(
        jff.schnet_params,
        dataclasses.replace(cfg, precision="bf16", message_passing="xla"),
        pos, types)
    floor = float(np.abs(f_floor - f_ref).max() / scale)
    params = jattach_cheb_fit(jff.schnet_params, cfg)
    errors, chosen = {}, None
    for m1, m2 in jfr.CANDIDATES:
        p_t = {**params,
               "cheb_fit": jfr._truncated_fits(params["cheb_fit"], m1, m2)}
        f = jfr._schnet_forces(p_t, cfg, pos, types)
        errors[(m1, m2)] = float(np.abs(f - f_ref).max() / scale)
        if errors[(m1, m2)] <= 1.2 * max(floor, 1e-6):
            chosen = (m1, m2)
            break
    return d_min, floor, errors, chosen


def _roughen(model, factor):
    """Narrow the radial basis by ``factor`` (its exponent's coefficient):
    a filter whose Chebyshev series converges slowly."""
    model.schnet_params["rbf"]["coeff"] = (
        model.schnet_params["rbf"]["coeff"] * np.float32(factor))
    return model


@pytest.mark.parametrize("rough", [False, True], ids=["smooth", "rough"])
def test_frontier_measurement_matches_jax(written, caplog, rough):
    """The port's frontier against the reference's measurement on the same
    structures: d_min, the bf16 floor and budget (the xla paths), each
    measured candidate's error, the choice. Rough: no candidate meets the
    budget, every one is measured and both keep the fallback."""
    info = written["plain"]
    ref, cfgs, jref, jcfgs = _load_both(info)
    if rough:
        ref, jref = _roughen(ref, 100.0), _roughen(jref, 100.0)
    with caplog.at_level(logging.INFO, logger=fr.__name__):
        ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs,
                                  device="cpu")
    report = _frontier_report(caplog)
    d_min, floor, errors, chosen = _jax_frontier(jref, jcfgs)
    assert report.d_min == d_min > 0.0
    assert report.floor == pytest.approx(floor, rel=0.05)
    assert report.budget == pytest.approx(1.2 * floor, rel=0.05)
    assert report.chosen == chosen
    assert list(report.errors) == list(errors)
    for cand, err in report.errors.items():
        if rough:
            # truncation-dominated (> 5x the floor): within 5 %
            assert errors[cand] > 5 * floor
            assert err == pytest.approx(errors[cand], rel=0.05), cand
        else:
            assert abs(err - errors[cand]) <= floor, cand
    cfg = ff.schnet_config
    if rough:
        assert chosen is None and len(errors) == len(fr.CANDIDATES)
        assert (cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min) == (
            *fr.FULL_DOMAIN_FALLBACK, 0.0)
    else:
        assert (cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min) == (
            *chosen, d_min)


def test_frontier_helpers_match_jax(written, monkeypatch):
    ref, cfgs, jref, jcfgs = _load_both(written["plain"])
    assert fr.CANDIDATES == jfr.CANDIDATES
    assert (fr.FULL_DOMAIN_FALLBACK, fr.MAX_ORDER) == (
        jfr.FULL_DOMAIN_FALLBACK, jfr.MAX_ORDER)
    for rc in (0.5, 2.0, sc.RCUT):
        assert fr.derive_d_min(cfgs, rc) == jfr.derive_d_min(jcfgs, rc)
    periodic = [dataclasses.replace(c, cell=10.0 * np.eye(3)) for c in cfgs]
    assert fr.derive_d_min(periodic, sc.RCUT) == 0.0
    # truncated fits against the reference's on the same float32 fits
    ff = cio.build_forcefield(ref, cfgs[0], optimize=False, device="cpu")
    cfg = dataclasses.replace(ff.schnet_config, message_passing="cheb",
                              cheb_order=96, cheb_order_deriv=96)
    fits = attach_cheb_fit(ff.schnet_params, cfg)["cheb_fit"]
    jfits = tuple(tuple(jnp.asarray(t.numpy()) for t in f) for f in fits)
    for got, want in zip(fr._truncated_fits(fits, 48, 72),
                         jfr._truncated_fits(jfits, 48, 72)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)
    # FLASHMD_TPU_AUTOFRONTIER=0 keeps the full-domain (64, 96)
    monkeypatch.setenv("FLASHMD_TPU_AUTOFRONTIER", "0")
    assert not fr.autofrontier_enabled()
    ff = cio.build_forcefield(ref, cfgs[0], device="cpu")
    assert (ff.schnet_config.cheb_order, ff.schnet_config.cheb_order_deriv,
            ff.schnet_config.cheb_d_min) == (64, 96, 0.0)


def test_ingested_checkpoint_runs_langevin(written):
    """The slice end to end on the CPU: load, build (frontier measured),
    attach (the fit at the chosen orders), a few BAOAB steps; the first
    force evaluation equals the same field's forces outside the engine."""
    info = written["general_priors"]
    ref = cio.load_reference_checkpoint(info["model_path"])
    cfgs = cio.load_reference_configurations(info["structures_path"])
    ff = cio.build_forcefield(ref, cfgs[0], tune_configurations=cfgs,
                              device="cpu")
    assert ff.schnet_config.message_passing == "cheb"
    sim = LangevinSimulation(dt=0.004, friction=1.0, n_timesteps=4,
                             save_interval=2, random_seed=1, device="cpu")
    sim.attach_model_and_configurations(ff, cfgs, beta=1.67)
    carry = sim._init_carry(sim.initial_system)
    e, f, _ = compute_energy_forces(sim.model, sim.initial_system.pos,
                                    sim.initial_system.atom_types)
    assert torch.equal(carry["forces"], f)
    coords = sim.simulate()
    assert coords.shape == (2, 2, A, 3)
    assert np.isfinite(coords).all()
