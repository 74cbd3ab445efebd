"""Port parity: cheb_stack_apply, the SchNet force field and the weight
carry-over against the JAX package, on identical weights and positions.

On the CPU, JAX's model dispatch takes the per-block custom VJP
(schnet.py:409-424) while the port takes the stacked schedule: the two
differ only in summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.cutoff import CosineCutoff as JCosineCutoff
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.mlp import mlp_apply as jmlp_apply
from flashmd_tpu.models.schnet import SchNetConfig as JSchNetConfig
from flashmd_tpu.models.schnet import init_schnet as jinit_schnet
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.data.system import collate as jcollate
from flashmd_tpu_torch.models.cheb import (
    attach_cheb_fit,
    cheb_stack_apply,
    fit_chebyshev_filter_host,
)
from flashmd_tpu_torch.models.convert import (
    config_from_kwargs,
    forcefield_from_numpy,
)
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.models.mlp import mlp_apply
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like

RCUT = 4.0
F = 16
ORDER = 16
N_BLOCKS = 3
S = 2


def config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _stack_model(d_min):
    jcfg = JSchNetConfig(
        hidden_channels=F, embedding_size=4, num_filters=F, num_rbf=9,
        num_interactions=N_BLOCKS, cutoff=JCosineCutoff(0.0, RCUT),
        output_hidden_layer_widths=(8,), cheb_d_min=d_min,
        message_passing="cheb", cheb_order=ORDER,
    )
    params = jinit_schnet(jax.random.PRNGKey(0), jcfg)
    jfits = [
        jcheb.fit_chebyshev_filter_host(bp, params["rbf"], jcfg, order=ORDER)
        for bp in params["interactions"]
    ]
    np_params = jax.tree.map(np.asarray, params)
    cfg = config_from_kwargs(config_kwargs(jcfg))
    fits = [
        fit_chebyshev_filter_host(bp, np_params["rbf"], cfg, order=ORDER)
        for bp in np_params["interactions"]
    ]
    lins = [
        {k: torch.tensor(bp[k]) for k in
         ("lin1_w", "lin2_w", "lin2_b", "lin_w", "lin_b")}
        for bp in np_params["interactions"]
    ]
    return params, jfits, fits, lins


def _stack_inputs(a=23, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 6.0, (S, a, 3)).astype(np.float32)
    x0 = rng.normal(size=(S, a, F)).astype(np.float32)
    g = rng.normal(size=(S, a, F)).astype(np.float32)
    return pos, x0, g


@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_cheb_stack_matches_jax(d_min):
    params, jfits, fits, lins = _stack_model(d_min)
    pos, x0, g = _stack_inputs()

    def jloss(p, x, gg):
        out = jcheb.cheb_stack_apply(
            jfits, params["interactions"], p, x, RCUT, "fp32", d_min=d_min
        )
        return jnp.sum(out * gg), out

    jgrad = jax.jit(jax.vmap(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)
    ))
    (_, out_ref), (gpos_ref, gx0_ref) = jgrad(
        jnp.asarray(pos), jnp.asarray(x0), jnp.asarray(g)
    )

    tpos = torch.from_numpy(pos).requires_grad_(True)
    tx0 = torch.from_numpy(x0).requires_grad_(True)
    out = cheb_stack_apply(fits, lins, tpos, tx0, RCUT, "fp32", d_min=d_min)
    (out * torch.from_numpy(g)).sum().backward()
    # 1e-4 as tests/models/test_cheb_stack.py:130-135 (summation order).
    np.testing.assert_allclose(out.detach().numpy(), out_ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tpos.grad.numpy(), gpos_ref, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tx0.grad.numpy(), gx0_ref, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("mode", ["zero", "poison"])
def test_stack_param_cotangents(mode, monkeypatch):
    """Inference-only contract (reference cheb.py:638-652): parameter
    cotangents are exactly zero, NaN under FLASHMD_CHEB_PARAM_GRAD=poison;
    the position gradient is never poisoned."""
    if mode == "poison":
        monkeypatch.setenv("FLASHMD_CHEB_PARAM_GRAD", "poison")
    else:
        monkeypatch.delenv("FLASHMD_CHEB_PARAM_GRAD", raising=False)
    _, _, fits, lins = _stack_model(0.0)
    fits = [tuple(t.clone().requires_grad_(True) for t in f) for f in fits]
    lins = [{k: v.clone().requires_grad_(True) for k, v in lp.items()}
            for lp in lins]
    pos, x0, _ = _stack_inputs()
    tpos = torch.from_numpy(pos).requires_grad_(True)
    cheb_stack_apply(fits, lins, tpos, torch.from_numpy(x0), RCUT,
                     "fp32").sum().backward()
    assert torch.isfinite(tpos.grad).all()
    leaves = [t for f in fits for t in f] + [
        t for lp in lins for t in lp.values()
    ]
    for t in leaves:
        if mode == "poison":
            assert torch.isnan(t.grad).all()
        else:
            assert (t.grad == 0).all()


def _zoo_pair(precision, cheb_order=None):
    jff, jcfgs = jcgschnet(
        n_atoms=32, batch_size=S, num_interactions=2, precision=precision,
        message_passing="cheb", neighbor_capacity=32, cheb_order=cheb_order,
    )
    jff = jff.replace(
        schnet_params=jcheb.attach_cheb_fit(jff.schnet_params,
                                            jff.schnet_config)
    )
    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    del np_params["cheb_fit"]
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        config_kwargs(jff.schnet_config),
    )
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    return jff, jcfgs, ff


def test_weights_carried_bit_for_bit():
    jff, _, ff = _zoo_pair("bf16")
    jleaves = jax.tree_util.tree_leaves_with_path(dict(jff.schnet_params))
    for path, leaf in jleaves:
        node = ff.schnet_params
        for key in path:
            node = node[getattr(key, "key", getattr(key, "idx", None))]
        np.testing.assert_array_equal(np.asarray(node.cpu()),
                                      np.asarray(leaf))
    for name, p in jff.priors.items():
        for k, v in p.params.items():
            np.testing.assert_array_equal(
                ff.priors[name].params[k].numpy(), np.asarray(v)
            )
        np.testing.assert_array_equal(
            ff.priors[name].index_mapping.numpy(), np.asarray(p.index_mapping)
        )
    cfg = ff.schnet_config
    assert (cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min) == (
        48, 64, 2.0
    )


@pytest.mark.parametrize(
    "precision,cheb_order,tol",
    [
        # fp32 with an explicit small order: summation order only.
        ("fp32", 16, 1e-4),
        # bf16 defaults (48, 64, d_min 2): the port rounds bf16 operands on
        # the kernels' bases, JAX's per-block VJP on the Ttil basis.
        ("bf16", None, 2e-3),
    ],
)
def test_force_evaluation_matches_jax(precision, cheb_order, tol):
    jff, jcfgs, ff = _zoo_pair(precision, cheb_order)
    jsys = jcollate(jcfgs, dtype=jnp.float32)
    je, jf, jcomps = jax.jit(
        lambda p: jcompute_energy_forces(jff, p, jsys.atom_types)
    )(jsys.pos)
    pos = torch.tensor(np.asarray(jsys.pos))
    types = torch.tensor(np.asarray(jsys.atom_types)).long()
    e, f, comps = compute_energy_forces(ff, pos, types)
    jf = np.asarray(jf)
    assert f.shape == jf.shape and e.shape == (S,)
    assert np.abs(f.numpy() - jf).max() <= tol * np.abs(jf).max()
    assert set(comps) == set(jcomps)
    for name, v in comps.items():
        ref = np.asarray(jcomps[name])
        assert np.abs(v.numpy() - ref).max() <= tol * max(
            np.abs(ref).max(), 1.0
        ), name
    np.testing.assert_allclose(e.numpy(), np.asarray(je),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_mlp_tiers_match_jax(precision):
    """bf16: bf16 operands, float32 result, as the reference _dense; the
    product of two bf16 values is exact in float32, so only the summation
    order differs (1e-6)."""
    rng = np.random.default_rng(3)
    layers = [
        {"w": rng.normal(size=(16, 32)).astype(np.float32),
         "b": rng.normal(size=32).astype(np.float32)},
        {"w": rng.normal(size=(32, 4)).astype(np.float32)},
    ]
    x = rng.normal(size=(5, 16)).astype(np.float32)
    ref = jmlp_apply({"layers": jax.tree.map(jnp.asarray, layers)},
                     jnp.asarray(x), precision=precision)
    out = mlp_apply(
        {"layers": [{k: torch.from_numpy(v) for k, v in lay.items()}
                    for lay in layers]},
        torch.from_numpy(x), precision=precision,
    )
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_zoo_defaults_and_refusals():
    ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=2,
                                  num_interactions=1)
    cfg = ff.schnet_config
    assert (cfg.cheb_order, cfg.cheb_order_deriv, cfg.cheb_d_min,
            cfg.precision) == (48, 64, 2.0, "bf16")
    assert len(cfgs) == 2 and cfgs[0].pos.shape == (24, 3)
    with pytest.raises(NotImplementedError):
        cgschnet_1enh_like(n_atoms=24, batch_size=1, message_passing="xla")
    pos = torch.zeros(1, 24, 3)
    types = torch.zeros(24, dtype=torch.long)
    with pytest.raises(NotImplementedError):
        compute_energy_forces(ff, pos, types, cell=torch.eye(3))
    with pytest.raises(NotImplementedError):
        compute_energy_forces(
            ff.replace(exc_pair_index=torch.zeros(2, 1)), pos, types
        )
    with pytest.raises(ValueError):
        compute_energy_forces(ff, pos, types[None])
