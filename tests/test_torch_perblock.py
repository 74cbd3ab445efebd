"""Port parity for the per-block Chebyshev schedule (FLASHMD_CHEB_STACK=0):
the combined gx+gd backward's plain twin, the unstacked gd-only backward
of block 1, the per-block autograd Function and the SchNet branch that
reads the variable, against the JAX package on identical inputs.

fp32 twins are held against the Pallas kernel called directly in
interpreter mode (the JAX suite's backward tolerance, 1e-4); bf16 twins
against the pure-jnp _cheb_bwd of models/cheb.py. On the CPU the JAX model
always runs its per-block branch with that jnp backward (_use_pallas is
False there), so it is the oracle of the model-level tests too.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import cheb as jcheb
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.schnet import schnet_energy as jschnet_energy
from flashmd_tpu.models.zoo import cgschnet_1enh_like as jcgschnet
from flashmd_tpu.ops.pallas.cheb_kernel import cheb_conv_bwd_pallas
from flashmd_tpu_torch.models import schnet as tschnet
from flashmd_tpu_torch.models.cheb import (
    LIN_KEYS,
    _lin_slope,
    attach_cheb_fit,
    cheb_cfconv_apply,
)
from flashmd_tpu_torch.models.convert import forcefield_from_numpy
from flashmd_tpu_torch.models.forcefield import compute_energy_forces
from flashmd_tpu_torch.ops import cheb_kernel as ck
from tests.test_torch_threads import one_torch_thread  # noqa: F401

L = 9.0
RCUT = 4.0
F = 16
M1, M2 = 12, 16
S = 2
# rows = lattice vectors; smallest perpendicular width 8.93 > 2 rcut
CELLS = {
    "open": None,
    "cubic": L * np.eye(3, dtype=np.float32),
    "triclinic": np.array([[9.0, 0.0, 0.0], [1.0, 9.0, 0.0],
                           [0.5, 0.5, 9.0]], np.float32),
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _coeffs(seed=0):
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(M1, F)) / M1).astype(np.float32)
    c2 = (rng.normal(size=(M2, F)) / M2).astype(np.float32)
    w0 = rng.normal(size=(F,)).astype(np.float32)
    return c, c2, w0


def _inputs(a, seed=1):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, L, (S, a, 3)).astype(np.float32)
    x = rng.normal(size=(S, a, F)).astype(np.float32)
    g = rng.normal(size=(S, a, F)).astype(np.float32)
    return pos, x, g


def _jax_bwd(fn, cell, *arrays):
    """(gpos, gx) of a per-molecule JAX backward over the leading S axis."""
    outs = [
        fn(None if cell is None else jnp.asarray(cell),
           *(jnp.asarray(a[s]) for a in arrays))
        for s in range(S)
    ]
    return tuple(np.stack([np.asarray(o[k]) for o in outs]) for k in (0, 1))


@pytest.mark.parametrize("cell_kind", list(CELLS))
@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("a", [23, 48])
def test_gxgd_twin_matches_pallas_fp32(cell_kind, d_min, a):
    cell = CELLS[cell_kind]
    c, c2, w0 = _coeffs(seed=2)
    pos, x, g = _inputs(a, seed=3)
    gpos_ref, gx_ref = _jax_bwd(
        lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jnp.asarray(c), jnp.asarray(c2), jnp.asarray(w0), p, xx, gg,
            RCUT, "fp32", need_gx=True, need_gd=True, cell=cl, d_min=d_min,
        ),
        cell, pos, x, g,
    )
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    gpos, gx = ck.cheb_conv_bwd_gxgd(
        _t(c), _t(c2), _t(w0), _t(pos), _t(x), _t(g), RCUT, "fp32", d_min,
        w_lin, cell=None if cell is None else _t(cell),
    )
    # 1e-4: the JAX suite's backward kernel tolerance.
    np.testing.assert_allclose(gpos.numpy(), gpos_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx.numpy(), gx_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d_min", [0.0, 1.2])
@pytest.mark.parametrize("a", [23, 48])
def test_unstacked_gd_twin_matches_pallas_fp32(d_min, a):
    """Block 1's backward: the gd-only kernel on one block's [S, A, F]
    operands (reference need_gx=False, not stacked)."""
    c, c2, w0 = _coeffs(seed=4)
    pos, x, g = _inputs(a, seed=5)
    gpos_ref, gx_ref = _jax_bwd(
        lambda cl, p, xx, gg: cheb_conv_bwd_pallas(
            jnp.asarray(c), jnp.asarray(c2), jnp.asarray(w0), p, xx, gg,
            RCUT, "fp32", need_gx=False, d_min=d_min,
        ),
        None, pos, x, g,
    )
    assert not gx_ref.any()
    gpos = ck.cheb_conv_bwd_gd(_t(c2), _t(pos), _t(x), _t(g), RCUT, "fp32",
                               d_min)
    np.testing.assert_allclose(gpos.numpy(), gpos_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("cell_kind", ["open", "triclinic"])
@pytest.mark.parametrize("d_min", [0.0, 1.2])
def test_bf16_gxgd_twin_matches_jnp_branch(cell_kind, d_min):
    """bf16 combined twin vs the pure-jnp _cheb_bwd(need_gx=True)
    (cheb.py:655-772) at 1e-2 of the output's scale, for the reason
    test_torch_kernels.test_bf16_twins_match_jnp_branch states: the twin
    rounds on the kernels' own bases (That_k and q_k g; c2_m g), the jnp
    branch g, then c_m g, on the Ttil basis."""
    cell = CELLS[cell_kind]
    c, c2, w0 = _coeffs(seed=6)
    pos, x, g = _inputs(48, seed=7)
    jc, jc2, jw0 = (jnp.asarray(v) for v in (c, c2, w0))
    bwd = [
        jcheb._cheb_bwd(RCUT, "bf16", True, d_min,
                        (jc, jc2, jw0, jnp.asarray(pos[s]),
                         jnp.asarray(x[s]),
                         None if cell is None else jnp.asarray(cell)),
                        jnp.asarray(g[s]))
        for s in range(S)
    ]
    gpos_ref = np.stack([np.asarray(b[3]) for b in bwd])
    gx_ref = np.stack([np.asarray(b[4]) for b in bwd])
    w_lin = _lin_slope(_t(c2)) if d_min > 0 else None
    gpos, gx = ck.cheb_conv_bwd_gxgd(
        _t(c), _t(c2), _t(w0), _t(pos), _t(x), _t(g), RCUT, "bf16", d_min,
        w_lin, cell=None if cell is None else _t(cell),
    )

    def rel(a_, b_):
        return np.abs(a_ - b_).max() / np.abs(b_).max()

    assert rel(gx.numpy(), gx_ref) <= 1e-2
    assert rel(gpos.numpy(), gpos_ref) <= 1e-2


@functools.cache
def _carried_pair(precision, cheb_order, num_interactions=2):
    """A small zoo model in JAX and the same weights in the port, both
    with their host fits attached; built once per module and argument
    tuple (the tests derive their variants by ``replace``)."""
    jff, jcfgs = jcgschnet(
        n_atoms=32, batch_size=S, num_interactions=num_interactions,
        precision=precision, message_passing="cheb", neighbor_capacity=32,
        cheb_order=cheb_order,
    )
    np_params = jax.tree.map(np.asarray, dict(jff.schnet_params))
    np_params.pop("cheb_fit", None)
    ff = forcefield_from_numpy(
        np_params, jax.tree.map(np.asarray, jff.priors),
        {f.name: getattr(jff.schnet_config, f.name)
         for f in dataclasses.fields(jff.schnet_config)},
        device="cpu",
    )
    jff = jff.replace(schnet_params=jcheb.attach_cheb_fit(
        jff.schnet_params, jff.schnet_config))
    ff = ff.replace(schnet_params=attach_cheb_fit(ff.schnet_params,
                                                  ff.schnet_config))
    return jff, jcfgs, ff


# The 32-bead chain spans ~31 A; cells of 24 A (half width 12 > rcut 10)
# wrap its far pairs into the cutoff.
BIG_CUBIC = 24.0 * np.eye(3, dtype=np.float32)
BIG_TRICLINIC = np.array([[24.0, 0.0, 0.0], [3.0, 24.0, 0.0],
                          [2.0, 2.0, 24.0]], np.float32)


@pytest.mark.parametrize(
    "precision,cheb_order,tol,cell,priors",
    [
        # fp32 with an explicit small order: summation order only.
        ("fp32", 16, 1e-4, None, True),
        # bf16 defaults (48, 64, d_min 2): the port rounds bf16 operands on
        # the kernels' bases, JAX's per-block VJP on the Ttil basis.
        ("bf16", None, 2e-3, None, True),
        # periodic, as test_torch_pbc.test_periodic_forces_match_jax
        ("fp32", 16, 1e-4, np.stack([BIG_CUBIC, BIG_TRICLINIC]), False),
        ("bf16", None, 2e-3, np.stack([BIG_TRICLINIC, BIG_CUBIC]), True),
    ],
    ids=["fp32", "bf16", "fp32-periodic", "bf16-periodic"],
)
def test_perblock_forces_match_jax(precision, cheb_order, tol, cell, priors,
                                   monkeypatch):
    monkeypatch.setenv("FLASHMD_CHEB_STACK", "0")
    jff, jcfgs, ff = _carried_pair(precision, cheb_order)
    if not priors:
        jff, ff = jff.replace(priors={}), ff.replace(priors={})
    pos_np = np.stack([c.pos for c in jcfgs]).astype(np.float32)
    types = torch.tensor(jcfgs[0].atom_types).long()
    jcell = None if cell is None else jnp.asarray(cell)
    je, jf, _ = jcompute_energy_forces(
        jff, jnp.asarray(pos_np), jnp.asarray(jcfgs[0].atom_types),
        cell=jcell,
    )
    e, f, _ = compute_energy_forces(ff, _t(pos_np), types,
                                    cell=None if cell is None else _t(cell))
    jf = np.asarray(jf)
    assert np.abs(f.numpy() - jf).max() <= tol * np.abs(jf).max()
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=tol, atol=tol)


@pytest.mark.parametrize("cell", [None, np.stack([BIG_CUBIC, BIG_TRICLINIC])],
                         ids=["open", "periodic"])
def test_perblock_matches_stacked_fp32(cell, monkeypatch):
    """One function on two schedules: the port's per-block forces against
    its stacked ones, fp32, 1e-5 of max|F| (summation order only)."""
    _, jcfgs, ff = _carried_pair("fp32", 16, num_interactions=3)
    pos = _t(np.stack([c.pos for c in jcfgs]).astype(np.float32))
    types = torch.tensor(jcfgs[0].atom_types).long()
    tcell = None if cell is None else _t(cell)
    out = {}
    for stack in ("1", "0"):
        monkeypatch.setenv("FLASHMD_CHEB_STACK", stack)
        out[stack] = compute_energy_forces(ff, pos, types, cell=tcell)
    f_s, f_b = out["1"][1].numpy(), out["0"][1].numpy()
    assert np.abs(f_b - f_s).max() <= 1e-5 * np.abs(f_s).max()
    np.testing.assert_allclose(out["0"][0].numpy(), out["1"][0].numpy(),
                               rtol=1e-5)


def test_perblock_lin_gradients_match_jax(monkeypatch):
    """The per-block schedule leaves the linear layers in autograd: their
    gradients of the summed energy against jax.grad of the JAX energy
    (block 1's lin1_w gets zero in both: its conv's gx is dead)."""
    monkeypatch.setenv("FLASHMD_CHEB_STACK", "0")
    jff, jcfgs, ff = _carried_pair("fp32", 16, num_interactions=3)
    pos_np = np.stack([c.pos for c in jcfgs]).astype(np.float32)
    jtypes = jnp.asarray(jcfgs[0].atom_types)
    jcfg = jff.schnet_config

    def jenergy(params):
        return sum(jschnet_energy(params, jcfg, jnp.asarray(pos_np[s]),
                                  jtypes, None) for s in range(S))

    jgrads = jax.grad(jenergy)(jff.schnet_params)["interactions"]
    params = dict(ff.schnet_params)
    params["interactions"] = [
        {k: (v.clone().requires_grad_(True) if k in LIN_KEYS else v)
         for k, v in bp.items()}
        for bp in params["interactions"]
    ]
    tschnet.schnet_energy(params, ff.schnet_config, _t(pos_np),
                          torch.tensor(jcfgs[0].atom_types).long(), None
                          ).sum().backward()
    for b, (bp, jbp) in enumerate(zip(params["interactions"], jgrads)):
        for k in LIN_KEYS:
            ref = np.asarray(jbp[k])
            got = bp[k].grad.numpy()
            assert np.abs(got - ref).max() <= 1e-4 * max(
                np.abs(ref).max(), 1e-6), (b, k)
    assert not params["interactions"][0]["lin1_w"].grad.any()
    assert params["interactions"][1]["lin1_w"].grad.abs().max() > 0


@pytest.mark.parametrize("mode", ["zero", "poison"])
def test_perblock_param_cotangents(mode, monkeypatch):
    """Inference-only contract on the per-block schedule: the fits' c, c2
    and w0 get exactly zero (NaN under FLASHMD_CHEB_PARAM_GRAD=poison),
    the linear layers real gradients, the positions a finite one."""
    monkeypatch.setenv("FLASHMD_CHEB_STACK", "0")
    if mode == "poison":
        monkeypatch.setenv("FLASHMD_CHEB_PARAM_GRAD", "poison")
    else:
        monkeypatch.delenv("FLASHMD_CHEB_PARAM_GRAD", raising=False)
    _, jcfgs, ff = _carried_pair("fp32", 16, num_interactions=3)
    params = dict(ff.schnet_params)
    params["cheb_fit"] = tuple(
        tuple(t.clone().requires_grad_(True) for t in fit)
        for fit in params["cheb_fit"]
    )
    params["interactions"] = [
        {k: v.clone().requires_grad_(True) for k, v in bp.items()
         if k in LIN_KEYS}
        for bp in params["interactions"]
    ]
    pos = _t(np.stack([c.pos for c in jcfgs]).astype(np.float32))
    pos.requires_grad_(True)
    tschnet.schnet_energy(params, ff.schnet_config, pos,
                          torch.tensor(jcfgs[0].atom_types).long(), None
                          ).sum().backward()
    assert torch.isfinite(pos.grad).all() and pos.grad.abs().max() > 0
    for fit in params["cheb_fit"]:
        for t in fit:
            if mode == "poison":
                assert torch.isnan(t.grad).all()
            else:
                assert (t.grad == 0).all()
    lin_w = params["interactions"][2]["lin_w"].grad
    assert torch.isfinite(lin_w).all() and lin_w.abs().max() > 0


@pytest.mark.parametrize("value,per_block", [(None, False), ("1", False),
                                             ("0", True), ("no", True)])
def test_schedule_read_at_call_time(value, per_block, monkeypatch):
    """FLASHMD_CHEB_STACK unset or "1" runs the stack, any other value the
    per-block convs (block 1 without gx), read at each call."""
    if value is None:
        monkeypatch.delenv("FLASHMD_CHEB_STACK", raising=False)
    else:
        monkeypatch.setenv("FLASHMD_CHEB_STACK", value)
    calls = []

    def record(name, fn):
        def wrapped(*args, **kw):
            calls.append((name, args[7] if name == "conv" else None))
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(tschnet, "cheb_stack_apply",
                        record("stack", tschnet.cheb_stack_apply))
    monkeypatch.setattr(tschnet, "cheb_cfconv_apply",
                        record("conv", cheb_cfconv_apply))
    _, jcfgs, ff = _carried_pair("fp32", 16, num_interactions=3)
    pos = _t(np.stack([c.pos for c in jcfgs]).astype(np.float32))
    compute_energy_forces(ff, pos, torch.tensor(jcfgs[0].atom_types).long())
    if per_block:
        assert calls == [("conv", False), ("conv", True), ("conv", True)]
    else:
        assert calls == [("stack", None)]
