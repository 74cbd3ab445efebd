"""Port parity for the exact ``"xla"`` message-passing path: the cutoff
envelopes, the deterministic neighbour gather (ops/gather.py), the
path's building blocks and the whole force field, each against the JAX
package's xla path on identical inputs made with numpy and weights carried
across by ``forcefield_from_numpy``.

The JAX xla path runs no Pallas kernel, so its own functions are the
reference here. Tolerances, on max|port - jax| / max|jax|:
  * fp32: 1e-5 (summation order only);
  * bf16: 2e-3 (the rounded filter-MLP operands; the CPU rounds to nearest
    on both sides, the TPU truncates, ROADMAP queue C);
  * the envelopes on a distance grid: 1e-6 absolute;
  * the gather's backward against the plain ``index_add_``: 1e-6.
"""

import dataclasses
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.models import cutoff as jcut
from flashmd_tpu.models.forcefield import ForceField as JForceField
from flashmd_tpu.models.forcefield import (
    compute_energy_forces as jcompute_energy_forces,
)
from flashmd_tpu.models.forcefield import total_energy as jtotal_energy
from flashmd_tpu.models import schnet as jschnet
from flashmd_tpu.ops.neighborlist import (
    batched_radius_neighbor_matrix as jbatched,
)
from flashmd_tpu_torch.models import cutoff as cut
from flashmd_tpu_torch.models import schnet
from flashmd_tpu_torch.models.convert import (
    config_from_kwargs,
    forcefield_from_numpy,
)
from flashmd_tpu_torch.models.forcefield import (
    build_neighbors,
    compute_energy_forces,
    total_energy,
)
from flashmd_tpu_torch.models.zoo import cgschnet_1enh_like
from flashmd_tpu_torch.ops import neighborlist as nl
from flashmd_tpu_torch.ops.gather import neighbor_gather
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S, A, F, R, K = 2, 32, 16, 9, 16
RCUT = 4.0
L = 9.0  # cubic box: rcut < L / 2, the minimum image is sound
TRICLINIC = np.array([[9.0, 0.0, 0.0], [1.0, 9.0, 0.0], [0.5, 0.5, 9.0]],
                     np.float32)
CELLS = {
    "open": None,
    "cubic": L * np.eye(3, dtype=np.float32),  # [3, 3], shared
    "per_molecule": np.stack([L * np.eye(3, dtype=np.float32), TRICLINIC]),
}
TOL = {"fp32": 1e-5, "bf16": 2e-3}


def _rel(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max() / np.abs(ref).max())


def _config_kwargs(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.0, L, (S, A, 3)).astype(np.float32)
    types = rng.integers(0, 4, A)
    return pos, types


def _jax_ff(precision="fp32", remat="block", cutoff=None, rbf_cutoff=None,
            exc=None, capacity=K):
    jcfg = jschnet.SchNetConfig(
        hidden_channels=F, embedding_size=4, num_filters=F, num_rbf=R,
        num_interactions=2,
        cutoff=cutoff or jcut.CosineCutoff(0.0, RCUT),
        rbf_cutoff=rbf_cutoff, output_hidden_layer_widths=(8,),
        precision=precision, message_passing="xla", remat=remat,
    )
    params = jschnet.init_schnet(jax.random.PRNGKey(11), jcfg)
    return JForceField(
        schnet_params=params, priors={}, schnet_config=jcfg,
        neighbor_capacity=capacity,
        exc_pair_index=None if exc is None else jnp.asarray(exc),
    )


def _port_ff(jff, exc=None, **config_changes):
    ff = forcefield_from_numpy(
        jax.tree.map(np.asarray, jff.schnet_params), {},
        _config_kwargs(jff.schnet_config), device="cpu",
        neighbor_capacity=jff.neighbor_capacity, exc_pair_index=exc,
    )
    if config_changes:
        ff = ff.replace(schnet_config=dataclasses.replace(
            ff.schnet_config, **config_changes))
    return ff


def _cell_args(kind):
    c = CELLS[kind]
    return (None, None) if c is None else (jnp.asarray(c), torch.tensor(c))


# --------------------------------------------------------------------------
# envelopes
# --------------------------------------------------------------------------

ENVELOPES = [
    ("IdentityCutoff", {"cutoff_lower": 0.0, "cutoff_upper": RCUT}),
    ("CosineCutoff", {"cutoff_lower": 0.0, "cutoff_upper": RCUT}),
    ("CosineCutoff", {"cutoff_lower": 1.0, "cutoff_upper": RCUT}),
    ("ShiftedCosineCutoff", {"cutoff_lower": 0.0, "cutoff_upper": RCUT,
                             "smooth_width": 1.5}),
]


@pytest.mark.parametrize("name,fields", ENVELOPES)
def test_envelopes_match_jax(name, fields):
    d = np.linspace(-0.5, RCUT + 1.0, 2001).astype(np.float32)
    d = np.concatenate([d, [0.0, 1.0, RCUT, RCUT - 1.5]]).astype(np.float32)
    ref = getattr(jcut, name)(**fields)(jnp.asarray(d))
    out = getattr(cut, name)(**fields)(torch.tensor(d))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-6)


def test_check_cutoff_as_jax():
    for cls in ("IdentityCutoff", "CosineCutoff"):
        for mod in (jcut, cut):
            with pytest.raises(ValueError, match="less than lower"):
                getattr(mod, cls)(3.0, 2.0)
    # the shifted cosine checks its bounds where the basis takes it
    for mod, basis in ((jcut, "flashmd_tpu.models.radial_basis"),
                       (cut, "flashmd_tpu_torch.models.radial_basis")):
        module = __import__(basis, fromlist=["GaussianBasisConfig"])
        with pytest.raises(ValueError, match="less than lower"):
            module.GaussianBasisConfig(
                cutoff=mod.ShiftedCosineCutoff(3.0, 2.0))


def test_rbf_cutoff_defaults_and_warns_as_jax():
    conv = jcut.CosineCutoff(0.0, RCUT)
    for rbf in (jcut.CosineCutoff(0.5, RCUT), jcut.IdentityCutoff(0.0, 3.0)):
        with warnings.catch_warnings(record=True) as jw:
            warnings.simplefilter("always")
            jschnet.SchNetConfig(cutoff=conv, rbf_cutoff=rbf)
        kw = _config_kwargs(jschnet.SchNetConfig(cutoff=conv))
        kw.update(rbf_cutoff=rbf, message_passing="xla")
        with warnings.catch_warnings(record=True) as pw:
            warnings.simplefilter("always")
            cfg = config_from_kwargs(kw)
        assert [str(w.message) for w in pw] == [str(w.message) for w in jw]
        assert len(pw) == 1
        assert cfg.rbf_config.cutoff == cfg.rbf_cutoff
    cfg = schnet.SchNetConfig(message_passing="xla")
    assert cfg.rbf_cutoff == cfg.cutoff and cfg.remat == "block"
    with pytest.raises(ValueError, match="remat"):
        schnet.SchNetConfig(message_passing="xla", remat="full")


# --------------------------------------------------------------------------
# the neighbour gather
# --------------------------------------------------------------------------


def _lists():
    """An overflowed open list (asymmetric) and an image-replicated list
    (sources repeated within a row)."""
    pos, _ = _inputs(1)
    open_nbr = nl.batched_radius_neighbor_matrix(torch.tensor(pos), RCUT, 8)
    small = 5.0 * np.eye(3, dtype=np.float32)
    images = nl.compute_image_shifts(small, RCUT)
    img_pos = torch.tensor(pos[:, :6] * (5.0 / L))
    img_nbr = nl.batched_radius_neighbor_matrix(
        img_pos, RCUT, 64, cell=torch.tensor(small), images=images)
    return {"open": open_nbr, "images": img_nbr}


@pytest.mark.parametrize("kind", ["open", "images"])
@pytest.mark.parametrize("f", [3, F])
def test_gather_backward_is_the_csr_transpose(kind, f):
    nbr = _lists()[kind]
    s, a, k = nbr.idx.shape
    if kind == "images":  # one source fills several slots of a row
        live = nbr.idx[0, 0][nbr.mask[0, 0]]
        assert len(live) > len(torch.unique(live))
    gen = torch.Generator().manual_seed(3)
    src = torch.randn(s, a, f, generator=gen, requires_grad=True)
    out = neighbor_gather(src, nbr)
    flat = (torch.arange(s)[:, None, None] * a + nbr.idx.long()).reshape(-1)
    torch.testing.assert_close(
        out, src.detach().reshape(s * a, f)[flat].reshape(s, a, k, f),
        rtol=0, atol=0)
    # cotangents as the xla path gives them: zero on masked slots
    g = torch.randn(s, a, k, f, generator=gen) * nbr.mask[..., None]
    (gsrc,) = torch.autograd.grad(out, src, g)
    ref = torch.zeros(s * a, f).index_add_(0, flat, g.reshape(-1, f))
    np.testing.assert_allclose(gsrc.reshape(s * a, f).numpy(), ref.numpy(),
                               rtol=0, atol=1e-6)
    (again,) = torch.autograd.grad(neighbor_gather(src, nbr), src, g)
    assert torch.equal(again, gsrc)


def test_gather_needs_the_csr():
    pos, _ = _inputs()
    nbr = nl.radius_neighbor_matrix(torch.tensor(pos[0]), RCUT, K)
    with pytest.raises(ValueError, match="source CSR"):
        neighbor_gather(torch.zeros(1, A, 3), nbr)


def test_xla_path_uses_no_atomic_scatter():
    """The gather's backward is the CSR segment sum: the xla modules call
    no index_add_, scatter_add_ or accumulating index_put_."""
    import inspect

    from flashmd_tpu_torch.ops import gather

    for mod in (gather, schnet):
        src = inspect.getsource(mod)
        for call in ("index_add_(", "scatter_add_(", "accumulate=True"):
            assert call not in src, (mod.__name__, call)


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("cell_kind", ["open", "per_molecule"])
def test_blocks_match_jax(precision, cell_kind):
    """neighbor_distances_rbf, cfconv_apply and interaction_block_apply on
    the same list (built by each package) and inputs."""
    jff = _jax_ff(precision)
    ff = _port_ff(jff)
    pos, _ = _inputs(2)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(S, A, F)).astype(np.float32)
    jcell, tcell = _cell_args(cell_kind)
    jnbr = jbatched(jnp.asarray(pos), RCUT, K, cell=jcell)
    nbr = nl.batched_radius_neighbor_matrix(torch.tensor(pos), RCUT, K,
                                            cell=tcell)
    np.testing.assert_array_equal(nbr.idx.numpy(), np.asarray(jnbr.idx))
    jp, jc = jff.schnet_params, jff.schnet_config
    p, c = ff.schnet_params, ff.schnet_config
    jbp, bp = jp["interactions"][1], p["interactions"][1]

    def jblocks(pos_one, x_one, n):
        d, rbf = jschnet.neighbor_distances_rbf(jp, jc, pos_one, n)
        y = jschnet.cfconv_apply(jbp, jc, x_one, d, rbf, n)
        z = jschnet.interaction_block_apply(jbp, jc, x_one, d, rbf, n)
        return d, rbf, y, z

    ref = jax.vmap(jblocks)(jnp.asarray(pos), jnp.asarray(x), jnbr)
    tpos, tx = torch.tensor(pos), torch.tensor(x)
    d, rbf = schnet.neighbor_distances_rbf(p, c, tpos, nbr)
    y = schnet.cfconv_apply(bp, c, tx, d, rbf, nbr)
    z = schnet.interaction_block_apply(bp, c, tx, d, rbf, nbr)
    # the geometry has no bf16 step: fp32 tolerance on both tiers
    assert _rel(d, ref[0]) <= 1e-5 and _rel(rbf, ref[1]) <= 1e-5
    assert _rel(y, ref[2]) <= TOL[precision]
    assert _rel(z, ref[3]) <= TOL[precision]


# --------------------------------------------------------------------------
# the whole force field
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_reference(precision, cell_kind):
    jff = _jax_ff(precision)
    pos, types = _inputs(3)
    jcell, _ = _cell_args(cell_kind)
    e, f, _ = jax.jit(lambda p: jcompute_energy_forces(
        jff, p, jnp.asarray(types), cell=jcell))(jnp.asarray(pos))
    return jff, np.asarray(e), np.asarray(f)


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("cell_kind", list(CELLS))
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_forces_match_jax(precision, cell_kind, remat):
    jff, je, jf = _jax_reference(precision, cell_kind)
    ff = _port_ff(jff, remat=remat)
    assert ff.schnet_config.remat == remat
    pos, types = _inputs(3)
    _, tcell = _cell_args(cell_kind)
    e, f, comps = compute_energy_forces(ff, torch.tensor(pos),
                                        torch.tensor(types), cell=tcell)
    assert f.shape == (S, A, 3) and set(comps) == {"SchNet"}
    assert _rel(e, je) <= TOL[precision]
    assert _rel(f, jf) <= TOL[precision]
    if cell_kind != "open":  # the cell changes the answer
        _, _, jf_open = _jax_reference(precision, "open")
        assert _rel(f, jf_open) > 1e-2


FIELD_CASES = {
    "exclusions": {},
    "identity": {"cutoff": jcut.IdentityCutoff(0.0, RCUT)},
    "cosine_lower": {"cutoff": jcut.CosineCutoff(1.0, RCUT)},
    "shifted_cosine": {"cutoff": jcut.ShiftedCosineCutoff(0.0, RCUT, 1.5)},
    "rbf_cutoff": {"rbf_cutoff": jcut.IdentityCutoff(0.0, RCUT - 1.0)},
}


@pytest.mark.parametrize("case", list(FIELD_CASES))
def test_field_variants_match_jax(case):
    """fp32 energies and forces with pair exclusions, under each envelope,
    and with a radial-basis cutoff other than the conv cutoff."""
    pos, types = _inputs(4)
    exc = (np.random.default_rng(6).integers(0, A, (2, 40))
           if case == "exclusions" else None)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # rbf_cutoff differs
        jff = _jax_ff(exc=exc, **FIELD_CASES[case])
        ff = _port_ff(jff, exc=exc)
    je, jf, _ = jax.jit(lambda p: jcompute_energy_forces(
        jff, p, jnp.asarray(types)))(jnp.asarray(pos))
    e, f, _ = compute_energy_forces(ff, torch.tensor(pos),
                                    torch.tensor(types))
    assert _rel(e, je) <= TOL["fp32"]
    assert _rel(f, jf) <= TOL["fp32"]
    assert (type(ff.schnet_config.cutoff).__name__
            == type(jff.schnet_config.cutoff).__name__)
    if exc is not None:  # the exclusions change the forces
        f_all = compute_energy_forces(ff.replace(exc_pair_index=None),
                                      torch.tensor(pos),
                                      torch.tensor(types))[1]
        assert _rel(f_all, f) > 1e-3


@pytest.mark.parametrize("remat", ["block", "none"])
def test_parameter_gradients_match_jax(remat):
    """The xla path is the one with real parameter gradients: dE/d lin1_w
    and dE/d (the filter's first weight) of each block against jax.grad,
    1e-5 of max|jax|."""
    jff = _jax_ff("fp32")
    pos, types = _inputs(5)
    jcell, tcell = _cell_args("cubic")
    jnbr = jbatched(jnp.asarray(pos), RCUT, K, cell=jcell)

    def jloss(params):
        one = lambda p, n: jtotal_energy(  # noqa: E731
            jff.replace(schnet_params=params), p, jnp.asarray(types), n)[0]
        return jnp.sum(jax.vmap(one)(jnp.asarray(pos), jnbr))

    jgrad = jax.grad(jloss)(jff.schnet_params)
    ff = _port_ff(jff, remat=remat)
    leaves = []
    for bp in ff.schnet_params["interactions"]:
        for t in (bp["lin1_w"], bp["filter"]["layers"][0]["w"]):
            t.requires_grad_(True)
            leaves.append(t)
    nbr = build_neighbors(ff, torch.tensor(pos), cell=tcell)
    total, _ = total_energy(ff, torch.tensor(pos), torch.tensor(types), nbr)
    grads = torch.autograd.grad(total.sum(), leaves)
    refs = [g for bp in jgrad["interactions"]
            for g in (bp["lin1_w"], bp["filter"]["layers"][0]["w"])]
    for g, ref in zip(grads, refs):
        assert float(np.abs(np.asarray(ref)).max()) > 0
        assert _rel(g, ref) <= 1e-5


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_two_evaluations_are_bitwise_equal(precision):
    pos, types = _inputs(6)
    ff = _port_ff(_jax_ff(precision))
    args = (torch.tensor(pos), torch.tensor(types))
    e1, f1, _ = compute_energy_forces(ff, *args, cell=torch.tensor(TRICLINIC))
    e2, f2, _ = compute_energy_forces(ff, *args, cell=torch.tensor(TRICLINIC))
    assert torch.equal(f1, f2) and torch.equal(e1, e2)


def test_remat_gives_the_same_forces():
    """block and none compute one function; the recompute under the
    checkpoint is the forward again, so they agree to the last bits the
    backward's summation order allows."""
    ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=S,
                                  num_interactions=2, message_passing="xla",
                                  precision="fp32", device="cpu")
    pos = torch.tensor(np.stack([c.pos for c in cfgs]), dtype=torch.float32)
    types = torch.tensor(cfgs[0].atom_types)
    none = ff.replace(schnet_config=dataclasses.replace(ff.schnet_config,
                                                        remat="none"))
    f_block = compute_energy_forces(ff, pos, types)[1]
    f_none = compute_energy_forces(none, pos, types)[1]
    assert _rel(f_block, f_none.numpy()) <= 1e-6


def test_images_need_the_exact_path():
    """Port fix of the reference's fault 2 (ROADMAP queue C;
    flashmd_tpu/models/forcefield.py:218): image shifts on a path other
    than xla would bypass both minimum-image walls (the reference runs a
    cheb field with pbc_images in a small cell); here compute_energy_forces
    and build_neighbors raise."""
    ff, cfgs = cgschnet_1enh_like(n_atoms=24, batch_size=1,
                                  num_interactions=1, message_passing="cheb",
                                  device="cpu")
    small = 8.0 * np.eye(3)
    images = tuple(map(tuple, nl.compute_image_shifts(small, ff.rcut)))
    pos = torch.tensor(cfgs[0].pos[None], dtype=torch.float32)
    types = torch.tensor(cfgs[0].atom_types)
    for mp in ("cheb", "pallas", "dense"):
        other = ff.replace(
            schnet_config=dataclasses.replace(ff.schnet_config,
                                              message_passing=mp),
            pbc_images=images)
        with pytest.raises(NotImplementedError, match="pbc_images"):
            compute_energy_forces(other, pos, types,
                                  cell=torch.tensor(small))
        with pytest.raises(NotImplementedError, match="pbc_images"):
            build_neighbors(other, pos, cell=torch.tensor(small))
