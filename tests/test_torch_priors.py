"""Port parity for the prior terms and their geometry
(flashmd_tpu_torch/prior/priors.py, ops/geometry.py) against the JAX
package on identical inputs made with numpy.

Every one of the 13 prior kinds is evaluated on a batch of S molecules,
with and without a term mask, energy and forces (autograd against
``jax.grad``); the priors made from type-indexed statistics and the type
gather against the reference's; the geometry functions the kinds use.
Tolerance: max|port - jax| / max|jax| <= 1e-5 in float32 (summation
order and the transcendental functions' last ulps).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.ops import geometry as jgeo
from flashmd_tpu.prior import priors as jpriors
from flashmd_tpu_torch.ops import geometry as geo
from flashmd_tpu_torch.prior import priors
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S, A, T_MAX = 3, 12, 9
TOL = 1e-5


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
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(out) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _positions(seed=0):
    """A bent chain spread so that no two beads come close."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(size=(A, 3)) + [1.5, 0.0, 0.0], axis=0)
    return (base[None] + 0.1 * rng.normal(size=(S, A, 3))).astype(np.float32)


def _mapping(order):
    """Consecutive tuples (i, i+1, ..., i+order-1), plus for pairs the
    (i, i+3) ones."""
    idx = np.arange(A - order + 1)
    rows = [idx + k for k in range(order)]
    if order == 2:
        rows = [np.concatenate([idx, idx[:-2]]),
                np.concatenate([idx + 1, idx[:-2] + 3])]
    return np.stack(rows).astype(np.int64)


def _params(kind, n, rng):
    u = lambda lo, hi, *shape: rng.uniform(lo, hi, shape or (n,))  # noqa
    if kind == "repulsion_dense":
        sig = rng.uniform(0.5, 1.0, (A, A))
        sig[rng.uniform(size=(A, A)) < 0.3] = 0.0
        np.fill_diagonal(sig, 0.0)
        return {"sigma6": sig**6}
    if kind in priors.HARMONIC_KINDS:
        feat = priors._KIND_FEATURES[kind]
        lo, hi = {"distance": (1.0, 2.0), "angle_cos": (-0.5, 0.5),
                  "angle_raw": (1.5, 2.5)}.get(feat, (-math.pi, math.pi))
        return {"x0": u(lo, hi), "k": u(1.0, 5.0)}
    if kind == "repulsion":
        return {"sigma": u(0.5, 1.0)}
    if kind == "dihedral":
        return {"k1s": u(-1, 1, n, 3), "k2s": u(-1, 1, n, 3),
                "v_0": u(-1, 1, n, 1)}
    if kind in ("polynomial", "quartic_angles"):
        return {"ks": u(-2, 2, 4, n), "v_0": u(-1, 1)}
    return {f: u(-1, 1) for f in ("a", "b", "c", "d", "v_0")} | {
        "k": u(0.1, 0.5)}


def _prior_pair(kind, masked, seed=0):
    rng = np.random.default_rng(seed)
    feature = priors._KIND_FEATURES[kind]
    order = {"distance": 2, "angle_cos": 3, "angle_raw": 3}.get(feature, 4)
    mapping = _mapping(order)
    n = mapping.shape[1]
    params = {k: np.asarray(v, np.float32)
              for k, v in _params(kind, n, rng).items()}
    mask = (rng.uniform(size=n) < 0.6).astype(np.float32) if masked else None
    jp = jpriors.Prior(
        index_mapping=jnp.asarray(mapping, jnp.int32),
        params={k: jnp.asarray(v) for k, v in params.items()},
        kind=kind, name=kind, feature=feature,
        term_mask=None if mask is None else jnp.asarray(mask),
    )
    pp = priors.Prior(
        index_mapping=torch.tensor(mapping),
        params={k: torch.tensor(v) for k, v in params.items()},
        kind=kind, name=kind, feature=feature,
        term_mask=None if mask is None else torch.tensor(mask),
    )
    return jp, pp


def _jax_energy_forces(jp, pos):
    def energy(p):
        return jpriors.prior_energy(jp, p)

    e = jax.vmap(energy)(jnp.asarray(pos))
    f = -jax.vmap(jax.grad(energy))(jnp.asarray(pos))
    return np.asarray(e), np.asarray(f)


def _port_energy_forces(pp, pos):
    p = torch.tensor(pos, requires_grad=True)
    e = priors.prior_energy(pp, p)
    (g,) = torch.autograd.grad(e.sum(), p)
    return e.detach(), -g


def test_every_reference_kind_is_ported():
    assert set(priors.KINDS) == set(jpriors._KIND_FEATURES)
    assert priors._KIND_FEATURES == jpriors._KIND_FEATURES
    assert len(priors.KINDS) == 13
    with pytest.raises(NotImplementedError, match="Unknown prior kind"):
        priors.Prior(index_mapping=torch.zeros(2, 1, dtype=torch.long),
                     params={}, kind="mystery")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "term_mask"])
@pytest.mark.parametrize("kind", sorted(jpriors._KIND_FEATURES))
def test_prior_energy_and_forces_match_jax(kind, masked):
    jp, pp = _prior_pair(kind, masked)
    pos = _positions()
    e_ref, f_ref = _jax_energy_forces(jp, pos)
    e, f = _port_energy_forces(pp, pos)
    assert e.shape == (S,) and f.shape == (S, A, 3)
    assert _rel(e, e_ref) <= TOL, kind
    assert _rel(f, f_ref) <= TOL, kind
    if masked and kind != "repulsion_dense":
        # (the dense form has no terms: its zeros of sigma6 mask pairs)
        # the masked terms add nothing: the same prior restricted to the
        # kept terms gives the same energy
        keep = pp.term_mask > 0
        sub = priors.Prior(
            index_mapping=pp.index_mapping[:, keep],
            params={k: (v[:, keep] if k == "ks" else v[keep])
                    for k, v in pp.params.items()},
            kind=kind, name=kind, feature=pp.feature,
        )
        np.testing.assert_allclose(
            priors.prior_energy(sub, torch.tensor(pos)).numpy(), e.numpy(),
            rtol=1e-6)


def _stats(order, n_types, rng, fields):
    keys = [tuple(int(t) for t in k)
            for k in np.ndindex(*(n_types,) * order)]
    return {k: {f: float(rng.uniform(0.5, 1.5)) for f in fields}
            for k in keys}


@pytest.mark.parametrize("kind", ["harmonic_bonds", "harmonic_angles",
                                  "harmonic_angles_raw", "harmonic_impropers",
                                  "general_bonds", "general_angles"])
def test_harmonic_prior_from_statistics_matches_jax(kind):
    rng = np.random.default_rng(3)
    feature = priors._KIND_FEATURES[kind]
    order = {"distance": 2, "angle_cos": 3, "angle_raw": 3}.get(feature, 4)
    types = rng.integers(0, 3, A)
    mapping = _mapping(order)
    stats = _stats(order, 3, rng, ["x_0", "k"])
    jp = jpriors.harmonic_prior(stats, types, mapping, kind=kind)
    pp = priors.harmonic_prior(stats, types, mapping, kind=kind,
                               device="cpu")
    assert (pp.kind, pp.name, pp.feature) == (jp.kind, jp.name, jp.feature)
    for k in jp.params:
        np.testing.assert_array_equal(pp.params[k].numpy(),
                                      np.asarray(jp.params[k]))
    pos = _positions()
    assert _rel(_port_energy_forces(pp, pos)[1],
                _jax_energy_forces(jp, pos)[1]) <= TOL


def test_other_priors_from_statistics_match_jax():
    rng = np.random.default_rng(5)
    types = rng.integers(0, 2, A)
    m2, m3, m4 = _mapping(2), _mapping(3), _mapping(4)
    rep = _stats(2, 2, rng, ["sigma"])
    dih = {k: {"k1s": {f"k1_{i}": rng.normal() for i in (1, 2)},
               "k2s": {f"k2_{i}": rng.normal() for i in (1, 2)},
               "v_0": rng.normal()}
           for k in _stats(4, 2, rng, [])}
    poly = {k: {"ks": {f"k_{i}": rng.normal() for i in (1, 2, 3)},
                "v_0": rng.normal()}
            for k in _stats(3, 2, rng, [])}
    rq = _stats(3, 2, rng, ["a", "b", "c", "d", "k", "v_0"])
    pairs = [
        (jpriors.repulsion_prior(rep, types, m2),
         priors.repulsion_prior(rep, types, m2, device="cpu")),
        (jpriors.dihedral_prior(dih, types, m4, n_degs=2),
         priors.dihedral_prior(dih, types, m4, n_degs=2, device="cpu")),
        (jpriors.polynomial_prior(poly, types, m3, n_degs=3,
                                  kind="quartic_angles"),
         priors.polynomial_prior(poly, types, m3, n_degs=3,
                                 kind="quartic_angles", device="cpu")),
        (jpriors.restricted_quartic_prior(rq, types, m3),
         priors.restricted_quartic_prior(rq, types, m3, device="cpu")),
    ]
    pos = _positions(1)
    for jp, pp in pairs:
        assert (pp.kind, pp.name, pp.feature) == (jp.kind, jp.name,
                                                  jp.feature)
        assert set(pp.params) == set(jp.params)
        for k in jp.params:
            np.testing.assert_array_equal(pp.params[k].numpy(),
                                          np.asarray(jp.params[k]))
        e, f = _port_energy_forces(pp, pos)
        e_ref, f_ref = _jax_energy_forces(jp, pos)
        assert _rel(e, e_ref) <= TOL and _rel(f, f_ref) <= TOL, pp.kind


def test_gather_type_params_and_densify_match_jax():
    rng = np.random.default_rng(7)
    types = rng.integers(0, 4, A)
    table = rng.normal(size=(4, 4, 4))
    mapping = _mapping(3)
    # JAX gathers from a float32 copy of the float64 table
    np.testing.assert_array_equal(
        priors.gather_type_params(table, types, mapping).astype(np.float32),
        np.asarray(jpriors.gather_type_params(table, types,
                                              jnp.asarray(mapping))))
    jp, pp = _prior_pair("repulsion", masked=False)
    jd = jpriors.densify_repulsion(jp, A)
    pd = priors.densify_repulsion(pp, A)
    np.testing.assert_allclose(pd.params["sigma6"].numpy(),
                               np.asarray(jd.params["sigma6"]), rtol=1e-6)
    pos = _positions(2)
    assert _rel(_port_energy_forces(pd, pos)[1],
                _jax_energy_forces(jd, pos)[1]) <= TOL


def _single(fn_port, fn_jax, pos, mapping):
    out = fn_port(torch.tensor(pos), torch.tensor(mapping))
    ref = np.stack([np.asarray(fn_jax(jnp.asarray(p), jnp.asarray(mapping)))
                    for p in pos])
    return out, ref


@pytest.mark.parametrize("name,order", [
    ("compute_distances", 2), ("compute_angles_cos", 3),
    ("compute_angles_raw", 3), ("compute_torsions", 4),
])
def test_geometry_matches_jax(name, order):
    pos = _positions(4)
    out, ref = _single(getattr(geo, name), getattr(jgeo, name), pos,
                       _mapping(order))
    assert out.shape == (S, _mapping(order).shape[1])
    assert _rel(out, ref) <= TOL


def test_distance_vectors_and_safe_norm_match_jax():
    pos = _positions(5)
    mapping = _mapping(2)
    shifts = np.random.default_rng(0).normal(
        size=(mapping.shape[1], 3)).astype(np.float32)
    for cs in (None, shifts):
        d, u = geo.compute_distance_vectors(
            torch.tensor(pos), torch.tensor(mapping),
            None if cs is None else torch.tensor(cs))
        for s in range(S):
            jd, ju = jgeo.compute_distance_vectors(
                jnp.asarray(pos[s]), jnp.asarray(mapping),
                None if cs is None else jnp.asarray(cs))
            assert _rel(d[s], jd) <= TOL and _rel(u[s], ju) <= TOL
    x = np.concatenate([np.zeros((1, 3)), pos[0]]).astype(np.float32)
    np.testing.assert_allclose(geo.safe_norm(torch.tensor(x)).numpy(),
                               np.asarray(jgeo.safe_norm(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    # the zero vector passes through the normalisation unchanged
    n = geo.safe_norm(torch.tensor(x))
    np.testing.assert_array_equal(
        geo.safe_normalization(torch.tensor(x), n)[0].numpy(), x[0])


def test_shifted_torsions_match_jax():
    pos = _positions(6)
    out, ref = _single(priors._torsion_shifted, jpriors._torsion_shifted,
                       pos, _mapping(4))
    assert _rel(out, ref) <= TOL
