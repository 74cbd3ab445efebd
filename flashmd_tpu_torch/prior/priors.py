"""Classical prior terms (port of flashmd_tpu/prior/priors.py), every
kind of the reference: the harmonic family (bonds, cos and raw angles,
impropers and phase-shifted impropers, general bonds and angles),
Fourier dihedrals, polynomial and quartic angles, restricted quartic
bending, and term-list and dense repulsion.

A :class:`Prior` holds its per-term parameters directly (gathered once
from the type tables, ``gather_type_params``); ``prior_energy`` evaluates
the whole batch ``pos [S, A, 3] -> [S]``. The constructors from
type-indexed statistics are numpy, copied from the reference, and place
the gathered parameters on ``device``.

A prior is shared by the batch (``index_mapping`` [order, T], parameters
[T, ...], ``term_mask`` [T] or None), or, in a mixed-size batch, one per
molecule stacked along a leading [S] axis (``stack_priors``: index
mapping [S, order, T], parameters [S, ...], ``term_mask`` [S, T], dense
``sigma6`` [S, A, A]); the features then gather each molecule's atoms
from its own map. ``pad_prior`` pads a prior to more terms with masked
copies of its first, which add exactly zero energy and gradient.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ..ops.geometry import (
    compute_angles_cos,
    compute_angles_raw,
    compute_distances,
    compute_torsions,
)


def _torsion_shifted(pos, mapping):
    """Torsions shifted for distributions peaked at +-pi (reference
    priors.py:47-54)."""
    feats = compute_torsions(pos, mapping)
    return torch.where(feats < 0, feats + 2 * math.pi, feats) - math.pi


FEATURE_FNS = {
    "distance": compute_distances,
    "angle_cos": compute_angles_cos,
    "angle_raw": compute_angles_raw,
    "torsion": compute_torsions,
    "torsion_shifted": _torsion_shifted,
}

# kind -> feature (reference priors.py:116-130)
_KIND_FEATURES = {
    "repulsion_dense": "distance",
    "harmonic_bonds": "distance",
    "harmonic_angles": "angle_cos",
    "harmonic_angles_raw": "angle_raw",
    "harmonic_impropers": "torsion",
    "shifted_periodic_harmonic_impropers": "torsion_shifted",
    "general_bonds": "distance",
    "general_angles": "angle_cos",
    "repulsion": "distance",
    "dihedral": "torsion",
    "polynomial": "angle_cos",
    "quartic_angles": "angle_cos",
    "restricted_quartic": "angle_raw",
}
KINDS = tuple(_KIND_FEATURES)
HARMONIC_KINDS = (
    "harmonic_bonds",
    "harmonic_angles",
    "harmonic_angles_raw",
    "harmonic_impropers",
    "shifted_periodic_harmonic_impropers",
    "general_bonds",
    "general_angles",
)


@dataclasses.dataclass
class Prior:
    """A specialised prior: static index map + per-term parameters.
    ``term_mask`` ([n_terms] float, 1 = real term, 0 = dropped) selects the
    terms that count, energy and gradient; None counts every term."""

    index_mapping: torch.Tensor  # [order, n_terms] int64
    params: Dict[str, torch.Tensor]
    kind: str = "harmonic_bonds"
    name: str = "bonds"
    feature: str = "distance"
    term_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise NotImplementedError(f"Unknown prior kind: {self.kind}")

    @property
    def batched(self) -> bool:
        """Whether the leaves carry a leading per-molecule [S] axis."""
        return self.index_mapping.ndim == 3

    @property
    def order(self) -> int:
        return self.index_mapping.shape[-2]

    @property
    def n_terms(self) -> int:
        return self.index_mapping.shape[-1]

    def replace(self, **changes) -> "Prior":
        return dataclasses.replace(self, **changes)


def harmonic_compute(x, x0, k, V0=0.0):
    """k (x - x0)^2 + V0 (reference priors.py:69-71)."""
    return k * torch.square(x - x0) + V0


def fourier_compute(theta, v_0, k1s, k2s):
    """v0 + sum_n k1_n sin(n theta) + k2_n cos(n theta); k1s/k2s
    [n_terms, n_degs], or [S, n_terms, n_degs] stacked (reference
    priors.py:74-83)."""
    n_k = k1s.shape[-1]
    n_degs = torch.arange(1, n_k + 1, dtype=theta.dtype, device=theta.device)
    angles = theta[..., None] * n_degs
    v = k1s * torch.sin(angles) + k2s * torch.cos(angles)
    if v_0.ndim == k1s.ndim:  # [..., T, 1]
        v_0 = v_0[..., 0]
    return torch.sum(v, dim=-1) + v_0


def repulsion_compute(x, sigma):
    """(sigma / x)^6 (reference priors.py:86-89)."""
    rr = (sigma / x) * (sigma / x)
    return rr * rr * rr


def polynomial_compute(x, ks, V0):
    """V0 + sum_n k_n x^n, powers built incrementally; ks [n_degs, n_terms]
    (reference priors.py:92-101)."""
    v = ks[0] * x
    x_pow = x
    for k in ks[1:]:
        x_pow = x_pow * x
        v = v + k * x_pow
    return v + V0


def restricted_quartic_compute(x, a, b, c, d, k, v_0):
    """a cos^4 + b cos^3 + c cos^2 + d cos + k / sin^2 + v0 (reference
    priors.py:104-112)."""
    cos = torch.cos(x)
    sin = torch.sin(x)
    quart = a * cos**4 + b * cos**3 + c * cos**2 + d * cos
    return quart + k / (sin**2) + v_0


def _dense_repulsion_energy(sigma6, pos):
    """Dense-pair (sigma/d)^6 over the [A, A] matrix; sigma6 is zero on
    excluded pairs (reference priors.py:184-195)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    d2 = torch.sum(rel * rel, dim=-1)
    live = sigma6 > 0
    d2_safe = torch.where(live, d2, torch.ones_like(d2))
    inv6 = 1.0 / (d2_safe * d2_safe * d2_safe)
    e = torch.where(live, sigma6 * inv6, torch.zeros_like(inv6))
    return torch.sum(e, dim=(1, 2))


def prior_energy(prior: Prior, pos: torch.Tensor) -> torch.Tensor:
    """Per-molecule prior energy, [S] (reference priors.py:162-213), of a
    shared or a stacked (per-molecule) prior."""
    kind = prior.kind
    p = prior.params
    if kind == "repulsion_dense":
        return _dense_repulsion_energy(p["sigma6"], pos)
    feats = FEATURE_FNS[prior.feature](pos, prior.index_mapping)
    if kind in HARMONIC_KINDS:
        terms = harmonic_compute(feats, p["x0"], p["k"], p.get("V0", 0.0))
    elif kind == "repulsion":
        terms = repulsion_compute(feats, p["sigma"])
    elif kind == "dihedral":
        terms = fourier_compute(feats, p["v_0"], p["k1s"], p["k2s"])
    elif kind in ("polynomial", "quartic_angles"):
        ks = p["ks"]  # [n_degs, T], stacked [S, n_degs, T]
        if prior.batched:
            ks = ks.transpose(0, 1)
        terms = polynomial_compute(feats, ks, p["v_0"])
    else:  # restricted_quartic
        terms = restricted_quartic_compute(
            feats, p["a"], p["b"], p["c"], p["d"], p["k"], p["v_0"]
        )
    if prior.term_mask is not None:
        terms = torch.where(prior.term_mask > 0, terms,
                            torch.zeros_like(terms))
    return torch.sum(terms, dim=-1)


# ---------------------------------------------------------------------------
# Priors from type-indexed statistics (reference priors.py:216-420)
# ---------------------------------------------------------------------------


def _dense_tables_from_statistics(statistics, order, field_names):
    """Dense [max_type+1]^order float64 tables from a statistics dict
    (reference priors.py:216-230)."""
    keys = np.asarray(list(statistics.keys()), dtype=np.int64)
    if keys.ndim == 1:
        keys = keys[:, None]
    if keys.min() < 0:
        raise ValueError("statistics keys must be non-negative atom types")
    max_type = int(keys.max())
    sizes = tuple(max_type + 1 for _ in range(order))
    tables = {f: np.zeros(sizes, dtype=np.float64) for f in field_names}
    for key, stats in statistics.items():
        idx = tuple(np.atleast_1d(np.asarray(key, dtype=np.int64)))
        for f in field_names:
            tables[f][idx] = np.asarray(stats[f], dtype=np.float64)
    return tables


def gather_type_params(table, atom_types, index_mapping) -> np.ndarray:
    """table[types[m_0], types[m_1], ...] -> per-term numpy vector, once
    per simulation (reference priors.py:233-243)."""
    table = np.asarray(table)
    types = np.asarray(atom_types)
    mapping = np.asarray(index_mapping)
    return table[tuple(types[mapping[i]] for i in range(mapping.shape[0]))]


def _mapping(index_mapping) -> np.ndarray:
    if isinstance(index_mapping, torch.Tensor):
        index_mapping = index_mapping.cpu().numpy()
    return np.asarray(index_mapping, dtype=np.int64)


def _prior(mapping, params, kind, name, device, dtype) -> Prior:
    return Prior(
        index_mapping=torch.as_tensor(mapping, dtype=torch.int64,
                                      device=device),
        params={k: torch.as_tensor(np.asarray(v), dtype=dtype, device=device)
                for k, v in params.items()},
        kind=kind,
        name=name,
        feature=_KIND_FEATURES[kind],
    )


_HARMONIC_NAMES = {
    "harmonic_bonds": "bonds",
    "harmonic_angles": "angles",
    "harmonic_angles_raw": "angles",
    "harmonic_impropers": "impropers",
    "shifted_periodic_harmonic_impropers": "impropers",
    "general_bonds": "bonds",
    "general_angles": "angles",
}


def harmonic_prior(statistics, atom_types, index_mapping,
                   kind: str = "harmonic_bonds", name: Optional[str] = None,
                   device="cuda", dtype=torch.float32) -> Prior:
    """Any harmonic-family prior from a statistics dict (reference
    priors.py:246-284)."""
    mapping = _mapping(index_mapping)
    tables = _dense_tables_from_statistics(statistics, mapping.shape[0],
                                           ["x_0", "k"])
    params = {
        "x0": gather_type_params(tables["x_0"], atom_types, mapping),
        "k": gather_type_params(tables["k"], atom_types, mapping),
    }
    return _prior(mapping, params, kind, name or _HARMONIC_NAMES[kind],
                  device, dtype)


def repulsion_prior(statistics, atom_types, index_mapping,
                    name: str = "repulsion", device="cuda",
                    dtype=torch.float32) -> Prior:
    """(sigma/x)^6 excluded-volume prior (reference priors.py:287-305)."""
    mapping = _mapping(index_mapping)
    tables = _dense_tables_from_statistics(statistics, 2, ["sigma"])
    params = {"sigma": gather_type_params(tables["sigma"], atom_types,
                                          mapping)}
    return _prior(mapping, params, "repulsion", name, device, dtype)


def _degree_tables(statistics, order, n_degs, group, prefix):
    """([n_degs, T^order] coefficient tables, [T^order] v_0) from the
    statistics' nested ``group`` dicts keyed ``{prefix}_{n}``."""
    keys = np.asarray(list(statistics.keys()), dtype=np.int64)
    sizes = tuple(int(keys.max()) + 1 for _ in range(order))
    k = np.zeros((n_degs,) + sizes)
    v_0 = np.zeros(sizes)
    for key, stats in statistics.items():
        idx = tuple(np.asarray(key, dtype=np.int64))
        for ii in range(n_degs):
            k[(ii,) + idx] = np.asarray(stats[group][f"{prefix}_{ii + 1}"])
        v_0[idx] = np.asarray(stats["v_0"])
    return k, v_0


def dihedral_prior(statistics, atom_types, index_mapping, n_degs: int = 3,
                   name: str = "dihedrals", device="cuda",
                   dtype=torch.float32) -> Prior:
    """Fourier-series dihedral prior (reference priors.py:308-356)."""
    mapping = _mapping(index_mapping)
    order = mapping.shape[0]
    k1, v_0 = _degree_tables(statistics, order, n_degs, "k1s", "k1")
    k2, _ = _degree_tables(statistics, order, n_degs, "k2s", "k2")
    params = {
        "k1s": np.stack([gather_type_params(k1[i], atom_types, mapping)
                         for i in range(n_degs)], axis=1),
        "k2s": np.stack([gather_type_params(k2[i], atom_types, mapping)
                         for i in range(n_degs)], axis=1),
        "v_0": gather_type_params(v_0, atom_types, mapping)[:, None],
    }
    return _prior(mapping, params, "dihedral", name, device, dtype)


def polynomial_prior(statistics, atom_types, index_mapping, n_degs: int = 4,
                     kind: str = "polynomial", name: str = "angles",
                     device="cuda", dtype=torch.float32) -> Prior:
    """Polynomial / QuarticAngles prior (reference priors.py:359-394)."""
    mapping = _mapping(index_mapping)
    k, v_0 = _degree_tables(statistics, mapping.shape[0], n_degs, "ks", "k")
    params = {
        "ks": np.stack([gather_type_params(k[i], atom_types, mapping)
                        for i in range(n_degs)], axis=0),
        "v_0": gather_type_params(v_0, atom_types, mapping),
    }
    return _prior(mapping, params, kind, name, device, dtype)


def restricted_quartic_prior(statistics, atom_types, index_mapping,
                             name: str = "angles", device="cuda",
                             dtype=torch.float32) -> Prior:
    """Restricted-quartic bending prior (reference priors.py:397-418)."""
    mapping = _mapping(index_mapping)
    fields = ["a", "b", "c", "d", "k", "v_0"]
    tables = _dense_tables_from_statistics(statistics, 3, fields)
    params = {f: gather_type_params(tables[f], atom_types, mapping)
              for f in fields}
    return _prior(mapping, params, "restricted_quartic", name, device, dtype)


def densify_repulsion(prior: Prior, n_atoms: int) -> Prior:
    """Term-list repulsion -> dense sigma^6 matrix, one direction per term
    (reference priors.py:421-440)."""
    if prior.kind != "repulsion":
        raise ValueError("densify_repulsion expects a repulsion prior")
    idx = prior.index_mapping.cpu().numpy()
    sigma = prior.params["sigma"].cpu().numpy().astype(np.float64)
    mat = np.zeros((n_atoms, n_atoms), dtype=np.float64)
    mat[idx[0], idx[1]] += sigma**6
    return Prior(
        index_mapping=prior.index_mapping,
        params={
            "sigma6": torch.as_tensor(
                mat, dtype=torch.float32, device=prior.params["sigma"].device
            )
        },
        kind="repulsion_dense",
        name=prior.name,
        feature="distance",
    )


# ---------------------------------------------------------------------------
# Mixed-size batches: padding and stacking per-molecule priors (reference
# priors.py:443-562)
# ---------------------------------------------------------------------------


def _term_axis(name: str) -> int:
    """The term axis of a parameter leaf: polynomial ``ks`` is
    [n_degs, T], every other leaf [T, ...]."""
    return 1 if name == "ks" else 0


def pad_prior(prior: Prior, n_terms: int) -> Prior:
    """The prior padded to ``n_terms`` terms, the padding masked out
    (reference pad_prior, priors.py:456-512).

    Padding terms copy the first term (indices and parameters), whose
    features and partials are finite, so the masked select of
    :func:`prior_energy` gives them exactly zero energy and gradient. A
    prior without terms is padded with consecutive atoms 0..order-1 and
    zero parameters. Polynomial ``ks`` pad along their term axis (the
    reference pads them along the degree axis)."""
    if prior.kind == "repulsion_dense":
        raise ValueError(
            "pad_prior pads term lists; densify after stacking instead "
            "(dense repulsion pads by zero-extending sigma6)."
        )
    t = prior.n_terms
    if n_terms < t:
        raise ValueError(f"Cannot pad {t} terms down to {n_terms}")
    idx = prior.index_mapping
    mask = prior.term_mask
    if mask is None:
        mask = torch.ones(t, dtype=torch.float32, device=idx.device)
    if n_terms == t:
        return prior.replace(term_mask=mask)
    extra = n_terms - t
    if t > 0:
        idx_pad = idx[:, :1].expand(-1, extra)
        params_pad = {
            k: v.narrow(_term_axis(k), 0, 1).repeat_interleave(
                extra, dim=_term_axis(k))
            for k, v in prior.params.items()
        }
    else:
        idx_pad = torch.arange(prior.order, dtype=idx.dtype,
                               device=idx.device)[:, None].expand(-1, extra)
        params_pad = {}
        for k, v in prior.params.items():
            shape = list(v.shape)
            shape[_term_axis(k)] = extra
            params_pad[k] = v.new_zeros(shape)
    return prior.replace(
        index_mapping=torch.cat([idx, idx_pad], dim=1),
        params={k: torch.cat([v, params_pad[k]], dim=_term_axis(k))
                for k, v in prior.params.items()},
        term_mask=torch.cat([mask, mask.new_zeros(extra)]),
    )


def stack_priors(priors) -> Prior:
    """Per-molecule priors of one kind stacked into one prior whose leaves
    carry a leading [S] axis, each padded to the largest term count
    (reference stack_priors, priors.py:515-562); dense repulsion
    zero-extends ``sigma6`` to the largest atom count instead."""
    priors = list(priors)
    if not priors:
        raise ValueError("stack_priors needs at least one prior")
    ref = priors[0]
    for p in priors:
        if (p.kind, p.name, p.feature, p.order) != (
            ref.kind, ref.name, ref.feature, ref.order,
        ):
            raise ValueError(
                "stack_priors requires matching (kind, name, feature, "
                f"order): got {(p.kind, p.name, p.feature, p.order)} vs "
                f"{(ref.kind, ref.name, ref.feature, ref.order)}"
            )
    if ref.kind == "repulsion_dense":
        a_max = max(p.params["sigma6"].shape[0] for p in priors)
        mats = [torch.nn.functional.pad(
                    p.params["sigma6"],
                    (0, a_max - p.params["sigma6"].shape[0]) * 2)
                for p in priors]
        return ref.replace(
            index_mapping=ref.index_mapping.new_zeros(
                (len(priors), ref.order, 0)),
            params={"sigma6": torch.stack(mats)},
        )
    t_max = max(p.n_terms for p in priors)
    padded = [pad_prior(p, t_max) for p in priors]
    return ref.replace(
        index_mapping=torch.stack([p.index_mapping for p in padded]),
        params={k: torch.stack([p.params[k] for p in padded])
                for k in ref.params},
        term_mask=torch.stack([p.term_mask for p in padded]),
    )
