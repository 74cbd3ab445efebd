"""Classical prior terms (port of flashmd_tpu/prior/priors.py), for the
four kinds the zoo builds: ``harmonic_bonds``, ``harmonic_angles`` (cos),
``dihedral`` (Fourier) and ``repulsion_dense``. Any other kind raises.

A :class:`Prior` holds its per-term parameters directly; ``prior_energy``
evaluates the whole batch ``pos [S, A, 3] -> [S]``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..ops.geometry import (
    compute_angles_cos,
    compute_distances,
    compute_torsions,
)

FEATURE_FNS = {
    "distance": compute_distances,
    "angle_cos": compute_angles_cos,
    "torsion": compute_torsions,
}

KINDS = ("harmonic_bonds", "harmonic_angles", "dihedral", "repulsion_dense")


@dataclasses.dataclass
class Prior:
    """A specialised prior: static index map + per-term parameters."""

    index_mapping: torch.Tensor  # [order, n_terms] int64
    params: Dict[str, torch.Tensor]
    kind: str = "harmonic_bonds"
    name: str = "bonds"
    feature: str = "distance"

    def __post_init__(self):
        if self.kind not in KINDS and self.kind != "repulsion":
            raise NotImplementedError(
                f"prior kind {self.kind!r} is not ported to "
                "flashmd_tpu_torch yet"
            )


def harmonic_compute(x, x0, k):
    """k (x - x0)^2 (reference priors.py:69-71, V0 = 0)."""
    return k * torch.square(x - x0)


def fourier_compute(theta, v_0, k1s, k2s):
    """v0 + sum_n k1_n sin(n theta) + k2_n cos(n theta); k1s/k2s
    [n_terms, n_degs] (reference priors.py:74-83)."""
    n_k = k1s.shape[1]
    n_degs = torch.arange(1, n_k + 1, dtype=theta.dtype, device=theta.device)
    angles = theta[..., None] * n_degs
    v = k1s * torch.sin(angles) + k2s * torch.cos(angles)
    if v_0.ndim > 1:
        v_0 = v_0[:, 0]
    return torch.sum(v, dim=-1) + v_0


def prior_energy(prior: Prior, pos: torch.Tensor) -> torch.Tensor:
    """Per-molecule prior energy, [S]."""
    p = prior.params
    if prior.kind == "repulsion_dense":
        # Dense-pair (sigma/d)^6 over the [A, A] matrix; sigma6 is zero on
        # excluded pairs (reference priors.py:184-195).
        sigma6 = p["sigma6"]
        rel = pos[:, None, :, :] - pos[:, :, None, :]
        d2 = torch.sum(rel * rel, dim=-1)
        live = sigma6 > 0
        d2_safe = torch.where(live, d2, torch.ones_like(d2))
        inv6 = 1.0 / (d2_safe * d2_safe * d2_safe)
        e = torch.where(live, sigma6 * inv6, torch.zeros_like(inv6))
        return torch.sum(e, dim=(1, 2))
    if prior.kind not in KINDS:
        raise NotImplementedError(
            f"prior kind {prior.kind!r} is evaluated densely only: call "
            "densify_repulsion first"
        )
    feats = FEATURE_FNS[prior.feature](pos, prior.index_mapping)
    if prior.kind in ("harmonic_bonds", "harmonic_angles"):
        terms = harmonic_compute(feats, p["x0"], p["k"])
    else:
        terms = fourier_compute(feats, p["v_0"], p["k1s"], p["k2s"])
    return torch.sum(terms, dim=-1)


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
