"""Internal coordinates: distances, angle cosines, torsions (port of
flashmd_tpu/ops/geometry.py).

Positions carry the batch as a leading axis, ``pos [S, A, 3]``; the index
map ``mapping [order, n_terms]`` (int64 tensor) is shared by the batch.
Each function returns ``[S, n_terms]``.
"""

from __future__ import annotations

import torch


def compute_distances(pos: torch.Tensor, mapping: torch.Tensor):
    """Plain 2-norm of r_j - r_i (reference geometry.py:66-81)."""
    dr = pos[:, mapping[1]] - pos[:, mapping[0]]
    return torch.linalg.vector_norm(dr, dim=-1)


def compute_angles_cos(pos: torch.Tensor, mapping: torch.Tensor):
    """cos(theta_ijk) (reference geometry.py:100-115)."""
    dr1 = pos[:, mapping[0]] - pos[:, mapping[1]]
    dr2 = pos[:, mapping[2]] - pos[:, mapping[1]]
    dot = torch.sum(dr1 * dr2, dim=-1)
    norms = torch.linalg.vector_norm(dr1, dim=-1) * torch.linalg.vector_norm(
        dr2, dim=-1
    )
    return dot / norms


def _normalize(x, eps: float = 1e-12):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def compute_torsions(pos: torch.Tensor, mapping: torch.Tensor):
    """Dihedral phi_ijkl, MDTraj sign: atan2(-(n1 x r_kj) . n2, n1 . n2)
    on normalised bond vectors (reference geometry.py:124-141)."""
    dr1 = _normalize(pos[:, mapping[1]] - pos[:, mapping[0]])
    dr2 = _normalize(pos[:, mapping[2]] - pos[:, mapping[1]])
    dr3 = _normalize(pos[:, mapping[3]] - pos[:, mapping[2]])
    n1 = torch.cross(dr1, dr2, dim=-1)
    n2 = torch.cross(dr2, dr3, dim=-1)
    m1 = torch.cross(n1, dr2, dim=-1)
    y = torch.sum(m1 * n2, dim=-1)
    x = torch.sum(n1 * n2, dim=-1)
    return torch.atan2(-y, x)
