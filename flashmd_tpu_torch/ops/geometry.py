"""Internal coordinates: distances, angles, torsions (port of
flashmd_tpu/ops/geometry.py).

Positions carry the batch as a leading axis, ``pos [S, A, 3]``; the index
map (int64 tensor) is ``mapping [order, n_terms]``, shared by the batch,
or ``[S, order, n_terms]``, one per molecule (a mixed-size batch). Each
function returns ``[S, n_terms]`` (``compute_distance_vectors``:
``[S, n_terms, 1]`` and ``[S, n_terms, 3]``).
"""

from __future__ import annotations

import math

import torch


def _atoms(pos: torch.Tensor, mapping: torch.Tensor, k: int):
    """[S, n_terms, 3]: the k-th atom of every term, from a shared map or
    from each molecule's own (one flat index, so that the backward is the
    same index accumulation as for a shared map)."""
    if mapping.ndim == 2:
        return pos[:, mapping[k]]
    s, a = pos.shape[0], pos.shape[1]
    base = torch.arange(s, device=pos.device)[:, None] * a
    return pos.reshape(s * a, pos.shape[-1])[mapping[:, k] + base]


def safe_norm(x, axis: int = -1, keepdims: bool = True, eps: float = 1e-16):
    """sqrt(sum(x^2) + eps) - sqrt(eps): differentiable at 0 (reference
    geometry.py:23-33, whose argument names it keeps)."""
    return (torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=keepdims)
                       + eps) - math.sqrt(eps))


def safe_normalization(x, norms):
    """x / norms where norms > 0, x unchanged elsewhere (reference
    geometry.py:36-47); the untaken branch divides by 1, never by 0."""
    mask = norms > 0.0
    safe = torch.where(mask, norms, torch.ones_like(norms))
    return torch.where(mask, x / safe, x)


def compute_distance_vectors(pos: torch.Tensor, mapping: torch.Tensor,
                             cell_shifts=None):
    """(safe-norm distances [S, T, 1], unit vectors [S, T, 3]) of
    r_j - r_i, with ``cell_shifts`` added to the displacement where given
    (reference geometry.py:50-65)."""
    dr = _atoms(pos, mapping, 1) - _atoms(pos, mapping, 0)
    if cell_shifts is not None:
        dr = dr + cell_shifts
    distances = safe_norm(dr, axis=-1, keepdims=True)
    return distances, safe_normalization(dr, distances)


def compute_distances(pos: torch.Tensor, mapping: torch.Tensor,
                      cell_shifts=None):
    """Plain 2-norm of r_j - r_i, with ``cell_shifts`` ([S, T, 3] or
    broadcastable) added to the displacement where given (reference
    geometry.py:66-81)."""
    dr = _atoms(pos, mapping, 1) - _atoms(pos, mapping, 0)
    if cell_shifts is not None:
        dr = dr + cell_shifts
    return torch.linalg.vector_norm(dr, dim=-1)


def compute_angles_raw(pos: torch.Tensor, mapping: torch.Tensor,
                       cell_shifts=None):
    """theta_ijk in radians, atan2(|r_ij x r_kj|, r_ij . r_kj) (reference
    geometry.py:84-99). ``cell_shifts`` is taken and not read, as in the
    reference."""
    dr1 = _atoms(pos, mapping, 0) - _atoms(pos, mapping, 1)
    dr2 = _atoms(pos, mapping, 2) - _atoms(pos, mapping, 1)
    n = torch.linalg.vector_norm(torch.cross(dr1, dr2, dim=-1), dim=-1)
    d = torch.sum(dr1 * dr2, dim=-1)
    return torch.atan2(n, d)


def compute_angles_cos(pos: torch.Tensor, mapping: torch.Tensor,
                       cell_shifts=None):
    """cos(theta_ijk) (reference geometry.py:100-115). ``cell_shifts`` is
    taken and not read, as in the reference."""
    dr1 = _atoms(pos, mapping, 0) - _atoms(pos, mapping, 1)
    dr2 = _atoms(pos, mapping, 2) - _atoms(pos, mapping, 1)
    dot = torch.sum(dr1 * dr2, dim=-1)
    norms = torch.linalg.vector_norm(dr1, dim=-1) * torch.linalg.vector_norm(
        dr2, dim=-1
    )
    return dot / norms


def _normalize(x, eps: float = 1e-12):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def compute_torsions(pos: torch.Tensor, mapping: torch.Tensor):
    """Dihedral or improper phi_ijkl, MDTraj sign: atan2(-(n1 x r_kj) . n2,
    n1 . n2) on normalised bond vectors (reference geometry.py:118-141)."""
    dr1 = _normalize(_atoms(pos, mapping, 1) - _atoms(pos, mapping, 0))
    dr2 = _normalize(_atoms(pos, mapping, 2) - _atoms(pos, mapping, 1))
    dr3 = _normalize(_atoms(pos, mapping, 3) - _atoms(pos, mapping, 2))
    n1 = torch.cross(dr1, dr2, dim=-1)
    n2 = torch.cross(dr2, dr3, dim=-1)
    m1 = torch.cross(n1, dr2, dim=-1)
    y = torch.sum(m1 * n2, dim=-1)
    x = torch.sum(n1 * n2, dim=-1)
    return torch.atan2(-y, x)
