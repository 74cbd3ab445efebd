"""Fixed-capacity, padded radius graph on the device (port of
flashmd_tpu/ops/neighborlist.py, open boundaries only).

The neighbour structure is a padded per-atom matrix ``idx [S, A, K]`` +
``mask [S, A, K]`` with a static capacity K, each row nearest first, so
capacity overflow drops the farthest pairs. It is built in plain PyTorch
on the device from the [S, A, A] squared distances, as the reference
builds it in XLA outside any kernel.

Beside the matrix, the batched build keeps the **source CSR** that the
neighbour-matrix CFConv backward (ops/cfconv.py) walks for its column side:
the live (mask) slots grouped by source atom ``s A + idx``, in slot order,
as flat slot ids ``(s A + i) K + k`` (``csr_slots``, padded to S A K
entries with the masked slots) with group offsets ``csr_offsets [S A +
1]``. A stable sort gives it, so its order is fixed by the list; it is the
exact transpose of the list, an asymmetric (overflowed) list included.

The list builders refuse periodic cells: image replication and
minimum-image shifts on the list belong to the exact ``xla`` path, which
is not ported (ROADMAP A11); a ``cell`` or ``images`` argument raises.
The minimum-image helpers that the Chebyshev path needs are here:
``_inv_3x3``, ``min_cell_width`` and ``validate_min_image``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class NeighborMatrix:
    """Padded per-atom neighbourhood (reference NeighborMatrix,
    neighborlist.py:58-77).

    ``idx[s, i, k]`` is the k-th nearest neighbour of atom i (padded with
    ``i`` itself), ``mask[s, i, k]`` marks real neighbours, ``n_max[s]`` is
    the largest true neighbour count before truncation. ``csr_offsets`` /
    ``csr_slots`` are the source CSR of the batched build (module
    docstring); None for a single molecule.
    """

    idx: torch.Tensor  # [S, A, K] int32 (or [A, K])
    mask: torch.Tensor  # [S, A, K] bool
    n_max: torch.Tensor  # [S] int32 (or [])
    csr_offsets: Optional[torch.Tensor] = None  # [S*A + 1] int32
    csr_slots: Optional[torch.Tensor] = None  # [S*A*K] int32

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


def _refuse_periodic(cell, images):
    if cell is not None or images is not None:
        raise NotImplementedError(
            "Periodic cells and image replication are not ported to the "
            "neighbour list yet (ROADMAP A11): the port builds open-boundary "
            "lists only."
        )


def _inv_3x3(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse (adjugate / det) of [..., 3, 3] lattices, in the
    dtype of ``m`` (reference _inv_3x3, neighborlist.py:80-94)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    det = a * co[..., 0, 0] + b * co[..., 1, 0] + c * co[..., 2, 0]
    return co / det[..., None, None]


def min_cell_width(cell) -> float:
    """Smallest perpendicular width of a (possibly triclinic) cell whose
    rows are the lattice vectors: volume / area of the face spanned by the
    other two, which is smaller than the row norms for a skewed cell
    (reference min_cell_width, neighborlist.py:97-113)."""
    c = np.asarray(cell, dtype=np.float64)
    vol = abs(float(np.linalg.det(c)))
    widths = [
        vol / float(np.linalg.norm(np.cross(c[(k + 1) % 3], c[(k + 2) % 3])))
        for k in range(3)
    ]
    return min(widths)


def validate_min_image(cell, rcut: float, context: str = "") -> None:
    """Raise unless the minimum-image convention is sound for ``cell``:
    ``rcut`` must be < half the smallest perpendicular width, or second
    images sit within the cutoff and minimum image silently drops them
    (reference validate_min_image, neighborlist.py:162-202).

    ``cell`` may be None (no-op), a [3, 3] lattice or an [S, 3, 3] batch,
    as numpy or a tensor; a tensor on the card is copied to the host, so
    callers on a hot loop validate once, ahead of it."""
    if cell is None:
        return
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    c = np.asarray(cell)
    if c.ndim == 3:
        for one in c:
            validate_min_image(one, rcut, context)
        return
    width = min_cell_width(c)
    if rcut >= 0.5 * width:
        where = f" ({context})" if context else ""
        raise ValueError(
            f"Minimum-image convention is unsound{where}: the search "
            f"radius {rcut:g} must be < half the smallest perpendicular "
            f"cell width ({width:g} / 2 = {0.5 * width:g}). A smaller "
            "cell has multiple periodic images of the same pair within "
            "the cutoff, which minimum image silently drops — wrong "
            "periodic physics. Use a larger box (or a smaller cutoff/"
            "neighbor_skin); sub-minimum-image cells are out of scope "
            "(see PARITY.md; the reference replicates images instead, "
            "torch_impl.py:102-163)."
        )


def _build(pos, rcut, capacity, exclude_pairs):
    """(idx, mask, n_max) of the batched build."""
    s, n_atoms, _ = pos.shape
    dr = pos[:, None, :, :] - pos[:, :, None, :]  # [s, i, j] = p_j - p_i
    d2 = (dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1]) + (
        dr[..., 2] * dr[..., 2]
    )
    valid = (d2 < rcut * rcut) & ~torch.eye(n_atoms, dtype=torch.bool,
                                             device=pos.device)
    if exclude_pairs is not None:
        ep = torch.as_tensor(exclude_pairs, device=pos.device).long()
        excl = torch.zeros(n_atoms, n_atoms, dtype=torch.bool,
                           device=pos.device)
        excl[ep[0], ep[1]] = True
        excl[ep[1], ep[0]] = True
        valid = valid & ~excl

    # Nearest first; ties keep the lower index first, as lax.top_k does.
    k_eff = min(capacity, n_atoms)
    key = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices[..., :k_eff]
    mask = torch.gather(valid, -1, order)
    row = torch.arange(n_atoms, dtype=torch.int32, device=pos.device)
    row = row[None, :, None].expand(s, n_atoms, k_eff)
    idx = torch.where(mask, order.to(torch.int32), row)
    if k_eff < capacity:  # capacity exceeds the atom count: pad slots
        pad = capacity - k_eff
        idx = torch.cat([idx, row[..., :1].expand(s, n_atoms, pad)], dim=-1)
        mask = torch.cat([mask, mask.new_zeros(s, n_atoms, pad)], dim=-1)
    n_max = valid.sum(dim=-1).amax(dim=-1).to(torch.int32)
    return idx.contiguous(), mask.contiguous(), n_max


def source_csr(idx, mask):
    """(csr_offsets [S A + 1], csr_slots [S A K]) int32: the mask slots
    grouped by source ``s A + idx``, in slot order within a group (a stable
    sort); the masked slots follow at the end."""
    s, n_atoms, k = idx.shape
    dev = idx.device
    base = torch.arange(s, device=dev, dtype=torch.int64)[:, None, None]
    src = torch.where(mask, base * n_atoms + idx.long(), s * n_atoms)
    src = src.reshape(-1)
    slots = torch.sort(src, stable=True).indices
    offsets = torch.searchsorted(
        src[slots], torch.arange(s * n_atoms + 1, device=dev)
    )
    return offsets.to(torch.int32), slots.to(torch.int32)


def batched_radius_neighbor_matrix(
    pos: torch.Tensor,
    rcut: float,
    capacity: int,
    cell=None,
    exclude_pairs=None,
    images=None,
) -> NeighborMatrix:
    """Padded neighbour matrices of a [S, A, 3] batch, with the source CSR
    (reference batched_radius_neighbor_matrix, neighborlist.py:390-426).

    Pairs i != j with d < rcut (strict) are neighbours; ``exclude_pairs``
    [2, P] are dropped in both directions. ``n_max`` is per molecule."""
    _refuse_periodic(cell, images)
    with torch.no_grad():
        idx, mask, n_max = _build(pos, rcut, capacity, exclude_pairs)
        offsets, slots = source_csr(idx, mask)
    return NeighborMatrix(idx=idx, mask=mask, n_max=n_max,
                          csr_offsets=offsets, csr_slots=slots)


def radius_neighbor_matrix(
    pos: torch.Tensor,
    rcut: float,
    capacity: int,
    cell=None,
    exclude_pairs=None,
    images=None,
) -> NeighborMatrix:
    """The padded neighbour matrix of one molecule, pos [A, 3] (reference
    radius_neighbor_matrix, neighborlist.py:224-309); no source CSR."""
    _refuse_periodic(cell, images)
    with torch.no_grad():
        idx, mask, n_max = _build(pos[None], rcut, capacity, exclude_pairs)
    return NeighborMatrix(idx=idx[0], mask=mask[0], n_max=n_max[0])


def suggest_capacity(n_true_max: int, slack: float = 1.25, align: int = 8):
    """Round a measured max neighbour count up to an aligned static
    capacity (reference neighborlist.py:502-505)."""
    cap = int(n_true_max * slack) + 1
    return ((cap + align - 1) // align) * align


def max_neighbor_count(pos, rcut: float) -> int:
    """Max per-atom neighbour count at ``rcut`` on the host, in float64
    (the numpy branch of the reference's native ``max_neighbor_count``,
    flashmd_tpu/native/__init__.py:89-128, open boundaries)."""
    pos = np.ascontiguousarray(pos, dtype=np.float64)
    dr = pos[None, :, :] - pos[:, None, :]
    d2 = np.einsum("ijk,ijk->ij", dr, dr)
    np.fill_diagonal(d2, np.inf)
    return int((d2 < rcut * rcut).sum(axis=1).max(initial=0))
