"""Fixed-capacity, padded radius graph on the device (port of
flashmd_tpu/ops/neighborlist.py).

The neighbour structure is a padded per-atom matrix ``idx [S, A, K]`` +
``mask [S, A, K]`` with a static capacity K, each row nearest first, so
capacity overflow drops the farthest pairs. It is built in plain PyTorch
on the device from the [S, A, A] squared distances, as the reference
builds it in XLA outside any kernel.

Beside the matrix, the batched build keeps the **source CSR** that the
neighbour-matrix CFConv backward (ops/cfconv.py) and the neighbour gather
of the exact path (ops/gather.py) walk for their column side: the live
(mask) slots grouped by source atom ``s A + idx``, in slot order, as flat
slot ids ``(s A + i) K + k`` (``csr_slots``, padded to S A K entries with
the masked slots) with group offsets ``csr_offsets [S A + 1]``. A stable
sort gives it, so its order is fixed by the list; it is the exact
transpose of the list, an asymmetric (overflowed) list included, and
under image replication a source that fills several slots of one row
keeps each of them.

Periodic cells: under a ``cell`` ([3, 3] shared or [S, 3, 3] per
molecule; rows are lattice vectors) the build takes minimum-image
displacements, sound while the search radius is below half the smallest
perpendicular width (``validate_min_image``), and carries per-slot
``shifts`` such that ``pos[idx] + shifts - pos[i]`` is the periodic
displacement. Smaller cells take explicit image replication
(``compute_image_shifts`` and ``images=``): the candidate columns are
every (lattice image, atom) pair, indices fold back to real atoms and the
image offsets ride the shifts. Every lattice product here is written as
float32 elementwise products, never as a matmul, so that no TF32 or
truncated operand rounds a fraction near +-0.5 to the wrong image.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..native import max_neighbor_count  # noqa: F401


@dataclasses.dataclass(frozen=True)
class NeighborMatrix:
    """Padded per-atom neighbourhood (reference NeighborMatrix,
    neighborlist.py:58-77).

    ``idx[s, i, k]`` is the k-th nearest neighbour of atom i (padded with
    ``i`` itself), ``mask[s, i, k]`` marks real neighbours, ``n_max[s]`` is
    the largest true neighbour count before truncation. ``shifts`` (None
    for open boundaries) are the periodic corrections of the slots, zero
    on masked slots. ``csr_offsets`` / ``csr_slots`` are the source CSR of
    the batched build (module docstring); None for a single molecule.
    """

    idx: torch.Tensor  # [S, A, K] int32 (or [A, K])
    mask: torch.Tensor  # [S, A, K] bool
    n_max: torch.Tensor  # [S] int32 (or [])
    csr_offsets: Optional[torch.Tensor] = None  # [S*A + 1] int32
    csr_slots: Optional[torch.Tensor] = None  # [S*A*K] int32
    shifts: Optional[torch.Tensor] = None  # [S, A, K, 3] float32

    @property
    def capacity(self) -> int:
        return self.idx.shape[-1]


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


def _cell_operands(cell, s: int, device, inv=None):
    """(cell, inv) as contiguous float32 [S, 3, 3] on ``device`` from a
    [3, 3] (shared) or [S, 3, 3] (per molecule) cell; (None, None) for
    open boundaries (reference _cell_operands, cheb_kernel.py:688-696)."""
    if cell is None:
        return None, None
    cell = torch.as_tensor(cell, dtype=torch.float32, device=device)
    if cell.ndim == 2:
        cell = cell.expand(s, 3, 3)
    if tuple(cell.shape) != (s, 3, 3):
        raise ValueError(f"cell: expected [3, 3] or [{s}, 3, 3], got "
                         f"{tuple(cell.shape)}")
    cell = cell.contiguous()
    return cell, (_inv_3x3(cell) if inv is None else inv)


def _vec_mat(v, m):
    """Row vectors times 3 x 3 matrices, ``v [..., 3] @ m [..., 3, 3]``, as
    float32 elementwise products summed left to right (never a matmul)."""
    return torch.stack([
        v[..., 0] * m[..., 0, k] + v[..., 1] * m[..., 1, k]
        + v[..., 2] * m[..., 2, k]
        for k in range(3)
    ], dim=-1)


def pair_rel(pos: torch.Tensor, cell=None, inv=None) -> torch.Tensor:
    """rel[s, i, j] = pos_j - pos_i, [S, A, A, 3]; minimum-imaged under a
    cell ([S, 3, 3] with its inverse) component by component, never by a
    matmul: a truncated matmul operand rounds a fraction near +-0.5 to the
    wrong image, an error of a whole box length (PERFORMANCE.md:348-352).
    The reference's _pairwise_displacements (neighborlist.py:205-222)."""
    rel = pos[:, None, :, :] - pos[:, :, None, :]
    if cell is None:
        return rel
    n = torch.round(_vec_mat(rel, inv[:, None, None]))
    return rel - _vec_mat(n, cell[:, None, None])


def wrap_positions(pos: torch.Tensor, cell) -> torch.Tensor:
    """Positions ``[S, A, 3]`` wrapped into their cell (fractional
    coordinates in [0, 1)); ``cell`` [3, 3] or [S, 3, 3] (reference
    wrap_positions, neighborlist.py:488-499)."""
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device)
    frac = _vec_mat(pos, inv[:, None])
    return pos - _vec_mat(torch.floor(frac), cell[:, None])


def min_cell_width(cell) -> float:
    """Smallest perpendicular width of a (possibly triclinic) cell whose
    rows are the lattice vectors: volume / area of the face spanned by the
    other two, which is smaller than the row norms for a skewed cell
    (reference min_cell_width, neighborlist.py:97-113)."""
    return float(min(_cell_widths(cell)))


def _cell_widths(cell) -> np.ndarray:
    """The three perpendicular widths of one [3, 3] cell, float64."""
    c = np.asarray(cell, dtype=np.float64)
    vol = abs(float(np.linalg.det(c)))
    return np.array([
        vol / float(np.linalg.norm(np.cross(c[(k + 1) % 3], c[(k + 2) % 3])))
        for k in range(3)
    ])


def _host_cells(cell) -> np.ndarray:
    """[N, 3, 3] float64 of a [3, 3] or [S, 3, 3] cell (numpy or tensor; a
    tensor on the card is copied to the host)."""
    if isinstance(cell, torch.Tensor):
        cell = cell.detach().cpu().numpy()
    c = np.asarray(cell, dtype=np.float64)
    return c[None] if c.ndim == 2 else c


def compute_image_shifts(cell, rcut: float) -> np.ndarray:
    """Integer lattice shifts [M, 3] (int64, the zero shift first) that
    reach every image within ``rcut`` of a wrapped atom: along each
    reciprocal direction k, shifts up to ``floor(rcut / width_k) + 1``
    (reference compute_image_shifts, neighborlist.py:116-159). ``cell``
    [3, 3] or [S, 3, 3] (the tightest width over the batch)."""
    widths = np.stack([_cell_widths(one) for one in _host_cells(cell)])
    n = [int(np.floor(rcut / widths[:, k].min())) + 1 for k in range(3)]
    grids = np.meshgrid(*(np.arange(-nk, nk + 1) for nk in n),
                        indexing="ij")
    shifts = np.stack([g.ravel() for g in grids], axis=1)
    zero = np.all(shifts == 0, axis=1)
    return np.concatenate([shifts[zero], shifts[~zero]]).astype(np.int64)


def image_shift_radius(images, cell) -> float:
    """The search radius that the shift set ``images`` covers in ``cell``
    ([3, 3] or [S, 3, 3]): a full grid up to ``n_k`` along direction k
    reaches every image within ``n_k width_k`` of a wrapped atom
    (compute_image_shifts' rule read backwards); the least over the
    batch. A radius at or above it needs more images."""
    n = np.abs(np.asarray(images)).max(axis=0)
    widths = np.stack([_cell_widths(one) for one in _host_cells(cell)])
    return float((n[None, :] * widths).min())


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
    for one in _host_cells(cell):
        width = min_cell_width(one)
        if rcut >= 0.5 * width:
            where = f" ({context})" if context else ""
            raise ValueError(
                f"Minimum-image convention is unsound{where}: the search "
                f"radius {rcut:g} must be < half the smallest perpendicular "
                f"cell width ({width:g} / 2 = {0.5 * width:g}). A smaller "
                "cell has multiple periodic images of the same pair within "
                "the cutoff, which minimum image silently drops — wrong "
                "periodic physics. Use a larger box (or a smaller cutoff/"
                "neighbor_skin), or image replication on the exact 'xla' "
                "path (models.forcefield.with_image_replication)."
            )


def _exclusion_matrix(exclude_pairs, n_atoms, device):
    """[A, A] bool, True at the excluded pairs in both directions."""
    ep = torch.as_tensor(exclude_pairs, device=device).long()
    excl = torch.zeros(n_atoms, n_atoms, dtype=torch.bool, device=device)
    excl[ep[0], ep[1]] = True
    excl[ep[1], ep[0]] = True
    return excl


def _squared_norm(dr):
    return (dr[..., 0] * dr[..., 0] + dr[..., 1] * dr[..., 1]) + (
        dr[..., 2] * dr[..., 2]
    )


def _select(d2, valid, capacity):
    """(order, mask, k_eff): each row's nearest ``capacity`` valid columns.
    Ties keep the lower column first, as lax.top_k does (a stable sort)."""
    k_eff = min(capacity, d2.shape[-1])
    key = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    order = torch.sort(key, dim=-1, stable=True).indices[..., :k_eff]
    return order, torch.gather(valid, -1, order), k_eff


def _pad(capacity, k_eff, idx, mask, shifts):
    """Pad the slots past ``k_eff`` (the capacity exceeds the candidate
    columns): self index, masked, zero shift."""
    if k_eff == capacity:
        return idx, mask, shifts
    s, n_atoms, _ = idx.shape
    pad = capacity - k_eff
    row = torch.arange(n_atoms, dtype=torch.int32, device=idx.device)
    idx = torch.cat([idx, row[None, :, None].expand(s, n_atoms, pad)],
                    dim=-1)
    mask = torch.cat([mask, mask.new_zeros(s, n_atoms, pad)], dim=-1)
    if shifts is not None:
        shifts = torch.cat([shifts, shifts.new_zeros(s, n_atoms, pad, 3)],
                           dim=-2)
    return idx, mask, shifts


def _build(pos, rcut, capacity, exclude_pairs, cell=None,
           self_interaction=False):
    """(idx, mask, n_max, shifts) of the batched build, minimum-imaged
    under ``cell`` (shifts None without one)."""
    s, n_atoms, _ = pos.shape
    cell, inv = _cell_operands(cell, s, pos.device)
    dr = pair_rel(pos, cell, inv)  # [s, i, j] = p_j - p_i (min image)
    d2 = _squared_norm(dr)
    valid = d2 < rcut * rcut
    if not self_interaction:
        valid = valid & ~torch.eye(n_atoms, dtype=torch.bool,
                                   device=pos.device)
    if exclude_pairs is not None:
        valid = valid & ~_exclusion_matrix(exclude_pairs, n_atoms,
                                           pos.device)
    order, mask, k_eff = _select(d2, valid, capacity)
    row = torch.arange(n_atoms, dtype=torch.int32, device=pos.device)
    idx = torch.where(mask, order.to(torch.int32), row[None, :, None])
    shifts = None
    if cell is not None:
        # shift = minimum-image displacement - raw displacement, at the
        # selected columns
        raw = pos[:, None, :, :] - pos[:, :, None, :]
        sel = order.long()[..., None].expand(s, n_atoms, k_eff, 3)
        shifts = torch.gather(dr - raw, 2, sel)
        shifts = torch.where(mask[..., None], shifts, 0.0)
    idx, mask, shifts = _pad(capacity, k_eff, idx, mask, shifts)
    n_max = valid.sum(dim=-1).amax(dim=-1).to(torch.int32)
    return idx.contiguous(), mask.contiguous(), n_max, shifts


def _check_images(images) -> np.ndarray:
    imgs = np.asarray(images)
    if imgs.ndim != 2 or imgs.shape[1] != 3:
        raise ValueError(f"images must be [M, 3], got {imgs.shape}")
    if np.any(imgs[0] != 0):
        raise ValueError(
            "images[0] must be the zero shift (compute_image_shifts puts it "
            "first; the self-pair exclusion relies on it)"
        )
    return imgs


def _build_images(pos, rcut, capacity, exclude_pairs, cell, images,
                  self_interaction=False):
    """(idx, mask, n_max, shifts) of the image-replication build over the
    [S, A, M A] candidate columns (image m, atom j) of the wrapped
    positions (reference _radius_neighbor_matrix_images,
    neighborlist.py:312-387). The shifts make ``pos[j] + shift - pos[i]``
    the periodic displacement of the raw positions."""
    s, n_atoms, _ = pos.shape
    imgs = _check_images(images)
    m_img = imgs.shape[0]
    cell, _ = _cell_operands(cell, s, pos.device)
    posw = wrap_positions(pos, cell)
    imgs_t = torch.as_tensor(imgs, dtype=pos.dtype, device=pos.device)
    sv = _vec_mat(imgs_t[None], cell[:, None])  # [S, M, 3]
    ghost = (posw[:, None, :, :] + sv[:, :, None, :]).reshape(
        s, m_img * n_atoms, 3)
    dr = ghost[:, None, :, :] - posw[:, :, None, :]  # [S, A, M A, 3]
    d2 = _squared_norm(dr)
    valid = d2 < rcut * rcut
    if not self_interaction:
        # zero-shift self pairs only: an atom is a neighbour of its own
        # non-zero images in a cell this small
        self_pair = torch.zeros(n_atoms, m_img * n_atoms, dtype=torch.bool,
                                device=pos.device)
        self_pair[:, :n_atoms] = torch.eye(n_atoms, dtype=torch.bool,
                                           device=pos.device)
        valid = valid & ~self_pair
    if exclude_pairs is not None:
        excl = _exclusion_matrix(exclude_pairs, n_atoms, pos.device)
        valid = valid & ~excl.repeat(1, m_img)
    order, mask, k_eff = _select(d2, valid, capacity)
    j_real = (order % n_atoms).to(torch.int32)
    row = torch.arange(n_atoms, dtype=torch.int32, device=pos.device)
    idx = torch.where(mask, j_real, row[None, :, None])
    pos_cols = torch.gather(
        pos, 1, j_real.long().reshape(s, -1, 1).expand(-1, -1, 3)
    ).reshape(s, n_atoms, k_eff, 3)
    dr_sel = torch.gather(dr, 2, order[..., None].expand(-1, -1, -1, 3))
    shifts = dr_sel - (pos_cols - pos[:, :, None, :])
    shifts = torch.where(mask[..., None], shifts, 0.0)
    idx, mask, shifts = _pad(capacity, k_eff, idx, mask, shifts)
    n_max = valid.sum(dim=-1).amax(dim=-1).to(torch.int32)
    return idx.contiguous(), mask.contiguous(), n_max, shifts


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


def permute_neighbor_matrix(nbr: NeighborMatrix,
                            perm: torch.Tensor) -> NeighborMatrix:
    """The batched list with its molecules reordered, molecule ``s`` of
    the result being molecule ``perm[s]`` of ``nbr``: ``idx``, ``mask``,
    ``n_max`` and ``shifts`` are gathered along the batch; the source CSR
    is built again from them, since its slot ids ``(s A + i) K + k`` and
    its one tail of masked slots are global to the batch and cannot be
    permuted in place. On the device and free of host syncs."""
    idx, mask = nbr.idx[perm], nbr.mask[perm]
    offsets, slots = source_csr(idx, mask)
    return NeighborMatrix(
        idx=idx, mask=mask, n_max=nbr.n_max[perm],
        csr_offsets=offsets, csr_slots=slots,
        shifts=None if nbr.shifts is None else nbr.shifts[perm],
    )


def _build_any(pos, rcut, capacity, cell, self_interaction, exclude_pairs,
               images, check_cell, context):
    if images is not None:
        if cell is None:
            raise ValueError("image replication requires a cell")
        return _build_images(pos, rcut, capacity, exclude_pairs, cell,
                             images, self_interaction)
    if check_cell:
        validate_min_image(cell, rcut, context=context)
    return _build(pos, rcut, capacity, exclude_pairs, cell, self_interaction)


def batched_radius_neighbor_matrix(
    pos: torch.Tensor,
    rcut: float,
    capacity: int,
    cell=None,
    self_interaction: bool = False,
    exclude_pairs=None,
    images=None,
    check_cell: bool = True,
) -> NeighborMatrix:
    """Padded neighbour matrices of a [S, A, 3] batch, with the source CSR
    (reference batched_radius_neighbor_matrix, neighborlist.py:390-426).

    Pairs i != j with d < rcut (strict) are neighbours, and with
    ``self_interaction`` the self pairs i == i at d = 0 too (under image
    replication the self pair of the zero shift is the only one ever left
    out without it: an atom's other images are pairs like any other);
    ``exclude_pairs`` [2, P] are dropped in both directions (every image of
    the pair under replication). ``n_max`` is per molecule. ``cell`` ([3, 3] or
    [S, 3, 3]) takes the minimum image, validated on the host unless
    ``check_cell`` is False (a caller that validated it once, ahead of a
    hot loop); ``images`` (an [M, 3] integer shift set, zero first, from
    ``compute_image_shifts``) takes image replication instead."""
    with torch.no_grad():
        idx, mask, n_max, shifts = _build_any(
            pos, rcut, capacity, cell, self_interaction, exclude_pairs,
            images, check_cell, "batched_radius_neighbor_matrix",
        )
        offsets, slots = source_csr(idx, mask)
    return NeighborMatrix(idx=idx, mask=mask, n_max=n_max,
                          csr_offsets=offsets, csr_slots=slots,
                          shifts=shifts)


def radius_neighbor_matrix(
    pos: torch.Tensor,
    rcut: float,
    capacity: int,
    cell=None,
    self_interaction: bool = False,
    exclude_pairs=None,
    images=None,
    check_cell: bool = True,
) -> NeighborMatrix:
    """The padded neighbour matrix of one molecule, pos [A, 3], with a
    [3, 3] cell where given (reference radius_neighbor_matrix,
    neighborlist.py:224-309; the arguments as in
    :func:`batched_radius_neighbor_matrix`); no source CSR."""
    if cell is not None:
        cell = torch.as_tensor(cell, dtype=torch.float32,
                               device=pos.device)[None]
    with torch.no_grad():
        idx, mask, n_max, shifts = _build_any(
            pos[None], rcut, capacity, cell, self_interaction, exclude_pairs,
            images, check_cell, "radius_neighbor_matrix",
        )
    return NeighborMatrix(idx=idx[0], mask=mask[0], n_max=n_max[0],
                          shifts=None if shifts is None else shifts[0])


def suggest_capacity(n_true_max: int, slack: float = 1.25, align: int = 8):
    """Round a measured max neighbour count up to an aligned static
    capacity (reference neighborlist.py:502-505)."""
    cap = int(n_true_max * slack) + 1
    return ((cap + align - 1) // align) * align


class EdgeList(NamedTuple):
    """Flat padded edge list + mask, the reference's ``index_mapping
    [2, E]`` view of one molecule's list (reference EdgeList,
    neighborlist.py:429-441); the neighbour matrix is the layout the
    force field runs on."""

    senders: torch.Tensor  # [E] source atom j (edge_index[0])
    receivers: torch.Tensor  # [E] destination atom i
    mask: torch.Tensor  # [E] bool


def neighbor_matrix_to_edges(nm: NeighborMatrix) -> EdgeList:
    """Flatten one molecule's [A, K] neighbour matrix into E = A K edges,
    on its device (reference neighborlist.py:444-453)."""
    n_atoms, capacity = nm.idx.shape
    receivers = torch.arange(n_atoms, dtype=torch.int32,
                             device=nm.idx.device).repeat_interleave(capacity)
    return EdgeList(senders=nm.idx.reshape(-1), receivers=receivers,
                    mask=nm.mask.reshape(-1))


def configuration2term_list(pos, rcut: float, tag: str = "fully connected",
                            self_interaction: bool = False):
    """Every directed pair within ``rcut`` of one configuration as an
    order-2 :class:`~flashmd_tpu_torch.data.system.TermList`, from the host
    radius engine (reference configuration2term_list,
    neighborlist.py:456-485), e.g. to attach a pair prior. ``pos`` [A, 3]
    may be numpy or a tensor on any device."""
    from ..data.system import make_term_list
    from ..native import radius_pairs

    if isinstance(pos, torch.Tensor):
        pos = pos.detach().cpu().numpy()
    pos = np.asarray(pos, dtype=np.float64)
    src, dst = radius_pairs(pos, rcut)
    if self_interaction:
        eye = np.arange(pos.shape[0], dtype=np.int64)
        src, dst = np.concatenate([src, eye]), np.concatenate([dst, eye])
    return make_term_list(np.stack([src, dst]), tag=tag, rcut=rcut,
                          self_interaction=self_interaction)
