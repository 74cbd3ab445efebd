"""Force-field composition: network + priors -> energies and forces
(port of flashmd_tpu/models/forcefield.py).

Forces are ``-torch.autograd.grad`` of the summed energy, taken under
``torch.enable_grad()`` on a copy of ``pos`` that requires grad, so the
integrator around it may run under ``no_grad``.

Periodic cells run on the cheb path, which applies the minimum image
inside its pair geometry, and on the exact xla path, which takes the
periodic displacements from the neighbour list's shifts. The dense and
pallas paths refuse cells. An unsound cell (rcut not below half the
smallest perpendicular width) raises, as in the reference, unless an xla
field carries an image-replication shift set (``with_image_replication``)
that covers the search radius in that cell; a shift set on any other path
raises.

Mixed-size batches (``stack_forcefields``; the reference refuses them,
base.py:914-983) share one network over molecules of different sizes:
each molecule keeps its own priors, stacked along [S]
(``batched_priors``), the types are [S, A] and an ``atom_mask`` drops the
padded atoms' head energies. They run on every path, with open
boundaries and without pair exclusions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.neighborlist import (
    NeighborMatrix,
    batched_radius_neighbor_matrix,
    compute_image_shifts,
    image_shift_radius,
    validate_min_image,
)
from ..prior.priors import Prior, prior_energy
from .schnet import SchNetConfig, schnet_energy

SCHNET_NAME = "SchNet"


@dataclasses.dataclass
class ForceField:
    """SchNet parameters + specialised priors (reference ForceField,
    forcefield.py:38-73). ``neighbor_capacity`` is the static K of the
    padded neighbour matrix. ``exc_pair_index`` ([2, P] atom pairs) is
    dropped from the neighbour list on the ``"xla"`` and ``"pallas"`` paths
    and refused on the all-pairs paths, which have no list to drop pairs
    from. ``pbc_images`` (a tuple of (i, j, k) integer lattice shifts, set
    by ``with_image_replication``) switches the xla path's list to image
    replication, for cells below the minimum-image regime.
    ``batched_priors`` (set by ``stack_forcefields``) marks priors whose
    leaves carry a leading per-molecule [S] axis, those of a mixed batch.
    """

    schnet_params: Optional[dict]
    priors: Dict[str, Prior]
    schnet_config: Optional[SchNetConfig] = None
    neighbor_capacity: int = 64
    exc_pair_index: Optional[torch.Tensor] = None
    batched_priors: bool = False
    pbc_images: Optional[tuple] = None

    @property
    def rcut(self) -> float:
        return float(self.schnet_config.cutoff.cutoff_upper)

    def replace(self, **changes) -> "ForceField":
        return dataclasses.replace(self, **changes)


def validate_quantized(ff: ForceField) -> None:
    """Raise unless the SchNet MLPs run on the bf16 path, as a quantized
    (``gptq``) simulation asks (reference validate_quantized,
    forcefield.py:76-89)."""
    if ff.schnet_config is None:
        return
    if ff.schnet_config.precision != "bf16":
        raise RuntimeError(
            "Quantized simulation requested but the SchNet filter/output "
            f"MLPs run at precision={ff.schnet_config.precision!r}; "
            "expected 'bf16'."
        )


def uses_neighbor_list(ff: ForceField) -> bool:
    """Whether the SchNet term runs over a neighbour matrix."""
    return (ff.schnet_params is not None
            and ff.schnet_config.message_passing not in ("dense", "cheb"))


def _require_exact_path_for_images(ff: ForceField) -> None:
    """Image shifts are honoured by the xla path only; on another path
    they would bypass both minimum-image walls (a fault of the reference,
    forcefield.py:218, which the port does not copy): the cheb kernels
    apply the minimum image in-kernel, and dense and pallas refuse cells."""
    if ff.pbc_images is None or ff.schnet_params is None:
        return
    mp = ff.schnet_config.message_passing
    if mp != "xla":
        raise NotImplementedError(
            "Image replication (pbc_images, sub-minimum-image cells) "
            f"requires message_passing='xla' (got {mp!r}): no other path "
            "reads the list's image shifts."
        )


def build_neighbors(ff: ForceField, pos_batch: torch.Tensor,
                    skin: float = 0.0, cell=None,
                    check_cell: bool = True) -> NeighborMatrix:
    """Batched padded radius graph (with its source CSR) for the SchNet
    term at rcut + ``skin``, without the force field's excluded pairs
    (reference build_neighbors, forcefield.py:134-164): minimum-imaged
    under ``cell``, or image-replicated when the field carries
    ``pbc_images``. Indices carry no gradient; a skin-padded list stays
    exact while no pair moves from beyond rcut + skin to within rcut
    between rebuilds. ``check_cell=False`` skips the host-side
    minimum-image check of a cell validated ahead of a hot loop."""
    _require_exact_path_for_images(ff)
    images = None if ff.pbc_images is None else np.asarray(ff.pbc_images)
    return batched_radius_neighbor_matrix(
        pos_batch.detach(), rcut=ff.rcut + skin,
        capacity=ff.neighbor_capacity, cell=cell,
        exclude_pairs=ff.exc_pair_index, images=images,
        check_cell=check_cell,
    )


def validate_image_cover(ff: ForceField, cell, radius: float,
                         context: str = "") -> None:
    """Raise unless the field's image shifts reach every image within
    ``radius`` in ``cell`` (the port's fix of the reference's early return,
    simulation/base.py:413, which trusts any bound shift set)."""
    cover = image_shift_radius(ff.pbc_images, cell)
    if radius >= cover:
        where = f" ({context})" if context else ""
        raise ValueError(
            f"Image replication is unsound{where}: the bound shifts reach "
            f"images within {cover:g} in this cell, but the search radius "
            f"is {radius:g}. Bind them again with with_image_replication("
            "ff, cell, skin=neighbor_skin)."
        )


def with_image_replication(ff: ForceField, cell,
                           skin: float = 0.0) -> ForceField:
    """The field with an image-replication shift set bound: every lattice
    image that can reach rcut + ``skin`` in ``cell`` ([3, 3] or
    [S, 3, 3]; reference with_image_replication, forcefield.py:349-385).
    Sub-minimum-image cells on the xla path; the other paths raise."""
    shifts = compute_image_shifts(cell, ff.rcut + skin)
    out = ff.replace(pbc_images=tuple(map(tuple, shifts.tolist())))
    _require_exact_path_for_images(out)
    return out


def energy_components(
    ff: ForceField, pos, atom_types, nbr: Optional[NeighborMatrix],
    cell=None, atom_mask=None,
) -> Dict[str, torch.Tensor]:
    """Per-model energies, each [S] (reference energy_components,
    forcefield.py:93-115). ``nbr`` is None on the cheb and dense paths.
    ``cell`` reaches the SchNet term only; the priors evaluate on the raw
    coordinates. ``atom_mask`` ([S, A]) drops the padded atoms' head
    energies of a mixed batch; padded priors carry their own
    ``term_mask``."""
    out = {}
    if ff.schnet_params is not None:
        out[SCHNET_NAME] = schnet_energy(
            ff.schnet_params, ff.schnet_config, pos, atom_types, nbr, cell,
            atom_mask=atom_mask,
        )
    for name, prior in ff.priors.items():
        out[name] = prior_energy(prior, pos)
    return out


def total_energy(
    ff: ForceField, pos, atom_types, nbr: Optional[NeighborMatrix],
    cell=None, atom_mask=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """([S] total energy, components) (reference total_energy,
    forcefield.py:118-131)."""
    comps = energy_components(ff, pos, atom_types, nbr, cell, atom_mask)
    total = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    for v in comps.values():
        total = total + v
    return total, comps


def _check_cell(ff: ForceField, cell, check_cell: bool) -> None:
    """The reference's cell checks (forcefield.py:206-229): dense and
    pallas refuse a cell; an unsound cell raises unless the caller has
    validated it already (``check_cell=False``), or the xla field carries
    image shifts, which must then cover rcut in the cell."""
    if cell is None or ff.schnet_params is None:
        return
    mp = ff.schnet_config.message_passing
    if mp not in ("xla", "cheb"):
        raise NotImplementedError(
            "Periodic cells require message_passing='xla' or 'cheb' "
            f"(got {mp!r}); the dense/pallas paths compute pair geometry "
            "from raw positions."
        )
    if not check_cell:
        return
    if ff.pbc_images is not None:
        validate_image_cover(ff, cell, ff.rcut,
                             context="compute_energy_forces")
    else:
        validate_min_image(cell, ff.rcut, context="compute_energy_forces")


def compute_energy_forces(
    ff: ForceField,
    pos_batch: torch.Tensor,  # [S, A, 3]
    atom_types: torch.Tensor,  # [A], or [S, A] in a mixed batch
    nbr: Optional[NeighborMatrix] = None,
    cell=None,
    atom_mask=None,  # [S, A] in a mixed batch, else None
    *,
    check_cell: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """([S] energies, [S, A, 3] forces, components dict of [S])
    (reference compute_energy_forces, forcefield.py:166-275). On the
    neighbour-list paths ``nbr`` is built here when not given (under
    ``cell``, with the field's image shifts where it has them). A mixed
    batch (``data.system.collate_padded``) gives [S, A] types and its
    ``atom_mask``; a field with batched priors needs [S, A] types, and a
    mixed batch refuses a cell, as in the reference.

    ``cell`` ([3, 3] shared, or [S, 3, 3] per molecule; rows are lattice
    vectors) runs the cheb path, and the xla path through the list's
    shifts, under periodic boundaries. A cell is validated here (which
    reads it on the host); the engine,
    which validated its cells at attach, passes ``check_cell=False`` so
    that its per-step calls never synchronise with the card."""
    if atom_types is None or atom_types.ndim not in (1, 2):
        raise ValueError(
            "atom_types must be a 1-D [A] (homogeneous batch) or 2-D "
            "[S, A] (mixed batch) integer array"
        )
    types_mapped = atom_types.ndim == 2
    if ff.batched_priors and ff.priors and not types_mapped:
        raise ValueError(
            "A batched-prior (mixed-size) force field needs per-sim "
            "[S, A] atom_types (see data.system.collate_padded)."
        )
    if (types_mapped or atom_mask is not None) and cell is not None:
        raise NotImplementedError(
            "Mixed-size (padded) batches do not support periodic cells "
            "(data/system.collate_padded refuses them at collation)."
        )
    mp = None if ff.schnet_params is None else ff.schnet_config.message_passing
    _require_exact_path_for_images(ff)
    _check_cell(ff, cell, check_cell)
    if ff.exc_pair_index is not None and mp in ("dense", "cheb"):
        # The all-pairs paths have no neighbour list to drop pairs from.
        raise NotImplementedError(
            "Structure-level pair exclusions (exc_pair_index) require "
            "a neighbor-list message-passing path ('xla' or 'pallas'); "
            f"got {mp!r}."
        )
    if nbr is None and uses_neighbor_list(ff):
        nbr = build_neighbors(ff, pos_batch, cell=cell, check_cell=False)
    with torch.enable_grad():
        pos = pos_batch.detach().requires_grad_(True)
        # only the cheb path reads the cell in the model: a shared [3, 3]
        # one broadcasts over the batch, an [S, 3, 3] one goes per molecule
        # (models.cheb.cheb_stack_apply); the xla path reads nbr.shifts
        model_cell = cell if mp == "cheb" else None
        total, comps = total_energy(ff, pos, atom_types, nbr, model_cell,
                                    atom_mask)
        (grad,) = torch.autograd.grad(total.sum(), pos)
    return (
        total.detach(),
        -grad,
        {k: v.detach() for k, v in comps.items()},
    )


def _same_tree(a, b) -> bool:
    """Whether two parameter trees have one structure and equal tensors,
    leaf by leaf."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.shape == b.shape
                and torch.equal(a, b.to(a.device)))
    return a == b


def stack_forcefields(ffs) -> ForceField:
    """One mixed-batch field from per-molecule fields (reference
    stack_forcefields, forcefield.py:278-346): every field shares one
    SchNet network (configs equal, parameters equal leaf by leaf, the
    Chebyshev fits included where present) and one prior keyset; each
    prior kind is stacked along [S] (``prior.priors.stack_priors``), and
    the largest ``neighbor_capacity`` is kept. Pair exclusions raise. Pair
    it with ``data.system.collate_padded``."""
    from ..prior.priors import stack_priors

    ffs = list(ffs)
    if not ffs:
        raise ValueError("stack_forcefields needs at least one field")
    ref = ffs[0]
    if any(ff.batched_priors for ff in ffs):
        raise ValueError("stack_forcefields inputs must be unbatched")
    if any(ff.exc_pair_index is not None for ff in ffs):
        raise NotImplementedError(
            "Mixed-size batches with exc_pair_index are not supported."
        )
    for ff in ffs[1:]:
        if (ff.schnet_params is None) != (ref.schnet_params is None):
            raise ValueError(
                "stack_forcefields: SchNet presence differs across fields"
            )
        if ff.schnet_config != ref.schnet_config:
            raise ValueError(
                "stack_forcefields requires identical SchNet configs "
                "(one transferable network shared by every molecule)."
            )
        if (ref.schnet_params is not None
                and not _same_tree(ref.schnet_params, ff.schnet_params)):
            raise ValueError(
                "stack_forcefields requires identical SchNet "
                "parameters — the mixed batch shares one network."
            )
        if set(ff.priors.keys()) != set(ref.priors.keys()):
            raise ValueError(
                f"Prior keysets differ: {sorted(ff.priors)} vs "
                f"{sorted(ref.priors)}"
            )
    priors = {
        name: stack_priors([ff.priors[name] for ff in ffs])
        for name in ref.priors
    }
    return ref.replace(
        priors=priors,
        neighbor_capacity=max(ff.neighbor_capacity for ff in ffs),
        batched_priors=True,
    )
