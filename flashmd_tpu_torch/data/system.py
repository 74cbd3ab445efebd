"""Containers for a batch of molecular systems (port of
flashmd_tpu/data/system.py).

* :class:`Configuration` and :class:`TermList` are host-side numpy, copied
  from the reference.
* :class:`System` holds the batched state as tensors on an explicit
  ``device``: positions and velocities ``[S, A, 3]``, masses ``[S, A]``,
  inverse temperatures ``[S]``, periodic cells ``[S, 3, 3]``. The batch is
  a leading tensor axis.
* :func:`collate` stacks one molecule's frames; :func:`collate_padded`
  stacks molecules of different sizes, padded to the largest, with an
  ``atom_mask`` of the real atoms (reference collate_padded,
  data/system.py:392-500).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TermList:
    """A fixed interaction list of ``order``-tuples of atom indices
    (reference TermList, data/system.py:45-67)."""

    index_mapping: np.ndarray  # [order, n_terms] int32
    tag: str = ""
    order: int = 2
    rcut: Optional[float] = None
    self_interaction: bool = False

    @property
    def n_terms(self) -> int:
        return self.index_mapping.shape[1]


def make_term_list(
    index_mapping,
    tag: str = "",
    order: Optional[int] = None,
    rcut: Optional[float] = None,
    self_interaction: bool = False,
) -> TermList:
    """Build a :class:`TermList`, validating shape against ``order``."""
    index_mapping = np.asarray(index_mapping, dtype=np.int32)
    if index_mapping.ndim != 2:
        raise RuntimeError(
            f"index_mapping must be [order, n_terms], got shape "
            f"{index_mapping.shape}"
        )
    if order is None:
        order = int(index_mapping.shape[0])
    if index_mapping.shape[0] != order:
        raise RuntimeError(
            f"index_mapping shape does not match the order: "
            f"{index_mapping.shape[0]} != {order}"
        )
    return TermList(index_mapping, tag, order, rcut, self_interaction)


def validate_term_list(term_list) -> bool:
    """True iff ``term_list`` is a usable :class:`TermList` (reference
    validate_term_list, data/system.py:104-115)."""
    return (
        isinstance(term_list, TermList)
        and term_list.index_mapping.ndim == 2
        and term_list.index_mapping.shape[0] == term_list.order
    )


@dataclasses.dataclass
class Configuration:
    """Host-side description of a single molecule (one frame)."""

    pos: np.ndarray  # [A, 3]
    atom_types: np.ndarray  # [A] int
    masses: Optional[np.ndarray] = None  # [A]
    velocities: Optional[np.ndarray] = None  # [A, 3]
    neighbor_lists: Dict[str, TermList] = dataclasses.field(
        default_factory=dict
    )
    cell: Optional[np.ndarray] = None
    exc_pair_index: Optional[np.ndarray] = None
    tag: str = ""

    def __post_init__(self):
        self.pos = np.asarray(self.pos, dtype=np.float64)
        if self.pos.ndim != 2:
            raise ValueError(f"pos must be [A, 3], got {self.pos.shape}")
        self.atom_types = np.asarray(self.atom_types)
        if self.atom_types.shape[0] != self.pos.shape[0]:
            raise ValueError("atom_types length must match pos")
        if self.masses is not None:
            self.masses = np.asarray(self.masses, dtype=np.float64)
            if self.masses.shape != self.atom_types.shape:
                raise ValueError("masses shape must match atom_types")
        if self.velocities is not None:
            self.velocities = np.asarray(self.velocities, dtype=np.float64)
            if self.velocities.shape != self.pos.shape:
                raise ValueError("velocities shape must match pos")
        if self.cell is not None:
            self.cell = np.asarray(self.cell, dtype=np.float64)
            if self.cell.shape != (3, 3):
                raise ValueError(
                    f"cell must be [3, 3], got {self.cell.shape}"
                )
        if self.exc_pair_index is not None:
            # reference data/system.py:165-178
            epi = np.asarray(self.exc_pair_index, dtype=np.int64)
            if epi.ndim != 2 or 2 not in epi.shape:
                raise ValueError(
                    f"exc_pair_index must be [2, P] pairs, got {epi.shape}"
                )
            if epi.shape[0] != 2:  # accept the transposed [P, 2] layout
                epi = epi.T
            if epi.size and (epi.min() < 0 or epi.max() >= self.n_atoms):
                raise ValueError(
                    "exc_pair_index refers to atoms outside [0, "
                    f"{self.n_atoms})"
                )
            self.exc_pair_index = epi

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[0]

    @classmethod
    def from_points(
        cls,
        pos,
        atom_types,
        masses=None,
        velocities=None,
        neighbor_lists=None,
        cell=None,
        exc_pair_index=None,
        tag: str = "",
    ) -> "Configuration":
        """Construct from raw arrays (reference Configuration.from_points,
        data/system.py:185-209)."""
        return cls(
            pos=np.asarray(pos),
            atom_types=np.asarray(atom_types),
            masses=None if masses is None else np.asarray(masses),
            velocities=None if velocities is None else np.asarray(velocities),
            neighbor_lists=dict(neighbor_lists or {}),
            cell=None if cell is None else np.asarray(cell),
            exc_pair_index=(
                None if exc_pair_index is None else np.asarray(exc_pair_index)
            ),
            tag=tag,
        )


@dataclasses.dataclass
class System:
    """The batched on-device simulation state."""

    pos: torch.Tensor  # [S, A, 3]
    atom_types: torch.Tensor  # [A] int64, or [S, A] in a mixed batch
    masses: torch.Tensor  # [S, A]
    beta: torch.Tensor  # [S]
    velocities: Optional[torch.Tensor] = None  # [S, A, 3]
    # Periodic lattices (rows = lattice vectors; None = open boundaries):
    # on the device for the force evaluation, and as float64 numpy on the
    # host so that validating them never reads the card.
    cell: Optional[torch.Tensor] = None  # [S, 3, 3] float32
    cell_host: Optional[np.ndarray] = None  # [S, 3, 3] float64
    term_lists: Dict[str, TermList] = dataclasses.field(default_factory=dict)
    # Mixed-size batches (collate_padded): 1 on real atoms, 0 on padding;
    # None when every molecule has the batch's size.
    atom_mask: Optional[torch.Tensor] = None  # [S, A] float32

    @property
    def n_sims(self) -> int:
        return self.pos.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[1]

    @property
    def n_dims(self) -> int:
        return self.pos.shape[2]


def validate_configurations(configurations: Sequence[Configuration]):
    """Same shapes, atom types, term lists, mass and cell presence and pair
    exclusions across the batch (reference validate_configurations,
    data/system.py:253-310)."""
    if len(configurations) == 0:
        raise ValueError("Cannot collate an empty configuration list")
    ref = configurations[0]
    for frame, cfg in enumerate(configurations):
        if cfg.pos.shape != ref.pos.shape:
            raise ValueError(
                f"Positions shape {cfg.pos.shape} at frame {frame} differs "
                f"from shape {ref.pos.shape} in previous frames."
            )
        if not np.array_equal(cfg.atom_types, ref.atom_types):
            raise ValueError(
                f"Atom types at frame {frame} are not equal to atom types "
                "in previous frames."
            )
        if set(cfg.neighbor_lists) != set(ref.neighbor_lists):
            raise ValueError(
                f"Neighbor list keyset at frame {frame} does not match "
                "previous frames."
            )
        for key, tl in cfg.neighbor_lists.items():
            if not np.array_equal(
                tl.index_mapping, ref.neighbor_lists[key].index_mapping
            ):
                raise ValueError(
                    f"Index mapping for key {key} at frame {frame} does not "
                    "match those of previous frames."
                )
        if (cfg.masses is None) != (ref.masses is None):
            raise ValueError(
                f"Inconsistent mass specification at frame {frame}."
            )
        if (cfg.cell is None) != (ref.cell is None):
            raise ValueError(
                f"Inconsistent cell specification at frame {frame}."
            )
        same_exc = (
            (cfg.exc_pair_index is None) == (ref.exc_pair_index is None)
        ) and (
            cfg.exc_pair_index is None
            or np.array_equal(cfg.exc_pair_index, ref.exc_pair_index)
        )
        if not same_exc:
            # the exclusions are a property of THE molecule, like its types
            raise ValueError(
                f"exc_pair_index at frame {frame} does not match previous "
                "frames."
            )


def collate(
    configurations: Sequence[Configuration],
    beta=None,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> System:
    """Stack configurations into a batched :class:`System` on ``device``
    (the card unless the caller asks for the CPU).

    Velocities given on EVERY configuration are honoured (reference
    collate, data/system.py:338-342); otherwise the integrator samples
    them. Cells (all or none) stack into ``System.cell`` [S, 3, 3]
    (reference :344-347). Pair exclusions (the same on every
    configuration) are the force field's to honour
    (``ForceField.exc_pair_index``); the engine checks at attach that it
    carries them.
    """
    validate_configurations(configurations)
    n_sims = len(configurations)

    def tensor(arr, dt=dtype):
        return torch.as_tensor(np.array(arr), dtype=dt, device=device)

    pos = tensor(np.stack([c.pos for c in configurations]))
    atom_types = tensor(configurations[0].atom_types, torch.int64)
    if configurations[0].masses is not None:
        masses = tensor(np.stack([c.masses for c in configurations]))
    else:
        masses = torch.ones(n_sims, pos.shape[1], dtype=dtype, device=device)
    velocities = None
    if all(c.velocities is not None for c in configurations):
        velocities = tensor(np.stack([c.velocities for c in configurations]))

    cell = cell_host = None
    if configurations[0].cell is not None:
        cell_host = np.stack([c.cell for c in configurations])
        cell = tensor(cell_host)

    if beta is None:
        beta_np = np.ones(n_sims)
    else:
        beta_np = np.broadcast_to(np.asarray(beta, np.float64), (n_sims,))
        if not np.all(beta_np > 0) or not np.all(np.isfinite(beta_np)):
            raise ValueError(
                f"All betas must be positive and finite, got {beta_np}."
            )
    return System(
        pos=pos,
        atom_types=atom_types,
        masses=masses,
        beta=tensor(beta_np),
        velocities=velocities,
        term_lists=dict(configurations[0].neighbor_lists),
        cell=cell,
        cell_host=cell_host,
    )


def collate_padded(
    configurations: Sequence[Configuration],
    beta=None,
    device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
    pad_spacing: float = 1.0e4,
) -> System:
    """Stack configurations of different sizes into one padded
    :class:`System` on ``device`` (reference collate_padded,
    data/system.py:392-500).

    Every molecule is padded to the batch's largest atom count, with types
    0 and masses 1 on the padding, and ``atom_mask`` [S, A_max] marks the
    real atoms. Padded atoms are parked on a ladder along x, starting
    ``pad_spacing`` beyond the molecule's mean position and
    ``pad_spacing`` apart, so that no pair within any cutoff involves one
    and every padded pair distance is positive. Velocities are kept when
    every configuration gives them (zero on the padding).

    Masses must be given on every configuration or on none: the
    reference gives mass 1.0 to the atoms of a configuration without
    masses when another one has them (:444, :486); the port raises.
    Periodic cells and pair exclusions raise, as in the reference.
    """
    if len(configurations) == 0:
        raise ValueError("Cannot collate an empty configuration list")
    if any(c.cell is not None for c in configurations):
        raise NotImplementedError(
            "Mixed-size (padded) batches do not support periodic cells: "
            "minimum-image wrapping would fold the padding atoms back "
            "into the box. Collate homogeneous batches for PBC."
        )
    if any(c.exc_pair_index is not None for c in configurations):
        raise NotImplementedError(
            "Mixed-size batches with exc_pair_index are not supported "
            "(the exclusion list is bound per force field; see "
            "models/forcefield.stack_forcefields)."
        )
    with_masses = [c.masses is not None for c in configurations]
    if any(with_masses) and not all(with_masses):
        frame = with_masses.index(not with_masses[0])
        raise ValueError(
            f"Inconsistent mass specification at frame {frame}: give "
            "masses on every configuration of a mixed batch or on none."
        )
    n_sims = len(configurations)
    a_max = max(c.n_atoms for c in configurations)
    have_vel = all(c.velocities is not None for c in configurations)

    pos = np.zeros((n_sims, a_max, 3), np.float64)
    types = np.zeros((n_sims, a_max), np.int64)
    masses = np.ones((n_sims, a_max), np.float64)
    mask = np.zeros((n_sims, a_max), np.float32)
    vel = np.zeros((n_sims, a_max, 3), np.float64) if have_vel else None
    for s, c in enumerate(configurations):
        a = c.n_atoms
        pos[s, :a] = c.pos
        n_pad = a_max - a
        if n_pad:
            # strictly increasing offsets along x keep every padded-padded
            # and padded-real distance at least pad_spacing
            pos[s, a:] = c.pos.mean(axis=0)
            pos[s, a:, 0] += pad_spacing * np.arange(1, n_pad + 1)
        types[s, :a] = c.atom_types
        if c.masses is not None:
            masses[s, :a] = c.masses
        mask[s, :a] = 1.0
        if have_vel:
            vel[s, :a] = c.velocities

    if beta is None:
        beta_np = np.ones(n_sims)
    else:
        beta_np = np.broadcast_to(np.asarray(beta, np.float64),
                                  (n_sims,)).copy()
        if not np.all(beta_np > 0) or not np.all(np.isfinite(beta_np)):
            raise ValueError(
                f"All betas must be positive and finite, got {beta_np}."
            )

    def tensor(arr, dt=dtype):
        return torch.as_tensor(arr, dtype=dt, device=device)

    return System(
        pos=tensor(pos),
        atom_types=tensor(types, torch.int64),
        masses=tensor(masses),
        beta=tensor(beta_np),
        velocities=None if vel is None else tensor(vel),
        atom_mask=tensor(mask, torch.float32),
    )
