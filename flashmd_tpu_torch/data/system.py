"""Containers for a batch of molecular systems (port of
flashmd_tpu/data/system.py).

* :class:`Configuration` and :class:`TermList` are host-side numpy, copied
  from the reference.
* :class:`System` holds the batched state as tensors on an explicit
  ``device``: positions and velocities ``[S, A, 3]``, masses ``[S, A]``,
  inverse temperatures ``[S]``. The batch is a leading tensor axis.
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

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[0]


@dataclasses.dataclass
class System:
    """The batched on-device simulation state."""

    pos: torch.Tensor  # [S, A, 3]
    atom_types: torch.Tensor  # [A] int64
    masses: torch.Tensor  # [S, A]
    beta: torch.Tensor  # [S]
    velocities: Optional[torch.Tensor] = None  # [S, A, 3]
    term_lists: Dict[str, TermList] = dataclasses.field(default_factory=dict)

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
    """Same shapes, atom types, term lists and mass presence across the
    batch (reference validate_configurations, data/system.py:253-310)."""
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


def collate(
    configurations: Sequence[Configuration],
    beta=None,
    device: torch.device | str = "cpu",
    dtype: torch.dtype = torch.float32,
) -> System:
    """Stack configurations into a batched :class:`System` on ``device``.

    Velocities given on EVERY configuration are honoured (reference
    collate, data/system.py:338-342); otherwise the integrator samples
    them. Periodic cells and pair exclusions are not on the port's path
    and raise.
    """
    validate_configurations(configurations)
    if any(c.cell is not None for c in configurations):
        raise NotImplementedError("periodic cells are not ported yet")
    if any(c.exc_pair_index is not None for c in configurations):
        raise NotImplementedError("exc_pair_index is not ported yet")
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
    )
