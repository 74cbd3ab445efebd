"""ASE interoperability (port of flashmd_tpu/data/ase_io.py; the
reference's ``ase2data``, neighbor_list/utils.py:6-54). ``ase`` is an
optional dependency: the converter only calls the ``Atoms`` methods and
imports nothing of it."""

from __future__ import annotations

import numpy as np

from .system import Configuration


def ase2configuration(atoms) -> Configuration:
    """``ase.Atoms`` -> :class:`Configuration` (positions, numbers, masses,
    and the cell where any(pbc) is set, which the neighbour list then
    minimum-images)."""
    cell = None
    pbc = getattr(atoms, "pbc", None)
    if pbc is not None and np.any(pbc):
        cell = np.asarray(atoms.get_cell(), dtype=np.float64)
    return Configuration(
        pos=np.asarray(atoms.get_positions(), dtype=np.float64),
        atom_types=np.asarray(atoms.get_atomic_numbers(), dtype=np.int64),
        masses=np.asarray(atoms.get_masses(), dtype=np.float64),
        cell=cell,
        tag=str(atoms.symbols) if hasattr(atoms, "symbols") else "",
    )
