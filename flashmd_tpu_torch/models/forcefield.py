"""Force-field composition: network + priors -> energies and forces
(port of flashmd_tpu/models/forcefield.py).

Forces are ``-torch.autograd.grad`` of the summed energy, taken under
``torch.enable_grad()`` on a copy of ``pos`` that requires grad, so the
integrator around it may run under ``no_grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..prior.priors import Prior, prior_energy
from .schnet import SchNetConfig, schnet_energy

SCHNET_NAME = "SchNet"


@dataclasses.dataclass
class ForceField:
    """SchNet parameters + specialised priors (reference ForceField,
    forcefield.py:38-73). ``exc_pair_index`` is carried only to refuse it:
    the all-pairs Chebyshev path has no neighbour list to drop pairs from.
    """

    schnet_params: Optional[dict]
    priors: Dict[str, Prior]
    schnet_config: Optional[SchNetConfig] = None
    exc_pair_index: Optional[torch.Tensor] = None

    @property
    def rcut(self) -> float:
        return float(self.schnet_config.cutoff.cutoff_upper)

    def replace(self, **changes) -> "ForceField":
        return dataclasses.replace(self, **changes)


def energy_components(
    ff: ForceField, pos, atom_types
) -> Dict[str, torch.Tensor]:
    """Per-model energies, each [S]."""
    out = {}
    if ff.schnet_params is not None:
        out[SCHNET_NAME] = schnet_energy(
            ff.schnet_params, ff.schnet_config, pos, atom_types
        )
    for name, prior in ff.priors.items():
        out[name] = prior_energy(prior, pos)
    return out


def compute_energy_forces(
    ff: ForceField,
    pos_batch: torch.Tensor,  # [S, A, 3]
    atom_types: torch.Tensor,  # [A]
    cell=None,
    atom_mask=None,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """([S] energies, [S, A, 3] forces, components dict of [S])
    (reference compute_energy_forces, forcefield.py:166-275)."""
    if atom_types is None or atom_types.ndim != 1:
        raise ValueError(
            "atom_types must be a 1-D [A] integer tensor (mixed batches are "
            "not ported)"
        )
    mp = None if ff.schnet_params is None else ff.schnet_config.message_passing
    if cell is not None:
        raise NotImplementedError(
            f"Periodic cells are not ported yet (message_passing={mp!r}): "
            "every ported path computes pair geometry from raw positions."
        )
    if atom_mask is not None:
        raise NotImplementedError("mixed-size batches are not ported yet")
    if ff.exc_pair_index is not None and mp is not None:
        raise NotImplementedError(
            "Structure-level pair exclusions (exc_pair_index) require "
            "a neighbor-list message-passing path ('xla' or 'pallas'); "
            f"got {mp!r}."
        )
    with torch.enable_grad():
        pos = pos_batch.detach().requires_grad_(True)
        comps = energy_components(ff, pos, atom_types)
        total = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
        for v in comps.values():
            total = total + v
        (grad,) = torch.autograd.grad(total.sum(), pos)
    return (
        total.detach(),
        -grad,
        {k: v.detach() for k, v in comps.items()},
    )
