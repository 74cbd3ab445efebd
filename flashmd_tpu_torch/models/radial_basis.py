"""Gaussian radial basis (port of flashmd_tpu/models/radial_basis.py).

On the Chebyshev path only the fits read the basis, with its own
envelope, whatever that is (the float64 host fit its numpy copy, the
in-graph fit ``gaussian_basis_apply`` at the Chebyshev nodes); the exact
``"xla"`` path expands every neighbour-matrix distance with
``gaussian_basis_apply``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch

from .cutoff import IdentityCutoff, _Cutoff


@dataclasses.dataclass(frozen=True)
class GaussianBasisConfig:
    """Equidistant Gaussian basis f_n = exp(coeff (d - c_n)^2) cutoff(d).

    ``cutoff`` may be a number, read as IdentityCutoff(0, cutoff) as in the
    reference (radial_basis.py:20-45), or a cutoff dataclass.
    ``trainable`` is the reference's training flag, kept as metadata: no
    code of either package reads it."""

    cutoff: Union[float, int, _Cutoff] = 5.0
    num_rbf: int = 50
    trainable: bool = False

    def __post_init__(self):
        if isinstance(self.cutoff, (float, int)):
            object.__setattr__(
                self, "cutoff", IdentityCutoff(0.0, float(self.cutoff))
            )
        elif not isinstance(self.cutoff, _Cutoff):
            raise TypeError(
                f"Supplied cutoff {self.cutoff} is neither a number nor a "
                "cutoff instance."
            )
        self.cutoff.check_cutoff()

    @property
    def cutoff_lower(self) -> float:
        return self.cutoff.cutoff_lower

    @property
    def cutoff_upper(self) -> float:
        return self.cutoff.cutoff_upper


def init_gaussian_basis(config: GaussianBasisConfig, device):
    """Offsets equidistant on [lower, upper]; coeff = -0.5 / delta^2
    (reference init_gaussian_basis, radial_basis.py:53-65), float32."""
    offset = np.linspace(
        config.cutoff_lower, config.cutoff_upper, config.num_rbf
    )
    coeff = -0.5 / float(offset[1] - offset[0]) ** 2
    return {
        "offset": torch.as_tensor(offset, dtype=torch.float32, device=device),
        "coeff": torch.tensor(coeff, dtype=torch.float32, device=device),
    }


def gaussian_basis_apply(params, config: GaussianBasisConfig, dist):
    """``dist [...]`` -> ``[..., num_rbf]``, the basis times its own cutoff
    (reference gaussian_basis_apply, radial_basis.py:68-78)."""
    d = dist[..., None]
    expanded = torch.exp(params["coeff"] * torch.square(d - params["offset"]))
    return expanded * config.cutoff(d)
