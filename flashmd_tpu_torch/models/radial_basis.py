"""Gaussian radial basis parameters (port of
flashmd_tpu/models/radial_basis.py).

On the Chebyshev path only the float64 host fit reads the basis; nothing
here runs per step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cutoff import CosineCutoff


@dataclasses.dataclass(frozen=True)
class GaussianBasisConfig:
    """Equidistant Gaussian basis f_n = exp(coeff (d - c_n)^2) cutoff(d)."""

    cutoff: CosineCutoff = CosineCutoff(0.0, 5.0)
    num_rbf: int = 50

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
