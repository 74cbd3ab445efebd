"""Cosine cutoff envelope (port of flashmd_tpu/models/cutoff.py; only the
``CosineCutoff`` the Chebyshev path uses)."""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CosineCutoff:
    """Cosine envelope on [lower, upper] (reference cutoff.py:48-89).

    For ``cutoff_lower == 0``: ``0.5 (cos(d pi / upper) + 1) * (d < upper)``.
    Otherwise the two-sided variant with hard zeroing outside (lower, upper).
    """

    cutoff_lower: float = 0.0
    cutoff_upper: float = 5.0

    def __post_init__(self):
        if self.cutoff_upper < self.cutoff_lower:
            raise ValueError(
                f"Upper cutoff {self.cutoff_upper} is less than lower "
                f"cutoff {self.cutoff_lower}"
            )

    def __call__(self, distances: torch.Tensor) -> torch.Tensor:
        lo, hi = self.cutoff_lower, self.cutoff_upper
        if lo > 0:
            c = 0.5 * (
                torch.cos(math.pi * (2 * (distances - lo) / (hi - lo) + 1.0))
                + 1.0
            )
            return c * (distances < hi) * (distances > lo)
        c = 0.5 * (torch.cos(distances * math.pi / hi) + 1.0)
        return c * (distances < hi)
