"""Smooth cutoff envelopes (port of flashmd_tpu/models/cutoff.py).

Frozen, hashable dataclasses whose ``__call__`` evaluates the envelope
elementwise on a distance tensor of any shape. The Chebyshev, dense and
neighbour-matrix kernels hard-code the zero-lower ``CosineCutoff`` as the
conv cutoff, and the dense and neighbour-matrix ones also as the radial
basis's; the Chebyshev fits take every envelope here as the basis's (a
float64 copy in models/cheb.py for the host fit), and the exact ``"xla"``
path every envelope in both places.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class _Cutoff:
    cutoff_lower: float = 0.0
    cutoff_upper: float = float("inf")

    def check_cutoff(self):
        if self.cutoff_upper < self.cutoff_lower:
            raise ValueError(
                f"Upper cutoff {self.cutoff_upper} is less than lower "
                f"cutoff {self.cutoff_lower}"
            )

    def __call__(self, distances: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCutoff(_Cutoff):
    """Envelope that is one everywhere (reference cutoff.py:35-45)."""

    cutoff_lower: float = 0.0
    cutoff_upper: float = float("inf")

    def __post_init__(self):
        self.check_cutoff()

    def __call__(self, distances: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(distances)


@dataclasses.dataclass(frozen=True)
class CosineCutoff(_Cutoff):
    """Cosine envelope on [lower, upper] (reference cutoff.py:48-89).

    For ``cutoff_lower == 0``: ``0.5 (cos(d pi / upper) + 1) * (d < upper)``.
    Otherwise the two-sided variant with hard zeroing outside (lower, upper).
    """

    cutoff_lower: float = 0.0
    cutoff_upper: float = 5.0

    def __post_init__(self):
        self.check_cutoff()

    def __call__(self, distances: torch.Tensor) -> torch.Tensor:
        lo, hi = self.cutoff_lower, self.cutoff_upper
        if lo > 0:
            c = 0.5 * (
                torch.cos(math.pi * (2 * (distances - lo) / (hi - lo) + 1.0))
                + 1.0
            )
            c = c * (distances < hi).to(distances.dtype)
            return c * (distances > lo).to(distances.dtype)
        c = 0.5 * (torch.cos(distances * math.pi / hi) + 1.0)
        return c * (distances < hi).to(distances.dtype)


@dataclasses.dataclass(frozen=True)
class ShiftedCosineCutoff(_Cutoff):
    """Behler cosine cutoff with a smoothing width: one below ``upper -
    smooth_width``, a cosine down to zero at ``upper``, zero past it
    (reference cutoff.py:92-114)."""

    cutoff_lower: float = 0.0
    cutoff_upper: float = 5.0
    smooth_width: float = 0.5

    def __call__(self, distances: torch.Tensor) -> torch.Tensor:
        hi, width = self.cutoff_upper, self.smooth_width
        smooth = 0.5 + 0.5 * torch.cos(
            math.pi * (distances - hi + width) / width
        )
        c = torch.where(distances > hi - width, smooth,
                        torch.ones_like(distances))
        return torch.where(distances > hi, torch.zeros_like(c), c)
