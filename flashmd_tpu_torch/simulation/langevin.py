"""BAOAB Langevin dynamics (port of flashmd_tpu/simulation/langevin.py).

The step takes its standard-normal noise ``xi`` as an argument:
``simulate()`` draws it from the simulation's ``torch.Generator`` on the
device, and a test can inject the reference's own noise to compare
trajectories step for step (JAX's threefry and torch's Philox give
different streams).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .base import Simulation


def sample_maxwell_boltzmann(beta, masses, generator: torch.Generator):
    """Velocities ~ N(0, 1/(beta m)); beta/masses [S, A] -> [S, A, 3]."""
    scale = torch.sqrt(1.0 / (beta * masses))[..., None]
    noise = torch.randn(
        beta.shape + (3,), generator=generator, device=masses.device,
        dtype=masses.dtype,
    )
    return scale * noise


class LangevinSimulation(Simulation):
    r"""BAOAB Langevin dynamics (reference langevin.py:37-122).

    .. math::
        [B]\; V_{t+1/2} = V_t + (dt / 2m) F(X_t) \\
        [A]\; X_{t+1/2} = X_t + (dt / 2) V_{t+1/2} \\
        [O]\; V'_{t+1/2} = e^{-\gamma dt} V_{t+1/2}
              + \sqrt{1 - e^{-2\gamma dt}} \sqrt{1/(\beta m)}\, \xi \\
        [A]\; X_{t+1} = X_{t+1/2} + (dt / 2) V'_{t+1/2} \\
        [B]\; V_{t+1} = V'_{t+1/2} + (dt / 2m) F(X_{t+1})
    """

    def __init__(self, friction: float = 1e-3, **kwargs: Any):
        super().__init__(**kwargs)
        if friction <= 0:
            raise ValueError("friction must be positive")
        self.friction = friction
        self.vscale = float(np.exp(-self.dt * self.friction))
        self.noisescale = float(np.sqrt(1 - self.vscale * self.vscale))

    def _attach_configurations(self, configurations, beta):
        super()._attach_configurations(configurations, beta)
        system = self.initial_system
        beta_atom = system.beta[:, None].expand_as(system.masses)
        self.beta_mass_ratio = torch.sqrt(1.0 / beta_atom / system.masses)[
            ..., None
        ]
        if system.velocities is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.random_seed + 1
            )
            system.velocities = sample_maxwell_boltzmann(
                beta_atom, system.masses, gen
            )

    def _timestep(self, carry: Dict, xi: torch.Tensor) -> Dict:
        return self._baoab(carry, xi)

    def _baoab(self, carry: Dict, xi: torch.Tensor) -> Dict:
        dt = self.dt
        masses = self.initial_system.masses[..., None]
        # B (first velocity half-step)
        v = carry["vel"] + 0.5 * dt * carry["forces"] / masses
        # A (first position half-step)
        x = carry["pos"] + v * (dt * 0.5)
        # O (stochastic velocity update)
        noise = self.beta_mass_ratio * xi
        v = v * self.vscale + self.noisescale * noise
        # A (second position half-step)
        x = x + v * (dt * 0.5)
        # Force evaluation (the expensive part)
        potential, forces, _ = self._forces(x)
        # B (second velocity half-step)
        v = v + 0.5 * dt * forces / masses
        return {**carry, "pos": x, "vel": v, "forces": forces,
                "potential": potential}
