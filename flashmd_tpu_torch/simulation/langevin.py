"""BAOAB Langevin and overdamped (Brownian) dynamics (port of
flashmd_tpu/simulation/langevin.py).

A step takes its standard-normal noise ``xi`` as an argument:
``simulate()`` draws it from the simulation's ``torch.Generator`` on the
device, and a test can inject the reference's own noise to compare
trajectories step for step (JAX's threefry and torch's Philox give
different streams).
"""

from __future__ import annotations

import warnings
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


def kinetic_energy(vel, masses):
    """Per-molecule kinetic energy 0.5 sum m v^2, [S] (reference
    langevin.py:124-133, velocity_verlet.py:76-85)."""
    return 0.5 * torch.sum(masses[..., None] * vel * vel, dim=(1, 2))


def attach_velocities(sim: Simulation) -> None:
    """Maxwell-Boltzmann velocities at each molecule's beta from
    ``random_seed + 1`` where the configurations gave none; a mixed
    batch's padded atoms start at rest (reference langevin.py:80-87)."""
    system = sim.initial_system
    if system.velocities is None:
        beta_atom = system.beta[:, None].expand_as(system.masses)
        gen = torch.Generator(device=sim.device).manual_seed(
            sim.random_seed + 1
        )
        vel = sample_maxwell_boltzmann(beta_atom, system.masses, gen)
        if system.atom_mask is not None:
            vel = vel * system.atom_mask[..., None]
        system.velocities = vel


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

    _batch_attrs = ("beta_mass_ratio",)

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
        if system.atom_mask is not None:
            # a zero noise scale, zero force and zero initial velocity make
            # every BAOAB substep the identity on a mixed batch's padding
            # (reference langevin.py:71-78); the draw keeps its [S, A, 3]
            self.beta_mass_ratio = (self.beta_mass_ratio
                                    * system.atom_mask[..., None])
        attach_velocities(self)

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
        potential, forces, _ = self._forces(carry, x)
        # B (second velocity half-step)
        v = v + 0.5 * dt * forces / masses
        return {**carry, "pos": x, "vel": v, "forces": forces,
                "potential": potential}

    def _frame_outputs(self, carry: Dict) -> Dict:
        out = super()._frame_outputs(carry)
        if self.save_energies:
            out["kinetic_energy"] = kinetic_energy(
                carry["vel"], self.initial_system.masses)
        return out


class OverdampedSimulation(Simulation):
    r"""Brownian dynamics (reference langevin.py:153-202):

    .. math::
        x \leftarrow x + F D\, dt + \sqrt{2 D\, dt}\, \xi,
        \quad D = 1 / (\beta \gamma)

    Masses and velocities are unused.
    """

    _batch_attrs = ("diffusion", "_dtau")

    def __init__(self, friction: float = 1.0, **kwargs: Any):
        super().__init__(**kwargs)
        if friction <= 0:
            raise ValueError("friction must be positive")
        self.friction = friction

    def _attach_configurations(self, configurations, beta):
        super()._attach_configurations(configurations, beta)
        if any(c.masses is not None for c in configurations):
            warnings.warn(
                "Masses were provided, but will not be used since an "
                "overdamped Langevin scheme is being used for integration."
            )
        system = self.initial_system
        beta_atom = system.beta[:, None].expand_as(system.masses)[..., None]
        self.diffusion = 1.0 / beta_atom / self.friction  # [S, A, 1]
        if system.atom_mask is not None:
            # zero diffusion freezes a mixed batch's padding: no drift,
            # no noise (reference langevin.py:179-182)
            self.diffusion = self.diffusion * system.atom_mask[..., None]
        self._dtau = self.diffusion * self.dt

    def _timestep(self, carry: Dict, xi: torch.Tensor) -> Dict:
        x = (carry["pos"] + carry["forces"] * self._dtau
             + torch.sqrt(2 * self._dtau) * xi)
        potential, forces, _ = self._forces(carry, x)
        return {**carry, "pos": x, "forces": forces, "potential": potential}
