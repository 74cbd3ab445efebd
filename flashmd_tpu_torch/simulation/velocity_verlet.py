"""NVE (microcanonical) velocity Verlet (port of
flashmd_tpu/simulation/velocity_verlet.py): symplectic, time-reversible,
one force evaluation per step, no noise drawn. Initial velocities are
Maxwell-Boltzmann sampled from ``random_seed + 1`` where the
configurations give none; a mixed batch's padding starts, and stays, at
rest (reference velocity_verlet.py:50-54)."""

from __future__ import annotations

from typing import Dict

from .base import Simulation
from .langevin import attach_velocities, kinetic_energy


class NVESimulation(Simulation):
    r"""Velocity Verlet (reference velocity_verlet.py:23-97):

    .. math::
        v_{t+1/2} = v_t + (dt / 2m) F(x_t) \\
        x_{t+1} = x_t + dt\, v_{t+1/2} \\
        v_{t+1} = v_{t+1/2} + (dt / 2m) F(x_{t+1})
    """

    uses_noise = False

    def _attach_configurations(self, configurations, beta):
        super()._attach_configurations(configurations, beta)
        attach_velocities(self)

    def _timestep(self, carry: Dict, xi=None) -> Dict:
        dt = self.dt
        m = self.initial_system.masses[..., None]
        v_half = carry["vel"] + 0.5 * dt * carry["forces"] / m
        x = carry["pos"] + dt * v_half
        potential, forces, _ = self._forces(carry, x)
        v = v_half + 0.5 * dt * forces / m
        return {**carry, "pos": x, "vel": v, "forces": forces,
                "potential": potential}

    def _frame_outputs(self, carry: Dict) -> Dict:
        out = super()._frame_outputs(carry)
        if self.save_energies:
            out["kinetic_energy"] = kinetic_energy(
                carry["vel"], self.initial_system.masses)
        return out
