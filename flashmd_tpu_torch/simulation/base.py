"""Simulation engine, main-path slice (port of
flashmd_tpu/simulation/base.py).

What is here: the constructor options ``dt``, ``n_timesteps``,
``save_interval``, ``random_seed`` and ``device``; attach (which fits the
Chebyshev filters on the host, base.py:479-508); the initial carry
(:661-683); ``simulate()``, which steps in chunks of ``save_interval``,
keeps position and potential frames in memory at save points, and times
the second half of the run exactly as ``get_throughput_metrics``
(:1368-1390) defines it. The host clock is read after
``torch.cuda.synchronize()`` on the card.

Not here yet: file export, checkpoints, the divergence and pair-floor
guards, CUDA graphs. The reference's ``gptq`` option (which forces bf16)
is not ported: the model runs at its configured precision.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.system import Configuration, System, collate
from ..models.forcefield import ForceField, compute_energy_forces


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Simulation:
    """Base class for MD simulations of a trained force field."""

    def __init__(
        self,
        dt: float = 5e-4,
        n_timesteps: int = 100,
        save_interval: int = 10,
        random_seed: Optional[int] = 233,
        device: torch.device | str = "cpu",
    ):
        if n_timesteps % save_interval != 0:
            raise ValueError(
                "The save_interval must be a factor of the simulation "
                "n_timesteps"
            )
        self.dt = dt
        self.n_timesteps = n_timesteps
        self.save_interval = save_interval
        self.random_seed = 233 if random_seed is None else random_seed
        self.device = torch.device(device)
        self.dtype = torch.float32
        self.model: Optional[ForceField] = None
        self.initial_system: Optional[System] = None
        self._warmup_end_time = None
        self._simulation_end_time = None
        self._post_warmup_steps = 0
        self._simulated = False

    # ------------------------------------------------------------------
    # Attachment
    # ------------------------------------------------------------------

    def attach_model_and_configurations(
        self, model: ForceField, configurations: List[Configuration], beta
    ):
        self._attach_model(model)
        self._attach_configurations(configurations, beta)

    def _attach_model(self, model: ForceField):
        params = model.schnet_params
        if params is not None and "cheb_fit" not in params:
            from ..models.cheb import attach_cheb_fit

            model = model.replace(
                schnet_params=attach_cheb_fit(params, model.schnet_config)
            )
        self.model = model

    def _attach_configurations(self, configurations, beta):
        system = collate(
            configurations, beta=beta, device=self.device, dtype=self.dtype
        )
        self.n_sims = system.n_sims
        self.n_atoms = system.n_atoms
        self.n_dims = system.n_dims
        self.beta = system.beta
        self.initial_system = system

    # ------------------------------------------------------------------
    # Integrator interface
    # ------------------------------------------------------------------

    def _forces(self, pos):
        return compute_energy_forces(
            self.model, pos, self.initial_system.atom_types
        )

    def _init_carry(self, system: System) -> Dict:
        carry = {
            "pos": system.pos,
            "vel": (
                system.velocities
                if system.velocities is not None
                else torch.zeros_like(system.pos)
            ),
        }
        potential, forces, _ = self._forces(system.pos)
        carry["forces"] = forces
        carry["potential"] = potential
        return carry

    def _timestep(self, carry: Dict, xi: torch.Tensor) -> Dict:
        """One step; ``xi`` is the step's standard-normal noise."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # The host loop
    # ------------------------------------------------------------------

    def simulate(self, overwrite: bool = False) -> np.ndarray:
        if self._simulated and not overwrite:
            raise RuntimeError(
                "Simulation results are already populated. To rerun, set "
                "overwrite=True."
            )
        if self.model is None or self.initial_system is None:
            raise RuntimeError(
                "Call attach_model_and_configurations before simulate()."
            )
        gen = torch.Generator(device=self.device).manual_seed(
            self.random_seed
        )
        self._warmup_end_time = None
        halfway_step = self.n_timesteps // 2
        pos_frames, pot_frames = [], []
        step = 0
        with torch.no_grad():
            carry = self._init_carry(self.initial_system)
            shape = carry["pos"].shape
            while step < self.n_timesteps:
                if self._warmup_end_time is None and step >= halfway_step:
                    _synchronize(self.device)
                    self._warmup_end_time = time.perf_counter()
                    self._steps_at_warmup_end = step
                for _ in range(self.save_interval):
                    xi = torch.randn(
                        shape, generator=gen, device=self.device,
                        dtype=self.dtype,
                    )
                    carry = self._timestep(carry, xi)
                step += self.save_interval
                pos_frames.append(carry["pos"].clone())
                pot_frames.append(carry["potential"].clone())
            _synchronize(self.device)
        self._simulation_end_time = time.perf_counter()
        if self._warmup_end_time is None:
            self._warmup_end_time = self._simulation_end_time
            self._steps_at_warmup_end = step
        self._post_warmup_steps = step - self._steps_at_warmup_end
        self.final_carry = carry
        # [frames, S, ...] on the host
        self.simulated_coords = torch.stack(pos_frames).cpu().numpy()
        self.simulated_potential = torch.stack(pot_frames).cpu().numpy()
        self._simulated = True
        return self.coords

    @property
    def coords(self) -> np.ndarray:
        """Saved coordinates as (n_sims, frames, atoms, dims)."""
        return np.swapaxes(self.simulated_coords, 0, 1)

    def get_throughput_metrics(self) -> Optional[dict]:
        """Second-half throughput: (steps * n_sims) / elapsed over the
        second half of the run (reference base.py:1368-1390)."""
        if self._warmup_end_time is None or self._simulation_end_time is None:
            return None
        second_half_time = self._simulation_end_time - self._warmup_end_time
        second_half_steps = self._post_warmup_steps
        if second_half_time > 0 and second_half_steps > 0:
            throughput = (second_half_steps * self.n_sims) / second_half_time
            ms_per_step = second_half_time / second_half_steps * 1000
        else:
            throughput = 0.0
            ms_per_step = 0.0
        return {
            "second_half_elapsed_time": second_half_time,
            "second_half_steps": second_half_steps,
            "throughput": throughput,
            "ms_per_timestep": ms_per_step,
            "first_half_steps": self.n_timesteps // 2,
            "n_sims": self.n_sims,
            "n_atoms": self.n_atoms,
        }
