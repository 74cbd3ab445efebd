"""Simulation engine, main-path slice (port of
flashmd_tpu/simulation/base.py).

What is here: the constructor options ``dt``, ``n_timesteps``,
``save_interval``, ``random_seed``, ``device`` (the card unless the
caller asks for the CPU) and the neighbour-list options
``neighbor_capacity``, ``neighbor_skin`` and ``neighbor_rebuild_interval``;
attach (which fits the Chebyshev filters on the host for a cheb model,
base.py:479-508), the minimum-image soundness check of periodic cells
with the xla path's switch to image replication (:399-437) and the
pair-exclusion binding check (:439-459); the initial carry (:661-683); the
Verlet neighbour list of the ``"xla"`` and ``"pallas"`` paths
(:580-716), under the cells and image shifts where there are any: rebuilt
at rcut + skin from the positions at the start of a step, every
``neighbor_rebuild_interval``
steps, with the running maxima of the true neighbour count and of the
displacement since the last rebuild kept on the device; ``simulate()``,
which steps in chunks of ``save_interval``, keeps position and potential
frames in memory at save points, raises the reference's capacity-overflow
and Verlet-skin warnings at its end (:1176-1197), and times the second half
of the run exactly as ``get_throughput_metrics`` (:1368-1390) defines it.
The host clock is read after ``torch.cuda.synchronize()`` on the card.

Not here yet: file export, checkpoints, the divergence and pair-floor
guards, CUDA graphs. The reference's ``gptq`` option (which forces bf16)
is not ported: the model runs at its configured precision.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.system import Configuration, System, collate
from ..models.forcefield import (
    ForceField,
    build_neighbors,
    compute_energy_forces,
    uses_neighbor_list,
)


logger = logging.getLogger(__name__)


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
        device: torch.device | str = "cuda",
        neighbor_capacity: Optional[int] = None,
        neighbor_skin: float = 1.0,
        neighbor_rebuild_interval: int = 1,
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
        # Verlet list: search radius rcut + neighbor_skin, rebuilt every
        # neighbor_rebuild_interval steps (1 = every step, always exact).
        self.neighbor_capacity = neighbor_capacity
        self.neighbor_skin = neighbor_skin
        self.neighbor_rebuild_interval = neighbor_rebuild_interval
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
        self._check_exclusion_binding(model, configurations)
        self._attach_configurations(configurations, beta)
        self._check_min_image_soundness()

    @staticmethod
    def _check_exclusion_binding(model, configurations):
        """Configurations that carry ``exc_pair_index`` need a model that
        honours it; running the SchNet term WITH the excluded pairs would
        change the physics (reference base.py:439-459)."""
        has_exc = any(c.exc_pair_index is not None for c in configurations)
        if (has_exc and model.schnet_params is not None
                and model.exc_pair_index is None):
            raise ValueError(
                "Configurations carry exc_pair_index but the model was "
                "built without pair exclusions; pass the structure's "
                "exclusions to forcefield_from_numpy(..., exc_pair_index=) "
                "or set ForceField.exc_pair_index explicitly."
            )

    def _check_min_image_soundness(self):
        """Periodic runs must satisfy the minimum-image condition at the
        search radius: rcut on the cheb path, which keeps no list, rcut +
        skin on a list path (reference base.py:399-437). The check reads
        the host copy of the cells, once; the per-step force evaluations
        then skip it. An xla field below the minimum-image regime switches
        to image replication with the skin, as in the reference; other
        paths raise, and a sound cell on dense or pallas raises as
        compute_energy_forces would. A field that comes with image shifts
        bound is checked, not trusted: the shifts must cover rcut + skin in
        these cells (the reference returns early, base.py:413)."""
        ff = self.model
        cell = self.initial_system.cell_host
        if cell is None or ff is None or ff.schnet_params is None:
            return
        from ..models.forcefield import (
            _check_cell,
            _require_exact_path_for_images,
            validate_image_cover,
            with_image_replication,
        )
        from ..ops.neighborlist import validate_min_image

        skin = self.neighbor_skin if self._uses_neighbor_list() else 0.0
        search_r = ff.rcut + skin
        context = "attach_model_and_configurations"
        _require_exact_path_for_images(ff)
        if ff.pbc_images is not None:
            validate_image_cover(ff, cell, search_r, context=context)
            return
        try:
            validate_min_image(cell, search_r, context=context)
        except ValueError:
            if ff.schnet_config.message_passing != "xla":
                raise
            self.model = with_image_replication(ff, cell, skin=skin)
            logger.info(
                "[pbc] cell below the minimum-image regime: switched the "
                "neighbor build to explicit image replication "
                f"({len(self.model.pbc_images)} lattice images)"
            )
            return
        _check_cell(ff, cell, check_cell=False)

    def _attach_model(self, model: ForceField):
        params = model.schnet_params
        if (
            params is not None
            and model.schnet_config.message_passing == "cheb"
            and "cheb_fit" not in params
        ):
            from ..models.cheb import attach_cheb_fit

            model = model.replace(
                schnet_params=attach_cheb_fit(params, model.schnet_config)
            )
        if self.neighbor_capacity is not None:
            model = model.replace(neighbor_capacity=self.neighbor_capacity)
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

    def _uses_neighbor_list(self) -> bool:
        return self.model is not None and uses_neighbor_list(self.model)

    def _rebuild_neighbors(self, carry: Dict) -> Dict:
        """The list (and its source CSR) from the carry's positions, under
        the system's cells (validated at attach) and the field's image
        shifts; the running max of the true neighbour count stays on the
        device."""
        nbr = build_neighbors(self.model, carry["pos"],
                              skin=self.neighbor_skin,
                              cell=self.initial_system.cell,
                              check_cell=False)
        n_max = nbr.n_max.max()
        prev = carry.get("nbr_n_max")
        out = {
            **carry,
            "nbr": nbr,
            "nbr_n_max": n_max if prev is None else torch.maximum(prev, n_max),
        }
        if self.neighbor_rebuild_interval > 1:
            out["nbr_ref_pos"] = carry["pos"]
        return out

    def _track_neighbor_displacement(self, carry: Dict) -> Dict:
        """Running max of the per-atom displacement since the last rebuild;
        an amortised list is exact while no atom moves more than skin/2."""
        disp2 = torch.sum(torch.square(carry["pos"] - carry["nbr_ref_pos"]),
                          dim=-1)
        disp = torch.sqrt(torch.max(disp2))
        return {**carry,
                "nbr_disp_max": torch.maximum(carry["nbr_disp_max"], disp)}

    def _forces(self, carry: Dict, pos):
        """Potential + forces at ``pos`` with the carry's neighbour list and
        the system's cells (validated at attach, so not here: that would
        read the cells from the card every step)."""
        return compute_energy_forces(
            self.model, pos, self.initial_system.atom_types, carry.get("nbr"),
            cell=self.initial_system.cell, check_cell=False,
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
        if self._uses_neighbor_list():
            carry = self._rebuild_neighbors(carry)
            if self.neighbor_rebuild_interval > 1:
                carry["nbr_disp_max"] = torch.zeros((), dtype=self.dtype,
                                                    device=self.device)
        potential, forces, _ = self._forces(carry, system.pos)
        carry["forces"] = forces
        carry["potential"] = potential
        return carry

    def _step_with_hooks(self, carry: Dict, xi: torch.Tensor,
                         t: int) -> Dict:
        """Step ``t`` (0-based): the list is rebuilt from the positions at
        the start of the step, then the integrator step evaluates the force
        at the new positions with it (reference _step_with_hooks,
        base.py:697-716)."""
        nbr_list = self._uses_neighbor_list()
        if nbr_list and t % self.neighbor_rebuild_interval == 0:
            carry = self._rebuild_neighbors(carry)
        carry = self._timestep(carry, xi)
        if nbr_list and self.neighbor_rebuild_interval > 1:
            carry = self._track_neighbor_displacement(carry)
        return carry

    def _warn_neighbor_list(self, carry: Dict) -> None:
        """The reference's export-time checks (base.py:1176-1197)."""
        if "nbr_n_max" in carry:
            n_max = int(carry["nbr_n_max"])
            cap = self.model.neighbor_capacity
            if n_max > cap:
                warnings.warn(
                    f"Neighbor capacity overflow: an atom had {n_max} "
                    f"neighbors within rcut+skin but capacity is {cap}; "
                    "the farthest were dropped. Increase neighbor_capacity.",
                    RuntimeWarning,
                )
        if "nbr_disp_max" in carry:
            d_max = float(carry["nbr_disp_max"])
            half_skin = self.neighbor_skin / 2
            if d_max > half_skin:
                warnings.warn(
                    "Verlet-skin soundness violated: an atom moved "
                    f"{d_max:.4f} since the last neighbor rebuild but "
                    f"skin/2 is {half_skin:.4f}, so forces may have used a "
                    "stale neighbor list. Decrease "
                    "neighbor_rebuild_interval or increase neighbor_skin.",
                    RuntimeWarning,
                )

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
                    carry = self._step_with_hooks(carry, xi, step)
                    step += 1
                pos_frames.append(carry["pos"].clone())
                pot_frames.append(carry["potential"].clone())
            _synchronize(self.device)
        self._simulation_end_time = time.perf_counter()
        if self._warmup_end_time is None:
            self._warmup_end_time = self._simulation_end_time
            self._steps_at_warmup_end = step
        self._post_warmup_steps = step - self._steps_at_warmup_end
        self.final_carry = carry
        self._warn_neighbor_list(carry)
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
