"""Simulation engine (port of flashmd_tpu/simulation/base.py).

What is here: the constructor options ``dt``, ``n_timesteps``,
``save_interval``, ``save_energies``, ``random_seed``, ``device`` (the
card unless the caller asks for the CPU) and the neighbour-list options
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
displacement since the last rebuild kept on the device; the in-loop
subroutine hook (identity here; parallel tempering's replica exchange),
run after the step that makes ``(t + 1) % sim_subroutine_interval == 0``
(:697-725); ``simulate()``, which steps in chunks of ``save_interval``,
keeps ``_frame_outputs`` on the device at save points (positions,
potentials, the blow-up statistic ``pos_spread``, the neighbour maxima,
the Chebyshev pair floor ``pair_d_min``; the integrators add theirs),
copies them to the host once at its end and runs the reference's
divergence, capacity-overflow, Verlet-skin and pair-floor checks on them
(:1150-1215), and times the second half of the run exactly as
``get_throughput_metrics`` (:1368-1390) defines it. The host clock is
read after ``torch.cuda.synchronize()`` on the card; nothing inside the
step loop reads the card.

Every draw comes from the simulation's one ``torch.Generator`` on the
device, in a fixed order per step: the step's standard-normal noise (none
for an integrator that uses none), then the subroutine's uniforms after
the steps that run it. Two runs with one seed are bitwise equal.

Not here yet: file export, checkpoints and resume, logging, CUDA graphs.
The reference's ``gptq`` option (which forces bf16) is not ported: the
model runs at its configured precision.
"""

from __future__ import annotations

import logging
import time
import warnings
from typing import Dict, List, Optional, Tuple

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


def fetch_frames(frames: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The tensors as numpy arrays through ONE device-to-host copy: their
    bytes are packed into one buffer on the device, copied, and read back
    in their own dtypes and shapes."""
    parts = {k: v.contiguous().reshape(-1) for k, v in frames.items()}
    buf = torch.cat([v.view(torch.uint8) for v in parts.values()]).cpu()
    raw = buf.numpy()
    out, off = {}, 0
    for k, v in parts.items():
        dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        out[k] = np.frombuffer(raw, dtype=dtype, count=v.numel(),
                               offset=off).reshape(frames[k].shape).copy()
        off += v.numel() * v.element_size()
    return out


class Simulation:
    """Base class for MD simulations of a trained force field."""

    #: whether a step takes a standard-normal draw of the positions' shape
    uses_noise = True
    #: steps between runs of the in-loop subroutine (None: never)
    sim_subroutine_interval: Optional[int] = None

    def __init__(
        self,
        dt: float = 5e-4,
        n_timesteps: int = 100,
        save_interval: int = 10,
        save_energies: bool = False,
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
        self.save_energies = save_energies
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
        # Blow-up guard scale (reference base.py:557-560).
        self.initial_pos_spread = float(
            max(np.std(np.asarray(c.pos), axis=0).max() for c in configurations)
        )
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

    def _has_device_subroutine(self) -> bool:
        return False

    def _subroutine_due(self, t: int) -> bool:
        """Whether the subroutine runs after step ``t`` (0-based)."""
        return (self._has_device_subroutine()
                and (t + 1) % self.sim_subroutine_interval == 0)

    def _subroutine_draw_shape(self) -> Tuple[int, ...]:
        """Shape of the uniforms one subroutine run takes."""
        raise NotImplementedError

    def _device_subroutine(self, carry: Dict, u: torch.Tensor) -> Dict:
        """In-loop subroutine (parallel tempering's exchange); ``u`` is its
        uniform draw. Identity by default."""
        return carry

    def _step_draws(self, gen: torch.Generator, t: int):
        """(xi, u) of step ``t``: its standard-normal noise (None for an
        integrator that uses none) and, where the subroutine runs after
        it, the subroutine's uniforms (else None), drawn in that order."""
        xi = u = None
        if self.uses_noise:
            xi = torch.randn(self.initial_system.pos.shape, generator=gen,
                             device=self.device, dtype=self.dtype)
        if self._subroutine_due(t):
            u = torch.rand(self._subroutine_draw_shape(), generator=gen,
                           device=self.device, dtype=self.dtype)
        return xi, u

    def _step_with_hooks(self, carry: Dict, xi: Optional[torch.Tensor],
                         t: int, u: Optional[torch.Tensor] = None) -> Dict:
        """Step ``t`` (0-based): the list is rebuilt from the positions at
        the start of the step, then the integrator step evaluates the force
        at the new positions with it, then the subroutine runs if the step
        makes ``(t + 1) % sim_subroutine_interval == 0`` (reference
        _step_with_hooks, base.py:697-725)."""
        nbr_list = self._uses_neighbor_list()
        if nbr_list and t % self.neighbor_rebuild_interval == 0:
            carry = self._rebuild_neighbors(carry)
        carry = self._timestep(carry, xi)
        if nbr_list and self.neighbor_rebuild_interval > 1:
            carry = self._track_neighbor_displacement(carry)
        if self._subroutine_due(t):
            carry = self._device_subroutine(carry, u)
        return carry

    def _timestep(self, carry: Dict, xi: Optional[torch.Tensor]) -> Dict:
        """One step; ``xi`` is the step's standard-normal noise (None
        where ``uses_noise`` is False)."""
        raise NotImplementedError

    # ------------------------------------------------------------------
    # Save points and their checks
    # ------------------------------------------------------------------

    def _frame_outputs(self, carry: Dict) -> Dict[str, torch.Tensor]:
        """What is recorded at each save point, on the device (reference
        _frame_outputs, base.py:727-765). The carry's tensors are never
        written in place, so they are kept without a copy."""
        pos = carry["pos"]
        out = {
            "pos": pos,
            "potential": carry["potential"],
            "pos_spread": torch.std(pos.reshape(pos.shape[0], -1), dim=1,
                                    correction=0),
        }
        for key in ("nbr_n_max", "nbr_disp_max"):
            if key in carry:
                out[key] = carry[key]
        d_min = self._pair_d_min(pos)
        if d_min is not None:
            out["pair_d_min"] = d_min
        return out

    def _pair_d_min(self, pos) -> Optional[torch.Tensor]:
        """The smallest pair distance in the batch, minimum-imaged under
        the system's cells, where the field is cheb with a restricted fit
        domain (cheb_d_min > 0); else None (reference _pair_floor_outputs,
        base.py:767-802)."""
        cfg = None if self.model is None else self.model.schnet_config
        if (cfg is None or cfg.message_passing != "cheb"
                or cfg.cheb_d_min <= 0.0):
            return None
        from ..ops.neighborlist import _cell_operands, pair_rel

        cell, inv = _cell_operands(self.initial_system.cell, pos.shape[0],
                                   pos.device)
        rel = pair_rel(pos, cell, inv)
        d2 = torch.sum(rel * rel, dim=-1)
        eye = torch.eye(pos.shape[1], dtype=d2.dtype, device=d2.device)
        return torch.sqrt(torch.min(d2 + eye * 1e12))

    def _check_divergence(self, frames: Dict[str, np.ndarray],
                          step_end: int) -> None:
        """Trajectory blow-up guard and the list and fit-domain checks on
        the host frames (reference _check_divergence, base.py:1150-1215)."""
        spread = frames["pos_spread"]  # [n_frames, S]
        bad = ~np.isfinite(spread) | (
            spread > 1e3 * max(self.initial_pos_spread, 1e-12)
        )
        if np.any(bad):
            frame_idx = int(np.argwhere(bad.any(axis=1))[0][0])
            n_frames = spread.shape[0]
            t = step_end - (n_frames - 1 - frame_idx) * self.save_interval
            raise RuntimeError(
                f"Simulation of trajectory blew up at #timestep={t}"
            )
        if "nbr_n_max" in frames:
            n_max = int(frames["nbr_n_max"].max())
            cap = self.model.neighbor_capacity
            if n_max > cap:
                warnings.warn(
                    f"Neighbor capacity overflow: an atom had {n_max} "
                    f"neighbors within rcut+skin but capacity is {cap}; "
                    "the farthest were dropped. Increase neighbor_capacity.",
                    RuntimeWarning,
                )
        if "nbr_disp_max" in frames:
            d_max = float(frames["nbr_disp_max"].max())
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
        if "pair_d_min" in frames:
            d_seen = float(np.min(frames["pair_d_min"]))
            floor = float(self.model.schnet_config.cheb_d_min)
            if d_seen < floor:
                warnings.warn(
                    f"Chebyshev fit-domain floor crossed: a pair came "
                    f"within {d_seen:.4f} but the filter was fitted on "
                    f"[{floor}, rcut] (cheb_d_min). Forces for that pair "
                    "were first-order extrapolated (accuracy degrades "
                    "quadratically with depth below the floor). Lower "
                    "cheb_d_min (0 restores the full-domain fit) or "
                    "strengthen the repulsive prior.",
                    RuntimeWarning,
                )

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
        frames = []
        step = 0
        with torch.no_grad():
            carry = self._init_carry(self.initial_system)
            while step < self.n_timesteps:
                if self._warmup_end_time is None and step >= halfway_step:
                    _synchronize(self.device)
                    self._warmup_end_time = time.perf_counter()
                    self._steps_at_warmup_end = step
                for _ in range(self.save_interval):
                    xi, u = self._step_draws(gen, step)
                    carry = self._step_with_hooks(carry, xi, step, u)
                    step += 1
                frames.append(self._frame_outputs(carry))
            stacked = {k: torch.stack([f[k] for f in frames])
                       for k in frames[0]}
            _synchronize(self.device)
        self._simulation_end_time = time.perf_counter()
        if self._warmup_end_time is None:
            self._warmup_end_time = self._simulation_end_time
            self._steps_at_warmup_end = step
        self._post_warmup_steps = step - self._steps_at_warmup_end
        self.final_carry = carry
        host = fetch_frames(stacked)  # [frames, S, ...] on the host
        self._check_divergence(host, step)
        self.simulated_frames = host
        self.simulated_coords = host["pos"]
        self.simulated_potential = host["potential"]
        self.simulated_kinetic_energies = host.get("kinetic_energy")
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
