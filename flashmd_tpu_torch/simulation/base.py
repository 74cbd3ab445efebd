"""Simulation engine (port of flashmd_tpu/simulation/base.py).

The constructor takes the reference's options (base.py:77-358): what is
saved (coordinates always; ``save_forces``, ``save_energies``, the energy
and force components of named models), the export, log and checkpoint
files with their intervals and the "already exists" refusal, resume from
a checkpoint, the host subroutines, the profiler window, the shape log,
neighbour-list dumps, ``max_steps_per_launch``, ``dtype`` and ``gptq``
(whose default, as in the reference, runs the network in bf16), and the
port's ``device`` (the card unless the caller asks for the CPU). The
reference's ``compile``, ``compile_mode``, ``force_compile`` and
``compile_model`` are accepted and do nothing, as there (:104-107): the
port compiles nothing at run time, and its kernels build once into
``_build/``.

Attach fits the Chebyshev filters on the host for a cheb model
(base.py:479-508), checks periodic cells for the minimum-image condition
with the xla path's switch to image replication (:399-437) and the
pair-exclusion binding (:439-459), and dumps the attached model next to
the outputs (:461-477).

``simulate()`` runs the reference's export loop (:891-1131). The run is
cut into export segments and each segment into launches of whole save
intervals, at most ``max_steps_per_launch`` steps each. A launch steps on
the device and stacks its save points' ``_frame_outputs`` there; its
frames (and, at a segment's end, the state its checkpoint writes) are
packed into one buffer and copied to pinned host memory on a side stream
behind an event, so that the copy never waits for work queued after it.
Launch k + 1 is dispatched before launch k is fetched, guarded (blow-up,
list capacity, Verlet skin, Chebyshev pair floor; :1163-1211) and
written, except where a host ``sim_subroutine`` or a ``save_subroutine``
may change the carry between segments: then the order is synchronous.
Nothing inside a launch reads the card, apart from the one
``torch.cuda.synchronize()`` at the throughput fence.

Every draw comes from the simulation's one ``torch.Generator`` on the
device, in a fixed order per step: the step's standard-normal noise (none
for an integrator that uses none), then the subroutine's uniforms after
the steps that run it. Two runs with one seed are bitwise equal, and a
checkpoint stores the generator's state as it was when its launch had
been dispatched, so a resumed run draws what the uninterrupted one drew.

Throughput is the second half of the run as ``get_throughput_metrics``
(:1368-1390) defines it, with the fence read at the first save point at
or past half-way (the reference reads it at a launch start only).

A list of per-molecule force fields attaches a mixed-size batch
(:367-397, :510-560): the fields are stacked (one network, the priors
along [S]), the configurations padded to the largest (``collate_padded``),
the atom mask reaches the force field, the blow-up statistic counts real
atoms only, and ``<filename>_atom_mask.npy`` is written once.

A ``mesh`` (:mod:`flashmd_tpu_torch.parallel.mesh`; one process per GPU)
shards the batch (reference base.py:119, 924-927): every rank attaches the
whole batch, then keeps its rows of the system, of the stacked priors of a
mixed batch and of the integrator's per-molecule tensors, so that
``initial_system`` holds this rank's rows. Each step draws the whole
batch's noise and keeps its rows, so a sharded run draws what the
unsharded one draws. Each launch all-gathers its frames and reduces the
guards' scalars (list capacity, Verlet displacement, pair floor) over the
ranks, so every rank guards the whole batch and raises what the others
raise; checkpoints and the final carry are gathered the same way. Files,
the dump, the log file, the shape log and the profiler trace are written
by rank 0 alone (:func:`~flashmd_tpu_torch.parallel.mesh.is_io_process`).
The throughput fence waits for every rank.

Not ported: CUDA graphs.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.keys import POSITIONS_KEY, VELOCITY_KEY
from ..data.system import Configuration, System, collate, collate_padded
from ..models.forcefield import (
    ForceField,
    build_neighbors,
    compute_energy_forces,
    stack_forcefields,
    total_energy,
    uses_neighbor_list,
)
from ..ops.neighborlist import NeighborMatrix
from ..parallel.mesh import (
    all_gather,
    all_reduce,
    as_mesh,
    barrier,
    gather_neighbor_matrix,
    is_io_process,
)
from ..utils.io import close_log_file, logger, setup_logging, tqdm


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class HostCopy:
    """Tensors on their way to the host as numpy arrays, through ONE
    device-to-host copy: their bytes are packed into one buffer on the
    current stream; on the card, a side stream waits for that work only
    and copies the buffer into pinned memory without blocking, so that
    ``result()`` waits for this copy and not for what was queued after
    it."""

    def __init__(self, tensors: Dict[str, torch.Tensor],
                 stream: Optional[torch.cuda.Stream] = None):
        self._meta = [(k, v.dtype, tuple(v.shape)) for k, v in tensors.items()]
        parts = [v.contiguous().reshape(-1).view(torch.uint8)
                 for v in tensors.values()]
        buf = torch.cat(parts) if parts else torch.empty(0, dtype=torch.uint8)
        self._done = None
        if buf.is_cuda:
            stream = stream or torch.cuda.Stream(buf.device)
            ready = torch.cuda.Event()
            ready.record()
            self._host = torch.empty(buf.shape, dtype=torch.uint8,
                                     pin_memory=True)
            with torch.cuda.stream(stream):
                stream.wait_event(ready)
                self._host.copy_(buf, non_blocking=True)
                self._done = torch.cuda.Event()
                self._done.record(stream)
            buf.record_stream(stream)
        else:
            self._host = buf

    def result(self) -> Dict[str, np.ndarray]:
        if self._done is not None:
            self._done.synchronize()
        raw = self._host.numpy()
        out, off = {}, 0
        for k, dtype, shape in self._meta:
            np_dtype = torch.empty((), dtype=dtype).numpy().dtype
            n = int(np.prod(shape, dtype=np.int64))
            out[k] = np.frombuffer(raw, dtype=np_dtype, count=n,
                                   offset=off).reshape(shape).copy()
            off += n * np_dtype.itemsize
        return out


def fetch_frames(frames: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The tensors as numpy arrays through one device-to-host copy."""
    return HostCopy(frames).result()


@dataclasses.dataclass
class _Launch:
    """A dispatched launch waiting to be fetched, guarded and written."""

    copy: HostCopy
    carry: Dict
    step_end: int
    n_frames: int
    seg_end: bool
    rng_state: np.ndarray


class Simulation:
    """Base class for MD simulations of a trained force field."""

    #: whether a step takes a standard-normal draw of the positions' shape
    uses_noise = True
    #: the integrator's per-molecule [S, ...] tensors, sharded with the batch
    _batch_attrs: Tuple[str, ...] = ()
    #: carry entries that are the same on every rank, whatever their shape
    _replicated_carry = frozenset()
    #: the save-point scalars of the guards, and their reduction over ranks
    _frame_reductions = {"nbr_n_max": "max", "nbr_disp_max": "max",
                         "pair_d_min": "min"}

    def __init__(
        self,
        dt: float = 5e-4,
        save_forces: bool = False,
        save_energies: bool = False,
        save_force_components: bool = False,
        save_energy_components: bool = False,
        force_components=None,
        energy_components=None,
        n_timesteps: int = 100,
        save_interval: int = 10,
        create_checkpoints: bool = False,
        read_checkpoint_file: Union[str, bool, None] = None,
        random_seed: Optional[int] = 233,
        device: torch.device | str = "cuda",
        dtype: str = "single",
        export_interval: Optional[int] = None,
        log_interval: Optional[int] = None,
        log_type: str = "write",
        filename: Optional[str] = None,
        add_timestamp: bool = False,
        output_dir: str = "./outputs",
        specialize_priors: bool = False,
        tqdm_refresh: float = 10,
        sim_subroutine: Optional[Callable] = None,
        sim_subroutine_interval: Optional[int] = None,
        save_subroutine: Optional[Callable] = None,
        compile: bool = True,
        compile_mode: str = "default",
        force_compile: bool = False,
        compile_model: bool = True,
        profile_start_step: Optional[int] = None,
        profile_end_step: Optional[int] = None,
        gptq: Optional[str] = "w16a16",
        print_shape: bool = False,
        print_shape_steps: int = 3,
        dump_neighbor_list: bool = False,
        dump_neighbor_list_last_n: Optional[int] = None,
        neighbor_capacity: Optional[int] = None,
        neighbor_skin: float = 1.0,
        neighbor_rebuild_interval: int = 1,
        max_steps_per_launch: Optional[int] = 1000,
        mesh=None,
    ):
        self.model: Optional[ForceField] = None
        self.gptq = gptq
        if gptq is not None and gptq not in ("w16a16", "bf16"):
            raise ValueError(
                f"Unsupported GPTQ mode: {gptq}. Supported: 'w16a16' "
                "(mapped to bf16 on TPU) or 'bf16'."
            )
        self.dt = dt
        self.save_forces = save_forces
        self.save_energies = save_energies
        self.save_force_components = save_force_components
        self.save_energy_components = save_energy_components
        if isinstance(force_components, str):
            force_components = [force_components]
        if isinstance(energy_components, str):
            energy_components = [energy_components]
        self.force_components = force_components
        self.energy_components = energy_components
        self.n_timesteps = n_timesteps
        self.save_interval = save_interval
        self.create_checkpoints = create_checkpoints
        self.read_checkpoint_file = (
            None if read_checkpoint_file is False else read_checkpoint_file
        )
        self.random_seed = 233 if random_seed is None else random_seed
        self.device = torch.device(device)
        # A ReplicaMesh, "auto" (every rank of the process group) or N (the
        # first N ranks): this rank then runs on the mesh's device.
        self.mesh = as_mesh(mesh)
        if self.mesh is not None:
            if self.mesh.device.type != self.device.type:
                raise ValueError(
                    f"device {device!r} differs from the mesh's device "
                    f"{self.mesh.device}"
                )
            self.device = self.mesh.device
        self._rows = slice(None)  # this rank's rows of the batch
        if dtype == "single":
            self.dtype = torch.float32
        elif dtype == "double":
            self.dtype = torch.float64
        else:
            raise ValueError("dtype must be 'single' or 'double'")
        self.export_interval = (
            n_timesteps if export_interval is None else export_interval
        )
        self._export_specified = export_interval is not None
        self.log_interval = log_interval
        if log_type not in ("print", "write"):
            raise ValueError("log_type can be either 'print' or 'write'")
        self.log_type = log_type
        self.output_dir = output_dir
        if filename is not None:
            os.makedirs(output_dir, exist_ok=True)
            if add_timestamp:
                filename = f"{filename}_{time.strftime('%Y%m%d_%H%M%S')}"
            self.filename = os.path.join(output_dir, filename)
        else:
            self.filename = None
        self.specialize_priors = specialize_priors  # priors are always
        self.tqdm_refresh = tqdm_refresh  # specialised at construction
        self.sim_subroutine = sim_subroutine
        self.sim_subroutine_interval = sim_subroutine_interval
        self.save_subroutine = save_subroutine
        self.profile_start_step = profile_start_step
        self.profile_end_step = profile_end_step
        self.print_shape = print_shape
        self.print_shape_steps = print_shape_steps
        self.dump_neighbor_list = dump_neighbor_list
        self.dump_neighbor_list_last_n = dump_neighbor_list_last_n
        # Verlet list: search radius rcut + neighbor_skin, rebuilt every
        # neighbor_rebuild_interval steps (1 = every step, always exact).
        self.neighbor_capacity = neighbor_capacity
        self.neighbor_skin = neighbor_skin
        self.neighbor_rebuild_interval = neighbor_rebuild_interval
        # Steps of one launch, rounded down to whole save intervals and
        # never below one; None: one launch per export segment.
        self.max_steps_per_launch = max_steps_per_launch
        self.initial_system: Optional[System] = None
        self._stream = None  # the side stream of the host copies
        self._warmup_end_time = None
        self._simulation_end_time = None
        self._post_warmup_steps = 0
        self._simulated = False
        self.input_option_checks()

    # ------------------------------------------------------------------
    # Option validation (reference base.py:226-358)
    # ------------------------------------------------------------------

    def input_option_checks(self):
        if (self.max_steps_per_launch is not None
                and self.max_steps_per_launch < 1):
            raise ValueError(
                "max_steps_per_launch must be a positive number of "
                f"timesteps or None (got {self.max_steps_per_launch})"
            )
        if self.n_timesteps % self.save_interval != 0:
            raise ValueError(
                "The save_interval must be a factor of the simulation "
                "n_timesteps"
            )
        if self._export_specified and self.filename is None:
            raise RuntimeError(
                "Must specify filename if export_interval isn't None"
            )
        if self.log_interval is not None:
            if self.log_type == "write" and self.filename is None:
                raise RuntimeError(
                    "Must specify filename if log_interval isn't None and "
                    "log_type=='write'"
                )
            if self.log_interval % self.save_interval != 0:
                raise ValueError(
                    "Logging must occur at a multiple of save_interval"
                )
        if self.n_timesteps // self.export_interval >= 10000:
            raise ValueError(
                "Simulation saving is not implemented if more than "
                "10000 files will be generated"
            )
        if self.export_interval % self.save_interval != 0:
            raise ValueError(
                "Numpy saving must occur at a multiple of save_interval"
            )

        self._read_checkpoint()

        if self.filename is not None:
            first = f"{self.filename}_coords_{self._npy_file_index:04d}.npy"
            if os.path.isfile(first):
                raise ValueError(
                    f"{first} already exists; choose a different filename."
                )
        if self.sim_subroutine is not None and (
            self.sim_subroutine_interval is None
        ):
            raise ValueError(
                f"subroutine {self.sim_subroutine} specified, but "
                "subroutine_interval is ambiguous."
            )
        if self.sim_subroutine_interval is not None and (
            self.sim_subroutine is None
            and not self._has_device_subroutine()
        ):
            raise ValueError(
                "subroutine interval specified, but subroutine is ambiguous."
            )
        if self.save_force_components and self.force_components is None:
            raise ValueError(
                "save_force_components is requested, but no force_components "
                "provided"
            )
        if self.save_energy_components and self.energy_components is None:
            raise ValueError(
                "save_energy_components is requested, but no "
                "energy_components provided"
            )

    def _read_checkpoint(self):
        """The resume half of the option checks (reference :265-325): the
        positions, velocities, export index, intervals and ``carry__*``
        entries of a checkpoint of either package, and the generator
        state of one of this package. A JAX ``rng_key`` cannot seed a
        ``torch.Generator``: the run then warns and draws from
        ``random_seed``, as the reference does without a key."""
        self.checkpointed_state = None
        self.current_timestep = 0
        self._npy_file_index = 0
        self._checkpoint_rng_state = None
        self._checkpoint_carry_extra = {}
        if self.read_checkpoint_file is None:
            return
        if isinstance(self.read_checkpoint_file, str):
            fn = self.read_checkpoint_file
        else:
            pattern = f"{self.filename}_checkpoint_[0-9]*.npz"
            files = sorted(glob.glob(pattern))
            if not files:
                raise FileNotFoundError(
                    f"No checkpoint file found matching {pattern}"
                )
            fn = files[-1]
        ckpt = dict(np.load(fn, allow_pickle=False))
        self.checkpointed_state = ckpt
        self.current_timestep = int(ckpt["current_timestep"])
        if "rng_state" in ckpt:
            self._checkpoint_rng_state = ckpt["rng_state"]
        else:
            why = ("holds the JAX package's rng_key, which cannot seed a "
                   "torch.Generator" if "rng_key" in ckpt
                   else "has no rng_state")
            warnings.warn(
                f"Checkpoint {why}: the resumed run seeds its generator "
                "from random_seed and will REPLAY the original run's noise "
                "sequence.",
                UserWarning,
            )
        self._checkpoint_carry_extra = {
            k[len("carry__"):]: v for k, v in ckpt.items()
            if k.startswith("carry__")
        }
        for field in ("export_interval", "save_interval", "log_interval"):
            if field not in ckpt or ckpt[field].size == 0:
                continue
            val = int(ckpt[field])
            if field == "log_interval" and val == -1:
                continue
            if getattr(self, field) != val and not (
                field == "log_interval" and getattr(self, field) is None
            ):
                warnings.warn(
                    f"specified {field} doesn't match the {field} in "
                    "the checkpoint, using checkpointed value instead",
                    UserWarning,
                )
                setattr(self, field, val)
        self._npy_file_index = self.current_timestep

    def _has_device_subroutine(self) -> bool:
        """Whether an in-loop subroutine runs on the device (PT)."""
        return False

    # ------------------------------------------------------------------
    # Attachment
    # ------------------------------------------------------------------

    def attach_model_and_configurations(
        self, model: Union[ForceField, List[ForceField]],
        configurations: List[Configuration], beta
    ):
        """Attach the force field and the starting structures. A LIST of
        force fields, one per configuration and all of one network,
        selects a mixed-size batch: the fields are stacked
        (``stack_forcefields``) and the configurations padded to the
        largest (``collate_padded``)."""
        if isinstance(model, (list, tuple)):
            if len(model) != len(configurations):
                raise ValueError(
                    f"Got {len(model)} force fields for "
                    f"{len(configurations)} configurations; a mixed "
                    "batch needs one per configuration."
                )
            model = stack_forcefields(model)
        self._attach_model(model)
        self._check_exclusion_binding(model, configurations)
        self._attach_configurations(configurations, beta)
        self._check_min_image_soundness()
        self._dump_specialized_model(configurations)
        if self.mesh is not None:
            self._shard_batch()

    def _shard_batch(self):
        """Keep this rank's rows of the attached batch: the system, the
        stacked priors of a mixed batch and ``_batch_attrs``. Raises when
        the batch does not divide over the mesh (reference shard_carry,
        mesh.py:120-125)."""
        rows = self.mesh.rows(self.n_sims)
        self._rows = rows
        system = self.initial_system

        def cut(x):
            return None if x is None else x[rows]

        self.initial_system = dataclasses.replace(
            system, pos=system.pos[rows],
            atom_types=(system.atom_types[rows]
                        if system.atom_types.ndim == 2
                        else system.atom_types),
            masses=system.masses[rows], beta=system.beta[rows],
            velocities=cut(system.velocities), cell=cut(system.cell),
            cell_host=cut(system.cell_host), atom_mask=cut(system.atom_mask),
        )
        if self.model.batched_priors:
            self.model = self.model.replace(priors={
                name: p.replace(
                    index_mapping=p.index_mapping[rows],
                    params={k: v[rows] for k, v in p.params.items()},
                    term_mask=cut(p.term_mask))
                for name, p in self.model.priors.items()})
        for name in self._batch_attrs:
            setattr(self, name, getattr(self, name)[rows])

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

    def _dump_specialized_model(self, configurations: List[Configuration]):
        """The attached model (precision and capacity overrides applied,
        Chebyshev fits included) and the configurations next to the
        outputs, readable by the checkpoint_io loaders (reference
        base.py:461-477)."""
        if self.filename is None or not is_io_process():
            return
        from ..models.checkpoint_io import save_specialized_dump

        save_specialized_dump(
            self.model, configurations,
            f"{self.filename}_specialized_model_and_config.pkl",
        )

    def _attach_model(self, model: ForceField):
        if self.gptq is not None and model.schnet_config is not None:
            model = model.replace(schnet_config=dataclasses.replace(
                model.schnet_config, precision="bf16"))
            logger.info(
                "[quantize] SchNet filter/output MLPs set to bf16 "
                "(W16A16 equivalent)"
            )
        if self.neighbor_capacity is not None:
            model = model.replace(neighbor_capacity=self.neighbor_capacity)
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
        self.model = model

    def _attach_configurations(self, configurations, beta):
        ff = self.model
        batched = ff is not None and ff.batched_priors
        if batched or len({c.n_atoms for c in configurations}) > 1:
            if ff is not None and ff.priors and not batched:
                raise ValueError(
                    "Configurations of different sizes need per-molecule "
                    "force fields: pass a LIST of fields to "
                    "attach_model_and_configurations (stacked via "
                    "models.forcefield.stack_forcefields)."
                )
            system = collate_padded(configurations, beta=beta,
                                    device=self.device, dtype=self.dtype)
            if batched and ff.priors:
                s_prior = next(iter(ff.priors.values())).index_mapping.shape[0]
                if s_prior != system.n_sims:
                    raise ValueError(
                        f"The stacked force field carries {s_prior} "
                        f"molecules but {system.n_sims} configurations "
                        "were attached."
                    )
        else:
            system = collate(configurations, beta=beta, device=self.device,
                             dtype=self.dtype)
        self.n_sims = system.n_sims
        self.n_atoms = system.n_atoms
        self.n_dims = system.n_dims
        self.beta = system.beta
        # Blow-up guard scale (reference base.py:557-560).
        self.initial_pos_spread = float(
            max(np.std(np.asarray(c.pos), axis=0).max() for c in configurations)
        )
        if self.checkpointed_state is not None:
            state = self.checkpointed_state
            system.pos = torch.as_tensor(state[POSITIONS_KEY],
                                         dtype=self.dtype, device=self.device)
            system.velocities = torch.as_tensor(
                state[VELOCITY_KEY], dtype=self.dtype, device=self.device)
            self.checkpointed_state = None
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
        system = self.initial_system
        return compute_energy_forces(
            self.model, pos, system.atom_types, carry.get("nbr"),
            cell=system.cell, atom_mask=system.atom_mask, check_cell=False,
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

    def _subroutine_due(self, t: int) -> bool:
        """Whether the device subroutine runs after step ``t`` (0-based)."""
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
            # the whole batch's draw, of which this rank keeps its rows
            shape = (self.n_sims, *self.initial_system.pos.shape[1:])
            xi = torch.randn(shape, generator=gen, device=self.device,
                             dtype=self.dtype)[self._rows]
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
            "pos_spread": self._pos_spread(pos),
        }
        for key in ("nbr_n_max", "nbr_disp_max"):
            if key in carry:
                out[key] = carry[key]
        d_min = self._pair_d_min(pos)
        if d_min is not None:
            out["pair_d_min"] = d_min
        if self.dump_neighbor_list and "nbr" in carry:
            out["nbr_idx"] = carry["nbr"].idx.to(torch.int32)
            out["nbr_mask"] = carry["nbr"].mask
        if self.save_forces:
            out["forces"] = carry["forces"]
        if self.save_energy_components or self.save_force_components:
            out.update(self._component_outputs(carry))
        return out

    def _pos_spread(self, pos) -> torch.Tensor:
        """[S] standard deviation of each molecule's coordinates, the
        blow-up statistic; over the real atoms only in a mixed batch,
        whose far-away padding would dominate it (reference
        _frame_outputs, base.py:730-750)."""
        mask = self.initial_system.atom_mask
        if mask is None:
            return torch.std(pos.reshape(pos.shape[0], -1), dim=1,
                             correction=0)
        w = mask[..., None]
        n = torch.sum(w, dim=(1, 2)) * pos.shape[-1]
        mean = torch.sum(pos * w, dim=(1, 2)) / n
        var = torch.sum(torch.square(pos - mean[:, None, None]) * w,
                        dim=(1, 2)) / n
        return torch.sqrt(var)

    def _pair_d_min(self, pos) -> Optional[torch.Tensor]:
        """The smallest pair distance in the batch, minimum-imaged under
        the system's cells, where the field is cheb with a restricted fit
        domain (cheb_d_min > 0); else None (reference _pair_floor_outputs,
        base.py:767-802, in float32 as there)."""
        cfg = None if self.model is None else self.model.schnet_config
        if (cfg is None or cfg.message_passing != "cheb"
                or cfg.cheb_d_min <= 0.0):
            return None
        from ..ops.neighborlist import _cell_operands, pair_rel

        pos = pos.to(torch.float32)
        cell, inv = _cell_operands(self.initial_system.cell, pos.shape[0],
                                   pos.device)
        rel = pair_rel(pos, cell, inv)
        d2 = torch.sum(rel * rel, dim=-1)
        eye = torch.eye(pos.shape[1], dtype=d2.dtype, device=d2.device)
        return torch.sqrt(torch.min(d2 + eye * 1e12))

    def _component_outputs(self, carry: Dict) -> Dict[str, torch.Tensor]:
        """Energies of the named models and their forces at the save
        point (reference _component_outputs, base.py:804-866): one more
        evaluation of the field, and one autograd pass per force
        component; a list path builds its list afresh at rcut."""
        ff = self.model
        pos = carry["pos"]
        cell = self.initial_system.cell
        nbr = (build_neighbors(ff, pos, cell=cell, check_cell=False)
               if self._uses_neighbor_list() else None)
        cheb = (ff.schnet_params is not None
                and ff.schnet_config.message_passing == "cheb")
        out = {}
        with torch.set_grad_enabled(self.save_force_components):
            p = pos.detach().requires_grad_(self.save_force_components)
            _, comps = total_energy(ff, p, self.initial_system.atom_types,
                                    nbr, cell if cheb else None,
                                    self.initial_system.atom_mask)
            if self.save_energy_components:
                for key in self.energy_components:
                    out[f"energy_component/{key}"] = comps[key].detach()
            if self.save_force_components:
                keys = self.force_components
                for i, key in enumerate(keys):
                    (g,) = torch.autograd.grad(
                        comps[key].sum(), p, retain_graph=i < len(keys) - 1)
                    out[f"force_component/{key}"] = -g
        return out

    def _check_divergence(self, frames: Dict[str, np.ndarray],
                          step_end: int) -> None:
        """Trajectory blow-up guard and the list and fit-domain checks on
        the host frames (reference _check_divergence, base.py:1163-1211)."""
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
    # The host loop (reference base.py:891-1131)
    # ------------------------------------------------------------------

    def _launch_sizes(self) -> List[Tuple[int, bool]]:
        """(frames, ends a segment) of every launch of the run from the
        current export index: segments of ``export_interval`` steps (the
        last may be shorter), each cut into launches of at most
        ``max_steps_per_launch`` steps, whole frames, one at least
        (reference split_frames, :950-1012)."""
        t_init = self.current_timestep * self.export_interval
        remaining = self.n_timesteps - t_init
        segments = [self.export_interval // self.save_interval] * (
            remaining // self.export_interval)
        if remaining % self.export_interval:
            segments.append(remaining % self.export_interval
                            // self.save_interval)
        cap = (None if self.max_steps_per_launch is None
               else max(1, self.max_steps_per_launch // self.save_interval))
        launches = []
        for n_frames in segments:
            take = n_frames if cap is None else cap
            sizes = [min(take, n_frames - i) for i in range(0, n_frames, take)]
            launches += [(n, j == len(sizes) - 1) for j, n in enumerate(sizes)]
        return launches

    def _make_generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device).manual_seed(
            self.random_seed)
        if self._checkpoint_rng_state is not None:
            state = torch.as_tensor(self._checkpoint_rng_state,
                                    dtype=torch.uint8)
            if state.numel() != gen.get_state().numel():
                raise ValueError(
                    f"The checkpoint's rng_state is that of a "
                    f"{state.numel()}-byte generator; a generator on "
                    f"{self.device.type} keeps {gen.get_state().numel()} "
                    "bytes: resume on the device that wrote it."
                )
            gen.set_state(state)
        return gen

    def _restore_carry_extra(self, carry: Dict) -> Dict:
        for name, val in self._checkpoint_carry_extra.items():
            if name in carry:
                carry[name] = torch.as_tensor(val, dtype=carry[name].dtype,
                                              device=self.device)
            else:
                warnings.warn(
                    f"Checkpoint carry entry {name!r} has no match in this "
                    "simulation's carry and was ignored (was the checkpoint "
                    "written by a different simulation type?)",
                    UserWarning,
                )
        return carry

    def _launch(self, carry: Dict, gen: torch.Generator, step: int,
                n_frames: int, halfway_step: int):
        """Enqueue ``n_frames`` save intervals; returns the carry and the
        frames stacked on the device, [n_frames, ...] per key. The
        throughput fence is read at the first save point at or past
        half-way, after a synchronisation of the device."""
        frames = []
        for _ in range(n_frames):
            if self._warmup_end_time is None and step >= halfway_step:
                _synchronize(self.device)
                barrier(self.mesh)
                self._warmup_end_time = time.perf_counter()
                self._steps_at_warmup_end = step
            for _ in range(self.save_interval):
                xi, u = self._step_draws(gen, step)
                carry = self._step_with_hooks(carry, xi, step, u)
                step += 1
            frames.append(self._frame_outputs(carry))
        return carry, self._gather_frames(
            {k: torch.stack([f[k] for f in frames]) for k in frames[0]})

    def _gather_frames(self, frames: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
        """A launch's frames for the whole batch on every rank: the
        per-molecule ones ([n_frames, S, ...]) all-gathered along S, the
        guards' scalars reduced (``_frame_reductions``). Without a mesh,
        the frames as they are."""
        if self.mesh is None:
            return frames
        return {k: (all_reduce(v, self.mesh, self._frame_reductions[k])
                    if v.ndim == 1 else all_gather(v, self.mesh, dim=1))
                for k, v in frames.items()}

    def _is_batch_leaf(self, name: str, x) -> bool:
        """Whether carry entry ``name`` is a per-molecule tensor (leading
        axis this rank's batch)."""
        return (name not in self._replicated_carry
                and isinstance(x, torch.Tensor) and x.ndim >= 1
                and x.shape[0] == self.initial_system.n_sims)

    def _gather_carry(self, carry: Dict) -> Dict:
        """The carry of the whole batch on every rank (reference
        base.py:1124): per-molecule entries all-gathered, the neighbour
        list with a source CSR for the whole batch."""
        if self.mesh is None:
            return carry
        out = {}
        for k, v in carry.items():
            if isinstance(v, NeighborMatrix):
                v = gather_neighbor_matrix(v, self.mesh)
            elif self._is_batch_leaf(k, v):
                v = all_gather(v, self.mesh)
            out[k] = v
        return out

    def _segment_end_state(self, carry: Dict) -> Dict[str, torch.Tensor]:
        """Carry entries fetched with a segment's last launch: those its
        checkpoint writes, under their checkpoint keys."""
        if not (self.create_checkpoints and self.filename is not None):
            return {}
        out = {POSITIONS_KEY: all_gather(carry["pos"], self.mesh),
               VELOCITY_KEY: all_gather(carry["vel"], self.mesh)}
        for name, val in self._checkpoint_extra_state(carry).items():
            out[f"carry__{name}"] = val
        return out

    def _copy_stream(self) -> Optional[torch.cuda.Stream]:
        if self.device.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _host_subroutine(self, carry: Dict, step: int) -> Dict:
        if (self.sim_subroutine is not None
                and not self._has_device_subroutine()
                and step % self.sim_subroutine_interval == 0):
            return self.sim_subroutine(carry)
        return carry

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
        self._set_up_simulation()
        t_init = self.current_timestep * self.export_interval
        if t_init >= self.n_timesteps:
            raise ValueError(
                f"Simulation has already been running for {t_init} steps, "
                f"which is larger than the target number of steps "
                f"{self.n_timesteps}"
            )
        gen = self._make_generator()
        self._warmup_end_time = None
        halfway_step = self.n_timesteps // 2
        # Pipelined unless a host hook that receives the carry may change
        # it between segments: the next launch would not see the change.
        pipeline = ((self.sim_subroutine is None
                     or self._has_device_subroutine())
                    and self.save_subroutine is None)
        stream = self._copy_stream()
        pbar = tqdm(total=self.n_timesteps, initial=t_init,
                    desc="Simulation timestep", mininterval=self.tqdm_refresh)
        parts: List[Dict[str, np.ndarray]] = []
        segments: List[Dict[str, np.ndarray]] = []

        def process(rec: _Launch):
            """Fetch and guard one launch; export at a segment's end."""
            host = rec.copy.result()
            state = {k[len("state/"):]: host.pop(k) for k in list(host)
                     if k.startswith("state/")}
            self._check_divergence(host, rec.step_end)
            parts.append(host)
            pbar.update(rec.n_frames * self.save_interval)
            if not rec.seg_end:
                return
            frames_np = {k: np.concatenate([p[k] for p in parts])
                         for k in parts[0]}
            parts.clear()
            state["rng_state"] = rec.rng_state
            self._export_segment(rec.carry, state, frames_np, rec.step_end)
            frames_np.pop("nbr_idx", None)
            frames_np.pop("nbr_mask", None)
            segments.append(frames_np)
            if self.log_interval is not None:
                self.log(rec.step_end // self.save_interval)

        profiler = None
        step = t_init
        pending = None
        try:
            with torch.no_grad():
                carry = self._restore_carry_extra(
                    self._init_carry(self.initial_system))
                if self.create_checkpoints and t_init == 0:
                    state = HostCopy(self._segment_end_state(carry)).result()
                    state["rng_state"] = gen.get_state().numpy()
                    self._write_checkpoint(state, "init")
                for i, (n_f, seg_end) in enumerate(self._launch_sizes()):
                    if (profiler is None and self.filename is not None
                            and self.profile_start_step is not None
                            and step >= self.profile_start_step
                            and is_io_process()):
                        profiler = self._start_profiler()
                    carry, frames = self._launch(carry, gen, step, n_f,
                                                 halfway_step)
                    step += n_f * self.save_interval
                    # the state of the generator after this launch's draws
                    rng_state = gen.get_state().numpy()
                    if (i == 0 and self.print_shape and self.filename
                            and is_io_process()):
                        self._write_shape_log(carry, frames)
                    if (profiler is not None
                            and self.profile_end_step is not None
                            and step >= self.profile_end_step):
                        self._stop_profiler(profiler)
                        profiler = None
                    if not pipeline and seg_end:
                        # before the export, so that the checkpoint holds
                        # the state after the subroutine
                        carry = self._host_subroutine(carry, step)
                    fetch = dict(frames)
                    if seg_end:
                        fetch.update({f"state/{k}": v for k, v in
                                      self._segment_end_state(carry).items()})
                    rec = _Launch(HostCopy(fetch, stream), carry, step, n_f,
                                  seg_end, rng_state)
                    if not pipeline:
                        process(rec)
                        continue
                    if pending is not None:
                        process(pending)
                    pending = rec
                if pending is not None:
                    process(pending)
                _synchronize(self.device)
                barrier(self.mesh)
                if profiler is not None:
                    self._stop_profiler(profiler)
                    profiler = None
            self._simulation_end_time = time.perf_counter()
            if self._warmup_end_time is None:
                self._warmup_end_time = self._simulation_end_time
                self._steps_at_warmup_end = step
            self._post_warmup_steps = step - self._steps_at_warmup_end
            self.final_carry = self._gather_carry(carry)
            self.simulated_frames = {  # [frames, S, ...] on the host
                k: np.concatenate([s[k] for s in segments])
                for k in segments[0]
            }
            self.simulated_coords = self.simulated_frames["pos"]
            self.simulated_potential = self.simulated_frames["potential"]
            self.simulated_forces = self.simulated_frames.get("forces")
            self.simulated_kinetic_energies = self.simulated_frames.get(
                "kinetic_energy")
            self.summary()
        finally:
            if profiler is not None:  # the run raised inside the window
                self._stop_profiler(profiler)
            pbar.close()
            if self._log_file is not None:
                close_log_file(self._log_file)
        self._simulated = True
        return self.coords

    # ------------------------------------------------------------------
    # Files (reference base.py:1134-1356)
    # ------------------------------------------------------------------

    def _set_up_simulation(self):
        self._log_file = None
        io = is_io_process()
        if self.filename is not None and self.log_type == "write" and io:
            self._log_file = os.path.abspath(f"{self.filename}_log.txt")
        setup_logging(log_file=self._log_file)
        mask = self.initial_system.atom_mask
        if self.filename is not None and mask is not None:
            # a mixed batch's frames are padded to its largest molecule:
            # the [S, A] mask of the real atoms trims them per molecule
            mask = all_gather(mask, self.mesh)
            if io:
                np.save(f"{self.filename}_atom_mask.npy", mask.cpu().numpy())
        if self.log_interval is not None:
            logger.info(
                f"Generating {self.n_sims} simulations of n_timesteps "
                f"{self.n_timesteps} saved at {self.save_interval}-step "
                f"intervals ({time.asctime()})"
            )

    @staticmethod
    def _swap_and_export(arr: np.ndarray) -> np.ndarray:
        """(frames, S, ...) -> (S, frames, ...) (reference :1213-1219)."""
        return np.ascontiguousarray(np.swapaxes(arr, 0, 1))

    def _get_numpy_count(self) -> str:
        return f"{self._npy_file_index:04d}"

    def _export_segment(self, carry: Dict, state: Dict[str, np.ndarray],
                        frames_np: Dict[str, np.ndarray], step_end: int):
        """Write one export segment's files (reference :1224-1295).
        ``state`` is the host copy of the segment-end state that
        ``_segment_end_state`` chose, with the generator's; ``carry`` is
        the segment's last carry on the device, which only a
        ``save_subroutine`` receives (the loop is then synchronous, so
        what it changes reaches the next launch). An override keeps what
        it accumulates across exports on the host."""
        if self.filename is None:
            return
        if is_io_process():
            self._write_segment_files(state, frames_np)
        if self.save_subroutine is not None:
            self.save_subroutine(carry, step_end // self.save_interval)
        self._npy_file_index += 1

    def _write_segment_files(self, state: Dict[str, np.ndarray],
                             frames_np: Dict[str, np.ndarray]):
        """The files of one export segment, on the IO rank."""
        key = self._get_numpy_count()

        def save(name, arr):
            np.save(f"{self.filename}_{name}_{key}.npy",
                    self._swap_and_export(arr))

        def savez(name, prefix):
            np.savez(f"{self.filename}_{name}_{key}.npz", **{
                k[len(prefix):]: self._swap_and_export(v)
                for k, v in frames_np.items() if k.startswith(prefix)})

        save("coords", frames_np["pos"])
        if self.save_forces:
            save("forces", frames_np["forces"])
        if self.save_energies:
            save("potential", frames_np["potential"])
        if self.save_energy_components:
            savez("energy_components", "energy_component/")
        if self.save_force_components:
            savez("force_components", "force_component/")
        if self.dump_neighbor_list and "nbr_idx" in frames_np:
            last_n = self.dump_neighbor_list_last_n
            idx, mask = frames_np["nbr_idx"], frames_np["nbr_mask"]
            if last_n is not None:
                idx, mask = idx[-last_n:], mask[-last_n:]
            np.savez(f"{self.filename}_neighbor_list_{key}.npz", idx=idx,
                     mask=mask)
        self._write_extra_frames(frames_np, key)
        if self.create_checkpoints:
            self._write_checkpoint(state, key, index=self._npy_file_index + 1)

    def _write_extra_frames(self, frames_np: Dict[str, np.ndarray], key: str):
        """Files of the integrators' own frames: the kinetic energy, which
        Langevin, NVE and PT record where the run saves energies
        (reference langevin.py:145-151, velocity_verlet.py:91-97)."""
        if "kinetic_energy" in frames_np:
            np.save(f"{self.filename}_kineticenergy_{key}.npy",
                    self._swap_and_export(frames_np["kinetic_energy"]))

    def _write_shape_log(self, carry: Dict, frames: Dict[str, torch.Tensor]):
        """The shapes and dtypes of the carry and of the first launch's
        frames as found (reference _write_shape_log, :1303-1331, which
        reads them off the traced program)."""
        def entry(x):
            return tuple(x.shape), str(x.dtype).removeprefix("torch.")

        def shapes(tree):
            out = {}
            for k, v in tree.items():
                if isinstance(v, torch.Tensor):
                    out[k] = entry(v)
                elif dataclasses.is_dataclass(v):  # the neighbour list
                    for f in dataclasses.fields(v):
                        x = getattr(v, f.name)
                        if isinstance(x, torch.Tensor):
                            out[f"{k}.{f.name}"] = entry(x)
            return out

        with open(f"{self.filename}_print_shape.log", "w") as f:
            f.write(f"Shape Log - {time.asctime()}\n")
            f.write(
                f"n_sims={self.n_sims} n_atoms={self.n_atoms} "
                f"n_dims={self.n_dims} n_timesteps={self.n_timesteps} "
                f"dt={self.dt} dtype={self.dtype}\n"
            )
            f.write("== scan carry (per-step state) ==\n")
            for k, v in sorted(shapes(carry).items()):
                f.write(f"  {k}: {v}\n")
            f.write("== frame outputs (per save point) ==\n")
            for k, v in sorted(shapes(frames).items()):
                f.write(f"  {k}: {v}\n")

    def _write_checkpoint(self, state: Dict[str, np.ndarray], key: str,
                          index: int = 0):
        """The checkpoint of the reference's layout (:1333-1351), with the
        generator's state under ``rng_state``; on the IO rank."""
        if self.filename is None or not is_io_process():
            return
        out = {
            POSITIONS_KEY: state[POSITIONS_KEY],
            VELOCITY_KEY: state[VELOCITY_KEY],
            "current_timestep": np.asarray(index),
            "export_interval": np.asarray(self.export_interval),
            "save_interval": np.asarray(self.save_interval),
            "log_interval": np.asarray(
                -1 if self.log_interval is None else self.log_interval),
            "rng_state": state["rng_state"],
        }
        out.update({k: v for k, v in state.items()
                    if k.startswith("carry__")})
        np.savez(f"{self.filename}_checkpoint_{key}.npz", **out)

    def _checkpoint_extra_state(self, carry: Dict) -> Dict[str, torch.Tensor]:
        """Integrator-specific carry entries a checkpoint keeps (restored
        by name on resume). Base: none."""
        return {}

    def _start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profiler(self, prof):
        """End the window and write its Chrome trace under
        ``<filename>_trace``."""
        _synchronize(self.device)
        prof.stop()
        trace_dir = f"{self.filename}_trace"
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(trace_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}"
                                    f"_{os.getpid()}.json"))

    # ------------------------------------------------------------------
    # Logging and metrics (reference base.py:1362-1417)
    # ------------------------------------------------------------------

    def log(self, iter_: int):
        logger.info(
            f"{iter_}/{self.n_timesteps // self.save_interval} time points "
            f"saved ({time.asctime()})"
        )

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

    def summary(self):
        potential = self.simulated_potential[-1].astype(np.float64)
        logger.info("=" * 50)
        logger.info(f"Simulation Complete ({time.asctime()})")
        logger.info("-" * 50)
        logger.info(f"Total timesteps: {self.n_timesteps}")
        logger.info(f"dt: {self.dt}")
        if potential.size == 1:
            logger.info(f"Final potential: {float(potential[0]):.6f}")
        else:
            logger.info(f"Mean potential: {potential.mean():.6f} ± "
                        f"{potential.std():.6f}")
            logger.info(f"Min: {potential.min():.6f}, Max: "
                        f"{potential.max():.6f}")
        if self.filename is not None:
            logger.info(f"Output directory: {self.output_dir}")
            logger.info(f"Output prefix: {os.path.basename(self.filename)}")
        logger.info("=" * 50)

    # ------------------------------------------------------------------
    # Results
    # ------------------------------------------------------------------

    @property
    def coords(self) -> np.ndarray:
        """Saved coordinates as (n_sims, frames, atoms, dims)."""
        return self._swap_and_export(self.simulated_coords)

    def reshape_output(self):
        """The saved coordinates, forces and potentials in the reference's
        (n_sims, frames, ...) layout (reference :1423-1434); call it once,
        after ``simulate()``."""
        self.simulated_coords = self.coords
        if self.save_forces:
            self.simulated_forces = self._swap_and_export(
                self.simulated_forces)
        if self.save_energies:
            self.simulated_potential = self._swap_and_export(
                self.simulated_potential)
