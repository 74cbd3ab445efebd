"""Command line and YAML configuration of the simulation entry points
(port of flashmd_tpu/simulation/cli.py).

The same surface as the reference's CLI:

* ``--config <yaml>`` with a ``simulation:`` section whose keys are the
  ``Simulation.__init__`` keyword arguments, plus top-level ``betas``,
  ``model_file`` and ``structure_file``;
* ``--simulation.<name> <value>`` overrides, one per keyword argument;
* ``--batch_size`` trims or duplicates the structures;
* the parsed config is echoed to ``<output_dir>/<filename>_config.yaml``;
* ``--disable_optim`` runs the un-optimised baseline (fp32, the exact xla
  message passing, ``gptq=None``);
* the ``MLCG_USE_*``, ``FLASHMD_TPU_MESSAGE_PASSING`` and
  ``FLASHMD_TPU_CHEB_DMIN`` environment flags.

What differs: ``simulation.device`` is an option of the port's
``Simulation`` (default ``"cuda"``), and the model is loaded onto that
device, or onto the mesh's under ``simulation.mesh`` (``auto`` or ``N``;
one process per GPU, launched with ``torchrun --nproc_per_node=N``). The
compile options (``compile``, ``compile_mode``, ``force_compile``,
``compile_model``) are accepted from a YAML file or the command line and
do nothing, as in the JAX package. Model files: a reference
``model_and_prior.pt`` or a native ``.pkl`` of either package; structure
files likewise.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.system import Configuration
from ..models.checkpoint_io import (
    ReferenceModel,
    build_forcefield,
    load_native_configurations,
    load_native_model,
    load_reference_checkpoint,
    load_reference_configurations,
)
from ..models.forcefield import ForceField
from ..parallel.mesh import as_mesh, is_io_process
from ..utils.io import dump_yaml, load_yaml, logger
from .base import Simulation

#: Flags whose value "0" turns the optimisations off, as the reference's
#: per-kernel opt-outs do (reference schnet.py:52-56).
MLCG_FLAGS = (
    "MLCG_USE_TRITON_MESSAGE_PASSING",
    "MLCG_USE_FUSED_RBF",
    "MLCG_USE_FUSED_TANH_LINEAR",
    "MLCG_USE_CSR",
    "MLCG_USE_SRC_CSR_GRAD_X",
)


def _simulation_kwargs(simulation_class) -> Dict[str, inspect.Parameter]:
    """All keyword parameters accepted by the simulation class chain."""
    params: Dict[str, inspect.Parameter] = {}
    for cls in reversed(simulation_class.__mro__):
        if cls is object:
            continue
        for name, p in inspect.signature(cls.__init__).parameters.items():
            if name not in ("self", "args", "kwargs"):
                params[name] = p
    return params


def _coerce(value: str, default: Any, name: str = "option"):
    """A ``--simulation.<name>`` string as a Python value. A value that
    does not parse as a number where the option's default is a number
    raises, rather than reach the simulation as a string."""
    if isinstance(value, str):
        low = value.lower()
        if low in ("none", "null"):
            return None
        if low in ("true", "false"):
            return low == "true"
        if isinstance(default, bool):
            return low in ("1", "true", "yes")
        for cast in (int, float):
            try:
                return cast(value)
            except (TypeError, ValueError):
                continue
        if isinstance(default, (int, float)):
            raise ValueError(
                f"--simulation.{name}={value!r} is not a valid number "
                f"(the option's default is {default!r})."
            )
    return value


def build_parser(
    simulation_class, description: str = "Simulation command line tool"
) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description,
                                     allow_abbrev=False)
    parser.add_argument("--config", type=str, default=None,
                        help="Path to a configuration file in yaml format.")
    parser.add_argument(
        "-tm", "--betas", type=float, nargs="+", default=None,
        help="inverse temperature(s) (1/kBT) at which the simulation runs")
    parser.add_argument(
        "-mf", "--model_file", type=str, default=None,
        help="path to the model file: a reference model_and_prior.pt "
        "checkpoint or a native .pkl force field")
    parser.add_argument(
        "-sf", "--structure_file", type=str, default=None,
        help="path to the starting configurations (.pt or .pkl)")
    parser.add_argument(
        "-p", "--profile", type=str, default="",
        help="Directory for a torch.profiler Chrome trace of the run.")
    parser.add_argument(
        "-bs", "--batch_size", type=int, default=None,
        help="Number of molecules to simulate (trim or duplicate the "
        "structure file to this count).")
    parser.add_argument(
        "--disable_optim", action="store_true",
        help="Run the un-optimized baseline path (fp32 MLPs, the exact xla "
        "message passing, no CUDA kernel) for A/B comparison.")
    parser.add_argument(
        "--allow_unconvertible", action="store_true",
        help="Skip (with a warning) checkpoint entries that cannot be "
        "converted and priors whose neighbor lists are missing from the "
        "structure file, instead of erroring. Skipping changes the "
        "simulated physics — only use when you know what you are dropping.")
    for name in _simulation_kwargs(simulation_class):
        parser.add_argument(f"--simulation.{name}",
                            dest=f"simulation.{name}", default=None)
    return parser


def apply_batch_size(
    initial_data_list: List[Configuration], batch_size: Optional[int]
) -> List[Configuration]:
    """Trim or duplicate configurations (reference cli.py:131-158)."""
    if batch_size is None:
        return initial_data_list
    native_count = len(initial_data_list)
    if batch_size <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    if batch_size < native_count:
        logger.info(f"Using {batch_size} of {native_count} native molecules")
        return initial_data_list[:batch_size]
    if batch_size > native_count:
        full_copies, remainder = divmod(batch_size, native_count)
        expanded = []
        for _ in range(full_copies):
            expanded.extend(deepcopy(d) for d in initial_data_list)
        expanded.extend(
            deepcopy(initial_data_list[i]) for i in range(remainder))
        logger.info(
            f"Expanded {native_count} native molecules to {batch_size} "
            f"({full_copies} full copies + {remainder} extra)")
        return expanded
    logger.info(f"Using all {native_count} native molecules")
    return initial_data_list


def load_model_file(path: str, allow_unconvertible: bool = False,
                    device="cuda"):
    """A reference ``model_and_prior.pt`` as a ReferenceModel (numpy; bound
    to a molecule later), or a native ``.pkl`` of either package as a
    ForceField on ``device`` (or a ReferenceModel)."""
    if path.endswith(".pt"):
        return load_reference_checkpoint(
            path, allow_unconvertible=allow_unconvertible)
    return load_native_model(path, device=device)


def load_structure_file(path: str) -> List[Configuration]:
    if path.endswith(".pt"):
        return load_reference_configurations(path)
    return load_native_configurations(path)


def _auto_cheb_d_min(configs: List[Configuration], rcut: float) -> float:
    """Fit-domain floor = 0.7 x the min pair distance over the structures.

    0.7 is the measured dynamic dip of the headline system (a 5000-step x
    128-molecule trajectory bottoms out at 0.73 of its initial minimum);
    the engine warns where a simulation undercuts the floor. Distances are
    raw euclidean, so periodic structures are refused; the floor must land
    in [0, rcut).
    """
    d2_min = np.inf
    for c in configs:
        if getattr(c, "cell", None) is not None:
            raise ValueError(
                "FLASHMD_TPU_CHEB_DMIN=auto uses raw euclidean pair "
                "distances and cannot derive a sound floor for periodic "
                "structures (the closest minimum-image pair may cross "
                "the boundary). Pass an explicit distance instead."
            )
        pos = np.asarray(c.pos, dtype=np.float64)
        # |p_i - p_j|^2 via the Gram trick: O(A^2) memory, no [A, A, 3].
        sq = np.sum(pos * pos, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
        np.fill_diagonal(d2, np.inf)
        d2_min = min(d2_min, float(d2.min()))
    if not np.isfinite(d2_min):
        raise ValueError(
            "FLASHMD_TPU_CHEB_DMIN=auto needs at least one structure "
            "with >= 2 atoms to derive the fit-domain floor."
        )
    d_min = round(0.7 * float(np.sqrt(max(d2_min, 0.0))), 2)
    if d_min >= rcut:
        raise ValueError(
            f"FLASHMD_TPU_CHEB_DMIN=auto derived {d_min} A, which is not "
            f"below the model cutoff {rcut} A — the structures' minimum "
            "pair distance is too large for a restricted-domain fit to "
            "make sense. Pass an explicit distance or unset the flag."
        )
    return d_min


def _warn_unknown(options: Dict[str, Any], known) -> None:
    unknown = set(options) - set(known)
    if not unknown:
        return
    logger.warning(f"Ignoring unknown simulation options: {unknown}")


def parse_simulation_config(
    simulation_class,
    description: str = "Simulation command line tool",
    args=None,
) -> Tuple[ForceField, List[Configuration], Any, Simulation, str]:
    """Parse config + CLI and instantiate everything: (model,
    initial_data_list, betas, simulation, profile), the reference's tuple
    (reference cli.py:22-167)."""
    parser = build_parser(simulation_class, description)
    ns = parser.parse_args(args=args)

    config: Dict[str, Any] = {"simulation": {}}
    if ns.config:
        config.update(load_yaml(ns.config) or {})
        config.setdefault("simulation", {})

    sim_params = _simulation_kwargs(simulation_class)
    for name, p in sim_params.items():
        cli_val = getattr(ns, f"simulation.{name}", None)
        if cli_val is not None:
            default = (p.default if p.default is not inspect.Parameter.empty
                       else None)
            config["simulation"][name] = _coerce(cli_val, default, name)

    for key in ("betas", "model_file", "structure_file", "batch_size"):
        val = getattr(ns, key)
        if val is not None:
            config[key] = val
    config["profile"] = ns.profile

    sim_kwargs = {k: v for k, v in config["simulation"].items()
                  if k in sim_params}
    _warn_unknown(config["simulation"], sim_kwargs)
    if ns.disable_optim:
        # a keyword, not os.environ: the opt-out must not leak into a later
        # parse in the same process
        sim_kwargs["gptq"] = None
    # `mesh: auto` shards the batch over every rank of the process group
    # (joined here from torchrun's environment), `mesh: N` over the first N
    # ranks; a ReplicaMesh passes through (reference cli.py:415-427)
    sim_kwargs["mesh"] = as_mesh(sim_kwargs.get("mesh"))
    device = sim_kwargs.get("device", sim_params["device"].default)
    if sim_kwargs["mesh"] is not None:
        device = sim_kwargs["mesh"].device

    out_name = sim_kwargs.get("filename")
    if out_name is not None and is_io_process():
        output_dir = sim_kwargs.get("output_dir", "./outputs")
        os.makedirs(output_dir, exist_ok=True)
        dump_yaml(os.path.join(output_dir, f"{out_name}_config.yaml"),
                  {k: v for k, v in config.items() if k != "config"})

    model = load_model_file(str(config["model_file"]),
                            allow_unconvertible=ns.allow_unconvertible,
                            device=device)
    # the unique structures, for what needs no batch_size duplicates
    raw_data_list = load_structure_file(str(config["structure_file"]))
    initial_data_list = apply_batch_size(raw_data_list,
                                         config.get("batch_size"))

    # A reference checkpoint binds to the loaded molecule here, in the
    # reference's attach order (model, structures, binding). optimize=True
    # takes the cheb bf16 path with its measured frontier where eligible.
    if isinstance(model, ReferenceModel):
        if not initial_data_list:
            raise ValueError(
                "structure_file contains no configurations; cannot bind "
                "the reference checkpoint to a molecule.")
        model = build_forcefield(
            model, initial_data_list[0],
            optimize=not ns.disable_optim,
            allow_missing_priors=ns.allow_unconvertible,
            tune_configurations=raw_data_list,
            device=device,
        )

    env_disable = any(os.environ.get(k) == "0" for k in MLCG_FLAGS)
    mp_override = os.environ.get("FLASHMD_TPU_MESSAGE_PASSING")
    if isinstance(model, ForceField) and model.schnet_config is not None:
        if ns.disable_optim or env_disable:
            model = _disable_optimizations(model)
        elif mp_override:
            model = model.replace(schnet_config=dataclasses.replace(
                model.schnet_config, message_passing=mp_override))
        dmin_override = os.environ.get("FLASHMD_TPU_CHEB_DMIN")
        if dmin_override and not (ns.disable_optim or env_disable):
            model = _with_cheb_d_min(model, dmin_override, raw_data_list)

    simulation = simulation_class(**sim_kwargs)
    betas = config.get("betas")
    if isinstance(betas, (list, tuple)) and len(betas) == 1:
        betas = float(betas[0])
    return model, initial_data_list, betas, simulation, config["profile"]


def _with_cheb_d_min(model: ForceField, value: str,
                     structures: List[Configuration]) -> ForceField:
    """The opt-in fit domain [d_min, rcut] (``FLASHMD_TPU_CHEB_DMIN``: a
    distance, or ``auto`` for :func:`_auto_cheb_d_min`). A fit already in
    the parameters (a reloaded specialized dump) belongs to the old domain
    and is dropped, so that attach fits again."""
    rcut = float(model.schnet_config.cutoff.cutoff_upper)
    if value.strip().lower() == "auto":
        d_min = _auto_cheb_d_min(structures, rcut)
        logger.info(
            "FLASHMD_TPU_CHEB_DMIN=auto: Chebyshev fit-domain "
            f"floor {d_min} A (0.7 x the initial structures' min "
            "pair distance; the engine warns if the dynamics "
            "undercut it)")
    else:
        d_min = float(value)
    model = model.replace(schnet_config=dataclasses.replace(
        model.schnet_config, cheb_d_min=d_min))
    if model.schnet_params is not None and "cheb_fit" in model.schnet_params:
        params = dict(model.schnet_params)
        params.pop("cheb_fit")
        model = model.replace(schnet_params=params)
    return model


def _disable_optimizations(model: ForceField) -> ForceField:
    """Baseline A/B path: fp32 MLPs + the exact xla message passing."""
    return model.replace(schnet_config=dataclasses.replace(
        model.schnet_config, precision="fp32", message_passing="xla"))
