"""Console entry points: flashmd-torch-langevin / flashmd-torch-pt-langevin /
flashmd-torch-nve-verlet (port of flashmd_tpu/simulation/scripts.py).

Parse the config, attach model and configurations, run the simulation
(optionally inside a ``torch.profiler`` window) and report the second-half
throughput and the peak device memory. The kernels build once into
``flashmd_tpu_torch/_build/``, so there is no compilation cache to set up.
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..utils.io import logger, setup_logging
from .base import _synchronize
from .cli import parse_simulation_config
from .langevin import LangevinSimulation
from .parallel_tempering import PTSimulation
from .velocity_verlet import NVESimulation


@contextlib.contextmanager
def _maybe_profile(simulation, profile_dir: str):
    """A torch.profiler window over the run whose Chrome trace goes into
    ``profile_dir`` (the reference's ``--profile``)."""
    if not profile_dir:
        yield
        return
    prof = simulation._start_profiler()
    try:
        yield
    finally:
        _synchronize(simulation.device)
        prof.stop()
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(profile_dir, f"trace_{os.getpid()}.json"))


def _report(simulation):
    """Throughput and memory report (reference nvt_langevin.py:129-177)."""
    metrics = simulation.get_throughput_metrics()
    if metrics is None:
        return
    logger.info("=" * 50)
    logger.info("Throughput (second half of simulation):")
    logger.info(f"  steps: {metrics['second_half_steps']} x "
                f"{metrics['n_sims']} molecules")
    logger.info(f"  elapsed: {metrics['second_half_elapsed_time']:.3f} s")
    logger.info(f"  throughput: {metrics['throughput']:.1f} timestep*mol/s")
    logger.info(f"  ms/timestep: {metrics['ms_per_timestep']:.3f}")
    device = simulation.device
    if device.type == "cuda":
        logger.info(
            f"  peak device memory [{torch.cuda.get_device_name(device)}]: "
            f"{torch.cuda.max_memory_allocated(device) / 1024 ** 3:.2f} GiB")
    logger.info("=" * 50)


def _run(simulation_class, description: str, betas_are_list: bool = False):
    setup_logging()
    model, data_list, betas, simulation, profile = parse_simulation_config(
        simulation_class, description)
    if betas_are_list and not isinstance(betas, (list, tuple)):
        betas = [betas]
    simulation.attach_model_and_configurations(model, data_list, betas)
    with _maybe_profile(simulation, profile):
        simulation.simulate()
    _report(simulation)
    return simulation


def nvt_langevin_main():
    return _run(LangevinSimulation, "NVT Langevin (BAOAB) simulation")


def nvt_pt_langevin_main():
    return _run(PTSimulation, "Parallel-tempering Langevin simulation",
                betas_are_list=True)


def nve_verlet_main():
    return _run(NVESimulation, "NVE velocity-Verlet simulation")


# Console-script wrappers: the ``*_main`` functions return the Simulation
# for programmatic use, but an entry point calls ``sys.exit(main())``, and
# a truthy return would exit 1 after a successful run.
def nvt_langevin_cli() -> None:
    nvt_langevin_main()


def nvt_pt_langevin_cli() -> None:
    nvt_pt_langevin_main()


def nve_verlet_cli() -> None:
    nve_verlet_main()


if __name__ == "__main__":  # pragma: no cover
    nvt_langevin_main()
