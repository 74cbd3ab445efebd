from .base import Simulation  # noqa: F401
from .constants import (  # noqa: F401
    AVOGADRO,
    JPERKCAL,
    KBOLTZMANN,
    calc_beta_from_temperature,
)
from .langevin import (  # noqa: F401
    LangevinSimulation,
    OverdampedSimulation,
    sample_maxwell_boltzmann,
)
from .parallel_tempering import PTSimulation  # noqa: F401
from .velocity_verlet import NVESimulation  # noqa: F401

# Alias matching the reference's private base name for config compatibility.
_Simulation = Simulation
