"""PyTorch + CUDA port of flashmd_tpu for NVIDIA Hopper (H100).

The JAX package ``flashmd_tpu`` is the reference; this package keeps its
module paths and function names wherever a reader looks for a
counterpart, and exports the names of its package root here, with the
integrators beside them. It imports ``torch`` and never ``jax``.

Matmul precision is stated and set here, once: TF32 is not a tier the
reference has, so float32 matrix products and convolutions run in full
float32 on the card.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from .data.keys import (  # noqa: E402,F401
    ATOM_TYPE_KEY,
    ENERGY_KEY,
    FORCE_KEY,
    MASS_KEY,
    POSITIONS_KEY,
    VELOCITY_KEY,
)
from .data.system import (  # noqa: E402,F401
    Configuration,
    System,
    TermList,
    collate,
    make_term_list,
    validate_term_list,
)
from .models.cutoff import (  # noqa: E402,F401
    CosineCutoff,
    IdentityCutoff,
    ShiftedCosineCutoff,
)
from .models.forcefield import (  # noqa: E402,F401
    ForceField,
    compute_energy_forces,
    total_energy,
)
from .models.radial_basis import (  # noqa: E402,F401
    GaussianBasisConfig,
    gaussian_basis_apply,
    init_gaussian_basis,
)
from .models.schnet import (  # noqa: E402,F401
    SchNetConfig,
    init_schnet,
    schnet_energy,
)
from .prior.priors import Prior, prior_energy  # noqa: E402,F401
from .simulation import (  # noqa: E402,F401
    LangevinSimulation,
    NVESimulation,
    OverdampedSimulation,
    PTSimulation,
    Simulation,
)
