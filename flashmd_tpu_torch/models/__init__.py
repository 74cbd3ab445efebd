from .cutoff import CosineCutoff, IdentityCutoff, ShiftedCosineCutoff  # noqa: F401
from .forcefield import (  # noqa: F401
    ForceField,
    build_neighbors,
    compute_energy_forces,
    energy_components,
    total_energy,
)
from .mlp import init_mlp, mlp_apply, xavier_uniform  # noqa: F401
from .radial_basis import (  # noqa: F401
    GaussianBasisConfig,
    gaussian_basis_apply,
    init_gaussian_basis,
)
from .schnet import (  # noqa: F401
    SchNetConfig,
    init_schnet,
    schnet_atom_energies,
    schnet_energy,
)
