from .priors import (  # noqa: F401
    Prior,
    dihedral_prior,
    fourier_compute,
    gather_type_params,
    harmonic_compute,
    harmonic_prior,
    polynomial_compute,
    polynomial_prior,
    prior_energy,
    repulsion_compute,
    repulsion_prior,
    restricted_quartic_compute,
    restricted_quartic_prior,
)
from .sparsify import (  # noqa: F401
    sparse_to_table,
    sparsify_repulsion,
    table_to_sparse,
)
from .fitting import (  # noqa: F401
    fit_fourier_from_potential_estimates,
    fit_harmonic_from_potential_estimates,
    fit_repulsion_from_potential_estimates,
    fit_repulsion_from_values,
)
