from .geometry import (  # noqa: F401
    compute_angles_cos,
    compute_angles_raw,
    compute_distance_vectors,
    compute_distances,
    compute_torsions,
    safe_norm,
    safe_normalization,
)
from .neighborlist import (  # noqa: F401
    EdgeList,
    NeighborMatrix,
    batched_radius_neighbor_matrix,
    neighbor_matrix_to_edges,
    radius_neighbor_matrix,
    configuration2term_list,
    suggest_capacity,
    wrap_positions,
)
