"""String key registry for system fields and model outputs (a copy of
flashmd_tpu/data/keys.py:12-41). The values are the reference's strings,
so that configs, output files and checkpoints of both packages share one
layout."""

from typing import Final, List

POSITIONS_KEY: Final[str] = "pos"
N_ATOMS_KEY: Final[str] = "n_atoms"
MASS_KEY: Final[str] = "masses"
NEIGHBOR_LIST_KEY: Final[str] = "neighbor_list"
TAG_KEY: Final[str] = "tag"

DIRECTION_VECTORS_KEY: Final[str] = "direction_vectors"
DISTANCES_KEY: Final[str] = "distances"
EDGE_ATTRS_KEY: Final[str] = "edge_attrs"
EDGE_EMBEDDING_KEY: Final[str] = "edge_embedding"
CELL_KEY: Final[str] = "cell"
PBC_KEY: Final[str] = "pbc"

NODE_FEATURES_KEY: Final[str] = "node_features"
NODE_ATTRS_KEY: Final[str] = "node_attrs"
ATOM_TYPE_KEY: Final[str] = "atom_types"

ENERGY_KEY: Final[str] = "energy"
FORCE_KEY: Final[str] = "forces"
VELOCITY_KEY: Final[str] = "velocities"

PROPERTY_KEYS: Final[List[str]] = [ENERGY_KEY, FORCE_KEY]

BATCH_KEY: Final[str] = "batch"

ALLOWED_KEYS: List[str] = [
    v for k, v in list(globals().items()) if k.endswith("_KEY")
]

SCALAR_KEYS = [ENERGY_KEY]
