"""Synthetic flagship model (port of flashmd_tpu/models/zoo.py).

``random_cg_protein`` and ``_chain_priors`` are the reference's numpy code,
copied, so both packages build the same structure and priors from a seed.
The SchNet weights come from a seeded ``torch.Generator``: same shapes and
distributions as the reference, not the same numbers (use
``models.convert.forcefield_from_numpy`` to carry JAX weights across).
"""

from __future__ import annotations

import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..data.system import Configuration, make_term_list
from ..ops.neighborlist import max_neighbor_count, suggest_capacity
from ..prior.priors import Prior, densify_repulsion
from .cutoff import CosineCutoff
from .forcefield import ForceField
from .schnet import SchNetConfig, init_schnet


def random_cg_protein(
    n_atoms: int = 266,
    n_types: int = 25,
    bond_length: float = 3.8,
    confinement_radius: float = 22.0,
    min_separation: float = 3.0,
    seed: int = 0,
) -> Configuration:
    """A collapsed self-avoiding random-walk CG chain, 1ENH-like in size
    and density (reference zoo.py:31-96)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((n_atoms, 3))
    p = np.zeros(3)
    for i in range(1, n_atoms):
        best, best_clear = None, -np.inf
        for _ in range(50):
            step = rng.normal(size=3)
            step *= bond_length / np.linalg.norm(step)
            cand = p + step
            r = np.linalg.norm(cand)
            if r > confinement_radius:
                cand *= confinement_radius / r
            clear = np.min(np.linalg.norm(pos[:i] - cand, axis=1))
            if clear > best_clear:
                best, best_clear = cand, clear
            if clear >= min_separation:
                break
        p = best
        pos[i] = p
    types = rng.integers(0, n_types, size=n_atoms)
    masses = rng.uniform(50.0, 150.0, size=n_atoms) / 418.4

    idx = np.arange(n_atoms)
    bonds = np.stack([idx[:-1], idx[1:]])
    angles = np.stack([idx[:-2], idx[1:-1], idx[2:]])
    dihedrals = np.stack([idx[:-3], idx[1:-2], idx[2:-1], idx[3:]])
    ii, jj = np.triu_indices(n_atoms, k=2)
    repulsion = np.stack([ii, jj])

    return Configuration(
        pos=pos,
        atom_types=types,
        masses=masses,
        neighbor_lists={
            "bonds": make_term_list(bonds, tag="bonds", order=2),
            "angles": make_term_list(angles, tag="angles", order=3),
            "dihedrals": make_term_list(dihedrals, tag="dihedrals", order=4),
            "repulsion": make_term_list(repulsion, tag="repulsion", order=2),
        },
        tag="random_cg_protein",
    )


def _chain_priors(cfg: Configuration, seed: int, device):
    """Prior parameters for the synthetic chain (reference zoo.py:99-161)."""
    rng = np.random.default_rng(seed + 1)
    nl = cfg.neighbor_lists

    def mk(name, kind, feature, params):
        return Prior(
            index_mapping=torch.as_tensor(
                nl[name].index_mapping, dtype=torch.int64, device=device
            ),
            params={
                k: torch.as_tensor(
                    np.asarray(v, np.float32), dtype=torch.float32,
                    device=device,
                )
                for k, v in params.items()
            },
            kind=kind,
            name=name,
            feature=feature,
        )

    nb = nl["bonds"].n_terms
    na = nl["angles"].n_terms
    nd = nl["dihedrals"].n_terms
    nr = nl["repulsion"].n_terms
    priors = {
        "bonds": mk(
            "bonds", "harmonic_bonds", "distance",
            {"x0": np.full(nb, 3.8), "k": rng.uniform(40.0, 80.0, nb)},
        ),
        "angles": mk(
            "angles", "harmonic_angles", "angle_cos",
            {
                "x0": rng.uniform(-0.4, 0.0, na),
                "k": rng.uniform(5.0, 15.0, na),
            },
        ),
        "dihedrals": mk(
            "dihedrals", "dihedral", "torsion",
            {
                "k1s": rng.uniform(-0.5, 0.5, (nd, 3)),
                "k2s": rng.uniform(-0.5, 0.5, (nd, 3)),
                "v_0": np.zeros((nd, 1)),
            },
        ),
        "repulsion": mk(
            "repulsion", "repulsion", "distance",
            {"sigma": np.full(nr, 3.0)},
        ),
    }
    priors["repulsion"] = densify_repulsion(priors["repulsion"], cfg.n_atoms)
    return priors


def default_cheb_orders(n_atoms, precision, cheb_order=None,
                        cheb_order_deriv=None, cheb_d_min=None):
    """(order, order_deriv, d_min) as the reference zoo picks them
    (zoo.py:234-269). All-default bf16 takes (48, 64) on d_min = 2.0 for
    A <= 266 and (64, 64) above; bf16x3 takes its own (64, 96) on d_min =
    2.0 at every size; fp32 the full symmetric 128 on the full domain. An
    explicit order, either one, opts out of all coupled defaults: the other
    order becomes 64 (bf16), 96 (bf16x3 given the derivative order) or 128
    (fp32), or stays symmetric, and d_min 0.0."""
    bf16 = precision.startswith("bf16")
    x3 = precision == "bf16x3"
    if cheb_order is not None:
        order = cheb_order
    elif x3:
        order = 64 if cheb_order_deriv is None else 96
    elif bf16:
        order = 64 if cheb_order_deriv is not None or n_atoms > 266 else 48
    else:
        order = 128
    if cheb_order_deriv is not None:
        deriv = cheb_order_deriv
    elif cheb_order is None and bf16:
        deriv = 96 if x3 else 64
    else:
        deriv = None
    if cheb_d_min is None:
        explicit = cheb_order is not None or cheb_order_deriv is not None
        d_min = 2.0 if (not explicit and bf16) else 0.0
    else:
        d_min = cheb_d_min
    return order, deriv, d_min


def warn_past_frontier(n_atoms, precision, cheb_order=None,
                       cheb_order_deriv=None):
    """The reference's size warning (zoo.py:272-294): the default orders of
    the 16-bit tiers were measured up to 266 beads for bf16x3 and 532 for
    bf16; past that, without explicit orders, warn."""
    frontier = 266 if precision == "bf16x3" else 532
    if (cheb_order is None and cheb_order_deriv is None
            and precision.startswith("bf16") and n_atoms > frontier):
        warnings.warn(
            f"n_atoms={n_atoms} is past the measured fidelity frontier "
            f"(A={frontier} for precision={precision!r}): the 16-bit "
            "accumulation error of the Chebyshev path grows with the "
            "molecule size and the default orders were validated only up "
            f"to {frontier} beads. Measure the force error vs "
            "precision='fp32' or pass explicit cheb_order/cheb_order_deriv.",
            stacklevel=3,
        )


def cgschnet_1enh_like(
    n_atoms: int = 266,
    batch_size: int = 128,
    cutoff_upper: float = 10.0,
    num_interactions: int = 3,
    precision: str = "bf16",
    neighbor_capacity: Optional[int] = None,
    message_passing: str = "xla",
    seed: int = 0,
    cheb_order: Optional[int] = None,
    cheb_order_deriv: Optional[int] = None,
    cheb_d_min: Optional[float] = None,
    cheb_fit_method: Optional[str] = None,
    device: torch.device | str = "cuda",
) -> Tuple[ForceField, List[Configuration]]:
    """CGSchNet at 1ENH scale + chain priors (reference zoo.py:164-329):
    hidden 128, filters 128, 50 RBF, embedding 100, head [128, 128, 64, 1].

    ``message_passing`` takes the reference's four paths: "xla", the
    default as in the reference (the exact path that parameter gradients,
    pair exclusions and small periodic cells need), "cheb" (the Chebyshev
    kernels: name it to run them), "dense" and "pallas". All draw the same
    weights from the same
    seed; only the config differs. The arguments bind positionally as the
    reference's do, ``device`` last. ``cheb_fit_method`` ("proj" when None,
    "wls" or "lawson") chooses the host fit made at attach. Without an
    explicit ``neighbor_capacity`` the reference's rule sizes it: the max
    neighbour count at rcut + 1.0 (the default Verlet skin) x 1.35, aligned
    to 8, at most ``n_atoms``. The tensors are placed on the card unless
    ``device`` says otherwise. Past the measured fidelity frontier of the
    default orders (266 beads at bf16x3, 532 at bf16) it warns, as the
    reference does.
    """
    base = random_cg_protein(n_atoms=n_atoms, seed=seed)
    order, deriv, d_min = default_cheb_orders(
        n_atoms, precision, cheb_order, cheb_order_deriv, cheb_d_min
    )
    warn_past_frontier(n_atoms, precision, cheb_order, cheb_order_deriv)
    config = SchNetConfig(
        hidden_channels=128,
        embedding_size=100,
        num_filters=128,
        num_interactions=num_interactions,
        num_rbf=50,
        cutoff=CosineCutoff(0.0, cutoff_upper),
        output_hidden_layer_widths=(128, 64),
        precision=precision,
        message_passing=message_passing,
        cheb_order=order,
        cheb_order_deriv=deriv,
        cheb_d_min=d_min,
        cheb_fit_method=cheb_fit_method or "proj",
    )
    if neighbor_capacity is None:
        neighbor_capacity = min(
            suggest_capacity(
                max_neighbor_count(base.pos, cutoff_upper + 1.0), slack=1.35
            ),
            n_atoms,
        )
    gen = torch.Generator().manual_seed(seed)
    ff = ForceField(
        schnet_params=init_schnet(config, gen, device),
        priors=_chain_priors(base, seed, device),
        schnet_config=config,
        neighbor_capacity=neighbor_capacity,
    )
    rng = np.random.default_rng(seed + 7)
    configurations = [
        Configuration(
            pos=base.pos + rng.normal(scale=0.05, size=base.pos.shape),
            atom_types=base.atom_types,
            masses=base.masses,
            neighbor_lists=base.neighbor_lists,
            tag=base.tag,
        )
        for _ in range(batch_size)
    ]
    return ff, configurations
