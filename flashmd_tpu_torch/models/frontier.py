"""Measured fidelity frontier for ingested checkpoints (port of
flashmd_tpu/models/frontier.py).

At conversion time, on the Chebyshev path:

1. the fit-domain floor ``d_min`` is 0.7 x the structures' minimum pair
   distance (0 on periodic or degenerate structures, as in the
   reference);
2. the cheapest ``(cheb_order, cheb_order_deriv)`` of ``CANDIDATES`` is
   kept whose max relative SchNet force error against the exact fp32 xla
   oracle stays within ``budget_factor`` (1.2) x the bf16 floor, the
   error of the bf16 xla path on the same structures.

One host fit at ``MAX_ORDER`` serves every candidate: each zeroes the
tail of that fit, which adds exactly nothing, so a truncated fit is the
lower-order fit. The oracle and floor run on the port's xla path; the
candidates on its cheb path, the CUDA kernels on the card and their
plain twins on the CPU. All of it runs once, at conversion, never in the
step loop. ``FLASHMD_TPU_AUTOFRONTIER=0`` keeps the full-domain fallback.

The measurement is logged at INFO on this module's logger; the record
carries it as ``record.frontier`` (a :class:`FrontierReport`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

# Ascending kernel cost (about 5 M1 + 3 M2 order products per step at
# three blocks); the last is the full-domain-safe ceiling.
CANDIDATES: Tuple[Tuple[int, int], ...] = (
    (48, 64),
    (48, 72),
    (64, 64),
    (64, 72),
    (64, 96),
    (96, 96),
)
FULL_DOMAIN_FALLBACK: Tuple[int, int] = (64, 96)
MAX_ORDER = max(max(m1, m2) for m1, m2 in CANDIDATES)


@dataclasses.dataclass
class FrontierReport:
    """What one selection measured: the structures, the fit-domain floor,
    the bf16 floor and budget (relative to max|F_fp32|), each evaluated
    candidate's error in order, and the orders kept (None: fallback)."""

    n_structures: int
    d_min: float
    floor: float
    budget: float
    errors: Dict[Tuple[int, int], float]
    chosen: Optional[Tuple[int, int]]


def autofrontier_enabled() -> bool:
    return os.environ.get("FLASHMD_TPU_AUTOFRONTIER", "1").strip().lower() \
        not in ("0", "off", "false", "none")


def derive_d_min(configurations: Sequence, rcut: float) -> float:
    """0.7 x the minimum pair distance of the structures, rounded to 0.01,
    or 0.0 (the full domain) for periodic or degenerate structures and a
    floor that would reach the cutoff (reference frontier.py:62-90)."""
    d2_min = np.inf
    for c in configurations:
        if getattr(c, "cell", None) is not None:
            return 0.0
        pos = np.asarray(c.pos, dtype=np.float64)
        if pos.shape[0] < 2:
            continue
        sq = np.sum(pos * pos, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (pos @ pos.T)
        np.fill_diagonal(d2, np.inf)
        d2_min = min(d2_min, float(d2.min()))
    if not np.isfinite(d2_min):
        return 0.0
    d_min = round(0.7 * float(np.sqrt(max(d2_min, 0.0))), 2)
    if not 0.0 < d_min < rcut:
        return 0.0
    return d_min


def _stack_positions(configurations: Sequence, max_structs: int, device):
    """[S, A, 3] float32 positions of the first ``max_structs``
    structures, or None when their sizes differ."""
    shapes = {tuple(np.asarray(c.pos).shape) for c in configurations}
    if len(shapes) != 1:
        return None
    pos = np.stack([np.asarray(c.pos, np.float64)
                    for c in configurations[:max_structs]])
    return torch.as_tensor(pos, dtype=torch.float32, device=device)


def _schnet_forces(params, config, pos_batch, types):
    """[S, A, 3] forces of the SchNet term alone: the priors do not depend
    on the tier, so they would only dilute the error ratio."""
    from .forcefield import ForceField, compute_energy_forces

    ff = ForceField(schnet_params=params, priors={}, schnet_config=config,
                    neighbor_capacity=int(pos_batch.shape[1]))
    return compute_energy_forces(ff, pos_batch, types)[1]


def _truncated_fits(fits, m1: int, m2: int):
    """Each block's fit with the orders from ``m1`` (forward) and ``m2``
    (derivative) on zeroed; w0 = 4 sum_m (-1)^m c[m] of the truncated
    series, in float32 (reference frontier.py:118-126)."""
    out = []
    for c, c2, w0 in fits:
        ct = torch.where((torch.arange(c.shape[0], device=c.device)
                          < m1)[:, None], c, torch.zeros_like(c))
        c2t = torch.where((torch.arange(c2.shape[0], device=c2.device)
                           < m2)[:, None], c2, torch.zeros_like(c2))
        signs = torch.ones(c.shape[0], dtype=c.dtype, device=c.device)
        signs[1::2] = -1.0
        out.append((ct, c2t, 4.0 * (signs @ ct)))
    return tuple(out)


def _max_rel(f, f_ref, scale: float) -> float:
    return float((f - f_ref).abs().max()) / scale


def select_cheb_frontier(schnet_params, config, configurations: Sequence,
                         budget_factor: float = 1.2, max_structs: int = 4):
    """(cheb_order, cheb_order_deriv, cheb_d_min) by measurement on up to
    ``max_structs`` structures (reference frontier.py:129-217).

    ``config`` is the optimised cheb/bf16 config (eligibility checked by
    the caller). Returns the config with the orders and floor chosen, or
    with the full-domain fallback where nothing can be measured or no
    candidate meets the budget."""
    fallback = dataclasses.replace(
        config, cheb_order=FULL_DOMAIN_FALLBACK[0],
        cheb_order_deriv=FULL_DOMAIN_FALLBACK[1], cheb_d_min=0.0,
    )
    if not configurations:
        return fallback
    device = schnet_params["embedding"].device
    pos_batch = _stack_positions(configurations, max_structs, device)
    if pos_batch is None:
        logger.info("[frontier] mixed structure sizes; keeping the "
                    f"full-domain {FULL_DOMAIN_FALLBACK} default.")
        return fallback
    types = torch.as_tensor(np.asarray(configurations[0].atom_types),
                            dtype=torch.int64, device=device)
    rcut = float(config.cutoff.cutoff_upper)
    d_min = derive_d_min(configurations, rcut)

    # the oracle and the floor on the exact-MLP gather path
    cfg_fp32 = dataclasses.replace(config, precision="fp32",
                                   message_passing="xla")
    cfg_bf16 = dataclasses.replace(cfg_fp32, precision="bf16")
    f_ref = _schnet_forces(schnet_params, cfg_fp32, pos_batch, types)
    scale = float(f_ref.abs().max())
    if not np.isfinite(scale) or scale == 0.0:
        return fallback
    floor = _max_rel(_schnet_forces(schnet_params, cfg_bf16, pos_batch,
                                    types), f_ref, scale)
    budget = budget_factor * max(floor, 1e-6)

    from .cheb import attach_cheb_fit

    cfg_fit = dataclasses.replace(config, cheb_order=MAX_ORDER,
                                  cheb_order_deriv=MAX_ORDER,
                                  cheb_d_min=d_min)
    params_fit = attach_cheb_fit(schnet_params, cfg_fit)
    fits = params_fit["cheb_fit"]

    errors: Dict[Tuple[int, int], float] = {}
    chosen = None
    for m1, m2 in CANDIDATES:
        p_t = {**params_fit, "cheb_fit": _truncated_fits(fits, m1, m2)}
        err = _max_rel(_schnet_forces(p_t, cfg_fit, pos_batch, types),
                       f_ref, scale)
        errors[(m1, m2)] = err
        if err <= budget:
            chosen = (m1, m2)
            break
    report = FrontierReport(n_structures=int(pos_batch.shape[0]),
                            d_min=d_min, floor=floor, budget=budget,
                            errors=errors, chosen=chosen)
    listed = " ".join(f"({m1},{m2})={e:.2e}" for (m1, m2), e in
                      errors.items())
    if chosen is None:
        logger.warning(
            f"[frontier] no candidate met the fidelity budget {budget:.2e} "
            f"(bf16 floor {floor:.2e}; errors: {listed}); keeping the "
            f"full-domain {FULL_DOMAIN_FALLBACK} default.",
            extra={"frontier": report},
        )
        return fallback
    m1, m2 = chosen
    logger.info(
        f"[frontier] measured on {report.n_structures} structure(s): bf16 "
        f"floor {floor:.2e}, budget {budget:.2e} -> orders ({m1}, {m2}) on "
        f"d_min={d_min} at {errors[chosen]:.2e} max rel force error "
        f"(errors: {listed}).",
        extra={"frontier": report},
    )
    return dataclasses.replace(config, cheb_order=m1, cheb_order_deriv=m2,
                               cheb_d_min=d_min)
