"""Parallel tempering (replica exchange) on BAOAB Langevin (port of
flashmd_tpu/simulation/parallel_tempering.py).

Each of ``n_indep`` configurations is replicated across ``n_replicas``
inverse temperatures into one flat batch, replica-major (slot
``r * n_indep + i``). After every ``exchange_interval``-th step adjacent
temperature pairs, even and odd in turn, propose Metropolis swaps
``exp((U_a - U_b)(beta_a - beta_b))``; exchanged velocities are rescaled by
``sqrt(beta_old / beta_new)``.

The exchange stays on the device, as in the reference: the uniforms come
from the simulation's generator, the accepted swaps become one
permutation of the batch axis, and every batch-leading carry entry
(positions, velocities, forces, potentials, the neighbour list with its
shifts and a CSR built again for the new order, the Verlet reference
positions) follows it. Nothing in it reads the card from the host: no
``.item()``, boolean-mask indexing, ``nonzero`` or Python branch on a
device value. The int32 acceptance counts ride the carry and are fetched
with each export segment's last launch; each export writes the counts of
its own segment as float32 (``<filename>_acceptance_NNNN.npy``), the
difference of the cumulative matrix on the host, so the carry is never
changed at export.

Under a mesh (parallel.mesh) each rank holds the rows of its slots. The
exchange all-gathers the potentials, so that every rank draws the same
permutation from the shared uniforms, and every per-slot carry entry moves
to the rank that owns its new slot (gathered, then this rank's rows taken;
reference parallel_tempering.py:225-240). The acceptance matrix and the
counters are the same on every rank, and rank 0 writes the acceptance
files.
"""

from __future__ import annotations

import time
from copy import deepcopy
from typing import Any, Dict, List

import numpy as np
import torch

from ..data.system import Configuration
from ..ops.neighborlist import NeighborMatrix, permute_neighbor_matrix
from ..parallel.mesh import all_gather, gather_neighbor_matrix, is_io_process
from ..utils.io import logger
from .langevin import LangevinSimulation


class PTSimulation(LangevinSimulation):
    """Parallel-tempering Langevin simulation (reference
    parallel_tempering.py:44-335)."""

    # Carry entries that are not per slot, even where their first dimension
    # happens to equal the batch size (an [R, R] matrix with R == S).
    _replicated_carry = frozenset({
        "exchange_parity", "acceptance_matrix", "n_exchange_approved",
        "n_exchange_attempted",
    })

    def __init__(self, friction: float = 1e-3, exchange_interval: int = 100,
                 **kwargs: Any):
        if exchange_interval < 1:
            raise ValueError("exchange_interval must be a positive number "
                             "of steps")
        kwargs.pop("sim_subroutine", None)
        kwargs.pop("save_subroutine", None)
        kwargs.setdefault("sim_subroutine_interval", exchange_interval)
        super().__init__(friction=friction, **kwargs)
        self.exchange_interval = exchange_interval
        # the cumulative matrix at the last export, on the host
        self._acc_exported = None
        self._acceptance = []

    def _has_device_subroutine(self) -> bool:
        return True

    # ------------------------------------------------------------------
    # Attachment (reference parallel_tempering.py:72-159)
    # ------------------------------------------------------------------

    def attach_model_and_configurations(self, model, configurations, betas):
        if isinstance(model, (list, tuple)):
            raise NotImplementedError(
                "Parallel tempering does not support mixed-size batches "
                "(lists of per-molecule force fields)."
            )
        super().attach_model_and_configurations(model, configurations, betas)

    def _attach_configurations(self, configurations: List[Configuration],
                               beta):
        betas = beta
        if not isinstance(betas, (list, tuple, np.ndarray)):
            raise ValueError(
                "Parallel tempering requires multiple temperatures, but "
                f"only {betas} was supplied."
            )
        betas = [float(b) for b in betas]
        if not all(b > 0 and np.isfinite(b) for b in betas):
            raise ValueError(
                f"All betas must be positive and finite, got {betas}."
            )
        if not (np.array(betas[::-1]) == np.sort(betas[::-1])).all():
            raise ValueError(
                "Betas must be in order of increasing temperature."
            )
        self.n_indep_sims = len(configurations)
        self.n_replicas = len(betas)
        self.betas = betas
        replicated = [deepcopy(c) for _ in betas for c in configurations]
        extended_betas = [b for b in betas for _ in configurations]
        super()._attach_configurations(replicated, extended_betas)
        self._beta_all = self.initial_system.beta  # every slot's, unsharded
        self._build_exchange_pairs()

    def _build_exchange_pairs(self):
        """Even/odd adjacent-pair slot indices, padded to one length with
        (0, 0) pairs marked invalid (reference :120-159). Padding only
        ever pads the odd group, which never holds slot 0, so the padded
        writes of slot 0 in the permutation write its own index."""
        n_ind, n_rep = self.n_indep_sims, self.n_replicas
        even = [(i, i + 1) for i in range(0, n_rep - 1, 2)]
        odd = [(i, i + 1) for i in range(1, n_rep - 1, 2)] or even

        def expand(pairs, pad_to):
            a = [s for pa, _ in pairs for s in range(pa * n_ind,
                                                     (pa + 1) * n_ind)]
            b = [s for _, pb in pairs for s in range(pb * n_ind,
                                                     (pb + 1) * n_ind)]
            valid = [True] * len(a) + [False] * (pad_to - len(a))
            pad = [0] * (pad_to - len(a))
            return a + pad, b + pad, valid

        pad_to = max(len(even), len(odd)) * n_ind
        ea, eb, ev = expand(even, pad_to)
        oa, ob, ov = expand(odd, pad_to)

        def dev(x, dtype):
            return torch.as_tensor(np.asarray(x), dtype=dtype,
                                   device=self.device)

        self._pairs_a = dev([ea, oa], torch.int64)  # [2, P]
        self._pairs_b = dev([eb, ob], torch.int64)
        self._pairs_valid = dev([ev, ov], torch.bool)
        self._slot_to_replica = dev(
            np.repeat(np.arange(n_rep), n_ind), torch.int64)
        self._slots = torch.arange(self.n_sims, device=self.device)

    def _subroutine_draw_shape(self):
        return (self._pairs_a.shape[1],)

    # ------------------------------------------------------------------
    # Carry (reference :161-173)
    # ------------------------------------------------------------------

    def _init_carry(self, system):
        carry = super()._init_carry(system)
        self._acc_exported = None  # a fresh run or a resume: deltas restart
        self._acceptance = []

        def zero(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.device)

        carry["exchange_parity"] = zero()
        carry["acceptance_matrix"] = zero(self.n_replicas, self.n_replicas)
        carry["n_exchange_approved"] = zero()
        carry["n_exchange_attempted"] = zero()
        return carry

    # ------------------------------------------------------------------
    # On-device replica exchange (reference :195-282)
    # ------------------------------------------------------------------

    def _device_subroutine(self, carry: Dict, u: torch.Tensor) -> Dict:
        parity = carry["exchange_parity"]
        even = parity == 0
        pair_a = torch.where(even, self._pairs_a[0], self._pairs_a[1])
        pair_b = torch.where(even, self._pairs_b[0], self._pairs_b[1])
        valid = torch.where(even, self._pairs_valid[0], self._pairs_valid[1])

        beta = self._beta_all
        pot = all_gather(carry["potential"], self.mesh)
        # Metropolis acceptance against the step's uniforms
        p_pair = torch.exp((pot[pair_a] - pot[pair_b])
                           * (beta[pair_a] - beta[pair_b]))
        approved = (u < p_pair) & valid

        # One permutation of the batch axis for every approved swap
        perm = self._slots.clone()
        perm.index_put_((pair_a,), torch.where(approved, pair_b, pair_a))
        perm.index_put_((pair_b,), torch.where(approved, pair_a, pair_b))

        # the slots that this rank's rows take their replicas from; the
        # velocities rescaled by sqrt(beta_old / beta_new) (reference
        # parallel_tempering.py:465-477)
        src = perm[self._rows]
        vscale = torch.sqrt(beta[src] / beta[self._rows])[:, None, None]

        def permute(name, x):
            if isinstance(x, NeighborMatrix):
                return permute_neighbor_matrix(
                    gather_neighbor_matrix(x, self.mesh), src)
            if name != "vel" and self._is_batch_leaf(name, x):
                return all_gather(x, self.mesh)[src]
            return x

        new = {k: permute(k, v) for k, v in carry.items()}
        new["vel"] = all_gather(carry["vel"], self.mesh)[src] * vscale
        new["exchange_parity"] = 1 - parity
        new["n_exchange_approved"] = (carry["n_exchange_approved"]
                                      + approved.sum(dtype=torch.int32))
        new["n_exchange_attempted"] = (carry["n_exchange_attempted"]
                                       + valid.sum(dtype=torch.int32))
        # upper triangle counts accepts, lower triangle rejects, between
        # adjacent betas (reference parallel_tempering.py:399-413)
        n_rep = self.n_replicas
        ra = self._slot_to_replica[pair_a]
        rb = self._slot_to_replica[pair_b]
        acc = carry["acceptance_matrix"].reshape(-1)
        acc = acc.index_add(0, ra * n_rep + rb, approved.to(torch.int32))
        acc = acc.index_add(0, rb * n_rep + ra,
                            (valid & ~approved).to(torch.int32))
        new["acceptance_matrix"] = acc.reshape(n_rep, n_rep)
        return new

    # ------------------------------------------------------------------
    # Checkpoints and exports (reference :175-192, 283-302)
    # ------------------------------------------------------------------

    def _checkpoint_extra_state(self, carry: Dict) -> Dict:
        """The exchange parity (the alternation continues) and the
        cumulative counters of summary(). The matrix is not kept: a
        resumed run restarts it and its export baseline at zero, so the
        per-export deltas are unchanged."""
        return {name: carry[name] for name in (
            "exchange_parity", "n_exchange_approved", "n_exchange_attempted")}

    def _segment_end_state(self, carry: Dict) -> Dict:
        out = super()._segment_end_state(carry)
        out["acceptance_matrix"] = carry["acceptance_matrix"]
        return out

    def _export_segment(self, carry, state, frames_np, step_end):
        key = self._get_numpy_count()
        super()._export_segment(carry, state, frames_np, step_end)
        acc = state["acceptance_matrix"].astype(np.float32)
        if self._acc_exported is None:
            self._acc_exported = np.zeros_like(acc)
        delta = acc - self._acc_exported
        self._acc_exported = acc
        self._acceptance.append(delta)
        if self.filename is not None and is_io_process():
            np.save(f"{self.filename}_acceptance_{key}.npy", delta)

    @property
    def simulated_acceptance(self) -> np.ndarray:
        """Each export segment's accept (upper) / reject (lower) counts,
        [exports, R, R] float32, as the acceptance npys hold them."""
        return np.stack(self._acceptance)

    # ------------------------------------------------------------------
    # Replica bookkeeping (reference :318-335)
    # ------------------------------------------------------------------

    def get_replica_info(self, replica_num: int = 0) -> Dict:
        """Inverse temperature + output indices of one replica."""
        if (not isinstance(replica_num, int) or replica_num < 0
                or replica_num >= self.n_replicas):
            raise ValueError("Please provide a valid replica number.")
        indices = np.arange(replica_num * self.n_indep_sims,
                            (replica_num + 1) * self.n_indep_sims)
        return {"beta": self.betas[replica_num],
                "indices_in_the_output": indices}

    def summary(self) -> Dict:
        """Exchange counts of the finished run, logged and returned."""
        attempted = int(self.final_carry["n_exchange_attempted"])
        exchanged = int(self.final_carry["n_exchange_approved"])
        logger.info(f"Done simulating ({time.asctime()})")
        if attempted:
            logger.info("Replica-exchange rate: %.2f%% (%d/%d)",
                        exchanged / attempted * 100.0, exchanged, attempted)
        logger.info("Call .get_replica_info(#replica) for the inverse "
                    "temperature and trajectory indices of a replica.")
        return {"attempted": attempted, "approved": exchanged}
