"""Deterministic neighbour gather for the exact ``"xla"`` path.

``neighbor_gather(src, nbr)`` returns ``src[s, nbr.idx[s, i, k]]``,
``[S, A, K, F]`` from rows ``src [S, A, F]``: the ``pos[nbr.idx]`` and
``h[nbr.idx]`` of the reference's xla path (models/schnet.py:241-289).

Its backward is the reason this module exists. The autograd of
``src[idx]``, ``torch.gather`` or ``index_select`` accumulates into
shared rows with atomics on CUDA, in no fixed order, so forces would stop
being bitwise reproducible (the reference's guarantee,
tests/models/test_forcefield.py:100-106). Here the cotangent of a source
row is the sum of its live slots' cotangents in the order of the list's
source CSR (ops/neighborlist.source_csr): one fixed-order segment sum
(``torch.segment_reduce``, which walks each segment from its first slot
to its last), with no ``index_add_``, ``scatter_add_`` or accumulating
``index_put_``. Masked slots, which read their own row, get no share:
on the xla path every masked slot's cotangent is zero (the mask enters
the distance through ``where`` and the message through the cutoff), so
the live-slot sum is the whole transpose there.
"""

from __future__ import annotations

import torch


def _flat_index(idx: torch.Tensor) -> torch.Tensor:
    """[S A K] int64 rows ``s A + idx`` of the flattened source."""
    s, n_atoms, _ = idx.shape
    base = torch.arange(s, device=idx.device, dtype=torch.int64)
    return (base[:, None, None] * n_atoms + idx.long()).reshape(-1)


class _NeighborGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, csr_offsets, csr_slots):
        s, n_atoms, k = idx.shape
        f = src.shape[-1]
        ctx.save_for_backward(csr_offsets, csr_slots)
        ctx.shape = (s, n_atoms, k, f)
        rows = src.reshape(s * n_atoms, f).index_select(0, _flat_index(idx))
        return rows.reshape(s, n_atoms, k, f)

    @staticmethod
    def backward(ctx, grad):
        csr_offsets, csr_slots = ctx.saved_tensors
        s, n_atoms, k, f = ctx.shape
        # slot cotangents in CSR order; the masked tail is never read
        by_source = grad.reshape(s * n_atoms * k, f).index_select(
            0, csr_slots.long())
        gsrc = torch.segment_reduce(by_source, "sum", offsets=csr_offsets,
                                    axis=0, unsafe=True)
        return gsrc.reshape(s, n_atoms, f), None, None, None


def neighbor_gather(src: torch.Tensor, nbr) -> torch.Tensor:
    """``src [S, A, F]`` gathered at ``nbr.idx [S, A, K]`` -> ``[S, A, K,
    F]``, with the fixed-order CSR backward (module docstring). ``nbr``
    is a batched NeighborMatrix with its source CSR."""
    if nbr.csr_offsets is None:
        raise ValueError(
            "neighbor_gather needs the batched list's source CSR "
            "(ops.neighborlist.batched_radius_neighbor_matrix)"
        )
    return _NeighborGather.apply(src, nbr.idx, nbr.csr_offsets,
                                 nbr.csr_slots)
