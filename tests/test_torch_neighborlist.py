"""Port parity for the open-boundary neighbour list
(flashmd_tpu_torch/ops/neighborlist.py) against the JAX package's
ops/neighborlist.py on identical positions made with numpy: idx, mask and
n_max are compared exactly, at a capacity above the largest neighbour
count, below it (overflow), above the atom count (padding), and with
excluded pairs. The source CSR is checked to be the exact transpose of the
list, and the host capacity helpers against the reference's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flashmd_tpu.native import max_neighbor_count as jmax_neighbor_count
from flashmd_tpu.ops.neighborlist import (
    batched_radius_neighbor_matrix as jbatched,
)
from flashmd_tpu.ops.neighborlist import radius_neighbor_matrix as jradius
from flashmd_tpu.ops.neighborlist import suggest_capacity as jsuggest
from flashmd_tpu_torch.ops import neighborlist as nl
from tests.test_torch_threads import one_torch_thread  # noqa: F401

S, A, RCUT = 3, 29, 4.0


def _pos(seed=0, s=S):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 6.0, (s, A, 3)).astype(np.float32)


def _assert_same(port, ref):
    np.testing.assert_array_equal(port.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_array_equal(port.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(port.n_max.numpy(), np.asarray(ref.n_max))
    assert port.idx.dtype == torch.int32 and port.mask.dtype == torch.bool


# 24 holds every neighbour at this density; 8 overflows; 40 > A pads.
@pytest.mark.parametrize("capacity", [24, 8, 40])
def test_batched_matches_jax(capacity):
    pos = _pos()
    ref = jbatched(jnp.asarray(pos), RCUT, capacity)
    port = nl.batched_radius_neighbor_matrix(torch.tensor(pos), RCUT,
                                             capacity)
    _assert_same(port, ref)
    overflow = int(port.n_max.max()) > capacity
    assert overflow == (capacity == 8)
    assert port.capacity == capacity


def test_single_molecule_and_exclusions_match_jax():
    pos = _pos(1, s=1)[0]
    rng = np.random.default_rng(2)
    excl = rng.integers(0, A, (2, 40))
    for ep in (None, excl):
        ref = jradius(jnp.asarray(pos), RCUT, 16,
                      exclude_pairs=None if ep is None else jnp.asarray(ep))
        port = nl.radius_neighbor_matrix(
            torch.tensor(pos), RCUT, 16,
            exclude_pairs=None if ep is None else torch.tensor(ep))
        _assert_same(port, ref)
        assert port.csr_offsets is None
    # the exclusions are dropped in both directions
    idx, mask = port.idx.numpy(), port.mask.numpy()
    for i, j in excl.T:
        assert not np.any(idx[i][mask[i]] == j)
        assert not np.any(idx[j][mask[j]] == i)


@pytest.mark.parametrize("capacity", [24, 8])
def test_source_csr_is_the_exact_transpose(capacity):
    """Summing a per-slot value over each source's CSR entries equals the
    scatter of the list's slots to idx, on a symmetric and an overflowed
    (asymmetric) list; each source's entries are in slot order."""
    pos = torch.tensor(_pos(3))
    nbr = nl.batched_radius_neighbor_matrix(pos, RCUT, capacity)
    s, a, k = nbr.idx.shape
    off, slots = nbr.csr_offsets.long(), nbr.csr_slots.long()
    assert off.shape == (s * a + 1,) and slots.shape == (s * a * k,)
    assert int(off[-1]) == int(nbr.mask.sum())
    val = torch.randn(s * a * k, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(0))
    val = val * nbr.mask.reshape(-1)
    col = (torch.arange(s)[:, None, None] * a + nbr.idx.long()).reshape(-1)
    ref = torch.zeros(s * a, dtype=torch.float64).index_add_(0, col, val)
    rows = torch.repeat_interleave(torch.arange(s * a), off[1:] - off[:-1])
    n = int(off[-1])
    got = torch.zeros(s * a, dtype=torch.float64).index_add_(
        0, rows, val[slots[:n]])
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)
    assert torch.equal(col[slots[:n]], rows)  # each entry's source
    for r in range(s * a):
        seg = slots[off[r]:off[r + 1]]
        assert torch.all(seg[1:] > seg[:-1])


def test_periodic_arguments_raise():
    """Periodic lists are built now (tests/test_torch_images.py holds them
    against JAX); what still raises: a cell below the minimum-image regime
    without images, images without a cell, and a shift set that does not
    start with the zero shift."""
    pos = torch.tensor(_pos())
    with pytest.raises(ValueError, match="Minimum-image"):
        nl.batched_radius_neighbor_matrix(pos, RCUT, 8,
                                          cell=6.0 * torch.eye(3))
    images = nl.compute_image_shifts(6.0 * np.eye(3), RCUT)
    with pytest.raises(ValueError, match="requires a cell"):
        nl.radius_neighbor_matrix(pos[0], RCUT, 8, images=images)
    with pytest.raises(ValueError, match="zero shift"):
        nl.batched_radius_neighbor_matrix(pos, RCUT, 8,
                                          cell=6.0 * torch.eye(3),
                                          images=images[::-1])
    nbr = nl.batched_radius_neighbor_matrix(pos, RCUT, 8,
                                            cell=10.0 * torch.eye(3))
    assert nbr.shifts.shape == (S, A, 8, 3)


def test_capacity_helpers_match_jax():
    pos = _pos(4, s=1)[0].astype(np.float64)
    for rc in (2.0, 4.0, 5.5):
        assert nl.max_neighbor_count(pos, rc) == jmax_neighbor_count(pos, rc)
    for n, slack in ((0, 1.25), (17, 1.25), (63, 1.35), (64, 1.35)):
        assert nl.suggest_capacity(n, slack=slack) == jsuggest(n, slack)
