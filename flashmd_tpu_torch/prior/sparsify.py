"""Sparse <-> dense conversions for prior parameter storage (port of
flashmd_tpu/prior/sparsify.py; the reference's ``to_sparse``/``to_dense``,
models/utils.py:6-35).

The priors are term lists, sparse by construction. The dense buffers are
the optional [A, A] sigma^6 matrix of a ``repulsion_dense`` prior
(:func:`flashmd_tpu_torch.prior.priors.densify_repulsion`) and the dense
type-keyed statistics tables ``table[type_i, type_j, ...]`` used while
building priors; each has a sparse round trip here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .priors import Prior


def sparsify_repulsion(prior: Prior) -> Prior:
    """Inverse of :func:`densify_repulsion`: dense pairs -> term list, on
    the prior's device (reference sparsify.py:24-45). The dense form
    stores each term once, so the recovered terms are those
    ``densify_repulsion`` consumed, in row-major (i, j) order."""
    if prior.kind != "repulsion_dense":
        raise ValueError("sparsify_repulsion expects a repulsion_dense prior")
    sigma6 = prior.params["sigma6"]
    mat = sigma6.detach().cpu().numpy().astype(np.float64)
    i, j = np.nonzero(mat)
    sigma = mat[i, j] ** (1.0 / 6.0)
    return Prior(
        index_mapping=torch.as_tensor(np.stack([i, j]), dtype=torch.int64,
                                      device=sigma6.device),
        params={"sigma": torch.as_tensor(sigma, dtype=torch.float32,
                                         device=sigma6.device)},
        kind="repulsion",
        name=prior.name,
        feature="distance",
    )


def table_to_sparse(table, order: int = None) -> Tuple[np.ndarray, np.ndarray]:
    """Dense type-keyed table -> (indices [order, n], values [n, ...])
    (reference sparsify.py:48-66). ``table`` has ``order`` leading type
    axes (default: every axis, a scalar payload) and any trailing
    parameter axes; type combinations whose payload is all zero are
    dropped."""
    arr = np.asarray(table)
    if order is None:
        order = arr.ndim
    payload_axes = tuple(range(order, arr.ndim))
    present = np.abs(arr).sum(axis=payload_axes) if payload_axes else arr
    nz = np.nonzero(present)
    idx = np.stack(nz).astype(np.int64)
    return idx, arr[nz]


def sparse_to_table(idx, values, shape) -> np.ndarray:
    """(indices, values) -> dense table of ``shape``, zeros elsewhere
    (reference sparsify.py:69-77)."""
    idx = np.asarray(idx)
    values = np.asarray(values)
    out = np.zeros(shape, dtype=values.dtype)
    out[tuple(idx)] = values
    return out
