"""Carry a flashmd_tpu force field's weights into the port.

The caller turns the JAX ``ForceField``'s parameters and priors into
numpy (e.g. ``jax.tree.map(np.asarray, ff.schnet_params)``); this module
needs no JAX. Arrays are copied as they are, so both packages run on
bit-identical weights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .cutoff import (
    CosineCutoff,
    IdentityCutoff,
    ShiftedCosineCutoff,
    _Cutoff,
)
from .forcefield import ForceField
from .schnet import SchNetConfig
from ..prior.priors import Prior


def _tensor(a, device, dtype=torch.float32):
    """An integer array as int64, any other as ``dtype``."""
    a = np.array(a)
    if np.issubdtype(a.dtype, np.integer):
        dtype = torch.int64
    return torch.as_tensor(a, dtype=dtype, device=device)


def _tree_to_torch(tree, device, dtype=torch.float32):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device, dtype) for v in tree)
    return _tensor(tree, device, dtype)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


_ENVELOPES = {cls.__name__: cls
              for cls in (CosineCutoff, IdentityCutoff, ShiftedCosineCutoff)}


def _cutoff(cut, field: str) -> _Cutoff:
    """The port's envelope of a reference envelope (matched by class name
    and fields: this module imports nothing of the reference); an envelope
    the port does not have raises rather than run as another."""
    if cut is None or isinstance(cut, _Cutoff):
        return cut
    cls = _ENVELOPES.get(type(cut).__name__)
    if cls is None:
        raise NotImplementedError(
            f"{field}={cut!r}: only {sorted(_ENVELOPES)} are ported to "
            "flashmd_tpu_torch"
        )
    return cls(**{f.name: float(getattr(cut, f.name))
                  for f in dataclasses.fields(cls)})


def config_from_kwargs(config_kwargs: dict) -> SchNetConfig:
    """A port SchNetConfig from the reference config's fields; fields the
    port does not have are dropped. ``cutoff`` and ``rbf_cutoff`` carry
    across as the port's envelope of the same class (CosineCutoff,
    IdentityCutoff, ShiftedCosineCutoff); the config refuses those that
    its message-passing path cannot compute (models.schnet)."""
    names = {f.name for f in dataclasses.fields(SchNetConfig)}
    kw = {k: v for k, v in config_kwargs.items() if k in names}
    for field in ("cutoff", "rbf_cutoff"):
        if field in kw:
            kw[field] = _cutoff(kw[field], field)
    if "output_hidden_layer_widths" in kw:
        kw["output_hidden_layer_widths"] = tuple(
            kw["output_hidden_layer_widths"]
        )
    return SchNetConfig(**kw)


def forcefield_from_numpy(schnet_params_np, priors_np, config_kwargs,
                          device="cuda", neighbor_capacity: int = 64,
                          exc_pair_index=None,
                          pbc_images=None) -> ForceField:
    """The port's ForceField from numpy weights.

    ``schnet_params_np``: nested dicts/lists of numpy arrays in the
    reference layout (``embedding``, ``rbf``, ``interactions``,
    ``output``, optionally ``cheb_fit``). ``priors_np``: name -> prior
    with ``index_mapping``, ``params``, ``kind``, ``name``, ``feature``
    and optionally ``term_mask`` (attributes or dict keys); priors stacked
    along [S] by the reference's stack_forcefields (``index_mapping``
    [S, order, T]) make a field with ``batched_priors``.
    ``config_kwargs``: see config_from_kwargs.
    ``neighbor_capacity``, ``exc_pair_index`` ([2, P] or None) and
    ``pbc_images`` (the reference's tuple of (i, j, k) shifts, or None) are
    the reference ForceField's fields of those names. The tensors are
    placed on the card unless ``device`` says otherwise.
    """
    params = _tree_to_torch(dict(schnet_params_np), device)
    if "cheb_fit" in params:
        params["cheb_fit"] = tuple(tuple(f) for f in params["cheb_fit"])
    priors = {}
    for key, p in priors_np.items():
        term_mask = (p.get("term_mask") if isinstance(p, dict)
                     else getattr(p, "term_mask", None))
        priors[key] = Prior(
            index_mapping=_tensor(_field(p, "index_mapping"), device),
            params={
                k: _tensor(v, device) for k, v in _field(p, "params").items()
            },
            kind=_field(p, "kind"),
            name=_field(p, "name"),
            feature=_field(p, "feature"),
            term_mask=(None if term_mask is None
                       else _tensor(term_mask, device)),
        )
    return ForceField(
        schnet_params=params,
        priors=priors,
        schnet_config=config_from_kwargs(config_kwargs),
        neighbor_capacity=int(neighbor_capacity),
        exc_pair_index=(None if exc_pair_index is None
                        else _tensor(exc_pair_index, device)),
        pbc_images=(None if pbc_images is None
                    else tuple(tuple(map(int, s)) for s in pbc_images)),
        batched_priors=any(p.batched for p in priors.values()),
    )
