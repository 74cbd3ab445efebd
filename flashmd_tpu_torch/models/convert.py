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

from .cutoff import CosineCutoff
from .forcefield import ForceField
from .schnet import SchNetConfig
from ..prior.priors import Prior


def _tensor(a, device):
    a = np.array(a)
    integer = np.issubdtype(a.dtype, np.integer)
    dtype = torch.int64 if integer else torch.float32
    return torch.as_tensor(a, dtype=dtype, device=device)


def _tree_to_torch(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    return _tensor(tree, device)


def _field(obj, name):
    return obj[name] if isinstance(obj, dict) else getattr(obj, name)


def config_from_kwargs(config_kwargs: dict) -> SchNetConfig:
    """A port SchNetConfig from the reference config's fields; fields the
    port does not have are dropped, and any cutoff object with
    ``cutoff_lower``/``cutoff_upper`` becomes the port's CosineCutoff."""
    names = {f.name for f in dataclasses.fields(SchNetConfig)}
    kw = {k: v for k, v in config_kwargs.items() if k in names}
    cut = kw.get("cutoff")
    if cut is not None and not isinstance(cut, CosineCutoff):
        kw["cutoff"] = CosineCutoff(
            float(cut.cutoff_lower), float(cut.cutoff_upper)
        )
    if "output_hidden_layer_widths" in kw:
        kw["output_hidden_layer_widths"] = tuple(
            kw["output_hidden_layer_widths"]
        )
    return SchNetConfig(**kw)


def forcefield_from_numpy(schnet_params_np, priors_np, config_kwargs,
                          device="cpu") -> ForceField:
    """The port's ForceField from numpy weights.

    ``schnet_params_np``: nested dicts/lists of numpy arrays in the
    reference layout (``embedding``, ``rbf``, ``interactions``,
    ``output``, optionally ``cheb_fit``). ``priors_np``: name -> prior
    with ``index_mapping``, ``params``, ``kind``, ``name``, ``feature``
    (attributes or dict keys). ``config_kwargs``: see config_from_kwargs.
    """
    params = _tree_to_torch(dict(schnet_params_np), device)
    if "cheb_fit" in params:
        params["cheb_fit"] = tuple(tuple(f) for f in params["cheb_fit"])
    priors = {}
    for key, p in priors_np.items():
        priors[key] = Prior(
            index_mapping=_tensor(_field(p, "index_mapping"), device),
            params={
                k: _tensor(v, device) for k, v in _field(p, "params").items()
            },
            kind=_field(p, "kind"),
            name=_field(p, "name"),
            feature=_field(p, "feature"),
        )
    return ForceField(
        schnet_params=params,
        priors=priors,
        schnet_config=config_from_kwargs(config_kwargs),
    )
