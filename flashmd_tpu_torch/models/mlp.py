"""Functional multilayer perceptrons (port of flashmd_tpu/models/mlp.py).

Weights are stored ``[in, out]`` as in the reference. Activations:
tanh, relu, silu and identity (reference ``ACTIVATIONS``, mlp.py:25-30).
A per-species head (``init_types_mlp`` / ``types_mlp_apply``, the
reference TypesMLP) evaluates every species' MLP and selects per atom.
Precision tiers:

* ``fp32``: float32 operands and result (TF32 is off, see the package
  ``__init__``).
* ``bf16``: operands rounded to bfloat16, result in float32 — the
  reference ``_dense`` (mlp.py:89-109) with ``preferred_element_type=
  float32``. A bf16-output ``torch.matmul`` would add a rounding of the
  result that JAX does not have, so the rounded operands are multiplied
  in float32: the product of two bf16 values is exact in float32, which
  makes this the same arithmetic as a bf16 MMA with float32 accumulation.
* ``bf16x3``: float32 operands and result, as ``fp32``. The reference's
  ``_dense`` at this tier is a float32 dot at ``Precision.HIGH``
  (mlp.py:97-106), with no cast of its own; off the TPU that is a float32
  product. TF32 (10-bit mantissa) is another tier and stays off. Only the
  Chebyshev kernels split their operands at this tier (ops/_launch.py).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

PRECISIONS = ("fp32", "bf16", "bf16x3")
ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "silu": torch.nn.functional.silu,
    "identity": lambda x: x,
}


def check_activation(activation: str) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; the "
                         f"reference has {sorted(ACTIVATIONS)}")


def check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to the nearest bfloat16 and return float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ w at the precision tier, float32 result."""
    check_precision(precision)
    if precision == "bf16":
        return round_bf16(x) @ round_bf16(w)
    return x @ w


def xavier_uniform(shape, generator: torch.Generator, device, gain=1.0):
    """torch.nn.init.xavier_uniform_ for a [in, out] weight."""
    fan_in, fan_out = shape
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (u * (2 * a) - a).to(device)


def init_mlp(
    layer_widths: Sequence[int],
    generator: torch.Generator,
    device,
    last_bias: bool = True,
):
    """Xavier-uniform weights, zero biases (reference init_mlp,
    mlp.py:40-66). Draws on the host generator, then moves to ``device``."""
    layer_widths = list(layer_widths)
    if len(layer_widths) < 2:
        raise ValueError("layer_widths needs at least [in, out]")
    n_layers = len(layer_widths) - 1
    layers = []
    pairs = zip(layer_widths[:-1], layer_widths[1:])
    for i, (w_in, w_out) in enumerate(pairs):
        layer = {"w": xavier_uniform((w_in, w_out), generator, device)}
        if i < n_layers - 1 or last_bias:
            layer["b"] = torch.zeros(w_out, dtype=torch.float32, device=device)
        layers.append(layer)
    return {"layers": layers}


def _dense(x, layer, precision: str):
    y = matmul(x, layer["w"], precision)
    if "b" in layer:
        y = y + layer["b"]
    return y


def mlp_apply(params, x, activation: str = "tanh", precision: str = "fp32"):
    """Linear -> act -> ... -> Linear (no activation on the last layer;
    reference mlp_apply, mlp.py:112-126)."""
    act = ACTIVATIONS[activation]
    layers = params["layers"]
    for layer in layers[:-1]:
        x = act(_dense(x, layer, precision))
    return _dense(x, layers[-1], precision)


def init_types_mlp(layer_widths: Sequence[int], generator: torch.Generator,
                   device, species=None):
    """Per-species MLP bank (reference init_types_mlp, mlp.py:129-149):
    one MLP per distinct entry of ``species`` (sorted, as ``unique``), or
    one shared MLP without species."""
    if species is None:
        return {"species": None,
                "mlps": [init_mlp(layer_widths, generator, device)]}
    species = torch.unique(torch.as_tensor(species)).to(device)
    return {"species": species,
            "mlps": [init_mlp(layer_widths, generator, device)
                     for _ in range(species.shape[0])]}


def types_mlp_apply(params, features, atom_types, activation: str = "tanh",
                    precision: str = "fp32"):
    """y_i = MLP_{species(i)}(features_i), [..., A, 1] (reference
    types_mlp_apply, mlp.py:152-174): every species' MLP runs on every
    atom and a select keeps each atom's own, so no branch depends on the
    data. ``atom_types`` [A] broadcasts over the batch axes of
    ``features``, [S, A] (a mixed batch) gives each molecule its own; an
    atom of no listed species gets 0."""
    if params["species"] is None:
        return mlp_apply(params["mlps"][0], features, activation, precision)
    out = torch.zeros(features.shape[:-1] + (1,), dtype=features.dtype,
                      device=features.device)
    for s, mlp in zip(params["species"], params["mlps"]):
        y = mlp_apply(mlp, features, activation, precision)
        out = torch.where((atom_types == s)[..., None], y, out)
    return out
