"""Functional multilayer perceptrons (port of flashmd_tpu/models/mlp.py).

Weights are stored ``[in, out]`` as in the reference. Precision tiers:

* ``fp32``: float32 operands and result (TF32 is off, see the package
  ``__init__``).
* ``bf16``: operands rounded to bfloat16, result in float32 — the
  reference ``_dense`` (mlp.py:89-109) with ``preferred_element_type=
  float32``. A bf16-output ``torch.matmul`` would add a rounding of the
  result that JAX does not have, so the rounded operands are multiplied
  in float32: the product of two bf16 values is exact in float32, which
  makes this the same arithmetic as a bf16 MMA with float32 accumulation.
* ``bf16x3`` is not ported yet and raises.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

PRECISIONS = ("fp32", "bf16")


def check_precision(precision: str) -> None:
    if precision == "bf16x3":
        raise NotImplementedError(
            "precision='bf16x3' is not ported to flashmd_tpu_torch yet"
        )
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
    """Linear -> tanh -> ... -> Linear (no activation on the last layer)."""
    if activation != "tanh":
        raise NotImplementedError(f"activation {activation!r} is not ported")
    layers = params["layers"]
    for layer in layers[:-1]:
        x = torch.tanh(_dense(x, layer, precision))
    return _dense(x, layers[-1], precision)
