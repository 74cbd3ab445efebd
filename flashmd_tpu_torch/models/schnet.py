"""SchNet force field on the Chebyshev path (port of
flashmd_tpu/models/schnet.py).

The batch is the leading axis: ``pos [S, A, 3]`` gives ``[S]`` energies.
Only ``message_passing="cheb"`` is ported; any other value raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .cheb import cheb_stack_apply
from .cutoff import CosineCutoff
from .mlp import check_precision, init_mlp, mlp_apply, xavier_uniform
from .radial_basis import GaussianBasisConfig, init_gaussian_basis


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    """Static hyperparameters (reference SchNetConfig, schnet.py:58-163).
    The radial basis shares the conv cutoff."""

    hidden_channels: int = 128
    embedding_size: int = 100
    num_filters: int = 128
    num_interactions: int = 3
    num_rbf: int = 50
    cutoff: CosineCutoff = CosineCutoff(0.0, 5.0)
    output_hidden_layer_widths: Tuple[int, ...] = (128,)
    activation: str = "tanh"
    precision: str = "fp32"
    message_passing: str = "cheb"
    cheb_order: int = 128
    cheb_order_deriv: int | None = None
    cheb_d_min: float = 0.0
    cheb_fit_method: str = "proj"

    def __post_init__(self):
        if self.num_interactions < 1:
            raise ValueError(
                "At least one interaction block must be specified"
            )
        if self.message_passing != "cheb":
            raise NotImplementedError(
                f"message_passing={self.message_passing!r} is not ported to "
                "flashmd_tpu_torch; only 'cheb' is"
            )
        if self.cheb_order_deriv is None:
            object.__setattr__(self, "cheb_order_deriv", self.cheb_order)
        check_precision(self.precision)

    @property
    def rbf_config(self) -> GaussianBasisConfig:
        return GaussianBasisConfig(cutoff=self.cutoff, num_rbf=self.num_rbf)


def init_schnet(config: SchNetConfig, generator: torch.Generator, device):
    """Parameters with the reference's shapes and distributions
    (init_schnet, schnet.py:166-212), drawn on the host from
    ``generator`` and moved to ``device``. Weights are ``[in, out]``."""
    h = config.hidden_channels
    f = config.num_filters
    embedding = torch.randn(
        config.embedding_size, h, generator=generator, dtype=torch.float32
    ).to(device)
    params = {
        "embedding": embedding,
        "rbf": init_gaussian_basis(config.rbf_config, device),
        "interactions": [],
        "output": init_mlp(
            [h, *config.output_hidden_layer_widths, 1], generator, device,
            last_bias=False,
        ),
    }
    for _ in range(config.num_interactions):
        params["interactions"].append(
            {
                "lin1_w": xavier_uniform((h, f), generator, device),
                "filter": init_mlp(
                    [config.num_rbf, f, f], generator, device, last_bias=False
                ),
                "lin2_w": xavier_uniform((f, h), generator, device),
                "lin2_b": torch.zeros(h, dtype=torch.float32, device=device),
                "lin_w": xavier_uniform((h, h), generator, device),
                "lin_b": torch.zeros(h, dtype=torch.float32, device=device),
            }
        )
    return params


def output_energies(params, config: SchNetConfig, x):
    """Per-atom energies from the plain MLP head: [S, A, H] -> [S, A]."""
    e = mlp_apply(
        params["output"], x, activation=config.activation,
        precision=config.precision,
    )
    return e[..., 0]


def schnet_atom_energies(params, config: SchNetConfig, pos, atom_types):
    """[S, A] per-atom energies (reference cheb branch, schnet.py:353-424,
    always through ``cheb_stack_apply``). Needs the host fits attached
    (``models.cheb.attach_cheb_fit``)."""
    fits = params.get("cheb_fit")
    if fits is None:
        raise ValueError(
            "params carry no 'cheb_fit': run models.cheb.attach_cheb_fit "
            "(the simulation does so at attach)"
        )
    if (
        fits[0][0].shape[0] != config.cheb_order
        or fits[0][1].shape[0] != config.cheb_order_deriv
    ):
        raise ValueError("stale cheb_fit: its orders differ from the config")
    s, a = pos.shape[0], pos.shape[1]
    x0 = params["embedding"][atom_types]
    x0 = x0.expand(s, a, x0.shape[-1]).contiguous()
    x = cheb_stack_apply(
        fits, params["interactions"], pos, x0,
        float(config.cutoff.cutoff_upper), config.precision,
        d_min=float(config.cheb_d_min),
    )
    return output_energies(params, config, x)


def schnet_energy(params, config: SchNetConfig, pos, atom_types):
    """Total SchNet energy per molecule, [S]."""
    return torch.sum(schnet_atom_energies(params, config, pos, atom_types),
                     dim=-1)
