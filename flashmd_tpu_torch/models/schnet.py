"""SchNet force field (port of flashmd_tpu/models/schnet.py).

The batch is the leading axis: ``pos [S, A, 3]`` gives ``[S]`` energies.
Three message-passing paths are ported: ``"cheb"`` (Chebyshev-tabulated
filters, models/cheb.py), ``"dense"`` (the exact filter MLP over all
pairs, ops/cfconv_dense.py) and ``"pallas"``. The last keeps the
reference's name, so that a reference config carries across with its
meaning; in the port it names the exact filter MLP over the padded
neighbour matrix with CUDA kernels (ops/cfconv.py). Any other value raises.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

import torch

from ..ops.cfconv import fused_cfconv_message
from ..ops.cfconv_dense import dense_cfconv_message
from ..ops.cheb_kernel import _cell_operands
from .cheb import cheb_cfconv_apply, cheb_stack_apply
from .cutoff import CosineCutoff
from .mlp import check_precision, init_mlp, mlp_apply, xavier_uniform
from .radial_basis import GaussianBasisConfig, init_gaussian_basis


MESSAGE_PASSING = ("cheb", "dense", "pallas")


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
        if self.message_passing not in MESSAGE_PASSING:
            raise NotImplementedError(
                f"message_passing={self.message_passing!r} is not ported to "
                f"flashmd_tpu_torch; only {MESSAGE_PASSING} are"
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


def schnet_atom_energies(params, config: SchNetConfig, pos, atom_types,
                         nbr=None, cell=None):
    """[S, A] per-atom energies: embedding, the interaction blocks of the
    configured path, the output head. ``nbr`` is the batched neighbour
    matrix (ops.neighborlist) that the ``"pallas"`` path needs. ``cell``
    ([3, 3] or [S, 3, 3]) is consumed only by the cheb path (minimum-image
    pair geometry); the other paths refuse cells upstream
    (models.forcefield.compute_energy_forces)."""
    s, a = pos.shape[0], pos.shape[1]
    x0 = params["embedding"][atom_types]
    x0 = x0.expand(s, a, x0.shape[-1]).contiguous()
    if config.message_passing == "dense":
        x = _dense_blocks(params, config, pos, x0)
    elif config.message_passing == "pallas":
        x = _neighbor_blocks(params, config, pos, x0, nbr)
    else:
        x = _cheb_blocks(params, config, pos, x0, cell)
    return output_energies(params, config, x)


def _cheb_blocks(params, config: SchNetConfig, pos, x0, cell=None):
    """Reference cheb branch (schnet.py:353-424). Needs the host fits
    attached (``models.cheb.attach_cheb_fit``). ``FLASHMD_CHEB_STACK``,
    read at call time as in the reference: "1" (the default) runs the
    stack with its deferred block-stacked gd backward; any other value one
    conv per block (block 1 without its dead gx half), with the linear
    layers in autograd, in float32 as on the stack."""
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
    rcut = float(config.cutoff.cutoff_upper)
    d_min = float(config.cheb_d_min)
    if os.environ.get("FLASHMD_CHEB_STACK", "1") == "1":
        return cheb_stack_apply(
            fits, params["interactions"], pos, x0, rcut, config.precision,
            cell=cell, d_min=d_min,
        )
    cell, inv = _cell_operands(cell, pos.shape[0], pos.device)
    x = x0
    for i, ((c, c2, w0), bp) in enumerate(zip(fits, params["interactions"])):
        h = x @ bp["lin1_w"]
        agg = cheb_cfconv_apply(c, c2, w0, pos, h, rcut, config.precision,
                                i > 0, cell=cell, d_min=d_min, inv=inv)
        y = agg @ bp["lin2_w"] + bp["lin2_b"]
        x = x + (torch.tanh(y) @ bp["lin_w"] + bp["lin_b"])
    return x


def _exact_filter_blocks(params, config: SchNetConfig, x, message):
    """The interaction blocks around an exact-filter message ``message(h,
    w0, b0, w1, offset, coeff, rcut, precision)``. The linear layers run in
    float32, as the reference's DEFAULT-precision dot does off the TPU.

    Both exact-filter kernels hard-code the zero-lower cosine cutoff
    (cfconv_dense.py:79-82, cfconv.py:65-74), so a nonzero ``cutoff_lower``
    raises here where the reference silently computes the zero-lower
    formula."""
    if config.cutoff.cutoff_lower != 0:
        raise NotImplementedError(
            f"message_passing={config.message_passing!r} requires "
            f"CosineCutoff with cutoff_lower == 0 (got {config.cutoff!r})."
        )
    rbf = params["rbf"]
    for bp in params["interactions"]:
        layers = bp["filter"]["layers"]
        h = x @ bp["lin1_w"]
        agg = message(
            h, layers[0]["w"], layers[0]["b"], layers[1]["w"], rbf["offset"],
            rbf["coeff"], float(config.cutoff.cutoff_upper), config.precision,
        )
        y = agg @ bp["lin2_w"] + bp["lin2_b"]
        x = x + (torch.tanh(y) @ bp["lin_w"] + bp["lin_b"])
    return x


def _dense_blocks(params, config: SchNetConfig, pos, x):
    """Reference dense branch (schnet.py:426-451)."""
    return _exact_filter_blocks(
        params, config, x, lambda h, *w: dense_cfconv_message(pos, h, *w)
    )


def _neighbor_blocks(params, config: SchNetConfig, pos, x, nbr):
    """Reference pallas branch (schnet.py:453-479) over the batched
    neighbour matrix ``nbr``."""
    if nbr is None:
        raise ValueError(
            "message_passing='pallas' needs the neighbour matrix (see "
            "models.forcefield.build_neighbors)"
        )
    return _exact_filter_blocks(
        params, config, x,
        lambda h, *w: fused_cfconv_message(pos, h, nbr, *w),
    )


def schnet_energy(params, config: SchNetConfig, pos, atom_types, nbr=None,
                  cell=None):
    """Total SchNet energy per molecule, [S]."""
    return torch.sum(
        schnet_atom_energies(params, config, pos, atom_types, nbr, cell),
        dim=-1,
    )
