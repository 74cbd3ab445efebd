"""SchNet force field (port of flashmd_tpu/models/schnet.py).

The batch is the leading axis: ``pos [S, A, 3]`` gives ``[S]`` energies.
Four message-passing paths are ported: ``"xla"`` (the reference's
default: the exact filter MLP over the padded neighbour matrix in plain
PyTorch, with a deterministic neighbour gather, ops/gather.py),
``"cheb"`` (Chebyshev-tabulated filters, models/cheb.py), ``"dense"``
(the exact filter MLP over all pairs, ops/cfconv_dense.py) and
``"pallas"``. The last keeps the reference's name, so that a reference
config carries across with its meaning; in the port it names the exact
filter MLP over the padded neighbour matrix with CUDA kernels
(ops/cfconv.py). Any other value raises.

Only ``"xla"`` takes any conv cutoff envelope and any activation (tanh,
relu, silu, identity) in its filter MLP and interaction blocks. The
Chebyshev path takes any radial-basis envelope, as the reference's does:
the basis enters only its fits, which evaluate the basis with its own
envelope. The kernels of the dense and pallas paths compute the basis
themselves, with the zero-lower cosine on the conv cutoff's upper bound,
so those two refuse any other basis envelope. All three take only the
conv cutoff's zero-lower cosine and the tanh filter. The energy head is a
plain MLP or a per-species TypesMLP bank (``{"species", "mlps"}``, from
checkpoint ingestion) on every path.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.cfconv import fused_cfconv_message
from ..ops.cfconv_dense import dense_cfconv_message
from ..ops.cheb_kernel import _cell_operands
from ..ops.gather import neighbor_gather
from .cheb import (
    cheb_cfconv_apply,
    cheb_stack_apply,
    fit_chebyshev_filter,
    resolved_order_deriv,
)
from .cutoff import CosineCutoff, _Cutoff
from .mlp import (
    ACTIVATIONS,
    check_activation,
    check_precision,
    init_mlp,
    mlp_apply,
    types_mlp_apply,
    xavier_uniform,
)
from .radial_basis import (
    GaussianBasisConfig,
    gaussian_basis_apply,
    init_gaussian_basis,
)


MESSAGE_PASSING = ("xla", "cheb", "dense", "pallas")
REMAT = ("block", "none")


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    """Static hyperparameters (reference SchNetConfig, schnet.py:58-163).

    ``rbf_cutoff`` is the radial basis's own envelope, the conv cutoff when
    None; a lower or upper cutoff that differs from the conv cutoff's warns,
    as in the reference. ``max_num_neighbors`` is the reference's field,
    carried from a checkpoint and read by nothing (the neighbour matrix
    keeps the nearest ``neighbor_capacity`` pairs); ``aggr`` takes "add"
    only. ``message_passing`` defaults to the reference's exact "xla".
    ``cheb_order_deriv`` None follows ``cheb_order``, resolved where it is
    read (:func:`resolved_order_deriv`), so that ``dataclasses.replace(cfg,
    cheb_order=N)`` keeps the two coupled. ``remat`` ("block" or "none") is
    the xla path's rematerialisation: "block" recomputes each block's
    [S, A, K, F] intermediates in the backward instead of storing them."""

    hidden_channels: int = 128
    embedding_size: int = 100
    num_filters: int = 128
    num_interactions: int = 3
    num_rbf: int = 50
    cutoff: _Cutoff = CosineCutoff(0.0, 5.0)
    rbf_cutoff: Optional[_Cutoff] = None
    output_hidden_layer_widths: Tuple[int, ...] = (128,)
    activation: str = "tanh"
    max_num_neighbors: int = 1000
    aggr: str = "add"
    precision: str = "fp32"
    message_passing: str = "xla"
    cheb_order: int = 128
    cheb_order_deriv: int | None = None
    cheb_d_min: float = 0.0
    cheb_fit_method: str = "proj"
    remat: str = "block"

    def __post_init__(self):
        if self.num_interactions < 1:
            raise ValueError(
                "At least one interaction block must be specified"
            )
        if self.aggr != "add":
            raise NotImplementedError(
                f"Only aggr='add' is supported (got {self.aggr!r})."
            )
        if self.message_passing not in MESSAGE_PASSING:
            raise NotImplementedError(
                f"message_passing={self.message_passing!r} is not ported to "
                f"flashmd_tpu_torch; only {MESSAGE_PASSING} are"
            )
        if self.remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got "
                             f"{self.remat!r}")
        rbf_cutoff = self.rbf_cutoff or self.cutoff
        object.__setattr__(self, "rbf_cutoff", rbf_cutoff)
        for end in ("lower", "upper"):
            conv = getattr(self.cutoff, f"cutoff_{end}")
            rbf = getattr(rbf_cutoff, f"cutoff_{end}")
            if conv != rbf:
                warnings.warn(
                    f"Cutoff function {end} cutoff, {conv}, and radial "
                    f"basis function {end} cutoff, {rbf}, do not match."
                )
        check_activation(self.activation)
        if self.message_passing != "xla":
            _require_kernel_config(self)
        check_precision(self.precision)

    @property
    def rbf_config(self) -> GaussianBasisConfig:
        return GaussianBasisConfig(cutoff=self.rbf_cutoff,
                                   num_rbf=self.num_rbf)


def _require_kernel_config(config: SchNetConfig) -> None:
    """The cheb, dense and pallas kernels compute the cosine envelope on
    the conv cutoff's upper bound, and a tanh filter MLP (the Chebyshev fit
    fits one): another envelope or activation would run as those. The dense
    and pallas kernels also compute the radial basis with the zero-lower
    cosine on that bound, so those two refuse another basis envelope; the
    Chebyshev fits evaluate the basis with its own. (A nonzero lower bound
    of the conv cosine is refused where each path runs.)"""
    mp = config.message_passing
    cut, rbf = config.cutoff, config.rbf_cutoff
    if not isinstance(cut, CosineCutoff):
        raise NotImplementedError(
            f"message_passing={mp!r} requires cutoff=CosineCutoff (got "
            f"cutoff={cut!r}); only 'xla' takes other envelopes."
        )
    if mp != "cheb" and not (isinstance(rbf, CosineCutoff)
                             and rbf.cutoff_lower == 0
                             and rbf.cutoff_upper == cut.cutoff_upper):
        raise NotImplementedError(
            f"message_passing={mp!r} requires rbf_cutoff=CosineCutoff(0, "
            f"{cut.cutoff_upper}) (got rbf_cutoff={rbf!r}): its kernels "
            "compute the basis with that envelope; 'xla' and 'cheb' take "
            "another radial-basis envelope."
        )
    if config.activation != "tanh":
        raise NotImplementedError(
            f"message_passing={mp!r} requires activation='tanh' (got "
            f"{config.activation!r}): its filter and blocks are tanh; only "
            "'xla' takes another activation."
        )


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


def output_energies(params, config: SchNetConfig, x, atom_types):
    """Per-atom energies from the head, [S, A, H] -> [S, A]: a plain MLP,
    or a per-species TypesMLP bank (reference output_energies,
    schnet.py:219-236)."""
    out = params["output"]
    if "mlps" in out:
        e = types_mlp_apply(out, x, atom_types, activation=config.activation,
                            precision=config.precision)
    else:
        e = mlp_apply(out, x, activation=config.activation,
                      precision=config.precision)
    return e[..., 0]


def _cast_floats(tree, dtype):
    """The parameter tree with its floating-point tensors in ``dtype``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: _cast_floats(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cast_floats(v, dtype) for v in tree)
    return tree


def schnet_atom_energies(params, config: SchNetConfig, pos, atom_types,
                         nbr, cell=None):
    """[S, A] per-atom energies: embedding, the interaction blocks of the
    configured path, the output head. ``nbr`` is the batched neighbour
    matrix (ops.neighborlist) that the ``"xla"`` and ``"pallas"`` paths
    need, None on the others; the xla path takes its periodicity from the
    list's shifts.
    ``cell`` ([3, 3] or [S, 3, 3]) is consumed only by the cheb path
    (minimum-image pair geometry); dense and pallas refuse cells upstream
    (models.forcefield.compute_energy_forces)."""
    mp = config.message_passing
    if mp != "xla":
        # The kernels take float32 positions, as the JAX package's kernel
        # calls cast them: under dtype="double" the network runs in
        # float32 and its position gradient returns in float64.
        pos = pos.to(torch.float32)
    elif pos.dtype == torch.float64:
        # float64 positions promote the xla path's float32 weights in the
        # JAX package; torch's products do not promote, so cast them here.
        params = _cast_floats(params, pos.dtype)
    x0 = params["embedding"][atom_types]
    if atom_types.ndim == 1:  # one molecule's types, shared by the batch
        x0 = x0.expand(pos.shape[0], -1, -1).contiguous()
    if mp == "xla":
        x = _xla_blocks(params, config, pos, x0, nbr)
    elif mp == "dense":
        x = _dense_blocks(params, config, pos, x0)
    elif mp == "pallas":
        x = _neighbor_blocks(params, config, pos, x0, nbr)
    else:
        x = _cheb_blocks(params, config, pos, x0, cell)
    return output_energies(params, config, x, atom_types)


def neighbor_distances_rbf(params, config: SchNetConfig, pos, nbr):
    """(d [S, A, K], rbf [S, A, K, R]) over the neighbour matrix, with the
    list's periodic shifts where it has them (reference
    neighbor_distances_rbf, schnet.py:241-260). Masked slots read their own
    row, so their d2 is zero: the square root takes 1 there, which keeps
    its gradient finite, and the mask zeroes d and the basis. The live self
    pairs of a ``self_interaction`` list have d2 = 0 too: they take the
    same safe root and d = 0 with a zero position gradient (d is zero for
    every position), where the reference's root at 0 gives NaN forces."""
    rel = neighbor_gather(pos, nbr) - pos[:, :, None, :]
    if nbr.shifts is not None:
        rel = rel + nbr.shifts
    d2 = torch.sum(rel * rel, dim=-1)
    live = nbr.mask & (d2 > 0)
    d = torch.sqrt(torch.where(live, d2, 1.0))
    d = torch.where(live, d, 0.0)
    rbf = gaussian_basis_apply(params["rbf"], config.rbf_config, d)
    return d, rbf * nbr.mask[..., None]


def cfconv_apply(block_params, config: SchNetConfig, x, d, rbf, nbr):
    """Continuous-filter convolution (reference cfconv_apply,
    schnet.py:263-289): lin1, the filter MLP on the basis at the config's
    precision, cutoff(d) W h[j] summed over the K slots in order, lin2.
    The linear layers run in float32, as the reference's DEFAULT-precision
    dot does off the TPU."""
    h = x @ block_params["lin1_w"]
    w = mlp_apply(block_params["filter"], rbf, activation=config.activation,
                  precision=config.precision)  # [S, A, K, F]
    c = config.cutoff(d) * nbr.mask
    msg = w * c[..., None] * neighbor_gather(h, nbr)
    agg = torch.sum(msg, dim=2)
    return agg @ block_params["lin2_w"] + block_params["lin2_b"]


def interaction_block_apply(block_params, config: SchNetConfig, x, d, rbf,
                            nbr):
    """CFConv, the configured activation, linear (reference
    interaction_block_apply, schnet.py:292-310); the residual is added by
    the caller."""
    y = cfconv_apply(block_params, config, x, d, rbf, nbr)
    act = ACTIVATIONS[config.activation]
    return act(y) @ block_params["lin_w"] + block_params["lin_b"]


def _xla_blocks(params, config: SchNetConfig, pos, x, nbr):
    """Reference xla branch (schnet.py:481-499). Under ``remat="block"``
    each block, with its distances and basis, runs under a non-reentrant
    checkpoint (the reference's jax.checkpoint): the backward recomputes
    the block's [S, A, K, F] intermediates from its inputs and the list,
    which is built once, outside, and never again in the recompute."""
    if nbr is None:
        raise ValueError(
            "message_passing='xla' needs the neighbour matrix (see "
            "models.forcefield.build_neighbors)"
        )
    if config.remat == "none":
        d, rbf = neighbor_distances_rbf(params, config, pos, nbr)
        for bp in params["interactions"]:
            x = x + interaction_block_apply(bp, config, x, d, rbf, nbr)
        return x

    def one_block(bp, rbf_params, x, pos):
        d, rbf = neighbor_distances_rbf({"rbf": rbf_params}, config, pos,
                                        nbr)
        return interaction_block_apply(bp, config, x, d, rbf, nbr)

    for bp in params["interactions"]:
        x = x + checkpoint(one_block, bp, params["rbf"], x, pos,
                           use_reentrant=False, preserve_rng_state=False)
    return x


def _cheb_blocks(params, config: SchNetConfig, pos, x0, cell=None):
    """Reference cheb branch (schnet.py:353-424). Takes the host fits
    attached under ``params["cheb_fit"]`` (``models.cheb.attach_cheb_fit``,
    which the simulation runs at attach); without them, or when their
    orders differ from the config's, it fits every block in the graph
    (``models.cheb.fit_chebyshev_filter``), as the reference refits in
    jit. ``FLASHMD_CHEB_STACK``, read at call time as in the reference:
    "1" (the default) runs the stack with its deferred block-stacked gd
    backward; any other value one conv per block (block 1 without its dead
    gx half), with the linear layers in autograd, in float32 as on the
    stack."""
    order_deriv = resolved_order_deriv(config)
    fits = params.get("cheb_fit")
    if fits is not None and (
        fits[0][0].shape[0] != config.cheb_order
        or fits[0][1].shape[0] != order_deriv
    ):
        fits = None  # stale (the orders changed): refit in the graph
    if fits is None:
        fits = tuple(
            fit_chebyshev_filter(bp, params["rbf"], config,
                                 order=config.cheb_order,
                                 order_deriv=order_deriv)
            for bp in params["interactions"]
        )
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


def schnet_energy(params, config: SchNetConfig, pos, atom_types, nbr,
                  cell=None, atom_mask=None):
    """Total SchNet energy per molecule, [S]. ``atom_mask`` ([S, A], 1 on
    real atoms, 0 on padding) drops the head's energies of a mixed batch's
    padded atoms (reference schnet_energy, schnet.py:502-517); their
    messages need no mask, as the padding lies beyond every cutoff."""
    e = schnet_atom_energies(params, config, pos, atom_types, nbr, cell)
    if atom_mask is not None:
        e = e * atom_mask
    return torch.sum(e, dim=-1)
