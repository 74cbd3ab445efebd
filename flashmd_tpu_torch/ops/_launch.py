"""Launch helpers shared by the kernel wrappers of ``flashmd_tpu_torch.ops``:
operand checks, raw pointers, the current stream, CUDA error codes, the
tier codes of the kernels, and the operand rounding and tier products of
the plain twins."""

from __future__ import annotations

import torch

from ..models.mlp import round_bf16


# The kernels' tier argument: 0 fp32, 1 bf16, 3 bf16x3 (three bf16 passes).
TIER_CODES = {"fp32": 0, "bf16": 1, "bf16x3": 3}
# Largest atom index or list slot that a ring entry of the tensor-core
# CFConv kernels holds (RING_MAX in csrc/cfconv_tile.cuh).
RING_MAX = 0xFFFF


def _op(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A product operand at the precision tier (bf16x3: the unsplit value;
    see ``_dot``)."""
    return round_bf16(t) if precision == "bf16" else t


def _split_bf16(a: torch.Tensor):
    """(hi, lo): hi = bf16(a), lo = bf16(a - hi), both as float32 (reference
    ``_split_bf16``, ops/pallas/cheb_kernel.py:352-355)."""
    hi = round_bf16(a)
    return hi, round_bf16(a - hi)


def _dot(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b at the precision tier, float32 result. bf16x3 mirrors the
    reference's ``_mxu_dot`` (cheb_kernel.py:358-380): hi_a @ hi_b + lo_a @
    hi_b + hi_a @ lo_b, summed in that order, each a float32 product of
    bf16-exact values. fp32 and bf16 are ``_op(a) @ _op(b)``."""
    if precision == "bf16x3":
        a_hi, a_lo = _split_bf16(a)
        b_hi, b_lo = _split_bf16(b)
        return a_hi @ b_hi + a_lo @ b_hi + a_hi @ b_lo
    return _op(a, precision) @ _op(b, precision)


def _check(name, t, shape, dtype=torch.float32):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _same_device(*ts):
    dev = ts[0].device
    for t in ts[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def _stream():
    return torch.cuda.current_stream().cuda_stream
