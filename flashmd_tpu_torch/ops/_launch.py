"""Launch helpers shared by the kernel wrappers of ``flashmd_tpu_torch.ops``:
operand checks, raw pointers, the current stream, CUDA error codes, and the
bf16 operand rounding of the plain twins."""

from __future__ import annotations

import torch

from ..models.mlp import round_bf16


def _op(t: torch.Tensor, precision: str) -> torch.Tensor:
    """A product operand at the precision tier."""
    return round_bf16(t) if precision == "bf16" else t


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
