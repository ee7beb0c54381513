"""Checks shared by the kernel wrappers."""

from __future__ import annotations

import functools

import torch

DTYPES = (torch.float32, torch.bfloat16)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}  # as the C entries take it


def check_forward_only(name: str, *tensors) -> None:
    """The raw kernel wrappers own no gradient (the autograd Functions of
    ``ops/conv.py`` and ``ops/norm.py`` call them under ``no_grad`` and run
    the backward kernels): refuse a call whose result autograd would
    otherwise silently cut off from its inputs."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward-only: call it under torch.no_grad() or "
            "torch.inference_mode(), on tensors that do not require grad, or "
            "through conv_nd / norm_affine_act, which own the gradient")


def check_operand(name: str, t: torch.Tensor, ndim: int | None,
                  dtypes=DTYPES, device: torch.device | None = None) -> None:
    """``ndim=None`` takes any (..., channels) with at least two dims."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if ndim is None and t.ndim < 2:
        raise ValueError(f"{name} must be (..., channels), got "
                         f"{tuple(t.shape)}")
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def check_aligned(name: str, *tensors) -> None:
    """The CUDA kernels copy 16-byte vectors."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs 16-byte aligned tensors")


def on_cuda(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel runs), False for a CPU tensor (the
    plain version runs); any other device raises."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device "
                     f"{x.device}")


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device, read once."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())
