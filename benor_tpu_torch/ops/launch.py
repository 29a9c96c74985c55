"""What every kernel wrapper shares: device dispatch, operand checks, the
ctypes arguments of a launch, and the launch's error code."""

from __future__ import annotations

import ctypes

import torch


def on_cpu(device: torch.device, name: str) -> bool:
    """True for operands on the CPU (plain version), False on a CUDA device
    (kernel); any other device raises."""
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"{name}: kernels run on cuda or cpu tensors, got "
                         f"{device}")
    return False


def check(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel's C entry takes."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or \
            t.device != device or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} tensor of shape "
            f"{tuple(shape)} on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def count_vecs(counts: torch.Tensor) -> torch.Tensor:
    """The kernels' count operand: a [T, 3] histogram (or a [T] count) as
    contiguous f32."""
    return counts.to(torch.float32).contiguous()


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``: kernels launch on it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def raise_on(rc: int, name: str):
    """Raise if a C entry (a launch or a query) returned a non-zero
    cudaError."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA call failed: cudaError {rc}")
