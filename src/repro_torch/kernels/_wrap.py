"""Argument checks shared by the kernel wrappers."""
from __future__ import annotations

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(name: str, *tensors: torch.Tensor) -> int:
    """The C interface's dtype code; all tensors must share one type."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {dt} not supported (float32 or "
                        f"bfloat16)")
    for t in tensors[1:]:
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {dt} and {t.dtype}")
    return DTYPE_CODES[dt]


def on_cuda(name: str, *tensors: torch.Tensor) -> bool:
    """True when the kernel must run (all tensors on one CUDA device),
    False when the plain version must (all on the CPU); raises on a mix
    or on any other device. (Read from `is_cuda`, `is_cpu` and
    `get_device()`: cheaper on the launch path than building
    torch.device objects.)"""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        for t in tensors[1:]:
            if not t.is_cuda or t.get_device() != index:
                break
        else:
            return True
    elif all(t.is_cpu for t in tensors):
        return False
    raise ValueError(f"{name}: tensors must all lie on the CPU or all on "
                     f"one CUDA device, got {[str(t.device) for t in tensors]}")


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the C interface takes it.
    The kernel launches on the current device, so that must be `device`.
    (The raw stream handle, without building a torch.cuda.Stream: that
    took ~6 us of a ~29 us rmsnorm call on the H100, PERF.md.)"""
    current = torch._C._cuda_getDevice()
    if device.index != current:
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {current}; launch under "
                         f"torch.cuda.device({device})")
    return torch._C._cuda_getCurrentRawStream(current)
