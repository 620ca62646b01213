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
    or on any other device."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError(f"{name}: tensors must all lie on the CPU or all on "
                     f"one CUDA device, got {[str(t.device) for t in tensors]}")


def stream_of(device: torch.device) -> int:
    """PyTorch's current stream on `device`, as the C interface takes it.
    The kernel launches on the current device, so that must be `device`."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device} but the current CUDA device "
                         f"is {torch.cuda.current_device()}; launch under "
                         f"torch.cuda.device({device})")
    return torch.cuda.current_stream(device).cuda_stream
