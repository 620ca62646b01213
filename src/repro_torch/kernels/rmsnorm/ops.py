"""Wrapper of the RMSNorm kernel (`csrc/rmsnorm.cu`): arbitrary leading
dims, x float32 or bfloat16, scale float32, output in x's dtype."""
from __future__ import annotations

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_rmsnorm


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D]; scale [D] -> [..., D]. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if not on_cuda("rmsnorm", x, scale):
        return reference_rmsnorm(x, scale, eps)
    code = dtype_code("rmsnorm", x)
    D = x.shape[-1]
    if scale.dtype != torch.float32 or scale.shape != (D,):
        raise ValueError(f"rmsnorm: scale must be float32 [{D}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    out = torch.empty_like(x)
    err = library("rmsnorm")(
        x.data_ptr(), scale.data_ptr(), out.data_ptr(), x.numel() // D,
        D, float(eps), code, stream_of(x.device))
    check("rmsnorm", err)
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
