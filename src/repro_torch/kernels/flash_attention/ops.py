"""Wrapper of the flash-attention forward kernel
(`csrc/flash_attention.cu`). Forward only: the port serves, and a
backward kernel comes with training."""
from __future__ import annotations

import math

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_attention


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float = None) -> torch.Tensor:
    """Causal attention: q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd]
    (contiguous); query i sees keys 0..i. Inputs may be strided views as
    long as head_dim is contiguous. A CPU tensor takes the plain version;
    a CUDA tensor launches the kernel (or raises)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("flash_attention", q, k, v):
        return reference_attention(q, k, v, scale=s)
    code = dtype_code("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q [B,H,S,hd], k = v [B,KV,T,hd]")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if T < 1:
        raise ValueError("flash_attention: needs T >= 1")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head_dim must be contiguous")
    if q.dtype == torch.float32 and (hd % 32 or hd > 256):
        raise ValueError("flash_attention: float32 needs head_dim a "
                         "multiple of 32 up to 256")
    if q.dtype == torch.bfloat16:
        # the tensor-core kernel loads 16-byte rows with cp.async
        if hd not in (64, 128, 256):
            raise ValueError("flash_attention: bfloat16 needs head_dim "
                             "64, 128 or 256")
        for t in (q, k, v):
            if t.data_ptr() % 16 or any(
                    st % 8 for n, st in zip(t.shape[:3], t.stride()[:3])
                    if n > 1):
                raise ValueError("flash_attention: bfloat16 inputs need "
                                 "16-byte aligned rows")
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    err = library("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, T, hd, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(s), code,
        stream_of(q.device))
    check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
