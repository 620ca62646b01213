"""Wrapper of the flash-attention forward kernel
(`csrc/flash_attention.cu`). Forward only: the port serves, and a
backward kernel comes with training."""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_attention

BF16_HEAD_DIMS = (64, 128, 256)   # the tensor-core kernel's instantiations
F32_HEAD_DIM_STEP = 32            # the CUDA-core kernel: one column a lane
MAX_HEAD_DIM = 256


def kernel_head_dim(hd: int, dtype: torch.dtype) -> int:
    """The head_dim the kernel runs a head_dim of `hd` at: the next of
    64, 128 and 256 in bfloat16, the next multiple of 32 in float32."""
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {hd} outside 1.."
                         f"{MAX_HEAD_DIM}")
    if dtype == torch.bfloat16:
        return next(d for d in BF16_HEAD_DIMS if d >= hd)
    return -(-hd // F32_HEAD_DIM_STEP) * F32_HEAD_DIM_STEP


def padded_attention(attend: Callable, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, scale: float, head_dim: int,
                     causal: bool = True) -> torch.Tensor:
    """`attend(q, k, v, scale=scale, causal=causal)` at `head_dim`: q, k
    and v zero-padded along head_dim, the output sliced back. Zero columns
    add nothing to q.k, so the scores, and with them the softmax, are
    those at the true head_dim (the caller's `scale` comes from it); v's
    zero columns give output columns that the slice drops."""
    hd = q.shape[-1]
    if head_dim == hd:
        return attend(q, k, v, scale=scale, causal=causal)
    qp, kp, vp = (F.pad(t, (0, head_dim - hd)) for t in (q, k, v))
    return attend(qp, kp, vp, scale=scale,
                  causal=causal)[..., :hd].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float = None, causal: bool = True) -> torch.Tensor:
    """Attention: q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd]
    (contiguous); causal: query i sees keys 0..i, else every one of the T
    keys (an encoder's self-attention, cross-attention onto an encoder's
    rows). Inputs may be strided views as long as head_dim is contiguous;
    head_dim is at most 256 and is padded to the kernel's next size
    (`kernel_head_dim`). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("flash_attention", q, k, v):
        return reference_attention(q, k, v, scale=s, causal=causal)
    dtype_code("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("flash_attention: q [B,H,S,hd], k = v [B,KV,T,hd]")
    B, H, _, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if T < 1:
        raise ValueError("flash_attention: needs T >= 1")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention: head_dim must be contiguous")
    return padded_attention(_launch, q, k, v, scale=s,
                            head_dim=kernel_head_dim(hd, q.dtype),
                            causal=causal)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float, causal: bool) -> torch.Tensor:
    """The kernel on checked CUDA tensors at one of its head_dims."""
    code = dtype_code("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        # the tensor maps of the TMA loads need 16-byte aligned rows
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
        v.stride(0), v.stride(1), v.stride(2), float(scale), int(causal),
        code, stream_of(q.device))
    check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
