"""Wrappers of the flash-attention kernels: the forward
(`csrc/flash_attention.cu`) and its gradient (`csrc/flash_attention_bwd.cu`).

`flash_attention` launches the forward alone when no gradient is wanted
(serving); when grad is enabled and q, k or v requires grad it goes
through `_FlashAttention`, a `torch.autograd.Function` whose forward is
the same launch and whose backward launches `flash_attention_bwd`. The
head_dim padding stays outside the Function, so autograd slices the
padded gradients back."""
from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_attention, reference_attention_bwd

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
                     causal: bool = True, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """`attend(q, k, v, scale=scale, causal=causal, window=window,
    softcap=softcap)` at `head_dim`: q, k and v zero-padded along
    head_dim, the output sliced back. Zero columns add nothing to q.k, so
    the scores, and with them the cap and the softmax, are those at the
    true head_dim (the caller's `scale` comes from it); v's zero columns
    give output columns that the slice drops."""
    hd = q.shape[-1]
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if head_dim == hd:
        return attend(q, k, v, **kw)
    qp, kp, vp = (F.pad(t, (0, head_dim - hd)) for t in (q, k, v))
    return attend(qp, kp, vp, **kw)[..., :hd].contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float = None, causal: bool = True,
                    window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Attention: q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd]
    (contiguous); causal: query i sees keys 0..i (with window > 0 only
    (i - window, i]), else every one of the T keys (an encoder's
    self-attention, cross-attention onto an encoder's rows; a window is
    ignored); softcap > 0 caps the scores to tanh(s / softcap) * softcap.
    Inputs may be strided views as long as head_dim is contiguous;
    head_dim is at most 256 and is padded to the kernel's next size
    (`kernel_head_dim`). A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("flash_attention", q, k, v):
        return reference_attention(q, k, v, scale=s, causal=causal,
                                   window=window, softcap=softcap)
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
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    return padded_attention(_attend_grad if grad else _launch, q, k, v,
                            scale=s, head_dim=kernel_head_dim(hd, q.dtype),
                            causal=causal, window=window, softcap=softcap)


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (`_launch`, unchanged) with the backward kernel
    as its gradient; saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap):
        out = _launch(q, k, v, scale=scale, causal=causal, window=window,
                      softcap=softcap)
        ctx.save_for_backward(q, k, v, out)
        ctx.kw = dict(scale=scale, causal=causal, window=window,
                      softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, out, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def _attend_grad(q, k, v, *, scale, causal, window, softcap):
    return _FlashAttention.apply(q, k, v, scale, causal, window, softcap)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            scale: float, causal: bool, window: int,
            softcap: float) -> torch.Tensor:
    """The kernel on checked CUDA tensors at one of its head_dims."""
    code = dtype_code("flash_attention", q, k, v)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        _check_tma_rows("flash_attention", q, k, v)
    out = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    err = library("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, S, T, hd, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(scale), float(softcap),
        int(causal), int(window), code, stream_of(q.device))
    check("flash_attention", err)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def _check_tma_rows(name: str, *tensors: torch.Tensor) -> None:
    """The bfloat16 kernels' tensor maps (TMA loads) need 16-byte aligned
    rows: an aligned base and strides of whole 8-element steps."""
    for t in tensors:
        if t.data_ptr() % 16 or any(
                st % 8 for n, st in zip(t.shape[:3], t.stride()[:3])
                if n > 1):
            raise ValueError(f"{name}: bfloat16 inputs need 16-byte "
                             f"aligned rows")


def flash_attention_bwd(q, k, v, out, dout, *, scale: float,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0):
    """(dq, dk, dv) of `flash_attention(q, k, v, ...)` at its output
    `out` for the output gradient `dout`, in the inputs' dtype. q [B,H,S,hd]
    and k, v [B,KV,T,hd] may be strided views with head_dim contiguous;
    out and dout are copied to contiguous tensors where they are not;
    head_dim must be one the forward kernel runs at (`kernel_head_dim`: a
    multiple of 32, 64/128/256 in bf16). A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if not on_cuda("flash_attention_bwd", q, k, v, out, dout):
        return reference_attention_bwd(q, k, v, out, dout, scale=scale,
                                       causal=causal, window=window,
                                       softcap=softcap)
    return _launch_bwd(q, k, v, out, dout, scale=scale, causal=causal,
                       window=window, softcap=softcap)


def _launch_bwd(q, k, v, out, dout, *, scale: float, causal: bool,
                window: int, softcap: float):
    """The backward kernel's passes on CUDA tensors (three in float32,
    three or four in bfloat16); raises on what it does not take."""
    code = dtype_code("flash_attention_bwd", q, k, v, out, dout)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if (v.shape != k.shape or k.shape[0] != B
            or k.shape[3] != hd or KV == 0 or H % KV or T < 1
            or out.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, k, v "
                         f"{tuple(k.shape)}, out {tuple(out.shape)}, dout "
                         f"{tuple(dout.shape)} do not match")
    if hd != kernel_head_dim(hd, q.dtype):
        raise ValueError(f"flash_attention_bwd: head_dim {hd} is not one "
                         f"the kernel runs at ({kernel_head_dim(hd, q.dtype)}"
                         f")")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_attention_bwd: head_dim must be contiguous")
    if q.dtype == torch.bfloat16:
        _check_tma_rows("flash_attention_bwd", q, k, v)
    out, dout = out.contiguous(), dout.contiguous()
    dq = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, T, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty((2, B, H, S), dtype=torch.float32, device=q.device)
    # bfloat16 with H > KV: each query head's float32 dk and dv, which the
    # kernel's third launch sums over the head's group
    part = (torch.empty((2, B, H, T, hd), dtype=torch.float32,
                        device=q.device)
            if q.dtype == torch.bfloat16 and H > KV else None)
    err = library("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        stats[0].data_ptr(), stats[1].data_ptr(),
        None if part is None else part[0].data_ptr(),
        None if part is None else part[1].data_ptr(), B, H, KV, S, T, hd,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), float(scale),
        float(softcap), int(causal), int(window), code,
        stream_of(q.device))
    check("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0
