"""Wrapper of the split-KV decode-attention kernel
(`csrc/decode_attention.cu`)."""
from __future__ import annotations

import math

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_decode_attention

CHUNK = 32          # cache positions per block of the first pass
_SMEM_LIMIT = 48 * 1024


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: float = None) -> torch.Tensor:
    """One-token attention over a filled KV cache.

    q [B,H,hd]; k,v [B,KV,T,hd]; lengths [B] int32 -> [B,H,hd]. A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("decode_attention", q, k, v, lengths):
        return reference_decode_attention(q, k, v, lengths, scale=s)
    code = dtype_code("decode_attention", q, k, v)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q [B,H,hd], k = v [B,KV,T,hd]")
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if hd > 256 or T < 1:
        raise ValueError("decode_attention: needs head_dim <= 256, T >= 1")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be int32 [B], "
                         "contiguous")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode_attention: head_dim must be contiguous")
    qr = H // KV
    if 4 * qr * (hd + CHUNK) > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: {qr} query heads per kv head "
                         f"of head_dim {hd} exceed shared memory")
    n_chunks = -(-T // CHUNK)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    part_o = torch.empty((B, KV, n_chunks, qr, hd), dtype=torch.float32,
                         device=q.device)
    part_ml = torch.empty((2, B, KV, n_chunks, qr), dtype=torch.float32,
                          device=q.device)
    err = library("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), part_o.data_ptr(), part_ml[0].data_ptr(),
        part_ml[1].data_ptr(), B, H, KV, T, hd, CHUNK,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), float(s), code,
        stream_of(q.device))
    check("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
