"""Wrapper of the one-launch split-KV decode-attention kernel
(`csrc/decode_attention.cu`)."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_decode_attention

CHUNK = 32              # cache positions a block takes (kDecChunk)
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448    # shared memory a block may use on the H100

# per (device index, stream): the kernel's per-(b, kv head) ticket
# counters. Zeroed once; every call leaves them at 0 again.
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def heads_per_group(qr: int) -> int:
    """Query heads a lane holds at once (the kernel's HG): the next power
    of two >= qr, at most 8; more heads per kv head run in groups."""
    return min(8, 1 << (qr - 1).bit_length())


def smem_bytes(T: int, qr: int, hd: int, itemsize: int) -> int:
    """Dynamic shared memory of one block (`DecLayout` in the source): 128
    bytes for the mbarrier, then the K and V staging buffers with scores
    and weights [CHUNK][qp] in float32, or the merge weights
    [n_chunks][qp] in float32 laid over them, whichever is larger."""
    hg = heads_per_group(qr)
    qp = -(-qr // hg) * hg
    region = -(-(CHUNK * hd * itemsize + 16) // 128) * 128
    chunk = 2 * region + 4 * qp * 2 * CHUNK
    merge = 4 * qp * -(-T // CHUNK)
    return 128 + max(chunk, merge)


def scratch_numel(B: int, KV: int, T: int, qr: int, hd: int) -> int:
    """float32 elements of the partials (o, m, l) of every chunk."""
    return B * KV * -(-T // CHUNK) * qr * (hd + 2)


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> None:
    """Raise ValueError for what the kernel does not take."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q [B,H,hd], k = v [B,KV,T,hd]")
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV == 0 or H % KV:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not "
                         f"match k {tuple(k.shape)}")
    if not 1 <= hd <= MAX_HEAD_DIM or T < 1:
        raise ValueError(f"decode_attention: needs 1 <= head_dim <= "
                         f"{MAX_HEAD_DIM} and T >= 1")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) \
            or not lengths.is_contiguous():
        raise ValueError("decode_attention: lengths must be int32 [B], "
                         "contiguous")
    if q.stride(2) != 1:
        raise ValueError("decode_attention: q's head_dim must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.stride(3) != 1 or (T > 1 and t.stride(2) != hd):
            raise ValueError(
                f"decode_attention: the rows of {name} must be contiguous "
                f"(stride(2) == head_dim, stride(3) == 1), got strides "
                f"{t.stride()}: the kernel copies a chunk's rows as one run")
    need = smem_bytes(T, H // KV, hd, q.element_size())
    if need > SMEM_LIMIT:
        raise ValueError(f"decode_attention: {H // KV} query heads per kv "
                         f"head, head_dim {hd} and T {T} need {need} bytes "
                         f"of shared memory a block, over {SMEM_LIMIT}")


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """At least n zeroed int32 counters for launches on `stream`; grown
    (and zeroed) only when a call needs more than any before it."""
    key = (device.index, stream)
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * buf.numel() if buf is not None else 64)
        buf = _TICKETS[key] = torch.zeros(size, dtype=torch.int32,
                                          device=device)
    return buf


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *,
                     scale: float = None) -> torch.Tensor:
    """One-token attention over a filled KV cache.

    q [B,H,hd]; k,v [B,KV,T,hd] with contiguous rows; lengths [B] int32
    -> [B,H,hd]. A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel once (or raises)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if not on_cuda("decode_attention", q, k, v, lengths):
        return reference_decode_attention(q, k, v, lengths, scale=s)
    code = dtype_code("decode_attention", q, k, v)
    check_inputs(q, k, v, lengths)
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    stream = stream_of(q.device)
    out = torch.empty((B, H, hd), dtype=q.dtype, device=q.device)
    scratch = torch.empty(scratch_numel(B, KV, T, H // KV, hd),
                          dtype=torch.float32, device=q.device)
    tickets = _tickets(q.device, stream, B * KV)
    err = library("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), tickets.data_ptr(), B, H, KV, T,
        hd, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), float(s), code, stream)
    check("decode_attention", err)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
