"""Plain PyTorch version of decode attention with per-batch fill lengths
(the CPU path and the on-card reference of `csrc/decode_attention.cu`),
over a cache in q's dtype or an int8 one with a bf16 scale a row."""
from __future__ import annotations

import torch


def dequantize(x, scale, dtype):
    """An int8 cache's rows as the reference package's `_read_cache`
    reads them: int8 times the row's bf16 scale in float32, cast to the
    compute dtype."""
    return (x.float() * scale.float()).to(dtype)


def reference_decode_attention(q, k, v, lengths, *, scale: float,
                               window: int = 0, softcap: float = 0.0,
                               k_scale=None, v_scale=None):
    """q [B,H,hd]; k,v [B,KV,T,hd]; lengths [B] -> [B,H,hd].

    Row b sees positions [max(lengths[b] - window, 0), lengths[b]) (all
    below lengths[b] when window is 0): the reference's causal decode
    mask at index lengths[b] - 1. A score is q.k * scale, capped to
    tanh(s / softcap) * softcap when softcap > 0, then masked. An int8 k
    and v (with k_scale, v_scale [B,KV,T,1]) are dequantized to q's dtype
    first. Masked positions' values are zeroed, as the TPU kernel does,
    so a garbage cache tail cannot reach the output and a row with
    lengths[b] <= 0 gives zeros."""
    if k.dtype == torch.int8:
        k = dequantize(k, k_scale, q.dtype)
        v = dequantize(v, v_scale, q.dtype)
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = H // KV
    qf = q.float().reshape(B, KV, qr, hd)
    t = torch.arange(T, device=q.device)[None, :]
    length = lengths.to(q.device)[:, None]
    valid = t < length                                        # [B,T]
    if window > 0:
        valid &= t >= length - window
    s = torch.einsum("bgqd,bgtd->bgqt", qf, k.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    vf = torch.where(valid[:, None, :, None], v.float(), 0.0)
    o = torch.einsum("bgqt,bgtd->bgqd", w, vf)
    return o.reshape(B, H, hd).to(q.dtype)
