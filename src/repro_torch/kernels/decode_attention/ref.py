"""Plain PyTorch version of decode attention with per-batch fill lengths
(the CPU path and the on-card reference of `csrc/decode_attention.cu`)."""
from __future__ import annotations

import torch


def reference_decode_attention(q, k, v, lengths, *, scale: float):
    """q [B,H,hd]; k,v [B,KV,T,hd]; lengths [B] -> [B,H,hd].

    Positions >= lengths[b] are masked, and their values zeroed as the
    TPU kernel does, so a garbage cache tail cannot reach the output and
    a row with lengths[b] <= 0 gives zeros."""
    B, H, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = H // KV
    qf = q.float().reshape(B, KV, qr, hd)
    valid = (torch.arange(T, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])                 # [B,T]
    s = torch.einsum("bgqd,bgtd->bgqt", qf, k.float()) * scale
    s = torch.where(valid[:, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1)
    vf = torch.where(valid[:, None, :, None], v.float(), 0.0)
    o = torch.einsum("bgqt,bgtd->bgqd", w, vf)
    return o.reshape(B, H, hd).to(q.dtype)
