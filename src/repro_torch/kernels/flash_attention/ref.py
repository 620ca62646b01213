"""Plain PyTorch version of flash attention (GQA, causal or not): the CPU
path and the on-card reference of `csrc/flash_attention.cu`."""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, scale: float, causal: bool = True):
    """q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd] (f32 math); causal:
    query i sees keys 0..i, else every key."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = H // KV
    qf = q.float().reshape(B, KV, qr, S, D)
    s = torch.einsum("bgqsd,bgtd->bgqst", qf, k.float()) * scale
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(T, device=q.device)[None, :])
        s = torch.where(mask[None, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqst,bgtd->bgqsd", w, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
