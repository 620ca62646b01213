"""Plain PyTorch version of flash attention (GQA, causal or not, with a
sliding window and a score cap): the CPU path and the on-card reference
of `csrc/flash_attention.cu`."""
from __future__ import annotations

import torch


def reference_attention(q, k, v, *, scale: float, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """q [B,H,S,hd]; k,v [B,KV,T,hd] -> [B,H,S,hd] (f32 math); causal:
    query i sees keys 0..i, and with a window only (i - window, i];
    non-causal: every key (a window is ignored, as the reference does).
    A score is q.k * scale, capped to tanh(s / softcap) * softcap when
    softcap > 0, then masked."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = H // KV
    qf = q.float().reshape(B, KV, qr, S, D)
    s = torch.einsum("bgqsd,bgtd->bgqst", qf, k.float()) * scale
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        mask = i >= j
        if window > 0:
            mask &= i - j < window
        s = torch.where(mask[None, None, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqst,bgtd->bgqsd", w, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)
