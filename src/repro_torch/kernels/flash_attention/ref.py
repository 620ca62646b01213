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


def reference_attention_bwd(q, k, v, out, dout, *, scale: float,
                            causal: bool = True, window: int = 0,
                            softcap: float = 0.0):
    """The gradient of `reference_attention` at its output `out` for an
    output gradient dout, written out in float32 (the plain version of
    `csrc/flash_attention_bwd.cu`): with t the (capped) score and p =
    softmax over the visible keys, dv = p^T dout, dp = dout v^T, delta =
    rowsum(dout * out), ds = p (dp - delta) (times 1 - tanh^2 under a cap),
    dq = ds k scale, dk = ds^T q scale; GQA heads summed into their kv
    head. Returns (dq, dk, dv) in the inputs' dtype."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    qr = H // KV
    qf = q.float().reshape(B, KV, qr, S, D)
    kf, vf = k.float(), v.float()
    of = out.float().reshape(B, KV, qr, S, D)
    gf = dout.float().reshape(B, KV, qr, S, D)
    s = torch.einsum("bgqsd,bgtd->bgqst", qf, kf) * scale
    dcap = None
    if softcap > 0.0:
        th = torch.tanh(s / softcap)
        s = th * softcap
        dcap = 1.0 - th * th
    visible = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        i = torch.arange(S, device=q.device)[:, None]
        j = torch.arange(T, device=q.device)[None, :]
        visible = i >= j
        if window > 0:
            visible &= i - j < window
    s = torch.where(visible, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.where(visible, torch.exp(s - lse), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    dv = torch.einsum("bgqst,bgqsd->bgtd", p, gf)
    dp = torch.einsum("bgqsd,bgtd->bgqst", gf, vf)
    ds = p * (dp - delta)
    if dcap is not None:
        ds = ds * dcap
    dq = torch.einsum("bgqst,bgtd->bgqsd", ds, kf) * scale
    dk = torch.einsum("bgqst,bgqsd->bgtd", ds, qf) * scale
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
