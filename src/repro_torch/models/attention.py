"""GQA/MQA/MHA attention with RoPE, qwen2-vl's M-RoPE or no rotation
(rope="none"), causal or not, and cross-attention onto an encoder's
output, with a KV cache, through the flash-attention kernel (prefill,
train forward, an encoder) and the decode-attention kernel (decode).
Causal attention masks by the cache index (index-causal), as the TPU
kernels do, whatever the positions that rotate q and k.

Cross-attention (whisper's decoder) projects its K/V from `ctx.enc_out`
at prefill and writes them into a cache of the encoder's rows
([B, n_kv, enc_len, head_dim]); a decode step reads that cache and never
writes it. Neither masks: every query sees all enc_len rows.

KV caches are laid out [B, n_kv, max_len, head_dim] (kv-heads before seq),
as in the reference package, so a paused session's KV block is the same
bytes in both packages.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import reference_decode_attention
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import reference_attention
from .config import AttnSpec, ModelConfig
from .layers import Ctx, apply_mrope, apply_rope, rms_norm_heads

# per-head q/k norm scales (qk_norm): float32 [head_dim] leaves, ones at
# init, as the rmsnorm kernel takes its scale
SCALES = ("q_scale", "k_scale")


def check_supported(spec: AttnSpec) -> None:
    """Raise NotImplementedError for the attention features this port
    does not build yet (no ported config uses them)."""
    unported = {
        "sliding_window": spec.sliding_window != 0,
        "logit_softcap": spec.logit_softcap != 0.0,
    }
    missing = [name for name, used in unported.items() if used]
    if missing:
        raise NotImplementedError(
            f"attention features not ported yet: {', '.join(missing)}")


def param_shapes(cfg: ModelConfig, spec: AttnSpec):
    """{name: (shape, fan_in)} of one sublayer's leaves; fan_in None
    marks a float32 scale of ones (the qk-norm scales)."""
    d = cfg.d_model
    out = {
        "wq": ((d, spec.n_heads, spec.head_dim), d),
        "wk": ((d, spec.n_kv, spec.head_dim), d),
        "wv": ((d, spec.n_kv, spec.head_dim), d),
        "wo": ((spec.n_heads, spec.head_dim, d),
               spec.n_heads * spec.head_dim),
    }
    if spec.qk_norm:
        out.update({n: ((spec.head_dim,), None) for n in SCALES})
    return out


def cache_shape(spec: AttnSpec, batch: int, max_len: int, enc_len: int = 0):
    """A sublayer's K (and V) cache: max_len rows, or enc_len (the
    encoder's output) for cross-attention."""
    return (batch, spec.n_kv, enc_len if spec.cross else max_len,
            spec.head_dim)


def _rotary(x, spec: AttnSpec, cfg: ModelConfig, positions):
    """x [B,S,H,hd] rotated as `spec.rope` says: RoPE at positions [B,S],
    M-RoPE at [3,B,S], untouched for "none"."""
    if spec.rope == "none":
        return x
    if spec.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta,
                           spec.mrope_sections)
    return apply_rope(x, positions, cfg.rope_theta)


def apply(params, x, spec: AttnSpec, cfg: ModelConfig, ctx: Ctx,
          cache=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,D] (already normed). Returns (attn_out [B,S,D], cache).

    The cache is updated in place (the reference package rebuilds it
    functionally): prefill writes positions [0, S), decode writes each
    slot's position `cache_index[b]` — every slot, dead and parked ones
    too, whose garbage write the next real decode overwrites. A
    cross-attention sublayer writes its whole cache at prefill and only
    reads it in a decode step."""
    if spec.cross:
        return _cross(params, x, spec, ctx, cache)
    B, S, D = x.shape
    dt = ctx.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    k = torch.einsum("bsd,dgk->bgsk", x, params["wk"].to(dt))
    v = torch.einsum("bsd,dgk->bgsk", x, params["wv"].to(dt))
    if spec.qk_norm:
        # before RoPE, as the reference does; the kernel reads contiguous
        # rows, so k is normed as [B,S,KV,hd] and transposed back
        q = rms_norm_heads(q.contiguous(), params["q_scale"], cfg.norm_eps,
                           ctx.plain)
        k = rms_norm_heads(k.transpose(1, 2).contiguous(), params["k_scale"],
                           cfg.norm_eps, ctx.plain).transpose(1, 2)
    q = _rotary(q, spec, cfg, ctx.positions)
    k = _rotary(k.transpose(1, 2), spec, cfg, ctx.positions).transpose(1, 2)
    scale = 1.0 / math.sqrt(spec.head_dim)
    flash = reference_attention if ctx.plain else flash_attention

    if cache is None:                                   # train forward
        out = flash(q.transpose(1, 2), k, v, scale=scale,
                    causal=spec.causal)
        out = out.transpose(1, 2)                       # [B,S,H,hd]
    elif ctx.mode == "prefill":
        cache["k"][:, :, :S] = k
        cache["v"][:, :, :S] = v
        # causal attention over the whole cache (as the reference does)
        # equals attention over its first S rows: positions >= S are
        # masked for every query < S; non-causal attention sees every row
        rows = S if spec.causal else cache["k"].shape[2]
        out = flash(q.transpose(1, 2), cache["k"][:, :, :rows],
                    cache["v"][:, :, :rows], scale=scale, causal=spec.causal)
        out = out.transpose(1, 2)
    else:                                               # decode, S == 1
        idx = ctx.cache_index
        slots = torch.arange(B, device=idx.device)
        cache["k"][slots, :, idx] = k[:, :, 0].to(cache["k"].dtype)
        cache["v"][slots, :, idx] = v[:, :, 0].to(cache["v"].dtype)
        # the causal decode mask is kv_pos <= index, i.e. index + 1 filled
        # rows; a non-causal one masks nothing
        lengths = (idx + 1 if spec.causal else
                   torch.full_like(idx, cache["k"].shape[2])).to(torch.int32)
        out = _decode(ctx, q[:, 0], cache, lengths, scale)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache


def _decode(ctx: Ctx, q, cache, lengths, scale):
    """Decode attention of q [B,H,hd] over the cache's first `lengths`
    rows of each slot: [B,1,H,hd]."""
    dec = reference_decode_attention if ctx.plain else decode_attention
    return dec(q, cache["k"], cache["v"], lengths, scale=scale)[:, None]


def _cross(params, x, spec: AttnSpec, ctx: Ctx, cache):
    """Cross-attention: queries from x [B,S,D], K/V projected from the
    encoder's output `ctx.enc_out` [B,F,D] (prefill, train forward; a
    cache takes them, in its dtype) or read from the cache (decode), every
    one of the F rows seen. As in the reference, a prefill attends over
    the projections themselves, in the compute dtype, and a decode step
    over the cache."""
    dt = ctx.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    scale = 1.0 / math.sqrt(spec.head_dim)
    if cache is not None and ctx.mode == "decode":
        F_ = cache["k"].shape[2]
        lengths = torch.full((x.shape[0],), F_, dtype=torch.int32,
                             device=x.device)
        out = _decode(ctx, q[:, 0], cache, lengths, scale)
    else:
        src = ctx.enc_out
        k = torch.einsum("btd,dgk->bgtk", src, params["wk"].to(dt))
        v = torch.einsum("btd,dgk->bgtk", src, params["wv"].to(dt))
        if cache is not None:
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        flash = reference_attention if ctx.plain else flash_attention
        out = flash(q.transpose(1, 2), k, v, scale=scale,
                    causal=False).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache
