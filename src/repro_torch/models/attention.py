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
bytes in both packages. An int8 cache holds each written row quantized
(`quantize_kv`, the reference's `_quantize_kv` bit for bit) beside its
bf16 scale ("k_scale", "v_scale" [B, n_kv, max_len, 1]); a prefill
attends over the dequantized rows it wrote, as the reference does, and a
decode step hands the int8 rows and their scales to the kernel.

Gemma 2's attention features run inside both kernels: a sliding window
(`spec.sliding_window`: a causal query at index i sees (i - window, i])
and a score cap (`spec.logit_softcap`: tanh(s / cap) * cap after the
scale, before the mask), on every path that attends.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels.decode_attention.ops import decode_attention
from ..kernels.decode_attention.ref import (dequantize,
                                            reference_decode_attention)
from ..kernels.flash_attention.ops import flash_attention
from ..kernels.flash_attention.ref import reference_attention
from .config import AttnSpec, ModelConfig
from .layers import Ctx, apply_mrope, apply_rope, rms_norm_heads

# per-head q/k norm scales (qk_norm): float32 [head_dim] leaves, ones at
# init, as the rmsnorm kernel takes its scale
SCALES = ("q_scale", "k_scale")


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


def quantize_kv(x):
    """x [..., hd] -> (int8 values, bf16 per-row scale): symmetric, the
    row's largest magnitude at 127, as the reference's `_quantize_kv`
    (float32 math, round half to even, the scale at least 1e-8)."""
    xf = x.float()
    scale = (xf.abs().amax(-1, keepdim=True) / 127.0).clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _write(cache, index, k, v) -> None:
    """k and v written at `index` of the cache: cast to its dtype, or
    quantized beside their scales into an int8 cache."""
    for name, x in (("k", k), ("v", v)):
        if cache[name].dtype == torch.int8:
            cache[name][index], cache[name + "_scale"][index] = \
                quantize_kv(x)
        else:
            cache[name][index] = x.to(cache[name].dtype)


def _rows(cache, rows: int, dt):
    """The cache's first `rows` K and V rows for attention: as they lie,
    or an int8 cache's dequantized to `dt` (the reference's
    `_read_cache`)."""
    k, v = cache["k"][:, :, :rows], cache["v"][:, :, :rows]
    if k.dtype == torch.int8:
        return (dequantize(k, cache["k_scale"][:, :, :rows], dt),
                dequantize(v, cache["v_scale"][:, :, :rows], dt))
    return k, v


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
    features = dict(window=spec.sliding_window, softcap=spec.logit_softcap)

    if cache is None:                                   # train forward
        out = flash(q.transpose(1, 2), k, v, scale=scale,
                    causal=spec.causal, **features)
        out = out.transpose(1, 2)                       # [B,S,H,hd]
    elif ctx.mode == "prefill":
        _write(cache, (slice(None), slice(None), slice(None, S)), k, v)
        # causal attention over the whole cache (as the reference does)
        # equals attention over its first S rows: positions >= S are
        # masked for every query < S; non-causal attention sees every row
        rows = S if spec.causal else cache["k"].shape[2]
        out = flash(q.transpose(1, 2), *_rows(cache, rows, dt), scale=scale,
                    causal=spec.causal, **features)
        out = out.transpose(1, 2)
    else:                                               # decode, S == 1
        idx = ctx.cache_index
        slots = torch.arange(B, device=idx.device)
        _write(cache, (slots, slice(None), idx), k[:, :, 0], v[:, :, 0])
        # the causal decode mask is kv_pos <= index, i.e. index + 1 filled
        # rows, and with a window index - kv_pos < window; a non-causal
        # one masks nothing
        lengths = (idx + 1 if spec.causal else
                   torch.full_like(idx, cache["k"].shape[2])).to(torch.int32)
        out = _decode(ctx, q[:, 0], cache, lengths, scale,
                      spec.sliding_window if spec.causal else 0,
                      spec.logit_softcap)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache


def _decode(ctx: Ctx, q, cache, lengths, scale, window, softcap):
    """Decode attention of q [B,H,hd] over each slot's rows [max(lengths
    - window, 0), lengths) of the cache (int8 ones with their scales):
    [B,1,H,hd]."""
    dec = reference_decode_attention if ctx.plain else decode_attention
    return dec(q, cache["k"], cache["v"], lengths, scale=scale,
               window=window, softcap=softcap,
               k_scale=cache.get("k_scale"),
               v_scale=cache.get("v_scale"))[:, None]


def _cross(params, x, spec: AttnSpec, ctx: Ctx, cache):
    """Cross-attention: queries from x [B,S,D], K/V projected from the
    encoder's output `ctx.enc_out` [B,F,D] (prefill, train forward; a
    cache takes them, in its dtype or quantized) or read from the cache
    (decode), every one of the F rows seen. As in the reference, a
    prefill attends over the projections themselves, in the compute
    dtype, and a decode step over the cache."""
    dt = ctx.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"].to(dt))
    scale = 1.0 / math.sqrt(spec.head_dim)
    if cache is not None and ctx.mode == "decode":
        F_ = cache["k"].shape[2]
        lengths = torch.full((x.shape[0],), F_, dtype=torch.int32,
                             device=x.device)
        out = _decode(ctx, q[:, 0], cache, lengths, scale, 0,
                      spec.logit_softcap)
    else:
        src = ctx.enc_out
        k = torch.einsum("btd,dgk->bgtk", src, params["wk"].to(dt))
        v = torch.einsum("btd,dgk->bgtk", src, params["wv"].to(dt))
        if cache is not None:
            _write(cache, (slice(None),), k, v)
        flash = reference_attention if ctx.plain else flash_attention
        out = flash(q.transpose(1, 2), k, v, scale=scale, causal=False,
                    softcap=spec.logit_softcap).transpose(1, 2)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"].to(dt)), cache
