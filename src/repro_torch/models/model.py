"""Model assembly: embedding -> group stack (+tail) -> norm -> logits.

Three entry points share one stack implementation:

  forward(...)      train-mode forward, full-sequence logits
  prefill(...)      fills the KV cache, returns last-position logits
  decode_step(...)  one-token step against the cache

Parameters are a plain dict shaped like the reference package's pytree:
group params are stacked [G, ...] under {"groups": {"L0S0": {"norm",
"mixer"}}}, beside "embed" and "final_norm". `params_from_jax` takes the
reference's `init_params` output (as numpy arrays), so both packages
compute the same function; `init_params` draws the same distributions
natively on the device. Caches are grouped the same way:
{"groups": {"L0S0": {"k": [G,B,KV,T,hd], "v": ...}}, "tail": {}}.

The port builds attention + FFN stacks; the other sublayer kinds and the
attention features `attention.check_supported` lists raise
NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from . import attention, ffn
from .config import ModelConfig
from .layers import Ctx, apply_add_norm, apply_norm, embed_init

_MIXERS = {"attn": attention, "ffn": ffn}


def _key(li: int, si: int) -> str:
    return f"L{li}S{si}"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this port cannot build."""
    if cfg.encoder is not None:
        raise NotImplementedError("encoder stacks are not ported yet")
    if cfg.tail:
        raise NotImplementedError("non-repeating tails are not ported yet")
    if cfg.final_logit_softcap:
        raise NotImplementedError("final_logit_softcap is not ported yet")
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    if cfg.modality != "text":
        raise NotImplementedError(f"modality {cfg.modality!r} is not "
                                  f"ported yet")
    for _, _, _, spec in cfg.sublayers():
        if spec.kind not in _MIXERS:
            raise NotImplementedError(
                f"sublayer kind {spec.kind!r} is not ported yet")
        if spec.kind == "attn":
            attention.check_supported(spec)


def _sublayers(cfg: ModelConfig):
    for li, layer in enumerate(cfg.pattern):
        for si, spec in enumerate(layer):
            yield _key(li, si), spec


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Nested dict of leaf shapes, in the reference package's layout."""
    check_supported(cfg)
    G, d = cfg.n_groups, cfg.d_model
    shapes: Dict[str, Any] = {"embed": (cfg.vocab, d)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.vocab, d)
    shapes["groups"] = {
        k: {"norm": {"scale": (G, d)},
            "mixer": {n: (G,) + s for n, (s, _) in
                      _MIXERS[spec.kind].param_shapes(cfg, spec).items()}}
        for k, spec in _sublayers(cfg)}
    shapes["final_norm"] = {"scale": (d,)}
    return shapes


def _is_norm_path(path) -> bool:
    return "norm" in path or "final_norm" in path


def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int, None] = None,
                device=None, dtype: torch.dtype = torch.float32):
    """Native random init with the reference's distributions (truncated
    normal, fan-in scaled; embeddings at std 0.02; norm scales ones).

    Matrices are stored in `dtype`; norm scales stay float32, as the
    kernels take them. `generator` is a torch.Generator on `device` or an
    int seed. Runs on CUDA unless `device` says otherwise."""
    dev = resolve_device(device)
    if generator is None or isinstance(generator, int):
        seed = 0 if generator is None else generator
        generator = torch.Generator(device=dev).manual_seed(seed)
    G, d = cfg.n_groups, cfg.d_model
    shapes = param_shapes(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(shapes["embed"], generator, dev, dtype)}
    if "unembed" in shapes:
        params["unembed"] = embed_init(shapes["unembed"], generator, dev,
                                       dtype)
    params["groups"] = {}
    for k, spec in _sublayers(cfg):
        mixers = [_MIXERS[spec.kind].init(cfg, spec, generator, dev, dtype)
                  for _ in range(G)]
        params["groups"][k] = {
            "norm": {"scale": torch.ones((G, d), dtype=torch.float32,
                                         device=dev)},
            "mixer": {n: torch.stack([m[n] for m in mixers])
                      for n in mixers[0]}}
    params["final_norm"] = {"scale": torch.ones((d,), dtype=torch.float32,
                                                device=dev)}
    return params


def params_from_jax(tree, cfg: ModelConfig, device=None,
                    dtype: torch.dtype = torch.float32):
    """The reference package's `init_params` output (a tree of numpy
    arrays, e.g. `jax.tree.map(np.asarray, params)`) as this port's
    parameters. Matrices are cast to `dtype`; norm scales stay float32.
    Raises ValueError when the tree does not match `cfg`."""
    dev = resolve_device(device)
    shapes = param_shapes(cfg)

    def conv(node, want, path):
        if isinstance(want, dict):
            if not isinstance(node, dict) or set(node) != set(want):
                raise ValueError(
                    f"params at {'/'.join(path) or '<root>'}: keys "
                    f"{sorted(node) if isinstance(node, dict) else node!r}"
                    f", expected {sorted(want)}")
            return {k: conv(node[k], want[k], path + (k,)) for k in want}
        arr = np.asarray(node)
        if arr.shape != tuple(want):
            raise ValueError(f"params at {'/'.join(path)}: shape "
                             f"{arr.shape}, expected {tuple(want)}")
        leaf_dtype = torch.float32 if _is_norm_path(path) else dtype
        # np.array copies: the reference's arrays may be read-only views
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=leaf_dtype)

    return conv(tree, shapes, ())


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None):
    """Zero caches, grouped like params: {"groups": {key: [G,...]},
    "tail": {}}. Runs on CUDA unless `device` says otherwise."""
    check_supported(cfg)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported yet (int8 KV waits)")
    dev = resolve_device(device)
    groups = {}
    for k, spec in _sublayers(cfg):
        if spec.kind == "attn":
            shape = (cfg.n_groups,) + attention.cache_shape(spec, batch,
                                                            max_len)
            groups[k] = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                         "v": torch.zeros(shape, dtype=dtype, device=dev)}
    return {"groups": groups, "tail": {}}


# ---------------------------------------------------------------------------
# Stack
# ---------------------------------------------------------------------------

def _sub_apply(params, x, spec, cfg: ModelConfig, ctx: Ctx, cache=None,
               residual=None):
    """One sublayer: its norm, then its mixer. `residual` is the previous
    sublayer's output (None for the first), added into the stream inside
    this norm. Returns (x, out): the stream at this sublayer's input and
    the mixer's output, which the next norm adds in."""
    if residual is None:
        h = apply_norm(params["norm"], x, cfg.norm, cfg.norm_eps, ctx.plain)
    else:
        h, x = apply_add_norm(params["norm"], x, residual, cfg.norm,
                              cfg.norm_eps, ctx.plain)
    if spec.kind == "attn":
        out, _ = attention.apply(params["mixer"], h, spec, cfg, ctx, cache)
    else:
        out = ffn.apply(params["mixer"], h, spec, cfg, ctx)
    return x, out


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def run_stack(params, x, cfg: ModelConfig, ctx: Ctx, caches=None):
    """The group stack; caches (if any) are updated in place. Returns
    (x, out): the stream before the last sublayer's residual add, and that
    sublayer's output (None for an empty stack); `_final_norm` adds them."""
    out = None
    for g in range(cfg.n_groups):
        for k, spec in _sublayers(cfg):
            p = _index(params["groups"][k], g)
            c = (_index(caches["groups"][k], g)
                 if caches is not None and k in caches["groups"] else None)
            x, out = _sub_apply(p, x, spec, cfg, ctx, c, out)
    return x, out


def _final_norm(params, cfg: ModelConfig, x, out, plain: bool):
    """The final norm of x + out, the last residual add inside it."""
    if out is None:
        return apply_norm(params["final_norm"], x, cfg.norm, cfg.norm_eps,
                          plain)
    return apply_add_norm(params["final_norm"], x, out, cfg.norm,
                          cfg.norm_eps, plain)[0]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def _embed_tokens(params, cfg: ModelConfig, tokens, dtype):
    # gather first, then cast: the same values as casting the table
    x = params["embed"][tokens].to(dtype)
    if cfg.embed_scale:
        # stays in the compute dtype (a Python scalar does not promote)
        x = x * math.sqrt(cfg.d_model)
    return x


def _logits(params, cfg: ModelConfig, x):
    table = params.get("unembed", params["embed"])
    return torch.einsum("bsd,vd->bsv", x, table.to(x.dtype))


def _positions(B: int, S: int, device, offset: int = 0):
    return (torch.arange(S, device=device) + offset)[None].expand(B, S)


def forward(params, cfg: ModelConfig, tokens,
            compute_dtype: torch.dtype = torch.bfloat16,
            plain: bool = False):
    """Train-mode forward (no cache). tokens [B,S] -> logits [B,S,V]."""
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    ctx = Ctx(mode="train", positions=_positions(B, S, tokens.device),
              compute_dtype=compute_dtype, plain=plain)
    x, out = run_stack(params, x, cfg, ctx)
    return _logits(params, cfg, _final_norm(params, cfg, x, out, plain))


def prefill(params, cfg: ModelConfig, tokens, cache,
            compute_dtype: torch.dtype = torch.bfloat16,
            last_index: Optional[int] = None, plain: bool = False):
    """Fill the cache from a prompt. tokens [B,S]. Returns (cache,
    last_logits [B,V]); the cache is updated in place.

    `last_index` selects which position's logits to return instead of the
    final one — the serving engine right-pads prompts to power-of-two
    buckets and needs the logits of the last *real* token; causality
    keeps positions < last_index unaffected by pads."""
    B, S = tokens.shape
    x = _embed_tokens(params, cfg, tokens, compute_dtype)
    ctx = Ctx(mode="prefill", positions=_positions(B, S, tokens.device),
              compute_dtype=compute_dtype, plain=plain)
    x, out = run_stack(params, x, cfg, ctx, caches=cache)
    i = S - 1 if last_index is None else int(last_index)
    # only position i reaches the logits: its row alone is summed and normed
    x_last = _final_norm(params, cfg, x[:, i:i + 1],
                         None if out is None else out[:, i:i + 1], plain)
    return cache, _logits(params, cfg, x_last)[:, 0]


def decode_step(params, cfg: ModelConfig, token, cache, index,
                compute_dtype: torch.dtype = torch.bfloat16,
                plain: bool = False):
    """One decode step. token [B,1]; index [B] per-slot fill pointers (or
    an int for all slots). Returns (cache, logits [B,V]); the cache is
    updated in place."""
    B = token.shape[0]
    x = _embed_tokens(params, cfg, token, compute_dtype)
    idx = torch.as_tensor(index, device=token.device)
    idx = (idx.expand(B) if idx.dim() == 0 else idx).to(torch.int64)
    ctx = Ctx(mode="decode", positions=idx[:, None], cache_index=idx,
              compute_dtype=compute_dtype, plain=plain)
    x, out = run_stack(params, x, cfg, ctx, caches=cache)
    return cache, _logits(params, cfg,
                          _final_norm(params, cfg, x, out, plain))[:, 0]
