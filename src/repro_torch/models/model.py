"""Model assembly: embedding -> group stack (+tail) -> norm -> logits.

Three entry points share one stack implementation:

  forward(...)      train-mode forward, full-sequence logits
  prefill(...)      fills the KV cache, returns last-position logits
  decode_step(...)  one-token step against the cache

Parameters are a plain dict shaped like the reference package's pytree:
group params are stacked [G, ...] under {"groups": {"L0S0": {"norm",
"mixer"}}}, beside "embed" and "final_norm" (a norm holds its "scale",
and a layernorm its "bias" too); a sublayer whose weights are
shared across the groups (zamba2's attention and FFN) is held once,
unstacked, under {"shared": {"L5S0": ...}} and absent from "groups", and
the non-repeating tail's sublayers unstacked under {"tail": {"L0S0":
...}}, and an encoder's stack under {"encoder": {"groups": {...},
"final_norm"}}. `params_from_jax` takes the reference's `init_params`
output (as numpy arrays), so both packages compute the same function;
`init_params` draws the same distributions natively on the device.
Caches are grouped
the same way: {"groups": {"L0S0": {"k": [G,B,KV,T,hd], "v": ...}},
"tail": {"L0S0": {"ssm": [B,H,N,P], "conv": [B,W-1,C]}}}; a shared
attention sublayer keeps a cache for each of its G applications, and a
cross-attention sublayer one of the encoder's rows, [G,B,KV,F,hd]. An
xLSTM stack's caches hold, a sublayer, the mLSTM's {"C": [G,B,H,P,P+1],
"conv"} or the sLSTM's {"h", "c", "n", "m": [G,B,H,P], "conv"}.

The port builds attention (with RoPE, M-RoPE or none; causal or not;
self- or cross-attention), FFN, MoE, Mamba-2 and xLSTM (mLSTM and sLSTM)
stacks under RMSNorm or LayerNorm, on text, on a vision prefix ("vlm":
precomputed patch embeddings put before the text, qwen2-vl's stub
frontend) or on audio ("audio": an encoder stack over precomputed frame
embeddings [B,F,D] with sinusoidal positions, whisper's stub frontend,
whose output the decoder's cross-attention reads). A final logit
softcap, the int8 KV cache and the attention features
`attention.check_supported` lists raise NotImplementedError.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from . import attention, ffn, moe, ssm, xlstm
from .config import ModelConfig
from .layers import (Ctx, apply_add_norm, apply_norm, dense_init,
                     embed_init, sinusoidal_positions)

_MIXERS = {"attn": attention, "ffn": ffn, "moe": moe, "mamba2": ssm,
           "mlstm": xlstm.mlstm, "slstm": xlstm.slstm}
# sublayer kinds that hold a cache (updated in place by their `apply`);
# all but attention carry recurrent state ("conv" windows in the cache
# dtype, every other leaf float32)
_CACHED = ("attn", "mamba2", "mlstm", "slstm")

# constant leaves of a mixer's `param_shapes` (an init that is not a
# fan-in), float32 whatever the weights' dtype
CONSTANTS = {
    None: lambda shape, dev: torch.ones(shape, dtype=torch.float32,
                                        device=dev),
    "zeros": lambda shape, dev: torch.zeros(shape, dtype=torch.float32,
                                            device=dev),
    # Mamba-2's decay rates, log(linspace(1, 16, H)) along the last axis,
    # in float64 and rounded once (the reference's float32 linspace and
    # log are within an ulp of it)
    "a_log": lambda shape, dev: torch.log(torch.linspace(
        1.0, 16.0, shape[-1], dtype=torch.float64, device=dev)).to(
            torch.float32).expand(shape).contiguous(),
    # the gate biases, linspace(3, 6, w) for the forget gates and zeros
    # for the others: the mLSTM's (i | f) of H each, the sLSTM's (z | i |
    # f | o) of d_model each
    "mlstm_gates": lambda shape, dev: _gate_bias(shape, dev, 1, 0),
    "slstm_gates": lambda shape, dev: _gate_bias(shape, dev, 2, 1),
}


def _gate_bias(shape, dev, before: int, after: int):
    """zeros(before * w), linspace(3, 6, w), zeros(after * w) along the
    last axis, w = shape[-1] / (before + 1 + after); in float64, rounded
    once (as a_log)."""
    w = shape[-1] // (before + 1 + after)
    f64 = dict(dtype=torch.float64, device=dev)
    bias = torch.cat([torch.zeros(before * w, **f64),
                      torch.linspace(3.0, 6.0, w, **f64),
                      torch.zeros(after * w, **f64)])
    return bias.to(torch.float32).expand(shape).contiguous()


def _key(li: int, si: int) -> str:
    return f"L{li}S{si}"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for a config this port cannot build."""
    if cfg.final_logit_softcap:
        raise NotImplementedError("final_logit_softcap is not ported yet")
    if cfg.norm not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet")
    if cfg.modality not in ("text", "vlm", "audio"):
        raise NotImplementedError(f"modality {cfg.modality!r} is not "
                                  f"ported yet")
    for spec in ([spec for *_, spec in cfg.sublayers()]
                 + [spec for _, spec in _encoder(cfg)]):
        if spec.kind not in _MIXERS:
            raise NotImplementedError(
                f"sublayer kind {spec.kind!r} is not ported yet")
        if spec.kind == "attn":
            attention.check_supported(spec)


def _keyed(layers):
    """(key, spec) of a pattern's (or a tail's) sublayers, in order."""
    for li, layer in enumerate(layers):
        for si, spec in enumerate(layer):
            yield _key(li, si), spec


def _sublayers(cfg: ModelConfig):
    """(key, spec) of the repeated group's sublayers, in pattern order."""
    return _keyed(cfg.pattern)


def _tail(cfg: ModelConfig):
    """(key, spec) of the non-repeating tail's sublayers, in order."""
    return _keyed(cfg.tail)


def _encoder(cfg: ModelConfig):
    """(key, spec) of the encoder group's sublayers (none without an
    encoder), in pattern order."""
    return _keyed(cfg.encoder.pattern if cfg.encoder is not None else ())


def _shared(spec) -> bool:
    return getattr(spec, "shared", False)


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

    def sub(spec, lead):
        return {"norm": _norm_shapes(cfg, lead),
                "mixer": _stacked(_MIXERS[spec.kind].param_shapes(cfg, spec),
                                  lead)}
    shapes["groups"] = {k: sub(spec, (G,)) for k, spec in _sublayers(cfg)
                        if not _shared(spec)}
    shared = {k: sub(spec, ()) for k, spec in _sublayers(cfg)
              if _shared(spec)}
    if shared:
        shapes["shared"] = shared
    if cfg.tail:
        shapes["tail"] = {k: sub(spec, ()) for k, spec in _tail(cfg)}
    shapes["final_norm"] = _norm_shapes(cfg, ())
    if cfg.encoder is not None:
        lead = (cfg.encoder.n_groups,)
        shapes["encoder"] = {
            "groups": {k: sub(spec, lead) for k, spec in _encoder(cfg)},
            "final_norm": _norm_shapes(cfg, ())}
    return shapes


def _norm_shapes(cfg: ModelConfig, lead: tuple):
    """A norm's leaves behind `lead`: its scale, and a layernorm's bias."""
    names = ("scale",) if cfg.norm == "rmsnorm" else ("scale", "bias")
    return {n: lead + (cfg.d_model,) for n in names}


def _norm_init(cfg: ModelConfig, lead: tuple, dev):
    """A norm's constant leaves, float32 as the reference's `norm_init`
    sets them: scale ones, a layernorm's bias zeros."""
    return {n: (torch.ones if n == "scale" else torch.zeros)(
        shape, dtype=torch.float32, device=dev)
        for n, shape in _norm_shapes(cfg, lead).items()}


def _stacked(mats, lead: tuple):
    """A mixer's {name: (shape, init)} (nested for a shared expert) as its
    shapes behind `lead`: (G,) stacked, () held once."""
    return {n: _stacked(m, lead) if isinstance(m, dict) else lead + m[0]
            for n, m in mats.items()}


def _leaves_of(mats, path=()):
    """(path, shape, init) of a mixer's leaves, in `param_shapes` order;
    init is a fan-in (a drawn matrix) or a key of CONSTANTS (a float32
    constant: None ones, "zeros", "a_log")."""
    for n, m in mats.items():
        if isinstance(m, dict):
            yield from _leaves_of(m, path + (n,))
        else:
            yield path + (n,), m[0], m[1]


def _drawn(init) -> bool:
    return isinstance(init, int)


def _is_f32_path(path) -> bool:
    """Leaves kept in float32 whatever the weights' dtype: norm scales
    (and a layernorm's biases), the qk-norm scales, as the rmsnorm kernel
    takes them, Mamba-2's decay rates, biases, skip and gated-norm scale,
    and xLSTM's gate biases and inner-norm scales."""
    return ("norm" in path or "final_norm" in path
            or path[-1] in attention.SCALES or path[-1] in ssm.F32_LEAVES
            or path[-1] in xlstm.F32_LEAVES)


def _set(tree, path, value):
    for n in path[:-1]:
        tree = tree.setdefault(n, {})
    tree[path[-1]] = value


def _at_path(tree, path):
    for n in path:
        tree = tree[n]
    return tree


# a [G] slot whose draw holds more elements than this is drawn one
# leading-axis slice (one expert) at a time: a draw holds a float32
# sample, its scaled float32 copy and the cast, about 10 B an element, so
# one of llama4-maverick's [128, 5120, 8192] expert stacks drawn whole
# would need 53.7 GB beside the weights. Slices draw different numbers
# from one whole draw, so every slot at or below the bound is drawn whole.
DRAW_SLICE_ELEMENTS = 1 << 30


def init_params(cfg: ModelConfig,
                generator: Union[torch.Generator, int, None] = None,
                device=None, dtype: torch.dtype = torch.float32):
    """Native random init with the reference's distributions (truncated
    normal, fan-in scaled; embeddings at std 0.02; norm scales ones, a
    layernorm's biases zeros).

    Matrices are stored in `dtype`; norm and qk-norm scales stay float32,
    as the kernels take them. `generator` is a torch.Generator on `device`
    or an int seed. Runs on CUDA unless `device` says otherwise. Each
    stacked weight is drawn layer by layer into its slot, and a slot above
    DRAW_SLICE_ELEMENTS one leading-axis slice at a time. An encoder's
    weights are drawn after all of the decoder's, so a config without one
    draws what it drew before encoders were ported.

    The weights depend on the device: an int seed seeds that device's own
    generator, and the CUDA and CPU generators draw different numbers
    from one seed. A caller that compares devices draws once (on the CPU,
    say) and copies the weights to the other device."""
    dev = resolve_device(device)
    if generator is None or isinstance(generator, int):
        seed = 0 if generator is None else generator
        generator = torch.Generator(device=dev).manual_seed(seed)
    shapes = param_shapes(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(shapes["embed"], generator, dev, dtype)}
    if "unembed" in shapes:
        params["unembed"] = embed_init(shapes["unembed"], generator, dev,
                                       dtype)

    def sub(spec, n):
        return _init_sublayer(cfg, spec, n, generator, dev, dtype)
    # the groups, then the shared sublayers, then the tail, each in order
    params["groups"] = {k: sub(spec, cfg.n_groups)
                        for k, spec in _sublayers(cfg) if not _shared(spec)}
    if "shared" in shapes:
        params["shared"] = {k: sub(spec, None) for k, spec in _sublayers(cfg)
                            if _shared(spec)}
    if "tail" in shapes:
        params["tail"] = {k: sub(spec, None) for k, spec in _tail(cfg)}
    params["final_norm"] = _norm_init(cfg, (), dev)
    if cfg.encoder is not None:
        params["encoder"] = {
            "groups": {k: sub(spec, cfg.encoder.n_groups)
                       for k, spec in _encoder(cfg)},
            "final_norm": _norm_init(cfg, (), dev)}
    return params


def _init_sublayer(cfg: ModelConfig, spec, n: Optional[int], generator,
                   dev, dtype):
    """One sublayer's {"norm", "mixer"}: stacked [n, ...] (n layers drawn
    layer by layer, each matrix straight into its slot, so no second copy
    of a sublayer exists), or held once when n is None. Constant leaves
    (the norm scales, qk-norm scales and Mamba-2's) are float32, as the
    reference sets them."""
    lead = () if n is None else (n,)
    leaves = list(_leaves_of(_MIXERS[spec.kind].param_shapes(cfg, spec)))
    mixer: Dict[str, Any] = {}
    for path, shape, init in leaves:
        _set(mixer, path, torch.empty(lead + shape, dtype=dtype, device=dev)
             if _drawn(init) else CONSTANTS[init](lead + shape, dev))
    for g in range(n or 1):
        for path, shape, fan_in in leaves:
            if not _drawn(fan_in):
                continue
            slot = _at_path(mixer, path)
            slot = slot if n is None else slot[g]
            if math.prod(shape) <= DRAW_SLICE_ELEMENTS:
                slot.copy_(dense_init(shape, fan_in, generator, dev, dtype))
                continue
            # one leading-axis slice (one expert) at a time
            for e in range(shape[0]):
                slot[e] = dense_init(shape[1:], fan_in, generator, dev,
                                     dtype)
    return {"norm": _norm_init(cfg, lead, dev), "mixer": mixer}


def params_from_jax(tree, cfg: ModelConfig, device=None,
                    dtype: torch.dtype = torch.float32):
    """The reference package's `init_params` output (a tree of numpy
    arrays, e.g. `jax.tree.map(np.asarray, params)`) as this port's
    parameters. Matrices are cast to `dtype`; norm and qk-norm scales stay
    float32.
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
        leaf_dtype = torch.float32 if _is_f32_path(path) else dtype
        # np.array copies: the reference's arrays may be read-only views
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=leaf_dtype)

    return conv(tree, shapes, ())


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None):
    """Zero caches, grouped like params: {"groups": {key: [G,...]},
    "tail": {key: [...]}}: attention's K and V in `dtype` (max_len rows;
    a cross-attention sublayer's, the encoder's n_frames); a recurrent
    sublayer's state (Mamba-2's, the mLSTM's C, the sLSTM's h, c, n, m)
    in float32 and its conv window in `dtype`.
    Runs on CUDA unless `device` says otherwise."""
    check_supported(cfg)
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"KV cache dtype {dtype} is not ported yet (int8 KV waits)")
    dev = resolve_device(device)
    enc_len = cfg.encoder.n_frames if cfg.encoder is not None else 0

    def sub(spec, lead):
        # FFN and MoE hold no cache
        if spec.kind == "attn":
            shape = lead + attention.cache_shape(spec, batch, max_len,
                                                 enc_len)
            return {"k": torch.zeros(shape, dtype=dtype, device=dev),
                    "v": torch.zeros(shape, dtype=dtype, device=dev)}
        if spec.kind in _CACHED:
            return {n: torch.zeros(lead + shape, device=dev,
                                   dtype=dtype if n == "conv"
                                   else torch.float32)
                    for n, shape in _MIXERS[spec.kind].cache_shapes(
                        cfg, spec, batch).items()}
        return None
    caches = {"groups": {}, "tail": {}}
    for part, subs, lead in (("groups", _sublayers(cfg), (cfg.n_groups,)),
                             ("tail", _tail(cfg), ())):
        for k, spec in subs:
            c = sub(spec, lead)
            if c is not None:
                caches[part][k] = c
    return caches


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
    mixer = _MIXERS[spec.kind]
    if spec.kind in _CACHED:
        out, _ = mixer.apply(params["mixer"], h, spec, cfg, ctx, cache)
    else:
        out = mixer.apply(params["mixer"], h, spec, cfg, ctx)
    return x, out


def _index(tree, g: int):
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    return tree[g]


def stack(params, cfg: ModelConfig, caches=None):
    """(spec, params, cache) of every sublayer in stack order: the G
    groups, each reading a shared sublayer's one weight set and its own
    slice of the stacked ones and of the caches, then the tail. The cache
    is None for a sublayer that holds none (or when `caches` is None)."""
    for g in range(cfg.n_groups):
        for k, spec in _sublayers(cfg):
            p = (params["shared"][k] if _shared(spec)
                 else _index(params["groups"][k], g))
            c = (_index(caches["groups"][k], g)
                 if caches is not None and k in caches["groups"] else None)
            yield spec, p, c
    for k, spec in _tail(cfg):
        c = (caches["tail"].get(k) if caches is not None else None)
        yield spec, params["tail"][k], c


def run_stack(params, x, cfg: ModelConfig, ctx: Ctx, caches=None):
    """The group stack, then the tail; caches (if any) are updated in
    place. Returns (x, out): the stream before the last sublayer's
    residual add, and that sublayer's output (None for an empty stack);
    `_final_norm` adds them."""
    out = None
    for spec, p, c in stack(params, cfg, caches):
        x, out = _sub_apply(p, x, spec, cfg, ctx, c, out)
    return x, out


def run_encoder(params, frames, cfg: ModelConfig, ctx: Ctx):
    """Whisper's encoder over precomputed frame embeddings frames [B,F,D]:
    the sinusoidal table (cast to the frames' dtype first, as the
    reference does) added, the encoder's groups with no cache
    (non-causal self-attention through the flash kernel), then its final
    norm. Returns [B,F,D] in the frames' dtype."""
    enc = cfg.encoder
    B, F, D = frames.shape
    x = frames + _sinusoid(F, D, frames.device, frames.dtype)[None]
    ectx = Ctx(mode="train", positions=torch.arange(
        F, device=frames.device)[None].expand(B, F),
        compute_dtype=ctx.compute_dtype, plain=ctx.plain)
    out = None
    for g in range(enc.n_groups):
        for k, spec in _encoder(cfg):
            p = _index(params["encoder"]["groups"][k], g)
            x, out = _sub_apply(p, x, spec, cfg, ectx, None, out)
    return _final_norm(params["encoder"], cfg, x, out, ctx.plain)


@functools.lru_cache(maxsize=8)
def _sinusoid(n: int, d: int, device, dtype):
    """`sinusoidal_positions(n, d)` cast to `dtype` on `device`, made once
    (the float64 table takes ~50 ms of host time at whisper's [1500,
    1024]); read-only."""
    return sinusoidal_positions(n, d).to(device=device, dtype=dtype)


def _enc_out(params, cfg: ModelConfig, frames, ctx: Ctx):
    """The encoder's output on `frames` cast to the compute dtype, for a
    config with an encoder (which needs frames), else None."""
    if cfg.encoder is None:
        return None
    if frames is None:
        raise ValueError(f"{cfg.name} has an encoder: pass frames "
                         f"[B,{cfg.encoder.n_frames},{cfg.d_model}]")
    return run_encoder(params, frames.to(ctx.compute_dtype), cfg, ctx)


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


def _mrope(cfg: ModelConfig) -> bool:
    return any(s.kind == "attn" and s.rope == "mrope"
               for _, _, _, s in cfg.sublayers())


def _positions(cfg: ModelConfig, B: int, S: int, device):
    """The default positions, the index: [B,S], or [3,B,S] (the same
    index on the t, h and w streams) for a config with M-RoPE."""
    pos = torch.arange(S, device=device)[None].expand(B, S)
    return pos[None].expand(3, B, S) if _mrope(cfg) else pos


def _decode_positions(cfg: ModelConfig, idx):
    """A decode step's positions, each slot's fill index idx [B]: [B,1],
    or [3,B,1] for M-RoPE (the reference's rule: the cache index on all
    three streams, also after a vision prefix)."""
    pos = idx[:, None]
    return pos[None].expand(3, *pos.shape) if _mrope(cfg) else pos


def _embed_inputs(params, cfg: ModelConfig, tokens, dtype, vision_embeds):
    """The embedded tokens, behind the vision prefix [B,S_vis,D] (cast to
    `dtype`) for a "vlm" config; any other config ignores it, as the
    reference does."""
    x = _embed_tokens(params, cfg, tokens, dtype)
    if cfg.modality == "vlm" and vision_embeds is not None:
        x = torch.cat([vision_embeds.to(dtype), x], dim=1)
    return x


def forward(params, cfg: ModelConfig, tokens,
            compute_dtype: torch.dtype = torch.bfloat16,
            plain: bool = False, *, vision_embeds=None, positions=None,
            frames=None):
    """Train-mode forward (no cache). tokens [B,S_tok] -> logits [B,S,V],
    S counting a "vlm" config's vision prefix `vision_embeds`
    [B,S_vis,D]. `positions` ([B,S], or [3,B,S] for M-RoPE) replaces the
    index; the mask stays index-causal. A config with an encoder takes
    `frames` [B,F,D], which its cross-attention reads through it."""
    x = _embed_inputs(params, cfg, tokens, compute_dtype, vision_embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(cfg, B, S, tokens.device)
    ctx = Ctx(mode="train", positions=positions,
              compute_dtype=compute_dtype, plain=plain)
    ctx.enc_out = _enc_out(params, cfg, frames, ctx)
    x, out = run_stack(params, x, cfg, ctx)
    return _logits(params, cfg, _final_norm(params, cfg, x, out, plain))


def prefill(params, cfg: ModelConfig, tokens, cache,
            compute_dtype: torch.dtype = torch.bfloat16,
            last_index: Optional[int] = None, plain: bool = False, *,
            vision_embeds=None, positions=None, frames=None):
    """Fill the cache from a prompt. tokens [B,S_tok], behind a "vlm"
    config's vision prefix `vision_embeds` [B,S_vis,D]; `positions`
    replaces the index, as in `forward`. A config with an encoder runs it
    on `frames` [B,F,D] (cast to the compute dtype) and fills its
    cross-attention caches from its output. Returns (cache, last_logits
    [B,V]); the cache is updated in place.

    `last_index` selects which position's logits to return instead of the
    final one, counted over the whole sequence, prefix included — the
    serving engine right-pads prompts to power-of-two buckets and needs
    the logits of the last *real* token; causality keeps positions <
    last_index unaffected by pads."""
    x = _embed_inputs(params, cfg, tokens, compute_dtype, vision_embeds)
    B, S, _ = x.shape
    if positions is None:
        positions = _positions(cfg, B, S, tokens.device)
    ctx = Ctx(mode="prefill", positions=positions,
              compute_dtype=compute_dtype, plain=plain)
    ctx.enc_out = _enc_out(params, cfg, frames, ctx)
    x, out = run_stack(params, x, cfg, ctx, caches=cache)
    i = S - 1 if last_index is None else int(last_index)
    # only position i reaches the logits: its row alone is summed and normed
    x_last = _final_norm(params, cfg, x[:, i:i + 1],
                         None if out is None else out[:, i:i + 1], plain)
    return cache, _logits(params, cfg, x_last)[:, 0]


def decode_step(params, cfg: ModelConfig, token, cache, index,
                compute_dtype: torch.dtype = torch.bfloat16,
                plain: bool = False, active=None):
    """One decode step. token [B,1]; index [B] per-slot fill pointers (or
    an int for all slots), also the step's positions (on all three
    streams for M-RoPE); `active` [B] bool, the slots that decode (None:
    every slot): a recurrent sublayer writes its new state only there, so
    a parked slot's state holds (attention writes every slot's K/V at its
    pending position, which the next real decode rewrites; a
    cross-attention sublayer reads the encoder's K/V that prefill cached,
    so a step takes no frames). Returns (cache, logits [B,V]); the cache
    is updated in place."""
    B = token.shape[0]
    x = _embed_tokens(params, cfg, token, compute_dtype)
    idx = torch.as_tensor(index, device=token.device)
    idx = (idx.expand(B) if idx.dim() == 0 else idx).to(torch.int64)
    if active is not None:
        active = torch.as_tensor(active, device=token.device)
    ctx = Ctx(mode="decode", positions=_decode_positions(cfg, idx),
              cache_index=idx, compute_dtype=compute_dtype, plain=plain,
              active=active)
    x, out = run_stack(params, x, cfg, ctx, caches=cache)
    return cache, _logits(params, cfg,
                          _final_norm(params, cfg, x, out, plain))[:, 0]
