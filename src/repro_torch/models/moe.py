"""Mixture-of-experts sublayer with top-k routing and static capacity.

On one device the reference's expert-parallel `shard_map` (both its
strategies, `local_moe` and `local_moe_tokens`) computes one function:
route every token globally, dispatch each kept choice into a static
[E, C, D] capacity buffer, run every expert's FFN over its buffer as one
batched product, and combine the outputs by gate weight. This module
computes that function locally.

Capacity is static: C = max(ceil(capacity_factor * T * top_k / E), 4),
where T is the call's own token count (pads of a prefill bucket and the
dead slots of a decode grid included: they route like any token). A
choice is kept when fewer earlier choices went to its expert, earlier in
token-major order over the flattened [T * K] choices; a dropped choice
adds nothing (its gate mass is lost through the residual stream,
GShard-style).

The expert FFN reads every expert's weights on every call, routed or
not: three `torch.bmm` products over the capacity buffer. The reference
computes these products outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch

from . import ffn
from .config import FfnSpec, ModelConfig, MoeSpec
from .layers import ACTIVATIONS, Ctx


def _shared_spec(spec: MoeSpec) -> FfnSpec:
    return FfnSpec(d_ff=spec.shared_d_ff, act=spec.act)


def param_shapes(cfg: ModelConfig, spec: MoeSpec):
    """{name: (shape, fan_in)} of one sublayer's leaves, in the reference's
    layout; the always-on shared expert's are nested under "shared"."""
    d, f, e = cfg.d_model, spec.d_ff, spec.n_experts
    out = {"router": ((d, e), d), "w_in": ((e, d, f), d),
           "w_out": ((e, f, d), f)}
    if spec.act in ("swiglu", "geglu"):
        out["w_gate"] = ((e, d, f), d)
    if spec.shared_d_ff:
        out["shared"] = ffn.param_shapes(cfg, _shared_spec(spec))
    return out


def capacity(spec: MoeSpec, n_tokens: int) -> int:
    """Slots an expert has in a call of `n_tokens` tokens."""
    return max(int(math.ceil(
        spec.capacity_factor * n_tokens * spec.top_k / spec.n_experts)), 4)


def route(params, x, spec: MoeSpec, ctx: Ctx):
    """Global routing. x [B,S,D] -> (gates [B,S,K] in the compute dtype,
    expert ids [B,S,K] int64): the router product in the compute dtype,
    softmax in float32, top-k (an exact tie keeps the lower id, as
    `jax.lax.top_k` does), the kept gates renormalised when k > 1.

    In train mode it adds the reference's auxiliary losses to
    `ctx.aux["moe_aux_loss"]`: the Switch load-balance term E * sum_e
    f_e p_e (f_e the share of tokens whose first choice is e, p_e the
    mean router probability) times `aux_loss_weight`, plus 1e-4 times the
    router z-loss mean(logsumexp(logits)^2). Serving computes neither."""
    logits = torch.einsum("bsd,de->bse", x,
                          params["router"].to(ctx.compute_dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :spec.top_k], idx[..., :spec.top_k]
    if spec.top_k > 1:                              # renormalise kept mass
        gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    if ctx.mode == "train":
        e = spec.n_experts
        sel = torch.nn.functional.one_hot(idx[..., 0], e).float()
        f_e = sel.mean(dim=(0, 1))
        p_e = probs.mean(dim=(0, 1))
        aux = e * torch.sum(f_e * p_e)
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
        ctx.add_aux("moe_aux_loss", spec.aux_loss_weight * aux + 1e-4 * z)
    return gates.to(ctx.compute_dtype), idx


def dispatch(idx, n_experts: int, cap: int):
    """Static-capacity dispatch of choices idx [T,K]: (slot [T,K], each
    choice's row of the flattened [E * cap] buffer, and keep [T,K]). A
    choice's position in its expert counts the choices of that expert
    before it in token-major order (the reference's cumsum over a [T*K, E]
    one-hot); it is kept below `cap`. A stable sort by expert keeps that
    order within each expert, so a choice's position is its rank in the
    sort less its expert's first rank."""
    flat = idx.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_experts)
    first = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel(), device=flat.device) \
        - first[flat[order]]
    keep = pos < cap
    slot = flat * cap + pos
    return slot.reshape(idx.shape), keep.reshape(idx.shape)


def _expert_ffn(buf, params, act: str, dt):
    """buf [E,C,D] -> [E,C,D], every expert at once; each weight stack is
    in the compute dtype only while its product runs."""
    h = torch.bmm(buf, params["w_in"].to(dt))
    if "w_gate" in params:
        a = ACTIVATIONS["silu" if act == "swiglu" else "gelu"]
        h = a(torch.bmm(buf, params["w_gate"].to(dt))) * h
    else:
        h = ACTIVATIONS["gelu"](h)
    return torch.bmm(h, params["w_out"].to(dt))


def apply(params, x, spec: MoeSpec, cfg: ModelConfig, ctx: Ctx):
    """x [B,S,D] (normed); returns the MoE output [B,S,D]."""
    B, S, D = x.shape
    dt = ctx.compute_dtype
    E, K = spec.n_experts, spec.top_k
    gates, idx = route(params, x, spec, ctx)
    T = B * S
    cap = capacity(spec, T)
    slot, keep = dispatch(idx.reshape(T, K), E, cap)
    keep = keep.reshape(-1, 1)
    # a dropped choice writes the spare last row and reads zeros: no
    # data-dependent shapes, so the card is never waited on
    rows = torch.where(keep[:, 0], slot.reshape(-1), E * cap)
    src = torch.arange(T * K, device=x.device) // K          # choice's token
    buf = torch.zeros(E * cap + 1, D, dtype=dt, device=x.device)
    buf[rows] = x.reshape(T, D)[src].to(dt)
    out = _expert_ffn(buf[:-1].view(E, cap, D), params, spec.act, dt)
    got = torch.where(keep, out.reshape(E * cap, D)[
        rows.clamp(max=E * cap - 1)], 0)
    y = (got.reshape(T, K, D) * gates.reshape(T, K, 1)).sum(1)
    y = y.reshape(B, S, D)
    if spec.shared_d_ff:
        y = y + ffn.apply(params["shared"], x, _shared_spec(spec), cfg, ctx)
    return y
