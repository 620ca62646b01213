"""Dense feed-forward sublayer (SwiGLU / GeGLU / GELU / ReLU^2)."""
from __future__ import annotations

import torch

from .config import FfnSpec, ModelConfig
from .layers import ACTIVATIONS, Ctx


def param_shapes(cfg: ModelConfig, spec: FfnSpec):
    """{name: (shape, fan_in)} of one sublayer's matrices."""
    d, f = cfg.d_model, spec.d_ff
    out = {"w_in": ((d, f), d), "w_out": ((f, d), f)}
    if spec.act in ("swiglu", "geglu"):
        out["w_gate"] = ((d, f), d)
    return out


def apply(params, x, spec: FfnSpec, cfg: ModelConfig, ctx: Ctx):
    dt = ctx.compute_dtype
    h = torch.einsum("bsd,df->bsf", x, params["w_in"].to(dt))
    if spec.act in ("swiglu", "geglu"):
        act = ACTIVATIONS["silu" if spec.act == "swiglu" else "gelu"]
        g = torch.einsum("bsd,df->bsf", x, params["w_gate"].to(dt))
        h = act(g) * h
    else:
        h = ACTIVATIONS[spec.act](h)
    return torch.einsum("bsf,fd->bsd", h, params["w_out"].to(dt))
