"""AdamW with decoupled weight decay, global-norm clipping, cosine/linear
schedules, and optional int8 error-feedback gradient compression: the
reference package's `optim/adamw.py` in plain tensor code.

Trees are nested dicts of tensors (the model's parameters). The state is
{step, mu, nu} (+ {err} when compression is on): `step` an int32 scalar,
the moments float32 beside each parameter on its device. No
`torch.optim`: the numbers follow the reference's formulas op for op, in
float32. `apply_updates` updates the parameters and the state in place
(at full width a second copy of the float32 weights and both moments
would not fit beside them) and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    schedule: str = "cosine"           # "cosine" | "linear" | "constant"
    # int8 error-feedback DP gradient compression (0 = off)
    compress_bits: int = 0


def leaves(tree) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict, keys in sorted order at every level
    (the reference's `jax.tree.leaves` order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for path, leaf in leaves(tree[k]):
                yield (k,) + path, leaf
    else:
        yield (), tree


def tree_map(fn, tree, *rest):
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def schedule_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or an integer tensor), float32:
    linear warmup, then cosine or linear decay to min_lr_frac (or
    constant)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) \
            * 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1.0 - cfg.min_lr_frac) * frac
    else:
        decay = 1.0
    return cfg.peak_lr * warm * decay


def init_state(params, cfg: AdamWConfig) -> Dict[str, Any]:
    """Zero moments (float32, on each parameter's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(leaves(params))[1].device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}
    if cfg.compress_bits:
        state["err"] = tree_map(zeros, params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares, in float32, leaf
    by leaf in the reference's order."""
    total = 0
    for _, leaf in leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def compress_int8(g, err):
    """Error-feedback int8 quantization of a gradient leaf: (the
    dequantized gradient, the new error), the reference's formula (the
    largest magnitude at 127, round half to even)."""
    gf = g.to(torch.float32) + err
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, gf - deq


@torch.no_grad()
def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step: params, mu and nu (and err) updated in place, each
    parameter in its own dtype. Returns (params, state, metrics {"lr",
    "grad_norm"})."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.clip_norm else 1.0

    if cfg.compress_bits:
        def compress(g, err):
            deq, new_err = compress_int8(g, err)
            err.copy_(new_err)
            return deq
        grads = tree_map(compress, grads, state["err"])

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * scale
        mu.copy_(b1 * mu + (1 - b1) * g)
        nu.copy_(b2 * nu + (1 - b2) * g * g)
        u = (mu / c1) / (torch.sqrt(nu / c2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * u).to(p.dtype))

    tree_map(upd, params, grads, state["mu"], state["nu"])
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
