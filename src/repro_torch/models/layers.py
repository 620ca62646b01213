"""Shared building blocks: norms, RoPE, initializers, context."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import add_rmsnorm, rmsnorm
from ..kernels.rmsnorm.ref import reference_add_rmsnorm, reference_rmsnorm


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through every sublayer."""

    mode: str                          # "train" | "prefill" | "decode"
    positions: torch.Tensor            # [B,S] int64
    cache_index: Optional[torch.Tensor] = None   # [B] int64 fill pointers
    compute_dtype: torch.dtype = torch.bfloat16
    # True: the plain PyTorch versions of the kernels, on any device (the
    # on-card reference the kernels are held against). False: the kernel
    # wrappers, which launch the kernels on CUDA tensors.
    plain: bool = False


# ---------------------------------------------------------------------------
# Initializers (truncated normal in [-2, 2] standard deviations, scaled:
# the reference package's distributions)
# ---------------------------------------------------------------------------

def _trunc_normal(shape, std, generator, device, dtype):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * std).to(dtype)


def dense_init(shape, fan_in, generator, device, dtype=torch.float32):
    return _trunc_normal(shape, 1.0 / math.sqrt(max(fan_in, 1)), generator,
                         device, dtype)


def embed_init(shape, generator, device, dtype=torch.float32, std=0.02):
    return _trunc_normal(shape, std, generator, device, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def apply_norm(params, x, kind: str, eps: float, plain: bool = False):
    """RMSNorm in f32, output in x.dtype, through the rmsnorm kernel (or
    its plain version when `plain`)."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    fn = reference_rmsnorm if plain else rmsnorm
    return fn(x, params["scale"], eps)


def apply_add_norm(params, x, residual, kind: str, eps: float,
                   plain: bool = False):
    """The residual add and the norm after it: (norm(x + residual),
    x + residual), the sum in x.dtype and the norm read from it, in one
    launch of the rmsnorm kernel (or its plain version when `plain`)."""
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    fn = reference_add_rmsnorm if plain else add_rmsnorm
    return fn(x, residual, params["scale"], eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_angles(positions, dim: int, theta: float):
    """positions [...]; returns (sin, cos) each [..., dim/2] in f32."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions[..., None].float() * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, positions, theta: float):
    """x [B,S,H,D]; positions [B,S]. Rotates pairs (x_i, x_{i+half})."""
    d = x.shape[-1]
    sin, cos = _rope_angles(positions, d, theta)       # [B,S,half]
    sin = sin[:, :, None, :]
    cos = cos[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Activations (jax.nn.gelu's default is the tanh approximation)
# ---------------------------------------------------------------------------

ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
    "silu": F.silu,
}
