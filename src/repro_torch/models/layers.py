"""Shared building blocks: norms, RoPE, sinusoidal positions,
initializers, context."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.rmsnorm.ops import add_rmsnorm, rmsnorm
from ..kernels.rmsnorm.ref import reference_add_rmsnorm, reference_rmsnorm


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through every sublayer."""

    mode: str                          # "train" | "prefill" | "decode"
    positions: torch.Tensor            # [B,S] int64; [3,B,S] for M-RoPE
    cache_index: Optional[torch.Tensor] = None   # [B] int64 fill pointers
    compute_dtype: torch.dtype = torch.bfloat16
    # True: the plain PyTorch versions of the kernels, on any device (the
    # on-card reference the kernels are held against). False: the kernel
    # wrappers, which launch the kernels on CUDA tensors.
    plain: bool = False
    # decode: [B] bool of the slots that decode; a recurrent sublayer
    # writes its new state only there (None: every slot)
    active: Optional[torch.Tensor] = None
    # the encoder's output [B,F,D], which cross-attention projects to its
    # K/V at prefill (None: no encoder, or a decode step, which reads
    # them from the cache)
    enc_out: Optional[torch.Tensor] = None


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

def layer_norm(x, params, eps: float):
    """LayerNorm as the reference computes it: float32 mean and variance,
    (x - mean) * rsqrt(var + eps) * scale + bias, out in x.dtype. No TPU
    kernel computes it (the reference runs it in jnp), so these plain
    float32 ops are its port, on the card as on the CPU."""
    xf = x.float()
    centred = xf - xf.mean(dim=-1, keepdim=True)
    var = (centred * centred).mean(dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def apply_norm(params, x, kind: str, eps: float, plain: bool = False):
    """The norm in f32, output in x.dtype: RMSNorm ("rmsnorm") through the
    rmsnorm kernel (or its plain version when `plain`), any other kind
    LayerNorm, as the reference reads it, through `layer_norm`."""
    if kind != "rmsnorm":
        return layer_norm(x, params, eps)
    fn = reference_rmsnorm if plain else rmsnorm
    return fn(x, params["scale"], eps)


def apply_add_norm(params, x, residual, kind: str, eps: float,
                   plain: bool = False):
    """The residual add and the norm after it: (norm(x + residual),
    x + residual), the sum in x.dtype and the norm read from it: in one
    launch of the rmsnorm kernel (or its plain version when `plain`), or
    the sum, then `layer_norm`, for LayerNorm."""
    if kind != "rmsnorm":
        summed = x + residual
        return layer_norm(summed, params, eps), summed
    fn = reference_add_rmsnorm if plain else add_rmsnorm
    return fn(x, residual, params["scale"], eps)


def rms_norm_heads(x, scale, eps: float = 1e-6, plain: bool = False):
    """RMSNorm of contiguous rows: per-head q/k norm (qwen3) at head_dim,
    and Mamba-2's gated norm at float32 rows of d_in. x [..., D]
    contiguous, scale [D] float32; the rmsnorm kernel's function on rows
    of D (or its plain version when `plain`)."""
    fn = reference_rmsnorm if plain else rmsnorm
    return fn(x, scale, eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(half: int, theta: float, device):
    """The rotary frequencies theta^(-i/half), i < half, in f32."""
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def _rotate(x, ang):
    """x [B,S,H,D] rotated by angles ang [B,S,D/2] in f32: pairs (x_i,
    x_{i+half}), out in x's dtype."""
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x [B,S,H,D]; positions [B,S]. Rotates pairs (x_i, x_{i+half})."""
    freqs = _rope_freqs(x.shape[-1] // 2, theta, positions.device)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions, theta: float, sections):
    """M-RoPE (qwen2-vl): x [B,S,H,D]; positions [3,B,S] (t, h, w). The
    D/2 frequencies split into `sections` bands, band j rotated by
    stream j; with three equal streams this is `apply_rope` bit for
    bit."""
    half = x.shape[-1] // 2
    assert sum(sections) == half, (sections, half)
    pos = positions.float()
    # each frequency's position: stream j over the j-th band, [B,S,half]
    # (broadcast views, so no index tensor reaches the device)
    pos = torch.cat([pos[j, ..., None].expand(*pos.shape[1:], n)
                     for j, n in enumerate(sections)], dim=-1)
    return _rotate(x, pos * _rope_freqs(half, theta, positions.device))


def sinusoidal_positions(n: int, d: int):
    """Absolute sinusoidal table [n, d] float32 (whisper's encoder), the
    reference's: computed in float64 numpy, rounded once."""
    pos = np.arange(n)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(out.astype(np.float32))


# ---------------------------------------------------------------------------
# Activations (jax.nn.gelu's default is the tanh approximation)
# ---------------------------------------------------------------------------

ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
    "silu": F.silu,
}
