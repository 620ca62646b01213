"""Mamba-2 (state-space duality) sublayer, with the chunked linear-
recurrence core an xLSTM mLSTM block shares.

The SSD recurrence  S_t = a_t * S_t-1 + g_t * (k_t ⊗ v_t),  y_t = q_t · S_t
runs in the chunked dual form at prefill (and the train forward): within
a chunk of Q positions the output is a masked quadratic form, across
chunks only the [N,P] states pass, one chunk after another. A decode step
runs the recurrence for its one token against the cached state.

All recurrence math runs in float32 whatever the compute dtype, as in the
reference package. The reference computes this sublayer in jnp, with no
Pallas kernel: only its gated norm reaches a kernel here, the rmsnorm
kernel on float32 rows of d_in.

The cache ({"ssm": float32 [B,H,N,P], "conv": [B,W-1,C] in the cache
dtype}) is updated in place. A decode step writes the new state only for
the slots `ctx.active` marks (every slot when it is None): a parked slot's
state holds while the grid decodes around it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import Mamba2Spec, ModelConfig
from .layers import Ctx, rms_norm_heads

# leaves kept in float32 whatever the weights' dtype: the decay rates,
# biases, skip and gated-norm scale (a bf16 a_log moves every decay rate)
F32_LEAVES = ("a_log", "dt_bias", "d_skip", "norm_scale", "conv_b")


# ---------------------------------------------------------------------------
# Depthwise causal conv1d (shared by the mamba2 and xlstm blocks)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b, state=None):
    """x [B,S,C]; w [W,C]; b [C]; state [B,W-1,C] or None (zeros).

    Returns (silu(conv + b) [B,S,C] in x's dtype, new_state [B,W-1,C]: the
    last W-1 inputs, in x's dtype). The conv is a cross-correlation, as
    XLA's is: y_t = sum_i in_{t+i} w_i over the state-prefixed input."""
    B, S, C = x.shape
    W = w.shape[0]
    xf = x.float()
    if state is None:
        ctx_in = F.pad(xf, (0, 0, W - 1, 0))
    else:
        ctx_in = torch.cat([state.float(), xf], dim=1)
    # [B,S,C,W] windows times the taps, summed over the window
    y = (ctx_in.unfold(1, W, 1) * w.float().t()).sum(-1)
    y = F.silu(y + b.float())
    new_state = ctx_in[:, ctx_in.shape[1] - (W - 1):]
    return y.to(x.dtype), new_state.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked SSD core
# ---------------------------------------------------------------------------

def chunked_ssd(q, k, v, logf, gate, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """Linear recurrence in chunked dual form.

    q, k [B,S,H,N]; v [B,S,H,P]; logf, gate [B,S,H] (logf <= 0).
    Returns (y [B,S,H,P] in v's dtype, final_state float32 [B,H,N,P])."""
    B, S, H, N = q.shape
    P = v.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S
    f32 = torch.float32
    out_dtype = v.dtype

    def rs(a):
        if pad:
            a = F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        return a.reshape(B, nc, Q, *a.shape[2:]).to(f32)
    qc, kc, vc, fc, gc = map(rs, (q, k, v, logf, gate))

    cum = torch.cumsum(fc, dim=2)                      # [B,NC,Q,H]
    total = cum[:, :, -1]                              # [B,NC,H]
    # decay from j to i (i >= j): exp(cum_i - cum_j), masked BEFORE the
    # exp: above-diagonal differences are positive and can overflow
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # [B,NC,Qi,Qj,H]
    tri = torch.ones(Q, Q, dtype=torch.bool, device=q.device).tril()
    L = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                              torch.tensor(-1e30, dtype=f32,
                                           device=q.device)))

    # intra-chunk: y_i = sum_{j<=i} (q_i . k_j) L_ij g_j v_j
    s = torch.einsum("bcihn,bcjhn->bcijh", qc, kc) * L \
        * gc[:, :, None, :, :]
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", s, vc)

    # chunk states: S_c = sum_j exp(total - cum_j) g_j k_j (x) v_j, as two
    # two-operand products (the weights go into k first)
    w = torch.exp(total[:, :, None, :] - cum) * gc    # [B,NC,Q,H]
    states = torch.einsum("bcjhn,bcjhp->bchnp", w[..., None] * kc, vc)

    # pass the states across chunks, one chunk after another
    decay = torch.exp(total)                           # [B,NC,H]
    st = (torch.zeros(B, H, N, P, dtype=f32, device=q.device)
          if init_state is None else init_state.to(f32))
    prevs = []
    for c in range(nc):
        prevs.append(st)
        st = decay[:, c, :, None, None] * st + states[:, c]
    prev = torch.stack(prevs, dim=1)                   # [B,NC,H,N,P]

    # inter-chunk contribution: y_i += exp(cum_i) q_i . S_prev
    y_inter = torch.einsum("bcihn,bchnp->bcihp",
                           qc * torch.exp(cum)[..., None], prev)
    y = (y_intra + y_inter).reshape(B, nc * Q, H, P)
    if pad:
        y = y[:, :S]
    return y.to(out_dtype), st


def ssd_decode_step(q, k, v, logf, gate, state):
    """Single-token recurrence. q,k [B,H,N]; v [B,H,P]; logf, gate [B,H];
    state float32 [B,H,N,P]. Returns (y float32 [B,H,P], new_state)."""
    q, k, v = q.float(), k.float(), v.float()
    a = torch.exp(logf.float())[:, :, None, None]
    new_state = a * state + (gate.float()[:, :, None, None]
                             * k[..., None] * v[:, :, None, :])
    y = torch.einsum("bhn,bhnp->bhp", q, new_state)
    return y, new_state


# ---------------------------------------------------------------------------
# Mamba-2 sublayer
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig, spec: Mamba2Spec):
    d_in = spec.expand * cfg.d_model
    n_heads = d_in // spec.head_dim
    conv_dim = d_in + 2 * spec.n_groups * spec.d_state
    return d_in, n_heads, conv_dim


def param_shapes(cfg: ModelConfig, spec: Mamba2Spec):
    """{name: (shape, init)} of one sublayer's leaves: init a fan-in for a
    drawn matrix, or a constant (`model.CONSTANTS`): ones, zeros, or
    a_log's log(linspace(1, 16, H))."""
    d = cfg.d_model
    d_in, H, conv_dim = _dims(cfg, spec)
    proj_out = 2 * d_in + 2 * spec.n_groups * spec.d_state + H  # z x B C dt
    return {
        "w_in": ((d, proj_out), d),
        "conv_w": ((spec.d_conv, conv_dim), spec.d_conv),
        "conv_b": ((conv_dim,), "zeros"),
        "a_log": ((H,), "a_log"),
        "dt_bias": ((H,), "zeros"),
        "d_skip": ((H,), None),
        "norm_scale": ((d_in,), None),
        "w_out": ((d_in, d), d_in),
    }


def cache_shapes(cfg: ModelConfig, spec: Mamba2Spec, batch: int):
    """{leaf: shape} of one sublayer's cache: "ssm" (float32 always) and
    "conv" (the cache dtype)."""
    d_in, H, conv_dim = _dims(cfg, spec)
    return {"ssm": (batch, H, spec.d_state, spec.head_dim),
            "conv": (batch, spec.d_conv - 1, conv_dim)}


def apply(params, x, spec: Mamba2Spec, cfg: ModelConfig, ctx: Ctx,
          cache=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,D] (normed). Returns (out [B,S,D], cache); the cache is
    updated in place. Prefill starts from zero state, as the reference's
    does; decode (S == 1) steps the cached state (`_decode`)."""
    if cache is not None and ctx.mode == "decode":
        return _decode(params, x, spec, cfg, ctx, cache), cache
    B, S, D = x.shape
    d_in, H, conv_dim = _dims(cfg, spec)
    G, N, P = spec.n_groups, spec.d_state, spec.head_dim
    dt_ = ctx.compute_dtype

    proj = torch.einsum("bsd,de->bse", x, params["w_in"].to(dt_))
    # split: z [d_in] | conv block [conv_dim] = x + B + C | dt [H]
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + conv_dim]
    dt_raw = proj[..., d_in + conv_dim:]

    xbc, new_conv = causal_conv1d(xbc, params["conv_w"], params["conv_b"])
    xs = xbc[..., :d_in].reshape(B, S, H, P)
    Bm = xbc[..., d_in:d_in + G * N].reshape(B, S, G, N)
    Cm = xbc[..., d_in + G * N:].reshape(B, S, G, N)
    # broadcast the B/C groups to heads (each group's H // G heads in turn)
    Bh = Bm[:, :, :, None].expand(B, S, G, H // G, N).reshape(B, S, H, N)
    Ch = Cm[:, :, :, None].expand(B, S, G, H // G, N).reshape(B, S, H, N)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])
    logf = -torch.exp(params["a_log"]) * dt             # [B,S,H]
    y, new_ssm = chunked_ssd(Ch, Bh, xs, logf, dt, spec.chunk)

    y = y + xs * params["d_skip"][None, None, :, None].to(y.dtype)
    out = _gated_out(params, y.reshape(B, S, d_in), z, cfg, ctx)
    if cache is not None:
        cache["ssm"].copy_(new_ssm)
        cache["conv"].copy_(new_conv)
    return out, cache


def _gated_out(params, y, z, cfg: ModelConfig, ctx: Ctx):
    """The gated RMSNorm (mamba2 style) on float32 rows of d_in, y *
    silu(z), through the rmsnorm kernel, then the out-projection."""
    dt_ = ctx.compute_dtype
    yf = y.float() * F.silu(z.float())
    yf = rms_norm_heads(yf, params["norm_scale"], cfg.norm_eps, ctx.plain)
    return torch.matmul(yf.to(dt_), params["w_out"].to(dt_))


def _decode(params, x, spec: Mamba2Spec, cfg: ModelConfig, ctx: Ctx,
            cache):
    """`apply` at a decode step (S == 1): the reference's function
    (causal_conv1d on the cached window, then ssd_decode_step) in fewer
    launches, the state updated in place. A slot that `ctx.active` leaves
    out keeps its state and window bit for bit: its decay is 1 and its
    input 0 (state * 1 + 0 is the state), and its window is not
    shifted."""
    B = x.shape[0]
    d_in, H, conv_dim = _dims(cfg, spec)
    G, N, P = spec.n_groups, spec.d_state, spec.head_dim
    dt_ = ctx.compute_dtype
    active = ctx.active

    proj = torch.matmul(x[:, 0], params["w_in"].to(dt_))      # [B, E]
    z = proj[:, :d_in]
    dt_raw = proj[:, d_in + conv_dim:]
    # the conv window: the cached W-1 inputs and this one, in the compute
    # dtype; silu(conv + b) in float32, rounded to the compute dtype
    conv = cache["conv"]
    win = torch.cat([conv.to(dt_), proj[:, None, d_in:d_in + conv_dim]],
                    dim=1)                                      # [B, W, C]
    xbc = F.silu((win.float() * params["conv_w"].float()).sum(1)
                 + params["conv_b"].float()).to(dt_).float()
    xs = xbc[:, :d_in].view(B, H, P)
    k = xbc[:, d_in:d_in + G * N].view(B, G, 1, N)
    q = xbc[:, d_in + G * N:].view(B, G, 1, 1, N)

    dt = F.softplus(dt_raw.float() + params["dt_bias"])        # [B, H]
    a = torch.exp(-torch.exp(params["a_log"]) * dt)
    if active is not None:
        act = active[:, None]
        a = torch.where(act, a, 1.0)
        dt = torch.where(act, dt, 0.0)
    # state = a * state + (dt * k) (x) v, each group's heads together
    st = cache["ssm"]
    gk = (dt.view(B, G, H // G, 1) * k).view(B, H, N)
    st.mul_(a[:, :, None, None]).add_(gk[..., None] * xs[:, :, None, :])
    y = torch.matmul(q, st.view(B, G, H // G, N, P)).view(B, H, P)

    y = y + xs * params["d_skip"][None, :, None]
    out = _gated_out(params, y.view(B, d_in), z, cfg, ctx)
    if active is None:
        conv.copy_(win[:, 1:])
    else:
        conv.copy_(torch.where(active[:, None, None], win[:, 1:].to(
            conv.dtype), conv))
    return out[:, None]
