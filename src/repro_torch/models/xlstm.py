"""xLSTM sublayers: mLSTM (matrix memory, on the chunked SSD core the
Mamba-2 sublayer shares) and sLSTM (scalar memory, a recurrence over the
tokens with block-diagonal recurrent weights).

mLSTM is linear attention with exponential input gates and sigmoid forget
gates. Its recurrence is `ssm.chunked_ssd`'s (`ssm.ssd_decode_step`'s at
a decode step) with the key width N = the head width P, and v augmented with a ones column, so the normaliser
travels in the same state (h = num / max(|den|, 1)). Its state C is
float32 [B,H,P,P+1].

sLSTM's gates read h_{t-1}, so its prefill steps token by token: the input
projections (the bulk of its products) run for every position first, and
each step is one batched product over the heads ([H,B,P] x [H,P,4P]) and
the cell's elementwise updates, in place (on CUDA, whole chunks of steps
replay one captured CUDA graph: `scan`). Its state is h, c, n and m,
float32 [B,H,P] each.

Each module is an interface as `ssm` is (`param_shapes`, `cache_shapes`,
`apply`): `mlstm` and `slstm` below. The reference computes both in jnp,
with no Pallas kernel: only their inner norms reach a kernel here, the
rmsnorm kernel on float32 rows (d_in for mLSTM, d_model for sLSTM).

Prefill starts from zero state, as the reference's does, and writes the
new state into the cache in place. A decode step (S == 1) writes the new
state only for the slots `ctx.active` marks (every slot when it is None):
a parked slot's state and conv window hold while the grid decodes around
it.
"""
from __future__ import annotations

import math
import types
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import MLstmSpec, ModelConfig, SLstmSpec
from .layers import ACTIVATIONS, Ctx, rms_norm_heads
from .ssm import causal_conv1d, chunked_ssd, ssd_decode_step

IGATE_CLAMP = 10.0    # exp input-gate stabilization (in lieu of m-state)
# leaves kept in float32 whatever the weights' dtype, beside the
# `ssm.F32_LEAVES` both sublayers share (conv_b, norm_scale)
F32_LEAVES = ("b_gates", "gn_scale")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_dims(cfg: ModelConfig, spec: MLstmSpec):
    d_in = int(spec.proj_factor * cfg.d_model)
    H = spec.n_heads
    return d_in, H, d_in // H


def mlstm_param_shapes(cfg: ModelConfig, spec: MLstmSpec):
    """{name: (shape, init)} of one mLSTM sublayer's leaves: a fan-in for a
    drawn matrix, or a constant of `model.CONSTANTS`."""
    d = cfg.d_model
    d_in, H, _ = _mlstm_dims(cfg, spec)
    return {
        "w_up": ((d, 2 * d_in), d),
        "conv_w": ((spec.d_conv, d_in), spec.d_conv),
        "conv_b": ((d_in,), "zeros"),
        "wq": ((d_in, d_in), d_in),
        "wk": ((d_in, d_in), d_in),
        "wv": ((d_in, d_in), d_in),
        "w_gates": ((d_in, 2 * H), d_in),
        "b_gates": ((2 * H,), "mlstm_gates"),
        "norm_scale": ((d_in,), None),
        "w_down": ((d_in, d), d_in),
    }


def mlstm_cache_shapes(cfg: ModelConfig, spec: MLstmSpec, batch: int):
    """{leaf: shape}: "C" (float32 always) and "conv" (the cache dtype)."""
    d_in, H, P = _mlstm_dims(cfg, spec)
    return {"C": (batch, H, P, P + 1),
            "conv": (batch, spec.d_conv - 1, d_in)}


def _mlstm_gates(params, uc, H: int):
    """(log forget gate, input gate) float32 [..., H] from the conv'd
    input: the product in the compute dtype, then float32 plus b_gates."""
    gates = torch.matmul(uc, params["w_gates"].to(uc.dtype)).float() \
        + params["b_gates"]
    igate = torch.exp(torch.clamp_max(gates[..., :H], IGATE_CLAMP))
    return F.logsigmoid(gates[..., H:]), igate


def _mlstm_out(params, y, og, cfg: ModelConfig, ctx: Ctx, P: int):
    """h = num / max(|den|, 1) in float32 from y [..., H, P+1], the inner
    RMSNorm on float32 rows of d_in through the rmsnorm kernel, then the
    output gate silu(og) and the down-projection."""
    dt_ = ctx.compute_dtype
    h = y[..., :P].float() / torch.clamp_min(y[..., P:].float().abs(), 1.0)
    h = rms_norm_heads(h.reshape(og.shape), params["norm_scale"],
                       cfg.norm_eps, ctx.plain)
    h = h.to(dt_) * F.silu(og)
    return torch.matmul(h, params["w_down"].to(dt_))


def mlstm_apply(params, x, spec: MLstmSpec, cfg: ModelConfig, ctx: Ctx,
                cache=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,D] (normed). Returns (out [B,S,D], cache); the cache is
    updated in place. q and k come from the conv'd half of the up-
    projection, v from the half before the conv; k is scaled by
    1/sqrt(P)."""
    if cache is not None and ctx.mode == "decode":
        return _mlstm_decode(params, x, spec, cfg, ctx, cache), cache
    B, S, _ = x.shape
    d_in, H, P = _mlstm_dims(cfg, spec)
    dt_ = ctx.compute_dtype

    up = torch.matmul(x, params["w_up"].to(dt_))
    u, og = up[..., :d_in], up[..., d_in:]
    uc, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"])
    q = torch.matmul(uc, params["wq"].to(dt_)).view(B, S, H, P)
    # the reference divides by a float64 scalar: k leaves in float32
    k = (torch.matmul(uc, params["wk"].to(dt_)).float()
         / math.sqrt(P)).view(B, S, H, P)
    v = torch.matmul(u, params["wv"].to(dt_)).view(B, S, H, P)
    # the ones column carries the normaliser through the same recurrence
    v_aug = torch.cat([v, v.new_ones(B, S, H, 1)], dim=-1)
    logf, igate = _mlstm_gates(params, uc, H)
    y, new_C = chunked_ssd(q, k, v_aug, logf, igate, spec.chunk)
    out = _mlstm_out(params, y, og, cfg, ctx, P)
    if cache is not None:
        cache["C"].copy_(new_C)
        cache["conv"].copy_(new_conv)
    return out, cache


def _mlstm_decode(params, x, spec: MLstmSpec, cfg: ModelConfig, ctx: Ctx,
                  cache):
    """`mlstm_apply` at a decode step (S == 1): the conv on the cached
    window, then `ssd_decode_step` on C. A slot that `ctx.active` leaves
    out keeps C and its window bit for bit: its decay is 1 and its input
    0."""
    B = x.shape[0]
    d_in, H, P = _mlstm_dims(cfg, spec)
    dt_ = ctx.compute_dtype
    active = ctx.active

    up = torch.matmul(x, params["w_up"].to(dt_))
    u, og = up[..., :d_in], up[..., d_in:]
    conv = cache["conv"]
    uc, new_conv = causal_conv1d(u, params["conv_w"], params["conv_b"],
                                 conv)
    q = torch.matmul(uc, params["wq"].to(dt_)).view(B, H, P)
    k = torch.matmul(uc, params["wk"].to(dt_)).float().view(B, H, P) \
        / math.sqrt(P)
    v = torch.matmul(u, params["wv"].to(dt_)).view(B, H, P)
    v_aug = torch.cat([v, v.new_ones(B, H, 1)], dim=-1)
    logf, igate = _mlstm_gates(params, uc[:, 0], H)        # [B, H]
    if active is not None:
        logf = torch.where(active[:, None], logf, 0.0)
        igate = torch.where(active[:, None], igate, 0.0)
    y, new_C = ssd_decode_step(q, k, v_aug, logf, igate, cache["C"])
    cache["C"].copy_(new_C)
    # the reference rounds y to the compute dtype before num / den
    out = _mlstm_out(params, y[:, None].to(dt_), og, cfg, ctx, P)
    if active is None:
        conv.copy_(new_conv)
    else:
        conv.copy_(torch.where(active[:, None, None], new_conv, conv))
    return out


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def _slstm_dims(cfg: ModelConfig, spec: SLstmSpec):
    H = spec.n_heads
    return H, cfg.d_model // H, int(spec.proj_factor * cfg.d_model)


def slstm_param_shapes(cfg: ModelConfig, spec: SLstmSpec):
    """{name: (shape, init)} of one sLSTM sublayer's leaves."""
    d = cfg.d_model
    H, P, d_up = _slstm_dims(cfg, spec)
    return {
        "conv_w": ((spec.d_conv, d), spec.d_conv),
        "conv_b": ((d,), "zeros"),
        "w_gates": ((d, 4 * d), d),                  # z i f o
        "r_gates": ((H, 4, P, P), P),
        "b_gates": ((4 * d,), "slstm_gates"),
        "gn_scale": ((d,), None),
        "w_up": ((d, 2 * d_up), d),
        "w_down": ((d_up, d), d_up),
    }


def slstm_cache_shapes(cfg: ModelConfig, spec: SLstmSpec, batch: int):
    """{leaf: shape}: "h", "c", "n" and "m" (float32 always) and "conv"
    (the cache dtype)."""
    H, P, _ = _slstm_dims(cfg, spec)
    return {"h": (batch, H, P), "c": (batch, H, P), "n": (batch, H, P),
            "m": (batch, H, P),
            "conv": (batch, spec.d_conv - 1, cfg.d_model)}


def recurrent_weights(r_gates):
    """r_gates [H,4,P,P] as the step's batched operand, float32 [H,P,4P]:
    row p of head h holds r[h, g, p, :] for the gates g = z, i, f, o."""
    H, G, P, _ = r_gates.shape
    return r_gates.float().permute(0, 2, 1, 3).reshape(H, P, G * P)


def slstm_cell_(pre, h_prev, c, n, m, R, h_out):
    """One sLSTM step, in place, on the head-major layout.

    pre float32 [H,B,4P], the step's input pre-activations (gates z, i, f,
    o); it is overwritten (the recurrent product is added into it, then
    the gates are computed there). h_prev, c, n, m float32 [H,B,P]: c, n
    and m are updated in place; the new h goes to h_out. R is
    `recurrent_weights(r_gates)`. The reference's cell: m = max(log f +
    m_prev, i), i' = exp(i - m), f' = exp(log f + m_prev - m), c = f' c +
    i' tanh(z), n = max(f' n + i', 1e-6), h = sigmoid(o) c / n."""
    H, B, _ = pre.shape
    pre.baddbmm_(h_prev, R)
    # the gates' views, made in one call each (a step is host-bound)
    g = pre.view(H, B, 4, -1)
    z, i_s, f_s, o = g.unbind(2)
    torch.add(F.logsigmoid(f_s), m, out=f_s)      # log f + m_prev
    torch.maximum(f_s, i_s, out=m)
    g.narrow(2, 1, 2).sub_(m.unsqueeze(2)).exp_()  # i', f'
    c.mul_(f_s).addcmul_(i_s, z.tanh_())
    torch.addcmul(i_s, f_s, n, out=n).clamp_min_(1e-6)
    torch.div(c, n, out=h_out).mul_(o.sigmoid_())
    return h_out


# A CUDA prefill's scan replays each whole chunk of SCAN_CHUNK cell steps
# as one captured CUDA graph: the same launches from one host call, where
# a step's 14 launches take ~190 us of host time against ~24 us of device
# time on an H100 (xlstm-350m, one slot). The steps past the last whole
# chunk, and every step on the CPU, run one by one.
SCAN_CHUNK = 32
_SCAN_GRAPHS = {}


class _ScanGraph:
    """SCAN_CHUNK cell steps captured once for a shape and a device, on
    static buffers: pre [K,H,B,4P] in, hs [K,H,B,P] out, the state h, c,
    n, m [H,B,P] carried from one replay to the next, R [H,P,4P]."""

    def __init__(self, H: int, B: int, P: int, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.pre = torch.zeros(SCAN_CHUNK, H, B, 4 * P, **f32)
        self.hs = torch.zeros(SCAN_CHUNK, H, B, P, **f32)
        self.h, self.c, self.n, self.m = (torch.zeros(H, B, P, **f32)
                                          for _ in range(4))
        self.R = torch.zeros(H, P, 4 * P, **f32)
        # capture after a warm-up on a side stream, as CUDA graphs need
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._steps()
        torch.cuda.current_stream(device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._steps()

    def _steps(self):
        h = self.h
        for k in range(SCAN_CHUNK):
            h = slstm_cell_(self.pre[k], h, self.c, self.n, self.m, self.R,
                            self.hs[k])
        self.h.copy_(h)


def scan(pre, R, h, c, n, m, hs):
    """The cell over every step of pre [S,H,B,4P] (overwritten) from the
    state h, c, n, m [H,B,P]: c, n and m are updated in place and each
    step's h is written to hs [S,H,B,P]. Returns the last h."""
    S, H, B, _ = pre.shape
    t = 0
    if pre.is_cuda and S >= SCAN_CHUNK:
        key = (H, B, h.shape[-1], pre.device)
        if key not in _SCAN_GRAPHS:
            _SCAN_GRAPHS[key] = _ScanGraph(H, B, h.shape[-1], pre.device)
        g = _SCAN_GRAPHS[key]
        for dst, src in ((g.R, R), (g.h, h), (g.c, c), (g.n, n), (g.m, m)):
            dst.copy_(src)
        while S - t >= SCAN_CHUNK:
            g.pre.copy_(pre[t:t + SCAN_CHUNK])
            g.graph.replay()
            hs[t:t + SCAN_CHUNK].copy_(g.hs)
            t += SCAN_CHUNK
        for dst, src in ((c, g.c), (n, g.n), (m, g.m)):
            dst.copy_(src)
        h = hs[t - 1]
    for t in range(t, S):
        h = slstm_cell_(pre[t], h, c, n, m, R, hs[t])
    return h


def _slstm_pre(params, x, xc, D: int):
    """The input pre-activations, float32 [B,S,4D] (gates z i f o): z and
    o from the raw x, i and f from the conv path, plus b_gates."""
    w = params["w_gates"].to(x.dtype)
    wx = torch.matmul(x, w).float()
    wc = torch.matmul(xc, w).float()
    return torch.cat([wx[..., :D], wc[..., D:3 * D], wx[..., 3 * D:]],
                     dim=-1) + params["b_gates"]


def _slstm_out(params, hs, cfg: ModelConfig, ctx: Ctx, d_up: int):
    """The inner RMSNorm on float32 rows of d_model through the rmsnorm
    kernel, then the GeGLU up/down projection (tanh-approximated gelu, as
    jax's default)."""
    dt_ = ctx.compute_dtype
    hs = rms_norm_heads(hs, params["gn_scale"], cfg.norm_eps,
                        ctx.plain).to(dt_)
    up = torch.matmul(hs, params["w_up"].to(dt_))
    a, b = up[..., :d_up], up[..., d_up:]
    return torch.matmul(ACTIVATIONS["gelu"](a) * b,
                        params["w_down"].to(dt_))


def slstm_apply(params, x, spec: SLstmSpec, cfg: ModelConfig, ctx: Ctx,
                cache=None) -> Tuple[torch.Tensor, Optional[dict]]:
    """x [B,S,D] (normed). Returns (out [B,S,D], cache); the cache is
    updated in place. Prefill (and the train forward) steps from zero
    state through every position; decode steps the cached state."""
    if cache is not None and ctx.mode == "decode":
        return _slstm_decode(params, x, spec, cfg, ctx, cache), cache
    B, S, D = x.shape
    H, P, d_up = _slstm_dims(cfg, spec)

    xc, new_conv = causal_conv1d(x, params["conv_w"], params["conv_b"])
    # every step's pre-activations, head-major: [S, H, B, 4P]
    pre = _slstm_pre(params, x, xc, D).view(B, S, 4, H, P).permute(
        1, 3, 0, 2, 4).reshape(S, H, B, 4 * P)
    R = recurrent_weights(params["r_gates"])
    h, c, n, m = (x.new_zeros(H, B, P, dtype=torch.float32)
                  for _ in range(4))
    hs = x.new_empty(S, H, B, P, dtype=torch.float32)
    h = scan(pre, R, h, c, n, m, hs)
    out = _slstm_out(params, hs.permute(2, 0, 1, 3).reshape(B, S, D), cfg,
                     ctx, d_up)
    if cache is not None:
        for name, t in (("h", h), ("c", c), ("n", n), ("m", m)):
            cache[name].copy_(t.transpose(0, 1))
        cache["conv"].copy_(new_conv)
    return out, cache


def _slstm_decode(params, x, spec: SLstmSpec, cfg: ModelConfig, ctx: Ctx,
                  cache):
    """`slstm_apply` at a decode step (S == 1): the conv on the cached
    window and one cell step on the cached state. A slot that `ctx.active`
    leaves out keeps h, c, n, m and its window bit for bit."""
    B, _, D = x.shape
    H, P, d_up = _slstm_dims(cfg, spec)
    active = ctx.active

    conv = cache["conv"]
    xc, new_conv = causal_conv1d(x, params["conv_w"], params["conv_b"], conv)
    pre = _slstm_pre(params, x, xc, D).view(B, 4, H, P).permute(
        2, 0, 1, 3).reshape(H, B, 4 * P)
    h, c, n, m = (cache[name].transpose(0, 1).contiguous()
                  for name in ("h", "c", "n", "m"))
    h = slstm_cell_(pre, h, c, n, m, recurrent_weights(params["r_gates"]),
                    torch.empty_like(h))
    out = _slstm_out(params, h.transpose(0, 1).reshape(B, 1, D), cfg, ctx,
                     d_up)
    for name, t in (("h", h), ("c", c), ("n", n), ("m", m)):
        t = t.transpose(0, 1)
        cache[name].copy_(t if active is None else
                          torch.where(active[:, None, None], t, cache[name]))
    cache["conv"].copy_(new_conv if active is None else
                        torch.where(active[:, None, None], new_conv, conv))
    return out


# the two sublayer kinds' interfaces, as `model._MIXERS` reads them
mlstm = types.SimpleNamespace(param_shapes=mlstm_param_shapes,
                              cache_shapes=mlstm_cache_shapes,
                              apply=mlstm_apply)
slstm = types.SimpleNamespace(param_shapes=slstm_param_shapes,
                              cache_shapes=slstm_cache_shapes,
                              apply=slstm_apply)
