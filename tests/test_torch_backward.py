"""The port's backward on the CPU against the JAX reference: the plain
versions of the two backward kernels (`reference_attention_bwd`,
`reference_rmsnorm_bwd`, `reference_add_rmsnorm_bwd`), the
`torch.autograd.Function` wiring that takes them on the card, and one
training step of the recurrent, MoE and audio reduced configs
(tests/test_torch_train.py holds the dense ones).

Tolerances: float32 atol 1e-5 times the gradient's largest magnitude (at
least 1): the same float32 math in another summation order, as
tests/test_torch_kernels.py holds the forwards. The reference's
`flash_attention` (its Pallas kernel in interpret mode, whose custom_vjp
recomputes through the jnp oracle) takes no window and no cap; those
forms are held against `jax.vjp` of the reference model's `_sdpa_full`
with its mask. The CUDA kernels themselves are held against these plain
versions on the card by chip_smoke.py (phase 25)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.models.attention import _sdpa_full
from repro.models.layers import apply_norm as j_apply_norm
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import (reference_attention,
                                                     reference_attention_bwd)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import (reference_add_rmsnorm,
                                             reference_add_rmsnorm_bwd,
                                             reference_rmsnorm,
                                             reference_rmsnorm_bwd)

import test_torch_train as TT

# the forms phase 25(a) holds on the card, at small sizes: (name, q shape,
# k/v shape, causal, window, softcap)
FLASH_FORMS = [
    ("mqa_causal", (2, 4, 24, 32), (2, 1, 24, 32), True, 0, 0.0),
    ("mha_causal", (1, 4, 20, 32), (1, 4, 20, 32), True, 0, 0.0),
    ("gqa4_causal", (1, 8, 20, 32), (1, 2, 20, 32), True, 0, 0.0),
    ("cross_non_causal", (1, 4, 13, 16), (1, 4, 30, 16), False, 0, 0.0),
    ("window_cap", (1, 4, 28, 32), (1, 1, 28, 32), True, 7, 0.5),
    ("window", (1, 4, 28, 32), (1, 1, 28, 32), True, 5, 0.0),
    ("cap", (1, 4, 28, 32), (1, 2, 28, 32), True, 0, 0.5),
    ("hd112", (1, 4, 18, 112), (1, 2, 18, 112), True, 0, 0.0),
    ("hd16", (1, 4, 18, 16), (1, 2, 18, 16), True, 0, 0.0),
    ("s1_non_causal", (1, 4, 1, 32), (1, 2, 30, 32), False, 0, 0.0),
    ("t1_non_causal", (1, 4, 9, 32), (1, 2, 1, 32), False, 0, 0.0),
    ("s1_t1_causal", (1, 4, 1, 32), (1, 2, 1, 32), True, 0, 0.0),
]


def _close(got, want, what=""):
    want = np.asarray(want, np.float32)
    atol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, atol=atol,
                               rtol=1e-5, err_msg=what)


def _flash_inputs(qs, ks, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32) for s in
               (qs, ks, ks))
    dout = rng.standard_normal(qs).astype(np.float32)
    return q, k, v, dout


def _jax_sdpa(q, k, v, scale, causal, window, softcap):
    """The reference model's `_sdpa_full` on [B,H,S,hd] q and [B,KV,T,hd]
    k, v (its grouped layout in between), with the causal/window mask."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    qg = q.transpose(0, 2, 1, 3).reshape(B, S, KV, H // KV, hd)
    mask = None
    if causal:
        i, j = jnp.arange(S)[:, None], jnp.arange(T)[None, :]
        mask = i >= j
        if window:
            mask &= i - j < window
        mask = jnp.broadcast_to(mask, (B, S, T))
    out = _sdpa_full(qg, k, v, mask, scale, softcap)
    return out.reshape(B, S, H, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("form", FLASH_FORMS, ids=[f[0] for f in FLASH_FORMS])
def test_attention_bwd_matches_autograd_and_reference(form):
    """reference_attention_bwd against autograd through
    reference_attention and against jax.vjp of the reference's
    flash_attention (interpret mode; its custom_vjp) or, for a window or
    a cap, of the reference model's _sdpa_full."""
    _, qs, ks, causal, window, softcap = form
    q, k, v, dout = _flash_inputs(qs, ks)
    scale = qs[-1] ** -0.5
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = reference_attention(tq, tk, tv, **kw)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(dout))
    got = reference_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                  out.detach(), torch.from_numpy(dout), **kw)
    if window or softcap:
        def fn(a, b, c):
            return _jax_sdpa(a, b, c, scale, causal, window, softcap)
    else:
        def fn(a, b, c):
            return j_flash(a, b, c, causal, scale, True)
    jout, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    _close(out.detach().numpy(), jout, "forward")
    for name, g, a, w in zip("qkv", got, auto, want):
        assert g.dtype == torch.float32 and g.shape == a.shape
        _close(g.numpy(), a.numpy(), f"d{name} vs autograd")
        _close(g.numpy(), w, f"d{name} vs the reference's vjp")


def test_attention_bwd_bf16_rounds_once():
    """bf16 inputs: float32 math on the bf16 values, each gradient rounded
    once to bf16 (the float32 gradient of the same values, rounded)."""
    q, k, v, dout = _flash_inputs((1, 4, 20, 32), (1, 1, 20, 32), seed=3)
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, dout)]
    kw = dict(scale=32 ** -0.5, causal=True, window=6, softcap=0.7)
    out = reference_attention(*tb[:3], **kw)
    got = reference_attention_bwd(*tb[:3], out, tb[3], **kw)
    f32 = reference_attention_bwd(*(t.float() for t in tb[:3]), out.float(),
                                  tb[3].float(), **kw)
    for g, w in zip(got, f32):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, w.to(torch.bfloat16))


# the forms the bf16 tensor-core kernel's numerics are held on: (name, q
# shape, k/v shape, causal, window, softcap)
TC_FORMS = [
    ("causal", (1, 4, 24, 32), (1, 4, 24, 32), True, 0, 0.0),
    ("window_cap", (1, 4, 28, 32), (1, 1, 28, 32), True, 7, 0.5),
    ("gqa4_causal", (1, 8, 20, 32), (1, 2, 20, 32), True, 0, 0.0),
    ("cross_non_causal", (1, 4, 13, 16), (1, 4, 30, 16), False, 0, 0.0),
    ("s1_non_causal", (1, 4, 1, 32), (1, 2, 30, 32), False, 0, 0.0),
    ("t1_non_causal", (1, 4, 9, 32), (1, 2, 1, 32), False, 0, 0.0),
]


def _split_bf16(x):
    """float32 x as bf16 hi = bf16(x) and lo = bf16(x - hi), in float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _tensor_core_bwd(q, k, v, out, dout, *, scale, causal, window,
                     softcap):
    """The arithmetic of `csrc/flash_attention_bwd.cu`'s bf16 passes in
    plain torch: every product of bf16 values (q, k, v, out, dout, or a bf16
    part) summed in float32, as the tensor cores do; lse, p, delta, dp and
    ds in float32; p and ds entering their products as bf16 hi + lo parts,
    each part's product summed into one float32 result; every gradient
    rounded once to bf16."""
    B, H, S, D = q.shape
    KV, T = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, KV, H // KV, S, D)
    kf, vf = k.float(), v.float()
    of = out.float().reshape(B, KV, H // KV, S, D)
    gf = dout.float().reshape(B, KV, H // KV, S, D)
    s = torch.einsum("bgqsd,bgtd->bgqst", qf, kf) * scale
    dcap = 1.0
    if softcap:
        th = torch.tanh(s / softcap)
        s, dcap = th * softcap, 1.0 - th * th
    visible = torch.ones(S, T, dtype=torch.bool)
    if causal:
        i, j = torch.arange(S)[:, None], torch.arange(T)[None, :]
        visible = (i >= j) & ((i - j < window) if window else True)
    s = torch.where(visible, s, -torch.inf)
    p = torch.where(visible, torch.exp(s - torch.logsumexp(
        s, dim=-1, keepdim=True)), 0.0)
    delta = (gf * of).sum(-1, keepdim=True)
    dp = torch.einsum("bgqsd,bgtd->bgqst", gf, vf)
    ds = p * (dp - delta) * dcap
    dv = sum(torch.einsum("bgqst,bgqsd->bgtd", x, gf) for x in _split_bf16(p))
    dk = sum(torch.einsum("bgqst,bgqsd->bgtd", x, qf)
             for x in _split_bf16(ds)) * scale
    dq = sum(torch.einsum("bgqst,bgtd->bgqsd", x, kf)
             for x in _split_bf16(ds)) * scale
    return (dq.reshape(B, H, S, D).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


@pytest.mark.parametrize("form", TC_FORMS, ids=[f[0] for f in TC_FORMS])
def test_tensor_core_numerics_meet_the_bf16_rule(form):
    """The bf16 kernel's numerics (`_tensor_core_bwd`: bf16 products summed
    in float32, p and ds as bf16 hi + lo) on bf16 inputs and the plain
    forward's bf16 output, held to phase 25's rule for a bf16 gradient
    (chip_smoke.py's `_grad_hold`): the largest distance of the three
    gradients from reference_attention_bwd in float32 at most twice the
    plain bf16 version's own."""
    _, qs, ks, causal, window, softcap = form
    q, k, v, dout = _flash_inputs(qs, ks, seed=11)
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, dout)]
    kw = dict(scale=qs[-1] ** -0.5, causal=causal, window=window,
              softcap=softcap)
    ins = (*tb[:3], reference_attention(*tb[:3], **kw), tb[3])
    got = _tensor_core_bwd(*ins, **kw)
    plain = reference_attention_bwd(*ins, **kw)
    plain_f32 = reference_attention_bwd(*(t.float() for t in ins), **kw)
    for g, w in zip(got, plain):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
    own = max(float((p.float() - f).abs().max())
              for p, f in zip(plain, plain_f32))
    err = max(float((g.float() - f).abs().max())
              for g, f in zip(got, plain_f32))
    assert 0 < own and err <= 2 * own, (err, own)


@pytest.mark.parametrize("D", [64, 130])
@pytest.mark.parametrize("fused", [False, True], ids=["rmsnorm",
                                                      "add_rmsnorm"])
def test_rmsnorm_bwd_matches_autograd_and_reference(D, fused):
    """reference_rmsnorm_bwd (and its add form: one gradient for x and
    the residual, the sum's own gradient added in) against autograd
    through the plain forwards and jax.vjp of the reference's apply_norm;
    dscale summed over every row."""
    rng = np.random.default_rng(D)
    x, r, g, gs = (rng.standard_normal((3, 5, D)).astype(np.float32)
                   for _ in range(4))
    scale = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    eps = 1e-6
    tx, tr, ts = (torch.from_numpy(t).requires_grad_() for t in (x, r, scale))
    if fused:
        y, s = reference_add_rmsnorm(tx, tr, ts, eps)
        auto = torch.autograd.grad((y, s), (tx, tr, ts), (
            torch.from_numpy(g), torch.from_numpy(gs)))
        d, dscale = reference_add_rmsnorm_bwd(s.detach(), torch.from_numpy(g),
                                              torch.from_numpy(gs),
                                              ts.detach(), eps)
        got = (d, d, dscale)

        def fn(a, b, sc):
            summed = a + b
            return (j_apply_norm({"scale": sc}, summed, "rmsnorm", eps),
                    summed)
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(r),
                         jnp.asarray(scale))
        want = vjp((jnp.asarray(g), jnp.asarray(gs)))
    else:
        y = reference_rmsnorm(tx, ts, eps)
        auto = torch.autograd.grad(y, (tx, ts), torch.from_numpy(g))
        got = reference_rmsnorm_bwd(tx.detach(), torch.from_numpy(g),
                                    ts.detach(), eps)

        def fn(a, sc):
            return j_apply_norm({"scale": sc}, a, "rmsnorm", eps)
        _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(scale))
        want = vjp(jnp.asarray(g))
    assert got[-1].dtype == torch.float32 and got[-1].shape == (D,)
    for i, (a, b_, w) in enumerate(zip(got, auto, want)):
        _close(a.numpy(), b_.numpy(), f"grad {i} vs autograd")
        _close(a.numpy(), w, f"grad {i} vs the reference's vjp")


def test_cpu_backward_wrappers_take_the_plain_versions_and_count_nothing():
    """`flash_attention_bwd` and `rmsnorm_bwd` on CPU tensors return their
    plain versions' values exactly and launch nothing."""
    from repro_torch import kernels as K
    K.reset_launch_counts()
    q, k, v, dout = (torch.from_numpy(t) for t in _flash_inputs(
        (1, 4, 9, 32), (1, 2, 9, 32), seed=7))
    kw = dict(scale=0.2, causal=True, window=4, softcap=0.9)
    out = reference_attention(q, k, v, **kw)
    for got, want in zip(K.flash_attention_bwd(q, k, v, out, dout, **kw),
                         reference_attention_bwd(q, k, v, out, dout, **kw)):
        assert torch.equal(got, want)
    x, g, gs = (q[0, 0], dout[0, 0], dout[0, 1])
    scale = v[0, 0, 0]
    for g_sum in (None, gs):
        for got, want in zip(K.rmsnorm_bwd(x, g, scale, 1e-6, g_sum),
                             reference_rmsnorm_bwd(x, g, scale, 1e-6,
                                                   g_sum)):
            assert torch.equal(got, want)
    assert K.launch_counts()["flash_attention_bwd"] == 0
    assert K.launch_counts()["rmsnorm_bwd"] == 0


def test_backward_wrappers_refuse_other_devices():
    """The backward wrappers take CPU tensors (plain versions) and one
    CUDA device's (kernels) alone: meta tensors, or a mix, raise."""
    from repro_torch import kernels as K
    K.reset_launch_counts()
    meta = torch.empty(1, 2, 4, 32, device="meta")
    with pytest.raises(ValueError, match="all on one CUDA device"):
        K.flash_attention_bwd(meta, meta, meta, meta, meta, scale=0.2)
    x = torch.empty(2, 64, device="meta")
    with pytest.raises(ValueError, match="all on one CUDA device"):
        K.rmsnorm_bwd(x, torch.empty(2, 64), torch.ones(64))
    assert K.launch_counts()["flash_attention_bwd"] == 0
    assert K.launch_counts()["rmsnorm_bwd"] == 0


def test_bf16_wrappers_check_the_rows_tma_loads_take():
    """`_check_tma_rows`, which the bf16 forward and backward wrappers run
    before a launch: views whose strides are whole 8-element steps pass;
    a row stride of 65 elements, or a base 2 bytes past an aligned one,
    raises."""
    wide = torch.zeros(1, 2, 5, 72, dtype=torch.bfloat16)
    flash_ops._check_tma_rows("flash_attention_bwd", wide, wide[..., :64])
    odd = torch.zeros(1, 2, 5, 65, dtype=torch.bfloat16)[..., :64]
    shifted = torch.zeros(641, dtype=torch.bfloat16)[1:].view(1, 2, 5, 64)
    for t in (odd, shifted):
        with pytest.raises(ValueError, match="16-byte aligned rows"):
            flash_ops._check_tma_rows("flash_attention_bwd", wide, t)


def test_flash_function_wiring_and_padding(monkeypatch):
    """`_FlashAttention` (the route a CUDA tensor with grad takes), its
    launches swapped for the plain versions so it runs here: gradients
    through `padded_attention` at head_dim 112 padded to 128 (autograd
    slices the padded gradients back) equal autograd through
    reference_attention at 112, and the backward's count moves once."""
    monkeypatch.setattr(flash_ops, "_launch", reference_attention)
    monkeypatch.setattr(flash_ops, "_launch_bwd", reference_attention_bwd)
    q, k, v, dout = _flash_inputs((1, 4, 18, 112), (1, 2, 18, 112), seed=5)
    kw = dict(scale=112 ** -0.5, causal=True, window=4, softcap=0.8)
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    before = flash_ops.flash_attention_bwd.launches
    out = flash_ops.padded_attention(flash_ops._attend_grad, *leaves,
                                     head_dim=128, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    plain = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(reference_attention(*plain, **kw), plain,
                               torch.from_numpy(dout))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g.numpy(), w.numpy())
    # the swapped-in backward is the plain version, which counts nothing
    assert flash_ops.flash_attention_bwd.launches == before


def test_rmsnorm_function_wiring(monkeypatch):
    """`_RmsNorm` and `_AddRmsNorm` with their launches swapped for the
    plain versions: autograd through them equals autograd through the
    plain forwards, for x, the residual and the scale, also when the
    sum output is not used (its gradient None)."""
    monkeypatch.setattr(
        rms_ops, "_launch",
        lambda name, x, res, scale, eps: (
            (reference_rmsnorm(x, scale, eps), None) if res is None
            else reference_add_rmsnorm(x, res, scale, eps)))
    monkeypatch.setattr(
        rms_ops, "_launch_bwd",
        lambda x, g, g_sum, scale, eps: reference_rmsnorm_bwd(
            x, g, scale, eps, g_sum))
    rng = np.random.default_rng(1)
    x, r, g = (torch.from_numpy(rng.standard_normal((4, 24)).astype(
        np.float32)) for _ in range(3))
    scale = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    for use_sum in (False, True):
        a = [t.clone().requires_grad_() for t in (x, r, scale)]
        y, s = rms_ops._AddRmsNorm.apply(*a, 1e-6)
        loss = (y * g).sum() + ((s * s).sum() if use_sum else 0.0)
        got = torch.autograd.grad(loss, a)
        b = [t.clone().requires_grad_() for t in (x, r, scale)]
        y2, s2 = reference_add_rmsnorm(*b, 1e-6)
        loss2 = (y2 * g).sum() + ((s2 * s2).sum() if use_sum else 0.0)
        for u, w in zip(got, torch.autograd.grad(loss2, b)):
            _close(u.numpy(), w.numpy(), f"add form, sum used {use_sum}")
    a = [t.clone().requires_grad_() for t in (x, scale)]
    got = torch.autograd.grad((rms_ops._RmsNorm.apply(*a, 1e-6) * g).sum(),
                              a)
    b = [t.clone().requires_grad_() for t in (x, scale)]
    want = torch.autograd.grad((reference_rmsnorm(*b, 1e-6) * g).sum(), b)
    for u, w in zip(got, want):
        _close(u.numpy(), w.numpy())


@pytest.mark.parametrize("arch", ["gemma-2b", "xlstm-350m", "zamba2-7b",
                                  "qwen3-moe-235b-a22b", "whisper-medium"])
def test_cpu_gradients_reach_every_leaf_without_the_functions(arch,
                                                              monkeypatch):
    """On the CPU the wrappers take the plain versions and autograd runs
    through them: the autograd.Function route (`_FlashAttention`,
    `_RmsNorm`, `_AddRmsNorm`) is never taken, no kernel counter moves,
    and every parameter leaf gets a finite gradient (xlstm-350m's sLSTM
    scan through `slstm_cell`, where the in-place cell raised)."""
    from repro_torch import kernels as K

    def refuse(*a, **k):
        raise AssertionError("autograd.Function route taken on the CPU")
    for fn in (flash_ops._FlashAttention, rms_ops._RmsNorm,
               rms_ops._AddRmsNorm):
        monkeypatch.setattr(fn, "apply", refuse)
    from repro_torch.configs import get_config
    cfg = get_config(arch, reduced=True)
    tcfg = TT.TS.TrainConfig(compute_dtype=torch.float32)
    state = TT.TS.init_state(cfg, tcfg, generator=0, device="cpu")
    K.reset_launch_counts()
    paths, params = zip(*TT.adamw.leaves(state["params"]))
    loss, _ = TT.TS.loss_fn(state["params"], cfg,
                            TT.torch_batch(TT.batch_of(cfg)), tcfg)
    # allow_unused=False: autograd reaches every leaf, or this raises
    grads = torch.autograd.grad(loss, params, allow_unused=False)
    assert all(n == 0 for n in K.launch_counts().values())
    for path, leaf, g in zip(paths, params, grads):
        assert g.shape == leaf.shape and bool(torch.isfinite(g).all()), path


def test_functional_slstm_cell_equals_the_in_place_cell():
    """`slstm_cell` (autograd's step) against `slstm_cell_` (serving's, in
    place) over 20 steps from a zero state: every h and the final c, n, m
    bit for bit, through the m stabiliser (pre-activations of scale 2)."""
    from repro_torch.models.xlstm import (recurrent_weights, slstm_cell,
                                          slstm_cell_)
    rng = np.random.default_rng(9)
    H, B, P, S = 4, 3, 8, 20
    pre = torch.from_numpy(2 * rng.standard_normal(
        (S, H, B, 4 * P)).astype(np.float32))
    R = recurrent_weights(torch.from_numpy(0.3 * rng.standard_normal(
        (H, 4, P, P)).astype(np.float32)))
    h, c, n, m = (torch.zeros(H, B, P) for _ in range(4))
    hs = []
    for t in range(S):
        h, c, n, m = slstm_cell(pre[t], h, c, n, m, R)
        hs.append(h)
    h2, c2, n2, m2 = (torch.zeros(H, B, P) for _ in range(4))
    hs2 = torch.empty(S, H, B, P)
    pre2 = pre.clone()
    for t in range(S):
        h2 = slstm_cell_(pre2[t], h2, c2, n2, m2, R, hs2[t])
    assert torch.equal(torch.stack(hs), hs2)
    assert torch.equal(c, c2) and torch.equal(n, n2) and torch.equal(m, m2)


@pytest.fixture(scope="module", params=TT.BACKWARD_ARCHS)
def stepped(request):
    return TT.stepped_pair(request.param)


def test_loss_and_aux_matches_reference(stepped):
    TT.check_loss(stepped)


def test_train_step_matches_reference(stepped):
    TT.check_step(stepped)
