"""The port's Mamba-2 sublayer (`repro_torch.models.ssm`) against the JAX
reference's (`repro.models.ssm`) on the same seeded numpy inputs, float32,
on the CPU: the depthwise causal conv with and without a carried state,
the chunked SSD core at lengths below, at and past a chunk (and against
its own one-token recurrence run token by token), the whole sublayer
through prefill and then decode on reduced zamba2-7b's spec with its
cache compared leaf by leaf, and the `active` mask that keeps a parked
slot's state.

Values compare at ATOL 1e-5: the same float32 function in two frameworks
(observed differences are at most a few 1e-6, the recurrent state's
largest)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import ssm as JS
from repro.models.layers import Ctx as JCtx
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import get_config
from repro_torch.models import ssm as TS
from repro_torch.models.layers import Ctx

ATOL = 1e-5
ARCH = "zamba2-7b"


def _close(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [1, 2, 9])
def test_causal_conv1d_matches_reference(with_state, S):
    rng = np.random.default_rng(S + 10 * with_state)
    B, C, W = 2, 12, 4
    x = rng.standard_normal((B, S, C)).astype(np.float32)
    w = rng.standard_normal((W, C)).astype(np.float32) / 2
    b = rng.standard_normal(C).astype(np.float32) / 4
    state = (rng.standard_normal((B, W - 1, C)).astype(np.float32)
             if with_state else None)
    jy, js = JS.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              None if state is None else jnp.asarray(state))
    ty, ts = TS.causal_conv1d(_t(x), _t(w), _t(b),
                              None if state is None else _t(state))
    _close(ty, jy, "y")
    _close(ts, js, "state")
    # the new state is the last W-1 inputs (zeros before the first)
    ctx_in = np.concatenate([state if with_state else
                             np.zeros((B, W - 1, C), np.float32), x], 1)
    np.testing.assert_array_equal(ts.numpy(), ctx_in[:, -(W - 1):])


def _ssd_inputs(rng, B, S, H, N, P):
    q = rng.standard_normal((B, S, H, N)).astype(np.float32)
    k = rng.standard_normal((B, S, H, N)).astype(np.float32) / 2
    v = rng.standard_normal((B, S, H, P)).astype(np.float32)
    # logf <= 0, as -exp(a_log) * softplus(dt) is; gate > 0
    logf = -rng.uniform(0.01, 2.0, (B, S, H)).astype(np.float32)
    gate = rng.uniform(0.05, 1.5, (B, S, H)).astype(np.float32)
    return q, k, v, logf, gate


@pytest.mark.parametrize("S", [5, 8, 19])
def test_chunked_ssd_matches_reference_and_the_recurrence(S):
    """Chunk 8: S below it, equal to it, and not a multiple of it (three
    chunks, the last padded)."""
    B, H, N, P, chunk = 2, 3, 4, 5, 8
    q, k, v, logf, gate = _ssd_inputs(np.random.default_rng(S), B, S, H,
                                      N, P)
    jy, jf = JS.chunked_ssd(*map(jnp.asarray, (q, k, v, logf, gate)), chunk)
    ty, tf = TS.chunked_ssd(*map(_t, (q, k, v, logf, gate)), chunk)
    assert ty.dtype == tf.dtype == torch.float32
    _close(ty, jy, "y")
    _close(tf, jf, "final state")
    # the one-token recurrence, token by token from zero state
    st = torch.zeros(B, H, N, P)
    for s in range(S):
        y, st = TS.ssd_decode_step(*(_t(a[:, s]) for a in
                                     (q, k, v, logf, gate)), st)
        _close(y, ty[:, s], f"recurrence y at {s}")
    _close(st, tf, "recurrence state")


def test_ssd_decode_step_matches_reference():
    B, H, N, P = 3, 4, 6, 5
    rng = np.random.default_rng(3)
    q, k, v, logf, gate = (a[:, 0] for a in _ssd_inputs(rng, B, 1, H, N, P))
    state = rng.standard_normal((B, H, N, P)).astype(np.float32)
    jy, js = JS.ssd_decode_step(*map(jnp.asarray, (q, k, v, logf, gate,
                                                   state)))
    ty, ts = TS.ssd_decode_step(*map(_t, (q, k, v, logf, gate, state)))
    _close(ty, jy, "y")
    _close(ts, js, "state")


@pytest.fixture(scope="module")
def sublayer():
    """Reduced zamba2-7b's Mamba-2 spec and one sublayer's reference
    weights, with the drawn ones scaled up and the constants moved off
    their init values, so every leaf reaches the output."""
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    spec = cfg.pattern[0][0]
    assert spec.kind == "mamba2" and repr(spec) == repr(jcfg.pattern[0][0])
    jp, _ = JS.init(jax.random.PRNGKey(4), jcfg, jcfg.pattern[0][0])
    rng = np.random.default_rng(4)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    for name in ("conv_b", "dt_bias"):
        jp[name] = rng.normal(0, 0.3, jp[name].shape).astype(np.float32)
    for name in ("d_skip", "norm_scale"):
        jp[name] = rng.uniform(0.5, 1.5, jp[name].shape).astype(np.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    return jcfg, cfg, spec, jp, tp


def _ctxs(mode, B, S):
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    j = JCtx(rules=single_device_rules(), mode=mode,
             positions=jnp.asarray(pos), compute_dtype=jnp.float32)
    t = Ctx(mode=mode, positions=torch.from_numpy(pos.copy()),
            compute_dtype=torch.float32, plain=True)
    return j, t


def _caches(jcfg, cfg, spec, B):
    jc = JS.init_cache(jcfg, jcfg.pattern[0][0], B, jnp.float32)
    tc = {n: torch.zeros(shape) for n, shape in
          TS.cache_shapes(cfg, spec, B).items()}
    assert {n: tuple(t.shape) for n, t in tc.items()} == \
        {n: a.shape for n, a in jc.items()}
    return jc, tc


@pytest.mark.parametrize("S", [7, 16, 21])
def test_apply_prefill_then_decode_matches_reference(sublayer, S):
    """Prefill (reduced chunk 16: S below, at and past it) from zero
    state, then four decode steps on the cache; outputs and both cache
    leaves held at every step."""
    jcfg, cfg, spec, jp, tp = sublayer
    B = 2
    rng = np.random.default_rng(S)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jc, tc = _caches(jcfg, cfg, spec, B)
    jctx, tctx = _ctxs("prefill", B, S)
    jo, jc = JS.apply(jp, jnp.asarray(x), jcfg.pattern[0][0], jcfg, jctx, jc)
    to, tc = TS.apply(tp, _t(x), spec, cfg, tctx, tc)
    _close(to, jo, "prefill out")
    for leaf in ("ssm", "conv"):
        _close(tc[leaf], jc[leaf], f"prefill {leaf}")
    for step in range(4):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jctx, tctx = _ctxs("decode", B, 1)
        jo, jc = JS.apply(jp, jnp.asarray(x1), jcfg.pattern[0][0], jcfg,
                          jctx, jc)
        to, tc = TS.apply(tp, _t(x1), spec, cfg, tctx, tc)
        _close(to, jo, f"decode out {step}")
        for leaf in ("ssm", "conv"):
            _close(tc[leaf], jc[leaf], f"decode {leaf} {step}")


def test_apply_train_forward_matches_reference(sublayer):
    jcfg, cfg, spec, jp, tp = sublayer
    x = np.random.default_rng(8).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    jctx, tctx = _ctxs("train", 2, 23)
    jo, jc = JS.apply(jp, jnp.asarray(x), jcfg.pattern[0][0], jcfg, jctx)
    to, tc = TS.apply(tp, _t(x), spec, cfg, tctx)
    assert jc is None and tc is None
    _close(to, jo, "train out")


def test_active_mask_keeps_an_inactive_slots_state(sublayer):
    """A decode step with `active` = [True, False, True] writes slots 0
    and 2's new state and gives their outputs, each equal to an unmasked
    step's, and leaves slot 1's ssm and conv bit for bit as they were
    (slot 1's output is not read: the engine keeps a parked slot's
    token)."""
    jcfg, cfg, spec, jp, tp = sublayer
    B = 3
    rng = np.random.default_rng(9)
    _, tc = _caches(jcfg, cfg, spec, B)
    _, tctx = _ctxs("prefill", B, 6)
    TS.apply(tp, _t(rng.standard_normal((B, 6, cfg.d_model)).astype(
        np.float32)), spec, cfg, tctx, tc)
    x1 = _t(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
    before = {n: t.clone() for n, t in tc.items()}
    free = {n: t.clone() for n, t in tc.items()}
    _, tctx = _ctxs("decode", B, 1)
    want, _ = TS.apply(tp, x1, spec, cfg, tctx, free)
    tctx.active = torch.tensor([True, False, True])
    got, _ = TS.apply(tp, x1, spec, cfg, tctx, tc)
    assert torch.equal(got[[0, 2]], want[[0, 2]])
    for n in ("ssm", "conv"):
        assert torch.equal(tc[n][1], before[n][1]), n
        assert torch.equal(tc[n][[0, 2]], free[n][[0, 2]]), n
        assert not torch.equal(tc[n][0], before[n][0]), n
