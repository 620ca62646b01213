"""The port's xLSTM sublayers (`repro_torch.models.xlstm`) against the JAX
reference's (`repro.models.xlstm`) on the same seeded numpy inputs,
float32, on the CPU: the mLSTM and the sLSTM on reduced xlstm-350m's
specs through prefill (below, at and past the mLSTM's chunk of 16) and
then decode, with the cache compared leaf by leaf; the train forward;
the sLSTM cell where its m stabiliser takes over; the `active` mask that
keeps a parked slot's state; native init's constant leaves; and the
full-width trees' shapes (the weights, the cache and a paused blob's
bytes) on `jax.eval_shape`, without making them.

Values compare at ATOL 1e-5: the same float32 function in two frameworks
(as in tests/test_torch_ssm.py)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import xlstm as JX
from repro.models.layers import Ctx as JCtx
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models import xlstm as TX
from repro_torch.models.layers import Ctx

ATOL = 1e-5
ARCH = "xlstm-350m"
# kind -> (the reference's init, cache init, apply; the port's interface;
# its recurrent leaves)
KINDS = {
    "mlstm": (JX.init_mlstm, JX.init_mlstm_cache, JX.apply_mlstm, TX.mlstm,
              ("C",)),
    "slstm": (JX.init_slstm, JX.init_slstm_cache, JX.apply_slstm, TX.slstm,
              ("h", "c", "n", "m")),
}


def _close(got, want, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=what)


def _t(a):
    return torch.from_numpy(np.array(a))


def _spec(cfg, kind):
    return next(s for layer in cfg.pattern for s in layer if s.kind == kind)


@pytest.fixture(scope="module", params=sorted(KINDS))
def sublayer(request):
    """Reduced xlstm-350m's spec of one kind and one sublayer's reference
    weights, with the biases and scales moved off their init values, so
    every leaf reaches the output."""
    kind = request.param
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    spec, jspec = _spec(cfg, kind), _spec(jcfg, kind)
    assert repr(spec) == repr(jspec)
    init = KINDS[kind][0]
    jp, _ = init(jax.random.PRNGKey(4), jcfg, jspec)
    rng = np.random.default_rng(4)
    jp = {k: np.asarray(v) for k, v in jp.items()}
    assert sorted(jp) == sorted(KINDS[kind][3].param_shapes(cfg, spec))
    jp["conv_b"] = rng.normal(0, 0.3, jp["conv_b"].shape).astype(np.float32)
    jp["b_gates"] = (jp["b_gates"] + rng.normal(
        0, 0.5, jp["b_gates"].shape)).astype(np.float32)
    for name in ("norm_scale", "gn_scale"):
        if name in jp:
            jp[name] = rng.uniform(0.5, 1.5, jp[name].shape).astype(
                np.float32)
    tp = {k: _t(v) for k, v in jp.items()}
    return kind, jcfg, cfg, spec, jspec, jp, tp


def _ctxs(mode, B, S):
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    j = JCtx(rules=single_device_rules(), mode=mode,
             positions=jnp.asarray(pos), compute_dtype=jnp.float32)
    t = Ctx(mode=mode, positions=torch.from_numpy(pos.copy()),
            compute_dtype=torch.float32, plain=True)
    return j, t


def _caches(sub, B):
    kind, jcfg, cfg, spec, jspec, _, _ = sub
    jc = KINDS[kind][1](jcfg, jspec, B, jnp.float32)
    tc = {n: torch.zeros(shape) for n, shape in
          KINDS[kind][3].cache_shapes(cfg, spec, B).items()}
    assert {n: tuple(t.shape) for n, t in tc.items()} == \
        {n: a.shape for n, a in jc.items()}
    return jc, tc


def _apply_both(sub, x, jc, tc, mode):
    kind, jcfg, cfg, spec, jspec, jp, tp = sub
    B, S = x.shape[:2]
    jctx, tctx = _ctxs(mode, B, S)
    jo, jc = KINDS[kind][2](jp, jnp.asarray(x), jspec, jcfg, jctx, jc)
    to, tc = KINDS[kind][3].apply(tp, _t(x), spec, cfg, tctx, tc)
    return jo, jc, to, tc


@pytest.mark.parametrize("S", [7, 16, 21])
def test_prefill_then_decode_matches_reference(sublayer, S):
    """Prefill from zero state (S below, at and past the mLSTM's chunk of
    16), then three decode steps on the cache; the output and every cache
    leaf held at every step."""
    cfg = sublayer[2]
    B = 2
    rng = np.random.default_rng(S)
    jc, tc = _caches(sublayer, B)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    jo, jc, to, tc = _apply_both(sublayer, x, jc, tc, "prefill")
    _close(to, jo, "prefill out")
    for leaf in tc:
        _close(tc[leaf], jc[leaf], f"prefill {leaf}")
    for step in range(3):
        x1 = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        jo, jc, to, tc = _apply_both(sublayer, x1, jc, tc, "decode")
        _close(to, jo, f"decode out {step}")
        for leaf in tc:
            _close(tc[leaf], jc[leaf], f"decode {leaf} {step}")


def test_prefill_ignores_the_caches_contents(sublayer):
    """As the reference's: a prefill starts from zero state whatever the
    cache holds, and overwrites every leaf."""
    cfg = sublayer[2]
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, cfg.d_model)).astype(np.float32)
    jc, tc = _caches(sublayer, 2)
    for t in tc.values():
        t.normal_(generator=torch.Generator().manual_seed(1))
    jo, jc, to, tc = _apply_both(sublayer, x, jc, tc, "prefill")
    _close(to, jo, "prefill out")
    for leaf in tc:
        _close(tc[leaf], jc[leaf], f"prefill {leaf}")


def test_train_forward_matches_reference(sublayer):
    kind, jcfg, cfg, spec, jspec, jp, tp = sublayer
    x = np.random.default_rng(8).standard_normal(
        (2, 23, cfg.d_model)).astype(np.float32)
    jctx, tctx = _ctxs("train", 2, 23)
    jo, jc = KINDS[kind][2](jp, jnp.asarray(x), jspec, jcfg, jctx)
    to, tc = KINDS[kind][3].apply(tp, _t(x), spec, cfg, tctx)
    assert jc is None and tc is None
    _close(to, jo, "train out")


def test_active_mask_keeps_an_inactive_slots_state(sublayer):
    """A decode step with `active` = [True, False, True] writes slots 0
    and 2's new state and gives their outputs, each equal to an unmasked
    step's, and leaves slot 1's recurrent state and conv window bit for
    bit as they were."""
    kind, _, cfg, spec = sublayer[:4]
    tp = sublayer[6]
    mixer = KINDS[kind][3]
    B = 3
    rng = np.random.default_rng(9)
    _, tc = _caches(sublayer, B)
    _, tctx = _ctxs("prefill", B, 6)
    mixer.apply(tp, _t(rng.standard_normal((B, 6, cfg.d_model)).astype(
        np.float32)), spec, cfg, tctx, tc)
    x1 = _t(rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32))
    before = {n: t.clone() for n, t in tc.items()}
    free = {n: t.clone() for n, t in tc.items()}
    _, tctx = _ctxs("decode", B, 1)
    want, _ = mixer.apply(tp, x1, spec, cfg, tctx, free)
    tctx.active = torch.tensor([True, False, True])
    got, _ = mixer.apply(tp, x1, spec, cfg, tctx, tc)
    assert torch.equal(got[[0, 2]], want[[0, 2]])
    assert sorted(tc) == sorted(KINDS[kind][4] + ("conv",))
    for n in tc:
        assert torch.equal(tc[n][1], before[n][1]), n
        assert torch.equal(tc[n][[0, 2]], free[n][[0, 2]]), n
        assert not torch.equal(tc[n][0], before[n][0]), n


@pytest.mark.parametrize("regime", ["stabiliser", "forget", "mixed"])
def test_slstm_cell_matches_reference(regime):
    """The port's in-place cell (head-major) against the reference's
    `_slstm_cell` over eight steps from zero state. "stabiliser": input
    gates near 20, far above log f + m_prev at the first step, so m takes
    them and exp(i - m) stays near 1 where exp(i) is ~5e8; "forget":
    input gates near -20, far below, so m follows log f + m_prev;
    "mixed": each slot and head either way, step by step. (At gates of
    100, float32's rounding of i - m alone is ~1e-5 relative in both.)"""
    B, H, P, steps = 3, 2, 8, 8
    rng = np.random.default_rng(len(regime))
    r = (rng.standard_normal((H, 4, P, P)) / math.sqrt(P)).astype(
        np.float32)
    wx = rng.standard_normal((steps, B, H, 4, P)).astype(np.float32)
    big = {"stabiliser": 20.0, "forget": -20.0}.get(regime)
    if big is None:
        big = np.where(rng.random((steps, B, H, 1)) < 0.5, 20.0, -20.0)
    wx[..., 1, :] += big                       # i far from log f + m
    wx[..., 2, :] += 20.0                      # log f near 0
    j = [jnp.zeros((B, H, P), jnp.float32)] * 4
    h, c, n, m = (torch.zeros(H, B, P) for _ in range(4))
    R = TX.recurrent_weights(_t(r))
    for t in range(steps):
        j = JX._slstm_cell(jnp.asarray(wx[t]), *j, jnp.asarray(r))
        pre = _t(wx[t]).permute(1, 0, 2, 3).reshape(H, B, 4 * P)
        h = TX.slstm_cell_(pre, h, c, n, m, R, torch.empty(H, B, P))
        for name, got, want in zip("hcnm", (h, c, n, m), j):
            assert bool(torch.isfinite(got).all()), (t, name)
            _close(got.transpose(0, 1), want, f"step {t} {name}")
    if regime == "stabiliser":
        assert float(m.min()) > 15.0
    elif regime == "forget":
        assert float(m.max()) < 1.0


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_init_gives_xlstm_constants_in_float32(dtype):
    """Native init sets the constant leaves as the reference does (conv_b
    zeros, norm_scale and gn_scale ones, the mLSTM's b_gates zeros then
    linspace(3, 6, H), the sLSTM's zeros for z and i, linspace(3, 6, d)
    for f and zeros for o, to the reference's float32 rounding: within an
    ulp), in float32 at any dtype; the drawn matrices follow `dtype`."""
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg)[0])
    tp = TM.init_params(cfg, 0, device="cpu", dtype=dtype)
    for k, spec in TM._sublayers(cfg):
        m, jm = tp["groups"][k]["mixer"], jp["groups"][k]["mixer"]
        consts = ("conv_b", "b_gates",
                  "norm_scale" if spec.kind == "mlstm" else "gn_scale")
        assert sorted(m) == sorted(jm), k
        for name, t in m.items():
            assert t.shape == jm[name].shape, (k, name)
            want = torch.float32 if name in consts else dtype
            assert t.dtype == want, (k, name)
        for name in consts:
            np.testing.assert_allclose(m[name].numpy(), jm[name],
                                       rtol=2 ** -23, atol=0,
                                       err_msg=f"{k} {name}")
    d = cfg.d_model
    b = tp["groups"]["L1S0"]["mixer"]["b_gates"][0]
    assert torch.equal(b[:2 * d], torch.zeros(2 * d))
    assert torch.equal(b[3 * d:], torch.zeros(d))
    assert float(b[2 * d]) == 3.0 and float(b[3 * d - 1]) == 6.0


def test_full_width_trees_match_reference_shapes():
    """At full width, on shapes alone (`jax.eval_shape`; nothing is
    made): the reference's `init_params` tree is the port's
    `param_shapes` leaf for leaf, 391,730,272 elements (its analytic
    count is 391,533,760), and `init_cache` at 4 slots is the port's
    leaf for leaf and dtype for dtype, a slot's blob 51,068,928 B of
    float32."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    assert cfg.param_count() == 391_533_760
    tree = jax.eval_shape(lambda key: JM.init_params(key, jcfg)[0],
                          jax.random.PRNGKey(0))
    shapes = TM.param_shapes(cfg)
    paths = sorted(_paths(shapes))
    assert paths == sorted(_paths(jax.tree.map(lambda a: 0, tree)))
    total = 0
    for path in paths:
        want = tree
        for k in path:
            want = want[k]
        assert tuple(TM._at_path(shapes, path)) == want.shape, path
        total += math.prod(want.shape)
    assert total == 391_730_272
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 4, 1024,
                                              dtype=jnp.bfloat16))
    tc = TM.init_cache(cfg, 4, 1024, device="meta")
    assert sorted(_paths(tc)) == sorted(_paths(jax.tree.map(lambda a: 0,
                                                            jc)))
    blob = 0
    for path in _paths(tc):
        want = jc
        for k in path:
            want = want[k]
        got = TM._at_path(tc, path)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
        blob += 4 * got[:, 0].numel()          # one slot, float32
    assert blob == 51_068_928
