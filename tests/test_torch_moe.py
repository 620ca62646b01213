"""The port's MoE sublayer (`repro_torch.models.moe`) and qk-norm against
the JAX reference's (`repro.models.moe`, `rms_norm_heads`), float32, on
the CPU, the inputs drawn from a numpy seed and the reference run under
`single_device_rules()`: reduced qwen3-moe (top-2) and reduced
llama4-maverick (top-1, gates not renormalised, with an always-on shared
expert, in the second layer of a two-layer group).

The kept set (which token choices the static capacity keeps) is read
from each package's own `apply` by replacing its expert FFN with one
whose output at expert e is the unit vector e: a token's output is then
the sum of its kept choices' gates at their experts' coordinates, and a
choice is kept exactly where that coordinate is not zero (gates are
softmax probabilities, never zero)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as JMoe
from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import MoeSpec as JMoeSpec
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMoe
from repro_torch.models.config import MoeSpec
from repro_torch.models.layers import Ctx

ARCH = "qwen3-moe-235b-a22b"
TOP1 = "llama4-maverick-400b-a17b"
ATOL = 1e-5


@pytest.fixture(scope="module")
def rules():
    return single_device_rules()


def _cfgs(arch=ARCH, **moe):
    """Reduced `arch` on both sides (qwen3-moe: 8 experts top-2 of d_ff 96
    at d_model 64; llama4: 4 experts top-1 of d_ff 128 and a shared expert
    of 128 in the second of its two layers), the MoE spec of every layer
    of its pattern changed by `moe`."""
    jcfg = j_get_config(arch, reduced=True)
    cfg = get_config(arch, reduced=True)

    def fix(c, spec_cls):
        return dataclasses.replace(c, pattern=tuple(
            tuple(dataclasses.replace(s, **moe)
                  if isinstance(s, spec_cls) else s for s in layer)
            for layer in c.pattern))
    return fix(jcfg, JMoeSpec), fix(cfg, MoeSpec)


def _moe_spec(c):
    """The MoE sublayer's spec of a config's pattern."""
    return next(s for layer in c.pattern for s in layer if s.kind == "moe")


def _layer(jcfg, cfg, seed=0):
    """One MoE sublayer's reference params and the port's copy."""
    jspec, spec = _moe_spec(jcfg), _moe_spec(cfg)
    jp, _ = JMoe.init(jax.random.PRNGKey(seed), jcfg, jspec)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jspec, spec, jp, tp


def _jctx(rules, B, S):
    return JL.Ctx(rules=rules, mode="prefill",
                  positions=jnp.zeros((B, S), jnp.int32),
                  compute_dtype=jnp.float32)


def _tctx(B, S):
    return Ctx(mode="prefill",
               positions=torch.zeros(B, S, dtype=torch.int64),
               compute_dtype=torch.float32)


def _x(B, S, D, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _kept(monkeypatch, rules, jcfg, cfg, x, seed=0):
    """(reference kept [T,K], port kept [T,K], reference ids [T,K]) of one
    MoE call on x [B,S,D], read through a unit-vector expert FFN."""
    jspec, spec, jp, tp = _layer(jcfg, cfg, seed)
    B, S, D = x.shape
    E, K = spec.n_experts, spec.top_k
    assert D >= E
    monkeypatch.setattr(JMoe, "_expert_ffn", lambda buf, *a:
                        jnp.broadcast_to(jnp.eye(E, D, dtype=buf.dtype)
                                         [:, None, :], buf.shape))
    monkeypatch.setattr(TMoe, "_expert_ffn", lambda buf, *a: torch.eye(
        E, D, dtype=buf.dtype)[:, None, :].expand(buf.shape))
    jy = np.asarray(JMoe.apply(jp, jnp.asarray(x), jspec, jcfg,
                               _jctx(rules, B, S))).reshape(B * S, D)
    ty = TMoe.apply(tp, torch.from_numpy(x), spec, cfg,
                    _tctx(B, S)).numpy().reshape(B * S, D)
    _, idx = JMoe._route(jp, jnp.asarray(x), jspec, _jctx(rules, B, S))
    ids = np.asarray(idx).reshape(B * S, K)
    rows = np.arange(B * S)[:, None]
    return jy[rows, ids] != 0, ty[rows, ids] != 0, ids


def test_route_matches_reference(rules):
    jcfg, cfg = _cfgs()
    jspec, spec, jp, tp = _layer(jcfg, cfg)
    x = _x(3, 40, cfg.d_model, 0)
    jg, ji = JMoe._route(jp, jnp.asarray(x), jspec, _jctx(rules, 3, 40))
    tg, ti = TMoe.route(tp, torch.from_numpy(x), spec, _tctx(3, 40))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    np.testing.assert_allclose(tg.numpy().sum(-1), 1.0, atol=1e-6)


def test_route_breaks_exact_ties_to_the_lower_id(rules):
    """A zero router gives every expert the same probability: jax.lax.top_k
    keeps ids 0..K-1, and so does the port."""
    jcfg, cfg = _cfgs(n_experts=8, top_k=3)
    jspec, spec, jp, tp = _layer(jcfg, cfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = _x(1, 5, cfg.d_model, 1)
    _, ji = JMoe._route(jp, jnp.asarray(x), jspec, _jctx(rules, 1, 5))
    _, ti = TMoe.route(tp, torch.from_numpy(x), spec, _tctx(1, 5))
    np.testing.assert_array_equal(np.asarray(ji),
                                  np.tile([0, 1, 2], (1, 5, 1)))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_kept_set_matches_reference_with_drops(monkeypatch, rules):
    """A 256-token prefill at reduced qwen3-moe's capacity factor 1.25:
    cap 80 slots an expert against a mean of 64 choices, so some choices
    are dropped; the port keeps exactly the reference's."""
    jcfg, cfg = _cfgs()
    x = _x(1, 256, cfg.d_model, 2)
    jk, tk, _ = _kept(monkeypatch, rules, jcfg, cfg, x)
    assert TMoe.capacity(_moe_spec(cfg), 256) == 80
    assert (~jk).sum() > 0, "no choice was dropped"
    np.testing.assert_array_equal(tk, jk)


def test_dispatch_keeps_choices_in_token_major_order():
    idx = torch.tensor([[0, 1], [1, 0], [0, 2], [0, 1], [1, 2]])
    slot, keep = TMoe.dispatch(idx, 3, 2)
    np.testing.assert_array_equal(keep.numpy(), [[1, 1], [1, 1], [0, 1],
                                                 [0, 0], [0, 1]])
    np.testing.assert_array_equal(slot[keep].numpy(),
                                  [0, 2, 3, 1, 4, 5])


def test_bucket_pads_count_toward_capacity(monkeypatch, rules):
    """The engine right-pads a prompt to a power-of-two bucket; the pads
    route and count in T, after every real token. A 100-token prompt in
    bucket 128 gets cap 40 instead of 32, so real choices dropped without
    the pads are kept with them; the padded call's kept set is the
    reference's, and the model's prefill logits at the last real token
    equal the reference's."""
    jcfg, cfg = _cfgs()
    spec = _moe_spec(cfg)
    S, L = 100, 128
    assert (TMoe.capacity(spec, S), TMoe.capacity(spec, L)) == (32, 40)
    # one direction shared by every token skews the routing toward a few
    # experts, as a real prompt's would be skewed
    real = _x(1, S, cfg.d_model, 3) + 2.0 * _x(1, 1, cfg.d_model, 9)
    padded = np.concatenate(
        [real, np.broadcast_to(_x(1, 1, cfg.d_model, 4), (1, L - S,
                                                         cfg.d_model))], 1)
    jk_real, tk_real, ids = _kept(monkeypatch, rules, jcfg, cfg, real)
    jk_pad, tk_pad, ids_pad = _kept(monkeypatch, rules, jcfg, cfg, padded)
    np.testing.assert_array_equal(tk_real, jk_real)
    np.testing.assert_array_equal(tk_pad, jk_pad)
    np.testing.assert_array_equal(ids_pad[:S], ids)
    assert (~jk_real).sum() > (~jk_pad[:S]).sum() > 0
    monkeypatch.undo()
    # the whole model at the engine's bucket: the reference's logits
    jcfg, cfg = j_get_config(ARCH, reduced=True), get_config(ARCH,
                                                             reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    toks = np.zeros((1, L), np.int64)
    toks[0, :S] = np.random.default_rng(5).integers(1, cfg.vocab, S)
    jc = JM.init_cache(jcfg, 1, L + 1, dtype=jnp.float32)
    _, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                       compute_dtype=jnp.float32,
                       last_index=jnp.asarray(S - 1, jnp.int32))
    tc = TM.init_cache(cfg, 1, L + 1, dtype=torch.float32, device="cpu")
    _, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                       compute_dtype=torch.float32, last_index=S - 1)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)


@pytest.mark.parametrize("shared_d_ff", [0, 32])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_apply_matches_reference(rules, act, shared_d_ff):
    """The whole sublayer, drops present, in each activation, with and
    without the always-on shared expert."""
    jcfg, cfg = _cfgs(act=act, shared_d_ff=shared_d_ff)
    jspec, spec, jp, tp = _layer(jcfg, cfg, seed=1)
    assert ("w_gate" in tp) == (act != "gelu")
    assert ("shared" in tp) == bool(shared_d_ff)
    assert set(tp) == set(TMoe.param_shapes(cfg, spec))
    x = _x(2, 96, cfg.d_model, 6)
    jy = JMoe.apply(jp, jnp.asarray(x), jspec, jcfg, _jctx(rules, 2, 96))
    ty = TMoe.apply(tp, torch.from_numpy(x), spec, cfg, _tctx(2, 96))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_top1_route_keeps_the_top_probability(rules):
    """llama4's top-1 routing: the ids and gates equal the reference's,
    and a gate is its expert's softmax probability, not renormalised to 1
    (the reference renormalises only when k > 1)."""
    jcfg, cfg = _cfgs(TOP1)
    jspec, spec, jp, tp = _layer(jcfg, cfg)
    assert (spec.top_k, spec.shared_d_ff) == (1, 128)
    x = _x(3, 40, cfg.d_model, 10)
    jg, ji = JMoe._route(jp, jnp.asarray(x), jspec, _jctx(rules, 3, 40))
    tg, ti = TMoe.route(tp, torch.from_numpy(x), spec, _tctx(3, 40))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6)
    probs = torch.softmax(torch.einsum("bsd,de->bse", torch.from_numpy(x),
                                       tp["router"]), -1)
    np.testing.assert_allclose(tg.numpy(), probs.max(-1, keepdim=True)
                               .values.numpy(), atol=1e-6)
    assert float(tg.max()) < 1.0 - 1e-3


def test_top1_kept_set_matches_reference_with_drops(monkeypatch, rules):
    """A 256-token call at llama4's capacity factor 1.25 and top-1: cap 80
    slots an expert against a mean of 64 choices, so some are dropped; the
    port keeps exactly the reference's. The shared expert is off here, as
    it would add to every coordinate the kept set is read from."""
    jcfg, cfg = _cfgs(TOP1, shared_d_ff=0)
    x = _x(1, 256, cfg.d_model, 11) + 2.0 * _x(1, 1, cfg.d_model, 12)
    jk, tk, ids = _kept(monkeypatch, rules, jcfg, cfg, x)
    assert TMoe.capacity(_moe_spec(cfg), 256) == 80
    assert ids.shape == (256, 1)
    assert (~jk).sum() > 0, "no choice was dropped"
    np.testing.assert_array_equal(tk, jk)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu"])
def test_top1_apply_with_a_shared_expert_matches_reference(rules, act):
    """llama4's whole MoE sublayer, top-1 with its always-on shared expert,
    drops present (a skewed 2 x 128-token call), in each activation."""
    jcfg, cfg = _cfgs(TOP1, act=act)
    jspec, spec, jp, tp = _layer(jcfg, cfg, seed=2)
    assert "shared" in tp and ("w_gate" in tp) == (act != "gelu")
    x = _x(2, 128, cfg.d_model, 13) + 2.0 * _x(1, 1, cfg.d_model, 14)
    _, idx = TMoe.route(tp, torch.from_numpy(x), spec, _tctx(2, 128))
    _, keep = TMoe.dispatch(idx.reshape(-1, 1), spec.n_experts,
                            TMoe.capacity(spec, 256))
    assert not bool(keep.all()), "no choice was dropped"
    jy = JMoe.apply(jp, jnp.asarray(x), jspec, jcfg, _jctx(rules, 2, 128))
    ty = TMoe.apply(tp, torch.from_numpy(x), spec, cfg, _tctx(2, 128))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL)


def test_rms_norm_heads_matches_reference():
    x = _x(2, 5, 4 * 16, 7).reshape(2, 5, 4, 16)
    scale = 1.0 + 0.1 * np.random.default_rng(8).standard_normal(16).astype(
        np.float32)
    want = np.asarray(JL.rms_norm_heads(jnp.asarray(x), jnp.asarray(scale),
                                        1e-6))
    for plain in (False, True):
        got = TL.rms_norm_heads(torch.from_numpy(x), torch.from_numpy(scale),
                                1e-6, plain)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qk_scales_are_float32_ones(dtype):
    """The qk-norm scales' path has no "norm" in it, yet both native init
    and `params_from_jax` keep them float32 ones (as the rmsnorm kernel
    takes its scale) while the matrices take `dtype`."""
    cfg = get_config(ARCH, reduced=True)
    attn = cfg.pattern[0][0]
    jp, _ = JM.init_params(jax.random.PRNGKey(0),
                           j_get_config(ARCH, reduced=True))
    for p in (TM.init_params(cfg, 0, device="cpu", dtype=dtype),
              TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                 device="cpu", dtype=dtype)):
        mixer = p["groups"]["L0S0"]["mixer"]
        for n in ("q_scale", "k_scale"):
            assert mixer[n].dtype == torch.float32, n
            assert torch.equal(mixer[n],
                               torch.ones(cfg.n_groups, attn.head_dim)), n
        assert mixer["wq"].dtype == dtype
        assert p["groups"]["L0S1"]["mixer"]["router"].dtype == dtype
        assert p["groups"]["L0S1"]["mixer"]["w_in"].dtype == dtype


def test_model_logits_match_reference_with_drops(monkeypatch, rules):
    """Reduced qwen3-moe end to end, float32: a prefill of 2 x 64 tokens
    (cap 40 an expert against a mean of 32 choices) that drops choices,
    then per-slot decode at ragged fill levels; logits at the model
    tests' ATOL, and the port's drops counted through its dispatch."""
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    dropped = []
    dispatch = TMoe.dispatch

    def counted(idx, n_experts, cap):
        slot, keep = dispatch(idx, n_experts, cap)
        dropped.append(int((~keep).sum()))
        return slot, keep
    monkeypatch.setattr(TMoe, "dispatch", counted)
    B, S, T = 2, 64, 80
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab, (B, S))
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    jc, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                        compute_dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32)
    assert sum(dropped) > 0, "the prefill dropped no choice"
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    index = np.array([40, 64], np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index),
                                compute_dtype=jnp.float32)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   err_msg=f"decode step {step}")
        index = index + 1
