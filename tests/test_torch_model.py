"""gemma-2b (reduced, float32) in the PyTorch port against the JAX
reference on the same weights, plus the port's own decode-vs-forward
equivalence.

Logits compare at atol 1e-4: the same float32 function in two frameworks
(the reference additionally carries gemma's scaled embedding in float64,
since its x64 mode promotes the NumPy scalar); observed differences are
about 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import ARCHS, PORTED, get_config
from repro_torch.models import model as TM
from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm
from repro_torch.models import attention, ffn
from repro_torch.models.config import AttnSpec
from repro_torch.models.layers import Ctx

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("gemma-2b", reduced=True)
    cfg = get_config("gemma-2b", reduced=True)
    jparams, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return jcfg, cfg, jparams, tparams, single_device_rules()


def test_config_matches_reference():
    for reduced in (False, True):
        assert repr(get_config("gemma-2b", reduced)) == \
            repr(j_get_config("gemma-2b", reduced))
    assert get_config("gemma-2b").param_count() == 2_506_172_416


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in PORTED])
def test_unported_archs_raise(arch):
    with pytest.raises(NotImplementedError, match=arch):
        get_config(arch)


@pytest.mark.parametrize("B,S,last", [(2, 12, None), (1, 16, 9)])
def test_prefill_logits_match_reference(setup, B, S, last):
    jcfg, cfg, jp, tp, rules = setup
    toks = np.random.default_rng(B).integers(0, cfg.vocab, (B, S))
    jc = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
    jc, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                        compute_dtype=jnp.float32,
                        last_index=None if last is None else
                        jnp.asarray(last, jnp.int32))
    tc = TM.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32, last_index=last)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for leaf in ("k", "v"):
        np.testing.assert_allclose(
            tc["groups"]["L0S0"][leaf].numpy(),
            np.asarray(jc["groups"]["L0S0"][leaf]), atol=ATOL)


def test_per_slot_decode_logits_match_reference(setup):
    """Slots at different fill levels decode together (per-slot index)."""
    jcfg, cfg, jp, tp, rules = setup
    rng = np.random.default_rng(7)
    B, T = 3, 32
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, 10))
    jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                       compute_dtype=jnp.float32)
    tc, _ = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                       compute_dtype=torch.float32)
    index = np.array([4, 10, 7], np.int32)
    for step in range(4):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index), compute_dtype=jnp.float32)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
        index = index + 1
    np.testing.assert_allclose(tc["groups"]["L0S0"]["v"].numpy(),
                               np.asarray(jc["groups"]["L0S0"]["v"]),
                               atol=ATOL)


BF16_ATOL = 1e-2


def test_bf16_logits_and_greedy_tokens_match_reference(setup):
    """bf16 compute on both sides, the same weights and tokens: prefill,
    then 8 greedy decode steps, both fed the reference's greedy tokens.

    The reference runs gemma's residual stream in float64 (its x64 mode
    promotes the NumPy `sqrt(d_model)` of `_embed_tokens`) and so returns
    float32 logits; the port keeps the residual stream and the logits in
    the compute dtype, bf16, as it does on the card. The test follows the
    port's side: every product is bf16 on both, and BF16_ATOL (at a logit
    scale of ~0.5, where one bf16 rounding is ~2e-3) covers the residual
    stream's extra roundings (observed <= 5.5e-3). The port's greedy token
    equals the reference's at every step whose top-2 margin exceeds twice
    the tolerance; a closer pair is a tie at bf16's resolution."""
    jcfg, cfg, jp, tp, rules = setup
    B, S, steps = 2, 12, 8
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S))
    jc = JM.init_cache(jcfg, B, 32, dtype=jnp.bfloat16)
    jc, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                        compute_dtype=jnp.bfloat16)
    tc = TM.init_cache(cfg, B, 32, dtype=torch.bfloat16, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.bfloat16)
    index = np.full(B, S, np.int32)
    separated = 0
    for step in range(steps):
        assert tl.dtype == torch.bfloat16
        j = np.asarray(jl, np.float32)
        t = tl.float().numpy()
        np.testing.assert_allclose(t, j, atol=BF16_ATOL,
                                   err_msg=f"decode step {step}")
        top2 = np.sort(j, axis=-1)[:, -2:]
        sep = top2[:, 1] - top2[:, 0] > 2 * BF16_ATOL
        np.testing.assert_array_equal(t.argmax(-1)[sep], j.argmax(-1)[sep],
                                      err_msg=f"greedy token, step {step}")
        separated += int(sep.sum())
        tok = j.argmax(-1)[:, None].astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index),
                                compute_dtype=jnp.bfloat16)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.bfloat16)
        index = index + 1
    assert separated >= B * steps * 3 // 4, separated


def test_decode_matches_forward(setup):
    """As tests/test_decode_equivalence.py checks for the reference:
    prefill + token-by-token decode equal the parallel forward pass."""
    _, cfg, _, tp, _ = setup
    B, S, S0 = 2, 12, 5
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    par = TM.forward(tp, cfg, toks, compute_dtype=torch.float32)
    cache = TM.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    cache, pre = TM.prefill(tp, cfg, toks[:, :S0], cache,
                            compute_dtype=torch.float32)
    np.testing.assert_allclose(pre.numpy(), par[:, S0 - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for t in range(S0, S):
        cache, dec = TM.decode_step(tp, cfg, toks[:, t:t + 1], cache, t,
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(dec.numpy(), par[:, t].numpy(),
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"decode step {t} diverged")


def _unfused(tp, cfg, tokens, mode, dtype, cache=None, index=None,
             last=None):
    """The stack as composed before the residual add moved into the
    norms: norm, mixer, x + out after every sublayer, then the final norm
    of the stream (of one row at prefill). Returns the logits."""
    B, S = tokens.shape
    x = TM._embed_tokens(tp, cfg, tokens, dtype)
    if mode == "decode":
        idx = torch.as_tensor(index).to(torch.int64)
        ctx = Ctx(mode=mode, positions=idx[:, None], cache_index=idx,
                  compute_dtype=dtype, plain=True)
    else:
        ctx = Ctx(mode=mode, positions=TM._positions(B, S, tokens.device),
                  compute_dtype=dtype, plain=True)
    for g in range(cfg.n_groups):
        for k, spec in TM._sublayers(cfg):
            p = TM._index(tp["groups"][k], g)
            c = (TM._index(cache["groups"][k], g)
                 if cache is not None and k in cache["groups"] else None)
            h = reference_rmsnorm(x, p["norm"]["scale"], cfg.norm_eps)
            if spec.kind == "attn":
                out, _ = attention.apply(p["mixer"], h, spec, cfg, ctx, c)
            else:
                out = ffn.apply(p["mixer"], h, spec, cfg, ctx)
            x = x + out
    if mode == "prefill":
        i = S - 1 if last is None else last
        x = x[:, i:i + 1]
    x = reference_rmsnorm(x, tp["final_norm"]["scale"], cfg.norm_eps)
    logits = TM._logits(tp, cfg, x)
    return logits if mode == "train" else logits[:, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_residual_adds_are_bit_identical_on_the_cpu(setup, dtype):
    """The stack adds each sublayer's output inside the next norm (and the
    last one inside the final norm); on the CPU that is x + out, then the
    plain rmsnorm, so forward, prefill and decode give the unfused
    composition's logits and caches bit for bit."""
    _, cfg, _, tp, _ = setup
    B, S, T = 2, 9, 16
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (B, S + 3)))
    assert torch.equal(TM.forward(tp, cfg, toks[:, :S], compute_dtype=dtype),
                       _unfused(tp, cfg, toks[:, :S], "train", dtype))
    for last in (None, 5):
        got_c = TM.init_cache(cfg, B, T, dtype=dtype, device="cpu")
        want_c = TM.init_cache(cfg, B, T, dtype=dtype, device="cpu")
        got_c, got = TM.prefill(tp, cfg, toks[:, :S], got_c,
                                compute_dtype=dtype, last_index=last)
        want = _unfused(tp, cfg, toks[:, :S], "prefill", dtype, want_c,
                        last=last)
        assert torch.equal(got, want), last
    index = np.array([S, S - 2], np.int64)
    for step in range(3):
        tok = toks[:, S + step:S + step + 1]
        got_c, got = TM.decode_step(tp, cfg, tok, got_c,
                                    torch.from_numpy(index),
                                    compute_dtype=dtype)
        want = _unfused(tp, cfg, tok, "decode", dtype, want_c,
                        index=torch.from_numpy(index))
        assert torch.equal(got, want), f"decode step {step}"
        index = index + 1
    for k in got_c["groups"]:
        for leaf in ("k", "v"):
            assert torch.equal(got_c["groups"][k][leaf],
                               want_c["groups"][k][leaf])


def test_forward_matches_reference(setup):
    jcfg, cfg, jp, tp, rules = setup
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10))
    jl, _ = JM.forward(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                       compute_dtype=jnp.float32, remat=False)
    tl = TM.forward(tp, cfg, torch.from_numpy(toks),
                    compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_init_distributions(dtype):
    cfg = get_config("gemma-2b", reduced=True)
    p = TM.init_params(cfg, 3, device="cpu", dtype=dtype)
    shapes = TM.param_shapes(cfg)
    assert p["embed"].shape == shapes["embed"]
    assert p["embed"].dtype == dtype
    assert p["final_norm"]["scale"].dtype == torch.float32
    assert torch.equal(p["groups"]["L0S0"]["norm"]["scale"],
                       torch.ones(cfg.n_groups, cfg.d_model))
    emb = p["embed"].float()
    # truncated at 2 sigma, up to one bf16 rounding
    assert emb.abs().max() <= 2 * 0.02 * (1 + 2 ** -8)
    # a normal truncated at 2 sigma keeps 0.88 of its standard deviation
    assert abs(float(emb.std()) / 0.02 - 0.88) < 0.03
    wq = p["groups"]["L0S0"]["mixer"]["wq"].float()
    assert wq.shape == (cfg.n_groups, cfg.d_model, 4, 32)
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 0.88) < 0.05
    again = TM.init_params(cfg, 3, device="cpu", dtype=dtype)
    assert torch.equal(again["embed"], p["embed"])


def test_params_from_jax_rejects_a_mismatched_tree(setup):
    _, cfg, jp, _, _ = setup
    tree = jax.tree.map(np.asarray, jp)
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        TM.params_from_jax(tree, cfg, device="cpu")
    tree = jax.tree.map(np.asarray, jp)
    tree["embed"] = tree["embed"][:10]
    with pytest.raises(ValueError, match="embed: shape"):
        TM.params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("change", [
    dict(sliding_window=16), dict(logit_softcap=30.0),
    dict(rope="mrope"), dict(cross=True), dict(qk_norm=True)])
def test_unported_attention_features_raise(change):
    import dataclasses
    cfg = get_config("gemma-2b", reduced=True)
    layer = (dataclasses.replace(cfg.pattern[0][0], **change),
             cfg.pattern[0][1])
    bad = dataclasses.replace(cfg, pattern=(layer,))
    with pytest.raises(NotImplementedError):
        TM.init_params(bad, 0, device="cpu")


def test_int8_kv_cache_is_not_ported_yet():
    cfg = get_config("gemma-2b", reduced=True)
    with pytest.raises(NotImplementedError, match="int8"):
        TM.init_cache(cfg, 1, 8, dtype=torch.int8, device="cpu")


def test_unported_sublayer_kinds_raise():
    import dataclasses
    from repro_torch.models.config import MoeSpec
    cfg = get_config("gemma-2b", reduced=True)
    bad = dataclasses.replace(cfg, pattern=(
        (AttnSpec(n_heads=4, n_kv=1, head_dim=32),
         MoeSpec(n_experts=4, top_k=2, d_ff=64)),))
    with pytest.raises(NotImplementedError, match="moe"):
        TM.init_cache(bad, 1, 8, device="cpu")
