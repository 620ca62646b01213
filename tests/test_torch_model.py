"""The ported dense configs (reduced, float32) in the PyTorch port
against the JAX reference on the same weights, plus the port's own
decode-vs-forward equivalence: gemma-2b (MQA, GeGLU, tied and scaled
embeddings), deepseek-7b (MHA, SwiGLU, an untied unembed, no embedding
scale), mistral-nemo-12b (GQA 2:1 reduced, 4:1 at full width,
SwiGLU, untied; at full width its query width 32 x 128 = 4096 is not
its d_model 5120, which a widened reduced variant covers here) and
granite-20b (MQA, 4:1 reduced and 48:1 at full width, a plain GELU FFN,
tied embeddings without a scale) and qwen3-moe-235b-a22b (GQA with
qk-norm, and a mixture-of-experts sublayer: 8 experts top-2 reduced, 128
top-8 at full width, static capacity with drops) and
llama4-maverick-400b-a17b (a group of two layers, a dense FFN layer and
an MoE layer of top-1 routing with an always-on shared expert; GQA 2:1
reduced, 5:1 at full width) and zamba2-7b (Mamba-2 layers, an attention
and FFN pair whose weights all groups share, a non-repeating tail of
Mamba-2 layers; MHA) and xlstm-350m (alternating mLSTM and sLSTM
sublayers, no attention and no FFN) and qwen2-vl-2b (M-RoPE, GQA 2:1
reduced and 6:1 at full width, SwiGLU, tied embeddings; served on tokens
alone, so its three position streams are the index; the vision prefix
is held in tests/test_torch_mrope.py) and whisper-medium (an encoder of
non-causal self-attention over frame embeddings with sinusoidal
positions, a decoder of causal self-attention and cross-attention onto
the encoder's output, no positions at all in the decoder (rope="none"),
LayerNorm, GELU FFN, tied embeddings; every call here takes random
frames, made with numpy, on both sides; its own parts are held in
tests/test_torch_whisper.py). Native init draws each stacked
weight in place, bit for bit as a draw-then-stack loop would, and a
stack above `DRAW_SLICE_ELEMENTS` one expert at a time. Caches compare
leaf by leaf, the tail's and the recurrent state (Mamba-2's, the mLSTM's
and the sLSTM's) included.

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
from repro_torch.models.config import AttnSpec
from repro_torch.models.layers import Ctx, layer_norm

ATOL = 1e-4
# each ported config with its full-width parameter count
DENSE = {"gemma-2b": 2_506_172_416, "deepseek-7b": 6_910_365_696,
         "mistral-nemo-12b": 12_247_782_400, "granite-20b": 20_013_766_656,
         "qwen3-moe-235b-a22b": 235_093_634_560,
         "llama4-maverick-400b-a17b": 397_691_950_080,
         "zamba2-7b": 6_635_849_952, "xlstm-350m": 391_533_760,
         "qwen2-vl-2b": 1_543_656_960, "whisper-medium": 757_877_760}


def _frames(cfg, B, seed=0):
    """Random frame embeddings [B, n_frames, d_model] (float32 numpy) for
    a config with an encoder, None for any other."""
    if cfg.encoder is None:
        return None
    return np.random.default_rng(100 + seed).standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


def _jbatch(toks, frames):
    """The reference's batch of tokens, and of frames where there are."""
    batch = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        batch["frames"] = jnp.asarray(frames)
    return batch


def _tframes(frames):
    return None if frames is None else torch.from_numpy(frames)


def _has_moe(cfg) -> bool:
    return any(s.kind == "moe" for _, _, _, s in cfg.sublayers())


def _recurrent(cfg) -> bool:
    """A config with recurrent state (Mamba-2, mLSTM, sLSTM), which
    carries each step's rounding into every later step."""
    return any(s.kind in ("mamba2", "mlstm", "slstm")
               for _, _, _, s in cfg.sublayers())


def _no_drop(cfg):
    """As tests/test_decode_equivalence.py does: MoE capacity raised so
    no choice is dropped, since capacity is a function of the call's own
    token count and prefill(S0) and forward(S) drop different choices at
    finite capacity, by design."""
    import dataclasses
    from repro_torch.models.config import MoeSpec
    return dataclasses.replace(cfg, pattern=tuple(
        tuple(dataclasses.replace(s, capacity_factor=64.0)
              if isinstance(s, MoeSpec) else s for s in layer)
        for layer in cfg.pattern))


def _cache_keys(cfg):
    """The cache's keys by part: every attention and recurrent (Mamba-2,
    mLSTM, sLSTM) sublayer of the group, and of the tail."""
    return {"groups": [k for k, spec in TM._sublayers(cfg)
                       if spec.kind in TM._CACHED],
            "tail": [k for k, spec in TM._tail(cfg)
                     if spec.kind in TM._CACHED]}


def _assert_caches_close(tc, jc, cfg, atol=ATOL):
    """The port's cache against the reference's, leaf by leaf (K/V, the
    recurrent state and the conv window), in both parts."""
    for part, keys in _cache_keys(cfg).items():
        assert sorted(tc[part]) == sorted(jc[part]) == keys, part
        for key in keys:
            assert sorted(tc[part][key]) == sorted(jc[part][key])
            for leaf, got in tc[part][key].items():
                want = np.asarray(jc[part][key][leaf])
                assert got.shape == want.shape, (part, key, leaf)
                np.testing.assert_allclose(got.numpy(), want, atol=atol,
                                           err_msg=f"{part} {key} {leaf}")


@pytest.fixture(scope="module", params=sorted(DENSE))
def setup(request):
    jcfg = j_get_config(request.param, reduced=True)
    cfg = get_config(request.param, reduced=True)
    jparams, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = TM.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 device="cpu")
    return jcfg, cfg, jparams, tparams, single_device_rules()


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_config_matches_reference(arch):
    for reduced in (False, True):
        assert repr(get_config(arch, reduced)) == \
            repr(j_get_config(arch, reduced))
    assert get_config(arch).param_count() == DENSE[arch]
    assert arch in PORTED


def test_every_arch_is_ported_and_an_unknown_one_raises():
    assert sorted(PORTED) == sorted(ARCHS)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")


def _with(cfg, **change):
    """`cfg` with `change` made to every attention sublayer's spec (keys
    of AttnSpec) or to the config itself (any other key)."""
    import dataclasses
    spec_keys = {f.name for f in dataclasses.fields(AttnSpec)}
    attn = {k: v for k, v in change.items() if k in spec_keys}
    top = {k: v for k, v in change.items() if k not in spec_keys}
    return dataclasses.replace(cfg, pattern=tuple(
        tuple(dataclasses.replace(s, **attn) if s.kind == "attn" else s
              for s in layer) for layer in cfg.pattern), **top)


def test_non_causal_self_attention_with_a_cache_matches_reference():
    """No reference config has a non-causal decoder self-attention; the
    port builds one as the reference does: a prefill and a decode step
    attend over every row of the cache (the unfilled rows too), and a
    train forward over the whole sequence. Reduced deepseek-7b with
    causal=False on both sides, float32 logits at ATOL."""
    import dataclasses

    def non_causal(cfg):
        return dataclasses.replace(cfg, pattern=tuple(
            tuple(dataclasses.replace(s, causal=False) if s.kind == "attn"
                  else s for s in layer) for layer in cfg.pattern))
    jcfg = non_causal(j_get_config("deepseek-7b", reduced=True))
    cfg = non_causal(get_config("deepseek-7b", reduced=True))
    assert repr(cfg) == repr(jcfg)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rules = single_device_rules()
    rng = np.random.default_rng(21)
    B, S, T = 2, 9, 16
    toks = rng.integers(0, cfg.vocab, (B, S))
    jl, _ = JM.forward(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                       compute_dtype=jnp.float32, remat=False)
    tl = TM.forward(tp, cfg, torch.from_numpy(toks),
                    compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    jc, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                        compute_dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    index = np.array([S, S - 3], np.int32)
    for step in range(2):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index), compute_dtype=jnp.float32)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
        index = index + 1
    _assert_caches_close(tc, jc, cfg)


@pytest.mark.parametrize("feature", ["int8 KV", "logit_softcap",
                                     "final_logit_softcap",
                                     "sliding_window"])
def test_unported_features_raise(feature):
    """The features no ported config uses still raise, each on reduced
    whisper-medium (which reaches every other part of the reference's
    model) changed to use it."""
    cfg = get_config("whisper-medium", reduced=True)
    TM.init_cache(cfg, 1, 8, dtype=torch.float32, device="cpu")
    if feature == "int8 KV":
        with pytest.raises(NotImplementedError, match="int8"):
            TM.init_cache(cfg, 1, 8, dtype=torch.int8, device="cpu")
        return
    bad = _with(cfg, **{"logit_softcap": dict(logit_softcap=30.0),
                        "final_logit_softcap": dict(
                            final_logit_softcap=30.0),
                        "sliding_window": dict(sliding_window=16)}[feature])
    with pytest.raises(NotImplementedError, match=feature):
        TM.init_params(bad, 0, device="cpu")


@pytest.mark.parametrize("B,S,last", [(2, 12, None), (1, 16, 9)])
def test_prefill_logits_match_reference(setup, B, S, last):
    jcfg, cfg, jp, tp, rules = setup
    toks = np.random.default_rng(B).integers(0, cfg.vocab, (B, S))
    frames = _frames(cfg, B, S)
    jc = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
    jc, jl = JM.prefill(jp, jcfg, rules, _jbatch(toks, frames), jc,
                        compute_dtype=jnp.float32,
                        last_index=None if last is None else
                        jnp.asarray(last, jnp.int32))
    tc = TM.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32, last_index=last,
                        frames=_tframes(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_caches_close(tc, jc, cfg)


def test_per_slot_decode_logits_match_reference(setup):
    """Slots at different fill levels decode together (per-slot index)."""
    jcfg, cfg, jp, tp, rules = setup
    rng = np.random.default_rng(7)
    B, T = 3, 32
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    toks = rng.integers(0, cfg.vocab, (B, 10))
    frames = _frames(cfg, B)
    jc, _ = JM.prefill(jp, jcfg, rules, _jbatch(toks, frames), jc,
                       compute_dtype=jnp.float32)
    tc, _ = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                       compute_dtype=torch.float32, frames=_tframes(frames))
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
    _assert_caches_close(tc, jc, cfg)


def test_query_width_unlike_d_model_matches_reference():
    """mistral-nemo-12b projects d_model 5120 to 32 query heads of 128
    (4096) and back; no shipped reduced config has a query width other
    than its d_model. Its reduced config widened to d_model 80 (4 heads
    of 16 = 64) at its published rope theta 1e6, on both sides: prefill
    and per-slot decode logits at ATOL."""
    import dataclasses
    change = dict(d_model=80, rope_theta=1e6)
    jcfg = dataclasses.replace(
        j_get_config("mistral-nemo-12b", reduced=True), **change)
    cfg = dataclasses.replace(
        get_config("mistral-nemo-12b", reduced=True), **change)
    assert repr(cfg) == repr(jcfg)
    attn = cfg.pattern[0][0]
    assert attn.n_heads * attn.head_dim != cfg.d_model
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert tuple(tp["groups"]["L0S0"]["mixer"]["wq"].shape) == \
        (cfg.n_groups, 80, attn.n_heads, attn.head_dim)
    rules = single_device_rules()
    rng = np.random.default_rng(13)
    B, S, T = 3, 10, 32
    toks = rng.integers(0, cfg.vocab, (B, S))
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    jc, jl = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)}, jc,
                        compute_dtype=jnp.float32)
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    index = np.array([4, 10, 7], np.int32)
    for step in range(3):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index), compute_dtype=jnp.float32)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"decode step {step}")
        index = index + 1


BF16_ATOL = 1e-2
MIN_SEPARATED = 12      # slot-steps whose greedy token is compared
# MoE configs: a slot-step is held where the reference's router logits of
# the step's own tokens, at every MoE sublayer, put at least ROUTE_MARGIN
# between the k-th and the (k+1)-th expert; below it the two are a tie at
# bf16's resolution, and a swapped expert moves the logits past BF16_ATOL
ROUTE_MARGIN = 0.03
MIN_ROUTED = 16         # MoE slot-steps held to the reference's logits
MIN_SEPARATED_MOE = 8   # of them, slot-steps whose greedy token is compared


def _route_margins(monkeypatch, cfg):
    """Wraps the reference's router so that each call reports, a slot at
    a time, the least logit margin between its k-th and (k+1)-th expert
    over the call's tokens; returns the list the margins land in (one
    [B] array a MoE call, through an ordered debug callback, so it works
    inside the reference's scan)."""
    import repro.models.moe as JMoe
    seen = []
    if not _has_moe(cfg):
        return seen
    route = JMoe._route

    def noted(params, x, spec, ctx):
        logits = jnp.einsum("bsd,de->bse", x, params["router"].astype(
            ctx.compute_dtype)).astype(jnp.float32)
        top = jax.lax.top_k(logits, spec.top_k + 1)[0]
        margin = (top[..., -2] - top[..., -1]).min(-1)
        jax.debug.callback(lambda m: seen.append(np.asarray(m)), margin,
                           ordered=True)
        return route(params, x, spec, ctx)
    monkeypatch.setattr(JMoe, "_route", noted)
    return seen


def _held(seen, B):
    """Slots whose routing cleared ROUTE_MARGIN in the calls since the
    last read (every slot for a config without MoE)."""
    if not seen:
        return np.ones(B, bool)
    jax.effects_barrier()
    held = np.min(np.stack(seen), 0) > ROUTE_MARGIN
    seen.clear()
    return held


def test_bf16_logits_and_greedy_tokens_match_reference(setup, monkeypatch):
    """bf16 compute on both sides, the same weights and tokens: prefill,
    then 16 greedy decode steps, both fed the reference's greedy tokens.

    The reference runs gemma's residual stream in float64 (its x64 mode
    promotes the NumPy `sqrt(d_model)` of `_embed_tokens`) and so returns
    float32 logits; the port keeps the residual stream and the logits in
    the compute dtype, bf16, as it does on the card. The test follows the
    port's side: every product is bf16 on both, and BF16_ATOL (at a logit
    scale of ~0.5, where one bf16 rounding is ~2e-3) covers the residual
    stream's extra roundings (observed <= 7.3e-3). deepseek-7b and
    mistral-nemo-12b have no embedding scale, so both sides keep their
    stream and logits in bf16 and differ only in where they round
    (observed <= 6.4e-3 on each). The port's
    greedy token equals the reference's at every step whose top-2 margin
    exceeds twice the tolerance; a closer pair is a tie at bf16's
    resolution. Which steps those are depends on the reference's logits
    alone: at least MIN_SEPARATED slot-steps must be held to the greedy
    token (reduced gemma-2b's margins exceed twice the tolerance at ~80%
    of slot-steps, deepseek-7b's at ~68%, mistral-nemo-12b's at ~55%).

    Routing is a discrete choice: for qwen3-moe a slot-step is held (its
    logits, then its greedy token) only where the reference's routing of
    that step's tokens clears ROUTE_MARGIN at every MoE sublayer (the
    prefill's: every prompt token's). Reduced qwen3-moe holds 23 of the
    32 slot-steps (at least MIN_ROUTED must be), its held logits within
    6.8e-3, and compares the greedy token at 13 of them; one it leaves
    out (margin 0.004) is 0.093 off, a swapped expert.

    Recurrent state carries every step's rounding into the next: reduced
    zamba2-7b's bf16 logits lie 0.0078-0.0153 from its own float32 run
    (the reference's, and the port's alike), against 0.007 for
    deepseek-7b. For a recurrent config the reference also runs in
    float32 on the same tokens, and each step's tolerance is the larger
    of BF16_ATOL and twice the reference's own bf16 distance from it
    (the rule `_first_step` holds the kernels to on the card); a config
    without recurrent state keeps BF16_ATOL. Its margins clear twice that
    larger tolerance less often, so it decodes 32 steps: reduced
    zamba2-7b 0.0132 observed against bounds of 0.0142-0.0590, 23
    slot-steps held to the greedy token (0.0107 and 14 over 16 steps);
    reduced xlstm-350m 0.0166 against 0.0188-0.0428, 14 held (7 over 16
    steps)."""
    jcfg, cfg, jp, tp, rules = setup
    seen = _route_margins(monkeypatch, cfg)
    B, S = 2, 12
    # a recurrent config's tolerance is its noise floor, above BF16_ATOL,
    # so fewer of its margins clear twice the tolerance: it decodes twice
    # the steps
    floor = _recurrent(cfg)
    steps = 32 if floor else 16
    T = max(32, S + steps)
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S))
    frames = _frames(cfg, B, 11)
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.bfloat16)
    jc, jl = JM.prefill(jp, jcfg, rules, _jbatch(toks, frames), jc,
                        compute_dtype=jnp.bfloat16)
    tc = TM.init_cache(cfg, B, T, dtype=torch.bfloat16, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.bfloat16,
                        frames=_tframes(frames))
    # a recurrent config's reference also runs in float32 on the same
    # tokens: its distance from the bf16 run is the step's noise floor
    if floor:
        jc32 = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
        jc32, jl32 = JM.prefill(jp, jcfg, rules, _jbatch(toks, frames),
                                jc32, compute_dtype=jnp.float32)
    index = np.full(B, S, np.int32)
    separated = routed = 0
    for step in range(steps):
        assert tl.dtype == torch.bfloat16
        held = _held(seen, B)
        j = np.asarray(jl, np.float32)
        t = tl.float().numpy()
        tol = BF16_ATOL
        if floor:
            tol = max(tol, 2 * float(np.abs(j - np.asarray(jl32)).max()))
        np.testing.assert_allclose(t[held], j[held], atol=tol,
                                   err_msg=f"decode step {step}")
        top2 = np.sort(j, axis=-1)[:, -2:]
        sep = held & (top2[:, 1] - top2[:, 0] > 2 * tol)
        np.testing.assert_array_equal(t.argmax(-1)[sep], j.argmax(-1)[sep],
                                      err_msg=f"greedy token, step {step}")
        separated += int(sep.sum())
        routed += int(held.sum())
        tok = j.argmax(-1)[:, None].astype(np.int32)
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index),
                                compute_dtype=jnp.bfloat16)
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.bfloat16)
        if floor:
            jc32, jl32 = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok),
                                        jc32, jnp.asarray(index),
                                        compute_dtype=jnp.float32)
        index = index + 1
    if _has_moe(cfg):
        assert routed >= MIN_ROUTED, routed
        assert separated >= MIN_SEPARATED_MOE, separated
    else:
        assert routed == B * steps
        assert separated >= MIN_SEPARATED, separated


def test_decode_matches_forward(setup):
    """As tests/test_decode_equivalence.py checks for the reference:
    prefill + token-by-token decode equal the parallel forward pass (MoE
    at a capacity that drops nothing, as there)."""
    _, cfg, _, tp, _ = setup
    cfg = _no_drop(cfg)
    B, S, S0 = 2, 12, 5
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, (B, S)))
    frames = _tframes(_frames(cfg, B, 1))
    par = TM.forward(tp, cfg, toks, compute_dtype=torch.float32,
                     frames=frames)
    cache = TM.init_cache(cfg, B, S, dtype=torch.float32, device="cpu")
    cache, pre = TM.prefill(tp, cfg, toks[:, :S0], cache,
                            compute_dtype=torch.float32, frames=frames)
    np.testing.assert_allclose(pre.numpy(), par[:, S0 - 1].numpy(),
                               rtol=2e-4, atol=2e-4)
    for t in range(S0, S):
        cache, dec = TM.decode_step(tp, cfg, toks[:, t:t + 1], cache, t,
                                    compute_dtype=torch.float32)
        np.testing.assert_allclose(dec.numpy(), par[:, t].numpy(),
                                   rtol=5e-4, atol=5e-4,
                                   err_msg=f"decode step {t} diverged")


def _unfused(tp, cfg, tokens, mode, dtype, cache=None, index=None,
             last=None, frames=None):
    """The stack as composed before the residual add moved into the
    norms: norm, mixer, x + out after every sublayer, then the final norm
    of the stream (of one row at prefill); an encoder's stack (given
    `frames`) composed so too. Returns the logits."""
    B, S = tokens.shape

    def norm(p, x):
        if cfg.norm == "layernorm":
            return layer_norm(x, p, cfg.norm_eps)
        return reference_rmsnorm(x, p["scale"], cfg.norm_eps)

    def run(x, subs, ctx):
        for spec, p, c in subs:
            h = norm(p["norm"], x)
            if spec.kind in TM._CACHED:
                out, _ = TM._MIXERS[spec.kind].apply(p["mixer"], h, spec,
                                                     cfg, ctx, c)
            else:
                out = TM._MIXERS[spec.kind].apply(p["mixer"], h, spec, cfg,
                                                  ctx)
            x = x + out
        return x
    x = TM._embed_tokens(tp, cfg, tokens, dtype)
    if mode == "decode":
        idx = torch.as_tensor(index).to(torch.int64)
        ctx = Ctx(mode=mode, positions=TM._decode_positions(cfg, idx),
                  cache_index=idx, compute_dtype=dtype, plain=True)
    else:
        ctx = Ctx(mode=mode,
                  positions=TM._positions(cfg, B, S, tokens.device),
                  compute_dtype=dtype, plain=True)
    if frames is not None and mode != "decode":
        e = frames.to(dtype)
        e = e + TM.sinusoidal_positions(*e.shape[1:]).to(dtype)[None]
        ectx = Ctx(mode="train", positions=None, compute_dtype=dtype,
                   plain=True)
        enc = tp["encoder"]
        e = run(e, [(spec, TM._index(enc["groups"][k], g), None)
                    for g in range(cfg.encoder.n_groups)
                    for k, spec in TM._encoder(cfg)], ectx)
        ctx.enc_out = norm(enc["final_norm"], e)
    x = run(x, TM.stack(tp, cfg, cache), ctx)
    if mode == "prefill":
        i = S - 1 if last is None else last
        x = x[:, i:i + 1]
    x = norm(tp["final_norm"], x)
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
    frames = _tframes(_frames(cfg, B, 3))
    assert torch.equal(TM.forward(tp, cfg, toks[:, :S], compute_dtype=dtype,
                                  frames=frames),
                       _unfused(tp, cfg, toks[:, :S], "train", dtype,
                                frames=frames))
    for last in (None, 5):
        got_c = TM.init_cache(cfg, B, T, dtype=dtype, device="cpu")
        want_c = TM.init_cache(cfg, B, T, dtype=dtype, device="cpu")
        got_c, got = TM.prefill(tp, cfg, toks[:, :S], got_c,
                                compute_dtype=dtype, last_index=last,
                                frames=frames)
        want = _unfused(tp, cfg, toks[:, :S], "prefill", dtype, want_c,
                        last=last, frames=frames)
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
    for part in ("groups", "tail"):
        assert sorted(got_c[part]) == sorted(want_c[part])
        for k, leaves in got_c[part].items():
            for leaf, t in leaves.items():
                assert torch.equal(t, want_c[part][k][leaf]), (part, k, leaf)


def test_forward_matches_reference(setup):
    jcfg, cfg, jp, tp, rules = setup
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10))
    frames = _frames(cfg, 2, 5)
    jl, _ = JM.forward(jp, jcfg, rules, _jbatch(toks, frames),
                       compute_dtype=jnp.float32, remat=False)
    tl = TM.forward(tp, cfg, torch.from_numpy(toks),
                    compute_dtype=torch.float32, frames=_tframes(frames))
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


def _drawn_then_stacked(cfg, seed, dtype, bound=None):
    """Native init as a loop that draws all G layers' matrices of a
    sublayer into a list (layer 0's in `param_shapes` order, then layer
    1's, ...) and stacks them: the weights `init_params` must give; then
    each shared sublayer's and each tail sublayer's once, unstacked; then
    an encoder's groups, stacked as the decoder's. A
    matrix of more than `bound` elements (None: no bound) is drawn as its
    leading-axis slices, each a draw of the slice's shape from where the
    generator stands, then stacked."""
    import math
    from repro_torch.models.layers import dense_init, embed_init
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def draw(shape, fan_in):
        if bound is None or math.prod(shape) <= bound:
            return dense_init(shape, fan_in, gen, "cpu", dtype)
        return torch.stack([dense_init(shape[1:], fan_in, gen, "cpu", dtype)
                            for _ in range(shape[0])])

    def sublayer(spec, n):
        # constant leaves (the qk-norm scales, Mamba-2's) are not drawn; a
        # shared expert's leaves are nested, so leaves are keyed by paths
        mats = list(TM._leaves_of(TM._MIXERS[spec.kind].param_shapes(cfg,
                                                                     spec)))
        layers = [{p: draw(shape, init) if TM._drawn(init) else
                   TM.CONSTANTS[init](shape, "cpu")
                   for p, shape, init in mats} for _ in range(n or 1)]
        if n is None:
            return layers[0]
        return {p: torch.stack([m[p] for m in layers]) for p, _, _ in mats}
    shapes = TM.param_shapes(cfg)
    want = {"embed": embed_init(shapes["embed"], gen, "cpu", dtype)}
    if "unembed" in shapes:
        want["unembed"] = embed_init(shapes["unembed"], gen, "cpu", dtype)
    want["groups"] = {k: sublayer(spec, cfg.n_groups)
                      for k, spec in TM._sublayers(cfg)
                      if not getattr(spec, "shared", False)}
    shared = {k: sublayer(spec, None) for k, spec in TM._sublayers(cfg)
              if getattr(spec, "shared", False)}
    if shared:
        want["shared"] = shared
    if cfg.tail:
        want["tail"] = {k: sublayer(spec, None) for k, spec in TM._tail(cfg)}
    if cfg.encoder is not None:
        want["encoder"] = {k: sublayer(spec, cfg.encoder.n_groups)
                           for k, spec in TM._encoder(cfg)}
    return want


def _paths(tree, path=()):
    """The leaf paths of a nested dict."""
    for n, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, path + (n,))
        else:
            yield path + (n,)


# Mamba-2's float32 leaves beside its gated-norm scale (norm_scale), and
# xLSTM's gate biases (its norm scales end in "_scale" too)
MAMBA_F32 = ("a_log", "dt_bias", "d_skip", "conv_b", "b_gates")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("arch", sorted(DENSE))
def test_native_init_stacks_in_place(arch, dtype):
    """`init_params` draws each layer's matrices straight into their slot
    of the stacked [G, ...] tensor, bit for bit the weights of drawing
    every layer first and stacking the list."""
    cfg = get_config(arch, reduced=True)
    got = TM.init_params(cfg, 11, device="cpu", dtype=dtype)
    want = _drawn_then_stacked(cfg, 11, dtype)
    assert sorted(k for k in got if k != "final_norm") == sorted(want)
    for name in ("embed", "unembed"):
        if name in want:
            assert torch.equal(got[name], want[name]), name
    subs = {part: got.get(part, {}) for part in ("groups", "shared", "tail")}
    if "encoder" in got:
        subs["encoder"] = got["encoder"]["groups"]
    for part, have in subs.items():
        assert sorted(have) == sorted(want.get(part, {}))
        for k, mixer in want.get(part, {}).items():
            assert sorted(_paths(have[k]["mixer"])) == sorted(mixer)
            for n, t in mixer.items():
                g = TM._at_path(have[k]["mixer"], n)
                want_dtype = (torch.float32 if n[-1].endswith("_scale")
                              or n[-1] in MAMBA_F32 else dtype)
                assert g.dtype == t.dtype == want_dtype, (part, k, n)
                assert torch.equal(g, t), (part, k, n)


ARCH_2 = "llama4-maverick-400b-a17b"     # a group of two layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_init_draws_a_stack_above_the_bound_one_expert_at_a_time(
        monkeypatch, dtype):
    """A [G] slot of more than DRAW_SLICE_ELEMENTS is drawn one expert (one
    leading-axis slice) at a time, each expert a draw of its own shape from
    where the generator stands; every smaller slot is drawn whole. At full
    width only llama4's expert stacks pass the bound (qwen3-moe's 805M
    elements stay under it, so its native weights are unchanged); reduced
    llama4 with the bound lowered to 16,384 draws its [4, 64, 128] stacks
    (32,768 elements) by slices and its dense and shared FFN (8,192)
    whole, and the sliced weights are not those of whole draws."""
    import math
    big = {arch: max(math.prod(shape) for _, spec in TM._sublayers(
        get_config(arch)) for _, shape, fan_in in TM._leaves_of(
            TM._MIXERS[spec.kind].param_shapes(get_config(arch), spec))
        if TM._drawn(fan_in)) for arch in DENSE}
    assert big[ARCH_2] == 128 * 5120 * 8192 > TM.DRAW_SLICE_ELEMENTS
    assert all(n <= TM.DRAW_SLICE_ELEMENTS for a, n in big.items()
               if a != ARCH_2), big
    cfg = get_config(ARCH_2, reduced=True)
    whole = TM.init_params(cfg, 11, device="cpu", dtype=dtype)
    monkeypatch.setattr(TM, "DRAW_SLICE_ELEMENTS", 16_384)
    got = TM.init_params(cfg, 11, device="cpu", dtype=dtype)
    want = _drawn_then_stacked(cfg, 11, dtype, bound=16_384)
    sliced = 0
    for k, mixer in want["groups"].items():
        assert sorted(_paths(got["groups"][k]["mixer"])) == sorted(mixer)
        for n, t in mixer.items():
            g = TM._at_path(got["groups"][k]["mixer"], n)
            assert g.dtype == t.dtype and torch.equal(g, t), (k, n)
            drawn = TM._at_path(whole["groups"][k]["mixer"], n)
            if math.prod(t.shape[1:]) > 16_384:
                sliced += 1
                assert n in (("w_in",), ("w_gate",), ("w_out",)), (k, n)
                assert not torch.equal(g, drawn), (k, n)
    assert sliced == 3, sliced
    assert torch.equal(got["unembed"], whole["unembed"])


@pytest.mark.parametrize("arch", sorted(DENSE))
def test_no_drop_keeps_every_layer_of_the_pattern(arch):
    """`_no_drop` raises the capacity of every MoE sublayer in every layer
    of the pattern and leaves the pattern's length and every other spec as
    they were: on llama4 its group stays a dense layer and an MoE layer."""
    import dataclasses
    from repro_torch.models.config import MoeSpec
    cfg = get_config(arch, reduced=True)
    got = _no_drop(cfg)
    assert len(got.pattern) == len(cfg.pattern)
    assert got.param_count() == cfg.param_count()
    for new, old in zip(got.pattern, cfg.pattern):
        assert len(new) == len(old)
        for a, b in zip(new, old):
            if isinstance(b, MoeSpec):
                assert b.capacity_factor < a.capacity_factor == 64.0
                assert dataclasses.replace(a, capacity_factor=1.0) == \
                    dataclasses.replace(b, capacity_factor=1.0)
            else:
                assert a == b
    if arch == ARCH_2:
        assert [[s.kind for s in layer] for layer in got.pattern] == \
            [["attn", "ffn"], ["attn", "moe"]]


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
    dict(sliding_window=16), dict(logit_softcap=30.0)])
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
    """Every sublayer kind of the reference's configs is ported (mLSTM and
    sLSTM last); a kind the port does not build still raises."""
    import dataclasses

    @dataclasses.dataclass(frozen=True)
    class RetentionSpec:
        n_heads: int

        @property
        def kind(self) -> str:
            return "retention"
    assert set(TM._MIXERS) == {"attn", "ffn", "moe", "mamba2", "mlstm",
                               "slstm"}
    cfg = get_config("gemma-2b", reduced=True)
    bad = dataclasses.replace(cfg, pattern=(
        (AttnSpec(n_heads=4, n_kv=1, head_dim=32), RetentionSpec(4)),))
    with pytest.raises(NotImplementedError, match="retention"):
        TM.init_cache(bad, 1, 8, device="cpu")


ARCH_SSM = "zamba2-7b"


def test_params_from_jax_takes_shared_and_tail():
    """zamba2's tree: the non-shared sublayers stacked [G, ...] under
    "groups" (the shared keys absent there), the shared attention and FFN
    once under "shared", the tail's Mamba-2 layers unstacked under "tail".
    The reference's tree comes over leaf for leaf (float32 leaves exact
    at dtype bf16, matrices cast), and the port's native tree goes through
    numpy and back unchanged."""
    jcfg = j_get_config(ARCH_SSM, reduced=True)
    cfg = get_config(ARCH_SSM, reduced=True)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(1),
                                                 jcfg)[0])
    tp = TM.params_from_jax(jp, cfg, device="cpu", dtype=torch.bfloat16)
    shared = [k for k, s in TM._sublayers(cfg) if getattr(s, "shared", 0)]
    assert shared == sorted(tp["shared"]) == ["L1S0", "L1S1"]
    assert sorted(tp["groups"]) == ["L0S0", "L1S2"]
    assert sorted(tp["tail"]) == ["L0S0"]
    assert tp["groups"]["L0S0"]["mixer"]["w_in"].shape[0] == cfg.n_groups
    assert tp["shared"]["L1S0"]["mixer"]["wq"].dim() == 3
    assert tp["tail"]["L0S0"]["mixer"]["a_log"].dim() == 1
    n = 0
    for path in _paths(jp):
        got, want = TM._at_path(tp, path), TM._at_path(jp, path)
        f32 = TM._is_f32_path(path)
        assert got.dtype == (torch.float32 if f32 else torch.bfloat16), path
        assert torch.equal(got, torch.from_numpy(np.array(want)).to(
            got.dtype)), path
        n += got.numel()
    assert n == sum(t.numel() for t in _tensors(tp))
    native = TM.init_params(cfg, 5, device="cpu", dtype=torch.bfloat16)
    back = TM.params_from_jax(_map(native, lambda t: t.float().numpy()),
                              cfg, device="cpu", dtype=torch.bfloat16)
    for path in _paths(native):
        assert torch.equal(TM._at_path(back, path),
                           TM._at_path(native, path)), path


def _tensors(tree):
    for v in tree.values():
        yield from (_tensors(v) if isinstance(v, dict) else (v,))


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_native_init_gives_mamba_constants_in_float32(dtype):
    """Native init sets Mamba-2's constant leaves as the reference does
    (conv_b and dt_bias zeros, d_skip and norm_scale ones, a_log =
    log(linspace(1, 16, H)), to the reference's float32 rounding: within
    an ulp), in float32 at any dtype, in every group and the tail; the
    drawn matrices (w_in, conv_w, w_out) follow `dtype`."""
    jcfg = j_get_config(ARCH_SSM, reduced=True)
    cfg = get_config(ARCH_SSM, reduced=True)
    jp = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                 jcfg)[0])
    tp = TM.init_params(cfg, 0, device="cpu", dtype=dtype)
    mixers = [("groups", k) for k, s in TM._sublayers(cfg)
              if s.kind == "mamba2"] + [("tail", k) for k, _ in TM._tail(cfg)]
    assert len(mixers) == 3
    for part, k in mixers:
        m, jm = tp[part][k]["mixer"], jp[part][k]["mixer"]
        for name in ("conv_b", "dt_bias", "d_skip", "norm_scale"):
            assert m[name].dtype == torch.float32, (part, k, name)
            np.testing.assert_array_equal(m[name].numpy(), jm[name],
                                          err_msg=f"{part} {k} {name}")
        assert m["a_log"].dtype == torch.float32
        np.testing.assert_allclose(m["a_log"].numpy(), jm["a_log"],
                                   rtol=2 ** -23, atol=0)
        for name in ("w_in", "conv_w", "w_out"):
            assert m[name].dtype == dtype and m[name].shape == \
                jm[name].shape, (part, k, name)
        np.testing.assert_array_equal(
            m["a_log"].reshape(-1, 8).numpy(),
            np.broadcast_to(np.log(np.linspace(1.0, 16.0, 8)).astype(
                np.float32), (m["a_log"].numel() // 8, 8)))
