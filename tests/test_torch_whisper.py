"""whisper-medium's own parts in the PyTorch port against the JAX
reference, on the CPU: LayerNorm (and the residual add before it), the
encoder's sinusoidal positions, the encoder stack on random frames, the
cross-attention cache, the full-width weights tree, and the reference's
quirks the port follows: the decoder carries no position at all
(rope="none" and no learned positions), the engine serves on zero frames,
and `param_count()` leaves out the layernorm biases. The whole model
(reduced, float32) is held to the reference in tests/test_torch_model.py
and its engine in tests/test_torch_serving.py, with the other configs.

Tolerances: float32 atol 1e-5 for a norm (one float32 reduction in
another order), 1e-4 for the encoder's output and the logits (as
tests/test_torch_model.py); bf16 atol 2e-2 (one bf16 rounding of values
of order 1 after float32 math)."""
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import PORTED, get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.serving import DecodeEngine, Request

ARCH = "whisper-medium"
ATOL = 1e-4
NORM_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# the full-width weights tree, and the analytic count beside it: the
# reference's formula counts a norm as its d_model scale, so it leaves
# out the 122 layernorm biases (24 x 3 + 1 in the decoder, 24 x 2 + 1 in
# the encoder) of 1024 each
FULL_ELEMENTS = 758_002_688
PARAM_COUNT = 757_877_760
BIASES = 122 * 1024


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp, single_device_rules()


def _frames(cfg, B, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 1024)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_layer_norm_matches_reference(shape, dt):
    """apply_norm and apply_add_norm with kind "layernorm" against the
    reference's apply_norm (of x + r for the add), at a scale and bias
    that are not ones and zeros; the add's sum is x + r in x's dtype,
    bit for bit, and its normed output is the norm of that sum, bit for
    bit."""
    jdt, tdt = DTYPES[dt]
    rng = np.random.default_rng(len(shape))
    x, r = (rng.standard_normal(shape).astype(np.float32) for _ in "xr")
    d = shape[-1]
    params = {"scale": (1 + 0.1 * rng.standard_normal(d)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(d)).astype(np.float32)}
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tx, tr = (torch.from_numpy(a).to(tdt) for a in (x, r))
    jx, jr = (jnp.asarray(a).astype(jdt) for a in (x, r))
    got = TL.apply_norm(tparams, tx, "layernorm", 1e-6)
    want = JL.apply_norm(jparams, jx, "layernorm", 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=NORM_ATOL[dt], rtol=NORM_ATOL[dt])
    normed, summed = TL.apply_add_norm(tparams, tx, tr, "layernorm", 1e-6)
    assert torch.equal(summed, tx + tr)
    assert torch.equal(normed, TL.apply_norm(tparams, summed, "layernorm",
                                             1e-6))
    np.testing.assert_allclose(
        normed.float().numpy(),
        np.asarray(JL.apply_norm(jparams, jx + jr, "layernorm", 1e-6),
                   np.float32), atol=NORM_ATOL[dt], rtol=NORM_ATOL[dt])


@pytest.mark.parametrize("n,d", [(32, 64), (1500, 1024), (7, 10)])
def test_sinusoidal_positions_match_reference_bit_for_bit(n, d):
    got = TL.sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.sinusoidal_positions(n, d)))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_run_encoder_matches_reference(setup, dt):
    """The encoder stack on random frames: the sinusoidal table added in
    the frames' dtype, two groups of non-causal self-attention and GELU
    FFN, the final layernorm."""
    jcfg, cfg, jp, tp, rules = setup
    jdt, tdt = DTYPES[dt]
    frames = _frames(cfg, 2, 1)
    jctx = JL.Ctx(rules=rules, mode="train", positions=None,
                  compute_dtype=jdt)
    want = JM.run_encoder(jp, jnp.asarray(frames).astype(jdt), jcfg, jctx)
    tctx = TL.Ctx(mode="train", positions=None, compute_dtype=tdt)
    got = TM.run_encoder(tp, torch.from_numpy(frames).to(tdt), cfg, tctx)
    assert got.dtype == tdt and got.shape == frames.shape
    atol = ATOL if dt == "float32" else NORM_ATOL[dt]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=atol)


def test_cross_cache_is_written_at_prefill_and_read_at_decode(setup):
    """A cross-attention sublayer's cache holds the encoder's n_frames
    rows, filled at prefill with the encoder output's K/V
    (the reference's), and decode steps leave it as it is; the decoder's
    self-attention cache has max_len rows."""
    jcfg, cfg, jp, tp, rules = setup
    B, T = 2, 24
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, 6))
    frames = _frames(cfg, B, 2)
    tc = TM.init_cache(cfg, B, T, dtype=torch.float32, device="cpu")
    F_ = cfg.encoder.n_frames
    assert tc["groups"]["L0S0"]["k"].shape == (cfg.n_groups, B, 4, T, 16)
    assert tc["groups"]["L0S1"]["k"].shape == (cfg.n_groups, B, 4, F_, 16)
    tc, _ = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                       compute_dtype=torch.float32,
                       frames=torch.from_numpy(frames))
    jc = JM.init_cache(jcfg, B, T, dtype=jnp.float32)
    jc, _ = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                                         "frames": jnp.asarray(frames)},
                       jc, compute_dtype=jnp.float32)
    cross = {n: t.clone() for n, t in tc["groups"]["L0S1"].items()}
    for n, t in cross.items():
        assert bool(t.abs().sum() > 0), n
        np.testing.assert_allclose(t.numpy(),
                                   np.asarray(jc["groups"]["L0S1"][n]),
                                   atol=ATOL)
    for step in range(2):
        tok = torch.full((B, 1), step + 1)
        TM.decode_step(tp, cfg, tok, tc, 6 + step,
                       compute_dtype=torch.float32)
    for n, t in cross.items():
        assert torch.equal(tc["groups"]["L0S1"][n], t), n


def test_prefill_needs_frames(setup):
    _, cfg, _, tp, _ = setup
    tc = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        TM.prefill(tp, cfg, torch.ones(1, 4, dtype=torch.int64), tc,
                   compute_dtype=torch.float32)


def test_decoder_carries_no_position(setup):
    """A reference quirk the port follows: whisper's decoder has neither
    rotary (rope="none") nor learned positions, so a prompt of one token
    repeated gives the same last logits at any length (every position's
    attention averages identical rows), in the reference and the port
    alike."""
    jcfg, cfg, jp, tp, rules = setup
    frames = _frames(cfg, 1, 3)
    got, want = [], []
    for n in (1, 3, 9):
        toks = np.full((1, n), 17)
        jc = JM.init_cache(jcfg, 1, 16, dtype=jnp.float32)
        want.append(np.asarray(JM.prefill(
            jp, jcfg, rules, {"tokens": jnp.asarray(toks),
                              "frames": jnp.asarray(frames)}, jc,
            compute_dtype=jnp.float32)[1]))
        tc = TM.init_cache(cfg, 1, 16, dtype=torch.float32, device="cpu")
        got.append(TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                              compute_dtype=torch.float32,
                              frames=torch.from_numpy(frames))[1].numpy())
    for i in (1, 2):
        np.testing.assert_allclose(want[i], want[0], atol=1e-5)
        np.testing.assert_allclose(got[i], got[0], atol=1e-5)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL)


def test_engine_serves_on_zero_frames(setup, monkeypatch):
    """A reference quirk the port follows: the engine prefills every
    admission on zero frames [1, n_frames, d_model] in its dtype (the
    reference's stub audio frontend feeds no audio), at the prompt's
    exact length."""
    _, cfg, _, tp, _ = setup
    seen = []
    prefill = TM.prefill

    def noted(params, cfg_, tokens, cache, **kw):
        seen.append((tokens.shape, kw["frames"]))
        return prefill(params, cfg_, tokens, cache, **kw)
    monkeypatch.setattr(TM, "prefill", noted)
    eng = DecodeEngine(cfg, tp, max_slots=2, max_len=32, device="cpu")
    eng.admit(Request(rid="a", prompt=np.ones(5, np.int32)))
    (shape, frames), = seen
    assert tuple(shape) == (1, 5)
    assert frames.shape == (1, cfg.encoder.n_frames, cfg.d_model)
    assert frames.dtype == eng.dtype and not bool(frames.any())


def _leaf_shapes(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaf_shapes(v, path + (k,))
        else:
            yield path + (k,), tuple(v)


def test_full_width_tree_and_its_count():
    """The full-width weights tree is the reference's leaf for leaf (its
    `init_params` on `jax.eval_shape`), and on meta tensors it holds
    758,002,688 elements: `param_count()` (757,877,760, the reference's
    formula) and the 124,928 layernorm biases the formula leaves out;
    every norm leaf is float32 at dtype bf16."""
    cfg = get_config(ARCH)
    jcfg = j_get_config(ARCH)
    shapes = TM.param_shapes(cfg)
    ref = jax.eval_shape(lambda k: JM.init_params(k, jcfg)[0],
                         jax.random.PRNGKey(0))
    want = {tuple(k.key for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert dict(_leaf_shapes(shapes)) == want
    meta = {p: torch.empty(s, device="meta") for p, s in
            _leaf_shapes(shapes)}
    assert sum(t.numel() for t in meta.values()) == FULL_ELEMENTS
    assert cfg.param_count() == jcfg.param_count() == PARAM_COUNT
    assert FULL_ELEMENTS - PARAM_COUNT == BIASES
    assert sum(t.numel() for p, t in meta.items()
               if p[-1] == "bias") == BIASES
    assert all(TM._is_f32_path(p) for p in meta if p[-1] in ("scale",
                                                              "bias"))
    assert sorted(shapes["encoder"]["groups"]) == ["L0S0", "L0S1"]
    assert shapes["encoder"]["groups"]["L0S0"]["norm"]["bias"] == \
        (24, 1024)


# each other ported config's native weights (reduced, seed 11) as
# digests: what `init_params` drew before encoders were ported (an
# encoder is drawn after every decoder weight, so no other config's draw
# moves)
NATIVE_DIGESTS = {
    ("gemma-2b", "float32"): "68a817732c8578c2",
    ("gemma-2b", "bfloat16"): "76e9ef8bbf6c406e",
    ("deepseek-7b", "float32"): "fc1becbe43e14176",
    ("deepseek-7b", "bfloat16"): "4bef084ded5725e8",
    ("mistral-nemo-12b", "float32"): "9ef20b3903ece91a",
    ("mistral-nemo-12b", "bfloat16"): "760548a3883a0b7c",
    ("granite-20b", "float32"): "495f5867e5d8a05d",
    ("granite-20b", "bfloat16"): "dcac685ca489a3fc",
    ("qwen3-moe-235b-a22b", "float32"): "574626605c48538a",
    ("qwen3-moe-235b-a22b", "bfloat16"): "bcd3119a9eae0474",
    ("llama4-maverick-400b-a17b", "float32"): "13302835c767231f",
    ("llama4-maverick-400b-a17b", "bfloat16"): "34ff332e4f4668bf",
    ("zamba2-7b", "float32"): "43d536e596754e93",
    ("zamba2-7b", "bfloat16"): "32760c1cd48f365d",
    ("xlstm-350m", "float32"): "e7fda26fbe2ae8c6",
    ("xlstm-350m", "bfloat16"): "41b7026dfc329e6d",
    ("qwen2-vl-2b", "float32"): "9aba1607b1a0240b",
    ("qwen2-vl-2b", "bfloat16"): "0e65e4be0aff6399",
}


def _digest(params) -> str:
    """sha256 of every leaf's path, dtype and bytes, in sorted key order
    (16 hex digits)."""
    h = hashlib.sha256()

    def walk(tree, path=()):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                walk(tree[k], path + (k,))
                continue
            t = tree[k].contiguous()
            h.update("/".join(path + (k,)).encode())
            h.update(str(t.dtype).encode())
            bits = torch.int16 if t.dtype == torch.bfloat16 else torch.uint8
            h.update(t.view(bits).numpy().tobytes())
    walk(params)
    return h.hexdigest()[:16]


@pytest.mark.parametrize("arch,dt", sorted(NATIVE_DIGESTS))
def test_native_init_keeps_every_other_config_bit_for_bit(arch, dt):
    assert {a for a, _ in NATIVE_DIGESTS} == set(PORTED) - {ARCH}
    params = TM.init_params(get_config(arch, reduced=True), 11,
                            device="cpu", dtype=DTYPES[dt][1])
    assert _digest(params) == NATIVE_DIGESTS[(arch, dt)]
