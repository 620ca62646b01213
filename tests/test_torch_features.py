"""The reference model's features that no reference config turns on, in
the PyTorch port against the JAX reference on the same weights: the int8
KV cache (`init_cache(dtype=int8)`, `_quantize_kv`, `_read_cache`),
attention score caps (`logit_softcap`), sliding-window attention
(`sliding_window`) and the final logit cap (`final_logit_softcap`).

The caps and the window run on reduced gemma-2b with Gemma 2's
local/global pattern (`test_torch_model.gemma2`: a local layer of window
5 and a global one, score cap 0.3, final cap 1.0) on prompts of 12-16
tokens: each alone and all together, through the train forward, a
prefill and 8 decode steps, every logit at ATOL (the model's float32
parity tolerance), and each test shows that its feature changes the
logits by more than 10 x ATOL on the same weights. The int8 cache runs
on the archs of tests/test_kv_int8.py (gemma-2b, whisper-medium with its
cross cache, zamba2-7b) and on the Gemma 2 config; its logits hold at
ATOL too. Under int8 the reference keeps Mamba-2's state in float32;
its conv window is bf16 in `init_cache` but float32 after its first
write, so zamba2 runs with float32 windows at ATOL and with the port's
bf16 ones at BF16_CONV_ATOL. An int8 cache leaf holds a value quantized from float32 K/V that
two frameworks computed in another order: one that lies on a rounding
edge may land one step apart, so int8 leaves compare within one step
(almost all equal) and scales within one bf16 rounding.

The kernels' plain versions take every new argument and are held to the
reference's own attention functions (`_read_cache` + `_sdpa_full`,
`_sdpa_chunked` with a window); the CUDA kernels are held to these plain
versions on the card by chip_smoke.py (phase 24)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core.policy import Tier as JTier, TieringPolicy as JPolicy
from repro.models import attention as JA
from repro.models import model as JM
from repro.parallel.sharding import single_device_rules
from repro.runtime import TieredStore as JStore, TierSpec as JSpec, \
    VirtualClock as JClock
from repro.serving.engine import DecodeEngine as JEngine, Request as JReq
from repro_torch.configs import get_config
from repro_torch.core.policy import Tier as TTier, TieringPolicy as TPolicy
from repro_torch.kernels.decode_attention.ops import check_inputs, \
    decode_attention, smem_bytes
from repro_torch.kernels.decode_attention.ref import \
    reference_decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.models import model as TM
from repro_torch.models.attention import quantize_kv
from repro_torch.runtime import TieredStore as TStore, TierSpec as TSpec, \
    VirtualClock as TClock
from repro_torch.serving import DecodeEngine as TEngine, Request as TReq
from test_torch_model import ATOL, GEMMA2, _assert_caches_close, \
    _build, _configs, _frames, _jbatch, _tframes, gemma2
from test_torch_serving import MAX_LEN, STEP, _blob_bytes, _park_run, \
    _scenario

# each feature alone, and all together: (window, score cap, final cap)
FEATURES = {"sliding_window": dict(window=5, softcap=0.0, final=0.0),
            "logit_softcap": dict(window=0, softcap=0.3, final=0.0),
            "final_logit_softcap": dict(window=0, softcap=0.0, final=1.0),
            "all": {}}
NONE = dict(window=0, softcap=0.0, final=0.0)
BITES = 10 * ATOL              # least change a feature must make
# zamba2-7b's int8 run with `init_cache`'s bf16 conv windows against the
# reference, whose first write leaves them float32: the bf16 test's floor
# for a recurrent config, 1.3x the 7.5e-3 seen after 8 decode steps
BF16_CONV_ATOL = 1e-2
DECODE_STEPS = 8
INT8_ARCHS = ["gemma-2b", "whisper-medium", "zamba2-7b", GEMMA2]
JDT = {torch.int8: jnp.int8, torch.bfloat16: jnp.bfloat16,
       torch.float32: jnp.float32}


def _pair(**kw):
    """The Gemma 2 config at a window and caps, on both sides."""
    return gemma2(j_get_config, **kw), gemma2(get_config, **kw)


@pytest.fixture(scope="module")
def weights():
    """Reduced gemma-2b's Gemma 2 variant on both sides; its weights fit
    every window and cap."""
    return _build(GEMMA2)


def _run(tp, cfg, jp, jcfg, rules, toks, ref=True):
    """Forward, prefill (cache of 32 rows) and DECODE_STEPS per-slot
    decode steps in float32 on the port, and the same on the reference
    when `ref`; returns ([port logits], [reference logits], port cache,
    reference cache): the forward's [B,S,V], then [B,V] a call."""
    B, S = toks.shape
    rng = np.random.default_rng(31)
    steps = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1)).astype(np.int32)
    t_out = [TM.forward(tp, cfg, torch.from_numpy(toks),
                        compute_dtype=torch.float32)]
    tc = TM.init_cache(cfg, B, 32, dtype=torch.float32, device="cpu")
    tc, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), tc,
                        compute_dtype=torch.float32)
    t_out.append(tl)
    j_out, jc = [], None
    if ref:
        jl, _ = JM.forward(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                           compute_dtype=jnp.float32, remat=False)
        jc = JM.init_cache(jcfg, B, 32, dtype=jnp.float32)
        jc, jp_l = JM.prefill(jp, jcfg, rules, {"tokens": jnp.asarray(toks)},
                              jc, compute_dtype=jnp.float32)
        j_out += [jl, jp_l]
    index = np.array([S, S - 2], np.int32)
    for tok in steps:
        tc, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc,
                                torch.from_numpy(index),
                                compute_dtype=torch.float32)
        t_out.append(tl)
        if ref:
            jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                    jnp.asarray(index),
                                    compute_dtype=jnp.float32)
            j_out.append(jl)
        index = index + 1
    return t_out, j_out, tc, jc


@pytest.mark.parametrize("feature", sorted(FEATURES))
def test_feature_matches_reference_and_bites(weights, feature):
    """A feature alone (or all together) on Gemma 2's local/global
    pattern: the train forward on a 14-token prompt, a prefill, and 8
    decode steps of two slots at indices 14 and 12 onwards, logits and
    caches at ATOL against the reference; and the same calls without the
    feature, on the same weights, move the logits by more than BITES at
    the forward, the prefill and a decode step."""
    _, _, jp, tp, rules = weights
    jcfg, cfg = _pair(**FEATURES[feature])
    assert repr(cfg) == repr(jcfg)
    toks = np.random.default_rng(17).integers(0, cfg.vocab, (2, 14))
    got, want, tc, jc = _run(tp, cfg, jp, jcfg, rules, toks)
    for i, (t, j) in enumerate(zip(got, want)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=f"call {i}")
    _assert_caches_close(tc, jc, cfg)
    plain = gemma2(get_config, **NONE)
    without, _, _, _ = _run(tp, plain, None, None, None, toks, ref=False)
    moved = [float((a - b).abs().max()) for a, b in zip(got, without)]
    assert moved[0] > BITES and moved[1] > BITES, moved
    assert max(moved[2:]) > BITES, moved


def test_window_reaches_decode_alone(weights):
    """A window that only a decode step crosses: the prompt (4 tokens)
    fits in the window of 5, so prefill's logits equal the unwindowed
    ones, and the decode steps past position 5 differ from them (and
    match the reference)."""
    _, _, jp, tp, rules = weights
    jcfg, cfg = _pair(**FEATURES["sliding_window"])
    toks = np.random.default_rng(19).integers(0, cfg.vocab, (2, 4))
    got, want, _, _ = _run(tp, cfg, jp, jcfg, rules, toks)
    for i, (t, j) in enumerate(zip(got, want)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                                   err_msg=f"call {i}")
    without, _, _, _ = _run(tp, gemma2(get_config, **NONE), None, None,
                            None, toks, ref=False)
    assert torch.equal(got[1], without[1])
    assert float((got[-1] - without[-1]).abs().max()) > BITES


# ---------------------------------------------------------------- int8 KV

@pytest.mark.parametrize("shape,scale", [((4, 2, 16, 64), 3.0),
                                         ((3, 1, 9, 32), 1e-3),
                                         ((2, 5, 48), 200.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_quantizer_matches_reference_bit_for_bit(shape, scale, dt):
    """`quantize_kv` gives the reference's `_quantize_kv` int8 values and
    bf16 scales bit for bit on float32 and bf16 rows, with rows of zeros
    (the scale's 1e-8 floor) among them."""
    x = np.random.default_rng(23).standard_normal(shape).astype(
        np.float32) * scale
    x[..., 1, :] = 0.0
    tx = torch.from_numpy(x).to(dt)
    jx = jnp.asarray(x).astype(JDT[dt])
    q, s = quantize_kv(tx)
    jq, js = JA._quantize_kv(jx)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    assert s.shape == tx.shape[:-1] + (1,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.view(torch.int16).numpy(),
                                  np.asarray(js).view(np.int16))
    assert bool((q[..., 1, :] == 0).all())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_cache_tree_matches_reference(arch):
    """`init_cache(dtype=int8)`: the reference's keys, shapes and dtypes
    leaf for leaf: int8 K and V, bf16 scales [..., 1] beside them (a
    cross-attention's of the encoder's rows), and a recurrent sublayer's
    state float32 with its conv window bf16."""
    jcfg, cfg = _configs(arch)
    jc = JM.init_cache(jcfg, 2, 16, dtype=jnp.int8)
    tc = TM.init_cache(cfg, 2, 16, dtype=torch.int8, device="cpu")
    got = list(_leaves(tc))
    want = list(_leaves({k: v for k, v in jc.items() if v}))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, j) in zip(got, want):
        assert tuple(t.shape) == j.shape, path
        assert JDT[t.dtype] == j.dtype, (path, t.dtype, j.dtype)
    names = {p[-1] for p, _ in got}
    assert {"k", "v", "k_scale", "v_scale"} <= names


def _assert_int8_caches_close(tc, jc):
    """int8 leaves within one quantization step (at most 1% of them off
    by one), scales within one bf16 rounding, any other leaf at ATOL."""
    got = dict(_leaves(tc))
    want = dict(_leaves({k: v for k, v in jc.items() if v}))
    assert got.keys() == want.keys()
    for path, t in got.items():
        j = np.asarray(want[path])
        if t.dtype == torch.int8:
            diff = np.abs(t.numpy().astype(np.int32) - j.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, path
        elif path[-1].endswith("_scale") and t.dtype == torch.bfloat16:
            np.testing.assert_allclose(t.float().numpy(),
                                       j.astype(np.float32), rtol=2 ** -7,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(t.float().numpy(),
                                       j.astype(np.float32), atol=ATOL,
                                       err_msg=str(path))


def _recurrent(cfg) -> bool:
    return any(s.kind in ("mamba2", "mlstm", "slstm")
               for _, _, _, s in cfg.sublayers())


def _with_f32_conv(cache):
    """An int8 cache whose recurrent conv windows are float32, as the
    reference's become after their first write (its `causal_conv1d`
    returns the window in the compute dtype, and its cache keeps it)."""
    return {part: {k: {n: (t.float() if n == "conv" else t)
                       for n, t in leaves.items()}
                   for k, leaves in subs.items()}
            for part, subs in cache.items()}


@pytest.mark.parametrize("arch", INT8_ARCHS)
def test_int8_prefill_and_decode_match_reference(arch):
    """tests/test_kv_int8.py's path against the reference: a prefill of 6
    tokens of two slots into an int8 cache, then 8 decode steps at
    per-slot indices over it, float32 compute, logits at ATOL each call,
    the cache leaf by leaf; the int8 run's logits lie more than BITES
    from the port's own run over a float32 cache (the quantization
    bites).

    A recurrent config (zamba2-7b): `init_cache(int8)` gives the conv
    windows bf16, as the reference's does, but the reference's first
    write leaves them float32 (above), so the port runs twice: with its
    windows made float32, held at ATOL; and as `init_cache` builds them,
    held per call at BF16_CONV_ATOL (the bf16 rounding of the windows
    alone, carried by the recurrent state: 3.3e-7 at the prefill, 1.1e-3
    after one step and 7.5e-3 after eight on reduced zamba2-7b)."""
    jcfg, cfg, jp, tp, rules = _build(arch)
    B, S, T = 2, 6, 16
    toks = np.random.default_rng(29).integers(0, cfg.vocab, (B, S))
    frames = _frames(cfg, B, 29)
    steps = [np.random.default_rng(step).integers(
        0, cfg.vocab, (B, 1)).astype(np.int32) for step in range(DECODE_STEPS)]

    def port(cache):
        cache, tl = TM.prefill(tp, cfg, torch.from_numpy(toks), cache,
                               compute_dtype=torch.float32,
                               frames=_tframes(frames))
        out, index = [tl], np.array([S, S - 2], np.int32)
        for tok in steps:
            cache, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                       torch.from_numpy(index),
                                       compute_dtype=torch.float32)
            out.append(tl)
            index = index + 1
        return [t.numpy() for t in out], cache

    jc = JM.init_cache(jcfg, B, T, dtype=jnp.int8)
    jc, jl = JM.prefill(jp, jcfg, rules, _jbatch(toks, frames), jc,
                        compute_dtype=jnp.float32)
    want, index = [np.asarray(jl)], np.array([S, S - 2], np.int32)
    for tok in steps:
        jc, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                                jnp.asarray(index), compute_dtype=jnp.float32)
        want.append(np.asarray(jl))
        index = index + 1

    def cache(dt):
        return TM.init_cache(cfg, B, T, dtype=dt, device="cpu")
    got, tc = port(cache(torch.int8))
    if _recurrent(cfg):
        exact, tc = port(_with_f32_conv(cache(torch.int8)))
    else:
        exact = got
    for i, (t, j) in enumerate(zip(exact, want)):
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=f"call {i}")
    if _recurrent(cfg):
        for i, (t, j) in enumerate(zip(got, want)):
            np.testing.assert_allclose(t, j, atol=BF16_CONV_ATOL,
                                       err_msg=f"call {i}, bf16 windows")
    _assert_int8_caches_close(tc, jc)
    full, _ = port(cache(torch.float32))
    moved = max(float(np.abs(a - b).max()) for a, b in zip(got, full))
    assert moved > BITES, moved


def test_int8_cache_halves_the_kv_bytes():
    """At gemma-2b's full width, one slot at 8,192 positions: 151.0 MB of
    bf16 K/V, 76.1 MB in int8 with its scales (meta tensors)."""
    cfg = get_config("gemma-2b")

    def nbytes(dt):
        c = TM.init_cache(cfg, 1, 8192, dtype=dt, device="meta")
        return sum(t.numel() * t.element_size() for _, t in _leaves(c))
    assert nbytes(torch.bfloat16) == 18 * 2 * 8192 * 256 * 2 == 150_994_944
    assert nbytes(torch.int8) == 18 * 2 * 8192 * (256 + 2) == 76_087_296


# ------------------------------------------------------ the plain kernels

def _q5(q):
    """[B,H,S,hd] or [B,H,hd] (numpy) as the reference's [B,S,KV,QR,hd]
    for KV = 1."""
    if q.ndim == 3:
        q = q[:, :, None]
    B, H, S, hd = q.shape
    return q.transpose(0, 2, 1, 3).reshape(B, S, 1, H, hd)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 0.5), (7, 0.0),
                                            (7, 0.5), (40, 2.0)])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_plain_decode_matches_reference_read_and_sdpa(window, softcap, dt):
    """`reference_decode_attention` over an int8 cache with its scales, a
    window and a cap against the reference's `_read_cache` then
    `_sdpa_full` with its decode mask (kv_pos <= cur, cur - kv_pos <
    window at cur = length - 1), lengths ragged (1, a window's edge, one
    mid-chunk, T)."""
    rng = np.random.default_rng(37)
    B, H, T, hd = 4, 4, 40, 32
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, 1, T, hd)).astype(np.float32) * 2
            for _ in range(2))
    lengths = np.array([1, 7, 23, T], np.int32)
    jdt = JDT[dt]
    jk, jks = JA._quantize_kv(jnp.asarray(k))
    jv, jvs = JA._quantize_kv(jnp.asarray(v))
    jkd, jvd = JA._read_cache({"k": jk, "v": jv, "k_scale": jks,
                               "v_scale": jvs}, jdt)
    cur = lengths[:, None, None] - 1
    pos = np.arange(T)[None, None, :]
    mask = pos <= cur
    if window:
        mask &= cur - pos < window
    want = JA._sdpa_full(jnp.asarray(_q5(q)).astype(jdt), jkd, jvd,
                         jnp.asarray(mask), hd ** -0.5, softcap)
    tk, tks = quantize_kv(torch.from_numpy(k))
    tv, tvs = quantize_kv(torch.from_numpy(v))
    got = reference_decode_attention(
        torch.from_numpy(q).to(dt), tk, tv, torch.from_numpy(lengths),
        scale=hd ** -0.5, window=window, softcap=softcap, k_scale=tks,
        v_scale=tvs)
    tol = 1e-5 if dt == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32).reshape(B, H, hd),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("window,softcap", [(1, 0.0), (5, 0.0), (16, 0.7),
                                            (0, 0.7), (100, 0.0)])
def test_plain_flash_matches_reference_chunked(window, softcap):
    """`reference_attention` with a window and a cap against the
    reference's `_sdpa_chunked` (the path its long prefills take, blocks
    of 16 keys) and `_sdpa_full` with its causal window mask, at S = T =
    37, float32."""
    rng = np.random.default_rng(41)
    B, H, S, hd = 2, 4, 37, 32
    q = rng.standard_normal((B, H, S, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, 1, S, hd)).astype(np.float32)
            for _ in range(2))
    pos = np.arange(S)
    got = reference_attention(*map(torch.from_numpy, (q, k, v)),
                              scale=hd ** -0.5, causal=True, window=window,
                              softcap=softcap).numpy()
    chunked = JA._sdpa_chunked(
        jnp.asarray(_q5(q)), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(np.broadcast_to(pos, (B, S))), jnp.asarray(pos),
        hd ** -0.5, True, 16, softcap, window)
    mask = pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[:, None] - pos[None, :] < window
    full = JA._sdpa_full(jnp.asarray(_q5(q)), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(np.broadcast_to(mask, (B, S, S))),
                         hd ** -0.5, softcap)
    for want in (chunked, full):
        want = np.asarray(want).reshape(B, S, H, hd).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_plain_flash_ignores_a_window_when_not_causal():
    """A non-causal call (an encoder, cross-attention) attends over every
    key whatever the window, as the reference applies it only if causal;
    the cap still applies."""
    rng = np.random.default_rng(43)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 2, 9, 16), (1, 1, 20, 16), (1, 1, 20, 16)))
    for cap in (0.0, 0.4):
        assert torch.equal(
            reference_attention(q, k, v, scale=0.25, causal=False, window=3,
                                softcap=cap),
            reference_attention(q, k, v, scale=0.25, causal=False,
                                softcap=cap))


# ------------------------------------------------------ the CPU wrappers

@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_cpu_decode_wrapper_takes_an_int8_cache(dt):
    """On the CPU the wrapper takes int8 K/V with bf16 scales beside an
    f32 or bf16 q, and gives its plain version's output (and counts no
    launch); the flash wrapper passes its window and cap on too."""
    rng = np.random.default_rng(47)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(
        np.float32)).to(dt)
    k, ks = quantize_kv(torch.randn(2, 1, 24, 16))
    v, vs = quantize_kv(torch.randn(2, 1, 24, 16))
    lengths = torch.tensor([3, 24], dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, lengths, window=4, softcap=0.5,
                           k_scale=ks, v_scale=vs)
    assert decode_attention.launches == before
    assert got.dtype == dt
    assert torch.equal(got, reference_decode_attention(
        q, k, v, lengths, scale=0.25, window=4, softcap=0.5, k_scale=ks,
        v_scale=vs))
    qf = torch.randn(1, 4, 10, 16).to(dt)
    kf, vf = torch.randn(1, 1, 10, 16).to(dt), torch.randn(1, 1, 10, 16).to(dt)
    assert torch.equal(
        flash_attention(qf, kf, vf, window=3, softcap=0.5),
        reference_attention(qf, kf, vf, scale=0.25, window=3, softcap=0.5))


@pytest.mark.parametrize("case,match", [
    ("no k_scale", "needs k_scale"),
    ("no v_scale", "needs v_scale"),
    ("scale without position axis", "must be bf16"),
    ("float32 scale", "must be bf16"),
    ("scale of another length", "must be bf16"),
    ("scale on a bf16 cache", "int8 cache only"),
])
def test_cpu_decode_wrapper_rejects_bad_scales(case, match):
    """A missing, mis-shaped or mistyped scale raises on the CPU as on
    the card (the wrapper checks it before either path)."""
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 1, 24, 16, dtype=torch.int8)
    s = torch.zeros(2, 1, 24, 1, dtype=torch.bfloat16)
    kw = dict(k_scale=s, v_scale=s)
    if case == "no k_scale":
        kw["k_scale"] = None
    elif case == "no v_scale":
        kw["v_scale"] = None
    elif case == "scale without position axis":
        kw["k_scale"] = s[..., 0]
    elif case == "float32 scale":
        kw["v_scale"] = s.float()
    elif case == "scale of another length":
        kw["k_scale"] = torch.zeros(2, 1, 23, 1, dtype=torch.bfloat16)
    elif case == "scale on a bf16 cache":
        k = k.to(torch.bfloat16)
    lengths = torch.tensor([3, 24], dtype=torch.int32)
    with pytest.raises(ValueError, match=match):
        decode_attention(q, k, k, lengths, **kw)


def test_int8_shared_memory_at_gemma_full_width():
    """`smem_bytes` of an int8 cache adds the K and V scale buffers (128
    bytes each) to staging buffers of one byte an element: at gemma-2b's
    shape, 128 + 2 x 8320 + 2 x 128 + the scores and weights of 8 heads;
    its merge weights at 8,192 positions (256 chunks) fit under them, and
    the wrapper's checks take the full-width int8 cache (meta tensors)."""
    assert smem_bytes(8192, 8, 256, 1) == \
        128 + 2 * 8320 + 2 * 128 + 4 * 8 * 64
    assert smem_bytes(8192, 8, 256, 2) == 128 + 2 * 16512 + 4 * 8 * 64
    q = torch.empty(4, 8, 256, dtype=torch.bfloat16, device="meta")
    k = torch.empty(4, 1, 8192, 256, dtype=torch.int8, device="meta")
    s = torch.empty(4, 1, 8192, 1, dtype=torch.bfloat16, device="meta")
    lengths = torch.empty(4, dtype=torch.int32, device="meta")
    check_inputs(q, k, k, lengths, s, s)


# -------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(weights):
    """serve_tiered_kv's scenario (tests/test_torch_serving.py) on the
    Gemma 2 config through both engines: six requests of 5-20 tokens and
    12 new tokens each (every window crossed), two paused and resumed
    through flash."""
    jcfg, cfg, jp, tp, rules = weights
    ref = _scenario(
        lambda pol, st: JEngine(jcfg, jp, rules, max_slots=4,
                                max_len=MAX_LEN, policy=pol, store=st,
                                step_time=STEP),
        JReq, JPolicy, JTier, JClock, JStore, JSpec, jcfg)
    port = _scenario(
        lambda pol, st: TEngine(cfg, tp, max_slots=4, max_len=MAX_LEN,
                                policy=pol, store=st, step_time=STEP,
                                device="cpu"),
        TReq, TPolicy, TTier, TClock, TStore, TSpec, cfg)
    return ref, port


def test_engine_serves_gemma2_with_the_reference_tokens(served, weights):
    """The engines' greedy tokens, tiers, stall and store counters are
    the reference's across a pause to flash and a prefetched resume, and
    the paused blobs (the whole cache, no ring buffer) match at 1e-5."""
    ref, port = served
    assert port["tokens"] == ref["tokens"]
    assert port["done"] == ref["done"] and port["steps"] == ref["steps"]
    assert port["tiers"] == ref["tiers"]
    assert port["tiers"][2] == int(TTier.FLASH)
    assert port["stall"] == ref["stall"]
    assert port["tier_stats"] == ref["tier_stats"]
    cfg = weights[1]
    assert port["blobs"].keys() == ref["blobs"].keys()
    for key, want in ref["blobs"].items():
        assert port["blobs"][key].nbytes == _blob_bytes(cfg)
        np.testing.assert_allclose(port["blobs"][key], want, atol=1e-5,
                                   err_msg=str(key))


def test_engine_park_keeps_gemma2_tokens(weights):
    """A session parked three steps decodes the tokens of its unbroken
    run, on both engines, and those are the reference's."""
    jcfg, cfg, jp, tp, rules = weights

    def port():
        return TEngine(cfg, tp, max_slots=2, max_len=MAX_LEN, device="cpu")

    def ref():
        return JEngine(jcfg, jp, rules, max_slots=2, max_len=MAX_LEN)
    whole = _park_run(port, TReq, cfg, park=False)
    assert _park_run(port, TReq, cfg, park=True) == whole
    assert _park_run(ref, JReq, jcfg, park=False) == whole
    assert _park_run(ref, JReq, jcfg, park=True) == whole


def test_features_add_no_weights(weights):
    """`params_from_jax` needs nothing new: the features add no weights,
    so the reference's weights of the pattern without them load into the
    Gemma 2 config and are its weights leaf for leaf."""
    _, cfg, _, tp, _ = weights
    plain_j = gemma2(j_get_config, **NONE)
    assert TM.param_shapes(cfg) == TM.param_shapes(
        gemma2(get_config, **NONE))
    jp, _ = JM.init_params(jax.random.PRNGKey(0), plain_j)
    got = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    a, b = dict(_leaves(got)), dict(_leaves(tp))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
