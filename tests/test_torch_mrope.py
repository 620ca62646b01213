"""M-RoPE and the vision prefix (qwen2-vl-2b) in the PyTorch port against
the JAX reference on the same seeded numpy inputs, float32, on the CPU:
`apply_mrope` with three distinct position streams (and a swapped
section or stream, which must differ), `apply_mrope` with equal streams
bit for bit `apply_rope`, and reduced qwen2-vl-2b's prefill behind a
vision prefix of 16 patch embeddings, then decode, and its train
forward, with logits and every cache leaf compared; the full-width
trees' shapes on `jax.eval_shape`.

Positions: "index" is t = the sequence index everywhere, h and w a patch
grid at fixed offsets over the image and the index over the text; it
keeps the reference's mask index-causal. "qwen2-vl" is Qwen2-VL's own
rule: t constant over the image, h and w the patch's row and column, the
text from the image's largest position + 1 on all three streams. The
reference masks a prefill by t's value against cache indices and a train
forward by t's value against the first row's, so on that rule its two
modes disagree; the port masks by the index in every mode, as both TPU
attention kernels do (ROADMAP Queue 3, reference quirks).

Values compare at ATOL: the same float32 function in two frameworks
(observed differences ~1e-6, as in tests/test_torch_model.py). Rotations
alone compare at ROT_ATOL: the two libraries' float32 frequencies
`theta ** (-i / half)` differ by an ulp at a few i (4 of 64 at head_dim
128), which at positions up to 1e3 moves an angle by up to ~1e-4 rad
(observed 1.3e-5 at head_dim 128, 2.4e-7 at 16)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as JA
from repro.models import model as JM
from repro.models.layers import apply_mrope as j_apply_mrope
from repro.parallel.sharding import single_device_rules
from repro_torch.configs import get_config
from repro_torch.models import model as TM
from repro_torch.models.layers import apply_mrope, apply_rope

from test_torch_model import _assert_caches_close

ATOL = 1e-4
ROT_ATOL = 1e-4
ARCH = "qwen2-vl-2b"
GRID = 4                       # the prefix: a 4 x 4 grid of patches
N_IMG = GRID * GRID
N_TEXT = 10
OFFSETS = (3, 5)               # "index" rule: h = 3 + row, w = 5 + column
MAX_LEN = 32


def _streams(rng, B, S, H, hd):
    """x [B,S,H,hd] float32 and three distinct position streams [3,B,S]."""
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 1000, (3, B, S))
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return x, pos


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
def test_apply_mrope_matches_reference(sections, hd):
    x, pos = _streams(np.random.default_rng(hd), 2, 7, 3, hd)
    want = j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROT_ATOL,
                               rtol=0)


@pytest.mark.parametrize("swap", ["sections", "streams"])
def test_a_swapped_section_or_stream_differs(swap):
    """The parity above catches a band that takes the wrong stream: with
    the first two sections swapped, or the h and w streams swapped, the
    port's rotation lies far from the reference's."""
    sections = (16, 24, 24)
    x, pos = _streams(np.random.default_rng(9), 2, 7, 3, 128)
    want = np.asarray(j_apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6,
                                    sections))
    if swap == "sections":
        got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                          (24, 16, 24))
    else:
        got = apply_mrope(torch.from_numpy(x),
                          torch.from_numpy(pos[[0, 2, 1]].copy()), 1e6,
                          sections)
    assert float(np.abs(got.numpy() - want).max()) > 0.1


@pytest.mark.parametrize("sections,hd", [((2, 3, 3), 16),
                                         ((16, 24, 24), 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_apply_mrope_with_equal_streams_is_apply_rope(sections, hd, dtype):
    """The served paths give all three streams the index: there M-RoPE
    is RoPE, bit for bit (the same frequencies, angles and pairing)."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, hd)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 32768, (2, 9)))
    assert torch.equal(apply_mrope(x, pos[None].expand(3, 2, 9), 1e6,
                                   sections),
                       apply_rope(x, pos, 1e6))


def _vl_positions(B, rule):
    """[3,B,S] positions of the 16-patch prefix and N_TEXT text tokens by
    `rule` ("index" or "qwen2-vl", see the module docstring)."""
    S = N_IMG + N_TEXT
    row, col = np.divmod(np.arange(N_IMG), GRID)
    pos = np.broadcast_to(np.arange(S), (3, S)).copy()
    if rule == "index":
        pos[1, :N_IMG] = OFFSETS[0] + row
        pos[2, :N_IMG] = OFFSETS[1] + col
    else:
        pos[0, :N_IMG] = 0
        pos[1, :N_IMG] = row
        pos[2, :N_IMG] = col
        pos[:, N_IMG:] = GRID + np.arange(N_TEXT)
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, B, S)))


@pytest.fixture(scope="module")
def vl():
    """Reduced qwen2-vl-2b on the reference's weights, two prompts of
    N_TEXT tokens behind 16 patch embeddings (normal x 0.02, as the
    reference's `concrete_batch` draws them)."""
    jcfg = j_get_config(ARCH, reduced=True)
    cfg = get_config(ARCH, reduced=True)
    jp, _ = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TM.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(3)
    B = 2
    toks = rng.integers(0, cfg.vocab, (B, N_TEXT))
    vis = (0.02 * rng.standard_normal((B, N_IMG, cfg.d_model))).astype(
        np.float32)
    return jcfg, cfg, jp, tp, toks, vis


def _j_batch(toks, vis, pos):
    return {"tokens": jnp.asarray(toks), "vision_embeds": jnp.asarray(vis),
            "positions": jnp.asarray(pos)}


def _t_inputs(toks, vis, pos):
    return dict(tokens=torch.from_numpy(toks),
                vision_embeds=torch.from_numpy(vis),
                positions=torch.from_numpy(pos))


def test_vision_prefill_then_decode_matches_reference(vl):
    """Prefill behind the prefix at the "index" positions, then three
    per-slot decode steps (the reference's rule: the cache index on all
    three streams): logits at every step and every cache leaf."""
    jcfg, cfg, jp, tp, toks, vis = vl
    rules = single_device_rules()
    B, S = toks.shape[0], N_IMG + N_TEXT
    pos = _vl_positions(B, "index")
    jc = JM.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32)
    jc, jl = JM.prefill(jp, jcfg, rules, _j_batch(toks, vis, pos), jc,
                        compute_dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    ins = _t_inputs(toks, vis, pos)
    tc, tl = TM.prefill(tp, cfg, ins.pop("tokens"), tc,
                        compute_dtype=torch.float32, **ins)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_caches_close(tc, jc, cfg)
    rng = np.random.default_rng(8)
    index = np.array([S, S - 3], np.int32)
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
    _assert_caches_close(tc, jc, cfg)


def test_vision_prefill_last_index_counts_the_prefix(vl):
    """`last_index` counts over the whole sequence, prefix included: the
    logits of the last patch and of a text token equal the reference's
    there."""
    jcfg, cfg, jp, tp, toks, vis = vl
    rules = single_device_rules()
    pos = _vl_positions(toks.shape[0], "index")
    for last in (N_IMG - 1, N_IMG + 4):
        jc = JM.init_cache(jcfg, toks.shape[0], MAX_LEN, dtype=jnp.float32)
        _, jl = JM.prefill(jp, jcfg, rules, _j_batch(toks, vis, pos), jc,
                           compute_dtype=jnp.float32,
                           last_index=jnp.asarray(last, jnp.int32))
        tc = TM.init_cache(cfg, toks.shape[0], MAX_LEN, dtype=torch.float32,
                           device="cpu")
        ins = _t_inputs(toks, vis, pos)
        _, tl = TM.prefill(tp, cfg, ins.pop("tokens"), tc,
                           compute_dtype=torch.float32, last_index=last,
                           **ins)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   err_msg=f"last_index {last}")


def test_vision_forward_matches_reference(vl):
    """The train forward behind the prefix at the "index" positions, every
    position's logits (the prefix's too)."""
    jcfg, cfg, jp, tp, toks, vis = vl
    pos = _vl_positions(toks.shape[0], "index")
    jl, _ = JM.forward(jp, jcfg, single_device_rules(),
                       _j_batch(toks, vis, pos), compute_dtype=jnp.float32,
                       remat=False)
    ins = _t_inputs(toks, vis, pos)
    tl = TM.forward(tp, cfg, ins.pop("tokens"), compute_dtype=torch.float32,
                    **ins)
    assert tl.shape == (toks.shape[0], N_IMG + N_TEXT, cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("rule", ["index", "qwen2-vl"])
def test_forward_and_prefill_agree_on_any_positions(vl, rule):
    """The port masks by the index in both modes, so its forward's logits
    at a position equal its prefill's there, on Qwen2-VL's own rule too."""
    _, cfg, _, tp, toks, vis = vl
    ins = _t_inputs(toks, vis, _vl_positions(toks.shape[0], rule))
    tokens = ins.pop("tokens")
    par = TM.forward(tp, cfg, tokens, compute_dtype=torch.float32, **ins)
    for last in (N_IMG - 1, N_IMG + N_TEXT - 1):
        cache = TM.init_cache(cfg, toks.shape[0], MAX_LEN,
                              dtype=torch.float32, device="cpu")
        _, pre = TM.prefill(tp, cfg, tokens, cache,
                            compute_dtype=torch.float32, last_index=last,
                            **ins)
        np.testing.assert_allclose(pre.numpy(), par[:, last].numpy(),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"position {last}")


def test_reference_masks_by_position_value_the_port_by_index(
        vl, monkeypatch):
    """A reference quirk the port does not copy (ROADMAP Queue 3). On
    Qwen2-VL's rule the reference's forward and prefill disagree: the
    prefill masks by t's value against cache indices, the forward by t's
    value against the first row's. The port's prefill equals the
    reference's prefill run with the same rotation but t = the index for
    the mask (the rotation's positions swapped in at `apply_mrope`), and
    so does its cache; then one decode step, at the cache index on all
    three streams in both packages (not at the largest position + 1:
    the reference's rule, which the port follows), equals the
    reference's."""
    jcfg, cfg, jp, tp, toks, vis = vl
    rules = single_device_rules()
    B, S = toks.shape[0], N_IMG + N_TEXT
    rot = _vl_positions(B, "qwen2-vl")
    j_fwd, _ = JM.forward(jp, jcfg, rules, _j_batch(toks, vis, rot),
                          compute_dtype=jnp.float32, remat=False)
    _, j_pre = JM.prefill(jp, jcfg, rules, _j_batch(toks, vis, rot),
                          JM.init_cache(jcfg, B, MAX_LEN, dtype=jnp.float32),
                          compute_dtype=jnp.float32)
    assert float(np.abs(np.asarray(j_fwd)[:, -1] - np.asarray(j_pre)).max()) \
        > 1e-2
    # t = the index for the reference's mask, Qwen2-VL's positions for
    # its rotation
    masked = rot.copy()
    masked[0] = np.arange(S)
    with monkeypatch.context() as m:
        m.setattr(JA, "apply_mrope",
                  lambda x, pos, theta, sections: j_apply_mrope(
                      x, jnp.asarray(rot), theta, sections))
        jc, jl = JM.prefill(jp, jcfg, rules, _j_batch(toks, vis, masked),
                            JM.init_cache(jcfg, B, MAX_LEN,
                                          dtype=jnp.float32),
                            compute_dtype=jnp.float32)
    tc = TM.init_cache(cfg, B, MAX_LEN, dtype=torch.float32, device="cpu")
    ins = _t_inputs(toks, vis, rot)
    tc, tl = TM.prefill(tp, cfg, ins.pop("tokens"), tc,
                        compute_dtype=torch.float32, **ins)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    _assert_caches_close(tc, jc, cfg)
    tok = np.random.default_rng(2).integers(0, cfg.vocab, (B, 1)).astype(
        np.int32)
    _, jl = JM.decode_step(jp, jcfg, rules, jnp.asarray(tok), jc,
                           jnp.asarray(S, jnp.int32),
                           compute_dtype=jnp.float32)
    _, tl = TM.decode_step(tp, cfg, torch.from_numpy(tok), tc, S,
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)


def test_text_config_ignores_vision_embeds():
    """As the reference: a "text" config's prefill ignores a vision
    prefix (the logits and cache of the tokens alone)."""
    cfg = get_config("gemma-2b", reduced=True)
    tp = TM.init_params(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (1, 6)))
    vis = torch.ones(1, 4, cfg.d_model)
    outs = [TM.prefill(tp, cfg, toks, TM.init_cache(
        cfg, 1, 16, dtype=torch.float32, device="cpu"),
        compute_dtype=torch.float32, **kw)[1] for kw in
        ({}, {"vision_embeds": vis})]
    assert torch.equal(*outs)


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    else:
        yield path


def test_full_width_trees_match_reference_shapes():
    """At full width, on shapes alone (`jax.eval_shape`; nothing is
    made): the reference's `init_params` tree is the port's
    `param_shapes` leaf for leaf (the tree `params_from_jax` takes),
    1,543,656,960 elements, its `param_count()`; `init_cache` at 4 slots
    and 1,024 positions is the port's leaf for leaf and dtype for dtype,
    a slot 29,360,128 B of the bf16 cache and its paused blob 58,720,256 B
    of float32."""
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
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
    assert total == cfg.param_count() == 1_543_656_960
    jc = jax.eval_shape(lambda: JM.init_cache(jcfg, 4, 1024,
                                              dtype=jnp.bfloat16))
    tc = TM.init_cache(cfg, 4, 1024, device="meta")
    assert sorted(_paths(tc)) == sorted(_paths(jax.tree.map(lambda a: 0,
                                                            jc)))
    slot = 0
    for path in _paths(tc):
        want = jc
        for k in path:
            want = want[k]
        got = TM._at_path(tc, path)
        assert tuple(got.shape) == want.shape, path
        assert str(got.dtype).split(".")[1] == str(want.dtype), path
        slot += got[:, 0].numel()
    assert 2 * slot == 29_360_128          # bf16, 28,672 B a position
    assert 4 * slot == 58_720_256          # the blob, float32
