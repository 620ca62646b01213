"""The plain PyTorch versions of the port's kernels against the JAX
reference: its Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) and its jnp oracles (`ref.py`).

Tolerances: float32 atol 1e-5 — the same float32 math in another
summation order; bfloat16 atol 2e-2 — inputs are the same bf16 values on
both sides, outputs are rounded to bf16 (2^-8 relative) after float32
math in another order. On the CPU the kernel wrappers take the plain
version and count no launch; the CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as j_dec
from repro.kernels.decode_attention.ref import \
    reference_decode_attention as j_dec_ref
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import reference_attention as j_fref
from repro.kernels.rmsnorm.ops import rmsnorm as j_rms
from repro.kernels.rmsnorm.ref import reference_rmsnorm as j_rms_ref
from repro_torch import kernels as K
from repro_torch.kernels.decode_attention.ref import \
    reference_decode_attention
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.rmsnorm.ref import reference_rmsnorm

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _pair(rng, shape, dt):
    """The same values as a jax array and a torch tensor of dtype dt."""
    jdt, tdt, _ = DTYPES[dt]
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)


def _assert_close(t, j, dt):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32),
                               atol=DTYPES[dt][2], rtol=DTYPES[dt][2])


@pytest.mark.parametrize("shape", [(4, 256), (3, 100, 512), (1, 8, 2048)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_rmsnorm_plain_matches_jax(shape, dt):
    rng = np.random.default_rng(0)
    jx, tx = _pair(rng, shape, dt)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    got = reference_rmsnorm(tx, torch.from_numpy(s), 1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    _assert_close(got, j_rms(jx, jnp.asarray(s), eps=1e-6), dt)
    _assert_close(got, j_rms_ref(jx, jnp.asarray(s), 1e-6), dt)


@pytest.mark.parametrize("B,H,KV,T,D,lengths", [
    (4, 8, 1, 1024, 64, [1, 77, 700, 1024]),  # gemma MQA, ragged
    (2, 8, 2, 600, 128, [600, 333]),          # GQA, T not a block multiple
    (3, 4, 4, 96, 32, [96, 1, 50]),           # MHA, T < block
])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_plain_matches_jax(B, H, KV, T, D, lengths, dt):
    rng = np.random.default_rng(1)
    jq, tq = _pair(rng, (B, H, D), dt)
    jk, tk = _pair(rng, (B, KV, T, D), dt)
    jv, tv = _pair(rng, (B, KV, T, D), dt)
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / np.sqrt(D)
    got = reference_decode_attention(tq, tk, tv, torch.from_numpy(lens),
                                     scale=scale)
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    _assert_close(got, j_dec(jq, jk, jv, jnp.asarray(lens)), dt)
    _assert_close(got, j_dec_ref(jq, jk, jv, jnp.asarray(lens),
                                 scale=scale), dt)


def test_decode_attention_plain_ignores_a_garbage_tail():
    """Unfilled cache rows may hold anything, NaN included: neither the
    Pallas kernel nor the port lets them reach the output."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 1, 40, 32)).astype(np.float32)
    v = rng.standard_normal((2, 1, 40, 32)).astype(np.float32)
    lens = np.asarray([10, 25], np.int32)
    k[0, :, 10:] = np.nan
    v[0, :, 10:] = np.nan
    v[1, :, 25:] = np.inf
    got = reference_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), scale=0.2)
    want = j_dec(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(lens), scale=0.2)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("B,H,KV,S,T,D", [
    (1, 8, 1, 256, 256, 64),     # gemma-like MQA
    (2, 4, 2, 200, 200, 32),     # GQA, S not a block multiple
    (1, 4, 1, 100, 160, 32),     # S < T (prefill over a longer cache)
])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_attention_plain_matches_jax(B, H, KV, S, T, D, dt):
    rng = np.random.default_rng(3)
    jq, tq = _pair(rng, (B, H, S, D), dt)
    jk, tk = _pair(rng, (B, KV, T, D), dt)
    jv, tv = _pair(rng, (B, KV, T, D), dt)
    scale = 1.0 / np.sqrt(D)
    got = reference_attention(tq, tk, tv, scale=scale)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    _assert_close(got, j_fref(jq, jk, jv, causal=True, scale=scale), dt)
    if S == T:     # the Pallas kernel's causal mask assumes S == T blocks
        _assert_close(got, j_flash(jq, jk, jv, True, None, True), dt)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    K.reset_launch_counts()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    s = torch.ones(64)
    assert torch.equal(K.rmsnorm(x, s), reference_rmsnorm(x, s))
    q = torch.from_numpy(rng.standard_normal((2, 4, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, 9, 32))
                         .astype(np.float32))
    lens = torch.tensor([3, 9], dtype=torch.int32)
    assert torch.equal(
        K.decode_attention(q, k, k, lens),
        reference_decode_attention(q, k, k, lens, scale=32 ** -0.5))
    qf = torch.from_numpy(rng.standard_normal((1, 4, 9, 32))
                          .astype(np.float32))
    assert torch.equal(
        K.flash_attention(qf, k[:1], k[:1]),
        reference_attention(qf, k[:1], k[:1], scale=32 ** -0.5))
    assert K.launch_counts() == {"rmsnorm": 0, "decode_attention": 0,
                                 "flash_attention": 0, "cuckoo_probe": 0,
                                 "ann_topk": 0, "reuse_sketch": 0}
