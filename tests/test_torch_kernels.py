"""The plain PyTorch versions of the port's kernels against the JAX
reference: its Pallas kernels (interpret mode on the CPU, as
tests/test_kernels.py runs them) and its jnp oracles (`ref.py`).

Tolerances: float32 atol 1e-5 — the same float32 math in another
summation order; bfloat16 atol 2e-2 — inputs are the same bf16 values on
both sides, outputs are rounded to bf16 (2^-8 relative) after float32
math in another order. On the CPU the kernel wrappers take the plain
version and count no launch; the CUDA kernels themselves are held against
these plain versions on the card by chip_smoke.py."""
import pathlib

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
from repro_torch.kernels.decode_attention.ops import check_inputs, \
    heads_per_group, scratch_numel, smem_bytes
from repro_torch.kernels.decode_attention.ref import \
    reference_decode_attention
from repro_torch.kernels.flash_attention.ops import kernel_head_dim, \
    padded_attention
from repro_torch.kernels.flash_attention.ref import reference_attention
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import reference_add_rmsnorm, \
    reference_rmsnorm

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


@pytest.mark.parametrize("shape", [(4, 256), (3, 100, 512), (1, 8, 2048)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_add_rmsnorm_plain_matches_jax(shape, dt):
    """add_rmsnorm's plain version against x + r, then the reference's
    oracle and its Pallas kernel (interpret mode); the sum is the same
    rounded add on both sides, so it compares exactly."""
    rng = np.random.default_rng(1)
    jx, tx = _pair(rng, shape, dt)
    jr, tr = _pair(rng, shape, dt)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    normed, summed = reference_add_rmsnorm(tx, tr, torch.from_numpy(s),
                                           1e-6)
    assert normed.dtype == summed.dtype == tx.dtype
    assert normed.shape == summed.shape == tx.shape
    js = jx + jr
    np.testing.assert_array_equal(summed.float().numpy(),
                                  np.asarray(js, np.float32))
    _assert_close(normed, j_rms(js, jnp.asarray(s), eps=1e-6), dt)
    _assert_close(normed, j_rms_ref(js, jnp.asarray(s), 1e-6), dt)


# (rows, D, itemsize, aligned) -> (threads a row, chunks a thread, rows a
# block, blocks, path), worked by hand from the rule in csrc/rmsnorm.cu
PLAN_EDGES = [
    ((4, 2048, 2, True), (256, 1, 1, 4, "vector")),      # decode step
    ((1, 2048, 2, True), (256, 1, 1, 1, "vector")),
    ((1023, 2048, 2, True), (256, 1, 2, 512, "vector")),  # prefill
    ((1023, 2048, 4, True), (512, 1, 1, 1023, "vector")),
    ((4, 64, 2, True), (8, 1, 4, 1, "vector")),          # rows share warps
    ((1023, 64, 4, True), (16, 1, 4, 256, "vector")),
    ((1, 8192, 2, True), (1024, 1, 1, 1, "vector")),
    ((1023, 8192, 2, True), (1024, 1, 1, 1023, "vector")),
    ((1023, 8192, 4, True), (1024, 2, 1, 1023, "vector")),
    ((4, 8192, 4, True), (1024, 2, 1, 4, "vector")),
    ((1023, 2050, 2, True), (288, 1, 1, 1023, "scalar")),  # D % 8 != 0
    ((4, 2050, 4, True), (544, 1, 1, 4, "scalar")),
    ((1023, 2048, 2, False), (256, 1, 2, 512, "scalar")),  # odd offset
    ((4, 2048, 2, False), (256, 1, 1, 4, "scalar")),
    ((4, 1, 2, True), (1, 1, 32, 1, "scalar")),
    ((8 * 132, 256, 2, True), (32, 1, 8, 132, "vector")),
    ((8 * 132 - 1, 256, 2, True), (32, 1, 4, 264, "vector")),
    ((8 * 132, 1536, 2, True), (192, 1, 2, 528, "vector")),
    ((2 * 132 - 1, 2048, 2, True), (256, 1, 1, 263, "vector")),
]


@pytest.mark.parametrize("args,want", PLAN_EDGES,
                         ids=[str(a) for a, _ in PLAN_EDGES])
def test_rmsnorm_launch_plan_at_its_edges(args, want):
    """ops.launch_plan, the Python twin of `rmsnorm_plan` (the card checks
    the two agree, chip_smoke phase 3): a row's chunks across its threads,
    rows packed into whole warps and then into blocks of up to 512 threads
    while every SM still gets a block; the scalar path for a ragged D or a
    misaligned pointer."""
    rows, d, itemsize, aligned = args
    plan = rms_ops.launch_plan(rows, d, itemsize, aligned)
    got = tuple(plan[k] for k in ("row_threads", "chunks", "rows", "blocks",
                                  "path"))
    assert got == want
    threads = plan["rows"] * plan["row_threads"]
    assert threads % 32 == 0 and threads <= rms_ops.MAX_THREADS
    assert plan["chunks"] * plan["row_threads"] * 16 // itemsize >= d


def test_rmsnorm_constants_match_the_source():
    src = (pathlib.Path(__file__).resolve().parents[1] / "src" /
           "repro_torch" / "csrc" / "rmsnorm.cu").read_text()
    for name, value in (("kRmsVecBytes", rms_ops.VEC_BYTES),
                        ("kRmsMaxThreads", rms_ops.MAX_THREADS),
                        ("kRmsBlockThreads", rms_ops.BLOCK_THREADS),
                        ("kRmsMaxRowBytes", rms_ops.MAX_ROW_BYTES)):
        assert f"constexpr int {name} = {value};" in src, name
    # the widest row the kernel takes: 1024 threads x 2 chunks of 16 bytes
    assert rms_ops.MAX_ROW_BYTES == 2 * rms_ops.MAX_THREADS * 16
    assert rms_ops.launch_plan(1, rms_ops.MAX_ROW_BYTES // 2, 2)[
        "chunks"] == 2


@pytest.mark.parametrize("B,H,KV,T,D,lengths", [
    (4, 8, 1, 1024, 64, [1, 77, 700, 1024]),  # gemma MQA, ragged
    (2, 8, 2, 600, 128, [600, 333]),          # GQA, T not a block multiple
    (3, 4, 4, 96, 32, [96, 1, 50]),           # MHA, T < block
    (3, 8, 1, 64, 32, [0, 5, 100]),           # lengths 0 and above T
])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_decode_attention_plain_matches_jax(B, H, KV, T, D, lengths, dt):
    """Lengths above T count as T. A row of length 0 gives zeros, as the
    Pallas kernel gives; the reference's jnp oracle softmaxes that
    all-masked row into the mean of v, so it is held to the rows with a
    filled position only."""
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
    live = lens > 0
    want = j_dec_ref(jq, jk, jv, jnp.asarray(lens), scale=scale)
    _assert_close(got[torch.from_numpy(live)], np.asarray(want)[live], dt)
    assert not got[torch.from_numpy(~live)].any()


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


@pytest.mark.parametrize("qr,hg", [(1, 1), (2, 2), (3, 4), (4, 4), (6, 8),
                                   (8, 8), (12, 8), (32, 8)])
def test_decode_attention_head_groups(qr, hg):
    """The kernel holds q for up to 8 heads a lane at once, in powers of
    two; more heads per kv head run in groups of 8."""
    assert heads_per_group(qr) == hg


def test_decode_attention_shared_memory_and_scratch_sizes():
    """`smem_bytes` mirrors the kernel's `DecLayout`: 128 bytes for the
    mbarrier, then two 128-byte padded staging buffers of 32 rows (16
    spare bytes for an unaligned start) and float32 scores and weights
    [32][qp], or the float32 merge weights [n_chunks][qp] laid over them,
    whichever is larger. At gemma-2b's decode shape: 128 + 2 * 16512 +
    4 * 8 * 64 (the merge weights, 4 * 8 * 32, fit under them)."""
    assert smem_bytes(1024, 8, 256, 2) == 128 + 2 * 16512 + 4 * 8 * 64
    assert smem_bytes(1024, 8, 256, 4) == 128 + 2 * 32896 + 4 * 8 * 64
    # qr 3 runs as a group of 4 heads; hd 7 rows are 14 bytes
    assert smem_bytes(61, 3, 7, 2) == 128 + 2 * 512 + 4 * 4 * 64
    # granite-20b at its max_seq: 48 heads' merge weights over 1,024
    # chunks outgrow the staging (2 * 16512 + 4 * 48 * 64 in float32)
    assert smem_bytes(32768, 48, 128, 4) == 128 + 4 * 48 * 1024
    assert smem_bytes(32768, 48, 128, 2) == 128 + 4 * 48 * 1024
    # mistral-nemo-12b at its max_seq: 4 heads over 4,096 chunks
    assert smem_bytes(131072, 4, 128, 2) == 128 + 4 * 4 * 4096
    assert scratch_numel(4, 1, 1024, 8, 256) == 4 * 32 * 8 * 258
    assert scratch_numel(3, 2, 1023, 4, 112) == 3 * 2 * 32 * 4 * 114


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_takes_granite_at_its_max_seq(dtype):
    """granite-20b's decode at its own context: 48 query heads on one kv
    head of 128 over 32,768 positions fits a block's shared memory in
    float32 and bf16 (meta tensors: nothing is allocated)."""
    q = torch.empty(4, 48, 128, dtype=dtype, device="meta")
    k = torch.empty(4, 1, 32768, 128, dtype=dtype, device="meta")
    lengths = torch.empty(4, dtype=torch.int32, device="meta")
    check_inputs(q, k, k, lengths)
    with pytest.raises(ValueError, match="shared memory"):
        check_inputs(q, torch.empty(4, 1, 38752, 128, dtype=dtype,
                                    device="meta"),
                     torch.empty(4, 1, 38752, 128, dtype=dtype,
                                 device="meta"), lengths)


def test_decode_attention_takes_the_cache_layouts_of_the_path():
    """The model's cache (a layer's [B,KV,T,hd] slice of [G,B,KV,T,hd])
    with q a [B,1,H,hd] projection's token 0, and chip_smoke's inputs,
    have contiguous rows: the kernel takes them."""
    cache = torch.zeros(3, 4, 1, 64, 32)
    q = torch.zeros(4, 1, 8, 32)[:, 0]
    lens = torch.zeros(4, dtype=torch.int32)
    check_inputs(q, cache[1], cache[2], lens)
    check_inputs(torch.zeros(4, 8, 256), torch.zeros(4, 2, 1023, 256),
                 torch.zeros(4, 2, 1023, 256), lens)


@pytest.mark.parametrize("case,match", [
    ("strided rows", "rows of k must be contiguous"),
    ("transposed v", "rows of v must be contiguous"),
    ("int64 lengths", "lengths must be int32"),
    ("head_dim 300", "head_dim <= 256"),
    ("GQA mismatch", "does not match"),
    ("shared memory", "shared memory"),
])
def test_decode_attention_raises_for_what_the_kernel_does_not_take(
        case, match):
    q, k = torch.zeros(2, 8, 32), torch.zeros(2, 1, 64, 32)
    lens = torch.zeros(2, dtype=torch.int32)
    args = dict(q=q, k=k, v=k, lengths=lens)
    if case == "strided rows":
        args["k"] = torch.zeros(2, 1, 128, 32)[:, :, ::2]
        args["v"] = args["k"]
    elif case == "transposed v":
        args["v"] = torch.zeros(2, 1, 32, 64).transpose(2, 3)
    elif case == "int64 lengths":
        args["lengths"] = lens.long()
    elif case == "head_dim 300":
        args.update(q=torch.zeros(2, 8, 300), k=torch.zeros(2, 1, 64, 300),
                    v=torch.zeros(2, 1, 64, 300))
    elif case == "GQA mismatch":
        args.update(k=torch.zeros(2, 3, 64, 32), v=torch.zeros(2, 3, 64, 32))
    elif case == "shared memory":       # merge weights of 8192 chunks
        args.update(q=torch.zeros(2, 8, 1), k=torch.zeros(2, 1, 1 << 18, 1),
                    v=torch.zeros(2, 1, 1 << 18, 1))
    with pytest.raises(ValueError, match=match):
        check_inputs(**args)


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


@pytest.mark.parametrize("B,H,KV,S,T,D", [
    (1, 4, 4, 48, 48, 16),       # S = T, MHA: an encoder's self-attention
    (2, 4, 4, 7, 48, 64),        # S < T: cross-attention onto 48 rows
    (1, 4, 1, 1, 40, 16),        # one query (a decode step's), MQA
    (1, 8, 2, 60, 24, 64),       # S > T, GQA
    (2, 6, 3, 33, 33, 16),       # S = T, GQA, S not a block multiple
])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_attention_non_causal_plain_matches_jax(B, H, KV, S, T, D, dt):
    """causal=False: every query sees all T keys (whisper's encoder at S =
    T, its cross-attention at S != T), against the reference's Pallas
    kernel in interpret mode and its oracle; the wrapper on the CPU is the
    plain version, and causal=True still masks."""
    rng = np.random.default_rng(S * T)
    jq, tq = _pair(rng, (B, H, S, D), dt)
    jk, tk = _pair(rng, (B, KV, T, D), dt)
    jv, tv = _pair(rng, (B, KV, T, D), dt)
    # a Python float: a NumPy float64 would promote the Pallas kernel's
    # float32 scratch where another test turned on JAX's x64 mode
    scale = float(1.0 / np.sqrt(D))
    got = reference_attention(tq, tk, tv, scale=scale, causal=False)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    _assert_close(got, j_fref(jq, jk, jv, causal=False, scale=scale), dt)
    _assert_close(got, j_flash(jq, jk, jv, False, scale, True), dt)
    assert torch.equal(K.flash_attention(tq, tk, tv, scale=scale,
                                         causal=False), got)
    if S > 1:
        assert not torch.equal(
            reference_attention(tq, tk, tv, scale=scale), got)


@pytest.mark.parametrize("D,want_bf16,want_f32", [
    (16, 64, 32), (32, 64, 32), (112, 128, 128)])
def test_flash_attention_padded_head_dim_matches_jax(D, want_bf16, want_f32):
    """Pad, attend, slice: at the head_dim each kernel takes, zero-padded
    q, k and v give attention at the true head_dim (the scale from it), to
    float32 tolerance, against the reference's oracle and its Pallas
    kernel."""
    assert kernel_head_dim(D, torch.bfloat16) == want_bf16
    assert kernel_head_dim(D, torch.float32) == want_f32
    rng = np.random.default_rng(6)
    jq, tq = _pair(rng, (1, 4, 80, D), "float32")
    jk, tk = _pair(rng, (1, 1, 80, D), "float32")
    jv, tv = _pair(rng, (1, 1, 80, D), "float32")
    scale = 1.0 / np.sqrt(D)
    want = j_fref(jq, jk, jv, causal=True, scale=scale)
    for head_dim in (want_bf16, want_f32):
        got = padded_attention(reference_attention, tq, tk, tv, scale=scale,
                               head_dim=head_dim)
        assert got.shape == (1, 4, 80, D) and got.is_contiguous()
        _assert_close(got, want, "float32")
        _assert_close(got, j_flash(jq, jk, jv, True, None, True), "float32")
    for bad in (0, 257):
        with pytest.raises(ValueError, match="head_dim"):
            kernel_head_dim(bad, torch.bfloat16)


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    K.reset_launch_counts()
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    s = torch.ones(64)
    assert torch.equal(K.rmsnorm(x, s), reference_rmsnorm(x, s))
    r = torch.from_numpy(rng.standard_normal((3, 5, 64)).astype(np.float32))
    normed, summed = K.add_rmsnorm(x, r, s)
    want_normed, want_summed = reference_add_rmsnorm(x, r, s)
    assert torch.equal(normed, want_normed)
    assert torch.equal(summed, want_summed) and torch.equal(summed, x + r)
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
                                 "ann_topk": 0, "reuse_sketch": 0,
                                 "flash_attention_bwd": 0, "rmsnorm_bwd": 0}
