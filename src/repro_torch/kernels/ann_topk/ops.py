"""Wrapper of the fused distance + top-k kernel (`csrc/ann_topk.cu`)."""
from __future__ import annotations

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_ann_topk

BLOCK_Q = 128         # queries per block of the first pass
TILE = 128            # corpus rows per tile
MAX_K = 256
MAX_SPLITS = 128      # per-split lists the merge pass takes per query
# a corpus of SEED_MIN_ROWS rows or more is searched twice: first a strided
# sample of max(SEED_ROWS, 16 k) rows, whose k-th distances bound the
# second, full pass
SEED_ROWS = 2048
SEED_MIN_ROWS = 131_072
# the first pass's shared memory (`ann_smem_bytes` in csrc/ann_topk.cu)
CHUNK = 64            # features per pipeline step
QUERY_CHUNK = 128     # query features staged at once
STAGES = 2            # corpus steps in the ring
BUFFER = 64           # candidate slots per query
THREADS = 256
# an H100 SM: shared memory, of which each resident block takes 1 KB more,
# registers and threads; and the first pass's register cap under
# __launch_bounds__(256, 1)
SM_SMEM, BLOCK_RESERVED = 228 * 1024, 1024
SM_REGISTERS, SM_THREADS = 65536, 2048
MAX_REGISTERS = 255


def smem_bytes() -> int:
    """Shared memory of one first-pass block, the same at every k: the
    per-query buffers, thresholds and their caps (64-bit keys), the staged
    queries and the corpus ring (rows padded by 4 floats), per-query
    threshold distances, counts and list flags, and the tile's |c|^2."""
    return (BLOCK_Q * (BUFFER + 2) * 8
            + (BLOCK_Q * (QUERY_CHUNK + 4) + STAGES * TILE * (CHUNK + 4)) * 4
            + (3 * BLOCK_Q + TILE) * 4)


def resident_blocks() -> int:
    """First-pass blocks an H100 SM holds by the design's own limits
    (shared memory, the register cap, threads); `blocks_per_sm` asks the
    card, which must agree."""
    regs = -(-MAX_REGISTERS // 8) * 8          # allocated 8 a thread
    return min(SM_SMEM // (smem_bytes() + BLOCK_RESERVED),
               SM_REGISTERS // (THREADS * regs), SM_THREADS // THREADS)


def split_plan(n_q: int, n_c: int, n_sm: int, per_sm: int):
    """(n_splits, tiles_per_split): the corpus's tiles cut into contiguous
    splits so that query blocks x splits fill the card's resident blocks
    (`per_sm` first-pass blocks on each of `n_sm` SMs) once. Blocks of one
    split plan do equal work, so a second, partial wave would leave most
    SMs idle while it runs."""
    q_blocks = -(-n_q // BLOCK_Q)
    n_tiles = -(-n_c // TILE)
    want = min(MAX_SPLITS, n_tiles, max(1, per_sm * n_sm // q_blocks))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def blocks_per_sm(k: int, device: torch.device) -> int:
    """First-pass blocks resident on one SM of `device` at this k, as the
    card reports them for the kernel's shared memory and registers."""
    with torch.cuda.device(device):
        n = library("ann_topk_blocks_per_sm")(k)
    check("ann_topk", max(0, -n))
    if n < 1:
        raise RuntimeError(f"ann_topk: no first-pass block fits an SM at "
                           f"k = {k}")
    return n


def ann_topk(queries: torch.Tensor, corpus: torch.Tensor, *,
             k: int = 16):
    """queries [Q, D], corpus [N, D] float32 -> (dists [Q, k] float32,
    ids [Q, k] int32), the k nearest rows by |c|^2 - 2 q.c, ties to the
    lower id. A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel (or raises)."""
    if queries.dim() != 2 or corpus.dim() != 2 \
            or queries.shape[1] != corpus.shape[1]:
        raise ValueError(f"ann_topk: queries [Q, D] and corpus [N, D], got "
                         f"{tuple(queries.shape)} and {tuple(corpus.shape)}")
    Q, D = queries.shape
    N = corpus.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"ann_topk: k = {k} must lie in [1, N = {N}]")
    if not on_cuda("ann_topk", queries, corpus):
        return reference_ann_topk(queries, corpus, k)
    if k > MAX_K:
        raise ValueError(f"ann_topk: k = {k} exceeds the kernel's {MAX_K}")
    if queries.dtype != torch.float32 or corpus.dtype != torch.float32 \
            or not (queries.is_contiguous() and corpus.is_contiguous()):
        raise ValueError("ann_topk: queries and corpus must be contiguous "
                         "float32")
    if max(Q, N, D) >= 2**31:
        raise ValueError("ann_topk: Q, N and D must fit in int32")
    return _launch(queries, corpus, k, seed_bound(queries, corpus, k))


def seed_bound(queries: torch.Tensor, corpus: torch.Tensor, k: int):
    """Each query's k-th nearest distance in a strided sample of
    max(SEED_ROWS, 16 k) corpus rows (`ann_topk` on the sample: the kernel
    on CUDA tensors, the plain version on CPU tensors), or None for a
    corpus under SEED_MIN_ROWS rows. The k-th nearest in the whole
    corpus is no farther, so the full pass admits only distances up to
    this bound: its splits skip filling their lists from scratch, and the
    result is the same. 16 k rows put the bound near the same quantile at
    every k."""
    N = corpus.shape[0]
    if N < SEED_MIN_ROWS:
        return None
    rows = max(SEED_ROWS, 16 * k)
    sample = corpus[::N // rows][:rows].contiguous()
    return ann_topk(queries, sample, k=k)[0][:, k - 1].contiguous()


def _launch(queries, corpus, k: int, bound):
    """One launch of the kernel (both passes) on contiguous float32 CUDA
    tensors, the first pass bounded by `bound` [Q] where one is given."""
    Q, D = queries.shape
    N = corpus.shape[0]
    dev = queries.device
    n_splits, per = split_plan(
        Q, N, torch.cuda.get_device_properties(dev).multi_processor_count,
        blocks_per_sm(k, dev))
    part_d = torch.empty((Q, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_splits, k), dtype=torch.int32, device=dev)
    dists = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    err = library("ann_topk")(
        queries.data_ptr(), corpus.data_ptr(),
        None if bound is None else bound.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), dists.data_ptr(), ids.data_ptr(), Q, N, D, k,
        n_splits, per, stream_of(dev))
    check("ann_topk", err)
    ann_topk.launches += 1
    return dists, ids


ann_topk.launches = 0
