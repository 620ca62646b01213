"""Wrapper of the fused distance + top-k kernel (`csrc/ann_topk.cu`)."""
from __future__ import annotations

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_ann_topk

BLOCK_Q = 64          # queries per block of the first pass
TILE = 64             # corpus rows per tile
MAX_K = 256
MAX_SPLITS = 128      # per-split lists the merge pass takes per query


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
    if Q >= 2**31 or D >= 2**31:
        raise ValueError("ann_topk: Q and D must fit in int32")
    dev = queries.device
    n_splits, per = split_plan(
        Q, N, torch.cuda.get_device_properties(dev).multi_processor_count,
        blocks_per_sm(k, dev))
    part_d = torch.empty((Q, n_splits, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_splits, k), dtype=torch.int32, device=dev)
    dists = torch.empty((Q, k), dtype=torch.float32, device=dev)
    ids = torch.empty((Q, k), dtype=torch.int32, device=dev)
    err = library("ann_topk")(
        queries.data_ptr(), corpus.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), dists.data_ptr(), ids.data_ptr(), Q, N, D, k,
        n_splits, per, stream_of(dev))
    check("ann_topk", err)
    ann_topk.launches += 1
    return dists, ids


ann_topk.launches = 0
