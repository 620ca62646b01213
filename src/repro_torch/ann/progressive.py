"""Two-stage progressive SSD-resident ANN search (paper §VII-B, Fig. 9).

Stage 1: scan *reduced* vectors (512B-class rows) with the fused
distance+top-M kernel (`kernels.ann_topk`) — predominantly small-block
reads, the IOPS-friendly regime Storage-Next unlocks.
Stage 2: re-rank the small promoted candidate set on *full* vectors
(2-8KB rows) — the bandwidth-bound tail, amortized by the >90% rejection
rate of stage 1 (Gao et al.). It is a gather, a batched product and a
sort, in plain PyTorch, as the reference leaves it outside its kernel.

`search` and `exact_topk` run on CUDA unless the caller passes another
device; numpy inputs are copied there. `search` measures recall against
exact brute force; the paper's >98% recall claim is validated on the
MRL-like corpus in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._device import resolve_device
from ..kernels.ann_topk.ops import ann_topk
from ..kernels.ann_topk.ref import smallest_k


@dataclasses.dataclass
class SearchStats:
    queries: int = 0
    stage1_reads: int = 0            # reduced-vector row reads (512B-class)
    stage2_reads: int = 0            # full-vector row reads (KB-class)


def exact_topk(queries, corpus, k: int, device=None) -> torch.Tensor:
    """Brute-force ids [Q, k] (int64) of the k nearest corpus rows, by
    |c|^2 - 2 q.c, ties to the lower id."""
    device = resolve_device(device)
    q = torch.as_tensor(queries, device=device)
    c = torch.as_tensor(corpus, device=device)
    d = torch.sum(c * c, dim=1)[None, :] - 2.0 * (q @ c.T)
    return smallest_k(d, k)[1]


def search(queries, reduced, full, k: int = 10, promote: int = 64,
           stats: SearchStats = None, use_kernel: bool = True,
           device=None) -> Tuple[torch.Tensor, SearchStats]:
    """Two-stage search. Returns (ids [Q, k] int64 on the device, stats).
    use_kernel=False takes stage 1 by `exact_topk` instead."""
    device = resolve_device(device)
    q = torch.as_tensor(queries, device=device)
    red = torch.as_tensor(reduced, device=device)
    full = torch.as_tensor(full, device=device)
    stats = stats or SearchStats()
    Q = len(q)
    q_red = q[:, :red.shape[1]].contiguous()
    # stage 1: top-`promote` on reduced vectors
    if use_kernel:
        cand = ann_topk(q_red, red, k=promote)[1].long()
    else:
        cand = exact_topk(q_red, red, promote, device=device)
    stats.queries += Q
    stats.stage1_reads += Q * len(red)          # streamed scan rows
    # stage 2: exact re-rank of the promoted set on full vectors
    gather = full[cand]                         # [Q, promote, D]
    stats.stage2_reads += Q * promote
    d2 = torch.sum(gather ** 2, dim=-1) - 2.0 * torch.einsum(
        "qd,qpd->qp", q, gather)
    order = smallest_k(d2, k)[1]
    return torch.gather(cand, 1, order), stats


def recall_at_k(pred, truth) -> float:
    """Share of the true neighbours found: |pred_row ∩ truth_row| summed
    over rows, over truth's size. Rows hold distinct ids, as top-k rows
    do. Computed where `pred` lies."""
    p = torch.as_tensor(pred)
    t = torch.as_tensor(truth, device=p.device)
    hits = (p[:, :, None] == t[:, None, :]).any(dim=-1).sum()
    return int(hits) / t.numel()
