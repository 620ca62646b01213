"""Plain PyTorch version of the fused distance + top-k (the CPU path and
the on-card reference of `csrc/ann_topk.cu`)."""
import torch


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of each row of d [Q, N] float32, ordered by
    (value, column): ties go to the lower column, as `lax.top_k` gives
    them. One `torch.topk` over int64 keys that pack an order-preserving
    image of the float's bits above the column index. Returns (values,
    columns int64)."""
    d = d.float() + 0.0                   # -0.0 -> +0.0: one zero
    bits = d.view(torch.int32).long()
    # negative floats order backwards as signed ints: flip their magnitude
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    cols = torch.arange(d.shape[1], device=d.device)
    key = ordered * 2**32 + cols
    cols = torch.topk(key, k, dim=1, largest=False, sorted=True).values \
        & 0xFFFFFFFF
    return torch.gather(d, 1, cols), cols


def reference_ann_topk(queries, corpus, k: int = 16):
    """queries [Q, D], corpus [N, D] -> (dists [Q, k] float32, ids [Q, k]
    int32). Same rank-preserving distance as the kernel: |c|^2 - 2 q.c
    (no |q|^2 term)."""
    qf = queries.float()
    cf = corpus.float()
    d = torch.sum(cf * cf, dim=1)[None, :] - 2.0 * (qf @ cf.T)
    dists, ids = smallest_k(d, k)
    return dists, ids.to(torch.int32)
