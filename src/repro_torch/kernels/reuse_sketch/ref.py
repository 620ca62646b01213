"""Plain PyTorch version of the decayed log-bucket reuse-interval sketch
update (the CPU path and the on-card reference of `csrc/reuse_sketch.cu`).

It gives the reference's numpy oracle bit for bit. The oracle's bucket is
the floor of a float32 log2 that numpy rounds correctly, which is not the
exponent of the quotient: one ulp below 2^20 has a log2 that rounds to
exactly 20.0. So the quotient is an IEEE float32 division, its log2 is
taken in float64 and rounded to float32, and only then floored. The
divisor is a tensor on the quotient's device: PyTorch multiplies a CUDA
tensor by the reciprocal of a host scalar instead of dividing by it."""
import torch


def bucket_of(intervals: torch.Tensor, tau0: float,
              n_buckets: int) -> torch.Tensor:
    """Bucket of each interval, floor(log2(interval / tau0)) clipped to
    [0, n_buckets), as float32 (NaN where the interval is NaN)."""
    iv = intervals.to(torch.float32)
    tau = torch.full((), tau0, dtype=torch.float32, device=iv.device)
    q = torch.clamp(iv, min=1e-30) / tau
    lg = torch.log2(q.to(torch.float64)).to(torch.float32)
    return torch.clamp(torch.floor(lg), 0, n_buckets - 1)


def reference_reuse_sketch(hist, intervals, class_ids, *, tau0: float,
                           decay: float, ends=None) -> torch.Tensor:
    """hist [C, B] float32; intervals [N] float32 (<= 0 or NaN marks an
    invalid slot: first touch or padding, skipped); class_ids [N] int32
    (out of range also skipped). Returns decay * hist + this batch's
    per-(class, bucket) counts, the multiply and the add rounded apart.
    With ends (int32 [M], non-decreasing, the last N) it applies the M
    batches [ends[j-1], ends[j]) one after another, each as above."""
    if ends is not None:
        iv = intervals.reshape(-1)
        cls = class_ids.reshape(-1)
        out, start = hist, 0
        for end in ends.tolist():
            out = reference_reuse_sketch(out, iv[start:end],
                                         cls[start:end], tau0=tau0,
                                         decay=decay)
            start = end
        return out
    hist = hist.to(torch.float32)
    C, B = hist.shape
    iv = intervals.to(torch.float32).reshape(-1)
    cls = class_ids.to(torch.int64).reshape(-1)
    valid = (iv > 0) & (cls >= 0) & (cls < C)
    b = bucket_of(iv[valid], tau0, B).to(torch.int64)
    counts = torch.bincount(cls[valid] * B + b, minlength=C * B)
    dec = torch.full((), decay, dtype=torch.float32, device=hist.device)
    out = hist * dec
    return out + counts.to(torch.float32).view(C, B)
