"""Plain PyTorch version of the blocked-cuckoo bucket probe (the CPU path
and the on-card reference of `csrc/cuckoo_probe.cu`)."""
import torch


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def reference_cuckoo_probe(keys, b1, b2, bucket_keys, bucket_vals):
    """keys [N] int32; b1,b2 [N] bucket ids; bucket_keys/vals
    [n_buckets, slots] int32 -> (found [N] int32, values [N] int32).

    A key found in both buckets takes bucket 1's value; duplicate hits in
    one bucket sum, wrapping in int32 as the kernel's accumulator does."""
    b1, b2 = b1.long(), b2.long()
    hit1 = bucket_keys[b1] == keys[:, None]            # [N, slots]
    hit2 = bucket_keys[b2] == keys[:, None]
    any1 = hit1.any(dim=1)
    any2 = hit2.any(dim=1)
    val1 = torch.where(hit1, bucket_vals[b1].long(), 0).sum(dim=1)
    val2 = torch.where(hit2, bucket_vals[b2].long(), 0).sum(dim=1)
    found = (any1 | any2).to(torch.int32)
    return found, _wrap_int32(torch.where(any1, val1, val2))
