"""Wrapper of the blocked-cuckoo probe kernel (`csrc/cuckoo_probe.cu`)
and the bucket hash pair both sides use."""
from __future__ import annotations

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_cuckoo_probe

H1_MUL = 0x9E3779B1
H2_MUL = 0x85EBCA77
_U32 = 0xFFFFFFFF


def _mul_u32(k: torch.Tensor, m: int) -> torch.Tensor:
    """(k * m) mod 2^32 for 0 <= k < 2^32, in int64 without overflow: the
    two 16-bit halves of k each give a product below 2^48."""
    lo = (k & 0xFFFF) * m
    hi = (((k >> 16) * m) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_pair(keys: torch.Tensor, n_buckets: int):
    """Two independent 32-bit multiplicative hashes -> bucket ids (int32),
    bit for bit the uint32 arithmetic of the kernel: a key is taken mod
    2^32 first, as numpy's and jax's astype(uint32) do."""
    k = keys.to(torch.int64) & _U32
    h1 = _mul_u32(k, H1_MUL) ^ (k >> 16)
    h2 = _mul_u32(k, H2_MUL) ^ (k >> 13)
    return ((h1 % n_buckets).to(torch.int32),
            (h2 % n_buckets).to(torch.int32))


def cuckoo_probe(keys: torch.Tensor, bucket_keys: torch.Tensor,
                 bucket_vals: torch.Tensor):
    """Batched GET. keys [N] int32 (0 = empty sentinel); table
    bucket_keys/vals [n_buckets, slots] int32 -> (found [N] int32,
    values [N] int32). A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel (or raises)."""
    if not on_cuda("cuckoo_probe", keys, bucket_keys, bucket_vals):
        return reference_cuckoo_probe(
            keys, *hash_pair(keys, bucket_keys.shape[0]), bucket_keys,
            bucket_vals)
    if keys.dim() != 1 or bucket_keys.dim() != 2 \
            or bucket_vals.shape != bucket_keys.shape:
        raise ValueError("cuckoo_probe: keys [N], bucket_keys = bucket_vals "
                         "[n_buckets, slots]")
    for name, t in (("keys", keys), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"cuckoo_probe: {name} must be contiguous "
                             f"int32, got {t.dtype}")
    nb, slots = bucket_keys.shape
    if not 0 < nb < 2**31 or slots < 1:
        raise ValueError(f"cuckoo_probe: bad table shape {(nb, slots)}")
    found = torch.empty_like(keys)
    values = torch.empty_like(keys)
    err = library("cuckoo_probe")(
        keys.data_ptr(), bucket_keys.data_ptr(), bucket_vals.data_ptr(),
        found.data_ptr(), values.data_ptr(), keys.numel(), nb, slots,
        stream_of(keys.device))
    check("cuckoo_probe", err)
    cuckoo_probe.launches += 1
    return found, values


cuckoo_probe.launches = 0
