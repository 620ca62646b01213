"""Wrapper of the blocked-cuckoo probe kernel (`csrc/cuckoo_probe.cu`)
and the bucket hash pair both sides use."""
from __future__ import annotations

from typing import Dict

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_cuckoo_probe

H1_MUL = 0x9E3779B1
H2_MUL = 0x85EBCA77
_U32 = 0xFFFFFFFF

# the kernel's constants (csrc/cuckoo_probe.cu)
THREADS = 256             # a block (kProbeThreads)
BLOCKS_PER_SM = 4         # the grid's cap an SM (kProbeBlocksPerSm)
ROW_INTS = 16             # vector path: L * slots (kProbeRowInts)
VECTOR_SLOTS = (4, 8, 16)
H100_SMS = 132


def launch_plan(n: int, slots: int, n_sm: int = H100_SMS,
                aligned: bool = True) -> Dict[str, object]:
    """The kernel's path and grid for a call (`probe_plan` in the source,
    whose header states the rule): threads a block, lookups a thread
    takes from each group (L), blocks, and the path ("vector": 16-byte
    row loads, for slots 4, 8 or 16 with both tables 16-byte aligned and
    row strides a multiple of 4 ints; "scalar" otherwise)."""
    vec = aligned and slots in VECTOR_SLOTS
    lookups = ROW_INTS // slots if vec else 1
    groups = -(-n // (lookups * THREADS))
    return {"threads": THREADS, "lookups": lookups,
            "blocks": min(groups, n_sm * BLOCKS_PER_SM),
            "path": "vector" if vec else "scalar"}


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


def check_args(keys: torch.Tensor, bucket_keys: torch.Tensor,
               bucket_vals: torch.Tensor):
    """What the kernel takes (raises otherwise): keys [N] contiguous,
    bucket_keys and bucket_vals [n_buckets, slots] with unit slot stride,
    all int32. Returns (n_buckets, slots)."""
    if keys.dim() != 1 or bucket_keys.dim() != 2 \
            or bucket_vals.shape != bucket_keys.shape:
        raise ValueError("cuckoo_probe: keys [N], bucket_keys = bucket_vals "
                         "[n_buckets, slots]")
    for name, t in (("keys", keys), ("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if t.dtype != torch.int32:
            raise ValueError(f"cuckoo_probe: {name} must be int32, got "
                             f"{t.dtype}")
    if not keys.is_contiguous():
        raise ValueError("cuckoo_probe: keys must be contiguous")
    nb, slots = bucket_keys.shape
    if not 0 < nb < 2**31 or slots < 1:
        raise ValueError(f"cuckoo_probe: bad table shape {(nb, slots)}")
    for name, t in (("bucket_keys", bucket_keys),
                    ("bucket_vals", bucket_vals)):
        if t.stride(1) != 1 and slots > 1:
            raise ValueError(f"cuckoo_probe: {name} needs unit slot "
                             f"stride, got strides {t.stride()}")
    return nb, slots


def cuckoo_probe(keys: torch.Tensor, bucket_keys: torch.Tensor,
                 bucket_vals: torch.Tensor):
    """Batched GET. keys [N] int32 (0 = empty sentinel); table
    bucket_keys/vals [n_buckets, slots] int32, each contiguous or a view
    of rows with unit slot stride (e.g. the two halves of one
    [n_buckets, 2 * slots] table) -> (found [N] int32, values [N] int32).
    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    if not on_cuda("cuckoo_probe", keys, bucket_keys, bucket_vals):
        return reference_cuckoo_probe(
            keys, *hash_pair(keys, bucket_keys.shape[0]), bucket_keys,
            bucket_vals)
    nb, slots = check_args(keys, bucket_keys, bucket_vals)
    found = torch.empty_like(keys)
    values = torch.empty_like(keys)
    if keys.numel() == 0:
        return found, values
    err = library("cuckoo_probe")(
        keys.data_ptr(), bucket_keys.data_ptr(), bucket_vals.data_ptr(),
        found.data_ptr(), values.data_ptr(), keys.numel(), nb, slots,
        bucket_keys.stride(0), bucket_vals.stride(0),
        stream_of(keys.device))
    check("cuckoo_probe", err)
    cuckoo_probe.launches += 1
    return found, values


cuckoo_probe.launches = 0
