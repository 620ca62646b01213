"""Wrapper of the reuse-sketch kernel (`csrc/reuse_sketch.cu`)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_reuse_sketch

# the large path's per-block histogram lives in the default 48 KiB of
# shared memory: one uint32 cell per (class, bucket) (kMaxCells)
MAX_CELLS = 48 * 1024 // 4
# the most slots the one-block small path takes (kSmallMaxSlots), 4 a
# thread; above it a call is one segment on the large path. On the H100
# the small path at this size is still faster than the large path one slot
# above it, whose ticket's round trips cost a fixed time (PERF.md).
SMALL_MAX_SLOTS = 4096

# per (device index, stream): the large path's counts [MAX_CELLS] and its
# ticket, uint32. Zeroed once; every call leaves them at 0 again.
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def small_path(n: int) -> bool:
    """The kernel's path rule (`sketch_small_path` in the source): a batch
    of n slots in any number of segments takes the one-block small path
    when n <= SMALL_MAX_SLOTS; a larger one is one segment on the large
    path."""
    return n <= SMALL_MAX_SLOTS


def _scratch(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _SCRATCH.get(key)
    if buf is None:
        buf = _SCRATCH[key] = torch.zeros(MAX_CELLS + 1, dtype=torch.int32,
                                          device=device)
    return buf


def _check_ends(ends: torch.Tensor, n: int) -> None:
    e = ends.tolist()
    if e[0] < 0 or e[-1] != n or any(b < a for a, b in zip(e, e[1:])):
        raise ValueError(f"reuse_sketch: ends must be non-decreasing from "
                         f">= 0 to N = {n}")


def reuse_sketch_update(hist: torch.Tensor, intervals: torch.Tensor,
                        class_ids: torch.Tensor, *, tau0: float,
                        decay: float,
                        ends: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decayed sketch update for M batches in order: hist [C, B] float32,
    intervals [N] float32 (<= 0 slots skipped), class_ids [N] int32
    (slots outside [0, C) skipped), ends int32 [M] the batches' segment
    ends over the slots (non-decreasing, the last N; None: one batch of all
    N) -> the [C, B] float32 after hist <- decay * hist + counts(segment j)
    for j = 0 .. M-1. An empty segment decays the sketch only. More than
    one segment needs N <= SMALL_MAX_SLOTS.

    A CPU tensor takes the plain version (and its ends are checked); a
    CUDA tensor launches the kernel once (or raises). On the card the
    ends are not read back to be checked: both paths clamp each end into
    [0, N] and count only the slots before the last one, so ends that
    stop short of N count the same slots on either path, and bad ends give
    a wrong sketch but read nothing outside the batch. The batch needs no
    padding: no width is compiled in."""
    n = intervals.numel()
    if n != class_ids.numel():
        raise ValueError("intervals and class_ids must match in length")
    tensors = (hist, intervals, class_ids)
    m = 1
    if ends is not None:
        m = ends.numel()
        if ends.dim() != 1 or m == 0:
            raise ValueError("reuse_sketch: ends must be [M], M >= 1")
        if m > 1 and not small_path(n):
            raise ValueError(f"reuse_sketch: {m} segments of {n} slots; "
                             f"more than one segment takes at most "
                             f"{SMALL_MAX_SLOTS} slots")
        tensors += (ends,)
    if not on_cuda("reuse_sketch", *tensors):
        if ends is not None:
            _check_ends(ends, n)
        return reference_reuse_sketch(hist, intervals, class_ids,
                                      tau0=tau0, decay=decay, ends=ends)
    if hist.dim() != 2 or intervals.dim() != 1 or class_ids.dim() != 1:
        raise ValueError("reuse_sketch: hist [C, B], intervals [N], "
                         "class_ids [N]")
    for name, t, dt in (("hist", hist, torch.float32),
                        ("intervals", intervals, torch.float32),
                        ("class_ids", class_ids, torch.int32),
                        ("ends", ends, torch.int32)):
        if t is not None and (t.dtype != dt or not t.is_contiguous()):
            raise ValueError(f"reuse_sketch: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    C, B = hist.shape
    if not 0 < C * B <= MAX_CELLS:
        raise ValueError(f"reuse_sketch: C*B = {C * B} cells; the kernel "
                         f"takes 1 to {MAX_CELLS}")
    stream = stream_of(hist.device)
    out = torch.empty_like(hist)
    err = library("reuse_sketch")(
        hist.data_ptr(), intervals.data_ptr(), class_ids.data_ptr(),
        0 if ends is None else ends.data_ptr(), out.data_ptr(),
        _scratch(hist.device, stream).data_ptr(), n, m, C, B, float(tau0),
        float(decay), stream)
    check("reuse_sketch", err)
    reuse_sketch_update.launches += 1
    return out


reuse_sketch_update.launches = 0
