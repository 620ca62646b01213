"""Wrapper of the reuse-sketch kernel (`csrc/reuse_sketch.cu`)."""
from __future__ import annotations

import torch

from .._build import check, library
from .._wrap import on_cuda, stream_of
from .ref import reference_reuse_sketch

# the kernel's per-block histogram lives in the default 48 KiB of shared
# memory: one uint32 cell per (class, bucket)
MAX_CELLS = 48 * 1024 // 4


def reuse_sketch_update(hist: torch.Tensor, intervals: torch.Tensor,
                        class_ids: torch.Tensor, *, tau0: float,
                        decay: float) -> torch.Tensor:
    """Decayed sketch update for one step's batch: hist [C, B] float32,
    intervals [N] float32 (<= 0 slots skipped), class_ids [N] int32
    (slots outside [0, C) skipped) -> the new [C, B] float32. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or
    raises). The batch needs no padding: no width is compiled in."""
    if intervals.numel() != class_ids.numel():
        raise ValueError("intervals and class_ids must match in length")
    if not on_cuda("reuse_sketch", hist, intervals, class_ids):
        return reference_reuse_sketch(hist, intervals, class_ids,
                                      tau0=tau0, decay=decay)
    if hist.dim() != 2 or intervals.dim() != 1 or class_ids.dim() != 1:
        raise ValueError("reuse_sketch: hist [C, B], intervals [N], "
                         "class_ids [N]")
    for name, t, dt in (("hist", hist, torch.float32),
                        ("intervals", intervals, torch.float32),
                        ("class_ids", class_ids, torch.int32)):
        if t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"reuse_sketch: {name} must be contiguous "
                             f"{dt}, got {t.dtype}")
    C, B = hist.shape
    if not 0 < C * B <= MAX_CELLS:
        raise ValueError(f"reuse_sketch: C*B = {C * B} cells; the kernel "
                         f"takes 1 to {MAX_CELLS}")
    out = torch.empty_like(hist)
    counts = torch.empty(C * B, dtype=torch.int32, device=hist.device)
    err = library("reuse_sketch")(
        hist.data_ptr(), intervals.data_ptr(), class_ids.data_ptr(),
        out.data_ptr(), counts.data_ptr(), intervals.numel(), C, B,
        float(tau0), float(decay), stream_of(hist.device))
    check("reuse_sketch", err)
    reuse_sketch_update.launches += 1
    return out


reuse_sketch_update.launches = 0
