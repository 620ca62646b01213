"""Wrappers of the RMSNorm kernel (`csrc/rmsnorm.cu`): arbitrary leading
dims, x float32 or bfloat16, scale float32, output in x's dtype.

`rmsnorm` is the TPU kernel's function. `add_rmsnorm` puts the residual
add in front of it in the same launch (the model's stack adds each
sublayer's output inside the next sublayer's norm); its launches count
under `rmsnorm.launches`, since both run the one kernel source."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import reference_add_rmsnorm, reference_rmsnorm

# the kernel's constants (csrc/rmsnorm.cu)
VEC_BYTES = 16            # one chunk: 8 bf16 or 4 f32 (kRmsVecBytes)
MAX_THREADS = 1024        # kRmsMaxThreads
BLOCK_THREADS = 512       # rows share a block up to (kRmsBlockThreads)
MAX_ROW_BYTES = 32768     # D * itemsize (kRmsMaxRowBytes)
H100_SMS = 132


def launch_plan(rows: int, d: int, itemsize: int, aligned: bool = True,
                n_sm: int = H100_SMS) -> Dict[str, object]:
    """The kernel's path and shape for a call (`rmsnorm_plan` in the
    source, whose header states the rule): threads a row, chunks a thread
    holds, rows a block, blocks, and the path ("vector": 16-byte loads;
    "scalar": D % (16 / itemsize) != 0 or a pointer not 16-byte
    aligned)."""
    vec = VEC_BYTES // itemsize
    chunks = -(-d // vec)
    if chunks <= 32:
        row_threads = 1 << (chunks - 1).bit_length()
    else:
        row_threads = min(MAX_THREADS, -(-chunks // 32) * 32)
    r = 1
    while r * row_threads < 32:
        r *= 2
    while 2 * r * row_threads <= BLOCK_THREADS and 2 * r * n_sm <= rows:
        r *= 2
    return {"row_threads": row_threads,
            "chunks": -(-chunks // row_threads), "rows": r,
            "blocks": -(-rows // r),
            "path": "vector" if aligned and d % vec == 0 else "scalar"}


def check_args(name: str, x: torch.Tensor, res: Optional[torch.Tensor],
               scale: torch.Tensor) -> int:
    """What the kernel takes (raises otherwise); returns the dtype code."""
    code = dtype_code(name, x) if res is None else dtype_code(name, x, res)
    D = x.shape[-1]
    if scale.dtype != torch.float32 or scale.shape != (D,):
        raise ValueError(f"{name}: scale must be float32 [{D}], got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if res is not None and res.shape != x.shape:
        raise ValueError(f"{name}: residual {tuple(res.shape)} is not x's "
                         f"{tuple(x.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and (res is None or res.is_contiguous())):
        raise ValueError(f"{name}: x, residual and scale must be "
                         f"contiguous")
    if D * x.element_size() > MAX_ROW_BYTES:
        raise ValueError(f"{name}: a row of {D} x {x.dtype} is over the "
                         f"kernel's {MAX_ROW_BYTES} bytes")
    return code


def _launch(name: str, x: torch.Tensor, res: Optional[torch.Tensor],
            scale: torch.Tensor, eps: float):
    code = check_args(name, x, res, scale)
    out = torch.empty_like(x)
    summed = None if res is None else torch.empty_like(x)
    if x.numel() == 0:
        return out, summed
    D = x.shape[-1]
    err = library("rmsnorm")(
        x.data_ptr(), None if res is None else res.data_ptr(),
        scale.data_ptr(), out.data_ptr(),
        None if summed is None else summed.data_ptr(), x.numel() // D, D,
        float(eps), code, stream_of(x.device))
    check(name, err)
    rmsnorm.launches += 1
    return out, summed


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D]; scale [D] -> [..., D]. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if not on_cuda("rmsnorm", x, scale):
        return reference_rmsnorm(x, scale, eps)
    return _launch("rmsnorm", x, None, scale, eps)[0]


def add_rmsnorm(x: torch.Tensor, residual: torch.Tensor,
                scale: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rmsnorm(x + residual), x + residual), the sum in x's dtype; one
    launch on a CUDA tensor, whose normed output equals
    rmsnorm(x + residual) bit for bit. A CPU tensor takes the plain
    version."""
    if not on_cuda("add_rmsnorm", x, residual, scale):
        return reference_add_rmsnorm(x, residual, scale, eps)
    return _launch("add_rmsnorm", x, residual, scale, eps)


rmsnorm.launches = 0
