"""Wrappers of the RMSNorm kernel (`csrc/rmsnorm.cu`): arbitrary leading
dims, x float32 or bfloat16, scale float32, output in x's dtype.

`rmsnorm` is the TPU kernel's function. `add_rmsnorm` puts the residual
add in front of it in the same launch (the model's stack adds each
sublayer's output inside the next sublayer's norm); its launches count
under `rmsnorm.launches`, since both run the one kernel source.

When grad is enabled and an input requires grad, both go through a
`torch.autograd.Function` whose forward is the same launch and whose
backward launches `rmsnorm_bwd` (`csrc/rmsnorm_bwd.cu`); otherwise they
launch the forward alone, as serving does."""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from .._build import check, library
from .._wrap import dtype_code, on_cuda, stream_of
from .ref import (reference_add_rmsnorm, reference_rmsnorm,
                  reference_rmsnorm_bwd)

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


def _wants_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad
                                           for t in tensors)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D]; scale [D] -> [..., D]. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises)."""
    if not on_cuda("rmsnorm", x, scale):
        return reference_rmsnorm(x, scale, eps)
    if _wants_grad(x, scale):
        return _RmsNorm.apply(x, scale, eps)
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
    if _wants_grad(x, residual, scale):
        return _AddRmsNorm.apply(x, residual, scale, eps)
    return _launch("add_rmsnorm", x, residual, scale, eps)


class _RmsNorm(torch.autograd.Function):
    """rmsnorm's launch, with `rmsnorm_bwd`'s as its gradient; saves x."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        out = _launch("rmsnorm", x, None, scale, eps)[0]
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = _launch_bwd(x, g, None, scale, ctx.eps)
        return dx, dscale, None


class _AddRmsNorm(torch.autograd.Function):
    """add_rmsnorm's launch, with `rmsnorm_bwd`'s as its gradient: one
    gradient for x and the residual. Saves the sum."""

    @staticmethod
    def forward(ctx, x, residual, scale, eps):
        out, summed = _launch("add_rmsnorm", x, residual, scale, eps)
        ctx.save_for_backward(summed, scale)
        ctx.eps = eps
        # an output nobody read has no gradient (not a tensor of zeros)
        ctx.set_materialize_grads(False)
        return out, summed

    @staticmethod
    def backward(ctx, g, g_sum):
        summed, scale = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(summed)
        d, dscale = _launch_bwd(summed, g, g_sum, scale, ctx.eps)
        return d, d, dscale, None


def rmsnorm_bwd(x: torch.Tensor, g: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6,
                g_sum: Optional[torch.Tensor] = None):
    """(dx, dscale) of `rmsnorm(x, scale, eps)` for the output gradient g;
    with g_sum, of `add_rmsnorm` at its sum output x, dx then the gradient
    of both the input and the residual. dx in x's dtype, dscale float32
    [D]. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises)."""
    extra = () if g_sum is None else (g_sum,)
    if not on_cuda("rmsnorm_bwd", x, g, scale, *extra):
        return reference_rmsnorm_bwd(x, g, scale, eps, g_sum)
    return _launch_bwd(x, g, g_sum, scale, eps)


def _launch_bwd(x, g, g_sum, scale, eps: float):
    """The backward kernel's two launches on CUDA tensors (g and g_sum
    copied where they are not contiguous)."""
    g = g.contiguous()
    if g_sum is not None:
        g_sum = g_sum.contiguous()
    code = check_args("rmsnorm_bwd", x, g_sum, scale)
    if g.shape != x.shape or g.dtype != x.dtype or (
            g_sum is not None and g_sum.dtype != x.dtype):
        raise ValueError(f"rmsnorm_bwd: gradient {g.dtype} "
                         f"{tuple(g.shape)} is not x's {x.dtype} "
                         f"{tuple(x.shape)}")
    D = x.shape[-1]
    rows = x.numel() // D
    dx = torch.empty_like(x)
    dscale = torch.zeros(D, dtype=torch.float32, device=x.device)
    if rows == 0:
        return dx, dscale
    partial = torch.empty((min(rows, 2 * _sm_count(x.device)), D),
                          dtype=torch.float32, device=x.device)
    err = library("rmsnorm_bwd")(
        x.data_ptr(), g.data_ptr(),
        None if g_sum is None else g_sum.data_ptr(), scale.data_ptr(),
        dx.data_ptr(), dscale.data_ptr(), partial.data_ptr(),
        partial.numel(), rows, D, float(eps), code, stream_of(x.device))
    check("rmsnorm_bwd", err)
    rmsnorm_bwd.launches += 1
    return dx, dscale


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
