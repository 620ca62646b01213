"""Plain PyTorch versions of rmsnorm and add_rmsnorm (the CPU path and
the on-card references of `csrc/rmsnorm.cu`)."""
import torch


def reference_rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def reference_add_rmsnorm(x, residual, scale, eps: float = 1e-6):
    s = x + residual
    return reference_rmsnorm(s, scale, eps), s
