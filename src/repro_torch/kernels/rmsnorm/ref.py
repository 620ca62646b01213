"""Plain PyTorch version of rmsnorm (the CPU path and the on-card
reference of `csrc/rmsnorm.cu`)."""
import torch


def reference_rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
