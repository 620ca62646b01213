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


def reference_rmsnorm_bwd(x, g, scale, eps: float = 1e-6, g_sum=None):
    """The gradient of `reference_rmsnorm(x, scale, eps)` for an output
    gradient g, written out in float32 (the plain version of
    `csrc/rmsnorm_bwd.cu`): with r = rsqrt(mean(x^2) + eps),
    dx = r (g scale) - x r^3 mean(x g scale) and dscale = the sum over
    rows of g x r. g_sum, the gradient of add_rmsnorm's sum output (x
    is then that sum), is added into dx. Returns (dx in x's dtype,
    dscale float32 [D])."""
    xf, gf = x.float(), g.float()
    r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    gs = gf * scale.float()
    dx = r * gs - xf * r ** 3 * torch.mean(xf * gs, dim=-1, keepdim=True)
    if g_sum is not None:
        dx = dx + g_sum.float()
    dscale = (gf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale


def reference_add_rmsnorm_bwd(summed, g, g_sum, scale, eps: float = 1e-6):
    """The gradient of `reference_add_rmsnorm` at its sum output `summed`
    (x + residual): g of the normed output, g_sum of the sum (None when
    the sum was not used). Returns (d, dscale): d is the gradient of both
    x and the residual."""
    return reference_rmsnorm_bwd(summed, g, scale, eps, g_sum)
