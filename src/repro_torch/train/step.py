"""Training step: loss -> grad -> AdamW update, the reference package's
`train/step.py` on one device.

The state is a plain dict {"params", "opt"}: float32 master weights (each
leaf a tensor that requires grad) and the optimizer's {step, mu, nu}. The
forward runs in `TrainConfig.compute_dtype` through the model's kernels
(on a CUDA device: rmsnorm and flash attention forward and backward),
each group recomputed in the backward under the remat policy; gradients
come from `torch.autograd.grad` over the parameter leaves, then
`adamw.apply_updates` updates the state in place.

The reference's `rules` (sharding over a mesh) have no counterpart until
the port shards a model, and its `cost_exact` / `unroll` (the roofline
cost probes) none until the port has a roofline: this step runs on one
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from .._device import resolve_device
from ..models import model as model_lib
from ..models.config import ModelConfig
from ..optim import adamw


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: adamw.AdamWConfig = adamw.AdamWConfig()
    compute_dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    remat_policy: str = "nothing"      # "nothing"|"dots"|"dots_no_batch"
    z_loss: float = 1e-4
    microbatch: int = 0                # >0: grad-accumulate in chunks


def trainable(params):
    """The parameters as leaves autograd differentiates (in place)."""
    for _, leaf in adamw.leaves(params):
        leaf.requires_grad_(True)
    return params


def init_state(cfg: ModelConfig, tcfg: TrainConfig,
               generator: Union[torch.Generator, int, None] = None,
               device=None) -> Dict[str, Any]:
    """Native init (`model.init_params`, float32 master weights) and a
    zero optimizer state, on CUDA unless `device` says otherwise."""
    params = model_lib.init_params(cfg, generator, resolve_device(device),
                                   dtype=torch.float32)
    return {"params": trainable(params),
            "opt": adamw.init_state(params, tcfg.optimizer)}


def state_from_jax(state_tree, cfg: ModelConfig, device=None
                   ) -> Dict[str, Any]:
    """The reference's train state ({"params", "opt": {"step", "mu", "nu"
    (, "err")}} as numpy arrays) as this port's: every leaf float32
    through `model.params_from_jax`, the step an int32 scalar. Runs on
    CUDA unless `device` says otherwise."""
    dev = resolve_device(device)

    def tree(t):
        return model_lib.params_from_jax(t, cfg, device=dev,
                                         dtype=torch.float32)
    opt = state_tree["opt"]
    new_opt = {"step": torch.as_tensor(np.array(opt["step"]),
                                       dtype=torch.int32, device=dev),
               "mu": tree(opt["mu"]), "nu": tree(opt["nu"])}
    if "err" in opt:
        new_opt["err"] = tree(opt["err"])
    return {"params": trainable(tree(state_tree["params"])),
            "opt": new_opt}


def batch_on(batch, device) -> Dict[str, torch.Tensor]:
    """The batch's arrays (numpy or tensors) as tensors on `device`."""
    return {k: torch.as_tensor(np.asarray(v) if isinstance(v, np.ndarray)
                               else v).to(device)
            for k, v in batch.items()}


def loss_fn(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    return model_lib.loss_and_aux(
        params, cfg, batch, compute_dtype=tcfg.compute_dtype,
        remat=tcfg.remat, remat_policy=tcfg.remat_policy,
        z_loss=tcfg.z_loss)


def grads_and_metrics(params, cfg: ModelConfig, batch, tcfg: TrainConfig):
    """(loss, metrics, grads): the gradient of every parameter leaf (zeros
    for a leaf the loss does not reach), in the leaf's dtype."""
    paths, flat = zip(*adamw.leaves(params))
    loss, metrics = loss_fn(params, cfg, batch, tcfg)
    got = torch.autograd.grad(loss, flat, allow_unused=True)
    grads: Dict[str, Any] = {}
    for path, leaf, g in zip(paths, flat, got):
        node = grads
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros_like(leaf) if g is None else g
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def train_step(state, batch, *, cfg: ModelConfig, tcfg: TrainConfig):
    """One step on `batch` ({"tokens" [B,S], and optionally "loss_mask",
    "vision_embeds", "positions", "frames"}; numpy arrays or tensors).
    Returns (state, metrics): the state updated in place, metrics the
    loss's {"ce", "z_loss", "aux", "ppl_proxy"} with "loss", "lr" and
    "grad_norm", float32 scalars on the device."""
    params = state["params"]
    batch = batch_on(batch, next(adamw.leaves(params))[1].device)
    if tcfg.microbatch and tcfg.microbatch < batch["tokens"].shape[0]:
        return _train_step_accum(state, batch, cfg=cfg, tcfg=tcfg)
    loss, metrics, grads = grads_and_metrics(params, cfg, batch, tcfg)
    del batch
    _, new_opt, om = adamw.apply_updates(params, grads, state["opt"],
                                         tcfg.optimizer)
    metrics = dict(metrics, loss=loss, **om)
    return {"params": params, "opt": new_opt}, metrics


def _train_step_accum(state, batch, *, cfg: ModelConfig,
                      tcfg: TrainConfig):
    """Gradient accumulation over microbatches: the gradients summed in
    float32 and divided by their count, the metrics of the last
    microbatch with the mean loss; one optimizer update."""
    params = state["params"]
    B = batch["tokens"].shape[0]
    mb = tcfg.microbatch
    n = B // mb
    assert B % mb == 0, (B, mb)
    gsum: Optional[Dict[str, Any]] = None
    lsum = torch.zeros((), dtype=torch.float32)
    for i in range(n):
        mbatch = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        loss, metrics, g = grads_and_metrics(params, cfg, mbatch, tcfg)
        g = adamw.tree_map(lambda t: t.to(torch.float32), g)
        gsum = g if gsum is None else adamw.tree_map(torch.add, gsum, g)
        lsum = lsum.to(loss.device) + loss
    grads = adamw.tree_map(lambda t: t / n, gsum)
    _, new_opt, om = adamw.apply_updates(params, grads, state["opt"],
                                         tcfg.optimizer)
    metrics = dict(metrics, loss=lsum / n, **om)
    return {"params": params, "opt": new_opt}, metrics
