"""Optimizer: Adam with L2 weight decay after a global-norm gradient clip.

The JAX package chains optax's clip_by_global_norm(gradient_clip_val),
add_decayed_weights(weight_decay), scale_by_adam(0.9, 0.999, eps=1e-8) and
scale(-lr). torch.optim.Adam with ``weight_decay`` adds wd * param to the
raw gradient before the moments (L2, not AdamW), so the clip then Adam is
the same chain. The clip is optax's formula, written out: every gradient
times max/norm when the global norm is at least max (torch's
clip_grad_norm_ divides by norm + 1e-6 instead). A parameter the loss does
not reach (the unused time embeddings) gets a zero gradient, as JAX's grad
gives it, so weight decay still moves it as optax does.
"""

from __future__ import annotations

from typing import List

import torch

from temp_tpu_torch.config import TKGConfig


def param_leaves(params) -> List[torch.Tensor]:
    """The tensors of a nested dict/list parameter tree, in a fixed order
    (insertion order of the tree)."""
    if isinstance(params, dict):
        return [t for v in params.values() for t in param_leaves(v)]
    if isinstance(params, (list, tuple)):
        return [t for v in params for t in param_leaves(v)]
    return [params]


def make_optimizer(cfg: TKGConfig, params) -> torch.optim.Adam:
    return torch.optim.Adam(param_leaves(params), lr=cfg.lr,
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=cfg.weight_decay)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: each gradient becomes
    (g / norm) * max_norm when the global norm is not below max_norm. The
    choice stays on the device (no host synchronisation)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))


def clip_and_step(optimizer: torch.optim.Optimizer, cfg: TKGConfig) -> None:
    """Clip the gradients of every parameter to the global norm
    ``gradient_clip_val``, then take one optimizer step."""
    leaves = [p for g in optimizer.param_groups for p in g["params"]]
    for p in leaves:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    clip_by_global_norm([p.grad for p in leaves], cfg.gradient_clip_val)
    optimizer.step()
