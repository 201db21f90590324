"""The optimizer chain of the flagship recipe: clip by global norm, then
AdamW, as ``optax.chain(clip_by_global_norm(c), adamw(schedule, eps, wd))``
(``mlagg_unet_tpu/training/trainer.py:282-287``).

``clip_by_global_norm_`` takes optax's form: gradients whose global norm
``n`` reaches ``max_norm`` are scaled by ``max_norm / n``, with no epsilon
in the denominator. ``torch.optim.AdamW`` with betas (0.9, 0.999) is optax's
``adamw``: the same bias-corrected moments, ``eps`` outside the square root
and weight decay decoupled, scaled by the learning rate. ``AdamWChain``
sets the lr to ``schedule(count)`` before each step, with optax's count: the
first step uses ``schedule(0)``.
"""
from __future__ import annotations

from typing import Callable, Iterable, List

import torch


@torch.no_grad()
def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``;
    returns the norm before clipping (a 0-d tensor, no host sync)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class AdamWChain:
    """clip_by_global_norm -> AdamW with a per-step learning-rate schedule."""

    def __init__(self, params: Iterable[torch.nn.Parameter], schedule: Callable,
                 clip_norm: float, eps: float, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=schedule(0),
                                     betas=(0.9, 0.999), eps=eps,
                                     weight_decay=weight_decay)

    def step(self) -> torch.Tensor:
        """Clip the parameters' gradients, then one AdamW step; returns the
        global gradient norm before clipping."""
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = clip_by_global_norm_(grads, self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
        return norm

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)
