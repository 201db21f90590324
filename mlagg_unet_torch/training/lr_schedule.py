"""Learning-rate schedules: functions epoch -> lr, stepped once per epoch.

Counterparts of ``mlagg_unet_tpu/training/lr_schedule.py``:
``poly_lr`` (nnU-Net's PolyLRScheduler, lr0 (1 - e / E)^0.9),
``cosine_warmup_lr`` (timm's CosineLRScheduler as the flagship trainer sets
it up: linear warmup from ``warmup_lr_init`` over ``warmup_epochs``, then a
cosine to ``lr_min`` at ``max_epochs``) and ``constant_lr``
(``mlagg_unet_tpu/training/trainer.py:272-273``). ``epoch_schedule_to_step_schedule``
holds the lr constant within an epoch for a per-step optimizer. The cosine
schedule's arithmetic is fp32 with Python-float constants, as the JAX
package's is.
"""
from __future__ import annotations

import math
from typing import Callable

import torch


def poly_lr(initial_lr: float, max_epochs: int, exponent: float = 0.9) -> Callable:
    def schedule(epoch):
        return initial_lr * (1 - epoch / max_epochs) ** exponent

    return schedule


def cosine_warmup_lr(initial_lr: float, max_epochs: int, lr_min: float = 1e-6,
                     warmup_epochs: int = 10,
                     warmup_lr_init: float = 1e-4) -> Callable:
    def f32(v):
        return torch.tensor(v, dtype=torch.float32)

    def schedule(epoch):
        epoch = f32(epoch)
        if epoch < warmup_epochs:
            slope = (initial_lr - warmup_lr_init) / max(warmup_epochs, 1)
            return float(warmup_lr_init + epoch * slope)
        t = torch.clamp((epoch - warmup_epochs) / max(max_epochs - warmup_epochs, 1),
                        0.0, 1.0)
        return float(lr_min + 0.5 * (initial_lr - lr_min) * (1 + torch.cos(math.pi * t)))

    return schedule


def constant_lr(initial_lr: float) -> Callable:
    def schedule(epoch):
        return initial_lr

    return schedule


def epoch_schedule_to_step_schedule(epoch_schedule: Callable,
                                    steps_per_epoch: int) -> Callable:
    """step -> lr of the step's epoch."""
    def schedule(step):
        return epoch_schedule(step // steps_per_epoch)

    return schedule
