"""Trainer registry: named training recipes and their network builders.

Counterpart of ``mlagg_unet_tpu/training/registry.py`` for the flagship
recipe alone, ``nnUNetTrainer_MLAgg_2D_dt_MS`` (``registry.py:226-241``):
AdamW at lr 5e-4, eps 1e-4, weight decay 3e-5, a cosine schedule with 10
warmup epochs over 500, gradient clip 12, five fixed deep-supervision
scales, bf16 forward on fp32 master weights, DC+CE loss. The other trainer
names wait for later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from mlagg_unet_torch.device import DeviceLike


@dataclass(frozen=True)
class TrainerConfig:
    """The fields of the JAX package's TrainerConfig that the train step
    reads; those of the data pipeline (sampling, augmentation, mirroring)
    come with that slice."""
    name: str
    num_epochs: int = 1000
    num_iterations_per_epoch: int = 250
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    optimizer: str = "sgd"            # 'sgd' | 'adamw' | 'adan'
    adam_eps: float = 1e-8
    lr_scheduler: str = "poly"        # 'poly' | 'cosine_warmup'
    warmup_epochs: int = 10
    grad_clip_norm: float = 12.0
    enable_deep_supervision: bool = True
    network: str = "plans_unet"       # key into NETWORK_BUILDERS
    # fixed deep-supervision scales (the flagship's five levels)
    deep_supervision_scales_override: Optional[Sequence[Sequence[float]]] = None
    loss: str = "default"             # 'default' is DC+CE
    compute_dtype: str = "bfloat16"   # forward dtype; master params stay fp32


TRAINER_REGISTRY: Dict[str, TrainerConfig] = {}


def register_trainer(cfg: TrainerConfig) -> TrainerConfig:
    TRAINER_REGISTRY[cfg.name] = cfg
    return cfg


def get_trainer_config(name: str) -> TrainerConfig:
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"Unknown trainer {name}. Known: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]


def _build_mlla_uper(image_patch: Sequence[int], num_input_channels: int,
                     num_output_channels: int, deep_supervision: bool, *,
                     seed: int = 0, device: DeviceLike = "cuda", **overrides):
    """The flagship build (embed 96, depths 2/2/2/2, heads 2/4/8/16, mlp
    ratio 2, sr 16/8/4/2, drop path 0.1), fp32, seeded, on ``device``."""
    from mlagg_unet_torch.models.mlla_uper import build_flagship

    if len(image_patch) != 2:
        raise ValueError("the MLAgg flagship is a 2D network: give a 2D patch size")
    return build_flagship(num_output_channels, num_input_channels, seed=seed,
                          device=device, deep_supervision=deep_supervision,
                          **overrides)


NETWORK_BUILDERS: Dict[str, Callable] = {"mlla_uper": _build_mlla_uper}


def get_network_builder(key: str) -> Callable:
    if key not in NETWORK_BUILDERS:
        raise KeyError(f"network {key!r} is not ported yet; ported: {sorted(NETWORK_BUILDERS)}")
    return NETWORK_BUILDERS[key]


# the flagship (nnUNetTrainer_MLAgg_2D_dt_MS.py:42-147): five fixed levels
# 1, 1/2, 1/4, 1/8, 1/16
_FLAGSHIP_DS_SCALES = [
    list(s) for s in (1 / np.cumprod(
        np.vstack([[1, 1], [2, 2], [2, 2], [2, 2], [2, 2]]), axis=0))
]
register_trainer(TrainerConfig(
    name="nnUNetTrainer_MLAgg_2D_dt_MS",
    num_epochs=500,
    initial_lr=5e-4,
    weight_decay=3e-5,
    optimizer="adamw",
    adam_eps=1e-4,
    lr_scheduler="cosine_warmup",
    warmup_epochs=10,
    network="mlla_uper",
    deep_supervision_scales_override=_FLAGSHIP_DS_SCALES,
))
