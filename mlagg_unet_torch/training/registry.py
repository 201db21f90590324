"""Trainer registry: named training recipes and their network builders.

Counterpart of ``mlagg_unet_tpu/training/registry.py`` for the flagship
recipe and for every recipe on the plans' U-Net (``plans_unet``, and
``plans_unet_bn`` with BatchNorm). The flagship,
``nnUNetTrainer_MLAgg_2D_dt_MS`` (``registry.py:226-241``): AdamW at lr
5e-4, eps 1e-4, weight decay 3e-5, a cosine schedule with 10 warmup epochs
over 500, gradient clip 12, five fixed deep-supervision scales, bf16
forward on fp32 master weights, DC+CE loss, 250 training and 50 validation
steps per epoch. The default ``nnUNetTrainer``: SGD with Nesterov momentum
0.99 at lr 1e-2, weight decay 3e-5, the poly schedule over 1000 epochs,
gradient clip 12, deep supervision at the plans' scales. Its variants
change the length, the optimizer, the loss, the schedule, the norm, the
augmentation or the sampling, with the JAX entries' values. The other
networks' names wait for later slices (ROADMAP queue A, A16).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence

import numpy as np

from mlagg_unet_torch.device import DeviceLike


@dataclass(frozen=True)
class TrainerConfig:
    """The fields of the JAX package's TrainerConfig (``registry.py:19-47``)
    that the train step, the data pipeline and the epoch loop read."""
    name: str
    num_epochs: int = 1000
    num_iterations_per_epoch: int = 250
    num_val_iterations_per_epoch: int = 50
    initial_lr: float = 1e-2
    weight_decay: float = 3e-5
    # 'sgd' (momentum 0.99, Nesterov) | 'adamw' | 'adan' | 'adamw_amsgrad' | 'adam_l2'
    optimizer: str = "sgd"
    adam_eps: float = 1e-8
    lr_scheduler: str = "poly"        # 'poly' | 'cosine_warmup' | 'constant'
    warmup_epochs: int = 10
    grad_clip_norm: float = 12.0
    oversample_foreground_percent: float = 0.33
    enable_deep_supervision: bool = True
    network: str = "plans_unet"       # key into NETWORK_BUILDERS
    # fixed deep-supervision scales (the flagship's five levels); None takes
    # them from the plans' pooling
    deep_supervision_scales_override: Optional[Sequence[Sequence[float]]] = None
    disable_mirroring: bool = False
    # restrict mirroring to these axes (nnUNetTrainer_onlyMirror01)
    mirror_axes_override: Optional[Sequence[int]] = None
    disable_da: bool = False
    probabilistic_oversampling: bool = False
    benchmark: bool = False           # record the fastest epoch's time to json
    no_data_loading: bool = False     # train on one cached batch (device speed alone)
    # 'default' is DC+CE (DC+BCE for regions) | 'ce' | 'dice' | 'dc_topk' |
    # 'topk10' | 'topk10_ls01'
    loss: str = "default"
    da_level: str = "default"         # 'default' | 'DA5' (heavy augmentation)
    # resampling orders of the spatial augmentation (data, seg)
    order_resampling_data: int = 3
    order_resampling_seg: int = 1
    compute_dtype: str = "bfloat16"   # forward dtype; master params stay fp32


TRAINER_REGISTRY: Dict[str, TrainerConfig] = {}


def register_trainer(cfg: TrainerConfig) -> TrainerConfig:
    TRAINER_REGISTRY[cfg.name] = cfg
    return cfg


def get_trainer_config(name: str) -> TrainerConfig:
    if name not in TRAINER_REGISTRY:
        raise KeyError(f"Unknown trainer {name}. Known: {sorted(TRAINER_REGISTRY)}")
    return TRAINER_REGISTRY[name]


def _build_mlla_uper(image_patch, num_input_channels: int,
                     num_output_channels: int, deep_supervision: bool, *,
                     seed: int = 0, device: DeviceLike = "cuda", **overrides):
    """The flagship build (embed 96, depths 2/2/2/2, heads 2/4/8/16, mlp
    ratio 2, sr 16/8/4/2, drop path 0.1), fp32, seeded, on ``device``.
    ``image_patch`` is the patch size or a ``ConfigurationManager`` (the
    JAX package's form, ``registry.py:80-100``), whose patch size is used."""
    from mlagg_unet_torch.models.mlla_uper import build_flagship

    image_patch = getattr(image_patch, "patch_size", image_patch)
    if len(image_patch) != 2:
        raise ValueError("the MLAgg flagship is a 2D network: give a 2D patch size")
    return build_flagship(num_output_channels, num_input_channels, seed=seed,
                          device=device, deep_supervision=deep_supervision,
                          **overrides)


def _build_plans_unet(configuration_manager, num_input_channels: int,
                      num_output_channels: int, deep_supervision: bool, *,
                      seed: int = 0, device: DeviceLike = "cuda", norm: str = "instance"):
    """The plans' PlainConvUNet (``models/dynamic_unet.py``) of a
    ``ConfigurationManager``, as JAX's builder (``registry.py:68-74``)."""
    from mlagg_unet_torch.models.dynamic_unet import build_plans_unet

    if not hasattr(configuration_manager, "pool_op_kernel_sizes"):
        raise ValueError("the plans U-Net is built from the plans: pass the "
                         "ConfigurationManager, not a patch size")
    return build_plans_unet(configuration_manager, num_input_channels, num_output_channels,
                            deep_supervision, norm=norm, seed=seed, device=device)


def _build_plans_unet_bn(configuration_manager, num_input_channels: int,
                         num_output_channels: int, deep_supervision: bool, **kwargs):
    """The same with BatchNorm (nnUNetTrainerBN, ``registry.py:510-522``)."""
    return _build_plans_unet(configuration_manager, num_input_channels,
                             num_output_channels, deep_supervision, norm="batch", **kwargs)


NETWORK_BUILDERS: Dict[str, Callable] = {"mlla_uper": _build_mlla_uper,
                                         "plans_unet": _build_plans_unet,
                                         "plans_unet_bn": _build_plans_unet_bn}


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


# ---------------------------------------------------------------- the plans' U-Net
# Copies of the JAX entries whose network is plans_unet or plans_unet_bn
# (registry.py:177-603), with their values.
_default = register_trainer(TrainerConfig(name="nnUNetTrainer"))

# training length (variants/training_length/*)
for _ep in (1, 5, 10, 20, 50, 100, 250, 500, 2000, 4000, 8000):
    register_trainer(replace(_default, name=f"nnUNetTrainer_{_ep}epochs", num_epochs=_ep))
register_trainer(replace(_default, name="nnUNetTrainer_1epoch", num_epochs=1))
register_trainer(replace(_default, name="nnUNetTrainer_500e", num_epochs=500))
for _ep in (250, 2000, 4000, 8000):
    register_trainer(replace(_default, name=f"nnUNetTrainer_{_ep}epochs_NoMirroring",
                             num_epochs=_ep, disable_mirroring=True))

register_trainer(replace(_default, name="nnUNetTrainer_Adamw", optimizer="adamw",
                         initial_lr=3e-4))
register_trainer(replace(_default, name="nnUNetTrainerCosAnneal",
                         lr_scheduler="cosine_warmup", warmup_epochs=0))
register_trainer(replace(_default, name="nnUNetTrainerNoDeepSupervision",
                         enable_deep_supervision=False))
register_trainer(replace(_default, name="nnUNetTrainerNoMirroring", disable_mirroring=True))
register_trainer(replace(_default, name="nnUNetTrainerNoDA", disable_da=True,
                         disable_mirroring=True))
register_trainer(replace(_default, name="nnUNetTrainer_onlyMirror01",
                         mirror_axes_override=(0, 1)))

# sampling (variants/sampling/*): -1 is the sentinel for the deterministic
# sampler's effective percent at the batch size
register_trainer(replace(_default, name="nnUNetTrainer_probabilisticOversampling",
                         probabilistic_oversampling=True, oversample_foreground_percent=-1.0))
register_trainer(replace(_default, name="nnUNetTrainer_probabilisticOversampling_033",
                         probabilistic_oversampling=True, oversample_foreground_percent=0.33))
register_trainer(replace(_default, name="nnUNetTrainer_probabilisticOversampling_010",
                         probabilistic_oversampling=True, oversample_foreground_percent=0.1))

# augmentation (variants/data_augmentation/*)
register_trainer(replace(_default, name="nnUNetTrainerDA5", da_level="DA5"))
register_trainer(replace(_default, name="nnUNetTrainerDA5_10epochs", da_level="DA5",
                         num_epochs=10))
register_trainer(replace(_default, name="nnUNetTrainerDA5ord0", da_level="DA5",
                         order_resampling_data=0, order_resampling_seg=0))
register_trainer(replace(_default, name="nnUNetTrainerDA5Segord0", da_level="DA5",
                         order_resampling_data=3, order_resampling_seg=0))
register_trainer(replace(_default, name="nnUNetTrainerDAOrd0", order_resampling_data=0,
                         order_resampling_seg=0))
register_trainer(replace(_default, name="nnUNetTrainer_DASegOrd0", order_resampling_data=3,
                         order_resampling_seg=0))
register_trainer(replace(_default, name="nnUNetTrainer_DASegOrd0_NoMirroring",
                         order_resampling_data=3, order_resampling_seg=0,
                         disable_mirroring=True))

# losses (variants/loss/*)
register_trainer(replace(_default, name="nnUNetTrainerCELoss", loss="ce"))
register_trainer(replace(_default, name="nnUNetTrainerDiceLoss", loss="dice"))
register_trainer(replace(_default, name="nnUNetTrainerDiceCELoss_noSmooth", loss="default"))
register_trainer(replace(_default, name="nnUNetTrainerTopk10Loss", loss="topk10"))
register_trainer(replace(_default, name="nnUNetTrainerTopk10LossLS01", loss="topk10_ls01"))
register_trainer(replace(_default, name="nnUNetTrainerDiceTopK10Loss", loss="dc_topk"))

# benchmarking (variants/benchmarking/nnUNetTrainerBenchmark_5epochs.py:8-66)
register_trainer(replace(_default, name="nnUNetTrainerBenchmark_5epochs", num_epochs=5,
                         benchmark=True))
register_trainer(replace(_default, name="nnUNetTrainerBenchmark_5epochs_noDataLoading",
                         num_epochs=5, benchmark=True, no_data_loading=True))

# BatchNorm instead of InstanceNorm (variants/network_architecture/nnUNetTrainerBN.py)
register_trainer(replace(_default, name="nnUNetTrainerBN", network="plans_unet_bn"))

# optimizers (variants/optimizer/*): Adan; nnUNetTrainerAdam is AdamW with
# amsgrad, nnUNetTrainerVanillaAdam torch's Adam with coupled L2 decay
_adan = register_trainer(replace(_default, name="nnUNetTrainerAdan", optimizer="adan"))
register_trainer(replace(_adan, name="nnUNetTrainerAdan1en3", initial_lr=1e-3))
register_trainer(replace(_adan, name="nnUNetTrainerAdan3en4", initial_lr=3e-4))
register_trainer(replace(_adan, name="nnUNetTrainerAdan1en1", initial_lr=1e-1))
register_trainer(replace(_adan, name="nnUNetTrainerAdanCosAnneal",
                         lr_scheduler="cosine_warmup", warmup_epochs=0))
_adam = register_trainer(replace(_default, name="nnUNetTrainerAdam",
                                 optimizer="adamw_amsgrad"))
register_trainer(replace(_adam, name="nnUNetTrainerAdam1en3", initial_lr=1e-3))
register_trainer(replace(_adam, name="nnUNetTrainerAdam3en4", initial_lr=3e-4))
_vadam = register_trainer(replace(_default, name="nnUNetTrainerVanillaAdam",
                                  optimizer="adam_l2"))
register_trainer(replace(_vadam, name="nnUNetTrainerVanillaAdam1en3", initial_lr=1e-3))
register_trainer(replace(_vadam, name="nnUNetTrainerVanillaAdam3en4", initial_lr=3e-4))
