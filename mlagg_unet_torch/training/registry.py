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
augmentation or the sampling, with the JAX entries' values. The model zoo's
names are all registered with the JAX entries' values; the networks of
U-Mamba Bot / Enc (also with SS3D), VM-UNet, Mamba-UNet, Swin-UMamba(-D),
VM-UNet-3D (three forms), MSVM-UNet, SegMamba, LightM-UNet, UltraLight
VM-UNet, nnMamba, LKM-UNet, MedNeXt (B, kernel 3 or 5, and B k3 with its
Mamba skip), SwinUNETR, Swin-TUNet, TransUNet and MLLA-UNet are built: every
network of the JAX registry.
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


def _build_umamba(mode: str):
    def build(configuration_manager, num_input_channels: int, num_output_channels: int,
              deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda"):
        """U-Mamba Bot / Enc of the plans (``registry.py:103-138``), 2-D or 3-D;
        the SS3D modes 3-D only."""
        from mlagg_unet_torch.models.umamba import build_umamba

        if not hasattr(configuration_manager, "pool_op_kernel_sizes"):
            raise ValueError("U-Mamba is built from the plans: pass the "
                             "ConfigurationManager, not a patch size")
        if mode.endswith("_ss3d") and len(configuration_manager.patch_size) != 3:
            raise ValueError(f"U-Mamba {mode} is a 3D network: give a 3D configuration")
        return build_umamba(configuration_manager, num_input_channels, num_output_channels,
                            deep_supervision, mode, seed=seed, device=device)

    return build


def _build_vmunet3d(swin: bool = False, new: bool = False):
    def build(configuration_manager, num_input_channels: int, num_output_channels: int,
              deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
              **overrides):
        """VM-UNet-3D at its reference widths (``registry.py:465-483``):
        ``new`` drops the z gate and encoder5, ``swin`` takes the SwinT
        bottleneck; no deep supervision."""
        from mlagg_unet_torch.models.vmunet3d import build_vmunet3d

        patch = getattr(configuration_manager, "patch_size", configuration_manager)
        if len(patch) != 3:
            raise ValueError("VMUNet3D is a 3D network: give a 3D configuration")
        return build_vmunet3d(num_input_channels, num_output_channels, swin=swin, new=new,
                              seed=seed, device=device, **overrides)

    return build


def _build_2d(module: str, cls_name: str, with_ds: bool):
    def build(configuration_manager, num_input_channels: int, num_output_channels: int,
              deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
              **overrides):
        """A 2-D network of the zoo at its reference defaults (JAX's
        ``_make_simple_builder``, ``registry.py:286-305``), deep supervision
        passed where the network has it; ``overrides`` replace constructor
        arguments."""
        import importlib

        from mlagg_unet_torch.models.vmamba import build_seeded

        patch = getattr(configuration_manager, "patch_size", configuration_manager)
        if len(patch) != 2:
            raise ValueError(f"{cls_name} is a 2D network: give a 2D configuration")
        cls = getattr(importlib.import_module(module), cls_name)
        kwargs = dict(deep_supervision=deep_supervision) if with_ds else {}
        model = cls(num_input_channels, num_output_channels, **{**kwargs, **overrides})
        return build_seeded(model, seed, device)

    return build


def _seeded_variant(cls_name: str, num_input_channels: int, num_output_channels: int,
                    seed: int, device: DeviceLike, **kwargs):
    """A network of ``models/mamba_variants.py``, seeded, fp32, in eval mode
    on ``device``; ``kwargs`` are its constructor's."""
    from mlagg_unet_torch.models import mamba_variants
    from mlagg_unet_torch.models.vmamba import build_seeded

    model = getattr(mamba_variants, cls_name)(num_input_channels, num_output_channels, **kwargs)
    return build_seeded(model, seed, device)


# the networks of mamba_variants.py at their reference defaults, without deep
# supervision (JAX's _make_simple_builder and _build_nnmamba,
# registry.py:289-332); ``overrides`` replace constructor arguments
def _build_segmamba(configuration_manager, num_input_channels: int, num_output_channels: int,
                    deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
                    **overrides):
    """SegMamba, 3-D only: its strides are its own (a (1, 2, 2) stem, then
    2x2x2), not the plans'."""
    if len(getattr(configuration_manager, "patch_size", configuration_manager)) != 3:
        raise ValueError("SegMamba is a 3D network: give a 3D configuration")
    return _seeded_variant("SegMamba", num_input_channels, num_output_channels, seed, device,
                           **overrides)


def _build_lightm_unet(configuration_manager, num_input_channels: int, num_output_channels: int,
                       deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
                       **overrides):
    """LightM-UNet in the patch's dimension."""
    patch = getattr(configuration_manager, "patch_size", configuration_manager)
    return _seeded_variant("LightMUNet", num_input_channels, num_output_channels, seed, device,
                           **{"spatial_dims": len(patch), **overrides})


def _build_ultralight(configuration_manager, num_input_channels: int, num_output_channels: int,
                      deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
                      **overrides):
    """UltraLight VM-UNet: 2-D, and five 2x poolings need a patch divisible
    by 32."""
    patch = tuple(getattr(configuration_manager, "patch_size", configuration_manager))
    if len(patch) != 2 or any(p % 32 for p in patch):
        raise ValueError(f"UltraLightVMUNet is a 2D network whose patch divides by 32: {patch}")
    return _seeded_variant("UltraLightVMUNet", num_input_channels, num_output_channels, seed,
                           device, **overrides)


def _build_nnmamba(configuration_manager, num_input_channels: int, num_output_channels: int,
                   deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
                   **overrides):
    """nnMamba with its four strides from ``pool_op_kernel_sizes[1:5]``,
    padded with ones."""
    if not hasattr(configuration_manager, "pool_op_kernel_sizes"):
        raise ValueError("nnMamba takes its strides from the plans: pass the "
                         "ConfigurationManager, not a patch size")
    strides = [tuple(s) for s in configuration_manager.pool_op_kernel_sizes[1:5]]
    strides += [(1,) * len(configuration_manager.patch_size)] * (4 - len(strides))
    return _seeded_variant("NNMamba", num_input_channels, num_output_channels, seed, device,
                           **{"strides": tuple(strides), **overrides})


def _build_lkm_unet(configuration_manager, num_input_channels: int, num_output_channels: int,
                    deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda"):
    """LKM-UNet of the plans (``registry.py:413-437``), 2-D or 3-D."""
    from mlagg_unet_torch.models.lkm_unet import build_lkm_unet

    if not hasattr(configuration_manager, "pool_op_kernel_sizes"):
        raise ValueError("LKM-UNet is built from the plans: pass the ConfigurationManager, "
                         "not a patch size")
    return build_lkm_unet(configuration_manager, num_input_channels, num_output_channels,
                          deep_supervision, seed=seed, device=device)


def _build_transunet(configuration_manager, num_input_channels: int, num_output_channels: int,
                     deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda",
                     **overrides):
    """TransUNet R50-ViT-B/16 (``registry.py:365-371``), 2-D only; its
    position embedding is built for the patch size, as JAX's init takes it
    from the input."""
    patch = tuple(getattr(configuration_manager, "patch_size", configuration_manager))
    return _build_2d("mlagg_unet_torch.models.transunet", "TransUNet", False)(
        configuration_manager, num_input_channels, num_output_channels, deep_supervision,
        seed=seed, device=device, **{"img_size": patch, **overrides})


def _build_mednext(model_id: str, kernel_size: int, use_mamba_skip: bool = False):
    def build(configuration_manager, num_input_channels: int, num_output_channels: int,
              deep_supervision: bool, *, seed: int = 0, device: DeviceLike = "cuda"):
        """MedNeXt's preset in the patch's dimension (``registry.py:141-165``);
        the Mamba skip 2-D only."""
        from mlagg_unet_torch.models.mednext_net import build_mednext

        return build_mednext(configuration_manager, num_input_channels, num_output_channels,
                             deep_supervision, model_id, kernel_size, use_mamba_skip,
                             seed=seed, device=device)

    return build


NETWORK_BUILDERS: Dict[str, Callable] = {
    "mlla_uper": _build_mlla_uper,
    "plans_unet": _build_plans_unet,
    "plans_unet_bn": _build_plans_unet_bn,
    "umamba_bot": _build_umamba("bot"),
    "umamba_enc": _build_umamba("enc"),
    "vmunet": _build_2d("mlagg_unet_torch.models.vmamba", "VMUNet", False),
    "mamba_unet": _build_2d("mlagg_unet_torch.models.vmamba", "MambaUNet", False),
    "swin_umamba": _build_2d("mlagg_unet_torch.models.swin_umamba", "SwinUMamba", True),
    "swin_umamba_d": _build_2d("mlagg_unet_torch.models.swin_umamba", "SwinUMambaD", True),
    "umamba_bot_ss3d": _build_umamba("bot_ss3d"),
    "umamba_enc_ss3d": _build_umamba("enc_ss3d"),
    "vmunet3d": _build_vmunet3d(),
    "vmunet3d_new": _build_vmunet3d(new=True),
    "vmunet3d_swint": _build_vmunet3d(swin=True, new=True),
    "msvm_unet": _build_2d("mlagg_unet_torch.models.msvm_unet", "MSVMUNet", False),
    "segmamba": _build_segmamba,
    "lightm_unet": _build_lightm_unet,
    "ultralight_vmunet": _build_ultralight,
    "nnmamba": _build_nnmamba,
    "lkm_unet": _build_lkm_unet,
    "mednext_b3": _build_mednext("B", 3),
    "mednext_b5": _build_mednext("B", 5),
    "mednext_b3_mambaskip": _build_mednext("B", 3, use_mamba_skip=True),
    # the transformer baselines (registry.py:243-253, 332-379), 2-D only
    "swin_unetr": _build_2d("mlagg_unet_torch.models.swin_unetr", "SwinUNETR", False),
    "swin_tunet": _build_2d("mlagg_unet_torch.models.more_variants", "SwinTUNet", False),
    "transunet": _build_transunet,
    "mlla_unet": _build_2d("mlagg_unet_torch.models.mlla_unet", "MLLAUNet", False),
}


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


# ---------------------------------------------------------------- the model zoo
# Copies of the JAX entries of the other networks (registry.py:243-580), with
# their values.
register_trainer(replace(
    TRAINER_REGISTRY["nnUNetTrainer_MLAgg_2D_dt_MS"], name="nnUNetTrainer_MLLA_UNet",
    network="mlla_unet", initial_lr=1e-4, adam_eps=1e-8, enable_deep_supervision=False,
    deep_supervision_scales_override=None))
# U-Mamba (variants/mamba/nnUNetTrainerUMamba{Bot,Enc}.py): the default recipe
register_trainer(replace(_default, name="nnUNetTrainerUMambaBot", network="umamba_bot"))
register_trainer(replace(_default, name="nnUNetTrainerUMambaEnc", network="umamba_enc"))
# VM-UNet: AdamW 1e-4 / wd 1e-3, cosine warm-up, 500 epochs, no deep
# supervision (nnUNetTrainer_VMUNet.py:15-28,58-64)
register_trainer(replace(_default, name="nnUNetTrainer_VMUNet", network="vmunet",
                         enable_deep_supervision=False, optimizer="adamw", initial_lr=1e-4,
                         weight_decay=1e-3, lr_scheduler="cosine_warmup", num_epochs=500))
register_trainer(replace(_default, name="nnUNetTrainer_SegMamba", network="segmamba",
                         enable_deep_supervision=False, optimizer="adamw", initial_lr=1e-4,
                         weight_decay=1e-3, lr_scheduler="cosine_warmup", num_epochs=500))
register_trainer(replace(_default, name="nnUNetTrainer_LightMUNet", network="lightm_unet",
                         enable_deep_supervision=False, optimizer="adam_l2", initial_lr=1e-4,
                         weight_decay=1e-5, adam_eps=1e-5))
register_trainer(replace(_default, name="nnUNetTrainer_UltraLightVMUNet",
                         network="ultralight_vmunet", enable_deep_supervision=False,
                         optimizer="adamw", initial_lr=1e-3, weight_decay=1e-2,
                         lr_scheduler="cosine_warmup", num_epochs=500))
register_trainer(replace(_default, name="nnUNetTrainer_nnMamba", network="nnmamba",
                         enable_deep_supervision=False, optimizer="adamw", initial_lr=1e-4,
                         weight_decay=1e-3, lr_scheduler="cosine_warmup", num_epochs=500))
register_trainer(replace(_default, name="nnUNetTrainerTransUNet", network="transunet",
                         enable_deep_supervision=False, optimizer="adamw", initial_lr=1e-4))
# Swin-UMamba(-D) and Mamba-UNet: AdamW at 1e-4 / 1e-3 (registry.py:397-408)
register_trainer(replace(_default, name="nnUNetTrainerSwinUMambaScratch",
                         network="swin_umamba", optimizer="adamw", initial_lr=1e-4))
register_trainer(replace(_default, name="nnUNetTrainerSwinUMambaDScratch",
                         network="swin_umamba_d", optimizer="adamw", initial_lr=1e-4))
register_trainer(replace(_default, name="nnUNetTrainer_SwinTUNet", network="swin_tunet",
                         optimizer="adamw", initial_lr=1e-4, enable_deep_supervision=False))
register_trainer(replace(_default, name="nnUNetTrainer_MambaUNet", network="mamba_unet",
                         optimizer="adamw", initial_lr=1e-3))
register_trainer(replace(_default, name="nnUNetTrainerUMambaBot_SS3D",
                         network="umamba_bot_ss3d"))
register_trainer(replace(_default, name="nnUNetTrainerUMambaEnc_SS3D",
                         network="umamba_enc_ss3d"))
register_trainer(replace(_default, name="nnUNetTrainer_LKM_UNet", network="lkm_unet"))
register_trainer(replace(_default, name="nnUNetTrainer_MSVM_UNet", network="msvm_unet",
                         optimizer="adamw", initial_lr=1e-4, num_epochs=500,
                         lr_scheduler="cosine_warmup", enable_deep_supervision=False))
register_trainer(replace(_default, name="nnUNetTrainerSwinUNETR_2d", network="swin_unetr",
                         enable_deep_supervision=False, optimizer="adamw", initial_lr=1e-4))
register_trainer(replace(_default, name="nnUNetTrainer_MedNeXt", network="mednext_b3",
                         optimizer="adamw", initial_lr=1e-3))
register_trainer(replace(_default, name="nnUNetTrainer_MedNeXt_Mambaskip",
                         network="mednext_b3_mambaskip", optimizer="adamw", initial_lr=1e-3))
_vmunet3d = register_trainer(replace(
    _default, name="nnUNetTrainer_VMUNet3D", network="vmunet3d", optimizer="adamw",
    initial_lr=1e-4, weight_decay=1e-2, lr_scheduler="cosine_warmup", num_epochs=500,
    enable_deep_supervision=False))
register_trainer(replace(_vmunet3d, name="nnUNetTrainer_VMUNet3D_woinit"))
register_trainer(replace(_vmunet3d, name="nnUNetTrainer_VMUNet3D_woinit_new",
                         network="vmunet3d_new"))
register_trainer(replace(_vmunet3d, name="nnUNetTrainer_VMUNet3D_woinit_new_SwinT",
                         network="vmunet3d_swint"))
# names under which the reference also has some of them (registry.py:590-603)
for _alias, _orig in (
    ("nnUNetTrainerLightMUNet", "nnUNetTrainer_LightMUNet"),
    ("nnUNetTrainerMambaUNet", "nnUNetTrainer_MambaUNet"),
    ("nnUNetTrainerSegMamba", "nnUNetTrainer_SegMamba"),
    ("nnUNetTrainerUltraLightVMUNet", "nnUNetTrainer_UltraLightVMUNet"),
    ("nnUNetTrainerVMUNet", "nnUNetTrainer_VMUNet"),
    ("nnUNetTrainernnMamba", "nnUNetTrainer_nnMamba"),
    ("nnUNetTrainer_SwinUNETR_2d", "nnUNetTrainerSwinUNETR_2d"),
    ("nnUNetTrainer_MedNeXt_new", "nnUNetTrainer_MedNeXt"),
):
    register_trainer(replace(TRAINER_REGISTRY[_orig], name=_alias))
