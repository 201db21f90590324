"""The plans-driven plain-conv U-Net, channels-last, 2-D and 3-D.

Counterpart of ``mlagg_unet_tpu/models/dynamic_unet.py``, the default nnU-Net
v2 network (dynamic_network_architectures' ``PlainConvUNet``): per-stage
conv stacks (conv -> InstanceNorm or BatchNorm -> LeakyReLU 0.01) with the
plans' kernel sizes and anisotropic strides, transposed-conv upsampling
with kernel = stride, skip concatenation after the upsampled features, and
a 1x1 segmentation head per decoder stage under deep supervision, the
outputs highest resolution first. ``BasicBlockD`` and
``StackedResidualBlocks`` are the residual blocks of the same file.

Submodules carry the flax scope names (``encoder_stage{s}.conv{i}.conv``,
``.norm``, ``decoder_transp{d}``, ``decoder_stage{d}``, ``seg_head{d}``),
so ``weights.jax_params_to_state_dict`` only changes layouts. BatchNorm's
running statistics are the buffers ``mean`` and ``var`` of each ``norm``
(flax's ``batch_stats``). InstanceNorm takes its variance in two passes,
where flax's GroupNorm takes ``E[x^2] - E[x]^2``: the same function with
half the fp32 temporaries (``layers.InstanceNorm``). Training mode is the module's ``training`` flag:
BatchNorm normalises by the batch and updates its buffers there, by the
buffers in ``eval()``. No layer draws random numbers: the forward takes the
trainer's ``generator`` and ignores it.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTransposeTorch,
    InstanceNorm,
    init_parameters,
)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def _norm(norm: str, channels: int) -> nn.Module:
    if norm == "batch":   # torch momentum 0.1 == flax momentum 0.9
        return BatchNorm(channels, eps=1e-5, momentum=0.9)
    if norm == "instance":   # the two-pass variance: see layers.InstanceNorm
        return InstanceNorm(channels, two_pass=True)
    raise ValueError(f"norm {norm!r}: 'instance' or 'batch'")


class ConvNorm(nn.Module):
    """conv -> norm, no activation (the second half of a residual block)."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int], norm: str = "instance", use_bias: bool = True):
        super().__init__()
        self.conv = Conv(in_channels, features, list(kernel_size), list(strides),
                         bias=use_bias)
        self.norm = _norm(norm, features)

    def forward(self, x):
        return self.norm(self.conv(x))


class ConvNormAct(ConvNorm):
    """conv -> norm -> LeakyReLU 0.01."""

    def forward(self, x):
        return lrelu(self.norm(self.conv(x)))


class StackedConvBlocks(nn.Module):
    """``num_convs`` ConvNormAct (``conv{i}``); the first one strides."""

    def __init__(self, num_convs: int, in_channels: int, features: int,
                 kernel_size: Sequence[int], first_stride: Sequence[int],
                 norm: str = "instance"):
        super().__init__()
        ones = [1] * len(kernel_size)
        for i in range(num_convs):
            self.add_module(f"conv{i}", ConvNormAct(
                in_channels if i == 0 else features, features, kernel_size,
                first_stride if i == 0 else ones, norm))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class TransposedConvND(ConvTransposeTorch):
    """Transposed conv with kernel = stride, the nnU-Net upsampling: output
    size = input x stride. JAX's ``TransposedConvND`` flips its kernel as
    ``conv_transpose`` does, so the weights carry over unchanged."""

    def __init__(self, in_channels: int, features: int, strides: Sequence[int]):
        super().__init__(in_channels, features, list(strides), list(strides))


class BasicBlockD(nn.Module):
    """nnU-Net's residual basic block: conv-norm-act (``conv1``) ->
    conv-norm (``conv2``), a 1x1 conv + norm without bias (``skip``) where
    the stride or the width changes, LeakyReLU after the sum."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int], norm: str = "instance"):
        super().__init__()
        ones = [1] * len(kernel_size)
        self.conv1 = ConvNormAct(in_channels, features, kernel_size, strides, norm)
        self.conv2 = ConvNorm(features, features, kernel_size, ones, norm)
        self.skip = (ConvNorm(in_channels, features, ones, strides, norm, use_bias=False)
                     if in_channels != features or any(s != 1 for s in strides) else None)

    def forward(self, x):
        h = self.conv2(self.conv1(x))
        return lrelu(h + (x if self.skip is None else self.skip(x)))


class StackedResidualBlocks(nn.Module):
    """``n_blocks`` BasicBlockD (``block{i}``); the first may stride and
    change the width."""

    def __init__(self, n_blocks: int, in_channels: int, features: int,
                 kernel_size: Sequence[int], first_stride: Sequence[int],
                 norm: str = "instance"):
        super().__init__()
        ones = [1] * len(kernel_size)
        for i in range(n_blocks):
            self.add_module(f"block{i}", BasicBlockD(
                in_channels if i == 0 else features, features, kernel_size,
                first_stride if i == 0 else ones, norm))

    def forward(self, x):
        for block in self.children():
            x = block(x)
        return x


class PlainConvUNet(nn.Module):
    """The plans' U-Net on (B, *spatial, C) input. Returns the logits of the
    last decoder stage, or under deep supervision every stage's, highest
    resolution first."""

    def __init__(self, in_channels: int, num_classes: int, n_stages: int,
                 features_per_stage: Sequence[int],
                 conv_kernel_sizes: Sequence[Sequence[int]],
                 pool_op_kernel_sizes: Sequence[Sequence[int]],
                 n_conv_per_stage_encoder: Sequence[int],
                 n_conv_per_stage_decoder: Sequence[int],
                 deep_supervision: bool = True, norm: str = "instance"):
        super().__init__()
        self.n_stages = n_stages
        self.deep_supervision = deep_supervision
        cin = in_channels
        for s in range(n_stages):
            self.add_module(f"encoder_stage{s}", StackedConvBlocks(
                n_conv_per_stage_encoder[s], cin, features_per_stage[s],
                conv_kernel_sizes[s], pool_op_kernel_sizes[s], norm))
            cin = features_per_stage[s]
        for d in range(n_stages - 1):
            skip = n_stages - 2 - d
            width = features_per_stage[skip]
            self.add_module(f"decoder_transp{d}", TransposedConvND(
                cin, width, pool_op_kernel_sizes[skip + 1]))
            self.add_module(f"decoder_stage{d}", StackedConvBlocks(
                n_conv_per_stage_decoder[d], 2 * width, width, conv_kernel_sizes[skip],
                [1] * len(conv_kernel_sizes[skip]), norm))
            if deep_supervision or d == n_stages - 2:
                self.add_module(f"seg_head{d}", Conv(
                    width, num_classes, [1] * len(conv_kernel_sizes[skip])))
            cin = width

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        skips = []
        for s in range(self.n_stages):
            x = getattr(self, f"encoder_stage{s}")(x)
            skips.append(x)
        outputs = []
        for d in range(self.n_stages - 1):
            x = getattr(self, f"decoder_transp{d}")(x)
            x = torch.cat([x, skips[self.n_stages - 2 - d]], dim=-1)
            x = getattr(self, f"decoder_stage{d}")(x)
            if self.deep_supervision or d == self.n_stages - 2:
                outputs.append(getattr(self, f"seg_head{d}")(x))
        if not self.deep_supervision:
            return outputs[-1]
        return outputs[::-1]   # highest resolution first (nnU-Net's target order)


def network_from_plans(configuration_manager, num_input_channels: int,
                       num_output_channels: int, deep_supervision: bool = True,
                       norm: str = "instance") -> PlainConvUNet:
    """The U-Net of a ``ConfigurationManager``: widths min(base * 2^s, max)."""
    cm = configuration_manager
    n_stages = len(cm.pool_op_kernel_sizes)
    features = [min(cm.UNet_base_num_features * 2 ** i, cm.unet_max_num_features)
                for i in range(n_stages)]
    return PlainConvUNet(
        num_input_channels, num_output_channels, n_stages, features,
        cm.conv_kernel_sizes, cm.pool_op_kernel_sizes, cm.n_conv_per_stage_encoder,
        cm.n_conv_per_stage_decoder, deep_supervision, norm)


def build_plans_unet(configuration_manager, num_input_channels: int,
                     num_output_channels: int, deep_supervision: bool = True, *,
                     norm: str = "instance", seed: int = 0,
                     device: DeviceLike = "cuda") -> PlainConvUNet:
    """``network_from_plans`` with the JAX package's init distributions drawn
    from ``torch.Generator().manual_seed(seed)``, fp32, in eval mode on
    ``device`` (the GPU unless the caller passes another; raises without
    one). A trainer sets ``.train()``.

    The conv kernels are stored channels-last (``torch.channels_last_3d``,
    or ``torch.channels_last`` in 2-D). cuDNN then convolves in that layout
    whatever the input's channel count, so every conv answers channels-last
    and the (B, *spatial, C) activations stay contiguous: the permutes
    around each conv are views. Casts and copies of the parameters keep the
    layout; the values are the same."""
    dev = resolve_device(device)
    model = network_from_plans(configuration_manager, num_input_channels,
                               num_output_channels, deep_supervision, norm)
    init_parameters(model, torch.Generator().manual_seed(seed))
    dim = len(configuration_manager.conv_kernel_sizes[0])
    layout = torch.channels_last_3d if dim == 3 else torch.channels_last
    return model.to(dev, memory_format=layout).eval()
