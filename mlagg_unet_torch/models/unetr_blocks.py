"""UNETR residual conv blocks, 2D NHWC.

Counterparts of ``UnetResBlock``, ``UnetrBasicBlock`` and ``UnetrUpBlock``
in ``mlagg_unet_tpu/models/unetr_blocks.py``. With ``fused_instance_norm``
(``None``: the JAX package's ``MLAGG_FUSED_IN == "1"``, read at construction)
each InstanceNorm + LeakyReLU (+ residual) chain runs through
``ops.fused_norm.fused_instance_norm`` (kernels K7 and K8 on the GPU), as
``unetr_blocks.py:79-96`` does; the parameters keep their names either way.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import Conv, ConvTransposeTorch, InstanceNorm
from mlagg_unet_torch.ops.fused_norm import fused_instance_norm, fused_norms_enabled


def lrelu(x):
    return F.leaky_relu(x, 0.01)


class UnetResBlock(nn.Module):
    """conv(k, s) -> IN -> lrelu -> conv(k) -> IN [+ 1x1 conv / IN residual]
    -> lrelu."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 fused_instance_norm: Optional[bool] = None):
        super().__init__()
        self.has_proj = in_channels != out_channels or stride != 1
        self.fused = fused_norms_enabled(fused_instance_norm)
        self.conv1 = Conv(in_channels, out_channels, kernel_size, stride)
        self.norm1 = InstanceNorm(out_channels)
        self.conv2 = Conv(out_channels, out_channels, kernel_size)
        self.norm2 = InstanceNorm(out_channels)
        if self.has_proj:
            self.conv3 = Conv(in_channels, out_channels, 1, stride)
            self.norm3 = InstanceNorm(out_channels)

    def forward(self, x):
        if not self.fused:
            out = self.norm2(self.conv2(lrelu(self.norm1(self.conv1(x)))))
            residual = self.norm3(self.conv3(x)) if self.has_proj else x
            return lrelu(out + residual)
        n1, n2 = self.norm1.GroupNorm_0, self.norm2.GroupNorm_0
        out = fused_instance_norm(self.conv1(x), n1.weight, n1.bias, act=True)
        out = self.conv2(out)
        if self.has_proj:
            n3 = self.norm3.GroupNorm_0
            return fused_instance_norm(out, n2.weight, n2.bias, act=True,
                                       residual=self.conv3(x),
                                       res_scale=n3.weight, res_bias=n3.bias)
        return fused_instance_norm(out, n2.weight, n2.bias, act=True, residual=x)


class UnetrBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 fused_instance_norm: Optional[bool] = None):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, kernel_size, stride,
                                  fused_instance_norm)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """transposed conv (k = s = upsample_kernel_size) -> concat skip ->
    UnetResBlock."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int,
                 kernel_size: int = 3, upsample_kernel_size: int = 2,
                 fused_instance_norm: Optional[bool] = None):
        super().__init__()
        self.transp_conv = ConvTransposeTorch(
            in_channels, out_channels, upsample_kernel_size,
            upsample_kernel_size, 0)
        self.conv_block = UnetResBlock(out_channels + skip_channels,
                                       out_channels, kernel_size,
                                       fused_instance_norm=fused_instance_norm)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))
