"""UNETR residual conv blocks, channels-last 2-D (NHWC) or 3-D (NDHWC).

Counterparts of ``UnetResBlock``, ``UnetrBasicBlock`` and ``UnetrUpBlock``
in ``mlagg_unet_tpu/models/unetr_blocks.py``: ``spatial_dims`` sets the
dimension, and kernels and strides are ints or per-axis sequences, as JAX's
``_per_axis`` takes them (SegMamba's decoder upsamples by (1, 2, 2)). With
``fused_instance_norm``
(``None``: the JAX package's ``MLAGG_FUSED_IN == "1"``, read at construction)
each InstanceNorm + LeakyReLU (+ residual) chain runs through
``ops.fused_norm.fused_instance_norm`` (kernels K7 and K8 on the GPU), as
``unetr_blocks.py:79-96`` does; the parameters keep their names either way.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import Conv, ConvTransposeTorch, InstanceNorm
from mlagg_unet_torch.ops.fused_norm import fused_instance_norm, fused_norms_enabled


IntOrN = Union[int, Sequence[int]]


def lrelu(x):
    return F.leaky_relu(x, 0.01)


def _per_axis(v: IntOrN, d: int) -> Tuple[int, ...]:
    return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) else (int(v),) * d


class UnetResBlock(nn.Module):
    """conv(k, s) -> IN -> lrelu -> conv(k) -> IN [+ 1x1 conv / IN residual]
    -> lrelu. ``two_pass`` takes the instance norms' two-pass variance (the
    same function, fewer fp32 temporaries: SegMamba's full-resolution 3-D
    blocks); the fused path is 2-D only."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrN = 3, stride: IntOrN = 1,
                 fused_instance_norm: Optional[bool] = None, spatial_dims: int = 2,
                 two_pass: bool = False):
        super().__init__()
        ks, ss = _per_axis(kernel_size, spatial_dims), _per_axis(stride, spatial_dims)
        self.has_proj = in_channels != out_channels or any(s != 1 for s in ss)
        self.fused = fused_norms_enabled(fused_instance_norm)
        if self.fused and spatial_dims != 2:
            raise ValueError("the fused instance norm (K7/K8) is 2-D only")
        self.conv1 = Conv(in_channels, out_channels, ks, ss)
        self.norm1 = InstanceNorm(out_channels, two_pass=two_pass)
        self.conv2 = Conv(out_channels, out_channels, ks)
        self.norm2 = InstanceNorm(out_channels, two_pass=two_pass)
        if self.has_proj:
            self.conv3 = Conv(in_channels, out_channels, (1,) * spatial_dims, ss)
            self.norm3 = InstanceNorm(out_channels, two_pass=two_pass)

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
                 kernel_size: IntOrN = 3, stride: IntOrN = 1,
                 fused_instance_norm: Optional[bool] = None, spatial_dims: int = 2,
                 two_pass: bool = False):
        super().__init__()
        self.layer = UnetResBlock(in_channels, out_channels, kernel_size, stride,
                                  fused_instance_norm, spatial_dims, two_pass)

    def forward(self, x):
        return self.layer(x)


class UnetrUpBlock(nn.Module):
    """transposed conv (k = s = upsample_kernel_size) -> concat skip ->
    UnetResBlock."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int,
                 kernel_size: IntOrN = 3, upsample_kernel_size: IntOrN = 2,
                 fused_instance_norm: Optional[bool] = None, spatial_dims: int = 2,
                 two_pass: bool = False):
        super().__init__()
        up = _per_axis(upsample_kernel_size, spatial_dims)
        self.transp_conv = ConvTransposeTorch(in_channels, out_channels, up, up, 0)
        self.conv_block = UnetResBlock(out_channels + skip_channels,
                                       out_channels, kernel_size,
                                       fused_instance_norm=fused_instance_norm,
                                       spatial_dims=spatial_dims, two_pass=two_pass)

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))
