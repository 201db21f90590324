"""MedNeXt blocks, channels-last, 2-D and 3-D.

Counterparts of ``MedNeXtBlock``, ``MedNeXtDownBlock``, ``MedNeXtUpBlock``
(each with the optional GRN of ``_apply_grn``), ``PatchExpand`` and
``OutBlock`` in ``mlagg_unet_tpu/models/mednext.py``. The down and up
blocks take one stride for every axis or one per axis (anisotropic plans:
a stride-1 axis gets kernel 1 on the up block's conv1 and no top/left pad).
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from mlagg_unet_torch.models.layers import (
    Conv,
    ConvTransposeTorch,
    DepthwiseConv,
    InstanceNorm,
    PointwiseConv,
    _ntuple,
    gelu,
    pad_top_left,
)


class MedNeXtBlock(nn.Module):
    """depthwise k-conv -> GroupNorm -> 1x1 expand + GELU [-> GRN] -> 1x1
    compress [+ residual]. GRN params keep the JAX shape (1, ..., 1, C)."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel_size: int = 7, do_res: bool = True, grn: bool = False,
                 stride: Union[int, Sequence[int]] = 1, spatial_dims: int = 2):
        super().__init__()
        self.do_res, self.grn = do_res, grn
        self.d = spatial_dims
        self.stride = _ntuple(stride, spatial_dims)
        self.conv1 = self._conv1(in_channels, kernel_size)
        self.norm = InstanceNorm(in_channels)
        self.conv2 = PointwiseConv(in_channels, exp_r * in_channels, spatial_dims=spatial_dims)
        if grn:
            shape = (1,) * (spatial_dims + 1) + (exp_r * in_channels,)
            self.grn_beta = nn.Parameter(torch.empty(shape))
            self.grn_gamma = nn.Parameter(torch.empty(shape))
        self.conv3 = PointwiseConv(exp_r * in_channels, out_channels, spatial_dims=spatial_dims)

    def _conv1(self, channels, kernel_size):
        return DepthwiseConv(channels, kernel_size, self.d)

    def init_parameters(self, gen):
        if self.grn:
            with torch.no_grad():
                self.grn_beta.zero_()
                self.grn_gamma.zero_()

    def _body(self, x):
        x1 = gelu(self.conv2(self.norm(self.conv1(x))))
        if self.grn:
            gx = torch.sqrt((x1 * x1).sum(dim=tuple(range(1, self.d + 1)), keepdim=True))
            nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
            x1 = self.grn_gamma * (x1 * nx) + self.grn_beta + x1
        return self.conv3(x1)

    def forward(self, x):
        x1 = self._body(x)
        return x + x1 if self.do_res else x1


class MedNeXtDownBlock(MedNeXtBlock):
    """Strided depthwise conv1 (symmetric padding k // 2) and a strided 1x1
    residual, computed as slice-then-matmul."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel_size: int = 3, do_res: bool = True, grn: bool = False,
                 stride: Union[int, Sequence[int]] = 2, spatial_dims: int = 2):
        super().__init__(in_channels, out_channels, exp_r, kernel_size, do_res=do_res,
                         grn=grn, stride=stride, spatial_dims=spatial_dims)
        if do_res:
            self.res_conv = PointwiseConv(in_channels, out_channels, spatial_dims=spatial_dims)

    def _conv1(self, channels, kernel_size):
        return Conv(channels, channels, (kernel_size,) * self.d, stride=self.stride,
                    padding=kernel_size // 2, groups=channels)

    def forward(self, x):
        x1 = self._body(x)
        if not self.do_res:
            return x1
        return x1 + self.res_conv(x[(slice(None), *(slice(None, None, s) for s in self.stride))])


class MedNeXtUpBlock(MedNeXtBlock):
    """Transposed depthwise conv1, then the top/left pad of every strided
    axis after conv3, and a transposed 1x1 residual padded the same way:
    the output is exactly ``stride`` times the input."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel_size: int = 3, do_res: bool = True, grn: bool = False,
                 stride: Union[int, Sequence[int]] = 2, spatial_dims: int = 2):
        super().__init__(in_channels, out_channels, exp_r, kernel_size, do_res=do_res,
                         grn=grn, stride=stride, spatial_dims=spatial_dims)
        self.pad = tuple(int(s != 1) for s in self.stride)
        if do_res:
            self.res_conv = ConvTransposeTorch(in_channels, out_channels, (1,) * self.d,
                                               self.stride, 0)

    def _conv1(self, channels, kernel_size):
        ks = tuple(1 if s == 1 else kernel_size for s in self.stride)
        return ConvTransposeTorch(channels, channels, ks, self.stride, tuple(k // 2 for k in ks),
                                  groups=channels)

    def forward(self, x):
        x1 = pad_top_left(self._body(x), self.pad)
        if self.do_res:
            x1 = x1 + pad_top_left(self.res_conv(x), self.pad)
        return x1


class PatchExpand(nn.Module):
    """GroupNorm -> transposed k-conv stride 2 -> top/left pad, plus a
    transposed 1x1 residual: doubles H and W exactly."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, do_res: bool = True):
        super().__init__()
        self.do_res = do_res
        self.norm = InstanceNorm(in_channels)
        self.conv1 = ConvTransposeTorch(in_channels, out_channels, kernel_size,
                                        2, kernel_size // 2)
        if do_res:
            self.res_conv = ConvTransposeTorch(in_channels, out_channels, 1, 2, 0)

    def forward(self, x):
        x1 = pad_top_left(self.conv1(self.norm(x)))
        if self.do_res:
            x1 = x1 + pad_top_left(self.res_conv(x))
        return x1


class OutBlock(nn.Module):
    """1x1 projection to class logits."""

    def __init__(self, in_channels: int, n_classes: int, spatial_dims: int = 2):
        super().__init__()
        self.conv_out = PointwiseConv(in_channels, n_classes, spatial_dims=spatial_dims)

    def forward(self, x):
        return self.conv_out(x)
