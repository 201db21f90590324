"""MedNeXt blocks, 2D NHWC.

Counterparts of ``MedNeXtBlock``, ``MedNeXtDownBlock`` (with the optional
GRN of ``_apply_grn``), ``PatchExpand`` and ``OutBlock`` in
``mlagg_unet_tpu/models/mednext.py``.
"""
from __future__ import annotations

import torch
from torch import nn

from mlagg_unet_torch.models.layers import (
    Conv,
    ConvTransposeTorch,
    DepthwiseConv,
    InstanceNorm,
    PointwiseConv,
    gelu,
    pad_top_left,
)


class MedNeXtBlock(nn.Module):
    """depthwise k-conv -> GroupNorm -> 1x1 expand + GELU [-> GRN] -> 1x1
    compress [+ residual]. GRN params keep the JAX shape (1, 1, 1, C)."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel_size: int = 7, do_res: bool = True, grn: bool = False):
        super().__init__()
        self.do_res, self.grn = do_res, grn
        self.conv1 = self._conv1(in_channels, kernel_size)
        self.norm = InstanceNorm(in_channels)
        self.conv2 = PointwiseConv(in_channels, exp_r * in_channels)
        if grn:
            self.grn_beta = nn.Parameter(torch.empty(1, 1, 1, exp_r * in_channels))
            self.grn_gamma = nn.Parameter(torch.empty(1, 1, 1, exp_r * in_channels))
        self.conv3 = PointwiseConv(exp_r * in_channels, out_channels)

    def _conv1(self, channels, kernel_size):
        return DepthwiseConv(channels, kernel_size)

    def init_parameters(self, gen):
        if self.grn:
            with torch.no_grad():
                self.grn_beta.zero_()
                self.grn_gamma.zero_()

    def _body(self, x):
        x1 = gelu(self.conv2(self.norm(self.conv1(x))))
        if self.grn:
            gx = torch.sqrt((x1 * x1).sum(dim=(1, 2), keepdim=True))
            nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
            x1 = self.grn_gamma * (x1 * nx) + self.grn_beta + x1
        return self.conv3(x1)

    def forward(self, x):
        x1 = self._body(x)
        return x + x1 if self.do_res else x1


class MedNeXtDownBlock(MedNeXtBlock):
    """Stride-2 depthwise conv1 (symmetric padding k // 2) and a strided 1x1
    residual, computed as slice-then-matmul."""

    def __init__(self, in_channels: int, out_channels: int, exp_r: int = 4,
                 kernel_size: int = 3, do_res: bool = True, grn: bool = False):
        super().__init__(in_channels, out_channels, exp_r, kernel_size,
                         do_res=do_res, grn=grn)
        if do_res:
            self.res_conv = PointwiseConv(in_channels, out_channels)

    def _conv1(self, channels, kernel_size):
        return Conv(channels, channels, kernel_size, stride=2,
                    padding=kernel_size // 2, groups=channels)

    def forward(self, x):
        x1 = self._body(x)
        return x1 + self.res_conv(x[:, ::2, ::2]) if self.do_res else x1


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

    def __init__(self, in_channels: int, n_classes: int):
        super().__init__()
        self.conv_out = PointwiseConv(in_channels, n_classes)

    def forward(self, x):
        return self.conv_out(x)
