"""MSVM-UNet, channels-last.

Counterpart of ``mlagg_unet_tpu/models/msvm_unet.py``: the VSSM
``tiny_0230s`` encoder (dims 96-768, depths 2-2-8-2, patch embed v2,
downsample v3) of ``VSSBlockMSVM`` blocks, whose SS2D cell scans four
directions at ``d_state`` 1 with forward type ``v05_noz`` (no z gate, the
scan in the input dtype: bf16 when served in bf16; K1 on the GPU, K5 behind
autograd), ratio 1.0 and a bias-free depthwise conv; the decoder's
large-kernel patch expanding (``LKPE``: 1x1 conv -> BatchNorm -> ReLU ->
depthwise 3x3 -> 2x pixel shuffle -> LN), the skip concatenated and fused by
a Dense, multi-scale-MLP blocks; the 4x ``FLKPE`` head. A 1-channel input is
tiled to the encoder's 3 channels, as the reference's forward does. No deep
supervision. LayerNorms at flax's eps 1e-6, BatchNorm at flax's momentum
0.99. Submodules carry the flax scope names; stochastic depth draws from the
``generator`` the forward takes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import BatchNorm, Conv, Dense, DropPath, LayerNorm, gelu
from mlagg_unet_torch.models.mamba_block import SS2D

class MSConv(nn.Module):
    """x + the sum of bias-free depthwise convs of kernels 1, 3 and 5."""

    def __init__(self, dim: int, kernel_sizes: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.n = len(kernel_sizes)
        for i, k in enumerate(kernel_sizes):
            self.add_module(f"dw{i}", Conv(dim, dim, k, groups=dim, bias=False))

    def forward(self, x):
        return x + sum(getattr(self, f"dw{i}")(x) for i in range(self.n))


class MSMlp(nn.Module):
    """fc1 -> GELU -> MSConv -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.multiscale_conv = MSConv(hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(self.multiscale_conv(gelu(self.fc1(x))))


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class VSSBlockMSVM(nn.Module):
    """x + DropPath(SS2D(LN(x))), then x + DropPath(mlp(LN(x))), mlp ratio 4;
    the SS2D at d_state 1, d_conv 3 without bias, ratio 1.0, ``v05_noz``."""

    def __init__(self, dim: int, drop_path: float = 0.0, mlp_ratio: float = 4.0,
                 ms_mlp: bool = False):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.op = SS2D(dim, d_state=1, d_conv=3, conv_bias=False, expand=1.0,
                       forward_type="v05_noz")
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        hidden = int(dim * mlp_ratio)
        self.mlp = MSMlp(dim, hidden) if ms_mlp else Mlp(dim, hidden)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.drop_path(self.op(self.norm(x)), generator)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class PatchEmbedV2(nn.Module):
    """Two stride-2 3x3 convs (padding 1) with LN + GELU between, LN after."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        self.conv1 = Conv(in_channels, embed_dim // 2, 3, 2, padding=1)
        self.norm1 = LayerNorm(embed_dim // 2)
        self.conv2 = Conv(embed_dim // 2, embed_dim, 3, 2, padding=1)
        self.norm2 = LayerNorm(embed_dim)

    def forward(self, x):
        return self.norm2(self.conv2(gelu(self.norm1(self.conv1(x)))))


class DownsampleV3(nn.Module):
    """A stride-2 3x3 conv (padding 1) + LN."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.conv = Conv(dim, out_dim, 3, 2, padding=1)
        self.norm = LayerNorm(out_dim)

    def forward(self, x):
        return self.norm(self.conv(x))


def _linspace(lo: float, hi: float, n: int) -> List[float]:
    return [float(v) for v in np.linspace(lo, hi, n)]


class MSVMEncoder(nn.Module):
    """The patch embed, then per stage its blocks (the feature is kept) and
    a downsample to the next width."""

    def __init__(self, in_channels: int = 3, dims: Sequence[int] = (96, 192, 384, 768),
                 depths: Sequence[int] = (2, 2, 8, 2), drop_path_rate: float = 0.2):
        super().__init__()
        self.depths = list(depths)
        dpr = _linspace(0, drop_path_rate, sum(depths))
        self.patch_embed = PatchEmbedV2(in_channels, dims[0])
        k = 0
        for i, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"layer{i}_block{b}", VSSBlockMSVM(dims[i], drop_path=dpr[k]))
                k += 1
            if i < len(depths) - 1:
                self.add_module(f"downsample{i}", DownsampleV3(dims[i], dims[i + 1]))

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = self.patch_embed(x)
        feats = []
        for i, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"layer{i}_block{b}")(x, generator)
            feats.append(x)
            if i < len(self.depths) - 1:
                x = getattr(self, f"downsample{i}")(x)
        return feats


def pixel_shuffle(x: torch.Tensor, p: int) -> torch.Tensor:
    """NHWC pixel shuffle, einops 'b h w (p1 p2 c) -> b (h p1) (w p2) c'."""
    B, H, W, C = x.shape
    c = C // (p * p)
    return x.reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5).reshape(B, H * p, W * p, c)


class LKPE(nn.Module):
    """1x1 conv to 2C -> BatchNorm -> ReLU -> depthwise 3x3 -> 2x pixel
    shuffle -> LN: C / 2 channels at twice the resolution. With ``scale``
    4 and ``num_classes`` it is ``FLKPE``, the head: 16C, a 4x shuffle, LN,
    then a 1x1 conv to the classes."""

    def __init__(self, dim: int, scale: int = 2, num_classes: Optional[int] = None):
        super().__init__()
        wide = dim * scale * scale // 2 if num_classes is None else dim * 16
        self.scale = scale
        self.expand_conv1 = Conv(dim, wide, 1)
        self.bn = BatchNorm(wide, momentum=0.99)
        self.expand_dwconv = Conv(wide, wide, 3, groups=wide)
        self.norm = LayerNorm(wide // (scale * scale))
        if num_classes is not None:
            self.out = Conv(wide // (scale * scale), num_classes, 1)

    def forward(self, x):
        x = self.expand_dwconv(F.relu(self.bn(self.expand_conv1(x))))
        x = self.norm(pixel_shuffle(x, self.scale))
        return self.out(x) if hasattr(self, "out") else x


class MSVMUpBlock(nn.Module):
    """``LKPE`` up, the skip concatenated, a Dense fuse to ``out_channels``,
    then multi-scale-MLP blocks."""

    def __init__(self, in_channels: int, out_channels: int, depth: int,
                 drop_path: Sequence[float]):
        super().__init__()
        self.depth = depth
        self.up = LKPE(in_channels)
        self.concat_layer = Dense(in_channels // 2 + out_channels, out_channels)
        for b in range(depth):
            self.add_module(f"block{b}", VSSBlockMSVM(out_channels, drop_path=drop_path[b],
                                                      ms_mlp=True))

    def forward(self, x, skip, generator: Optional[torch.Generator] = None):
        x = self.concat_layer(torch.cat([self.up(x), skip], dim=-1))
        for b in range(self.depth):
            x = getattr(self, f"block{b}")(x, generator)
        return x


class MSVMUNet(nn.Module):
    """The MSVM-UNet: (B, H, W, in_channels) -> (B, H, W, num_classes). A
    1-channel input is tiled to the encoder's ``encoder_channels`` (3)."""

    def __init__(self, in_channels: int, num_classes: int,
                 dims: Sequence[int] = (96, 192, 384, 768), depths: Sequence[int] = (2, 2, 8, 2),
                 decoder_depths: Sequence[int] = (2, 2, 2, 2), drop_path_rate: float = 0.2,
                 decoder_drop_path_rate: float = 0.2, encoder_channels: int = 3):
        super().__init__()
        self.tile = in_channels == 1 and encoder_channels == 3
        self.encoder = MSVMEncoder(3 if self.tile else in_channels, dims, depths, drop_path_rate)
        rdims = list(dims[::-1])
        dpr = _linspace(decoder_drop_path_rate, 0, (len(rdims) - 1) * 2)
        self.n_up = len(rdims) - 1
        for i in range(1, len(rdims)):
            lo, hi = sum(decoder_depths[: i - 1]), sum(decoder_depths[:i])
            self.add_module(f"up{i - 1}", MSVMUpBlock(rdims[i - 1], rdims[i],
                                                      decoder_depths[i], dpr[lo:hi]))
        self.final = LKPE(rdims[-1], scale=4, num_classes=num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.tile:
            x = x.repeat(1, 1, 1, 3)
        feats = self.encoder(x, generator)[::-1]
        out = feats[0]
        for i in range(self.n_up):
            out = getattr(self, f"up{i}")(out, feats[i + 1], generator)
        return self.final(out)

