"""Swin-TUNet, channels-last.

Counterpart of ``mlagg_unet_tpu/models/more_variants.py::SwinTUNet``: a
Swin-transformer U-shape. A stride-4 4x4 patch embed (torch's bias init; no
padding on the multiples of 4 it takes, flax's SAME there), LayerNorm at
flax's eps 1e-6, four ``SwinStage``s with a swin-v1 ``PatchMergingSwin``
between them, a decoder of ``PatchExpand2D`` (VM-UNet's) + the skip added +
one Swin block per stage, two more ``PatchExpand2D`` to full resolution and
MedNeXt's 1x1 ``OutBlock``. No deep supervision. Submodules carry the flax
scope names (``stage0.block1.attn.qkv``, ``merge0``, ``up2``, ``seg``...).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mlagg_unet_torch.models.layers import Conv, LayerNorm
from mlagg_unet_torch.models.mednext import OutBlock
from mlagg_unet_torch.models.swin_unetr import PatchMergingSwin, SwinStage
from mlagg_unet_torch.models.vmamba import PatchExpand2D


class SwinTUNet(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, num_classes), H and W multiples
    of 4 x 2^(stages - 1)."""

    def __init__(self, in_channels: int, num_classes: int, embed_dim: int = 48,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7):
        super().__init__()
        e, n = embed_dim, len(depths)
        dims = [e * 2 ** i for i in range(n)]
        self.n = n
        self.patch_embed = Conv(in_channels, e, 4, 4, 0, torch_bias=True)
        self.patch_norm = LayerNorm(e)
        for i, (dep, nh) in enumerate(zip(depths, num_heads)):
            self.add_module(f"stage{i}", SwinStage(dims[i], dep, nh, window_size))
            if i < n - 1:
                self.add_module(f"merge{i}", PatchMergingSwin(dims[i]))
        for i in range(n - 2, -1, -1):
            self.add_module(f"up{i}", PatchExpand2D(dims[i + 1], dims[i]))
            self.add_module(f"dec{i}", SwinStage(dims[i], 1, num_heads[i], window_size))
        self.up_final_a = PatchExpand2D(dims[0], max(e // 2, 4))
        self.up_final_b = PatchExpand2D(max(e // 2, 4), max(e // 4, 4))
        self.seg = OutBlock(max(e // 4, 4), num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.patch_norm(self.patch_embed(x))
        skips = []
        for i in range(self.n):
            h = getattr(self, f"stage{i}")(h)
            skips.append(h)
            if i < self.n - 1:
                h = getattr(self, f"merge{i}")(h)
        for i in range(self.n - 2, -1, -1):
            h = getattr(self, f"dec{i}")(getattr(self, f"up{i}")(h) + skips[i])
        return self.seg(self.up_final_b(self.up_final_a(h)))
