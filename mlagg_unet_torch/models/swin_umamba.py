"""Swin-UMamba and Swin-UMamba-D, 2-D, channels-last.

Counterparts of ``VSSLayer``, ``VSSMEncoder``, ``UnetOutBlock``,
``SwinUMamba``, ``PatchExpand``, ``FinalPatchExpand_X4`` and ``SwinUMambaD``
in ``mlagg_unet_tpu/models/swin_umamba.py:39-222``. Both encode with the
VMamba encoder (a patch embed, stages of MLP-free ``VSSBlock``s on the v0
SS2D cell, patch merging between them). Swin-UMamba adds a stride-2 7x7
stem and decodes with the UNETR residual blocks (``UnetrBasicBlock``,
``UnetrUpBlock``) and 1x1 heads for deep supervision; Swin-UMamba-D decodes
with ``PatchExpand``, a skip concat, a Dense back to the skip's width and two
``VSSBlock``s per stage, and a x4 final expand.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from mlagg_unet_torch.models.layers import Conv, Dense, InstanceNorm, LayerNorm
from mlagg_unet_torch.models.unetr_blocks import UnetrBasicBlock, UnetrUpBlock
from mlagg_unet_torch.models.vmamba import PatchMerging2D, VSSBlock


class VSSLayer(nn.Module):
    """``depth`` MLP-free v0 ``VSSBlock``s (``block{i}``)."""

    def __init__(self, dim: int, depth: int, d_state: int = 16,
                 drop_path: Sequence[float] = ()):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", VSSBlock(
                dim, drop_path[i] if i < len(drop_path) else 0.0, d_state, mlp_ratio=0.0,
                forward_type="v0"))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, generator)
        return x


class VSSMEncoder(nn.Module):
    """Returns [input, stage 0, ..., stage 3]; each stage's features are
    taken before its patch merging."""

    def __init__(self, in_channels: int, patch_size: int = 4,
                 depths: Sequence[int] = (2, 2, 9, 2),
                 dims: Sequence[int] = (96, 192, 384, 768), d_state: int = 16,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.depths = list(depths)
        p = patch_size
        self.patch_embed_proj = Conv(in_channels, dims[0], p, p, padding=0)
        self.patch_embed_norm = LayerNorm(dims[0])
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        for s, depth in enumerate(depths):
            start = sum(depths[:s])
            self.add_module(f"layer{s}", VSSLayer(dims[s], depth, d_state,
                                                  dpr[start:start + depth]))
            if s < len(depths) - 1:
                self.add_module(f"downsample{s}", PatchMerging2D(dims[s], 2 * dims[s]))

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        ret = [x]
        x = self.patch_embed_norm(self.patch_embed_proj(x))
        for s in range(len(self.depths)):
            x = getattr(self, f"layer{s}")(x, generator)
            ret.append(x)
            if s < len(self.depths) - 1:
                x = getattr(self, f"downsample{s}")(x)
        return ret


class UnetOutBlock(nn.Module):
    """monai's UnetOutBlock: a biased 1x1 conv."""

    def __init__(self, in_channels: int, num_classes: int):
        super().__init__()
        self.conv = Conv(in_channels, num_classes, 1)

    def forward(self, x):
        return self.conv(x)


class SwinUMamba(nn.Module):
    """The reference's SwinUMamba (the 'Scratch' trainer's network): stem
    conv 7x7 stride 2 + InstanceNorm, a patch-2 VMamba encoder at dims
    ``feat_size[1] * 2^i``, UNETR encoder and decoder blocks, four heads
    under deep supervision."""

    def __init__(self, in_channels: int, num_classes: int,
                 feat_size: Sequence[int] = (48, 96, 192, 384, 768),
                 hidden_size: int = 768, vssm_depths: Sequence[int] = (2, 2, 9, 2),
                 deep_supervision: bool = False):
        super().__init__()
        f = list(feat_size)
        self.deep_supervision = deep_supervision
        self.stem_conv = Conv(in_channels, f[0], 7, 2, padding=3)
        self.stem_norm = InstanceNorm(f[0])
        dims = [f[1] * 2 ** i for i in range(len(vssm_depths))]
        self.vssm_encoder = VSSMEncoder(f[0], 2, vssm_depths, dims)
        self.encoder1 = UnetrBasicBlock(in_channels, f[0])
        self.encoder2 = UnetrBasicBlock(f[0], f[1])
        self.encoder3 = UnetrBasicBlock(dims[0], f[2])
        self.encoder4 = UnetrBasicBlock(dims[1], f[3])
        self.encoder5 = UnetrBasicBlock(dims[2], f[4])
        self.decoder6 = UnetrUpBlock(dims[3], f[4], f[4])
        self.decoder5 = UnetrUpBlock(f[4], f[3], f[3])
        self.decoder4 = UnetrUpBlock(f[3], f[2], f[2])
        self.decoder3 = UnetrUpBlock(f[2], f[1], f[1])
        self.decoder2 = UnetrUpBlock(f[1], f[0], f[0])
        self.decoder1 = UnetrBasicBlock(f[0], f[0])
        for i, c in enumerate((f[0], f[1], f[2], f[3]) if deep_supervision else (f[0],)):
            self.add_module(f"out{i}", UnetOutBlock(c, num_classes))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        vss = self.vssm_encoder(self.stem_norm(self.stem_conv(x)), generator)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(vss[0])
        enc3 = self.encoder3(vss[1])
        enc4 = self.encoder4(vss[2])
        enc5 = self.encoder5(vss[3])
        dec4 = self.decoder6(vss[4], enc5)
        dec3 = self.decoder5(dec4, enc4)
        dec2 = self.decoder4(dec3, enc3)
        dec1 = self.decoder3(dec2, enc2)
        dec_out = self.decoder1(self.decoder2(dec1, enc1))
        if self.deep_supervision:
            return [getattr(self, f"out{i}")(h)
                    for i, h in enumerate((dec_out, dec1, dec2, dec3))]
        return self.out0(dec_out)


class PatchExpand(nn.Module):
    """A bias-free Dense to 2 x ``dim``, a 2x2 pixel shuffle ((p1, p2, c)
    channel order), LN over ``dim // 2``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.expand = Dense(dim, 2 * dim, bias=False)
        self.norm = LayerNorm(dim // 2)

    def forward(self, x):
        B, H, W, _ = x.shape
        c = self.dim // 2
        x = self.expand(x).reshape(B, H, W, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, 2 * H, 2 * W, c))


class FinalPatchExpand_X4(nn.Module):
    """A bias-free Dense to 16 x ``dim``, a 4x4 pixel shuffle, LN over
    ``dim``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.expand = Dense(dim, 16 * dim, bias=False)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        B, H, W, _ = x.shape
        x = self.expand(x).reshape(B, H, W, 4, 4, self.dim).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, 4 * H, 4 * W, self.dim))


class SwinUMambaD(nn.Module):
    """The reference's SwinUMambaD: a patch-4 VMamba encoder and a VSS
    decoder (``PatchExpand``, the skip concat, ``concat_back_dim{s}``, two
    blocks per stage; ``FinalPatchExpand_X4`` last), a head per stage under
    deep supervision."""

    def __init__(self, in_channels: int, num_classes: int,
                 dims: Sequence[int] = (96, 192, 384, 768), d_state: int = 16,
                 drop_path_rate: float = 0.2, deep_supervision: bool = False):
        super().__init__()
        dims = list(dims)
        n = self.n = len(dims)
        self.deep_supervision = deep_supervision
        self.vssm_encoder = VSSMEncoder(in_channels, 4, dims=dims)
        total = (n - 1) * 2
        dpr = [drop_path_rate * (1 - i / max(total - 1, 1)) for i in range(total)]
        for s in range(n):
            if s < n - 1:
                width = dims[n - s - 2]
                self.add_module(f"expand{s}", PatchExpand(dims[n - s - 1]))
                self.add_module(f"concat_back_dim{s}",
                                Dense(dims[n - s - 1] // 2 + width, width))
                self.add_module(f"stage{s}", VSSLayer(width, 2, d_state, dpr[2 * s:2 * s + 2]))
            else:
                width = dims[0]
                self.add_module(f"expand{s}", FinalPatchExpand_X4(dims[0]))
            if deep_supervision or s == n - 1:
                self.add_module(f"seg{s}", Conv(width, num_classes, 1))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        n = self.n
        skips = self.vssm_encoder(x, generator)
        lres = skips[-1]
        outputs = []
        for s in range(n):
            h = getattr(self, f"expand{s}")(lres)
            if s < n - 1:
                h = getattr(self, f"concat_back_dim{s}")(torch.cat([h, skips[-(s + 2)]], dim=-1))
                h = getattr(self, f"stage{s}")(h, generator)
            if self.deep_supervision or s == n - 1:
                outputs.append(getattr(self, f"seg{s}")(h))
            lres = h
        outputs = outputs[::-1]
        return outputs if self.deep_supervision else outputs[0]
