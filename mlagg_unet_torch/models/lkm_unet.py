"""LKM-UNet, channels-last, 2-D and 3-D.

Counterpart of ``mlagg_unet_tpu/models/lkm_unet.py``: nnU-Net's residual
encoder whose every stage is followed by a pixel-level and a window-level
bidirectional Mamba layer, and the residual decoder with a segmentation
head per stage. Each bidirectional layer normalises its tokens, runs one
``MambaBlock(project_out=False)`` on them and another on them reversed (the
block's causal conv1d sees the reversed sequence, so the scan's own
``reverse`` flag would compute something else), adds the second's output
reversed back to the first's, and projects the sum with one shared
``out_proj``. Every scan is ``ops.selective_scan_cuda.selective_scan_fwd``:
K1 on the card (K5 in training), the plain scan on the CPU.

The pixel layer's windows are p-strided sub-grids (period 5p in 2-D,
(5p, 7p, 6p) in 3-D): the offsets within a period go into the batch and the
periods into the sequence. Where an extent does not divide, the whole map is
one sequence. The window layer average-pools by p, scans the pooled tokens
and repeats each back over its p-cell (the whole map where p does not
divide). Submodules carry the flax scope names (``stem``, ``stage{s}``,
``pixel_mamba{s}.bi``, ``window_mamba{s}.bi``, ``transpconv{s}``,
``dec_stage{s}``, ``seg{s}``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike
from mlagg_unet_torch.models.dynamic_unet import (
    StackedConvBlocks,
    StackedResidualBlocks,
    TransposedConvND,
)
from mlagg_unet_torch.models.layers import Dense, LayerNorm, PointwiseConv
from mlagg_unet_torch.models.mamba_block import MambaBlock


class BiMambaShared(nn.Module):
    """norm -> forward Mamba + token-reversed backward Mamba -> one shared
    out_proj, on (NB, L, C) tokens (JAX's ``_BiMambaShared``)."""

    def __init__(self, dim: int, d_state: int = 16, d_conv: int = 4, expand: int = 2):
        super().__init__()
        self.norm = LayerNorm(dim)
        self.mamba_forw = MambaBlock(dim, d_state, d_conv, expand, project_out=False)
        self.mamba_backw = MambaBlock(dim, d_state, d_conv, expand, project_out=False)
        self.out_proj = Dense(expand * dim, dim, bias=False)

    def forward(self, t):
        t = self.norm(t)
        y = self.mamba_forw(t) + self.mamba_backw(t.flip(1)).flip(1)
        return self.out_proj(y)


class BiPixelMambaLayer(nn.Module):
    """The bidirectional Mamba over the p-strided sub-grids, residual."""

    def __init__(self, dim: int, p_raw: int):
        super().__init__()
        self.p_raw = p_raw
        self.bi = BiMambaShared(dim)

    def forward(self, x):
        C, p = x.shape[-1], self.p_raw
        if x.ndim == 5:
            B, Z, H, W, _ = x.shape
            p1, p2, p3 = 5 * p, 7 * p, 6 * p
            if Z % p1 == 0 and H % p2 == 0 and W % p3 == 0:
                nz, nh, nw = Z // p1, H // p2, W // p3
                xd = x.reshape(B, nz, p1, nh, p2, nw, p3, C).permute(0, 2, 4, 6, 1, 3, 5, 7)
                y = self.bi(xd.reshape(B * p1 * p2 * p3, nz * nh * nw, C))
                y = y.reshape(B, p1, p2, p3, nz, nh, nw, C).permute(0, 4, 1, 5, 2, 6, 3, 7)
                return x + y.reshape(x.shape)
        else:
            B, H, W, _ = x.shape
            p = 5 * p
            if p > 0 and H % p == 0 and W % p == 0:
                nh, nw = H // p, W // p
                xd = x.reshape(B, nh, p, nw, p, C).permute(0, 2, 4, 1, 3, 5)
                y = self.bi(xd.reshape(B * p * p, nh * nw, C))
                y = y.reshape(B, p, p, nh, nw, C).permute(0, 3, 1, 4, 2, 5)
                return x + y.reshape(x.shape)
        return x + self.bi(x.reshape(x.shape[0], -1, C)).reshape(x.shape)


class BiWindowMambaLayer(nn.Module):
    """Average-pool by p, the bidirectional Mamba over the pooled tokens,
    nearest unpool, residual."""

    def __init__(self, dim: int, p_raw: int):
        super().__init__()
        self.p = p_raw if p_raw > 0 else 1
        self.bi = BiMambaShared(dim)

    def forward(self, x):
        B, *sp, C = x.shape
        p = self.p
        if any(s % p for s in sp):
            return x + self.bi(x.reshape(B, -1, C)).reshape(x.shape)
        cells = [v for s in sp for v in (s // p, p)]
        pooled = x.reshape(B, *cells, C).mean(dim=tuple(range(2, 2 * len(sp) + 1, 2)))
        y = self.bi(pooled.reshape(B, -1, C))
        y = y.reshape(B, *[v for s in sp for v in (s // p, 1)], C)
        y = y.expand(B, *cells, C).reshape(*x.shape[:-1], y.shape[-1])
        return x + y


class LKMUNet(nn.Module):
    """``forward(x, generator)`` on channels-last ``x``: the logits, or
    under deep supervision one head per decoder stage, highest resolution
    first. No layer draws random numbers: ``generator`` is ignored."""

    def __init__(self, in_channels: int, num_classes: int, n_stages: int = 6,
                 features_per_stage: Sequence[int] = (32, 64, 128, 256, 512, 512),
                 kernel_sizes: Sequence[Sequence[int]] = ((3, 3),) * 6,
                 strides: Sequence[Sequence[int]] = ((1, 1),) + ((2, 2),) * 5,
                 n_conv_per_stage: Sequence[int] = (2,) * 6,
                 n_conv_per_stage_decoder: Sequence[int] = (2,) * 5,
                 deep_supervision: bool = True):
        super().__init__()
        n, f = n_stages, list(features_per_stage)
        self.n_stages, self.deep_supervision = n, deep_supervision
        d = len(kernel_sizes[0])
        ones = [1] * d
        self.stem = StackedConvBlocks(1, in_channels, f[0], kernel_sizes[0], ones)
        for s in range(n):
            self.add_module(f"stage{s}", StackedResidualBlocks(
                n_conv_per_stage[s], f[s - 1] if s else f[0], f[s], kernel_sizes[s],
                strides[s]))
            # reference :441-442: the periods from the stage's depth
            self.add_module(f"pixel_mamba{s}", BiPixelMambaLayer(f[s], 2 ** ((n - s + 1) // 2 - 1)))
            self.add_module(f"window_mamba{s}", BiWindowMambaLayer(f[s], 2 ** ((n - s + 1) // 2) // 2))
        for s in range(1, n):
            skip = f[n - s - 1]
            self.add_module(f"transpconv{s - 1}", TransposedConvND(f[n - s], skip, strides[n - s]))
            self.add_module(f"dec_stage{s - 1}", StackedResidualBlocks(
                n_conv_per_stage_decoder[s - 1], 2 * skip, skip, kernel_sizes[n - s - 1], ones))
            if deep_supervision or s == n - 1:
                self.add_module(f"seg{s - 1}", PointwiseConv(skip, num_classes, spatial_dims=d))

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        n = self.n_stages
        x = self.stem(x)
        skips = []
        for s in range(n):
            x = getattr(self, f"stage{s}")(x)
            x = getattr(self, f"window_mamba{s}")(getattr(self, f"pixel_mamba{s}")(x))
            skips.append(x)
        outs, lres = [], skips[-1]
        for s in range(1, n):
            up = getattr(self, f"transpconv{s - 1}")(lres)
            up = torch.cat([up, skips[n - s - 1]], dim=-1)
            lres = getattr(self, f"dec_stage{s - 1}")(up)
            if self.deep_supervision or s == n - 1:
                outs.append(getattr(self, f"seg{s - 1}")(lres))
        return outs[::-1] if self.deep_supervision else outs[-1]


def lkm_unet_from_plans(configuration_manager, num_input_channels: int,
                        num_output_channels: int, deep_supervision: bool) -> LKMUNet:
    """The plans' LKM-UNet (``get_lkmunet_from_plans``, JAX's
    ``_build_lkm_unet``): features min(base 2^i, max), kernels, strides and
    block counts from the configuration."""
    cm = configuration_manager
    stages = len(cm.conv_kernel_sizes)
    return LKMUNet(
        num_input_channels, num_output_channels, stages,
        [min(cm.UNet_base_num_features * 2 ** i, cm.unet_max_num_features)
         for i in range(stages)],
        [tuple(k) for k in cm.conv_kernel_sizes], [tuple(s) for s in cm.pool_op_kernel_sizes],
        list(cm.n_conv_per_stage_encoder), list(cm.n_conv_per_stage_decoder),
        deep_supervision)


def build_lkm_unet(configuration_manager, num_input_channels: int, num_output_channels: int,
                   deep_supervision: bool, *, seed: int = 0,
                   device: DeviceLike = "cuda") -> LKMUNet:
    """``lkm_unet_from_plans``, seeded, fp32, in eval mode on ``device``."""
    from mlagg_unet_torch.models.vmamba import build_seeded

    return build_seeded(lkm_unet_from_plans(configuration_manager, num_input_channels,
                                            num_output_channels, deep_supervision), seed, device)
