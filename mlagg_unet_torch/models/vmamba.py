"""VMamba blocks, VM-UNet and Mamba-UNet, channels-last.

Counterparts of ``mlagg_unet_tpu/models/vmamba.py:25-274``: ``VSSBlock``
(LN -> SS2D -> DropPath residual [-> LN -> MLP -> residual]),
``PatchMerging2D`` (2x2 patch merging), the ``VSSM`` backbone,
``PatchExpand2D`` (linear expand + pixel shuffle), ``_V0Block`` (the
VM-UNet / Mamba-UNet block: LN -> the v0 SS2D cell -> residual, no MLP),
``_FinalExpand`` and the two U-shaped networks. The patch embeds are
stride-4 4x4 convs with torch's bias init; flax's SAME padding is no
padding there, on the inputs (multiples of the patch) the networks take.

Submodules carry the flax scope names (``layer0_block1.self_attention``,
``downsample0.reduction``, ``up1.expand``...), so
``weights.jax_params_to_state_dict`` only changes layouts. Stochastic depth
draws from the ``generator`` that the forward takes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.models.layers import (
    Conv,
    Dense,
    DropPath,
    LayerNorm,
    gelu,
    init_parameters,
)
from mlagg_unet_torch.models.mamba_block import SS2D


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2 (``layers.py:45``; flax's ``Dense_0``/``Dense_1``)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)

    def forward(self, x):
        return self.Dense_1(gelu(self.Dense_0(x)))


class VSSBlock(nn.Module):
    """LN -> SS2D -> DropPath residual, then (``mlp_ratio > 0``) LN -> MLP
    -> DropPath residual. LayerNorms at flax's eps 1e-6."""

    def __init__(self, dim: int, drop_path: float = 0.0, d_state: int = 16,
                 ssm_ratio: float = 2.0, mlp_ratio: float = 4.0, forward_type: str = "v2"):
        super().__init__()
        self.ln_1 = LayerNorm(dim)
        self.self_attention = SS2D(dim, d_state=d_state, expand=ssm_ratio,
                                   forward_type=forward_type)
        self.drop_path = DropPath(drop_path)
        self.mlp_ratio = mlp_ratio
        if mlp_ratio > 0:
            self.ln_2 = LayerNorm(dim)
            self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.drop_path(self.self_attention(self.ln_1(x)), generator)
        if self.mlp_ratio > 0:
            x = x + self.drop_path(self.mlp(self.ln_2(x)), generator)
        return x


class PatchMerging2D(nn.Module):
    """2x2 patch merging: the four (h, w) offsets in torch's concat order
    (w-offset outer), LN (eps 1e-5), a bias-free reduction to ``out_dim``."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, out_dim, bias=False)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class PatchExpand2D(nn.Module):
    """VM-UNet's upsampling: a bias-free Dense to 4 x ``out_dim``, a 2x2
    pixel shuffle, LN (eps 1e-5)."""

    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.out_dim = out_dim
        self.expand = Dense(dim, 4 * out_dim, bias=False)
        self.norm = LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        B, H, W, _ = x.shape
        x = self.expand(x).reshape(B, H, W, 2, 2, self.out_dim).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, 2 * H, 2 * W, self.out_dim))


class _FinalExpand(nn.Module):
    """A bias-free Dense to ``expand_to``, a ``scale`` x ``scale`` pixel
    shuffle, LN (eps 1e-5) over ``expand_to // scale**2`` channels."""

    def __init__(self, dim: int, expand_to: int, scale: int = 4):
        super().__init__()
        self.scale, self.c = scale, expand_to // (scale * scale)
        self.expand = Dense(dim, expand_to, bias=False)
        self.norm = LayerNorm(self.c, eps=1e-5)

    def forward(self, x):
        B, H, W, _ = x.shape
        p, c = self.scale, self.c
        x = self.expand(x).reshape(B, H, W, p, p, c).permute(0, 1, 3, 2, 4, 5)
        return self.norm(x.reshape(B, p * H, p * W, c))


class _V0Block(nn.Module):
    """LN (eps 1e-5) -> SS2D v0 (fp32 scan, z gate) -> DropPath residual."""

    def __init__(self, dim: int, drop_path: float = 0.0, d_state: int = 16):
        super().__init__()
        self.ln_1 = LayerNorm(dim, eps=1e-5)
        self.self_attention = SS2D(dim, d_state=d_state, expand=2.0, forward_type="v0")
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return x + self.drop_path(self.self_attention(self.ln_1(x)), generator)


def _patch_embed(in_channels: int, dim: int) -> Conv:
    """The stride-4 4x4 patch embed, with torch's bias init (a zero bias
    would hand the LayerNorm after it exactly-zero vectors over padding)."""
    return Conv(in_channels, dim, 4, 4, padding=0, torch_bias=True)


def _linspace(rate: float, n: int) -> List[float]:
    return [float(v) for v in np.linspace(0, rate, n)]


class VSSM(nn.Module):
    """The VMamba encoder: patch embed + LN, stages of VSSBlocks with
    stride-2 patch merging between them. Returns each stage's output."""

    def __init__(self, in_channels: int, depths: Sequence[int] = (2, 2, 9, 2),
                 dims: Sequence[int] = (96, 192, 384, 768), d_state: int = 16,
                 drop_path_rate: float = 0.1, forward_type: str = "v2"):
        super().__init__()
        self.depths = list(depths)
        self.patch_embed = _patch_embed(in_channels, dims[0])
        self.patch_norm = LayerNorm(dims[0])
        dpr = _linspace(drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", VSSBlock(
                    dims[i], dpr[sum(depths[:i]) + b], d_state, forward_type=forward_type))
            if i < len(depths) - 1:
                self.add_module(f"merge{i}", PatchMerging2D(dims[i], dims[i + 1]))

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        x = self.patch_norm(self.patch_embed(x))
        outs = []
        for i, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x, generator)
            outs.append(x)
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge{i}")(x)
        return outs


class VMUNet(nn.Module):
    """VM-UNet (``vmamba.py:134-199``): patch-4 embed, encoder stages of
    v0 blocks with merging at each stage's end, decoder stages that add the
    skip taken at the encoder stage's input and upsample first, then run
    their blocks; one x4 final expand and a 1x1 conv. No deep supervision."""

    def __init__(self, in_channels: int, num_classes: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 depths_decoder: Sequence[int] = (2, 2, 2, 1),
                 dims: Sequence[int] = (96, 192, 384, 768), d_state: int = 16,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.depths, self.depths_decoder = list(depths), list(depths_decoder)
        n = len(depths)
        self.patch_embed = _patch_embed(in_channels, dims[0])
        self.patch_norm = LayerNorm(dims[0], eps=1e-5)
        dpr = _linspace(drop_path_rate, sum(depths))
        dpr_dec = _linspace(drop_path_rate, sum(depths_decoder))[::-1]
        for i, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"layer{i}_block{b}",
                                _V0Block(dims[i], dpr[sum(depths[:i]) + b], d_state))
            if i < n - 1:
                self.add_module(f"downsample{i}", PatchMerging2D(dims[i], dims[i + 1]))
        dims_dec = list(dims)[::-1]
        for i, depth in enumerate(depths_decoder):
            if i > 0:
                self.add_module(f"up{i}", PatchExpand2D(dims_dec[i - 1], dims_dec[i]))
            for b in range(depth):
                self.add_module(f"uplayer{i}_block{b}", _V0Block(
                    dims_dec[i], dpr_dec[sum(depths_decoder[:i]) + b], d_state))
        self.final_up = _FinalExpand(dims[0], 4 * dims[0], 4)
        self.final_conv = Conv(dims[0] // 4, num_classes, 1)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = len(self.depths)
        x = self.patch_norm(self.patch_embed(x))
        skips = []
        for i, depth in enumerate(self.depths):
            skips.append(x)
            for b in range(depth):
                x = getattr(self, f"layer{i}_block{b}")(x, generator)
            if i < n - 1:
                x = getattr(self, f"downsample{i}")(x)
        for i, depth in enumerate(self.depths_decoder):
            if i > 0:
                x = getattr(self, f"up{i}")(x + skips[n - i])
            for b in range(depth):
                x = getattr(self, f"uplayer{i}_block{b}")(x, generator)
        return self.final_conv(self.final_up(x))


class MambaUNet(nn.Module):
    """Mamba-UNet (``vmamba.py:202-274``): patch-4 embed, encoder with
    end-of-stage merging and a bottleneck LN; a decoder that concatenates
    each skip, projects back (``concat_back{i}``), runs its blocks and then
    upsamples, with drop-path rates reusing the encoder's; a final LN, a x4
    expand keeping ``dims[0]`` channels and a bias-free 1x1 conv."""

    def __init__(self, in_channels: int, num_classes: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768), d_state: int = 16,
                 drop_path_rate: float = 0.2):
        super().__init__()
        self.depths = list(depths)
        n = len(depths)
        self.patch_embed = _patch_embed(in_channels, dims[0])
        self.patch_norm = LayerNorm(dims[0], eps=1e-5)
        dpr = _linspace(drop_path_rate, sum(depths))
        for i, depth in enumerate(depths):
            for b in range(depth):
                self.add_module(f"layer{i}_block{b}",
                                _V0Block(dims[i], dpr[sum(depths[:i]) + b], d_state))
            if i < n - 1:
                self.add_module(f"downsample{i}", PatchMerging2D(dims[i], dims[i + 1]))
        self.norm = LayerNorm(dims[n - 1], eps=1e-5)
        self.up0 = PatchExpand2D(dims[n - 1], dims[n - 1] // 2)
        for i in range(1, n):
            width = dims[n - 1 - i]
            self.add_module(f"concat_back{i}", Dense(dims[n - i] // 2 + width, width))
            for b in range(depths[n - 1 - i]):
                self.add_module(f"uplayer{i}_block{b}", _V0Block(
                    width, dpr[sum(depths[:n - 1 - i]) + b], d_state))
            if i < n - 1:
                self.add_module(f"up{i}", PatchExpand2D(width, width // 2))
        self.norm_up = LayerNorm(dims[0], eps=1e-5)
        self.up = _FinalExpand(dims[0], 16 * dims[0], 4)
        self.output = Conv(dims[0], num_classes, 1, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n = len(self.depths)
        x = self.patch_norm(self.patch_embed(x))
        skips = []
        for i, depth in enumerate(self.depths):
            skips.append(x)
            for b in range(depth):
                x = getattr(self, f"layer{i}_block{b}")(x, generator)
            if i < n - 1:
                x = getattr(self, f"downsample{i}")(x)
        x = self.up0(self.norm(x))
        for i in range(1, n):
            x = getattr(self, f"concat_back{i}")(torch.cat([x, skips[n - 1 - i]], dim=-1))
            for b in range(self.depths[n - 1 - i]):
                x = getattr(self, f"uplayer{i}_block{b}")(x, generator)
            if i < n - 1:
                x = getattr(self, f"up{i}")(x)
        return self.output(self.up(self.norm_up(x)))


def build_seeded(model: nn.Module, seed: int, device: DeviceLike) -> nn.Module:
    """``model`` with the JAX package's init distributions drawn from
    ``torch.Generator().manual_seed(seed)``, fp32, in eval mode on
    ``device`` (the GPU unless the caller passes another)."""
    dev = resolve_device(device)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
