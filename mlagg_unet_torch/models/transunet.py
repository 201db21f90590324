"""TransUNet (R50-ViT-B/16), channels-last.

Counterpart of ``mlagg_unet_tpu/models/transunet.py``: the hybrid encoder,
a ResNetV2 (units (3, 4, 9), width 64) of weight-standardised convs
(``StdConv``: each output channel's kernel standardised by its mean and
biased variance, eps 1e-5, in fp32, then cast to the input's dtype) and
pre-activation bottlenecks with GroupNorm, the max-pool's off-by-one kept
(only the skip copies are zero-padded to 1/4 and 1/8 of the input); a 1x1
patch conv over the 1/16 map, a learned position embedding of (1, (H/16)
(W/16), 768), 12 ViT blocks (hidden 768, 12 heads, MLP 3072, LayerNorm eps
1e-6); the cup decoder: conv + BatchNorm + ReLU to 512, four 2x bilinear
(align-corners) up blocks, the first three with a skip, and a 3x3 head. No
deep supervision.

The position embedding's shape comes from the input size, as JAX takes it
at init: a network built for a H x W patch runs only on H x W tiles. The
attention is plain PyTorch, as in JAX. Submodules carry the flax scope names
(``hybrid_model.block1_unit1.conv1``, ``encoder_block0.attn.query``,
``decoder_block0.conv1.bn``...); BatchNorm's running statistics are its
``mean`` / ``var`` buffers.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import (
    BatchNorm,
    Conv,
    Dense,
    GroupNorm,
    LayerNorm,
    PointwiseConv,
    _channels_first,
    _channels_last,
    bilinear_ac,
    lecun_normal_,
)
from mlagg_unet_torch.models.vmamba import Mlp


class StdConv(nn.Module):
    """Conv with weight standardisation: the kernel standardised over (in,
    kh, kw) per output channel by its mean and biased variance (eps 1e-5) in
    fp32, then cast to the input's dtype; symmetric padding, no bias by
    default. ``weight`` is (out, in, kh, kw)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, bias: bool = False):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None

    def init_parameters(self, gen):
        lecun_normal_(self.weight, self.weight[0].numel(), gen)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def standardized(self, dtype: torch.dtype) -> torch.Tensor:
        w = self.weight.float()
        var, mean = torch.var_mean(w, (1, 2, 3), correction=0, keepdim=True)
        return ((w - mean) / torch.sqrt(var + 1e-5)).to(dtype)

    def forward(self, x):
        y = F.conv2d(_channels_first(x), self.standardized(x.dtype), None, self.stride,
                     self.padding)
        y = _channels_last(y)
        return y if self.bias is None else y + self.bias.to(y.dtype)


class PreActBottleneck(nn.Module):
    """1x1 -> GN(32) -> ReLU -> 3x3 (stride) -> GN -> ReLU -> 1x1 -> GN, plus
    the input or its projection (a strided 1x1 StdConv and GroupNorm with a
    group a channel at eps 1e-5), then ReLU; the unit's GroupNorms at eps
    1e-6."""

    def __init__(self, in_channels: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.has_proj = stride != 1 or in_channels != cout
        if self.has_proj:
            self.downsample = StdConv(in_channels, cout, 1, stride)
            self.gn_proj = GroupNorm(cout, cout, eps=1e-5)
        self.conv1 = StdConv(in_channels, cmid, 1)
        self.gn1 = GroupNorm(cmid, 32, eps=1e-6)
        self.conv2 = StdConv(cmid, cmid, 3, stride, padding=1)
        self.gn2 = GroupNorm(cmid, 32, eps=1e-6)
        self.conv3 = StdConv(cmid, cout, 1)
        self.gn3 = GroupNorm(cout, 32, eps=1e-6)

    def forward(self, x):
        residual = self.gn_proj(self.downsample(x)) if self.has_proj else x
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        return F.relu(residual + self.gn3(self.conv3(y)))


def max_pool_3x3_valid(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, stride=2, padding=0)`` on channels-last input."""
    return _channels_last(F.max_pool2d(_channels_first(x), 3, 2))


def pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad the bottom and the right of (B, H, W, C) to (h, w)."""
    ph, pw = h - x.shape[1], w - x.shape[2]
    return x if ph == 0 and pw == 0 else F.pad(x, (0, 0, 0, pw, 0, ph))


class ResNetV2(nn.Module):
    """The root (7x7 StdConv stride 2, GN, ReLU), the 3x3 max-pool, then
    ``block_units`` bottlenecks per block (the first of blocks 2 and 3 at
    stride 2). Returns the 1/16 map and the skips [1/8, 1/4, 1/2], the first
    two zero-padded to in // 4 // (b + 1); the map itself is not."""

    def __init__(self, in_channels: int, block_units: Sequence[int] = (3, 4, 9),
                 width: int = 64):
        super().__init__()
        w = width
        self.units = tuple(block_units)
        self.root_conv = StdConv(in_channels, w, 7, 2, padding=3)
        self.root_gn = GroupNorm(w, 32, eps=1e-6)
        couts, cmids = (4 * w, 8 * w, 16 * w), (w, 2 * w, 4 * w)
        cin = w
        for b, n_units in enumerate(block_units):
            for u in range(n_units):
                self.add_module(f"block{b + 1}_unit{u + 1}", PreActBottleneck(
                    cin, couts[b], cmids[b], stride=2 if (u == 0 and b > 0) else 1))
                cin = couts[b]

    def forward(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        in_h, in_w = x.shape[1:3]
        x = F.relu(self.root_gn(self.root_conv(x)))
        features = [x]
        x = max_pool_3x3_valid(x)
        for b, n_units in enumerate(self.units):
            for u in range(n_units):
                x = getattr(self, f"block{b + 1}_unit{u + 1}")(x)
            if b < len(self.units) - 1:
                features.append(pad_to(x, in_h // 4 // (b + 1), in_w // 4 // (b + 1)))
        return x, features[::-1]


class ViTAttention(nn.Module):
    """Multi-head self-attention: query, key, value and out Denses, the
    scores divided by sqrt(head dim) in at least fp32, softmax over the
    keys."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query, self.key, self.value = Dense(dim, dim), Dense(dim, dim), Dense(dim, dim)
        self.out = Dense(dim, dim)

    def forward(self, x):
        B, N, C = x.shape
        h, hd = self.num_heads, C // self.num_heads

        def split(t):
            return t.reshape(B, N, h, hd).transpose(1, 2)

        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        # JAX divides by an fp32 numpy scalar, which promotes bf16 scores: from
        # here on a bf16 network computes in fp32
        scores = q @ k.transpose(-2, -1)
        scores = scores.to(torch.promote_types(scores.dtype, torch.float32)) / math.sqrt(hd)
        probs = torch.softmax(scores, dim=-1)
        return self.out((probs @ v.to(probs.dtype)).transpose(1, 2).reshape(B, N, C))


class ViTBlock(nn.Module):
    """Pre-norm (eps 1e-6) attention and MLP, each residual."""

    def __init__(self, dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.attention_norm = LayerNorm(dim)
        self.attn = ViTAttention(dim, num_heads)
        self.ffn_norm = LayerNorm(dim)
        self.ffn = Mlp(dim, mlp_dim)

    def forward(self, x):
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Conv2dReLU(nn.Module):
    """Conv (no bias) -> BatchNorm (eps 1e-5, momentum 0.9) -> ReLU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, kernel_size, padding=padding, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class DecoderBlock(nn.Module):
    """2x bilinear (align corners), the skip concatenated, two Conv2dReLU."""

    def __init__(self, in_channels: int, out_channels: int, skip_channels: int = 0):
        super().__init__()
        self.conv1 = Conv2dReLU(in_channels + skip_channels, out_channels)
        self.conv2 = Conv2dReLU(out_channels, out_channels)

    def forward(self, x, skip: Optional[torch.Tensor] = None):
        x = bilinear_ac(x)
        if skip is not None:
            x = torch.cat([x, skip], dim=-1)
        return self.conv2(self.conv1(x))


class TransUNet(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, num_classes) for the ``img_size``
    (H, W) it is built for (multiples of 16)."""

    def __init__(self, in_channels: int, num_classes: int, img_size: Sequence[int] = (224, 224),
                 hidden_size: int = 768, mlp_dim: int = 3072, num_heads: int = 12,
                 num_layers: int = 12, resnet_units: Sequence[int] = (3, 4, 9), width: int = 64,
                 decoder_channels: Sequence[int] = (256, 128, 64, 16), n_skip: int = 3):
        super().__init__()
        self.grid = (int(img_size[0]) // 16, int(img_size[1]) // 16)
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.decoder_channels, self.n_skip = tuple(decoder_channels), n_skip
        self.hybrid_model = ResNetV2(in_channels, resnet_units, width)
        self.patch_embeddings = PointwiseConv(16 * width, hidden_size)
        self.position_embeddings = nn.Parameter(
            torch.empty(1, self.grid[0] * self.grid[1], hidden_size))
        for i in range(num_layers):
            self.add_module(f"encoder_block{i}", ViTBlock(hidden_size, num_heads, mlp_dim))
        self.encoder_norm = LayerNorm(hidden_size)
        self.conv_more = Conv2dReLU(hidden_size, 512)
        skip_channels = (8 * width, 4 * width, width)
        cin = 512
        for i, ch in enumerate(decoder_channels):
            skip = skip_channels[i] if i < n_skip else 0
            self.add_module(f"decoder_block{i}", DecoderBlock(cin, ch, skip))
            cin = ch
        self.seg_head = Conv(cin, num_classes, 3, padding=1)

    def init_parameters(self, gen):
        with torch.no_grad():
            self.position_embeddings.zero_()

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if tuple(x.shape[1:3]) != (16 * self.grid[0], 16 * self.grid[1]):
            raise ValueError(f"TransUNet built for {16 * self.grid[0]}x{16 * self.grid[1]} "
                             f"tiles (its position embedding) got {tuple(x.shape[1:3])}")
        h, skips = self.hybrid_model(x)
        h = self.patch_embeddings(h)
        B = h.shape[0]
        h = h.reshape(B, self.grid[0] * self.grid[1], self.hidden_size) + self.position_embeddings
        for i in range(self.num_layers):
            h = getattr(self, f"encoder_block{i}")(h)
        h = self.encoder_norm(h).reshape(B, *self.grid, self.hidden_size)
        h = self.conv_more(h)
        for i in range(len(self.decoder_channels)):
            h = getattr(self, f"decoder_block{i}")(h, skips[i] if i < self.n_skip else None)
        return self.seg_head(h)
