"""MLLA-UNet, channels-last: linear attention with RoPE in a symmetric U.

Counterpart of ``mlagg_unet_tpu/models/mlla_unet.py`` (the "Demystify
Mamba" MLLA block of the reference baseline): a conv-BatchNorm stem (/4),
four encoder stages of depths (2, 4, 8, 4) of ``MLLABlockLinear`` with
conv patch merging between them, skips taken at each stage's input; a
decoder of conv patch expanding (a depthwise transposed conv), the skip
concatenated and fused by a Dense (``concat_back``), depths (1, 2, 2, 2); a
16x linear expand with a 4x4 pixel shuffle and a bias-free 1x1 head. No
deep supervision; LayerNorm and BatchNorm at eps 1e-5, BatchNorm's running
statistics updated in training mode with the biased variance, as flax's.

``LinearAttention``: q and k through ELU + 1; RoPE (the y angles first, then
the x angles; interleaved pairs rotated in fp32, cast back) on both; the
normaliser z = 1 / (q . mean(k) + 1e-6) from the k without RoPE; the RoPE'd
k and v each scaled by n^-1/2 before their product; plus a depthwise 3x3
``lepe`` of v. This block is not the flagship's ``MLLABlock`` and runs none
of the port's kernels. Submodules carry the flax scope names
(``layer0_block1.attn.qk``, ``down0.conv_1``, ``layer_up1_upsample.deconv``,
``concat_back2``...); stochastic depth draws from the ``generator`` the
forward takes.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import (
    BatchNorm,
    Conv,
    ConvTransposeTorch,
    Dense,
    DropPath,
    DWConv2d,
    LayerNorm,
    PointwiseConv,
)
from mlagg_unet_torch.models.vmamba import Mlp

_EPS = 1e-5   # torch's LayerNorm / BatchNorm2d default, as the reference takes them


@functools.lru_cache(maxsize=32)
def rope_rotations(h: int, w: int, dim: int, base: float = 10000.0) -> np.ndarray:
    """(h, w, dim / 2, 2) cos / sin table: dim / 4 frequencies, the y angles
    first, then the x angles."""
    k_max = dim // 4
    theta = 1.0 / (base ** (np.arange(k_max) / k_max))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    angles = np.concatenate([ys[..., None] * theta, xs[..., None] * theta], axis=-1)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def apply_rope(x: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """x (b, h, w, c), rot (h, w, c / 2, 2): each interleaved pair of
    channels rotated as a complex number, in fp32, cast back to x's dtype."""
    b, h, w, c = x.shape
    xf = x.float().reshape(b, h, w, c // 2, 2)
    x0, x1 = xf[..., 0], xf[..., 1]
    cos, sin = rot[..., 0], rot[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.reshape(b, h, w, c).to(x.dtype)


class LinearAttention(nn.Module):
    """Linear attention with RoPE and LePE on (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qk = Dense(dim, 2 * dim, bias=qkv_bias)
        self.lepe = DWConv2d(dim)

    def forward(self, x):
        B, H, W, C = x.shape
        n, nh = H * W, self.num_heads
        hd = C // nh
        q, k = self.qk(x).chunk(2, dim=-1)
        v = x
        q, k = F.elu(q) + 1.0, F.elu(k) + 1.0
        rot = torch.from_numpy(rope_rotations(H, W, C)).to(x.device)
        q_rope, k_rope = apply_rope(q, rot), apply_rope(k, rot)

        def heads(t):   # (B, H, W, C) -> (B, nh, n, hd)
            return t.reshape(B, n, nh, hd).transpose(1, 2)

        qh, kh, vh = heads(q), heads(k), heads(v)
        k_mean = kh.mean(dim=2, keepdim=True)                       # (B, nh, 1, hd)
        z = 1.0 / (qh @ k_mean.transpose(-2, -1) + 1e-6)            # (B, nh, n, 1)
        kv = (heads(k_rope) * n ** -0.5).transpose(-2, -1) @ (vh * n ** -0.5)
        out = (heads(q_rope) @ kv) * z                              # (B, nh, n, hd)
        return out.transpose(1, 2).reshape(B, H, W, C) + self.lepe(v)


class MLLABlockLinear(nn.Module):
    """cpe1 -> LN -> (SiLU(act_proj) gate) * LinearAttention(SiLU(dwc(in_proj)))
    -> out_proj -> DropPath residual; cpe2; LN -> MLP -> DropPath residual."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path: float = 0.0):
        super().__init__()
        self.cpe1 = DWConv2d(dim)
        self.norm1 = LayerNorm(dim, eps=_EPS)
        self.act_proj = Dense(dim, dim)
        self.in_proj = Dense(dim, dim)
        self.dwc = DWConv2d(dim)
        self.attn = LinearAttention(dim, num_heads, qkv_bias)
        self.out_proj = Dense(dim, dim)
        self.drop_path = DropPath(drop_path)
        self.cpe2 = DWConv2d(dim)
        self.norm2 = LayerNorm(dim, eps=_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.cpe1(x)
        h = self.norm1(x)
        act_res = F.silu(self.act_proj(h))
        h = self.attn(F.silu(self.dwc(self.in_proj(h))))
        x = x + self.drop_path(self.out_proj(h * act_res), generator)
        x = x + self.cpe2(x)
        return x + self.drop_path(self.mlp(self.norm2(x)), generator)


class ConvLayer(nn.Module):
    """Conv (symmetric padding) [-> BatchNorm] [-> ReLU]."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, groups: int = 1, bias: bool = True,
                 bn: bool = True, act: bool = True):
        super().__init__()
        self.act = act
        self.conv = Conv(in_channels, out_channels, kernel_size, stride, padding, groups,
                         bias=bias)
        self.norm = BatchNorm(out_channels, eps=_EPS) if bn else None

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        return F.relu(x) if self.act else x


class StemMLLAUNet(nn.Module):
    """/2 conv-BN-ReLU, a residual pair of 3x3 conv-BNs, /2 conv to 4e and a
    1x1 projection to e: stride 4 in all."""

    def __init__(self, in_channels: int, embed_dim: int):
        super().__init__()
        e = embed_dim
        self.conv1 = ConvLayer(in_channels, e // 2, 3, 2, 1, bias=False)
        self.conv2_0 = ConvLayer(e // 2, e // 2, 3, 1, 1, bias=False)
        self.conv2_1 = ConvLayer(e // 2, e // 2, 3, 1, 1, bias=False, act=False)
        self.conv3_0 = ConvLayer(e // 2, 4 * e, 3, 2, 1, bias=False)
        self.conv3_1 = ConvLayer(4 * e, e, 1, 1, 0, bias=False, act=False)

    def forward(self, x):
        x = self.conv1(x)
        x = self.conv2_1(self.conv2_0(x)) + x
        return self.conv3_1(self.conv3_0(x))


class PatchMergingConv(nn.Module):
    """1x1 expand to ``ratio`` x out -> depthwise 3x3 stride 2 -> 1x1
    projection + BN: ``out_features`` channels at half the resolution."""

    def __init__(self, dim: int, out_features: int, ratio: float = 4.0):
        super().__init__()
        hidden = int(out_features * ratio)
        self.conv_0 = ConvLayer(dim, hidden, 1, bn=False)
        self.conv_1 = ConvLayer(hidden, hidden, 3, 2, 1, groups=hidden, bn=False)
        self.conv_2 = ConvLayer(hidden, out_features, 1, act=False)

    def forward(self, x):
        return self.conv_2(self.conv_1(self.conv_0(x)))


class PatchExpandConv(nn.Module):
    """1x1 expand to ``ratio`` x dim -> depthwise bias-free transposed 3x3
    stride 2 (padding 1, output padding 1: 2x) -> 1x1 projection + BN -> LN:
    ``out_features`` channels at twice the resolution."""

    def __init__(self, dim: int, out_features: int, ratio: float = 4.0):
        super().__init__()
        hidden = int(dim * ratio)
        self.conv_0 = ConvLayer(dim, hidden, 1, bn=False)
        self.deconv = ConvTransposeTorch(hidden, hidden, 3, 2, padding=1, output_padding=1,
                                         groups=hidden, bias=False)
        self.conv_2 = ConvLayer(hidden, out_features, 1, act=False)
        self.norm = LayerNorm(out_features, eps=_EPS)

    def forward(self, x):
        return self.norm(self.conv_2(self.deconv(self.conv_0(x))))


class MLLAUNet(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, num_classes), H and W multiples
    of 4 x 2^(stages - 1)."""

    def __init__(self, in_channels: int, num_classes: int, embed_dim: int = 64,
                 depths: Sequence[int] = (2, 4, 8, 4),
                 depths_decoder: Sequence[int] = (1, 2, 2, 2),
                 num_heads: Sequence[int] = (2, 4, 8, 16), mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_path_rate: float = 0.1):
        super().__init__()
        e, nl = embed_dim, len(depths)
        dims = [e * 2 ** i for i in range(nl)]
        self.nl, self.depths, self.depths_decoder = nl, tuple(depths), tuple(depths_decoder)
        dpr = [float(v) for v in np.linspace(0, drop_path_rate, sum(depths))]
        self.patch_embed = StemMLLAUNet(in_channels, e)
        for i in range(nl):
            for b in range(depths[i]):
                self.add_module(f"layer{i}_block{b}", MLLABlockLinear(
                    dims[i], num_heads[i], mlp_ratio, qkv_bias, dpr[sum(depths[:i]) + b]))
            if i < nl - 1:
                self.add_module(f"down{i}", PatchMergingConv(dims[i], dims[i + 1]))
        self.norm = LayerNorm(dims[-1], eps=_EPS)
        self.up0 = PatchExpandConv(dims[-1], dims[nl - 2])
        for j in range(1, nl):
            d = dims[nl - 1 - j]
            self.add_module(f"concat_back{j}", Dense(2 * d, d))
            dpr_slice = dpr[sum(depths[:nl - 1 - j]):sum(depths[:nl - j])]
            for b in range(depths_decoder[j]):
                self.add_module(f"layer_up{j}_block{b}", MLLABlockLinear(
                    d, num_heads[nl - 1 - j], mlp_ratio, qkv_bias, dpr_slice[b]))
            if j < nl - 1:
                self.add_module(f"layer_up{j}_upsample", PatchExpandConv(d, d // 2))
        self.norm_up = LayerNorm(dims[0], eps=_EPS)
        self.up_expand = Dense(dims[0], 16 * dims[0], bias=False)
        self.up_norm = LayerNorm(dims[0], eps=_EPS)
        self.output = PointwiseConv(dims[0], num_classes, bias=False)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        nl = self.nl
        h = self.patch_embed(x)
        skips = []
        for i in range(nl):
            skips.append(h)   # each stage's input
            for b in range(self.depths[i]):
                h = getattr(self, f"layer{i}_block{b}")(h, generator)
            if i < nl - 1:
                h = getattr(self, f"down{i}")(h)
        h = self.up0(self.norm(h))
        for j in range(1, nl):
            h = getattr(self, f"concat_back{j}")(torch.cat([h, skips[nl - 1 - j]], dim=-1))
            for b in range(self.depths_decoder[j]):
                h = getattr(self, f"layer_up{j}_block{b}")(h, generator)
            if j < nl - 1:
                h = getattr(self, f"layer_up{j}_upsample")(h)
        h = self.norm_up(h)
        B, H, W, C = h.shape
        h = self.up_expand(h).reshape(B, H, W, 4, 4, C).permute(0, 1, 3, 2, 4, 5)
        return self.output(self.up_norm(h.reshape(B, 4 * H, 4 * W, C)))
