"""SwinUNETR (2-D) and the Swin stages of Swin-TUNet, channels-last.

Counterparts of ``mlagg_unet_tpu/models/swin_unetr.py``: monai's SwinUNETR
(feature size 96, patch 2, window 7, depths (2, 2, 2, 2), heads (3, 6, 12,
24)) with the swin internals of the reference's vendored monai code: the
window clamped to the feature map per axis, the shift zeroed on clamped
axes; pad to the window, cyclic shift and the additive -100 region mask;
the relative-position bias of the configured window indexed [:N, :N]; a
patch merge (``PatchMergingV2``: the 2x2 neighbourhood in monai's order
[h0w0, h1w0, h0w1, h1w1]) after every stage; the parameter-free channel
LayerNorm (two-pass variance, eps 1e-5) on every hidden state; the UNETR
encoder and decoder blocks of ``unetr_blocks.py``. ``SwinStage`` and
``PatchMergingSwin`` (the swin-v1 merge, [h0w0, h0w1, h1w0, h1w1], LayerNorm
at flax's eps 1e-6) are Swin-TUNet's (``more_variants.py``).

The attention is plain PyTorch, as in JAX, which computes it outside any
Pallas kernel. The patch embed is a stride-2 2x2 conv with torch's bias
init; flax's SAME padding is no padding there, on the even inputs the
network takes. Submodules carry the flax scope names (``swinViT.layers1.
blocks0.attn.qkv``, ``decoder5.transp_conv``...), so
``weights.jax_params_to_state_dict`` only changes layouts.
"""
from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import Conv, Dense, LayerNorm, PointwiseConv
from mlagg_unet_torch.models.unetr_blocks import UnetrBasicBlock, UnetrUpBlock
from mlagg_unet_torch.models.vmamba import Mlp

IntOr2 = Union[int, Sequence[int]]


def _pair(v: IntOr2) -> Tuple[int, int]:
    return tuple(int(i) for i in v) if isinstance(v, (tuple, list)) else (int(v), int(v))


def window_partition(x: torch.Tensor, ws: IntOr2) -> torch.Tensor:
    """(B, H, W, C) -> (B * windows, ws0 * ws1, C)."""
    ws = _pair(ws)
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws[0], ws[0], W // ws[1], ws[1], C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws[0] * ws[1], C)


def window_reverse(win: torch.Tensor, ws: IntOr2, H: int, W: int) -> torch.Tensor:
    ws = _pair(ws)
    B = win.shape[0] // ((H // ws[0]) * (W // ws[1]))
    x = win.reshape(B, H // ws[0], W // ws[1], ws[0], ws[1], -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, -1)


def rel_pos_index(ws: Sequence[int]) -> np.ndarray:
    """The relative-position index of a ws0 x ws1 window ((N, N), N = ws0 ws1)."""
    coords = np.stack(np.meshgrid(np.arange(ws[0]), np.arange(ws[1]),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 0] *= 2 * ws[1] - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=64)
def shift_mask(dims: Tuple[int, int], ws: Tuple[int, int], ss: Tuple[int, int]) -> np.ndarray:
    """The additive mask (windows, N, N) of shifted windows on a padded map
    of ``dims``: -100 between regions the roll brought together, 0 within
    one (monai's ``compute_mask``)."""
    img = np.zeros(dims, np.float32)
    segs = [(slice(0, -w), slice(-w, -s), slice(-s, None)) if s > 0 else (slice(None),)
            for w, s in zip(ws, ss)]
    cnt = 0
    for h in segs[0]:
        for w in segs[1]:
            img[h, w] = cnt
            cnt += 1
    win = (img.reshape(dims[0] // ws[0], ws[0], dims[1] // ws[1], ws[1])
           .transpose(0, 2, 1, 3).reshape(-1, ws[0] * ws[1]))
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


class WindowAttention(nn.Module):
    """Window attention with a relative-position bias. The table and index
    are those of the configured window; a window clamped to a smaller map
    takes the index's top-left N x N block, as monai's does."""

    def __init__(self, dim: int, num_heads: int, window_size: IntOr2):
        super().__init__()
        ws = _pair(window_size)
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * ws[0] - 1) * (2 * ws[1] - 1), num_heads))
        self.register_buffer("index", torch.from_numpy(rel_pos_index(ws)), persistent=False)
        self.proj = Dense(dim, dim)

    def init_parameters(self, gen):
        with torch.no_grad():  # flax's truncated_normal(0.02): cut at 2 sigma
            nn.init.trunc_normal_(self.relative_position_bias_table, 0.0, 0.02, -0.04, 0.04,
                                  generator=gen)

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        Bn, N, C = x.shape
        h = self.num_heads
        hd = C // h
        q, k, v = self.qkv(x).reshape(Bn, N, 3, h, hd).permute(2, 0, 3, 1, 4)
        attn = (q * hd ** -0.5) @ k.transpose(-2, -1)
        idx = self.index[:N, :N].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, h).permute(2, 0, 1)
        attn = attn + bias[None]
        if mask is not None:   # an fp32 mask promotes a bf16 window to fp32, as in JAX
            nw = mask.shape[0]
            attn = (attn.reshape(Bn // nw, nw, h, N, N) + mask[None, :, None]
                    ).reshape(Bn, h, N, N)
        out = (torch.softmax(attn, dim=-1) @ v.to(attn.dtype)).transpose(1, 2)
        return self.proj(out.reshape(Bn, N, C))


class SwinBlock(nn.Module):
    """LN (eps 1e-5) -> pad to the window, (shift, mask) window attention,
    (shift back), crop -> residual; LN -> MLP -> residual."""

    def __init__(self, dim: int, num_heads: int, window_size: IntOr2 = 7,
                 shift: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = _pair(window_size), shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x):
        B, H, W, C = x.shape
        dims, cfg = (H, W), self.window_size
        ws = tuple(min(w, d) for w, d in zip(cfg, dims))
        ss = tuple(0 if dims[i] <= cfg[i] or not self.shift else cfg[i] // 2 for i in range(2))
        h = self.norm1(x)
        pads = [(w - d % w) % w for d, w in zip(dims, ws)]
        h = F.pad(h, (0, 0, 0, pads[1], 0, pads[0]))
        hp, wp = h.shape[1:3]
        mask = None
        if any(ss):
            h = torch.roll(h, shifts=(-ss[0], -ss[1]), dims=(1, 2))
            mask = torch.from_numpy(shift_mask((hp, wp), ws, ss)).to(h.device)
        h = window_reverse(self.attn(window_partition(h, ws), mask), ws, hp, wp)
        if any(ss):
            h = torch.roll(h, shifts=ss, dims=(1, 2))
        x = x + h[:, :H, :W]
        return x + self.mlp(self.norm2(x))


def _pad_even(x: torch.Tensor) -> torch.Tensor:
    """Pad an odd height or width of (B, H, W, C) by one row at the end."""
    H, W = x.shape[1:3]
    return F.pad(x, (0, 0, 0, W % 2, 0, H % 2)) if H % 2 or W % 2 else x


class PatchMergingV2(nn.Module):
    """monai's PatchMergingV2 in 2-D: the 2x2 neighbourhood concatenated in
    the order [h0w0, h1w0, h0w1, h1w1], LN (eps 1e-5) over 4C, a bias-free
    Dense to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=1e-5)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = _pad_even(x)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))


class BasicLayer(nn.Module):
    """``depth`` blocks (the odd ones shifted), then a patch merge."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: IntOr2 = 7,
                 downsample: bool = True):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"blocks{i}", SwinBlock(dim, num_heads, window_size, shift=i % 2 == 1))
        self.downsample = PatchMergingV2(dim) if downsample else None

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"blocks{i}")(x)
        return x if self.downsample is None else self.downsample(x)


def proj_out(x: torch.Tensor) -> torch.Tensor:
    """monai's parameter-free channel LayerNorm (two-pass variance, eps 1e-5)."""
    var, mean = torch.var_mean(x, -1, correction=0, keepdim=True)
    return (x - mean) / torch.sqrt(var + 1e-5)


class SwinViT(nn.Module):
    """The patch embed (2x2 conv, stride 2), then four stages that each end
    with a patch merge; the five hidden states, each through ``proj_out``."""

    def __init__(self, in_channels: int, embed_dim: int, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: IntOr2 = 7):
        super().__init__()
        self.n = len(depths)
        self.patch_embed = Conv(in_channels, embed_dim, 2, 2, 0, torch_bias=True)
        for i, (dep, nh) in enumerate(zip(depths, num_heads)):
            self.add_module(f"layers{i + 1}", BasicLayer(embed_dim * 2 ** i, dep, nh, window_size))

    def forward(self, x):
        h = self.patch_embed(x)
        hidden = [proj_out(h)]
        for i in range(self.n):
            h = getattr(self, f"layers{i + 1}")(h)
            hidden.append(proj_out(h))
        return hidden


class SwinUNETR(nn.Module):
    """monai's SwinUNETR wiring: (B, H, W, in_channels) -> (B, H, W,
    num_classes). ``encoder1``-``encoder4`` on the input and the first
    three hidden states, ``encoder10`` on the 16 fs bottleneck,
    ``decoder5``-``decoder1``, a 1x1 head. No deep supervision."""

    def __init__(self, in_channels: int, num_classes: int, feature_size: int = 96,
                 depths: Sequence[int] = (2, 2, 2, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: IntOr2 = 7):
        super().__init__()
        fs = feature_size
        self.swinViT = SwinViT(in_channels, fs, depths, num_heads, window_size)
        self.encoder1 = UnetrBasicBlock(in_channels, fs)
        self.encoder2 = UnetrBasicBlock(fs, fs)
        self.encoder3 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder4 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs, fs)
        self.out = PointwiseConv(fs, num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hidden = self.swinViT(x)
        enc0 = self.encoder1(x)
        enc1 = self.encoder2(hidden[0])
        enc2 = self.encoder3(hidden[1])
        enc3 = self.encoder4(hidden[2])
        d3 = self.decoder5(self.encoder10(hidden[4]), hidden[3])
        d0 = self.decoder2(self.decoder3(self.decoder4(d3, enc3), enc2), enc1)
        return self.out(self.decoder1(d0, enc0))


# ---------------------------------------------------------------- Swin-TUNet's pieces

class SwinStage(nn.Module):
    """``depth`` blocks (the odd ones shifted), no merge."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: IntOr2 = 7):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", SwinBlock(dim, num_heads, window_size, shift=i % 2 == 1))

    def forward(self, x):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x)
        return x


class PatchMergingSwin(nn.Module):
    """The swin-v1 merge: the 2x2 neighbourhood in the order [h0w0, h0w1,
    h1w0, h1w1] (a reshape and transpose), LN at flax's eps 1e-6, a
    bias-free Dense to 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        x = _pad_even(x)
        B, H, W, C = x.shape
        x = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
        return self.reduction(self.norm(x.reshape(B, H // 2, W // 2, 4 * C)))
