"""VM-UNet-3D (``VSSM_UNETR``) and its 12-direction SS3D cell, channels-last.

Counterparts of ``mlagg_unet_tpu/models/vmunet3d.py``:

* ``scan12_3d`` / ``merge12_3d`` (``:42``, ``:54``): the six axis orders of
  (D, H, W) as raster scans, then the same six reversed, stacked as the
  scan's 12 groups (B, 12, C, L); the merge undoes each path and sums them;
* ``SS3D12`` (``:72-136``): in_proj (with or without the z half), a
  depthwise 3x3x3 conv + SiLU, the 12-path scan through
  ``ops.selective_scan_cuda.selective_scan_fwd`` (K1 on the GPU, K5 behind
  autograd), the merge, LayerNorm (eps 1e-5), the SiLU(z) gate and out_proj;
* ``ConvGLU3D``, ``PlainMlp3D`` and ``VSSBlock3D`` (``:139-197``);
* the shifted-window transformer bottleneck of the SwinT variant
  (``:200-336``): plain attention in JAX too, so plain torch here, with the
  window clamped to the feature map, the padding, the shift mask and the
  relative-position table of the configured window sliced to the runtime
  one, as monai does;
* ``PatchEmbed3D``, ``PatchMerging3D`` (symmetric padding 1), ``VSSM3D``,
  ``ResBlockND``, ``UpBlockND`` (a transposed conv with ``output_padding``:
  exactly the stride times the input) and ``VMUNet3D`` (``:339-504``).

The 12 scans run at ``d_state`` 16 here and at 1 in the SS3D U-Mambas
(``models/umamba.py``). The scan's input is widened to fp32 exactly, as
JAX's scan widens it; its fp32 output promotes the layers after it
(``layers.promote_dtype``), as flax's do. Submodules carry the flax scope
names, so ``weights.jax_params_to_state_dict`` only changes layouts.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.device import DeviceLike
from mlagg_unet_torch.models.layers import (
    Conv,
    ConvTransposeTorch,
    Dense,
    InstanceNorm,
    LayerNorm,
    gelu,
    lecun_normal_,
)
from mlagg_unet_torch.models.mamba_block import _a_log_, _dt_bias_
from mlagg_unet_torch.ops.selective_scan_cuda import selective_scan_fwd

# the six axis orders over (D, H, W): dhw, dwh, hdw, hwd, wdh, whd
AXIS_ORDERS: Tuple[Tuple[int, int, int], ...] = (
    (0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0),
)
K_PATHS = 12
# the most elements of a (b, 12, d, L) scan operand SS3D12 makes at once: a
# larger batch is scanned a slice of samples at a time (U-Mamba Enc SS3D's
# stage 0 at 64x128x128 holds 805M a sample, 3.2 GB in fp32, so a served
# model batch of 8 mirrored tiles would need ~100 GB of them at once)
SCAN_SLICE_ELEMENTS = 2 ** 30


def scan12_3d(x: torch.Tensor) -> torch.Tensor:
    """(B, D, H, W, C) -> (B, 12, C, L): the six axis-order raster scans,
    then their length-reversed counterparts."""
    B, C = x.shape[0], x.shape[-1]
    fwd = torch.stack([x.permute(0, 4, *(1 + a for a in o)).reshape(B, C, -1)
                       for o in AXIS_ORDERS], dim=1)                    # (B, 6, C, L)
    return torch.cat([fwd, fwd.flip(-1)], dim=1)


def merge12_3d(ys: torch.Tensor, D: int, H: int, W: int) -> torch.Tensor:
    """The inverse of ``scan12_3d`` summed over the 12 paths -> (B, C, L),
    in JAX's order of summation."""
    B, _, C, L = ys.shape
    dims = (D, H, W)
    total = ys.new_zeros(B, C, L)
    for half in range(2):
        block = ys[:, 6 * half: 6 * half + 6]
        if half == 1:
            block = block.flip(-1)
        for k, order in enumerate(AXIS_ORDERS):
            y = block[:, k].reshape(B, C, *(dims[a] for a in order))
            inv = np.argsort(order)
            total = total + y.permute(0, 1, *(2 + int(a) for a in inv)).reshape(B, C, L)
    return total


class SS3D12(nn.Module):
    """The 12-direction 3-D selective-scan cell: (B, D, H, W, d_model) ->
    the same. ``no_z`` drops the z half of in_proj and the gate (the
    ``*_woinit_new`` trainers and the SS3D U-Mambas)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 expand: float = 2.0, no_z: bool = False):
        super().__init__()
        self.d_inner = d_inner = int(expand * d_model)
        self.d_state = d_state
        self.dt_rank = r = math.ceil(d_model / 16)
        self.no_z = no_z
        self.in_proj = Dense(d_model, (1 if no_z else 2) * d_inner, bias=False)
        self.conv3d = Conv(d_inner, d_inner, (d_conv,) * 3, groups=d_inner)
        self.x_proj_weight = nn.Parameter(torch.empty(K_PATHS, r + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_PATHS, d_inner, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_PATHS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_PATHS, d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(K_PATHS, d_inner))
        self.out_norm = LayerNorm(d_inner, eps=1e-5)
        self.out_proj = Dense(d_inner, d_model, bias=False)

    def init_parameters(self, gen):
        """flax's lecun normal for x_proj_weight, then the scan's init."""
        w = self.x_proj_weight
        lecun_normal_(w, w.numel() // w.shape[-1], gen)
        with torch.no_grad():
            std = self.dt_rank ** -0.5
            nn.init.uniform_(self.dt_projs_weight, -std, std, generator=gen)
            _dt_bias_(self.dt_projs_bias, gen)
            _a_log_(self.A_logs)
            self.Ds.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The samples of ``x`` are independent: a batch whose scan operands
        would exceed ``SCAN_SLICE_ELEMENTS`` runs a slice at a time."""
        per_sample = K_PATHS * self.d_inner * x[0, ..., 0].numel()
        step = max(1, SCAN_SLICE_ELEMENTS // per_sample)
        if step >= x.shape[0]:
            return self._forward(x)
        return torch.cat([self._forward(x[i:i + step]) for i in range(0, x.shape[0], step)])

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        B, Dz, H, W, _ = x.shape
        d, r, n = self.d_inner, self.dt_rank, self.d_state
        if self.no_z:
            xh, z = self.in_proj(x), None
        else:
            xh, z = self.in_proj(x).chunk(2, dim=-1)
        xs = scan12_3d(F.silu(self.conv3d(xh))).float().contiguous()   # (B, 12, d, L)
        w = self.x_proj_weight.float()
        proj = lambda wk: torch.einsum("bkdl,kcd->bkcl", xs, wk).contiguous()  # noqa: E731
        dts = torch.einsum("bkrl,kdr->bkdl", proj(w[:, :r]),
                           self.dt_projs_weight.float()).contiguous()
        A = -torch.exp(self.A_logs)
        ys = selective_scan_fwd(xs, dts, A, proj(w[:, r:r + n]), proj(w[:, r + n:]),
                                self.Ds, self.dt_projs_bias, delta_softplus=True)
        y = self.out_norm(merge12_3d(ys, Dz, H, W).transpose(1, 2)).reshape(B, Dz, H, W, d)
        if z is not None:
            y = y * F.silu(z)
        return self.out_proj(y)


class ConvGLU3D(nn.Module):
    """ConvolutionalGLU: fc1 -> split (x, v) -> GELU(dwconv3d(x)) * v -> fc2,
    ``hidden = int(2 * hidden_features / 3)``."""

    def __init__(self, dim: int, hidden_features: int):
        super().__init__()
        hidden = int(2 * hidden_features / 3)
        self.fc1 = Dense(dim, 2 * hidden)
        self.dwconv = Conv(hidden, hidden, (3, 3, 3), groups=hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x):
        h, v = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(gelu(self.dwconv(h)) * v)


class PlainMlp3D(nn.Module):
    """monai's MLPBlock: linear1 -> GELU -> linear2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.linear1 = Dense(dim, hidden)
        self.linear2 = Dense(hidden, dim)

    def forward(self, x):
        return self.linear2(gelu(self.linear1(x)))


class VSSBlock3D(nn.Module):
    """LN -> SS3D12 -> residual; LN -> mlp -> residual. ``mlp_type``
    'conv_glu' (VM-UNet-3D, U-Mamba Bot SS3D) or 'plain' (U-Mamba Enc
    SS3D); LayerNorms at eps 1e-5."""

    def __init__(self, dim: int, d_state: int = 16, expand: float = 2.0,
                 mlp_ratio: float = 4.0, no_z: bool = False, mlp_type: str = "conv_glu"):
        super().__init__()
        if mlp_type not in ("conv_glu", "plain"):
            raise ValueError(f"mlp_type {mlp_type!r}: 'conv_glu' or 'plain'")
        self.norm = LayerNorm(dim, eps=1e-5)
        self.self_attention = SS3D12(dim, d_state=d_state, expand=expand, no_z=no_z)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        hidden = int(dim * mlp_ratio)
        self.mlp = PlainMlp3D(dim, hidden) if mlp_type == "plain" else ConvGLU3D(dim, hidden)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = x + self.self_attention(self.norm(x))
        return x + self.mlp(self.norm2(x))


# ---------------------------------------------------------------- shifted windows

def window_partition3d(x: torch.Tensor, ws: Sequence[int]) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * windows, prod(ws), C)."""
    B, D, H, W, C = x.shape
    x = x.reshape(B, D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2], C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws[0] * ws[1] * ws[2], C)


def window_reverse3d(win: torch.Tensor, ws: Sequence[int], D: int, H: int,
                     W: int) -> torch.Tensor:
    B = win.shape[0] // ((D // ws[0]) * (H // ws[1]) * (W // ws[2]))
    x = win.reshape(B, D // ws[0], H // ws[1], W // ws[2], ws[0], ws[1], ws[2], -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(B, D, H, W, -1)


def rel_pos_index3d(ws: Sequence[int]) -> np.ndarray:
    """The relative-position index of a window of ``ws`` (prod(ws) square)."""
    coords = np.stack(np.meshgrid(*(np.arange(w) for w in ws), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws[0] - 1
    rel[:, :, 1] += ws[1] - 1
    rel[:, :, 2] += ws[2] - 1
    rel[:, :, 0] *= (2 * ws[1] - 1) * (2 * ws[2] - 1)
    rel[:, :, 1] *= 2 * ws[2] - 1
    return rel.sum(-1)


def shift_mask3d(dims: Sequence[int], ws: Sequence[int], ss: Sequence[int]) -> np.ndarray:
    """The additive mask (windows, N, N) of shifted windows: -1e9 between
    regions the roll brought together, 0 within one."""
    img = np.zeros((*dims,), np.float32)
    segs = [(slice(0, -w), slice(-w, -s), slice(-s, None)) if s > 0 else (slice(None),)
            for w, s in zip(ws, ss)]
    cnt = 0
    for d in segs[0]:
        for h in segs[1]:
            for w in segs[2]:
                img[d, h, w] = cnt
                cnt += 1
    D, H, W = dims
    win = img.reshape(D // ws[0], ws[0], H // ws[1], ws[1], W // ws[2], ws[2])
    win = win.transpose(0, 2, 4, 1, 3, 5).reshape(-1, ws[0] * ws[1] * ws[2])
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -1e9, 0.0).astype(np.float32)


class WindowAttention3D(nn.Module):
    """Window attention with a relative-position bias. The table and index
    are those of the configured ``window_size``; a window clamped to a
    smaller feature map takes the index's top-left N x N block, as monai's
    does."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int]):
        super().__init__()
        ws = tuple(window_size)
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim)
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * ws[0] - 1) * (2 * ws[1] - 1) * (2 * ws[2] - 1), num_heads))
        self.register_buffer("index", torch.from_numpy(rel_pos_index3d(ws)), persistent=False)
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
        attn = (q @ k.transpose(-2, -1)) * (hd ** -0.5)
        idx = self.index[:N, :N].reshape(-1)
        bias = self.relative_position_bias_table[idx].reshape(N, N, h).permute(2, 0, 1)
        attn = attn + bias[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(Bn // nw, nw, h, N, N) + mask[None, :, None]
                    ).reshape(Bn, h, N, N)
        out = (torch.softmax(attn, dim=-1) @ v.to(attn.dtype)).transpose(1, 2)
        return self.proj(out.reshape(Bn, N, C))


class SwinBlock3D(nn.Module):
    """LN -> (shifted) window attention -> residual; LN -> ConvGLU3D ->
    residual. The window is clamped to the feature map; a shifted block
    shifts by half the window along the axes longer than the configured
    window."""

    def __init__(self, dim: int, num_heads: int, window_size: Sequence[int],
                 shift: bool = False, mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = tuple(window_size), shift
        self.norm1 = LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim, eps=1e-5)
        self.mlp = ConvGLU3D(dim, int(dim * mlp_ratio))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        B, D, H, W, C = x.shape
        dims = (D, H, W)
        ws = [min(w, s) for w, s in zip(self.window_size, dims)]
        ss = [0 if dims[i] <= self.window_size[i] or not self.shift else ws[i] // 2
              for i in range(3)]
        h = self.norm1(x)
        pads = [(w - d % w) % w for d, w in zip(dims, ws)]
        h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        pd, ph, pw = h.shape[1:4]
        mask = None
        if any(ss):
            h = torch.roll(h, shifts=[-s for s in ss], dims=(1, 2, 3))
            mask = torch.from_numpy(shift_mask3d((pd, ph, pw), ws, ss)).to(h.device)
        win = self.attn(window_partition3d(h, ws), mask)
        h = window_reverse3d(win, ws, pd, ph, pw)
        if any(ss):
            h = torch.roll(h, shifts=ss, dims=(1, 2, 3))
        x = x + h[:, :D, :H, :W]
        return x + self.mlp(self.norm2(x))


# ---------------------------------------------------------------- backbone and UNETR

class PatchEmbed3D(nn.Module):
    """Conv (kernel = stride = patch, torch's bias init) -> LN (eps 1e-5)."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: Sequence[int]):
        super().__init__()
        self.proj = Conv(in_channels, embed_dim, tuple(patch_size), tuple(patch_size),
                         padding=0, torch_bias=True)
        self.norm = LayerNorm(embed_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.proj(x))


class PatchMerging3D(nn.Module):
    """Conv (k 3, ``stride``, symmetric padding 1, not SAME) -> LN (eps 1e-5)."""

    def __init__(self, dim: int, out_dim: int, stride: Sequence[int]):
        super().__init__()
        self.reduction = Conv(dim, out_dim, (3, 3, 3), tuple(stride), padding=1)
        self.norm = LayerNorm(out_dim, eps=1e-5)

    def forward(self, x):
        return self.norm(self.reduction(x))


STRIDES = ((2, 4, 4), (2, 2, 2), (2, 2, 2), (1, 2, 2))


class VSSM3D(nn.Module):
    """The 4-stage 3-D VSSM encoder; returns every stage's output. With
    ``last_stage_swin`` the last stage is shifted-window transformer blocks."""

    def __init__(self, in_channels: int, depths: Sequence[int] = (2, 2, 2, 2),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 strides: Sequence[Sequence[int]] = STRIDES, d_state: int = 16,
                 ssm_ratio: float = 2.0, mlp_ratio: float = 4.0,
                 last_stage_swin: bool = False, num_heads: int = 24,
                 window_size: Sequence[int] = (5, 6, 7), no_z: bool = False):
        super().__init__()
        self.depths = list(depths)
        n = len(depths)
        for i in range(n):
            if i == 0:
                self.patch_embed = PatchEmbed3D(in_channels, dims[0], strides[0])
            else:
                self.add_module(f"merge{i}", PatchMerging3D(dims[i - 1], dims[i], strides[i]))
            for j in range(depths[i]):
                block = (SwinBlock3D(dims[i], num_heads, window_size, shift=j % 2 == 1)
                         if last_stage_swin and i == n - 1 else
                         VSSBlock3D(dims[i], d_state=d_state, expand=ssm_ratio,
                                    mlp_ratio=mlp_ratio, no_z=no_z))
                self.add_module(f"stage{i}_block{j}", block)

    def forward(self, x, generator: Optional[torch.Generator] = None) -> List[torch.Tensor]:
        outs = []
        for i, depth in enumerate(self.depths):
            x = self.patch_embed(x) if i == 0 else getattr(self, f"merge{i}")(x)
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x, generator)
            outs.append(x)
        return outs


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class ResBlockND(nn.Module):
    """monai's UnetResBlock: conv -> IN -> lrelu -> conv -> IN, + (a 1x1
    conv -> IN where the width changes) -> lrelu. Two-pass instance norm, as
    the port's U-Nets take it."""

    def __init__(self, in_channels: int, out_channels: int, dim: int = 3,
                 kernel_size: int = 3):
        super().__init__()
        k = (kernel_size,) * dim
        self.conv1 = Conv(in_channels, out_channels, k)
        self.norm1 = InstanceNorm(out_channels, two_pass=True)
        self.conv2 = Conv(out_channels, out_channels, k)
        self.norm2 = InstanceNorm(out_channels, two_pass=True)
        if in_channels != out_channels:
            self.conv3 = Conv(in_channels, out_channels, (1,) * dim)
            self.norm3 = InstanceNorm(out_channels, two_pass=True)

    def forward(self, x):
        out = self.norm2(self.conv2(_lrelu(self.norm1(self.conv1(x)))))
        res = self.norm3(self.conv3(x)) if hasattr(self, "conv3") else x
        return _lrelu(out + res)


class UpBlockND(nn.Module):
    """monai's UnetrUpBlock: a transposed conv with kernel = stride = the
    upsampling, padding (k - 1) // 2 and output padding s + 2p - k (exactly
    s times the input), the skip concatenated, a ``ResBlockND``."""

    def __init__(self, in_channels: int, out_channels: int, upsample_strides: Sequence[int]):
        super().__init__()
        ks = tuple(upsample_strides)
        ps = tuple((k - 1) // 2 for k in ks)
        self.transp_conv = ConvTransposeTorch(in_channels, out_channels, ks, ks, ps,
                                              tuple(s + 2 * p - k for s, p, k in zip(ks, ps, ks)))
        self.conv_block = ResBlockND(2 * out_channels, out_channels, len(ks))

    def forward(self, x, skip):
        return self.conv_block(torch.cat([self.transp_conv(x), skip], dim=-1))


class VMUNet3D(nn.Module):
    """``VSSM_UNETR``: the VSSM3D encoder; UNETR residual conv blocks on the
    raw input and each scale; a transposed-conv decoder; a 1x1 head. No deep
    supervision. ``no_z`` and ``use_encoder5=False`` are the ``*_woinit_new``
    networks; ``last_stage_swin`` their SwinT variant."""

    def __init__(self, in_channels: int, num_classes: int,
                 depths: Sequence[int] = (2, 2, 2, 2), dims: Sequence[int] = (96, 192, 384, 768),
                 strides: Sequence[Sequence[int]] = STRIDES, d_state: int = 16,
                 ssm_ratio: float = 2.0, mlp_ratio: float = 4.0,
                 last_stage_swin: bool = False, num_heads: int = 24,
                 window_size: Sequence[int] = (5, 6, 7), no_z: bool = False,
                 use_encoder5: bool = True):
        super().__init__()
        self.use_encoder5 = use_encoder5
        self.vssm = VSSM3D(in_channels, depths, dims, strides, d_state, ssm_ratio, mlp_ratio,
                           last_stage_swin, num_heads, window_size, no_z)
        self.encoder1 = ResBlockND(in_channels, dims[0])
        self.encoder2 = ResBlockND(dims[0], dims[0])
        self.encoder3 = ResBlockND(dims[1], dims[1])
        self.encoder4 = ResBlockND(dims[2], dims[2])
        if use_encoder5:
            self.encoder5 = ResBlockND(dims[3], dims[3])
        self.decoder4 = UpBlockND(dims[3], dims[2], strides[3])
        self.decoder3 = UpBlockND(dims[2], dims[1], strides[2])
        self.decoder2 = UpBlockND(dims[1], dims[0], strides[1])
        self.decoder1 = UpBlockND(dims[0], dims[0], strides[0])
        self.out = Conv(dims[0], num_classes, (1, 1, 1))

    def forward(self, x, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        feats = self.vssm(x, generator)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(feats[0])
        enc3 = self.encoder3(feats[1])
        enc4 = self.encoder4(feats[2])
        hidden = self.encoder5(feats[3]) if self.use_encoder5 else feats[3]
        h = self.decoder4(hidden, enc4)
        h = self.decoder3(h, enc3)
        h = self.decoder2(h, enc2)
        h = self.decoder1(h, enc1)
        return self.out(h)


def build_vmunet3d(num_input_channels: int, num_output_channels: int, *, swin: bool = False,
                   new: bool = False, seed: int = 0, device: DeviceLike = "cuda",
                   **overrides) -> VMUNet3D:
    """The registry's VM-UNet-3D at its reference widths (``new``: no z gate,
    no encoder5; ``swin``: the SwinT bottleneck), seeded, fp32, in eval mode
    on ``device``."""
    from mlagg_unet_torch.models.vmamba import build_seeded

    kwargs = dict(last_stage_swin=swin, no_z=new, use_encoder5=not new)
    return build_seeded(VMUNet3D(num_input_channels, num_output_channels,
                                 **{**kwargs, **overrides}), seed, device)
