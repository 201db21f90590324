"""The Mamba U-Net variants: SegMamba, LightM-UNet, UltraLight VM-UNet and
nnMamba, channels-last.

Counterparts of ``mlagg_unet_tpu/models/mamba_variants.py``. Every Mamba
layer is ``mamba_block.MambaBlock`` at d_state 16, so every selective scan
runs kernel K1 on the GPU (K5 behind autograd), fp32 as flax promotes it.
The reference's quirks are kept: SegMamba's parameterless InstanceNorms and
its tri-orientated (bimamba v3) Mamba with no residual; LightM-UNet's
depthwise-separable conv whose two convs both take the stride, and its
Mamba layer's one LayerNorm applied twice; UltraLight's one
``MambaBlock(C / 4)`` on each of the four channel quarters; nnMamba's one
``MambaBlock`` on four views of the tokens (as they are, flipped over the
channels, over the sequence, and both), averaged, and one Mamba layer shared
by two blocks of each residual layer (one module, called twice, one
``mamba{idx}`` scope). Submodules carry the flax scope names, so
``weights.jax_params_to_state_dict`` only changes layouts; BatchNorm's
running statistics are buffers (flax's ``batch_stats``). The networks have
no stochastic depth: their forwards take the trainer's ``generator`` and
leave it unused.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

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
    _empty,
    bilinear_ac,
    gelu,
    instance_norm,
    linear_resize,
    max_pool2,
    nearest2,
)
from mlagg_unet_torch.models.mamba_block import MambaBlock
from mlagg_unet_torch.models.unetr_blocks import UnetrBasicBlock, UnetrUpBlock


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, *spatial, C) -> (B, L, C)."""
    return x.reshape(x.shape[0], -1, x.shape[-1])


class _SkipScale(nn.Module):
    """A module owning one ``skip_scale`` parameter (1,), ones at init."""

    def init_parameters(self, gen):
        with torch.no_grad():
            self.skip_scale.fill_(1.0)


# ---------------------------------------------------------------- SegMamba

class GSC(nn.Module):
    """Gated spatial convolution (``:23-41``): a 3^d conv stack and a 1^d
    conv in parallel, summed, a 1^d projection, an outer residual; every
    InstanceNorm parameterless."""

    def __init__(self, channels: int, spatial_dims: int = 3):
        super().__init__()
        k3 = (3,) * spatial_dims
        self.proj = Conv(channels, channels, k3, padding=1)
        self.proj2 = Conv(channels, channels, k3, padding=1)
        self.proj3 = PointwiseConv(channels, channels, spatial_dims=spatial_dims)
        self.proj4 = PointwiseConv(channels, channels, spatial_dims=spatial_dims)

    def forward(self, x):
        x1 = F.relu(instance_norm(self.proj(x)))
        x1 = F.relu(instance_norm(self.proj2(x1)))
        x2 = F.relu(instance_norm(self.proj3(x)))
        return F.relu(instance_norm(self.proj4(x1 + x2))) + x


class SegMambaLayer(nn.Module):
    """LN (eps 1e-5) -> tri-orientated Mamba (bimamba v3 over ``num_slices``
    slices) on the flattened tokens, no residual (``:44-61``)."""

    def __init__(self, dim: int, num_slices: int, d_state: int = 16):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.mamba = MambaBlock(dim, d_state, bimamba_type="v3", nslices=num_slices)

    def forward(self, x):
        return self.mamba(self.norm(_tokens(x))).reshape(x.shape)


class MlpChannel(nn.Module):
    """1^d conv -> exact GELU -> 1^d conv (``:64-75``)."""

    def __init__(self, dim: int, hidden: int, spatial_dims: int = 3):
        super().__init__()
        self.fc1 = PointwiseConv(dim, hidden, spatial_dims=spatial_dims)
        self.fc2 = PointwiseConv(hidden, dim, spatial_dims=spatial_dims)

    def forward(self, x):
        return self.fc2(gelu(self.fc1(x)))


class SegMambaEncoder(nn.Module):
    """The MambaEncoder (``:78-111``): a 7^d stem (padding 3) at strides[0],
    then per stage a parameterless IN and a 2^d conv at strides[i] (VALID),
    GSC, ``depths[i]`` Mamba layers, and the stage's output head IN ->
    ``MlpChannel(2 dims[i])``."""

    def __init__(self, in_channels: int, depths: Sequence[int], dims: Sequence[int],
                 strides: Sequence[Sequence[int]], num_slices_list: Sequence[int]):
        super().__init__()
        d = len(strides[0])
        self.depths = list(depths)
        self.stem = Conv(in_channels, dims[0], (7,) * d, strides[0], padding=3)
        for i in range(4):
            if i > 0:
                self.add_module(f"downsample{i}", Conv(dims[i - 1], dims[i], (2,) * d,
                                                       strides[i], padding=0))
            self.add_module(f"gsc{i}", GSC(dims[i], d))
            for j in range(depths[i]):
                self.add_module(f"stage{i}_{j}", SegMambaLayer(dims[i], num_slices_list[i]))
            self.add_module(f"mlp{i}", MlpChannel(dims[i], 2 * dims[i], d))

    def forward(self, x) -> List[torch.Tensor]:
        outs = []
        for i in range(4):
            x = self.stem(x) if i == 0 else getattr(self, f"downsample{i}")(instance_norm(x))
            x = getattr(self, f"gsc{i}")(x)
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i}_{j}")(x)
            outs.append(getattr(self, f"mlp{i}")(instance_norm(x)))
        return outs


class SegMamba(nn.Module):
    """SegMamba (``:114-147``): the tri-orientated-Mamba encoder ``vit``
    feeding a UNETR decoder (residual conv blocks on the raw input and each
    scale, transposed-conv up blocks, ``decoder2`` upsampling by
    ``strides[0]``) and a 1^d head. No deep supervision; the dimension is
    the strides' length (3 by default). The UNETR blocks take the two-pass
    instance-norm variance (the same function) and never the fused one."""

    def __init__(self, in_channels: int, num_classes: int,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 feat_size: Sequence[int] = (48, 96, 192, 384),
                 strides: Sequence[Sequence[int]] = ((1, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2)),
                 hidden_size: int = 768, num_slices_list: Sequence[int] = (64, 32, 16, 8)):
        super().__init__()
        d = len(strides[0])
        f = list(feat_size)
        self.vit = SegMambaEncoder(in_channels, depths, f, strides, num_slices_list)
        unetr = dict(spatial_dims=d, two_pass=True, fused_instance_norm=False)
        self.encoder1 = UnetrBasicBlock(in_channels, f[0], **unetr)
        self.encoder2 = UnetrBasicBlock(f[0], f[1], **unetr)
        self.encoder3 = UnetrBasicBlock(f[1], f[2], **unetr)
        self.encoder4 = UnetrBasicBlock(f[2], f[3], **unetr)
        self.encoder5 = UnetrBasicBlock(f[3], hidden_size, **unetr)
        self.decoder5 = UnetrUpBlock(hidden_size, f[3], f[3], **unetr)
        self.decoder4 = UnetrUpBlock(f[3], f[2], f[2], **unetr)
        self.decoder3 = UnetrUpBlock(f[2], f[1], f[1], **unetr)
        self.decoder2 = UnetrUpBlock(f[1], f[0], f[0], upsample_kernel_size=tuple(strides[0]),
                                     **unetr)
        self.decoder1 = UnetrBasicBlock(f[0], f[0], **unetr)
        self.out = PointwiseConv(f[0], num_classes, spatial_dims=d)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        outs = self.vit(x)
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(outs[0])
        enc3 = self.encoder3(outs[1])
        enc4 = self.encoder4(outs[2])
        h = self.decoder5(self.encoder5(outs[3]), enc4)
        h = self.decoder4(h, enc3)
        h = self.decoder3(h, enc2)
        h = self.decoder2(h, enc1)
        return self.out(self.decoder1(h))


# ---------------------------------------------------------------- LightM-UNet

class DWConvLayer(nn.Module):
    """Depthwise k^d conv (padding k // 2) then a pointwise conv, both at
    ``stride`` and without bias by default (``:150-167``)."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int,
                 kernel: int = 3, stride: int = 1, bias: bool = False):
        super().__init__()
        d = spatial_dims
        self.dw = Conv(in_channels, in_channels, (kernel,) * d, stride, padding=kernel // 2,
                       groups=in_channels, bias=bias)
        self.pw = Conv(in_channels, out_channels, (1,) * d, stride, padding=0, bias=bias)

    def forward(self, x):
        return self.pw(self.dw(x))


class LightMambaLayer(_SkipScale):
    """LN -> Mamba -> + skip_scale * tokens -> the SAME LN again (one set of
    parameters) -> a Dense to ``output_dim`` (``:170-191``)."""

    def __init__(self, dim: int, output_dim: int, d_state: int = 16):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.skip_scale = _empty(1)
        self.mamba = MambaBlock(dim, d_state)
        self.proj = Dense(dim, output_dim)

    def forward(self, x):
        t = _tokens(x)
        h = self.norm(self.mamba(self.norm(t)) + self.skip_scale * t)
        return self.proj(h).reshape(*x.shape[:-1], -1)


class GN8(nn.Module):
    """monai's ("GROUP", {"num_groups": 8}) norm, affine: the parameters in
    a child ``GroupNorm_0``."""

    def __init__(self, channels: int):
        super().__init__()
        self.GroupNorm_0 = GroupNorm(channels, 8)

    def forward(self, x):
        return self.GroupNorm_0(x)


class ResMambaBlock(nn.Module):
    """GN8 -> ReLU -> Mamba layer, twice, with an outer residual
    (``:201-213``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm1 = GN8(channels)
        self.conv1 = LightMambaLayer(channels, channels)
        self.norm2 = GN8(channels)
        self.conv2 = LightMambaLayer(channels, channels)

    def forward(self, x):
        h = self.conv1(F.relu(self.norm1(x)))
        return self.conv2(F.relu(self.norm2(h))) + x


class ResUpBlock(_SkipScale):
    """GN8 -> ReLU -> depthwise-separable conv + skip_scale * x -> GN8 ->
    ReLU (``:216-228``)."""

    def __init__(self, channels: int, spatial_dims: int):
        super().__init__()
        self.skip_scale = _empty(1)
        self.norm1 = GN8(channels)
        self.conv = DWConvLayer(channels, channels, spatial_dims)
        self.norm2 = GN8(channels)

    def forward(self, x):
        h = self.conv(F.relu(self.norm1(x))) + self.skip_scale * x
        return F.relu(self.norm2(h))


class LightMUNet(nn.Module):
    """LightM-UNet (``:242-282``): a SegResNet skeleton with Mamba layers
    for convs. A depthwise-separable stem; down stages of [a Mamba layer
    doubling the width and a 2x max-pool] and residual Mamba blocks; up
    stages of a 1^d conv halving the width, 2x nearest upsampling, the
    additive skip and residual up blocks; GN + ReLU + a 1^d separable head.
    2-D or 3-D (``spatial_dims``); no deep supervision."""

    def __init__(self, in_channels: int, num_classes: int, init_filters: int = 32,
                 blocks_down: Sequence[int] = (1, 2, 2, 4),
                 blocks_up: Sequence[int] = (1, 1, 1), spatial_dims: int = 2):
        super().__init__()
        f, d = init_filters, spatial_dims
        self.blocks_down, self.blocks_up = list(blocks_down), list(blocks_up)
        self.convInit = DWConvLayer(in_channels, f, d)
        for i, item in enumerate(blocks_down):
            ch = f * 2 ** i
            if i > 0:
                self.add_module(f"down{i}_mamba", LightMambaLayer(ch // 2, ch))
            for j in range(item):
                self.add_module(f"down{i}_block{j}", ResMambaBlock(ch))
        n_up = len(blocks_up)
        for i in range(n_up):
            cin = f * 2 ** (n_up - i)
            self.add_module(f"up{i}_conv", Conv(cin, cin // 2, (1,) * d, padding=0, bias=False))
            for j in range(blocks_up[i]):
                self.add_module(f"up{i}_block{j}", ResUpBlock(cin // 2, d))
        self.final_norm = GN8(f)
        self.conv_final = DWConvLayer(f, num_classes, d, kernel=1, bias=True)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        h = self.convInit(x)
        down_x = []
        for i, item in enumerate(self.blocks_down):
            if i > 0:
                h = max_pool2(getattr(self, f"down{i}_mamba")(h))
            for j in range(item):
                h = getattr(self, f"down{i}_block{j}")(h)
            down_x.append(h)
        down_x.reverse()
        for i, item in enumerate(self.blocks_up):
            h = nearest2(getattr(self, f"up{i}_conv")(h)) + down_x[i + 1]
            for j in range(item):
                h = getattr(self, f"up{i}_block{j}")(h)
        return self.conv_final(F.relu(self.final_norm(h)))


# ---------------------------------------------------------------- UltraLight VM-UNet

class PVMLayer(_SkipScale):
    """The PVM layer (``:285-310``): LN, the channels in four quarters, ONE
    ``MambaBlock(C / 4)`` on each with a skip_scale-gated residual, the
    quarters concatenated, the SAME LN again, a Dense to ``output_dim``."""

    def __init__(self, dim: int, output_dim: int, d_state: int = 16):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-5)
        self.skip_scale = _empty(1)
        self.mamba = MambaBlock(dim // 4, d_state)
        self.proj = Dense(dim, output_dim)

    def forward(self, x):
        tn = self.norm(_tokens(x))
        h = torch.cat([self.mamba(q) + self.skip_scale * q for q in tn.chunk(4, dim=-1)], -1)
        return self.proj(self.norm(h)).reshape(*x.shape[:-1], -1)


class SCAttBridge(nn.Module):
    """SC_Att_Bridge (``:334-373``): a spatial attention (channel mean and
    max -> one dilated 7x7 conv shared by the five skips -> sigmoid) with a
    residual, then a channel attention (each skip's global average, all
    concatenated -> one 1-D conv over the channel axis -> a Dense per skip
    -> sigmoid) with a residual."""

    def __init__(self, c_list: Sequence[int]):
        super().__init__()
        self.n = 5
        self.satt_conv = Conv(2, 1, (7, 7), padding=9, dilation=3)
        self.get_all_att = Conv(1, 1, (3,), padding=1, bias=False)
        total = sum(c_list[:self.n])
        for i in range(self.n):
            self.add_module(f"att{i + 1}", Dense(total, c_list[i]))

    def forward(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        def satt(t):
            stats = torch.cat([t.mean(-1, keepdim=True), t.amax(-1, keepdim=True)], -1)
            return torch.sigmoid(self.satt_conv(stats))

        r = ts
        ts = [satt(t) * t for t in ts]
        r_ = ts
        ts = [t + ro for t, ro in zip(ts, r)]
        pooled = torch.cat([t.mean((1, 2)) for t in ts], -1)               # (B, sum c)
        att = self.get_all_att(pooled[..., None])[..., 0]
        return [torch.sigmoid(getattr(self, f"att{i + 1}")(att))[:, None, None, :] * t + r_[i]
                for i, t in enumerate(ts)]


class UltraLightVMUNet(nn.Module):
    """UltraLight VM-UNet (``:376-423``): three conv and two PVM encoder
    stages (GroupNorm(4), 2x max-pool, exact GELU), the SC attention bridge
    on the five skips, a PVM bottleneck, a PVM / conv decoder with
    align-corners bilinear 2x upsampling and additive skips, a 1x1 head
    upsampled once more. 2-D, a patch divisible by 32; no deep
    supervision."""

    def __init__(self, in_channels: int, num_classes: int,
                 c_list: Sequence[int] = (8, 16, 24, 32, 48, 64), bridge: bool = True):
        super().__init__()
        c = list(c_list)
        self.bridge = bridge
        cin = [in_channels] + c[:2]
        for i in range(3):
            self.add_module(f"encoder{i + 1}", Conv(cin[i], c[i], (3, 3), padding=1))
        for i in range(3, 6):
            self.add_module(f"encoder{i + 1}", PVMLayer(c[i - 1], c[i]))
        for i in range(5):
            self.add_module(f"ebn{i + 1}", GroupNorm(c[i], 4))
        if bridge:
            self.scab = SCAttBridge(c)
        self.decoder1 = PVMLayer(c[5], c[4])
        self.decoder2 = PVMLayer(c[4], c[3])
        self.decoder3 = PVMLayer(c[3], c[2])
        self.decoder4 = Conv(c[2], c[1], (3, 3), padding=1)
        self.decoder5 = Conv(c[1], c[0], (3, 3), padding=1)
        for i in range(5):
            self.add_module(f"dbn{i + 1}", GroupNorm(c[4 - i], 4))
        self.final = PointwiseConv(c[0], num_classes)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        ts, h = [], x
        for i in range(5):
            h = gelu(max_pool2(getattr(self, f"ebn{i + 1}")(getattr(self, f"encoder{i + 1}")(h))))
            ts.append(h)
        if self.bridge:
            ts = self.scab(ts)
        h = gelu(self.encoder6(h))
        h = gelu(self.dbn1(self.decoder1(h))) + ts[4]
        for i in range(4):
            h = getattr(self, f"decoder{i + 2}")(h)
            h = gelu(bilinear_ac(getattr(self, f"dbn{i + 2}")(h))) + ts[3 - i]
        return bilinear_ac(self.final(h))


# ---------------------------------------------------------------- nnMamba

class NNDoubleConv(nn.Module):
    """conv(k, stride) + BN + ReLU, then conv(3) + BN + ReLU; the convs with
    bias (``:426-446``); BatchNorm at flax's momentum 0.9."""

    def __init__(self, in_channels: int, out_channels: int, spatial_dims: int,
                 stride: Optional[Sequence[int]] = None, kernel: int = 3):
        super().__init__()
        d = spatial_dims
        self.conv_a = Conv(in_channels, out_channels, (kernel,) * d,
                           tuple(stride) if stride is not None else 1, padding=kernel // 2)
        self.bn_a = BatchNorm(out_channels)
        self.conv_b = Conv(out_channels, out_channels, (3,) * d, padding=1)
        self.bn_b = BatchNorm(out_channels)

    def forward(self, x):
        return F.relu(self.bn_b(self.conv_b(F.relu(self.bn_a(self.conv_a(x))))))


class NNMambaLayer(nn.Module):
    """nnMamba's MambaLayer (``:449-483``): 1^d conv + BN + ReLU, then ONE
    Mamba applied to the tokens as they are, flipped over the channels (the
    reference's ``dims=[2]`` flip of (B, L, C) tokens), flipped over the
    sequence and both, each flipped back and the four averaged; the
    residual; 1^d conv + BN + ReLU."""

    def __init__(self, channels: int, spatial_dims: int, d_state: int = 16):
        super().__init__()
        self.nin = PointwiseConv(channels, channels, bias=False, spatial_dims=spatial_dims)
        self.norm = BatchNorm(channels)
        self.mamba = MambaBlock(channels, d_state)
        self.nin2 = PointwiseConv(channels, channels, bias=False, spatial_dims=spatial_dims)
        self.norm2 = BatchNorm(channels)

    def forward(self, x):
        act = F.relu(self.norm(self.nin(x)))
        t, m = _tokens(act), self.mamba
        y = (m(t) + m(t.flip(2)).flip(2) + m(t.flip(1)).flip(1)
             + m(t.flip((1, 2))).flip((1, 2))) / 4.0
        return F.relu(self.norm2(self.nin2(y.reshape(act.shape) + act)))


class NNBasicBlock(nn.Module):
    """The ResNet BasicBlock (``:486-516``): 3^d conv (stride) + BN + ReLU,
    3^d conv + BN, + the shared Mamba layer's output on the block's input
    where one is handed in, + the identity (or a 1^d conv + BN at the
    stride), ReLU. The Mamba layer is not a submodule: the residual layer
    owns it, once."""

    def __init__(self, in_channels: int, planes: int, spatial_dims: int,
                 stride: Optional[Sequence[int]] = None, has_downsample: bool = False):
        super().__init__()
        d = spatial_dims
        s = tuple(stride) if stride is not None else 1
        self.conv1 = Conv(in_channels, planes, (3,) * d, s, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = Conv(planes, planes, (3,) * d, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.has_downsample = has_downsample
        if has_downsample:
            self.ds_conv = Conv(in_channels, planes, (1,) * d, s, padding=0, bias=False)
            self.ds_bn = BatchNorm(planes)

    def forward(self, x, mamba: Optional[NNMambaLayer] = None):
        h = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        if mamba is not None:
            h = h + mamba(x)
        identity = self.ds_bn(self.ds_conv(x)) if self.has_downsample else x
        return F.relu(h + identity)


class NNMamba(nn.Module):
    """nnMambaSeg (``:527-578``): a double-conv stem at strides[0], three
    residual layers of ``blocks`` blocks (blocks 1 and up share the layer's
    Mamba layer ``mamba{idx}``), SE gates on the skips, a half-pixel linear
    upsampling decoder whose last double conv gives the logits (BN + ReLU
    included, a reference quirk). The dimension is the strides' length; no
    deep supervision."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 32, blocks: int = 3,
                 strides: Sequence[Sequence[int]] = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (2, 2, 2))):
        super().__init__()
        ch, d = channels, len(strides[0])
        self.strides = [tuple(s) for s in strides]
        self.blocks = blocks
        self.in_conv = NNDoubleConv(in_channels, ch, d, self.strides[0])
        cin = ch
        for idx in (1, 2, 3):
            planes = ch * 2 ** idx
            self.add_module(f"mamba{idx}", NNMambaLayer(planes, d))
            self.add_module(f"layer{idx}_block0", NNBasicBlock(
                cin, planes, d, self.strides[idx], has_downsample=True))
            for j in range(1, blocks):
                self.add_module(f"layer{idx}_block{j}", NNBasicBlock(planes, planes, d))
            cin = planes
        for idx in (1, 2, 3):
            c = ch * 2 ** (idx - 1)
            self.add_module(f"att{idx}_layer1", Dense(c, c // 16))
            self.add_module(f"att{idx}_layer2", Dense(c // 16, c))
        self.conv5 = NNDoubleConv(ch * 8 + ch * 4, ch * 4, d)
        self.conv6 = NNDoubleConv(ch * 4 + ch * 2, ch * 2, d)
        self.conv7 = NNDoubleConv(ch * 2 + ch, ch, d)
        self.conv8 = NNDoubleConv(ch, num_classes, d)

    def _se_gate(self, f: torch.Tensor, idx: int) -> torch.Tensor:
        pooled = f.mean(tuple(range(1, f.ndim - 1)))
        a = getattr(self, f"att{idx}_layer1")(pooled)
        a = torch.sigmoid(getattr(self, f"att{idx}_layer2")(F.relu(a)))
        return f * a.reshape(a.shape[0], *([1] * (f.ndim - 2)), a.shape[-1])

    def _res_layer(self, h: torch.Tensor, idx: int) -> torch.Tensor:
        mamba = getattr(self, f"mamba{idx}")
        h = getattr(self, f"layer{idx}_block0")(h)
        for j in range(1, self.blocks):
            h = getattr(self, f"layer{idx}_block{j}")(h, mamba)
        return h

    def forward(self, x, generator: Optional[torch.Generator] = None):
        st = self.strides
        c1 = self.in_conv(x)
        c2 = self._res_layer(c1, 1)
        c3 = self._res_layer(c2, 2)
        c4 = self._res_layer(c3, 3)
        h = self.conv5(torch.cat([linear_resize(c4, st[3]), self._se_gate(c3, 3)], -1))
        h = self.conv6(torch.cat([linear_resize(h, st[2]), self._se_gate(c2, 2)], -1))
        h = self.conv7(torch.cat([linear_resize(h, st[1]), self._se_gate(c1, 1)], -1))
        return self.conv8(linear_resize(h, st[0]))
