"""U-Mamba Bot and Enc, 2-D and 3-D, channels-last.

Counterparts of ``BasicResBlock``, ``MambaLayer``, ``_Upsample``,
``_halved_blocks``, ``UMambaUNet`` and ``umamba_from_plans`` in
``mlagg_unet_tpu/models/umamba.py:58-288``, which follow the reference's
UMambaBot_2d/3d.py and UMambaEnc_2d/3d.py:

* a residual encoder: a stem (``BasicResBlock`` + ``BasicBlockD``s) at the
  first stage's width, then per stage a strided ``BasicResBlock`` (1x1-conv
  shortcut without norm, every conv biased) and ``BasicBlockD``s; the deeper
  halves of encoder and decoder get one block (``_halved_blocks``);
* ``MambaLayer``: LN -> ``MambaBlock`` on the flattened tokens, no residual.
  Bot puts one on the bottleneck skip. Enc puts one after every stage in
  3-D and after alternating stages in 2-D (``bool(s % 2) ^ bool(n % 2)``,
  the last always); a stage whose spatial size, estimated from the plans'
  patch by floor division as the reference estimates it, is at most its
  width runs in channel-token mode (tokens = channels, d_model = the
  stage's flattened spatial size);
* a decoder of nearest-neighbour upsampling + 1x1 conv, the skip
  concatenated (2-D: on every stage but the last; 3-D: on every stage),
  a ``BasicResBlock`` and ``BasicBlockD``s, and a 1x1 head per stage for
  deep supervision, highest resolution first.

The SS3D variants (``umamba.py:207-233``; 3-D only, as the registry builds
them) put the 12-direction VSS block of ``models/vmunet3d.py`` at d_state 1
and without the z gate where the Mamba layers were: ``enc_ss3d`` one after
every stage (the plain MLP, ratio 2 for the first two stages and 4 after,
no channel-token mode), ``bot_ss3d`` one on the bottleneck skip (ConvGLU,
ratio 4). InstanceNorm takes its variance in two passes, as the port's U-Net does
(``layers.InstanceNorm``).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.device import DeviceLike
from mlagg_unet_torch.models.dynamic_unet import BasicBlockD
from mlagg_unet_torch.models.layers import Conv, InstanceNorm, LayerNorm
from mlagg_unet_torch.models.mamba_block import MambaBlock
from mlagg_unet_torch.models.vmamba import build_seeded
from mlagg_unet_torch.models.vmunet3d import VSSBlock3D

MAMBA_MODES = ("bot", "enc", "bot_ss3d", "enc_ss3d")


def _lrelu(x):
    return F.leaky_relu(x, 0.01)


class BasicResBlock(nn.Module):
    """conv -> IN -> lrelu -> conv -> IN [+ 1x1 conv shortcut] -> lrelu."""

    def __init__(self, in_channels: int, features: int, kernel_size: Sequence[int],
                 strides: Sequence[int], use_1x1conv: bool = False):
        super().__init__()
        k, ones = list(kernel_size), [1] * len(kernel_size)
        self.conv1 = Conv(in_channels, features, k, list(strides))
        self.norm1 = InstanceNorm(features, two_pass=True)
        self.conv2 = Conv(features, features, k)
        self.norm2 = InstanceNorm(features, two_pass=True)
        self.conv3 = Conv(in_channels, features, ones, list(strides)) if use_1x1conv else None

    def forward(self, x):
        y = self.norm2(self.conv2(_lrelu(self.norm1(self.conv1(x)))))
        return _lrelu(y + (x if self.conv3 is None else self.conv3(x)))


class MambaLayer(nn.Module):
    """LN (eps 1e-5) -> ``MambaBlock`` on the (B, L, C) tokens, no residual;
    with ``channel_token`` on the (B, C, L) tokens (d_model = L =
    ``spatial``, the stage's flattened size)."""

    def __init__(self, channels: int, d_state: int = 16, channel_token: bool = False,
                 spatial: int = 0):
        super().__init__()
        self.channel_token = channel_token
        d_model = spatial if channel_token else channels
        self.norm = LayerNorm(d_model, eps=1e-5)
        self.mamba = MambaBlock(d_model, d_state=d_state)

    def forward(self, x):
        B, *spatial, C = x.shape
        tokens = x.reshape(B, -1, C)
        if self.channel_token:
            h = self.mamba(self.norm(tokens.transpose(1, 2)))
            return h.transpose(1, 2).reshape(x.shape)
        return self.mamba(self.norm(tokens)).reshape(x.shape)


class _Upsample(nn.Module):
    """Nearest-neighbour upsampling by ``scale`` per axis + a 1x1 conv."""

    def __init__(self, in_channels: int, features: int, scale: Sequence[int]):
        super().__init__()
        self.scale = list(scale)
        self.conv = Conv(in_channels, features, [1] * len(scale))

    def forward(self, x):
        for ax, s in enumerate(self.scale):
            if s != 1:
                x = x.repeat_interleave(s, dim=1 + ax)
        return self.conv(x)


def _halved_blocks(n_stages: int, enc: Sequence[int], dec: Sequence[int]):
    """The reference's UMambaBot.__init__: the deeper halves of the encoder
    and the decoder get one block each."""
    enc, dec = list(enc), list(dec)
    for s in range(math.ceil(n_stages / 2), n_stages):
        enc[s] = 1
    for s in range(math.ceil((n_stages - 1) / 2 + 0.5), n_stages - 1):
        dec[s] = 1
    return enc, dec


class UMambaUNet(nn.Module):
    """``mamba_mode`` 'bot': a Mamba layer on the bottleneck only; 'enc':
    after every (3-D) or every other (2-D) encoder stage; 'bot_ss3d' /
    'enc_ss3d': the 12-direction VSS block in those places. ``input_size`` is
    the plans' patch: it decides the channel-token stages and sizes their
    Mamba layers (the network then takes inputs of that size)."""

    def __init__(self, in_channels: int, num_classes: int, n_stages: int,
                 features_per_stage: Sequence[int],
                 conv_kernel_sizes: Sequence[Sequence[int]],
                 pool_op_kernel_sizes: Sequence[Sequence[int]],
                 n_conv_per_stage_encoder: Sequence[int],
                 n_conv_per_stage_decoder: Sequence[int],
                 deep_supervision: bool = True, mamba_mode: str = "bot",
                 input_size: Optional[Sequence[int]] = None):
        super().__init__()
        if mamba_mode not in MAMBA_MODES:
            raise ValueError(f"mamba_mode {mamba_mode!r}: one of {MAMBA_MODES}")
        n = n_stages
        feats = list(features_per_stage)
        kernels = [list(k) for k in conv_kernel_sizes]
        strides = [list(s) for s in pool_op_kernel_sizes]
        dim = len(kernels[0])
        ones = [1] * dim
        n_enc, n_dec = _halved_blocks(n, n_conv_per_stage_encoder, n_conv_per_stage_decoder)
        self.n_stages, self.deep_supervision, self.mamba_mode = n, deep_supervision, mamba_mode
        self.n_enc, self.n_dec = n_enc, n_dec

        # the reference's floor-divided size estimate decides channel-token
        # mode; the Mamba layer's d_model is the stage's real (ceil) size
        est = real = list(input_size) if input_size is not None else None
        self.mamba_stages: List[int] = []
        for s in range(n):
            if input_size is not None:
                est = [i // j for i, j in zip(est, strides[s])]
                real = [-(-i // j) for i, j in zip(real, strides[s])]
            if mamba_mode == "enc" and (dim == 3 or bool(s % 2) ^ bool(n % 2)):
                if input_size is None:
                    raise ValueError("U-Mamba Enc needs input_size (the plans' patch)")
                channel_token = math.prod(est) <= feats[s]
                self.add_module(f"enc_mamba{s}", MambaLayer(
                    feats[s], channel_token=channel_token, spatial=math.prod(real)))
                self.mamba_stages.append(s)
            elif mamba_mode == "enc_ss3d":
                self.add_module(f"enc_vss{s}", VSSBlock3D(
                    feats[s], d_state=1, expand=2.0, mlp_ratio=2.0 if s < 2 else 4.0,
                    no_z=True, mlp_type="plain"))

        self.stem_block0 = BasicResBlock(in_channels, feats[0], kernels[0], ones, True)
        for i in range(1, n_enc[0]):
            self.add_module(f"stem_block{i}", BasicBlockD(feats[0], feats[0], kernels[0], ones))
        cin = feats[0]
        for s in range(n):
            self.add_module(f"stage{s}_block0",
                            BasicResBlock(cin, feats[s], kernels[s], strides[s], True))
            for i in range(1, n_enc[s]):
                self.add_module(f"stage{s}_block{i}",
                                BasicBlockD(feats[s], feats[s], kernels[s], ones))
            cin = feats[s]
        if mamba_mode == "bot":
            self.bot_mamba = MambaLayer(feats[-1])
        elif mamba_mode == "bot_ss3d":
            self.bot_vss0 = VSSBlock3D(feats[-1], d_state=1, expand=2.0, mlp_ratio=4.0,
                                       no_z=True)

        for s in range(n - 1):
            width = feats[n - 2 - s]
            self.add_module(f"up{s}", _Upsample(cin, width, strides[n - 1 - s]))
            concat = dim == 3 or s < n - 2
            self.add_module(f"dec_stage{s}_block0", BasicResBlock(
                width * (2 if concat else 1), width, kernels[n - 2 - s], ones, True))
            for i in range(1, n_dec[s] if s < len(n_dec) else 1):
                self.add_module(f"dec_stage{s}_block{i}",
                                BasicBlockD(width, width, kernels[n - 2 - s], ones))
            if deep_supervision or s == n - 2:
                self.add_module(f"seg{s}", Conv(width, num_classes, ones))
            cin = width

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        n = self.n_stages
        dim = x.ndim - 2
        x = self.stem_block0(x)
        for i in range(1, self.n_enc[0]):
            x = getattr(self, f"stem_block{i}")(x)
        skips = []
        for s in range(n):
            for i in range(self.n_enc[s]):
                x = getattr(self, f"stage{s}_block{i}")(x)
            if s in self.mamba_stages:
                x = getattr(self, f"enc_mamba{s}")(x)
            elif self.mamba_mode == "enc_ss3d":
                x = getattr(self, f"enc_vss{s}")(x)
            skips.append(x)
        if self.mamba_mode == "bot":
            skips[-1] = self.bot_mamba(skips[-1])
        elif self.mamba_mode == "bot_ss3d":
            skips[-1] = self.bot_vss0(skips[-1])
        outputs = []
        lres = skips[-1]
        for s in range(n - 1):
            up = getattr(self, f"up{s}")(lres)
            if dim == 3 or s < n - 2:
                up = torch.cat([up, skips[n - 2 - s]], dim=-1)
            for i in range(self.n_dec[s] if s < len(self.n_dec) else 1):
                up = getattr(self, f"dec_stage{s}_block{i}")(up)
            if self.deep_supervision or s == n - 2:
                outputs.append(getattr(self, f"seg{s}")(up))
            lres = up
        outputs = outputs[::-1]
        return outputs if self.deep_supervision else outputs[0]


def umamba_from_plans(configuration_manager, num_input_channels: int,
                      num_output_channels: int, deep_supervision: bool = True,
                      mamba_mode: str = "bot") -> UMambaUNet:
    """The U-Mamba of a ``ConfigurationManager``: widths min(base * 2^s,
    max), the plans' kernels, strides and blocks, its patch as input size."""
    cm = configuration_manager
    n_stages = len(cm.pool_op_kernel_sizes)
    features = [min(cm.UNet_base_num_features * 2 ** i, cm.unet_max_num_features)
                for i in range(n_stages)]
    return UMambaUNet(
        num_input_channels, num_output_channels, n_stages, features, cm.conv_kernel_sizes,
        cm.pool_op_kernel_sizes, cm.n_conv_per_stage_encoder, cm.n_conv_per_stage_decoder,
        deep_supervision, mamba_mode, getattr(cm, "patch_size", None))


def build_umamba(configuration_manager, num_input_channels: int, num_output_channels: int,
                 deep_supervision: bool = True, mamba_mode: str = "bot", *,
                 seed: int = 0, device: DeviceLike = "cuda") -> UMambaUNet:
    """``umamba_from_plans``, seeded, fp32, in eval mode on ``device``."""
    return build_seeded(umamba_from_plans(configuration_manager, num_input_channels,
                                          num_output_channels, deep_supervision, mamba_mode),
                        seed, device)
