"""MLLA_Uper, the flagship MLAgg-UNet network, NHWC.

Counterpart of ``mlagg_unet_tpu/models/mlla_uper.py``: MLLA encoder (4
stages) -> Multi-Scale Mamba Module over the 4 scales -> MedNeXt decoder with
PatchExpand upsampling -> stem-resolution UNETR head -> 1 + 4 deep-supervision
heads, returned as [full res, 1/2, 1/4, 1/8, 1/16].

Stochastic depth follows the flagship's build: encoder blocks at
``linspace(0, drop_path_rate, 8)``, the Multi-Scale Mamba skip at a fixed
``skip_drop_path`` (0.1, ``mlla_uper.py:61``). It acts only in training mode
and draws from the ``generator`` handed to ``forward``.

Three switches pick the fused paths, each ``None`` (the JAX package's
variable, read once at construction) or a bool: ``fused_local_attn`` (the
local attention half through K6 in ``eval()``; ``MLAGG_FUSED_LOCAL_ATTN ==
"1"``, off by default), ``fused_instance_norm`` (the UNETR head's
InstanceNorm chains through K7 and K8, in training too; ``MLAGG_FUSED_IN ==
"1"``, off by default) and ``fused_tail`` (the MLLA block front and tail
through K2 and K3 in ``eval()``; ``MLAGG_FUSED_TAIL != "0"``, on by default).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike, resolve_device
from mlagg_unet_torch.models.layers import init_parameters
from mlagg_unet_torch.models.mamba_skip import VSSConvLayer
from mlagg_unet_torch.models.mednext import MedNeXtBlock, OutBlock, PatchExpand
from mlagg_unet_torch.models.mlla import MLLAEncoder
from mlagg_unet_torch.models.unetr_blocks import UnetrBasicBlock, UnetrUpBlock
from mlagg_unet_torch.ops.fused_norm import fused_norms_enabled
from mlagg_unet_torch.ops.mlla_attn_fused import fused_local_attn_enabled
from mlagg_unet_torch.ops.mlla_fused import fused_tail_enabled


class MLLAUper(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, embed_dim: int = 96,
                 patch_size: int = 2, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 mlp_ratio: float = 2.0,
                 sr_ratio: Sequence[int] = (16, 8, 4, 2),
                 deep_supervision: bool = True, drop_path_rate: float = 0.1,
                 skip_drop_path: float = 0.1,
                 fused_local_attn: Optional[bool] = None,
                 fused_instance_norm: Optional[bool] = None,
                 fused_tail: Optional[bool] = None):
        super().__init__()
        fused_local_attn = fused_local_attn_enabled(fused_local_attn)
        fused_instance_norm = fused_norms_enabled(fused_instance_norm)
        fused_tail = fused_tail_enabled(fused_tail)
        e = embed_dim
        exp_r = int(mlp_ratio)
        self.depths = tuple(depths)
        self.deep_supervision = deep_supervision
        self.mlla = MLLAEncoder(in_channels, patch_size, e, depths, num_heads,
                                mlp_ratio, sr_ratio, drop_path_rate,
                                fused_local_attn, fused_tail)
        self.mambaskip = VSSConvLayer([e, 2 * e, 4 * e, 8 * e], e // 2, depth=1,
                                      drop_path=skip_drop_path)
        if deep_supervision:
            self.out_4 = OutBlock(8 * e, out_channels)
        for s, (c_in, c) in enumerate(((2 * e, e), (4 * e, 2 * e), (8 * e, 4 * e))):
            self.add_module(f"up_{s}", PatchExpand(c_in, c, kernel_size=3))
            for i in range(self.depths[s]):
                self.add_module(f"dec_block_{s}_{i}", MedNeXtBlock(
                    c, c, exp_r=exp_r, kernel_size=3, do_res=True))
            if deep_supervision:
                self.add_module(f"out_{s + 1}", OutBlock(c, out_channels))
        self.encoder0 = UnetrBasicBlock(in_channels, e // 2, kernel_size=3,
                                        fused_instance_norm=fused_instance_norm)
        self.decoder0 = UnetrUpBlock(e, e // 2, e // 2, kernel_size=3,
                                     upsample_kernel_size=2,
                                     fused_instance_norm=fused_instance_norm)
        self.out_0 = OutBlock(e // 2, out_channels)

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        hidden = self.mlla(x, generator)
        hidden = [hidden[0]] + list(self.mambaskip(hidden[1:], generator))
        ds = {}
        if self.deep_supervision:
            ds[4] = self.out_4(hidden[4])
        h = hidden[4]
        for s in (2, 1, 0):
            h = hidden[s + 1] + getattr(self, f"up_{s}")(h)
            for i in range(self.depths[s]):
                h = getattr(self, f"dec_block_{s}_{i}")(h)
            if self.deep_supervision:
                ds[s + 1] = getattr(self, f"out_{s + 1}")(h)
        h = self.decoder0(h, self.encoder0(hidden[0]))
        out0 = self.out_0(h)
        if self.deep_supervision:
            return [out0, ds[1], ds[2], ds[3], ds[4]]
        return out0


FLAGSHIP = dict(embed_dim=96, patch_size=2, depths=(2, 2, 2, 2),
                num_heads=(2, 4, 8, 16), mlp_ratio=2, sr_ratio=(16, 8, 4, 2))


def build_flagship(num_classes: int = 4, in_channels: int = 1, *,
                   seed: int = 0, device: DeviceLike = "cuda",
                   fused_local_attn: Optional[bool] = None,
                   fused_instance_norm: Optional[bool] = None,
                   fused_tail: Optional[bool] = None,
                   **overrides) -> MLLAUper:
    """The flagship MLLAUper (``bench.py``'s config unless overridden), fp32,
    with weights drawn from ``torch.Generator().manual_seed(seed)``, in eval
    mode on ``device`` (the GPU unless the caller passes another; raises
    without one). A trainer sets ``.train()``. The fused switches are
    ``MLLAUper``'s; the same seed gives the same weights in every config."""
    dev = resolve_device(device)
    model = MLLAUper(in_channels, num_classes, **{**FLAGSHIP, **overrides},
                     fused_local_attn=fused_local_attn,
                     fused_instance_norm=fused_instance_norm, fused_tail=fused_tail)
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
