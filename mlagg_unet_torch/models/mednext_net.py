"""The MedNeXt U-Net, with and without its multi-scale Mamba skip, 2-D and 3-D.

Counterpart of ``mlagg_unet_tpu/models/mednext_net.py``: ``MedNeXtNet``
(MedNextV1_new: a 1x1 stem, four levels of MedNeXt blocks with a strided
down block after each, the bottleneck, four up blocks whose output is added
to the level's skip, the level's blocks, and a 1x1 head per level under deep
supervision) and ``create_mednext_v1`` (the S/B/M/L presets). With
``use_mamba_skip`` (MedNextV1_new_Mambaskip, 2-D only) the four skips and
the bottleneck go through one ``VSSConvLayer`` over the five scales before
the decoder: its scan is K1 on the card (K5 in training). Submodules carry
the flax scope names (``stem``, ``enc_block_{lvl}_{i}``, ``down_{lvl}``,
``bottleneck_{i}``, ``mambaskip``, ``up_{lvl}``, ``dec_block_{lvl}_{i}``,
``out_{lvl}``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch
from torch import nn

from mlagg_unet_torch.device import DeviceLike
from mlagg_unet_torch.models.layers import Conv
from mlagg_unet_torch.models.mamba_skip import VSSConvLayer
from mlagg_unet_torch.models.mednext import (
    MedNeXtBlock,
    MedNeXtDownBlock,
    MedNeXtUpBlock,
    OutBlock,
)

# create_mednext_v1.py:65 (JAX's create_mednext_v1)
PRESETS = {
    "S": dict(n_channels=32, exp_r=2, block_counts=(2,) * 9),
    "B": dict(n_channels=32, exp_r=(2, 3, 4, 4, 4, 4, 4, 3, 2), block_counts=(2,) * 9),
    "M": dict(n_channels=32, exp_r=(2, 3, 4, 4, 4, 4, 4, 3, 2),
              block_counts=(3, 4, 4, 4, 4, 4, 4, 4, 3)),
    "L": dict(n_channels=32, exp_r=(3, 4, 8, 8, 8, 8, 8, 4, 3),
              block_counts=(3, 4, 8, 8, 8, 8, 8, 4, 3)),
}


class MedNeXtNet(nn.Module):
    """Five levels of n, 2n, 4n, 8n and 16n channels. ``forward(x,
    generator)`` on channels-last ``x``: the logits, or under deep
    supervision the five heads, highest resolution first. The Mamba skip's
    stochastic depth (0.1) draws from ``generator`` in training mode."""

    def __init__(self, in_channels: int, n_classes: int, n_channels: int = 32,
                 exp_r: Union[int, Sequence[int]] = 4, kernel_size: int = 7,
                 deep_supervision: bool = False, do_res: bool = True,
                 do_res_up_down: bool = True,
                 block_counts: Sequence[int] = (2,) * 9,
                 strides: Sequence = (2,) * 8, grn: bool = False, spatial_dims: int = 2,
                 use_mamba_skip: bool = False, mamba_hidden_dim: int = 16):
        super().__init__()
        if use_mamba_skip and spatial_dims != 2:
            raise ValueError("MedNeXt's Mamba skip (SS2D over five scales) is 2-D only")
        d, n = spatial_dims, n_channels
        er = list(exp_r) if isinstance(exp_r, (list, tuple)) else [exp_r] * len(block_counts)
        self.deep_supervision, self.use_mamba_skip = deep_supervision, use_mamba_skip
        self.block_counts = tuple(block_counts)
        self.stem = Conv(in_channels, n, (1,) * d)

        def blocks(name, channels, count, e):
            for i in range(count):
                self.add_module(f"{name}_{i}", MedNeXtBlock(
                    channels, channels, e, kernel_size, do_res=do_res, grn=grn,
                    spatial_dims=d))

        for lvl in range(4):
            ch = n * 2 ** lvl
            blocks(f"enc_block_{lvl}", ch, block_counts[lvl], er[lvl])
            self.add_module(f"down_{lvl}", MedNeXtDownBlock(
                ch, 2 * ch, er[lvl + 1], kernel_size, do_res=do_res_up_down, grn=grn,
                stride=strides[lvl], spatial_dims=d))
        blocks("bottleneck", 16 * n, block_counts[4], er[4])
        if use_mamba_skip:
            self.mambaskip = VSSConvLayer([n * 2 ** i for i in range(5)], mamba_hidden_dim,
                                          depth=1, drop_path=0.1)
        if deep_supervision:
            self.out_4 = OutBlock(16 * n, n_classes, d)
        for up in range(4):
            lvl = 3 - up
            ch = n * 2 ** lvl
            self.add_module(f"up_{lvl}", MedNeXtUpBlock(
                2 * ch, ch, er[5 + up], kernel_size, do_res=do_res_up_down, grn=grn,
                stride=strides[4 + up], spatial_dims=d))
            blocks(f"dec_block_{lvl}", ch, block_counts[5 + up], er[5 + up])
            if deep_supervision and lvl > 0:
                self.add_module(f"out_{lvl}", OutBlock(ch, n_classes, d))
        self.out_0 = OutBlock(n, n_classes, d)

    def _blocks(self, name: str, h, count: int):
        for i in range(count):
            h = getattr(self, f"{name}_{i}")(h)
        return h

    def forward(self, x, generator: Optional[torch.Generator] = None
                ) -> Union[torch.Tensor, List[torch.Tensor]]:
        counts = self.block_counts
        h = self.stem(x)
        res = []
        for lvl in range(4):
            h = self._blocks(f"enc_block_{lvl}", h, counts[lvl])
            res.append(h)
            h = getattr(self, f"down_{lvl}")(h)
        h = self._blocks("bottleneck", h, counts[4])
        if self.use_mamba_skip:
            *res, h = self.mambaskip(res + [h], generator)
        ds = [self.out_4(h)] if self.deep_supervision else []
        for up in range(4):
            lvl = 3 - up
            h = res[lvl] + getattr(self, f"up_{lvl}")(h)
            h = self._blocks(f"dec_block_{lvl}", h, counts[5 + up])
            if self.deep_supervision and lvl > 0:
                ds.append(getattr(self, f"out_{lvl}")(h))
        out = self.out_0(h)
        return [out] + ds[::-1] if self.deep_supervision else out


def create_mednext_v1(num_input_channels: int, num_classes: int, model_id: str = "B",
                      kernel_size: int = 3, deep_supervision: bool = False,
                      spatial_dims: int = 2, use_mamba_skip: bool = False) -> MedNeXtNet:
    """A preset (S, B, M or L) with residual blocks and residual up/down
    blocks, as JAX's ``create_mednext_v1``."""
    return MedNeXtNet(num_input_channels, num_classes, kernel_size=kernel_size,
                      deep_supervision=deep_supervision, do_res=True, do_res_up_down=True,
                      spatial_dims=spatial_dims, use_mamba_skip=use_mamba_skip,
                      **PRESETS[model_id])


def build_mednext(configuration_manager, num_input_channels: int, num_output_channels: int,
                  deep_supervision: bool, model_id: str, kernel_size: int,
                  use_mamba_skip: bool = False, *, seed: int = 0,
                  device: DeviceLike = "cuda") -> MedNeXtNet:
    """``create_mednext_v1`` in the dimension of the configuration's patch
    (or of a patch size), seeded, fp32, in eval mode on ``device``."""
    from mlagg_unet_torch.models.vmamba import build_seeded

    patch = getattr(configuration_manager, "patch_size", configuration_manager)
    model = create_mednext_v1(num_input_channels, num_output_channels, model_id, kernel_size,
                              deep_supervision, spatial_dims=len(patch),
                              use_mamba_skip=use_mamba_skip)
    return build_seeded(model, seed, device)
