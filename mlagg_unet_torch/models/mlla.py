"""MLLA encoder: aggregated attention blocks and patch embedding, NHWC.

Counterparts of ``mlagg_unet_tpu/models/mlla.py``: ``AggregatedAttention``
(both branches), ``MLLABlock``, ``BasicLayer``, ``ProjectBlock``,
``PatchEmbed`` and ``MLLAEncoder``, and ``Attention``: the full softmax
attention with LePE that ``MLLABlock`` runs at ``sr_ratio == 1``, through
``ops.flash_attention`` (kernel K4); no network of the registry reaches it.

In ``eval()`` mode, with ``fused_tail`` set, the block front and tail run
through ``ops.mlla_fused`` (kernels K2 and K3 on the GPU, their unfused twins
on the CPU); with ``fused_local_attn`` set, the local attention half runs
through ``ops.mlla_attn_fused`` (kernel K6). In training mode all of them run
unfused, the block with stochastic depth, as ``mlla.py:205-216, 338-341,
377-387`` do (K2, K3 and K6 have no backward). The pooled branch runs through
``ops.flash_attention`` (kernel K4) in both modes. ``None`` for a switch
reads the JAX package's variable at construction: ``MLAGG_FUSED_TAIL != "0"``
(on by default), ``MLAGG_FUSED_LOCAL_ATTN == "1"`` (off by default).

Scale note, kept from the reference: the pooled branch pre-scales q by
head_dim ** -0.5 and the attention call scales again, so its logits are
q.k / head_dim.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import (
    Conv,
    Dense,
    DropPath,
    DWConv2d,
    LayerNorm,
    PointwiseConv,
    RMSNorm,
    avg_pool_to,
    gelu,
)
from mlagg_unet_torch.models.mednext import MedNeXtDownBlock
from mlagg_unet_torch.ops.flash_attention import flash_attention
from mlagg_unet_torch.ops.local_attention import (
    local_window_attention_apply,
    local_window_attention_logits,
)
from mlagg_unet_torch.ops.mlla_attn_fused import (
    fused_local_attn_enabled,
    local_aggregated_attention_fused,
)
from mlagg_unet_torch.ops.mlla_fused import fused_tail_enabled, mlla_front, mlla_tail

WINDOW = 3          # local attention window
LAMBDA_INIT = 0.8   # DiffAttn lambda_init


class AggregatedAttention(nn.Module):
    """One half (local 3x3 window or pooled) of the dual attention with the
    DiffAttn lambda. ``num_heads`` counts differential heads: q and k use
    2 * num_heads heads of ``head_dim = dim // num_heads // 2``, v uses
    num_heads heads of 2 * head_dim."""

    def __init__(self, dim: int, num_heads: int, local: bool = True,
                 sr_ratio: int = 1, fused_local_attn: Optional[bool] = None):
        super().__init__()
        self.nh, self.local, self.sr_ratio = num_heads, local, sr_ratio
        self.fused = local and fused_local_attn_enabled(fused_local_attn)
        self.head_dim = hd = dim // num_heads // 2
        for name in ("lambda_q1", "lambda_k1", "lambda_q2", "lambda_k2"):
            setattr(self, name, nn.Parameter(torch.empty(hd)))
        self.q = Dense(dim, dim)
        self.kv = Dense(dim, 2 * dim)
        self.subln = RMSNorm(2 * hd)
        self.lepe = DWConv2d(dim)
        if not local:
            self.sr = PointwiseConv(dim, dim)
            self.norm = LayerNorm(dim)

    def init_parameters(self, gen):
        with torch.no_grad():
            for p in (self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2):
                nn.init.normal_(p, 0.0, 0.1, generator=gen)

    def lambda_full(self) -> torch.Tensor:
        return (torch.exp(torch.sum(self.lambda_q1 * self.lambda_k1))
                - torch.exp(torch.sum(self.lambda_q2 * self.lambda_k2))
                + LAMBDA_INIT).float()

    def forward(self, x):
        B, H, W, C = x.shape
        nh, hd = self.nh, self.head_dim
        scale = hd ** -0.5
        lam = self.lambda_full()
        if self.fused and not self.training:
            return local_aggregated_attention_fused(
                x, self.q.weight, self.q.bias, self.kv.weight, self.kv.bias,
                self.subln.weight, self.lepe.Conv_0.weight, self.lepe.Conv_0.bias,
                lam, nh, LAMBDA_INIT)
        q = self.q(x) * scale
        k, v = self.kv(x).chunk(2, dim=-1)
        if self.local:
            logits = local_window_attention_logits(
                q.reshape(B, H, W, 2 * nh, hd), k.reshape(B, H, W, 2 * nh, hd), WINDOW)
            attn = torch.softmax(logits, dim=-1).reshape(B, H, W, nh, 2, WINDOW ** 2)
            attn = attn[..., 0, :] - lam * attn[..., 1, :]
            out = local_window_attention_apply(attn, v.reshape(B, H, W, nh, 2 * hd), WINDOW)
        else:
            ph, pw = H // self.sr_ratio, W // self.sr_ratio
            P = ph * pw
            x_ = avg_pool_to(gelu(self.sr(x)), (ph, pw))
            # the reference reuses the kv projection on the pooled tokens
            kp, vp = self.kv(self.norm(x_.reshape(B, P, C))).chunk(2, dim=-1)
            qg = q.reshape(B, H * W, nh, 2, hd)
            kg = kp.reshape(B, P, nh, 2, hd)
            vv = vp.reshape(B, P, nh, 2 * hd).transpose(1, 2)   # (B, nh, P, 2hd)
            attn1 = flash_attention(qg[:, :, :, 0].transpose(1, 2),
                                    kg[:, :, :, 0].transpose(1, 2), vv, scale)
            attn2 = flash_attention(qg[:, :, :, 1].transpose(1, 2),
                                    kg[:, :, :, 1].transpose(1, 2), vv, scale)
            # the lambda combine stays in the compute dtype
            out = (attn1 - lam.to(attn1.dtype) * attn2).transpose(1, 2)
        out = self.subln(out) * (1 - LAMBDA_INIT)
        return out.reshape(B, H, W, C).to(x.dtype) + self.lepe(v)


class Attention(nn.Module):
    """Full softmax attention + LePE for the ``sr_ratio == 1`` stages
    (``mlla.py:278-306``): q is pre-scaled by head_dim ** -0.5 and the
    attention call scales by 1.0; the LePE depthwise conv runs on v."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.nh = num_heads
        self.qkv = Dense(dim, 3 * dim, bias=qkv_bias)
        self.lepe = DWConv2d(dim)

    def forward(self, x):
        B, H, W, C = x.shape
        nh, hd = self.nh, C // self.nh
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd)
        q = qkv[:, :, 0].transpose(1, 2) * hd ** -0.5
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        out = flash_attention(q, k.transpose(1, 2), v.transpose(1, 2), 1.0)
        return out.transpose(1, 2).reshape(B, H, W, C) + self.lepe(v.reshape(B, H, W, C))


class _Mlp(nn.Module):
    """Param container with the tree of the JAX ``Mlp`` (Dense_0, Dense_1)."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden)
        self.Dense_1 = Dense(hidden, dim)


class MLLABlock(nn.Module):
    """Mamba-like gated attention block: front (LN, gate, in-proj), dwconv +
    SiLU, the two attention halves (at ``sr_ratio == 1`` the full
    ``Attention``), tail (gate-mul, out-proj, residual, LN, MLP, residual),
    with stochastic depth on both residual branches."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 sr_ratio: int = 1, drop_path: float = 0.0,
                 fused_local_attn: Optional[bool] = None,
                 fused_tail: Optional[bool] = None):
        super().__init__()
        self.fused_tail = fused_tail_enabled(fused_tail)
        self.sr_ratio = sr_ratio
        self.norm1 = LayerNorm(dim)
        self.act_proj = Dense(dim, dim)
        self.in_proj = Dense(dim, dim)
        self.dwc = DWConv2d(dim)
        if sr_ratio == 1:
            self.attn = Attention(dim, num_heads)
        else:
            self.attn_local = AggregatedAttention(dim // 2, num_heads // 2,
                                                  local=True, sr_ratio=sr_ratio,
                                                  fused_local_attn=fused_local_attn)
            self.attn_pool = AggregatedAttention(dim // 2, num_heads // 2,
                                                 local=False, sr_ratio=sr_ratio)
        self.out_proj = Dense(dim, dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        m = self.mlp
        fused = self.fused_tail and not self.training
        if not fused:
            hn = self.norm1(x)
            a, h = F.silu(self.act_proj(hn)), self.in_proj(hn)
        else:
            a, h = mlla_front(x, self.norm1.weight, self.norm1.bias,
                              self.act_proj.weight, self.act_proj.bias,
                              self.in_proj.weight, self.in_proj.bias)
        h = F.silu(self.dwc(h))
        if self.sr_ratio == 1:
            h = self.attn(h)
        else:
            h1, h2 = h.chunk(2, dim=-1)
            h = torch.cat([self.attn_local(h1), self.attn_pool(h2)], dim=-1)
        if fused:
            return mlla_tail(h, a, x, self.out_proj.weight, self.out_proj.bias,
                             self.norm2.weight, self.norm2.bias,
                             m.Dense_0.weight, m.Dense_0.bias,
                             m.Dense_1.weight, m.Dense_1.bias)
        x = x + self.drop_path(self.out_proj(h * a), generator)
        y = m.Dense_1(gelu(m.Dense_0(self.norm2(x))))
        return x + self.drop_path(y, generator)


class BasicLayer(nn.Module):
    """A stack of MLLABlocks for one stage."""

    def __init__(self, dim: int, depth: int, num_heads: int,
                 mlp_ratio: float = 4.0, sr_ratio: int = 1,
                 drop_path: Sequence[float] = (),
                 fused_local_attn: Optional[bool] = None,
                 fused_tail: Optional[bool] = None):
        super().__init__()
        self.depth = depth
        rates = list(drop_path) or [0.0] * depth
        for i in range(depth):
            self.add_module(f"block{i}", MLLABlock(dim, num_heads, mlp_ratio,
                                                   sr_ratio, rates[i],
                                                   fused_local_attn, fused_tail))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, generator)
        return x


class ProjectBlock(nn.Module):
    """conv3x3(stride) -> GELU -> LN -> conv3x3 [-> GELU -> LN], with torch's
    default conv bias init."""

    def __init__(self, in_channels: int, out_dim: int, stride: int,
                 last: bool = False):
        super().__init__()
        self.last = last
        self.conv1 = Conv(in_channels, out_dim, 3, stride, padding=1, torch_bias=True)
        self.norm1 = LayerNorm(out_dim)
        self.conv2 = Conv(out_dim, out_dim, 3, padding=1, torch_bias=True)
        if not last:
            self.norm2 = LayerNorm(out_dim)

    def forward(self, x):
        x = self.conv2(self.norm1(gelu(self.conv1(x))))
        return x if self.last else self.norm2(gelu(x))


class PatchEmbed(nn.Module):
    """Two ProjectBlocks; total stride 2 * (patch_size // 2)."""

    def __init__(self, in_channels: int, patch_size: int = 2, embed_dim: int = 96):
        super().__init__()
        self.proj1 = ProjectBlock(in_channels, embed_dim // 2, 2)
        self.proj2 = ProjectBlock(embed_dim // 2, embed_dim,
                                  max(patch_size // 2, 1), last=True)

    def forward(self, x):
        return self.proj2(self.proj1(x))


class MLLAEncoder(nn.Module):
    """4-stage MLLA encoder with MedNeXtDownBlock downsampling between
    stages. Returns [input, stage0, ..., stage3]. Block i of the whole stack
    drops its residual branches at rate ``linspace(0, drop_path_rate,
    sum(depths))[i]`` in training (``mlla.py:482``)."""

    def __init__(self, in_channels: int, patch_size: int = 2,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 mlp_ratio: float = 2.0,
                 sr_ratio: Sequence[int] = (16, 8, 4, 2),
                 drop_path_rate: float = 0.1,
                 fused_local_attn: Optional[bool] = None,
                 fused_tail: Optional[bool] = None):
        super().__init__()
        self.num_layers = len(depths)
        self.patch_embed = PatchEmbed(in_channels, patch_size, embed_dim)
        dpr = [float(r) for r in np.linspace(0, drop_path_rate, sum(depths))]
        for i in range(self.num_layers):
            dim = embed_dim * 2 ** i
            first = sum(depths[:i])
            self.add_module(f"layer{i}", BasicLayer(
                dim, depths[i], num_heads[i], mlp_ratio, sr_ratio[i],
                dpr[first:first + depths[i]], fused_local_attn, fused_tail))
            if i < self.num_layers - 1:
                self.add_module(f"down{i}", MedNeXtDownBlock(
                    dim, 2 * dim, exp_r=int(mlp_ratio), kernel_size=3, do_res=True))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        outs = [x]
        h = self.patch_embed(x)
        for i in range(self.num_layers):
            h = getattr(self, f"layer{i}")(h, generator)
            outs.append(h)
            if i < self.num_layers - 1:
                h = getattr(self, f"down{i}")(h)
        return outs
