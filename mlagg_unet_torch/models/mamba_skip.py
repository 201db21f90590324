"""Multi-Scale Mamba Module (MSMM) skip connections, NHWC.

Counterparts of ``SS2DSkip`` (``mlagg_unet_tpu/models/mamba_skip.py:80-224``,
its non-interleaved branch) and ``VSSConvBlock`` / ``VSSConvLayer``
(``:227-300``). The four scan directions run over the token sequences of all
scales concatenated: two layouts, each scanned forward (directions 0/1) and
in reverse over the reversed scale order (directions 2/3). The scan is
``ops.selective_scan_cuda.selective_scan_fwd``: kernel K1 on the GPU, the
plain chunked scan on the CPU; its output is fp32.
"""
from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import (
    Conv,
    ConvolutionalGLU,
    Dense,
    DepthwiseConv,
    InstanceNorm,
    LayerNorm,
    lecun_normal_,
)
from mlagg_unet_torch.ops.cross_scan import (
    cross_merge_multiscale_tokens_2dir,
    cross_scan_multiscale_2dir,
)
from mlagg_unet_torch.ops.selective_scan_cuda import selective_scan_fwd

K_DIRS = 4
D_CONV = 3
DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4  # dt bias init range


class SS2DSkip(nn.Module):
    """Multi-scale 4-direction selective scan cell. Takes and returns a list
    of per-scale NHWC maps with ``d_model`` channels."""

    def __init__(self, d_model: int, d_state: int = 16, expand: float = 2.0,
                 stage_num: int = 4):
        super().__init__()
        self.d_inner = d_inner = int(expand * d_model)
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.in_proj = Dense(d_model, d_inner, bias=False)
        for i in range(stage_num):
            self.add_module(f"conv2d_{i}", DepthwiseConv(d_inner, D_CONV))
        self.x_proj_weight = nn.Parameter(
            torch.empty(K_DIRS, self.dt_rank + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, self.dt_rank))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS, d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.out_norm = LayerNorm(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=False)

    def init_parameters(self, gen):
        """S4D-real A_log = log(1..n), softplus-inverse dt bias, D = 1
        (``mamba_skip.py:46-77``)."""
        w = self.x_proj_weight
        lecun_normal_(w, w.numel() // w.shape[-1], gen)
        with torch.no_grad():
            std = self.dt_rank ** -0.5
            nn.init.uniform_(self.dt_projs_weight, -std, std, generator=gen)
            u = torch.rand(self.dt_projs_bias.shape, generator=gen)
            dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
            dt = torch.clamp(dt, min=DT_INIT_FLOOR)
            self.dt_projs_bias.copy_(dt + torch.log(-torch.expm1(-dt)))
            a = torch.arange(1, self.d_state + 1, dtype=torch.float32)
            self.A_logs.copy_(torch.log(a).expand_as(self.A_logs))
            self.Ds.fill_(1.0)

    def _project_and_scan(self, xs, ks: slice, reverse: bool, A):
        cdt = xs.dtype
        r, n = self.dt_rank, self.d_state
        w = self.x_proj_weight[ks].to(cdt)                # (2, r + 2n, d)
        proj = lambda wk: torch.einsum("bkdl,kcd->bkcl", xs, wk).contiguous()  # noqa: E731
        dts = torch.einsum("bkrl,kdr->bkdl", proj(w[:, :r]),
                           self.dt_projs_weight[ks].to(cdt)).contiguous()
        return selective_scan_fwd(
            xs, dts, A[ks], proj(w[:, r:r + n]), proj(w[:, r + n:]),
            self.Ds[ks], self.dt_projs_bias[ks], delta_softplus=True,
            reverse=reverse)

    def forward(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        B = xs[0].shape[0]
        shapes = [(x.shape[1], x.shape[2]) for x in xs]
        feats = [F.silu(getattr(self, f"conv2d_{i}")(self.in_proj(x)))
                 for i, x in enumerate(xs)]
        xs_fwd, l_split = cross_scan_multiscale_2dir(feats)
        xs_rev, _ = cross_scan_multiscale_2dir(feats, reverse_scales=True)
        A = -torch.exp(self.A_logs)
        out_fwd = self._project_and_scan(xs_fwd, slice(0, 2), False, A)
        out_rev = self._project_and_scan(xs_rev, slice(2, 4), True, A)
        y_scales = cross_merge_multiscale_tokens_2dir(out_fwd, out_rev, shapes,
                                                      l_split)
        cdt = xs_fwd.dtype
        return [self.out_proj(self.out_norm(y).to(cdt)).reshape(B, H, W, -1)
                for (H, W), y in zip(shapes, y_scales)]


class VSSConvBlock(nn.Module):
    """Channel-split mamba + conv skip block: the first ``hidden_dim``
    channels of every scale go through the shared multi-scale scan and a
    per-scale ConvGLU, the rest through Conv3x3 + InstanceNorm + SiLU."""

    def __init__(self, feature_dims: Sequence[int], hidden_dim: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.n = len(feature_dims)
        self.ln_1 = LayerNorm(hidden_dim)
        self.self_attention = SS2DSkip(hidden_dim, stage_num=self.n)
        self.norm2 = LayerNorm(hidden_dim)
        for i, c in enumerate(feature_dims):
            self.add_module(f"mlp{i}", ConvolutionalGLU(
                hidden_dim, hidden_dim * 4, act=F.silu))
            cc = c - hidden_dim
            self.add_module(f"conv_branch{i}", Conv(cc, cc, 3))
            self.add_module(f"conv_norm{i}", InstanceNorm(cc))

    def forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        hd = self.hidden_dim
        m_branch = [x[..., :hd] for x in inputs]
        scanned = self.self_attention([self.ln_1(m) for m in m_branch])
        outs = []
        for i in range(self.n):
            m = self.norm2(m_branch[i] + scanned[i])
            m = m + getattr(self, f"mlp{i}")(m)
            c = getattr(self, f"conv_branch{i}")(inputs[i][..., hd:])
            c = F.silu(getattr(self, f"conv_norm{i}")(c))
            outs.append(torch.cat([m, c], dim=-1))
        return outs


class VSSConvLayer(nn.Module):
    """A stack of VSSConvBlocks over the encoder scales."""

    def __init__(self, feature_dims: Sequence[int], hidden_dim: int,
                 depth: int = 1):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"block{i}", VSSConvBlock(feature_dims, hidden_dim))

    def forward(self, xs):
        for i in range(self.depth):
            xs = getattr(self, f"block{i}")(xs)
        return xs
