"""The Mamba-1 block and the single-scale SS2D cell, channels-last.

Counterparts of ``MambaBlock`` (``mlagg_unet_tpu/models/mamba_block.py:33-127``)
and ``SS2D`` (``:130-311``). Every selective scan goes through
``ops.selective_scan_cuda.selective_scan_fwd``: kernel K1 on the GPU (with K5
as its backward in training), the plain chunked scan on the CPU.

``MambaBlock`` is mamba_ssm's block: in_proj, a causal depthwise conv1d
(``padding=(d_conv - 1, 0)``) and SiLU, x_proj / dt_proj, the scan in layout
(b, 1, d_inner, L), the SiLU(z) gate and out_proj. The conv runs on the
channels-first view, which is already the scan's layout, and B, C and delta
are projected straight into (b, n, L) / (b, d_inner, L), contiguous as K1
takes them. ``bimamba_type="v3"`` adds SegMamba's backward branch (the
sequence flipped) and inter-slice branch (the sequence re-ordered across
``nslices`` slices), summed before the gate; ``project_out=False`` returns
the gated d_inner features.

``SS2D`` is VMamba's cell: in_proj (with or without the z half), a depthwise
conv + SiLU, the scan over 1, 2 or 4 directions, an out-norm tail, the gate
and out_proj. ``forward_type`` is parsed as in JAX (``:149-174``): the scan
runs in fp32 except for v04 / v05 / v3 and the 1- and 2-direction types,
which scan in the input dtype; the ``_no32``, ``_noz``, ``_nozact``,
``_onnone``, ``_onsoftmax``, ``_onsigmoid`` and ``_ondwconv3`` tails may be
combined. Four directions scan the row- and column-major layouts forward
(parameter groups 0-1) and then in reverse (groups 2-3), without flip copies.

Both modules compute what JAX computes in either dtype. In a 16-bit
compute dtype the scan's output stays fp32, as JAX's does: the gate and
out_proj (and SS2D's out-norm tail) promote to fp32 as flax's layers do, so
a network whose parameters were cast to bf16 computes in fp32, its
parameters widened, from its first Mamba block on (``layers.promote_dtype``). A
16-bit input to the scan is widened to fp32 exactly, as JAX's scan widens
it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mlagg_unet_torch.models.layers import Conv, Dense, LayerNorm, promote_dtype, lecun_normal_
from mlagg_unet_torch.ops.cross_scan import (
    _dirs01,
    cross_merge_1direction,
    cross_merge_2direction,
    cross_scan_1direction,
    cross_scan_2direction,
)
from mlagg_unet_torch.ops.selective_scan_cuda import selective_scan_fwd

DT_MIN, DT_MAX, DT_INIT_FLOOR = 0.001, 0.1, 1e-4  # dt bias init range


def _dt_bias_(b: torch.Tensor, gen: torch.Generator) -> None:
    """softplus^-1 of dt ~ logU(DT_MIN, DT_MAX), floored (``mamba_skip.py:64``)."""
    with torch.no_grad():
        u = torch.rand(b.shape, generator=gen)
        dt = torch.exp(u * (math.log(DT_MAX) - math.log(DT_MIN)) + math.log(DT_MIN))
        dt = torch.clamp(dt, min=DT_INIT_FLOOR)
        b.copy_(dt + torch.log(-torch.expm1(-dt)))


def _a_log_(a: torch.Tensor) -> None:
    """S4D-real: log(1..n) along the last axis."""
    with torch.no_grad():
        n = a.shape[-1]
        a.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32)).expand_as(a))


class CausalConv1d(nn.Module):
    """flax ``nn.Conv(d, (k,), padding=[(k - 1, 0)], feature_group_count=d)``
    on (B, d, L) channels-first input: ``weight`` (d, 1, k), ``bias`` (d,)."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.k = kernel_size
        self.weight = nn.Parameter(torch.empty(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.empty(channels))

    def init_parameters(self, gen):
        lecun_normal_(self.weight, self.k, gen)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        x, w, b = promote_dtype(x, self.weight, self.bias)
        return F.conv1d(F.pad(x, (self.k - 1, 0)), w, b, groups=w.shape[0])


class MambaBlock(nn.Module):
    """mamba_ssm's ``Mamba``: (B, L, d_model) -> (B, L, d_model), or the
    gated (B, L, d_inner) with ``project_out=False``."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 4,
                 expand: int = 2, project_out: bool = True,
                 bimamba_type: Optional[str] = None, nslices: int = 0):
        super().__init__()
        if bimamba_type not in (None, "v3"):
            raise NotImplementedError(f"bimamba_type {bimamba_type!r}")
        self.d_inner = d_inner = expand * d_model
        self.d_state = d_state
        self.dt_rank = math.ceil(d_model / 16)
        self.project_out = project_out
        self.bimamba_type = bimamba_type
        self.nslices = nslices
        self.suffixes = ("", "_b", "_s") if bimamba_type == "v3" else ("",)
        self.in_proj = Dense(d_model, 2 * d_inner, bias=False)
        for s in self.suffixes:
            self.add_module(f"conv1d{s}", CausalConv1d(d_inner, d_conv))
            self.add_module(f"x_proj{s}", Dense(d_inner, self.dt_rank + 2 * d_state,
                                                bias=False))
            self.register_parameter(f"dt_proj{s}_weight",
                                    nn.Parameter(torch.empty(d_inner, self.dt_rank)))
            self.register_parameter(f"dt_proj{s}_bias", nn.Parameter(torch.empty(d_inner)))
            self.register_parameter(f"A{s}_log", nn.Parameter(torch.empty(1, d_inner, d_state)))
            self.register_parameter(f"D{s}", nn.Parameter(torch.empty(d_inner)))
        if project_out:
            self.out_proj = Dense(d_inner, d_model, bias=False)

    def init_parameters(self, gen):
        with torch.no_grad():
            std = self.dt_rank ** -0.5
            for s in self.suffixes:
                nn.init.uniform_(getattr(self, f"dt_proj{s}_weight"), -std, std, generator=gen)
                _dt_bias_(getattr(self, f"dt_proj{s}_bias"), gen)
                _a_log_(getattr(self, f"A{s}_log"))
                getattr(self, f"D{s}").fill_(1.0)

    def _branch(self, xb: torch.Tensor, s: str) -> torch.Tensor:
        """(B, L, d_inner) tokens -> the scan's (B, L, d_inner) fp32 output:
        the causal conv + SiLU, then x_proj / dt_proj and the scan, all on
        the channels-first (B, d_inner, L) view."""
        r, n = self.dt_rank, self.d_state
        h = F.silu(getattr(self, f"conv1d{s}")(xb.transpose(1, 2)))      # (B, d, L)
        h, w = promote_dtype(h, getattr(self, f"x_proj{s}").weight)       # w: (r + 2n, d)
        dt = torch.einsum("cd,bdl->bcl", w[:r], h)                        # (B, r, L)
        u = h.float().unsqueeze(1)                                         # (B, 1, d, L)
        proj = lambda wk: torch.einsum(  # noqa: E731
            "cd,bdl->bcl", wk, h).float().unsqueeze(1).contiguous()
        delta = torch.einsum("dr,brl->bdl", getattr(self, f"dt_proj{s}_weight").float(),
                             dt.float()).unsqueeze(1).contiguous()
        A = -torch.exp(getattr(self, f"A{s}_log"))
        y = selective_scan_fwd(
            u.contiguous(), delta, A, proj(w[r:r + n]), proj(w[r + n:]),
            getattr(self, f"D{s}")[None], getattr(self, f"dt_proj{s}_bias")[None],
            delta_softplus=True)
        return y[:, 0].transpose(1, 2)                                     # (B, L, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, _ = x.shape
        d = self.d_inner
        xh, z = self.in_proj(x).chunk(2, dim=-1)
        y = self._branch(xh, "")
        if self.bimamba_type == "v3":
            # the backward branch on the flipped sequence, flipped back; the
            # inter-slice branch walks the slices at each in-slice position
            y = y + self._branch(xh.flip(1), "_b").flip(1)
            ns = self.nslices
            if ns <= 0 or L % ns:
                raise ValueError(f"bimamba v3 needs nslices ({ns}) dividing L ({L})")
            xs = xh.reshape(B, ns, L // ns, d).transpose(1, 2).reshape(B, L, d)
            ys = self._branch(xs, "_s").reshape(B, L // ns, ns, d)
            y = y + ys.transpose(1, 2).reshape(B, L, d)
        y = y * F.silu(z)
        return self.out_proj(y) if self.project_out else y


_FT_TAGS = ("_no32", "_noz", "_nozact", "_onnone", "_onsoftmax", "_onsigmoid", "_ondwconv3")


def parse_forward_type(forward_type: str):
    """(flags, force_fp32, directions) of an SS2D ``forward_type``
    (``mamba_block.py:149-174``): the tags are stripped from the end until
    none is left, in any order."""
    ft, flags = forward_type, {}
    stripped = True
    while stripped:
        stripped = False
        for tag in _FT_TAGS:
            if ft.endswith(tag):
                flags[tag] = True
                ft = ft[: -len(tag)]
                stripped = True
    force_fp32 = (ft not in ("v04", "v05", "v3", "v051d", "v052d", "v31d", "v32d")
                  and not flags.get("_no32"))
    directions = 1 if ft in ("v31d", "v051d") else 2 if ft in ("v32d", "v052d") else 4
    return flags, force_fp32, directions


K_DIRS = 4


class SS2D(nn.Module):
    """VMamba's single-scale cell: (B, H, W, d_model) -> (B, H, W, d_model)."""

    def __init__(self, d_model: int, d_state: int = 16, d_conv: int = 3,
                 conv_bias: bool = True, expand: float = 2.0, dropout: float = 0.0,
                 forward_type: str = "v2"):
        super().__init__()
        if dropout:
            raise NotImplementedError("SS2D with dropout > 0: no network of the repo uses it")
        self.flags, self.force_fp32, self.directions = parse_forward_type(forward_type)
        self.d_inner = d_inner = int(expand * d_model)
        self.d_state = d_state
        self.dt_rank = r = math.ceil(d_model / 16)
        self.has_z = not self.flags.get("_noz")
        self.in_proj = Dense(d_model, (2 if self.has_z else 1) * d_inner, bias=False)
        self.conv2d = Conv(d_inner, d_inner, d_conv, groups=d_inner, bias=conv_bias)
        self.x_proj_weight = nn.Parameter(torch.empty(K_DIRS, r + 2 * d_state, d_inner))
        self.dt_projs_weight = nn.Parameter(torch.empty(K_DIRS, d_inner, r))
        self.dt_projs_bias = nn.Parameter(torch.empty(K_DIRS, d_inner))
        self.A_logs = nn.Parameter(torch.empty(K_DIRS, d_inner, d_state))
        self.Ds = nn.Parameter(torch.empty(K_DIRS, d_inner))
        f = self.flags
        if f.get("_ondwconv3"):
            self.out_norm_dwconv = Conv(d_inner, d_inner, 3, groups=d_inner)
        elif not (f.get("_onnone") or f.get("_onsoftmax") or f.get("_onsigmoid")):
            self.out_norm = LayerNorm(d_inner)
        self.out_proj = Dense(d_inner, d_model, bias=False)

    def init_parameters(self, gen):
        """flax's lecun normal for x_proj_weight, then the scan's init
        (``mamba_block.py:206-220``)."""
        w = self.x_proj_weight
        lecun_normal_(w, w.numel() // w.shape[-1], gen)
        with torch.no_grad():
            std = self.dt_rank ** -0.5
            nn.init.uniform_(self.dt_projs_weight, -std, std, generator=gen)
            _dt_bias_(self.dt_projs_bias, gen)
            _a_log_(self.A_logs)
            self.Ds.fill_(1.0)

    def _project_and_scan(self, xs: torch.Tensor, ks: slice, reverse: bool, A):
        """xs: (B, k, d_inner, L) -> the scan's fp32 (B, k, d_inner, L)."""
        sdt = torch.float32 if self.force_fp32 else xs.dtype
        xs = xs.to(sdt).contiguous()
        r, n = self.dt_rank, self.d_state
        w = self.x_proj_weight[ks].to(sdt)
        proj = lambda wk: torch.einsum("bkdl,kcd->bkcl", xs, wk).contiguous()  # noqa: E731
        dts = torch.einsum("bkrl,kdr->bkdl", proj(w[:, :r]),
                           self.dt_projs_weight[ks].to(sdt)).contiguous()
        return selective_scan_fwd(xs, dts, A[ks], proj(w[:, r:r + n]), proj(w[:, r + n:]),
                                  self.Ds[ks], self.dt_projs_bias[ks], delta_softplus=True,
                                  reverse=reverse)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        B, H, W, _ = x.shape
        d, L = self.d_inner, H * W
        if self.has_z:
            xh, z = self.in_proj(x).chunk(2, dim=-1)
        else:
            xh, z = self.in_proj(x), None
        xh = F.silu(self.conv2d(xh))
        A = -torch.exp(self.A_logs)
        if self.directions == 4:
            xs2 = _dirs01(xh)                                     # (B, 2, d, L)
            y_f = self._project_and_scan(xs2, slice(0, 2), False, A)
            y_r = self._project_and_scan(xs2, slice(2, 4), True, A)
            row = y_f[:, 0] + y_r[:, 0]
            col = (y_f[:, 1] + y_r[:, 1]).reshape(B, d, W, H).transpose(2, 3).reshape(B, d, L)
            y = (row + col).transpose(1, 2)                       # (B, L, d)
        else:
            scan, merge = ((cross_scan_1direction, cross_merge_1direction)
                           if self.directions == 1
                           else (cross_scan_2direction, cross_merge_2direction))
            ys = self._project_and_scan(scan(xh), slice(0, K_DIRS), False, A)
            y = merge(ys, H, W).transpose(1, 2)
        f = self.flags
        if f.get("_onnone"):
            pass
        elif f.get("_onsoftmax"):
            y = torch.softmax(y, dim=1)                           # over L
        elif f.get("_onsigmoid"):
            y = torch.sigmoid(y)
        elif f.get("_ondwconv3"):
            y = self.out_norm_dwconv(y.reshape(B, H, W, d)).reshape(B, L, d)
        else:
            y = self.out_norm(y)
        y = y.reshape(B, H, W, d)
        if z is not None:
            y = y * (z if f.get("_nozact") else F.silu(z))
        return self.out_proj(y)
