"""Fused instance norm: kernels K7 (stats) and K8 (apply), ``csrc/fused_norm.cu``.

Replace the Pallas kernels ``_stats_kernel`` and ``_apply_kernel`` of
``mlagg_unet_tpu/ops/fused_norm.py`` (``fused_instance_norm``):

    y = IN(x) * scale + bias  [+ IN(residual) * res_scale + res_bias | + residual]
    [LeakyReLU(0.01)]

with fp32 per-(sample, channel) sums over every spatial position, the fast
variance ``E[x^2] - E[x]^2`` (not clamped, unlike ``layers.InstanceNorm``), a
raw residual added in fp32, and one cast to x's dtype at the end.
``instance_norm_plain`` is the plain twin, the JAX package's ``_functional``.

The kernels' own wrappers, ``instance_norm_stats`` (K7) and
``instance_norm_apply`` (K8), take (N, S, C) tensors and have plain twins of
their own. ``fused_instance_norm`` runs the twin on a CPU tensor and K7 then
K8 on a CUDA tensor, or raises. When a gradient is needed it goes through
``_FusedInstanceNorm``, whose backward recomputes the plain twin under
autograd, as the JAX custom_vjp does (``fused_norm.py:251-256``): there is no
backward kernel. The switch ``MLAGG_FUSED_IN`` (``fused_norms_enabled``)
decides, as in the JAX package, whether ``UnetResBlock`` takes this path.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from mlagg_unet_torch.ops import _ext

_LIB = _ext.KernelLib("fused_norm.cu", {
    "mlagg_in_stats": [_ext.VP] * 3 + [_ext.I32, _ext.I64, _ext.I32, _ext.I32,
                                      _ext.I32, _ext.VP],
    "mlagg_in_apply": [_ext.VP] * 9 + [_ext.I32, _ext.I64, _ext.I32, _ext.F32_ARG]
    + [_ext.I32] * 3 + [_ext.VP],
})
STATS = _ext.Kernel("instance_norm_stats", _LIB, "mlagg_in_stats")
APPLY = _ext.Kernel("instance_norm_apply", _LIB, "mlagg_in_apply")
CTAS_PER_SM = 4   # K7 splits each sample's positions over this many CTAs per SM


def fused_norms_enabled(flag: Optional[bool] = None) -> bool:
    """``flag``, or where it is None the JAX package's switch:
    ``MLAGG_FUSED_IN == "1"`` (off by default)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("MLAGG_FUSED_IN", "0") == "1"


def _res_mode(residual, res_scale) -> int:
    if residual is None:
        return 0
    return 1 if res_scale is None else 2


def instance_norm_plain(x, scale, bias, *, act: bool = False, residual=None,
                        res_scale=None, res_bias=None, eps: float = 1e-5):
    """The plain twin (``fused_norm.py:212-232``). x: (N, *spatial, C)."""
    red = tuple(range(1, x.ndim - 1))

    def norm(v, s, b):
        vf = v.float()
        mean = vf.mean(red, keepdim=True)
        var = (vf * vf).mean(red, keepdim=True) - mean * mean
        return (vf - mean) * torch.rsqrt(var + eps) * s.float() + b.float()

    y = norm(x, scale, bias)
    mode = _res_mode(residual, res_scale)
    if mode == 2:
        y = y + norm(residual, res_scale, res_bias)
    elif mode == 1:
        y = y + residual.float()
    if act:
        y = F.leaky_relu(y, 0.01)
    return y.to(x.dtype)


def _rows(t):
    """(N, *spatial, C) -> a contiguous (N, S, C) view (a copy only where the
    tensor's memory is not already in that order)."""
    return t.reshape(t.shape[0], -1, t.shape[-1]).contiguous()


def instance_norm_stats_plain(x3):
    """K7's plain twin: fp32 (N, 2, C) [sum, sum of squares] over axis 1 of
    an (N, S, C) tensor."""
    xf = x3.float()
    return torch.stack([xf.sum(1), (xf * xf).sum(1)], dim=1)


def instance_norm_stats(x3):
    """K7 on a contiguous CUDA (N, S, C) tensor, its plain twin on a CPU one."""
    if _ext.use_plain(x3):
        return instance_norm_stats_plain(x3)
    if x3.ndim != 3 or not x3.is_contiguous() or x3.dtype not in (torch.float32,
                                                                  torch.bfloat16):
        raise ValueError(f"instance_norm_stats: takes a contiguous fp32 or bf16 "
                         f"(N, S, C), got {tuple(x3.shape)} {x3.dtype}")
    N, S, C = x3.shape
    sms = torch.cuda.get_device_properties(x3.device).multi_processor_count
    P = max(1, min(math.ceil(S / 256), math.ceil(CTAS_PER_SM * sms / N)))
    f32 = dict(device=x3.device, dtype=torch.float32)
    part = torch.empty(N, P, 2, C, **f32)
    stats = torch.empty(N, 2, C, **f32)
    STATS.launch(_ext.ptr(x3), _ext.ptr(part), _ext.ptr(stats), N, S, C, P,
                 _dtype_code(x3), _ext.stream_ptr(x3.device))
    return stats


def _normalize(v, st, s, b, eps):
    """fp32 (v - mean) * rsqrt(var + eps) * s + b from [sum, sum of squares]."""
    n = v.shape[1]
    mean = st[:, 0:1] / n
    var = st[:, 1:2] / n - mean * mean
    return (v.float() - mean) * torch.rsqrt(var + eps) * s.float() + b.float()


def instance_norm_apply_plain(x3, stats, scale, bias, residual=None, res_stats=None,
                              res_scale=None, res_bias=None, act: bool = False,
                              eps: float = 1e-5):
    """K8's plain twin: the normalisation of (N, S, C) tensors from their
    ``instance_norm_stats``, the residual (mode 1 raw, mode 2 normalised)
    and the activation, cast to x's dtype."""
    y = _normalize(x3, stats, scale, bias, eps)
    mode = _res_mode(residual, res_scale)
    if mode == 2:
        y = y + _normalize(residual, res_stats, res_scale, res_bias, eps)
    elif mode == 1:
        y = y + residual.float()
    if act:
        y = F.leaky_relu(y, 0.01)
    return y.to(x3.dtype)


def instance_norm_apply(x3, stats, scale, bias, residual=None, res_stats=None,
                        res_scale=None, res_bias=None, act: bool = False,
                        eps: float = 1e-5):
    """K8 on contiguous CUDA (N, S, C) tensors, its plain twin on CPU ones."""
    if _ext.use_plain(x3):
        return instance_norm_apply_plain(x3, stats, scale, bias, residual, res_stats,
                                         res_scale, res_bias, act, eps)
    mode = _res_mode(residual, res_scale)
    N, S, C = x3.shape
    if x3.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"instance_norm_apply: dtype {x3.dtype} not supported")
    tensors = [x3] + ([residual] if mode else [])
    for t in tensors:
        if t.shape != x3.shape or t.dtype != x3.dtype or t.device != x3.device \
                or not t.is_contiguous():
            raise ValueError(f"instance_norm_apply: x and the residual must be "
                             f"contiguous {tuple(x3.shape)} {x3.dtype} on {x3.device}")
    for st in [stats] + ([res_stats] if mode == 2 else []):
        if (st is None or st.shape != (N, 2, C) or st.dtype != torch.float32
                or st.device != x3.device or not st.is_contiguous()):
            raise ValueError(f"instance_norm_apply: stats must be contiguous fp32 "
                             f"({N}, 2, {C}) on {x3.device}")
    vecs = [scale, bias] + ([res_scale, res_bias] if mode == 2 else [])
    for v in vecs:
        if v is None or v.shape != (C,) or v.device != x3.device:
            raise ValueError(f"instance_norm_apply: scale and bias must be ({C},) "
                             f"on {x3.device}")
    sc, bi, *rv = (v.float().contiguous() for v in vecs)
    out = torch.empty_like(x3)
    APPLY.launch(*map(_ext.ptr, (x3, stats, sc, bi, residual if mode else None,
                                 res_stats if mode == 2 else None,
                                 *(rv or [None, None]), out)),
                 N, S, C, float(eps), mode, int(act), _dtype_code(x3),
                 _ext.stream_ptr(x3.device))
    return out


def _launch(x, scale, bias, residual, res_scale, res_bias, act, eps):
    """K7 (x and, in mode 2, the residual) then K8, on CUDA tensors."""
    if x.ndim < 3 or x.numel() == 0:
        raise ValueError(f"fused_instance_norm: x {tuple(x.shape)} is not (N, *spatial, C)")
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"fused_instance_norm: residual {tuple(residual.shape)} "
                         f"!= x {tuple(x.shape)}")
    x3 = _rows(x)
    r3 = None if residual is None else _rows(residual)
    rst = instance_norm_stats(r3) if res_scale is not None and r3 is not None else None
    return instance_norm_apply(x3, instance_norm_stats(x3), scale, bias, r3, rst,
                               res_scale, res_bias, act, eps).view(x.shape)


class _FusedInstanceNorm(torch.autograd.Function):
    """K7 + K8 forward (the plain twin on a CPU tensor); the backward
    differentiates ``instance_norm_plain``."""

    @staticmethod
    def forward(ctx, x, scale, bias, residual, res_scale, res_bias, act, eps):
        ctx.save_for_backward(x, scale, bias, residual, res_scale, res_bias)
        ctx.flags = (act, eps)
        if _ext.use_plain(x):
            return instance_norm_plain(x, scale, bias, act=act, residual=residual,
                                       res_scale=res_scale, res_bias=res_bias, eps=eps)
        return _launch(x, scale, bias, residual, res_scale, res_bias, act, eps)

    @staticmethod
    def backward(ctx, go):
        act, eps = ctx.flags
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_() for t in saved]
            x, scale, bias, residual, res_scale, res_bias = leaves
            out = instance_norm_plain(x, scale, bias, act=act, residual=residual,
                                      res_scale=res_scale, res_bias=res_bias, eps=eps)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, go))
        return (*(None if t is None else next(grads) for t in leaves), None, None)


def fused_instance_norm(x, scale, bias, *, act: bool = False,
                        residual: Optional[torch.Tensor] = None,
                        res_scale: Optional[torch.Tensor] = None,
                        res_bias: Optional[torch.Tensor] = None,
                        eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm(x) * scale + bias [+ InstanceNorm(residual) * res_scale +
    res_bias | + residual] [LeakyReLU 0.01]; x: (N, *spatial, C), returned in
    x's shape and dtype. A residual with ``res_scale`` (and ``res_bias``) is
    normalised (mode 2), without them added raw (mode 1). Differentiable in
    every tensor argument."""
    if residual is not None and (res_scale is None) != (res_bias is None):
        raise ValueError("fused_instance_norm: give res_scale and res_bias together")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, scale, bias, residual, res_scale, res_bias)):
        return _FusedInstanceNorm.apply(x, scale, bias, residual, res_scale,
                                        res_bias, bool(act), float(eps))
    if _ext.use_plain(x):
        return instance_norm_plain(x, scale, bias, act=act, residual=residual,
                                   res_scale=res_scale, res_bias=res_bias, eps=eps)
    return _launch(x, scale, bias, residual, res_scale, res_bias, act, eps)


def _dtype_code(t):
    return _ext.BF16 if t.dtype == torch.bfloat16 else _ext.F32
