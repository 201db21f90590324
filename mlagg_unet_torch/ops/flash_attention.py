"""Non-causal attention forward: kernel K4 (``csrc/flash_attn_fwd.cu``).

Replaces the Pallas kernel ``_flash_kernel`` of
``mlagg_unet_tpu/ops/flash_attention.py``. Layout (batch, heads, len, dim);
dk may differ from dv (the pooled branch attends with v = concat(v1, v2)).
On the TPU the JAX package skips its kernel below lk = 512; the port
launches K4 at every shape.

``attention_reference`` is the plain twin and the CPU path: fp32 scores and
softmax, probabilities rounded to v's dtype for the second product, output
in q's dtype. ``flash_attention`` runs it on a CPU tensor and launches K4 on
a CUDA tensor, or raises. On a CUDA tensor that needs a gradient it goes
through ``_FlashAttention``, whose forward is K4 and whose backward
recomputes ``attention_reference`` under autograd, as the JAX custom_vjp
does (``flash_attention.py:157-167``): the JAX package has no backward
kernel here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from mlagg_unet_torch.ops import _ext

FWD = _ext.Kernel(
    "flash_attn_fwd",
    _ext.KernelLib("flash_attn_fwd.cu", {
        "mlagg_flash_attn_fwd": [_ext.VP] * 4 + [_ext.I32] * 6 + [_ext.I64] * 9
        + [_ext.F32_ARG, _ext.I32, _ext.VP],
    }),
    "mlagg_flash_attn_fwd",
)
MAX_HEAD_DIM = 128


def attention_reference(q, k, v, scale: Optional[float] = None):
    """q: (b, h, lq, dk), k: (b, h, lk, dk), v: (b, h, lk, dv)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


class _FlashAttention(torch.autograd.Function):
    """K4 forward; the backward differentiates ``attention_reference``."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, go):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_reference(*qkv, ctx.scale)
            dq, dk, dv = torch.autograd.grad(out, qkv, go)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """softmax(q k^T * scale) v; returns (b, h, lq, dv) in q's dtype,
    differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if _ext.use_plain(q):
        return attention_reference(q, k, v, scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, float(scale))
    return _launch(q, k, v, scale)


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """K4 on CUDA tensors (strided views with a unit last stride taken as
    they are)."""
    B, H, Lq, dk = q.shape
    Lk, dv = k.shape[2], v.shape[-1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    if k.shape != (B, H, Lk, dk) or v.shape != (B, H, Lk, dv):
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)} "
                         f"k {tuple(k.shape)} v {tuple(v.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q is {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit stride "
                             f"on its last axis, has {t.stride()}")
    if not (0 < dk <= MAX_HEAD_DIM and 0 < dv <= MAX_HEAD_DIM and Lk > 0):
        raise ValueError(f"flash_attention: dk={dk}, dv={dv}, lk={Lk} out of "
                         f"range (head dims 1..{MAX_HEAD_DIM}, lk >= 1)")
    o = torch.empty(B, H, Lq, dv, device=q.device, dtype=q.dtype)
    FWD.launch(
        _ext.ptr(q), _ext.ptr(k), _ext.ptr(v), _ext.ptr(o), B, H, Lq, Lk,
        dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _ext.BF16 if q.dtype == torch.bfloat16 else _ext.F32,
        _ext.stream_ptr(q.device))
    return o
