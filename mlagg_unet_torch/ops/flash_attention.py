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

K4 is two kernels in one source, picked by ``launch_plan`` from the type
alone: bf16 launches ``flash_fwd_mma_kernel`` (tensor-core ``mma.sync``,
q streamed with ``cp.async``, persistent CTAs on a 1-D grid), fp32 the
scalar ``flash_fwd_fp32_kernel``. The plan is a pure function of shapes,
strides, q's address and the number of SMs, so the CPU tests hold it.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from mlagg_unet_torch.ops import _ext

FWD = _ext.Kernel(
    "flash_attn_fwd",
    _ext.KernelLib("flash_attn_fwd.cu", {
        "mlagg_flash_attn_fwd": [_ext.VP] * 4 + [_ext.I32] * 6 + [_ext.I64] * 9
        + [_ext.F32_ARG] + [_ext.I32] * 6 + [_ext.I64, _ext.VP],
    }),
    "mlagg_flash_attn_fwd",
)
MAX_HEAD_DIM = 128
BQ = 64                  # query rows per tile, both kernels
# CTAs per SM the mma kernel's grid aims at: the narrow instantiation (dk_pad
# <= 32, dv_pad <= 48; the flagship's) is built for 5 resident per SM (its
# __launch_bounds__), the wide one's ~200 registers leave room for 2
CTAS_PER_SM_NARROW, CTAS_PER_SM_WIDE = 5, 2
MAX_GRID = 2 ** 31 - 1


class LaunchPlan(NamedTuple):
    kernel: str          # "flash_fwd_mma_kernel" (bf16) or "flash_fwd_fp32_kernel"
    dk_pad: int          # dk padded to a multiple of 16 (mma), else dk
    dv_pad: int          # dv padded to a multiple of 8 (mma), else dv
    copy_bytes: int      # width of q's cp.async copies: 16, 4, or 2 (plain loads)
    kv_copy_bytes: int   # the same for k and v (one width for both)
    tiles_per_cta: int   # 64-row query tiles each CTA walks (fp32: 1)
    grid: int            # CTAs on the 1-D grid


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


def _copy_bytes(t) -> int:
    """The widest of 16 and 4 bytes that t's start, its row length and every
    stride along a dimension longer than 1 are multiples of; else 2."""
    size = t.element_size()
    spans = [t.data_ptr(), t.shape[-1] * size]
    spans += [st * size for n, st in zip(t.shape[:3], t.stride()[:3]) if n > 1]
    for width in (16, 4):
        if all(x % width == 0 for x in spans):
            return width
    return 2


def launch_plan(q, k, v, num_sms: int) -> LaunchPlan:
    """Check what K4 takes and plan its launch; raises on what it does not
    take. Works on tensors of any device (the CPU tests call it)."""
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
    tiles = -(-Lq // BQ)
    if q.dtype == torch.float32:
        plan = LaunchPlan("flash_fwd_fp32_kernel", dk, dv, 0, 0, 1, B * H * tiles)
    else:
        dkp, dvp = -(-dk // 16) * 16, -(-dv // 8) * 8
        total = B * H * tiles
        per_sm = CTAS_PER_SM_NARROW if dkp <= 32 and dvp <= 48 else CTAS_PER_SM_WIDE
        per_cta = -(-total // (per_sm * num_sms))
        per_cta = max(1, min(tiles, per_cta))
        chunks = -(-tiles // per_cta)
        plan = LaunchPlan("flash_fwd_mma_kernel", dkp, dvp,
                          _copy_bytes(q), min(_copy_bytes(k), _copy_bytes(v)), per_cta,
                          B * H * chunks)
    if plan.grid > MAX_GRID:
        raise ValueError(f"flash_attention: {plan.grid} CTAs exceed the grid's {MAX_GRID}")
    return plan


def _launch(q, k, v, scale: float) -> torch.Tensor:
    """K4 on CUDA tensors (strided views with a unit last stride taken as
    they are)."""
    plan = launch_plan(q, k, v, torch.cuda.get_device_properties(q.device).multi_processor_count)
    B, H, Lq, dk = q.shape
    Lk, dv = k.shape[2], v.shape[-1]
    o = torch.empty(B, H, Lq, dv, device=q.device, dtype=q.dtype)
    if plan.grid == 0:  # no query rows
        return o
    FWD.launch(
        _ext.ptr(q), _ext.ptr(k), _ext.ptr(v), _ext.ptr(o), B, H, Lq, Lk,
        dk, dv, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _ext.BF16 if q.dtype == torch.bfloat16 else _ext.F32,
        plan.dk_pad, plan.dv_pad, plan.copy_bytes, plan.kv_copy_bytes, plan.tiles_per_cta,
        plan.grid,
        _ext.stream_ptr(q.device))
    return o
