"""Fused local aggregated attention: kernel K6 (``csrc/mlla_local_attn.cu``).

Replaces the Pallas kernel ``_local_attn_kernel`` of
``mlagg_unet_tpu/ops/mlla_attn_fused.py`` (``local_aggregated_attention_fused``):
the whole local half of the flagship's AggregatedAttention in one pass, per
token of a (B, H, W, ch) map with nh differential heads of head_dim
hd = ch / nh / 2:

    q = (x Wq^T + bq) hd^-0.5 (fp32);  k, v = x Wkv^T + bkv, rounded to x's dtype
    per q-group, the 3x3 window's logits q.k (-1e30 at taps outside the image)
    A1, A2 = softmax of each DiffAttn branch;  o = A1 v - lambda A2 v
    o = RMSNorm(o) over each v-head's 2 hd channels (eps 1e-5) * subln * (1 - lambda_init)
    out = o + LePE(v), the depthwise 3x3 of the rounded v plus its bias

in fp32, with one cast to x's dtype at the end. Weights are in torch's
layouts (``wq`` (ch, ch), ``wkv`` (2 ch, ch), ``lepe_w`` (ch, 1, 3, 3)).
``lam`` is a 0-d fp32 tensor on x's device, read by the kernel, so the call
makes no host sync.

``local_attention_fused_plain`` is the plain twin; the wrapper runs it on a
CPU tensor and launches K6 on a CUDA tensor, or raises. Inference only, as
in the JAX package: on a CUDA tensor with grad enabled and an input that
requires it, the wrapper raises. The switch ``MLAGG_FUSED_LOCAL_ATTN``
(``fused_local_attn_enabled``) decides, as in the JAX package, whether
``AggregatedAttention`` takes this path in ``eval()``.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.nn.functional as F

from mlagg_unet_torch.ops import _ext
from mlagg_unet_torch.ops.local_attention import (
    NEG_INF,
    _border_mask,
    _pad_hw,
    _tap,
    _window_offsets,
)

LOCAL = _ext.Kernel(
    "local_attn_fused",
    _ext.KernelLib("mlla_local_attn.cu", {
        "mlagg_local_attn": [_ext.VP] * 10 + [_ext.I32] * 6 + [_ext.I64, _ext.F32_ARG]
        + [_ext.I32, _ext.VP],
        "mlagg_local_attn_smem_bytes": [_ext.I32] * 4,
    }),
    "mlagg_local_attn",
)
HEAD_DIM = 24              # the flagship's head_dim at every stage: the kernel's
MIN_CTAS = 264             # rows per CTA shrink until the grid has this many


def fused_local_attn_enabled(flag: Optional[bool] = None) -> bool:
    """``flag``, or where it is None the JAX package's switch:
    ``MLAGG_FUSED_LOCAL_ATTN == "1"`` (off by default)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("MLAGG_FUSED_LOCAL_ATTN") == "1"


def local_attention_fused_plain(x, wq, bq, wkv, bkv, subln_scale, lepe_w,
                                lepe_b, lam, nh: int, lam_init: float = 0.8):
    """K6's plain twin, the arithmetic of ``_local_attn_kernel``."""
    B, H, W, ch = x.shape
    hd = ch // nh // 2
    xf = x.float()
    q = F.linear(xf, wq.float(), bq.float()) * hd ** -0.5
    k, v = F.linear(xf, wkv.float(), bkv.float()).to(x.dtype).float().chunk(2, dim=-1)
    qg = q.reshape(B, H, W, 2 * nh, hd)
    kp = _pad_hw(k.reshape(B, H, W, 2 * nh, hd), 1)
    vp = _pad_hw(v, 1)
    logits = []
    for dy, dx in _window_offsets(3):
        s = (qg * _tap(kp, H, W, 1, dy, dx)).sum(-1)
        logits.append(s.masked_fill(_border_mask(H, W, dy, dx, x.device)[None, :, :, None],
                                    NEG_INF))
    attn = torch.softmax(torch.stack(logits, dim=-1), dim=-1)
    attn = attn.reshape(B, H, W, nh, 2, 9)
    attn = attn[..., 0, :] - lam.float() * attn[..., 1, :]      # (B, H, W, nh, 9)
    out = torch.zeros(B, H, W, nh, 2 * hd, device=x.device)
    lepe = lepe_b.float().expand(B, H, W, ch)
    lw = lepe_w.float().reshape(ch, 9)
    for j, (dy, dx) in enumerate(_window_offsets(3)):
        vt = _tap(vp, H, W, 1, dy, dx)
        out = out + attn[..., j:j + 1] * vt.reshape(B, H, W, nh, 2 * hd)
        lepe = lepe + lw[:, j] * vt
    out = out * torch.rsqrt((out * out).mean(-1, keepdim=True) + 1e-5)
    out = out * subln_scale.float() * (1 - lam_init)
    return (out.reshape(B, H, W, ch) + lepe).to(x.dtype)


def local_aggregated_attention_fused(x, wq, bq, wkv, bkv, subln_scale, lepe_w,
                                     lepe_b, lam, nh: int,
                                     lam_init: float = 0.8) -> torch.Tensor:
    """x: (B, H, W, ch) -> (B, H, W, ch) in x's dtype (see the module doc)."""
    if _ext.use_plain(x):
        return local_attention_fused_plain(x, wq, bq, wkv, bkv, subln_scale,
                                           lepe_w, lepe_b, lam, nh, lam_init)
    params = (wq, bq, wkv, bkv, subln_scale, lepe_w, lepe_b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, lam, *params)):
        raise RuntimeError("local_aggregated_attention_fused: the kernel has no "
                           "backward; run the branch unfused (train mode) to "
                           "differentiate it")
    B, H, W, ch = x.shape
    hd = ch // nh // 2 if nh > 0 else 0
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"local_aggregated_attention_fused: dtype {x.dtype} not supported")
    if hd != HEAD_DIM or ch != 2 * nh * hd:
        raise ValueError(f"local_aggregated_attention_fused: ch={ch}, nh={nh}: "
                         f"the kernel takes head_dim {HEAD_DIM}")
    shapes = ((ch, ch), (ch,), (2 * ch, ch), (2 * ch,), (2 * hd,), (ch, 1, 3, 3), (ch,))
    for t, shape in zip(params, shapes):
        if t.shape != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"local_aggregated_attention_fused: a parameter is "
                             f"{tuple(t.shape)} {t.dtype} {t.device}, expected "
                             f"{shape} {x.dtype} {x.device}")
        if not t.is_contiguous():
            raise ValueError("local_aggregated_attention_fused: parameters must be contiguous")
    if lam.numel() != 1 or lam.dtype != torch.float32 or lam.device != x.device:
        raise ValueError("local_aggregated_attention_fused: lam must be one fp32 "
                         f"value on {x.device}")
    # x may be a channel slice of a wider map: tokens ld apart, channels unit stride
    ld = x.stride(2)
    if x.stride(3) != 1 or x.stride(1) != W * ld or x.stride(0) != H * W * ld or ld < ch:
        x = x.contiguous()
        ld = ch
    rows = _rows_per_cta(x, B, H, W, nh, hd)
    out = torch.empty(B, H, W, ch, device=x.device, dtype=x.dtype)
    LOCAL.launch(*map(_ext.ptr, (x, wq, bq, wkv, bkv, subln_scale, lepe_w, lepe_b,
                                 lam, out)),
                 B, H, W, nh, hd, rows, ld, float(lam_init),
                 _ext.BF16 if x.dtype == torch.bfloat16 else _ext.F32,
                 _ext.stream_ptr(x.device))
    return out


def _rows_per_cta(x, B, H, W, nh, hd) -> int:
    """Image rows per CTA: the most that fit the device's shared memory,
    cut so that the grid has at least MIN_CTAS CTAs where the map allows."""
    lib = LOCAL.lib.load()
    code = _ext.BF16 if x.dtype == torch.bfloat16 else _ext.F32
    have = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    tiles = -(-MIN_CTAS // (B * nh))
    cap = max(1, H // tiles)
    for rows in range(min(cap, H), 0, -1):
        if lib.mlagg_local_attn_smem_bytes(W, hd, rows, code) <= have:
            return rows
    raise ValueError(f"local_aggregated_attention_fused: a row of width {W} needs "
                     f"{lib.mlagg_local_attn_smem_bytes(W, hd, 1, code)} bytes of "
                     f"shared memory per block, the device allows {have}")
