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

K6 is two kernels, picked by ``local_launch_plan`` from the type. bf16 I/O
launches ``local_attn_mma_kernel``: the projections on tensor cores
(``mma.sync``, bf16 operands, fp32 accumulators), a CTA per head and
16 x 28 tile with the head's weights resident, k and v of the tile and its
neighbours in shared memory, q consumed in registers, 4 lanes per token for
the window. It rounds only k and v to bf16, where the JAX kernel rounds
them, so ``local_attention_fused_plain`` is its twin. fp32 I/O launches the
scalar ``local_attn_kernel`` (fp32 FMA projections, whole rows per CTA).
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

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
        "mlagg_local_attn": [_ext.VP] * 10 + [_ext.I32] * 7 + [_ext.I64, _ext.I64, _ext.F32_ARG]
        + [_ext.I32, _ext.VP],
    }),
    "mlagg_local_attn",
)
HEAD_DIM = 24              # the flagship's head_dim at every stage: the kernels'
SMEM_OPTIN = 232_448       # an H100's shared memory per block (opt-in)
SMEM_PER_SM = 233_472      # an H100's shared memory per SM (228 KB), 1 KB of it
                           # reserved per CTA
MIN_CTAS = 264             # fp32: rows per CTA shrink until the grid has this many
# bf16: rows x columns of a tile, the first whose shared memory fits (each
# cut to the map); 16 x 28 was the fastest tile at every flagship stage
MMA_TILES = ((16, 28), (16, 14), (8, 14), (4, 14), (2, 14), (1, 14), (1, 1))
MMA_WARPS = 16             # bf16: warps of a CTA, one CTA per SM


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


class LocalPlan(NamedTuple):
    kernel: str           # "local_attn_mma_kernel" (bf16) or "local_attn_kernel" (fp32)
    tile_rows: int
    tile_cols: int        # fp32: all of W
    halo_tokens: int      # k/v tokens of the largest tile: it and its neighbours in the map
    smem_bytes: int       # dynamic shared memory of one CTA
    grid: int             # CTAs: tiles x heads x images
    waves: int            # rounds of the grid over the SMs at the CTAs per SM that fit


def _mma_smem_bytes(ch: int, halo: int) -> int:
    """local_mma_smem_bytes in the CUDA source: the head's 144 weight rows of
    ch rounded up to 32 (bf16), the 16 warps' 16 x 56 bf16 output stages,
    672 fp32 parameters, k and v of ``halo`` tokens in rows of 48 bf16."""
    return (144 * (-(-ch // 32) * 32) * 2 + MMA_WARPS * 16 * 56 * 2 + 672 * 4
            + 2 * halo * 48 * 2)


def _scalar_smem_bytes(W: int, rows: int) -> int:
    """smem_bytes_t<float, 24> in the CUDA source: the weight and x slices,
    the parameters and q for ``rows`` rows (fp32), k and v for them and a halo
    row each side (fp32 rows of 49 words)."""
    return (8064 + 49 * rows * W) * 4 + 2 * (rows + 2) * W * 49 * 4


def _token_stride(x) -> Optional[int]:
    """The elements between x's tokens, where x is (B, H, W, ch) token rows
    with unit channel stride (a contiguous map or a channel slice of a wider
    one); None for any other layout."""
    B, H, W, ch = x.shape
    ld = x.stride(2)
    if x.stride(3) != 1 or x.stride(1) != W * ld or x.stride(0) != H * W * ld or ld < ch:
        return None
    return ld


def local_launch_plan(B: int, H: int, W: int, ch: int, nh: int, dtype, num_sms: int,
                      smem_optin: int = SMEM_OPTIN, operands=()) -> LocalPlan:
    """K6's kernel and launch for a (B, H, W, ch) map with nh heads, I/O type
    ``dtype``; raises on what the kernels do not take, including, for the
    given ``operands`` (x, wq, bq, wkv, bkv, subln_scale, lepe_w, lepe_b,
    lam), a grad request, mixed dtypes or devices, parameters of other
    shapes or not contiguous, and (bf16) x, its token stride, the weights not
    16-byte aligned. Works on tensors of any device (the CPU tests call it);
    the C launcher ``mlagg_local_attn`` in ``csrc/mlla_local_attn.cu`` checks
    the same numbers.

    bf16 launches ``local_attn_mma_kernel``: a CTA owns one head of one
    image's tile of up to 16 x 28 tokens (the whole map where it is smaller;
    smaller tiles where the head's weights leave too little shared memory)
    and projects k and v for the tile and its neighbours in the map, so the
    grid is the tiles x nh x B, one CTA of 16 warps per SM. fp32 launches
    the scalar ``local_attn_kernel``: a CTA owns ``tile_rows`` whole rows
    (the most whose shared memory fits, cut so that the grid has MIN_CTAS
    CTAs where the map allows) of one head of one image.
    """
    name = "local_aggregated_attention_fused"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    hd = ch // nh // 2 if nh > 0 else 0
    if hd != HEAD_DIM or ch != 2 * nh * hd:
        raise ValueError(f"{name}: ch={ch}, nh={nh}: the kernels take head_dim {HEAD_DIM}")
    if min(B, H, W) < 1 or B > 65535:
        raise ValueError(f"{name}: B={B}, H={H}, W={W}")
    if operands:
        _check_operands(name, operands, ch, hd, dtype)
    if dtype == torch.bfloat16:
        if operands:
            x, ld = operands[0], _token_stride(operands[0])
            if ld is None or ld % 8 or any(t.data_ptr() % 16 for t in (x, operands[1], operands[3])):
                raise ValueError(f"{name}: the bf16 kernel reads x's token rows and the "
                                 "weights with 16-byte loads: they must start 16-byte "
                                 "aligned, tokens a multiple of 8 elements apart")
        for tr, tc in MMA_TILES:
            tr, tc = min(H, tr), min(W, tc)
            halo = min(tr + 2, H) * min(tc + 2, W)
            smem = _mma_smem_bytes(ch, halo)
            if smem <= smem_optin:
                break
        else:
            raise ValueError(f"{name}: ch={ch} needs {smem} bytes of shared memory per "
                             f"block, the device allows {smem_optin}")
        grid = -(-H // tr) * -(-W // tc) * nh * B
        return LocalPlan("local_attn_mma_kernel", tr, tc, halo, smem, grid, -(-grid // num_sms))
    tiles = -(-MIN_CTAS // (B * nh))
    rows = next((r for r in range(min(max(1, H // tiles), H), 0, -1)
                 if _scalar_smem_bytes(W, r) <= smem_optin), 0)
    if not rows:
        raise ValueError(f"{name}: a row of width {W} needs {_scalar_smem_bytes(W, 1)} "
                         f"bytes of shared memory per block, the device allows {smem_optin}")
    smem = _scalar_smem_bytes(W, rows)
    grid = -(-H // rows) * nh * B
    return LocalPlan("local_attn_kernel", rows, W, (rows + 2) * W, smem, grid,
                     -(-grid // (max(1, SMEM_PER_SM // (smem + 1024)) * num_sms)))


def _check_operands(name, operands, ch, hd, dtype):
    x, *params, lam = operands
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        raise RuntimeError(f"{name}: the kernel has no backward; run the branch "
                           "unfused (train mode) to differentiate it")
    if x.dtype != dtype:
        raise ValueError(f"{name}: x is {x.dtype}, the plan is for {dtype}")
    shapes = ((ch, ch), (ch,), (2 * ch, ch), (2 * ch,), (2 * hd,), (ch, 1, 3, 3), (ch,))
    for t, shape in zip(params, shapes):
        if tuple(t.shape) != shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: a parameter is {tuple(t.shape)} {t.dtype} "
                             f"{t.device}, expected {shape} {x.dtype} {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: parameters must be contiguous")
    if lam.numel() != 1 or lam.dtype != torch.float32 or lam.device != x.device:
        raise ValueError(f"{name}: lam must be one fp32 value on {x.device}")


def local_aggregated_attention_fused(x, wq, bq, wkv, bkv, subln_scale, lepe_w,
                                     lepe_b, lam, nh: int,
                                     lam_init: float = 0.8) -> torch.Tensor:
    """x: (B, H, W, ch) -> (B, H, W, ch) in x's dtype (see the module doc)."""
    if _ext.use_plain(x):
        return local_attention_fused_plain(x, wq, bq, wkv, bkv, subln_scale,
                                           lepe_w, lepe_b, lam, nh, lam_init)
    B, H, W, ch = x.shape
    # x may be a channel slice of a wider map: tokens ld apart, channels unit stride
    if _token_stride(x) is None:
        x = x.contiguous()
    ops = (x, wq, bq, wkv, bkv, subln_scale, lepe_w, lepe_b, lam)
    props = torch.cuda.get_device_properties(x.device)
    plan = local_launch_plan(B, H, W, ch, nh, x.dtype, props.multi_processor_count,
                             props.shared_memory_per_block_optin, ops)
    out = torch.empty(B, H, W, ch, device=x.device, dtype=x.dtype)
    LOCAL.launch(*map(_ext.ptr, ops + (out,)), B, H, W, nh, HEAD_DIM, plan.tile_rows,
                 plan.tile_cols, plan.smem_bytes, _token_stride(x), float(lam_init),
                 _ext.BF16 if x.dtype == torch.bfloat16 else _ext.F32,
                 _ext.stream_ptr(x.device))
    return out
