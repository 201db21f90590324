"""Fused MLLA block front and tail: kernels K2 and K3 (``csrc/mlla_fused.cu``).

Replace the Pallas kernels ``_front_kernel`` (``mlla_block_front_fused``) and
``_tail_kernel`` (``mlla_block_tail_fused``) of
``mlagg_unet_tpu/ops/mlla_fused.py``. Token-pointwise:

    front: y = LN(x); a = silu(y Wa + ba); h = y Wi + bi
    tail:  x2 = s + (h * a) Wo + bo; out = x2 + gelu(LN(x2) W1 + b1) W2 + b2

LN is the flax LayerNorm (eps 1e-6, fast variance), GELU the exact erf form.
Weights are in torch's (out, in) layout. The plain twins are the unfused
math of ``mlagg_unet_tpu/models/mlla.py:339-341`` and ``:377-388``; the
wrappers run them on a CPU tensor and launch the kernels on a CUDA tensor,
or raise. The kernels have no backward (nor do the JAX ones: training runs
the block unfused), so on a CUDA tensor with grad enabled and an input that
requires it the wrappers raise rather than drop the gradient.
``MLLABlock`` takes them in ``eval()`` when ``fused_tail_enabled`` (the JAX
package's switch ``MLAGG_FUSED_TAIL``, on unless it is "0").

K2 and K3 are two kernels each, picked by ``front_launch_plan`` and
``tail_launch_plan`` from the type. fp32 I/O launches the scalar
``front_kernel`` and ``tail_kernel`` (fp32 arithmetic). bf16 I/O launches
the tensor-core kernels (bf16 operands, fp32 accumulators):
``front_mma_kernel`` (both products as one of width 2 C on Hopper's
``wgmma``, operands read from shared memory; persistent CTAs keep a chunk
of the weights and walk token tiles, or at C = 768 keep a token tile and
walk the weights) and ``tail_mma_kernel`` (``mma.sync``, weights streamed
through a ``cp.async`` ring, the MLP hidden in chunks).
``mlla_front_bf16_operands_plain`` and ``mlla_tail_bf16_operands_plain``
round to bf16 exactly where those kernels do.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from mlagg_unet_torch.models.layers import gelu, layer_norm
from mlagg_unet_torch.ops import _ext

_LIB = _ext.KernelLib("mlla_fused.cu", {
    "mlagg_mlla_front": [_ext.VP] * 9 + [_ext.I64, _ext.I32, _ext.F32_ARG,
                                         _ext.I32, _ext.I32, _ext.I32, _ext.I64,
                                         _ext.I64, _ext.VP],
    "mlagg_mlla_tail": [_ext.VP] * 12 + [_ext.I64, _ext.I32, _ext.I32, _ext.F32_ARG,
                                         _ext.I32, _ext.I32, _ext.I32, _ext.I64,
                                         _ext.I64, _ext.VP],
})
FRONT = _ext.Kernel("mlla_front", _LIB, "mlagg_mlla_front")
TAIL = _ext.Kernel("mlla_tail", _LIB, "mlagg_mlla_tail")


def fused_tail_enabled(flag: Optional[bool] = None) -> bool:
    """``flag``, or where it is None the JAX package's switch:
    ``MLAGG_FUSED_TAIL != "0"`` (on by default)."""
    if flag is not None:
        return bool(flag)
    return os.environ.get("MLAGG_FUSED_TAIL", "1") != "0"


def mlla_front_plain(x, ln_w, ln_b, wa, ba, wi, bi, eps: float = 1e-6):
    y = layer_norm(x, ln_w, ln_b, eps)
    return F.silu(F.linear(y, wa, ba)), F.linear(y, wi, bi)


def mlla_front_bf16_operands_plain(x, ln_w, ln_b, wa, ba, wi, bi, eps: float = 1e-6):
    """The front in fp32, rounded to bf16 exactly where ``front_mma_kernel``
    rounds: y = LN(x), the A operand of both products, and the weights, their
    B operands (no-ops for bf16 weights). The LN statistics, the biases and
    SiLU stay fp32. Returns fp32 (a, h): the kernel's final rounding to bf16
    is its own."""
    def r(t):
        return t.float().to(torch.bfloat16).float()

    y = r(layer_norm(x.float(), ln_w.float(), ln_b.float(), eps))
    return F.silu(F.linear(y, r(wa)) + ba.float()), F.linear(y, r(wi)) + bi.float()


def mlla_tail_plain(h, a, s, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
                    eps: float = 1e-6):
    x2 = s + F.linear(h * a, wo, bo)
    z = gelu(F.linear(layer_norm(x2, ln_w, ln_b, eps), w1, b1))
    return x2 + F.linear(z, w2, b2)


def mlla_tail_bf16_operands_plain(h, a, s, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
                                  eps: float = 1e-6):
    """The tail in fp32, rounded to bf16 exactly where ``tail_mma_kernel``
    rounds: the three A operands of its products (h * a, LN(x2), GELU(z))
    and the weights, its B operands (no-ops for bf16 weights). x2, the LN
    statistics, the biases and residuals stay fp32. Returns fp32: the
    kernel's final rounding to bf16 is its own."""
    def r(t):
        return t.float().to(torch.bfloat16).float()

    x2 = s.float() + F.linear(r(h.float() * a.float()), r(wo)) + bo.float()
    y = layer_norm(x2, ln_w.float(), ln_b.float(), eps)
    z = gelu(F.linear(r(y), r(w1)) + b1.float())
    return x2 + F.linear(r(z), r(w2)) + b2.float()


# mirrors pick_tm in the CUDA source: the scalar kernels' fp32 buffers of
# 8 tokens per warp step plus the staged weight slice must fit 112 KB
_SMEM_BUDGET = 112 * 1024
_WSLICE_FLOATS = 64 * 33
_MAX_GRID = 2 ** 31 - 1


def _scalar_tokens(name, per_token):
    """Tokens per CTA of the scalar kernels: the most (8 per warp step, up to
    128) whose ``per_token`` fp32 values fit the shared-memory budget."""
    tm = next((8 * t for t in (16, 8, 4, 2, 1)
               if (8 * t * per_token + _WSLICE_FLOATS) * 4 <= _SMEM_BUDGET), 0)
    if not tm:
        raise ValueError(f"{name}: {per_token} fp32 values per token "
                         "do not fit the kernel's shared memory")
    return tm


class FrontPlan(NamedTuple):
    kernel: str           # "front_mma_kernel" (bf16) or "front_kernel" (fp32)
    tokens_per_cta: int
    col_chunk: int        # columns of [a | h] a CTA computes: its resident weight rows
    smem_bytes: int       # dynamic shared memory of one CTA
    grid: int             # CTAs
    waves: int            # the most token tiles one CTA (or SM slot) works through


class TailPlan(NamedTuple):
    kernel: str           # "tail_mma_kernel" (bf16) or "tail_kernel" (fp32)
    tokens_per_cta: int
    hidden_chunk: int     # hidden units of one MLP chunk (fp32: all of Hd)
    smem_bytes: int       # dynamic shared memory of one CTA
    grid: int             # CTAs: one per tile of tokens_per_cta tokens
    waves: int            # rounds of the grid over the SMs at the design's CTAs per SM


def _check_operands(name, tensors, ref):
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; run the "
                           "block unfused (train mode) to differentiate it")
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {ref.dtype} not supported")
    for t in tensors:
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: all operands must be {ref.dtype} on "
                             f"{ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


# front_mma_kernel's instantiations: for C up to the first number, the width
# of a pass over output columns in units of 32 (16 per warpgroup), weight rows
# per chunk (0: all 2 C), the mode (0: a CTA keeps its weight chunk and walks
# token tiles; 1: a CTA keeps one token tile and walks weight chunks), CTAs
# per SM (mirrors MLAGG_FRONT_SHAPES in csrc/mlla_fused.cu)
_FRONT_SHAPES = ((96, 6, 0, 0, 2), (192, 6, 0, 0, 1), (384, 4, 128, 0, 1), (768, 1, 32, 1, 1))
_FRONT_TM = 64  # tokens per tile: the M of a wgmma


def front_launch_plan(M: int, C: int, dtype, num_sms: int, operands=()) -> FrontPlan:
    """K2's kernel and launch for M tokens of width C, I/O type ``dtype``;
    raises on what the kernels do not take, including, for the given
    ``operands`` (x, ln_w, ln_b, wa, ba, wi, bi), a grad request, mixed
    dtypes or devices, and non-contiguous or (bf16) not 16-byte aligned
    tensors. Works on tensors of any device (the CPU tests call it); the C
    launcher ``mlagg_mlla_front`` in ``csrc/mlla_fused.cu`` checks the same
    numbers.

    bf16 launches ``front_mma_kernel``, which takes C a multiple of 32 from
    32 to 768: every MLLA width of the repo (C = 96 * 2^i up to 768). Token
    tiles are 64 tokens; [Wa; Wi] comes in chunks of ``col_chunk`` rows. Up
    to C = 192 a CTA keeps all 2 C rows in shared memory (two CTAs per SM up
    to C = 96), up to 384 128 rows, and walks token tiles, the grid the
    chunks times as many CTAs per chunk as the SMs hold (at most one per
    tile). Above, a CTA keeps one token tile, LN'd once, and walks its share
    of the 32-row chunks through two slots: the grid is the tiles times as
    many groups of chunks as the SMs leave room for (at least one).
    ``waves`` is the most tiles one CTA, or one SM's CTA slot, works
    through. fp32 launches the scalar
    ``front_kernel``, one CTA per tile of the most tokens whose C fp32
    values fit 112 KB; its ``col_chunk`` is all 2 C.
    """
    name = "mlla_front"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    if operands:
        _check_operands(name, operands, operands[0])
        if operands[0].dtype != dtype:
            raise ValueError(f"{name}: operands are {operands[0].dtype}, plan is for {dtype}")
    if M < 0 or C < 1:
        raise ValueError(f"{name}: M={M}, C={C}")
    if dtype == torch.bfloat16:
        shape = next((r for r in _FRONT_SHAPES if C <= r[0]), None)
        if C % 32 or shape is None:
            raise ValueError(f"{name}: the bf16 kernel takes C a multiple of 32 up to 768, "
                             f"got C={C}")
        for i, t in enumerate(operands):
            if i in (0, 3, 5) and t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16 kernel's token rows and weights "
                                 "must start 16-byte aligned")
        _, nw, rows, xres, per_sm = shape
        tm, rows = _FRONT_TM, rows or 2 * C
        smem = (2 * ((1 + xres) * rows * C + (2 - xres) * tm * C + tm * (min(32 * nw, rows) + 8))
                + 8 * C)
        chunks, tiles, slots = -(-2 * C // rows), -(-M // tm), per_sm * num_sms
        if xres:  # tiles x groups of chunks, as many groups as the SMs leave room for
            span = -(-chunks // min(max(slots // max(tiles, 1), 1), chunks))
            grid = tiles * -(-chunks // span)
            return FrontPlan("front_mma_kernel", tm, rows, smem, grid, -(-grid // slots))
        per_chunk = min(max(slots // chunks, 1), tiles)
        return FrontPlan("front_mma_kernel", tm, rows, smem, per_chunk * chunks,
                         -(-tiles // per_chunk) if per_chunk else 0)
    tm = _scalar_tokens(name, C)
    grid = -(-M // tm)
    if grid > _MAX_GRID:
        raise ValueError(f"{name}: {grid} CTAs exceed the grid's {_MAX_GRID}")
    return FrontPlan("front_kernel", tm, 2 * C, (tm * C + _WSLICE_FLOATS) * 4, grid,
                     -(-grid // num_sms))


# tail_mma_kernel's instantiations: for C up to the first number, m16 tiles
# of tokens per warp, n8 tiles of a hidden chunk per warp, slots of the
# weight ring of 32-column weight slices (mirrors MLAGG_TAIL_SHAPES in
# csrc/mlla_fused.cu)
_MMA_SHAPES = ((96, 2, 4, 4), (192, 2, 4, 4), (384, 2, 4, 3), (768, 1, 8, 2))


def tail_launch_plan(M: int, C: int, Hd: int, dtype, num_sms: int,
                     operands=()) -> TailPlan:
    """K3's kernel and launch for M tokens of width C, hidden Hd, I/O type
    ``dtype``; raises on what the kernels do not take, including, for the
    given ``operands``, a grad request, mixed dtypes or devices, and
    non-contiguous or (bf16) not 16-byte aligned tensors. Works on tensors of
    any device (the CPU tests call it); the C launcher
    ``mlagg_mlla_tail`` in ``csrc/mlla_fused.cu`` checks the same numbers.

    bf16 launches ``tail_mma_kernel``, which takes C a multiple of 32 from 32
    to 768 and Hd a multiple of 32: every MLLA width of the repo (C = 96 * 2^i
    up to 768, Hd = 2 C). 64 tokens per CTA with 128-wide hidden chunks and
    a weight ring of 4 slots up to C = 192 (two CTAs per SM), 3 slots up to
    384; 32 tokens with 256-wide chunks and 2 slots at C = 768 (its
    accumulator tile of 32 x 768 fp32 is 96 registers a thread). fp32
    launches the scalar ``tail_kernel`` with the most tokens whose 2 C + Hd
    fp32 values fit 112 KB.
    """
    name = "mlla_tail"
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {dtype} not supported")
    if operands:
        _check_operands(name, operands, operands[2])
        if operands[2].dtype != dtype:
            raise ValueError(f"{name}: operands are {operands[2].dtype}, plan is for {dtype}")
    if M < 0 or C < 1 or Hd < 1:
        raise ValueError(f"{name}: M={M}, C={C}, Hd={Hd}")
    if dtype == torch.bfloat16:
        shape = next((r for r in _MMA_SHAPES if C <= r[0]), None)
        if C % 32 or shape is None or Hd % 32:
            raise ValueError(f"{name}: the bf16 kernel takes C a multiple of 32 up to 768 "
                             f"and Hd a multiple of 32, got C={C}, Hd={Hd}")
        for i, t in enumerate(operands):
            if i in (0, 1, 2, 3, 7, 9) and t.data_ptr() % 16:
                raise ValueError(f"{name}: the bf16 kernel's token rows and weights "
                                 "must start 16-byte aligned")
        widest, mt, nz, ring = shape
        tm, hc = 32 * mt, 32 * nz
        smem = 2 * (tm * (C + 8) + tm * (hc + 8) + ring * max(C, hc) * 40) + tm * 8 * 4
        # CTAs per SM the kernel's launch bounds are built for
        kernel, per_sm = "tail_mma_kernel", 2 if mt * (widest // 32 + nz) <= 20 else 1
    else:
        per_token = 2 * C + Hd
        tm = _scalar_tokens(name, per_token)
        hc, smem = Hd, (tm * per_token + _WSLICE_FLOATS) * 4
        kernel, per_sm = "tail_kernel", 1
    grid = -(-M // tm)
    if grid > _MAX_GRID:
        raise ValueError(f"{name}: {grid} CTAs exceed the grid's {_MAX_GRID}")
    return TailPlan(kernel, tm, hc, smem, grid, -(-grid // (per_sm * num_sms)))


def mlla_front(x, ln_w, ln_b, wa, ba, wi, bi, eps: float = 1e-6
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., C) -> (a, h), each (..., C) in x's dtype."""
    if _ext.use_plain(x):
        return mlla_front_plain(x, ln_w, ln_b, wa, ba, wi, bi, eps)
    C = x.shape[-1]
    x2d = x.reshape(-1, C)
    if wa.shape != (C, C) or wi.shape != (C, C):
        raise ValueError(f"mlla_front: weights {tuple(wa.shape)}, "
                         f"{tuple(wi.shape)} != {(C, C)}")
    ops = (x2d, ln_w, ln_b, wa, ba, wi, bi)
    plan = front_launch_plan(x2d.shape[0], C, x.dtype,
                             torch.cuda.get_device_properties(x.device).multi_processor_count,
                             ops)
    a = torch.empty_like(x2d)
    h = torch.empty_like(x2d)
    if plan.grid:
        FRONT.launch(*map(_ext.ptr, ops + (a, h)), x2d.shape[0], C, float(eps),
                     _dtype_code(x), plan.tokens_per_cta, plan.col_chunk,
                     plan.smem_bytes, plan.grid, _ext.stream_ptr(x.device))
    return a.view(x.shape), h.view(x.shape)


def mlla_tail(h, a, s, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
              eps: float = 1e-6) -> torch.Tensor:
    """h, a, s: (..., C) -> (..., C) in s's dtype. w1: (Hd, C), w2: (C, Hd)."""
    if _ext.use_plain(s):
        return mlla_tail_plain(h, a, s, wo, bo, ln_w, ln_b, w1, b1, w2, b2, eps)
    C = s.shape[-1]
    Hd = w1.shape[0]
    if h.shape != s.shape or a.shape != s.shape:
        raise ValueError("mlla_tail: h, a and s must have one shape")
    if wo.shape != (C, C) or w1.shape != (Hd, C) or w2.shape != (C, Hd):
        raise ValueError(f"mlla_tail: weights {tuple(wo.shape)}, "
                         f"{tuple(w1.shape)}, {tuple(w2.shape)} for C={C}")
    h2d, a2d, s2d = (t.reshape(-1, C) for t in (h, a, s))
    ops = (h2d, a2d, s2d, wo, bo, ln_w, ln_b, w1, b1, w2, b2)
    plan = tail_launch_plan(s2d.shape[0], C, Hd, s.dtype,
                            torch.cuda.get_device_properties(s.device).multi_processor_count,
                            ops)
    out = torch.empty_like(s2d)
    if plan.grid:
        TAIL.launch(*map(_ext.ptr, ops + (out,)), s2d.shape[0], C, Hd, float(eps),
                    _dtype_code(s), plan.tokens_per_cta, plan.hidden_chunk,
                    plan.smem_bytes, plan.grid, _ext.stream_ptr(s.device))
    return out.view(s.shape)


def _dtype_code(t):
    return _ext.BF16 if t.dtype == torch.bfloat16 else _ext.F32
