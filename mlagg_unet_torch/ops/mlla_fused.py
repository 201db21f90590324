"""Fused MLLA block front and tail: kernels K2 and K3 (``csrc/mlla_fused.cu``).

Replace the Pallas kernels ``_front_kernel`` (``mlla_block_front_fused``) and
``_tail_kernel`` (``mlla_block_tail_fused``) of
``mlagg_unet_tpu/ops/mlla_fused.py``. Token-pointwise, fp32 arithmetic:

    front: y = LN(x); a = silu(y Wa + ba); h = y Wi + bi
    tail:  x2 = s + (h * a) Wo + bo; out = x2 + gelu(LN(x2) W1 + b1) W2 + b2

LN is the flax LayerNorm (eps 1e-6, fast variance), GELU the exact erf form.
Weights are in torch's (out, in) layout. The plain twins are the unfused
math of ``mlagg_unet_tpu/models/mlla.py:339-341`` and ``:377-388``; the
wrappers run them on a CPU tensor and launch the kernels on a CUDA tensor,
or raise.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from mlagg_unet_torch.models.layers import gelu, layer_norm
from mlagg_unet_torch.ops import _ext

_LIB = _ext.KernelLib("mlla_fused.cu", {
    "mlagg_mlla_front": [_ext.VP] * 9 + [_ext.I64, _ext.I32, _ext.F32_ARG,
                                         _ext.I32, _ext.VP],
    "mlagg_mlla_tail": [_ext.VP] * 12 + [_ext.I64, _ext.I32, _ext.I32,
                                         _ext.F32_ARG, _ext.I32, _ext.VP],
})
FRONT = _ext.Kernel("mlla_front", _LIB, "mlagg_mlla_front")
TAIL = _ext.Kernel("mlla_tail", _LIB, "mlagg_mlla_tail")


def mlla_front_plain(x, ln_w, ln_b, wa, ba, wi, bi, eps: float = 1e-6):
    y = layer_norm(x, ln_w, ln_b, eps)
    return F.silu(F.linear(y, wa, ba)), F.linear(y, wi, bi)


def mlla_tail_plain(h, a, s, wo, bo, ln_w, ln_b, w1, b1, w2, b2,
                    eps: float = 1e-6):
    x2 = s + F.linear(h * a, wo, bo)
    z = gelu(F.linear(layer_norm(x2, ln_w, ln_b, eps), w1, b1))
    return x2 + F.linear(z, w2, b2)


# mirrors pick_tm in the CUDA source: one token per warp (8 per CTA) of fp32
# buffers plus the staged weight slice must fit 112 KB of shared memory
_SMEM_FLOATS = 112 * 1024 // 4 - 64 * 33


def _check(name, tensors, floats_per_token, ref):
    if 8 * floats_per_token > _SMEM_FLOATS:
        raise ValueError(f"{name}: {floats_per_token} fp32 values per token "
                         "do not fit the kernel's shared memory")
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {ref.dtype} not supported")
    for t in tensors:
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(f"{name}: all operands must be {ref.dtype} on "
                             f"{ref.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


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
    _check("mlla_front", (x2d, ln_w, ln_b, wa, ba, wi, bi), C, x)
    a = torch.empty_like(x2d)
    h = torch.empty_like(x2d)
    FRONT.launch(*map(_ext.ptr, (x2d, ln_w, ln_b, wa, ba, wi, bi, a, h)),
                 x2d.shape[0], C, float(eps), _dtype_code(x),
                 _ext.stream_ptr(x.device))
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
    _check("mlla_tail", (h2d, a2d, s2d, wo, bo, ln_w, ln_b, w1, b1, w2, b2),
           2 * C + Hd, s)
    out = torch.empty_like(s2d)
    TAIL.launch(*map(_ext.ptr, (h2d, a2d, s2d, wo, bo, ln_w, ln_b, w1, b1, w2,
                                b2, out)),
                s2d.shape[0], C, Hd, float(eps), _dtype_code(s),
                _ext.stream_ptr(s.device))
    return out.view(s.shape)


def _dtype_code(t):
    return _ext.BF16 if t.dtype == torch.bfloat16 else _ext.F32
