"""Local windowed (3x3) attention by shifted slices, NHWC.

Counterpart of ``mlagg_unet_tpu/ops/local_attention.py``: for each window
offset, the product of q with the shifted k summed over the head dim; taps
outside the image are masked to -1e30 before the softmax, like the
reference's unfold padding mask.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _window_offsets(window_size: int):
    r = window_size // 2
    return [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)]


def _pad_hw(x: torch.Tensor, r: int) -> torch.Tensor:
    """Zero-pad axes 1, 2 of (B, H, W, ...) by r."""
    pad = [0, 0] * (x.ndim - 3) + [r, r, r, r]
    return F.pad(x, pad)


def _tap(xp, H, W, r, dy, dx):
    return xp[:, r + dy:r + dy + H, r + dx:r + dx + W]


def _border_mask(H, W, dy, dx, device):
    ys = torch.arange(H, device=device)[:, None]
    xs = torch.arange(W, device=device)[None, :]
    return (ys + dy < 0) | (ys + dy >= H) | (xs + dx < 0) | (xs + dx >= W)


def local_window_attention_logits(q: torch.Tensor, k: torch.Tensor,
                                  window_size: int = 3) -> torch.Tensor:
    """q, k: (B, H, W, nh, dk), q pre-scaled -> fp32 logits
    (B, H, W, nh, ws^2) with -1e30 at border taps."""
    B, H, W, nh, dk = q.shape
    r = window_size // 2
    kp = _pad_hw(k, r)
    qf = q.float()
    logits = []
    for dy, dx in _window_offsets(window_size):
        s = (qf * _tap(kp, H, W, r, dy, dx).float()).sum(-1)
        m = _border_mask(H, W, dy, dx, q.device)[None, :, :, None]
        logits.append(s.masked_fill(m, NEG_INF))
    return torch.stack(logits, dim=-1)


def local_window_attention_apply(attn: torch.Tensor, v: torch.Tensor,
                                 window_size: int = 3) -> torch.Tensor:
    """attn: (B, H, W, nh, ws^2) weights; v: (B, H, W, nh, dv) -> output in
    v's dtype, fp32 accumulation."""
    H, W = v.shape[1], v.shape[2]
    r = window_size // 2
    vp = _pad_hw(v, r)
    out = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
    for j, (dy, dx) in enumerate(_window_offsets(window_size)):
        out = out + attn[..., j:j + 1].float() * _tap(vp, H, W, r, dy, dx).float()
    return out.to(v.dtype)
