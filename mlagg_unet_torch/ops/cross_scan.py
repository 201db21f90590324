"""Cross-scan / cross-merge layouts of the 4-direction scans.

Counterparts of ``cross_scan_multiscale_2dir`` and
``cross_merge_multiscale_tokens_2dir`` in ``mlagg_unet_tpu/ops/cross_scan.py``
for the multi-scale skip, and of the one-scale ``cross_scan_2d`` /
``cross_merge_2d`` and the 1- and 2-direction pairs for the SS2D cell. The
TPU's interleaved lane-order variants have no counterpart.

For the multi-scale scan only the two un-reversed layouts (row-major,
column-major) are built; directions 2 and 3 are the same sequences scanned
right to left
(``reverse=True`` in the scan) over the scales concatenated in reversed
order, which visits scale 0 first with each scale's tokens reversed: the
reference's per-scale flips without flip copies. No zero tail is appended:
the CUDA scan takes any L.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def _dirs01(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 2, C, H*W): row-major and column-major orders."""
    B, H, W, C = x.shape
    d0 = x.permute(0, 3, 1, 2).reshape(B, C, H * W)
    d1 = x.permute(0, 3, 2, 1).reshape(B, C, H * W)
    return torch.stack([d0, d1], dim=1)


def cross_scan_multiscale_2dir(xs: Sequence[torch.Tensor],
                               reverse_scales: bool = False
                               ) -> Tuple[torch.Tensor, List[int]]:
    """xs: NHWC maps [(B, H_i, W_i, C)] -> ((B, 2, C, sum L_i), [L_i]),
    scales concatenated in forward or reversed order."""
    l_split = [x.shape[1] * x.shape[2] for x in xs]
    order = range(len(xs) - 1, -1, -1) if reverse_scales else range(len(xs))
    return torch.cat([_dirs01(xs[i]) for i in order], dim=-1), l_split


def cross_merge_multiscale_tokens_2dir(
        y_fwd: torch.Tensor, y_rev: torch.Tensor,
        shapes: Sequence[Tuple[int, int]], l_split: Sequence[int],
) -> List[torch.Tensor]:
    """y_fwd: directions 0/1 in forward scale order; y_rev: directions 2/3
    in reversed scale order, outputs at natural positions. Returns per-scale
    tokens [(B, L_i, C)], the sum of the four directions."""
    B, _, C, _ = y_fwd.shape
    n_sc = len(l_split)
    off_f = [0]
    for l in l_split:
        off_f.append(off_f[-1] + l)
    off_r = [0]
    for l in reversed(l_split):
        off_r.append(off_r[-1] + l)
    out = []
    for i, (H, W) in enumerate(shapes):
        sf = slice(off_f[i], off_f[i + 1])
        r0 = off_r[n_sc - 1 - i]
        sr = slice(r0, r0 + l_split[i])
        row = y_fwd[:, 0, :, sf] + y_rev[:, 0, :, sr]          # (B, C, L_i)
        col = y_fwd[:, 1, :, sf] + y_rev[:, 1, :, sr]
        col = col.reshape(B, C, W, H).transpose(2, 3).reshape(B, C, H * W)
        out.append((row + col).transpose(1, 2))                # (B, L_i, C)
    return out


# ---------------------------------------------------------------- one scale
# Counterparts of cross_scan_2d / cross_merge_2d (``cross_scan.py:143``,
# ``:160``) and the direction-count ablations (``:309-330``), which keep
# K = 4 paths so that the parameters' shapes do not change.

def cross_scan_2d(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, 4, C, H*W): row-major, column-major and both
    reversed."""
    d01 = _dirs01(x)
    return torch.cat([d01, d01.flip(-1)], dim=1)


def cross_merge_2d(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, C, L) per-direction outputs -> (B, C, L): each direction's
    layout inverted, then summed."""
    B, _, C, L = ys.shape
    row = ys[:, 0] + ys[:, 2].flip(-1)
    col = ys[:, 1] + ys[:, 3].flip(-1)
    return row + col.reshape(B, C, W, H).transpose(2, 3).reshape(B, C, L)


def cross_scan_1direction(x: torch.Tensor) -> torch.Tensor:
    """All four paths see the row-major sequence."""
    B, H, W, C = x.shape
    hw = x.permute(0, 3, 1, 2).reshape(B, C, H * W)
    return hw[:, None].expand(B, 4, C, H * W)


def cross_merge_1direction(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return ys.sum(dim=1)


def cross_scan_2direction(x: torch.Tensor) -> torch.Tensor:
    """Paths 0 and 1 row-major, paths 2 and 3 reversed row-major."""
    B, H, W, C = x.shape
    fwd = x.permute(0, 3, 1, 2).reshape(B, C, H * W)[:, None].expand(B, 2, C, H * W)
    return torch.cat([fwd, fwd.flip(-1)], dim=1)


def cross_merge_2direction(ys: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return ys[:, 0] + ys[:, 1] + ys[:, 2].flip(-1) + ys[:, 3].flip(-1)
