"""Segmentation losses of the recipes, channels-last.

Counterparts of ``mlagg_unet_tpu/training/losses.py``: the memory-efficient
soft dice, the robust cross entropy (with an ignore index), the TopK cross
entropy (with label smoothing), DC+CE, DC+TopK, BCE and DC+BCE for region
datasets, the deep-supervision wrapper and weights, the nearest-neighbour
downsampling of the target for deep supervision, and the hard tp/fp/fn/tn
of the online pseudo dice; and ``convert_seg_to_regions``
(``mlagg_unet_tpu/training/trainer.py:98-115``). Logits are
(B, *spatial, C), integer targets (B, *spatial), one-hot targets
(B, *spatial, C); every sum is fp32.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def _one_hot(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(B, *spatial) int -> (B, *spatial, C) fp32 one-hot."""
    return F.one_hot(target.long(), num_classes).float()


def soft_dice_terms(probs: torch.Tensor, target_onehot: torch.Tensor,
                    loss_mask: Optional[torch.Tensor] = None):
    """Per-(batch, class) intersection, sum of predictions and sum of the
    target over the spatial axes: three (B, C) fp32 tensors."""
    probs, target_onehot = probs.float(), target_onehot.float()
    axes = tuple(range(1, probs.ndim - 1))
    if loss_mask is not None:
        m = loss_mask.float()[..., None]
        return ((probs * target_onehot * m).sum(axes), (probs * m).sum(axes),
                (target_onehot * m).sum(axes))
    return ((probs * target_onehot).sum(axes), probs.sum(axes),
            target_onehot.sum(axes))


def memory_efficient_soft_dice_loss(
        logits: torch.Tensor, target: torch.Tensor,
        apply_nonlin: Optional[Callable] = _softmax, batch_dice: bool = False,
        do_bg: bool = True, smooth: float = 1.0,
        loss_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MemoryEfficientSoftDiceLoss. target: int labels (B, *spatial) or a
    one-hot (B, *spatial, C); loss_mask: (B, *spatial), 1 = valid."""
    x = logits.float()
    if apply_nonlin is not None:
        x = apply_nonlin(x)
    y = target.float() if target.ndim == x.ndim else _one_hot(target, x.shape[-1])
    if not do_bg:
        x, y = x[..., 1:], y[..., 1:]
    intersect, sum_pred, sum_gt = soft_dice_terms(x, y, loss_mask)
    if batch_dice:
        intersect, sum_pred, sum_gt = intersect.sum(0), sum_pred.sum(0), sum_gt.sum(0)
    dc = (2.0 * intersect + smooth) / torch.clamp(sum_gt + sum_pred + smooth, min=1e-8)
    return -dc.mean()


def _select_class_logp(logp: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, -1, tgt.long()[..., None])[..., 0]


def robust_cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                              ignore_index: Optional[int] = None) -> torch.Tensor:
    """Mean softmax cross entropy; voxels at ignore_index contribute 0 and
    leave the mean."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    if ignore_index is None:
        return -_select_class_logp(logp, target).mean()
    valid = (target != ignore_index).float()
    tgt = torch.where(target == ignore_index, torch.zeros_like(target), target)
    nll = -_select_class_logp(logp, tgt)
    return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def topk_cross_entropy_loss(logits: torch.Tensor, target: torch.Tensor,
                            k_percent: float = 10.0, label_smoothing: float = 0.0,
                            ignore_index: Optional[int] = None) -> torch.Tensor:
    """The mean cross entropy of the hardest ``k = max(1, int(n k% / 100))``
    of the n voxels of the whole batch. ``label_smoothing`` mixes in the mean
    of -log p over the classes, as torch's CE does; voxels at
    ``ignore_index`` are zeroed before the selection. A label outside the
    classes (an ignore label the caller did not name) selects nothing and
    gives 0, as JAX's one-hot contraction does."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt = target if ignore_index is None else torch.where(
        target == ignore_index, torch.zeros_like(target), target)
    in_range = (tgt >= 0) & (tgt < logp.shape[-1])
    nll = -torch.where(in_range, _select_class_logp(logp, torch.where(
        in_range, tgt, torch.zeros_like(tgt))), torch.zeros((), device=logp.device))
    if label_smoothing > 0.0:
        nll = (1.0 - label_smoothing) * nll + label_smoothing * -logp.mean(-1)
    if ignore_index is not None:
        nll = torch.where(target == ignore_index, torch.zeros_like(nll), nll)
    flat = nll.reshape(-1)
    k = max(1, int(flat.shape[0] * k_percent / 100.0))
    return torch.topk(flat, k, sorted=False).values.mean()


def dc_and_ce_loss(logits: torch.Tensor, target: torch.Tensor,
                   weight_ce: float = 1.0, weight_dice: float = 1.0,
                   batch_dice: bool = False, smooth: float = 1e-5,
                   do_bg: bool = False,
                   ignore_label: Optional[int] = None) -> torch.Tensor:
    """DC_and_CE_loss; target: (B, *spatial) int."""
    mask = num_fg = None
    target_dice = target
    if ignore_label is not None:
        mask = (target != ignore_label).float()
        target_dice = torch.where(target == ignore_label,
                                  torch.zeros_like(target), target)
        num_fg = mask.sum()
    dc = (memory_efficient_soft_dice_loss(
        logits, target_dice, _softmax, batch_dice, do_bg, smooth, mask)
        if weight_dice != 0 else 0.0)
    ce = 0.0
    if weight_ce != 0:
        ce = robust_cross_entropy_loss(logits, target, ignore_label)
        if ignore_label is not None:  # no valid voxel: no CE at all
            ce = torch.where(num_fg > 0, ce, torch.zeros_like(ce))
    return weight_ce * ce + weight_dice * dc


def dc_and_topk_loss(logits: torch.Tensor, target: torch.Tensor,
                     weight_ce: float = 1.0, weight_dice: float = 1.0,
                     batch_dice: bool = False, smooth: float = 1e-5, do_bg: bool = False,
                     k_percent: float = 10.0,
                     ignore_label: Optional[int] = None) -> torch.Tensor:
    """DC_and_topk_loss: the dice with the ignored voxels masked out, plus
    TopK CE on the raw target (``losses.py:231-254``)."""
    mask = None
    target_dice = target
    if ignore_label is not None:
        mask = (target != ignore_label).float()
        target_dice = torch.where(target == ignore_label, torch.zeros_like(target), target)
    dc = (memory_efficient_soft_dice_loss(
        logits, target_dice, _softmax, batch_dice, do_bg, smooth, mask)
        if weight_dice != 0 else 0.0)
    ce = topk_cross_entropy_loss(logits, target, k_percent) if weight_ce != 0 else 0.0
    return weight_ce * ce + weight_dice * dc


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (no reduction)."""
    logits, target = logits.float(), target.float()
    return (torch.clamp(logits, min=0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))


def dc_and_bce_loss(logits: torch.Tensor, target: torch.Tensor,
                    weight_ce: float = 1.0, weight_dice: float = 1.0,
                    batch_dice: bool = False, smooth: float = 1e-5,
                    use_ignore_label: bool = False) -> torch.Tensor:
    """DC_and_BCE_loss for region-based training. target: (B, *spatial,
    C[+1]) one-hot regions; with use_ignore_label the last channel marks
    the ignored voxels."""
    mask = None
    target_regions = target
    if use_ignore_label:
        mask = 1.0 - target[..., -1].float()
        target_regions = target[..., :-1]
    dc = (memory_efficient_soft_dice_loss(
        logits, target_regions, torch.sigmoid, batch_dice, True, smooth, mask)
        if weight_dice != 0 else 0.0)
    ce_elem = bce_with_logits(logits, target_regions)
    if mask is not None:
        ce = (ce_elem * mask[..., None]).sum() / torch.clamp(
            mask.sum() * ce_elem.shape[-1], min=1e-8)
    else:
        ce = ce_elem.mean()
    return weight_ce * ce + weight_dice * dc


def convert_seg_to_regions(seg: torch.Tensor, regions,
                           ignore_label: Optional[int] = None) -> torch.Tensor:
    """(B, *spatial) int -> (B, *spatial, n_regions[+1]) fp32 one-hot region
    channels; with ignore_label, the ignored voxels' channel comes last."""
    chans = []
    for reg in regions:
        if isinstance(reg, (tuple, list)):
            m = torch.zeros(seg.shape, dtype=torch.bool, device=seg.device)
            for r in reg:
                m = m | (seg == r)
        else:
            m = seg == reg
        chans.append(m)
    if ignore_label is not None:
        chans.append(seg == ignore_label)
    return torch.stack(chans, dim=-1).float()


def deep_supervision_loss(loss_fn: Callable, outputs: Sequence[torch.Tensor],
                          targets: Sequence[torch.Tensor],
                          weights: Optional[Sequence[float]] = None) -> torch.Tensor:
    """Weighted sum of loss_fn over matched output / target pairs; scales
    of weight 0 are skipped."""
    if weights is None:
        weights = [1.0] * len(outputs)
    total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if w != 0:
            total = total + w * loss_fn(o, t)
    return total


def deep_supervision_weights(num_scales: int, drop_lowest: int = 0) -> List[float]:
    """1 / 2^i per scale, the lowest ``drop_lowest`` zeroed, normalised."""
    w = np.array([1.0 / (2.0 ** i) for i in range(num_scales)])
    if drop_lowest > 0:
        w[-drop_lowest:] = 0.0
    return list(w / w.sum())


def downsample_seg_for_ds(seg: torch.Tensor,
                          scales: Sequence[Sequence[float]]) -> List[torch.Tensor]:
    """Nearest-neighbour (strided) downsampling of an integer (B, *spatial)
    target to each deep-supervision scale."""
    out = []
    for scale in scales:
        if all(s == 1 for s in scale):
            out.append(seg)
            continue
        out.append(seg[(slice(None),) + tuple(
            slice(0, None, int(round(1.0 / s))) for s in scale)])
    return out


def get_tp_fp_fn_tn(probs: torch.Tensor, target: torch.Tensor,
                    mask: Optional[torch.Tensor] = None,
                    batch_reduce: bool = True):
    """Hard tp / fp / fn / tn per class for the online pseudo dice: (C,)
    each, or (B, C) without the batch reduction."""
    probs, target = probs.float(), target.float()
    axes = tuple(range(1, probs.ndim - 1))
    if mask is not None:
        m = mask.float()[..., None]
        probs, target = probs * m, target * m
    tp = (probs * target).sum(axes)
    fp = (probs * (1 - target)).sum(axes)
    fn = ((1 - probs) * target).sum(axes)
    tn = ((1 - probs) * (1 - target)).sum(axes)
    if batch_reduce:
        return tp.sum(0), fp.sum(0), fn.sum(0), tn.sum(0)
    return tp, fp, fn, tn
