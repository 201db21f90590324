"""Crop-to-nonzero (reference: preprocessing/cropping/cropping.py:8-52).

Outside-of-mask voxels are written as -1 into the cropped seg (the
"nonzero region" convention downstream normalization and losses rely on).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy.ndimage import binary_fill_holes


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    """data: (c, x, y(, z)). Union of per-channel nonzero, holes filled."""
    assert data.ndim in (3, 4)
    nonzero_mask = np.zeros(data.shape[1:], dtype=bool)
    for c in range(data.shape[0]):
        nonzero_mask |= data[c] != 0
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray) -> List[List[int]]:
    """[[lo, hi), ...] per axis."""
    bbox = []
    for ax in range(mask.ndim):
        other = tuple(i for i in range(mask.ndim) if i != ax)
        any_ax = np.any(mask, axis=other)
        nz = np.where(any_ax)[0]
        if len(nz) == 0:
            bbox.append([0, mask.shape[ax]])
        else:
            bbox.append([int(nz[0]), int(nz[-1]) + 1])
    return bbox


def bounding_box_to_slice(bbox: List[List[int]]) -> Tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in bbox)


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray = None
                    ) -> Tuple[np.ndarray, np.ndarray, List[List[int]]]:
    """data: (c, x, y(, z)); seg: (1, x, y(, z)) or None.
    Returns (cropped data, cropped seg with -1 outside mask, bbox)."""
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask)
    slicer = bounding_box_to_slice(bbox)

    data = data[(slice(None), *slicer)]
    nonzero_mask = nonzero_mask[slicer][None]
    if seg is not None:
        seg = seg[(slice(None), *slicer)]
        seg[(seg == 0) & ~nonzero_mask] = -1
    else:
        seg = np.where(nonzero_mask, np.int8(0), np.int8(-1))
    return data, seg, bbox
