"""Shape/spacing-aware resampling
(reference: preprocessing/resampling/default_resampling.py:22-212).

Copied from ``mlagg_unet_tpu/preprocessing/resampling.py`` without its
native OpenMP branch (``csrc/resample.cpp``): ``_resize`` always takes the
scipy path, which the JAX package calls identical math.

skimage is unavailable, so ``_resize`` reimplements skimage.transform.resize's
spline warp directly with scipy.ndimage.map_coordinates using the identical
coordinate mapping x_src = scale * (x_dst + 0.5) - 0.5 and mode='nearest'
(== skimage mode='edge'), anti_aliasing=False. ``resize_segmentation``
reimplements batchgenerators' one-hot-per-label resize.

The anisotropic "separate-z" path (in-plane spline per slice, order-0/linear
across z) is reproduced exactly — SURVEY.md ranks its parity as hard part #4
because it moves Dice when wrong.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
from scipy.ndimage import map_coordinates

from mlagg_unet_torch.configuration import ANISO_THRESHOLD


def _resize(data: np.ndarray, new_shape, order: int = 3) -> np.ndarray:
    """skimage.transform.resize(mode='edge', anti_aliasing=False) equivalent
    through scipy map_coordinates."""
    old_shape = data.shape
    new_shape = tuple(int(i) for i in new_shape)
    if tuple(old_shape) == new_shape:
        return data.astype(float, copy=True)

    coords = np.meshgrid(
        *[
            (np.arange(n) + 0.5) * (o / n) - 0.5
            for o, n in zip(old_shape, new_shape)
        ],
        indexing="ij",
    )
    return map_coordinates(
        data.astype(float), np.array(coords), order=order, mode="nearest"
    )


def resize_segmentation(segmentation: np.ndarray, new_shape, order: int = 3
                        ) -> np.ndarray:
    """batchgenerators.resize_segmentation: order-0 is a plain nearest
    resize; higher orders resize each label's indicator and re-argmax via
    0.5-thresholded painting."""
    tpe = segmentation.dtype
    if order == 0:
        return _resize(segmentation.astype(float), new_shape, order).astype(tpe)
    unique_labels = np.sort(np.unique(segmentation))
    reshaped = np.zeros(new_shape, dtype=tpe)
    for c in unique_labels:
        mask = segmentation == c
        reshaped_multihot = _resize(mask.astype(float), new_shape, order)
        reshaped[reshaped_multihot >= 0.5] = c
    return reshaped


def get_do_separate_z(spacing, anisotropy_threshold=ANISO_THRESHOLD) -> bool:
    return (np.max(spacing) / np.min(spacing)) > anisotropy_threshold


def get_lowres_axis(new_spacing) -> np.ndarray:
    return np.where(max(new_spacing) / np.array(new_spacing) == 1)[0]


def compute_new_shape(old_shape, old_spacing, new_spacing) -> np.ndarray:
    assert len(old_spacing) == len(old_shape) == len(new_spacing)
    return np.array(
        [int(round(i / j * k)) for i, j, k in zip(old_spacing, new_spacing, old_shape)]
    )


def _determine_separate_z_and_axis(current_spacing, new_spacing,
                                   force_separate_z, threshold):
    if force_separate_z is not None:
        do_separate_z = force_separate_z
        axis = get_lowres_axis(current_spacing) if force_separate_z else None
    else:
        if get_do_separate_z(current_spacing, threshold):
            do_separate_z = True
            axis = get_lowres_axis(current_spacing)
        elif get_do_separate_z(new_spacing, threshold):
            do_separate_z = True
            axis = get_lowres_axis(new_spacing)
        else:
            do_separate_z = False
            axis = None
    if axis is not None and len(axis) != 1:
        # 2 or 3 equal-spacing axes: do not separate (reference :56-66)
        do_separate_z = False
        axis = None
    return do_separate_z, axis


def resample_data_or_seg(data: np.ndarray, new_shape, is_seg: bool = False,
                         axis=None, order: int = 3,
                         do_separate_z: bool = False, order_z: int = 0
                         ) -> np.ndarray:
    """data: (c, x, y, z). The hot host-side loop (reference :122-212)."""
    assert data.ndim == 4, "data must be (c, x, y, z)"
    assert len(new_shape) == data.ndim - 1

    resize_fn = resize_segmentation if is_seg else _resize
    dtype_data = data.dtype
    shape = np.array(data[0].shape)
    new_shape = np.array([int(i) for i in new_shape])
    if np.all(shape == new_shape):
        return data

    data = data.astype(float)
    if do_separate_z:
        assert axis is not None and len(np.atleast_1d(axis)) == 1
        ax = int(np.atleast_1d(axis)[0])
        if ax == 0:
            new_shape_2d = new_shape[1:]
        elif ax == 1:
            new_shape_2d = new_shape[[0, 2]]
        else:
            new_shape_2d = new_shape[:-1]

        reshaped_final = []
        for c in range(data.shape[0]):
            slices = []
            for slice_id in range(shape[ax]):
                if ax == 0:
                    sl = data[c, slice_id]
                elif ax == 1:
                    sl = data[c, :, slice_id]
                else:
                    sl = data[c, :, :, slice_id]
                slices.append(resize_fn(sl, new_shape_2d, order))
            stacked = np.stack(slices, ax)
            if shape[ax] != new_shape[ax]:
                # z-resample via map_coordinates with the 0.5-offset grid
                rows, cols, dim = new_shape
                orig_rows, orig_cols, orig_dim = stacked.shape
                row_scale = float(orig_rows) / rows
                col_scale = float(orig_cols) / cols
                dim_scale = float(orig_dim) / dim
                map_rows, map_cols, map_dims = np.mgrid[:rows, :cols, :dim]
                map_rows = row_scale * (map_rows + 0.5) - 0.5
                map_cols = col_scale * (map_cols + 0.5) - 0.5
                map_dims = dim_scale * (map_dims + 0.5) - 0.5
                coord_map = np.array([map_rows, map_cols, map_dims])
                if not is_seg or order_z == 0:
                    reshaped_final.append(
                        map_coordinates(stacked, coord_map, order=order_z,
                                        mode="nearest")[None]
                    )
                else:
                    unique_labels = np.sort(np.unique(stacked.ravel()))
                    reshaped = np.zeros(new_shape, dtype=dtype_data)
                    for cl in unique_labels:
                        reshaped_multihot = np.round(
                            map_coordinates((stacked == cl).astype(float),
                                            coord_map, order=order_z,
                                            mode="nearest")
                        )
                        reshaped[reshaped_multihot > 0.5] = cl
                    reshaped_final.append(reshaped[None])
            else:
                reshaped_final.append(stacked[None])
        return np.vstack(reshaped_final).astype(dtype_data)

    reshaped = [resize_fn(data[c], new_shape, order)[None]
                for c in range(data.shape[0])]
    return np.vstack(reshaped).astype(dtype_data)


def resample_data_or_seg_to_shape(
    data: np.ndarray,
    new_shape,
    current_spacing,
    new_spacing,
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
    force_separate_z: Union[bool, None] = False,
    separate_z_anisotropy_threshold: float = ANISO_THRESHOLD,
) -> np.ndarray:
    do_separate_z, axis = _determine_separate_z_and_axis(
        current_spacing, new_spacing, force_separate_z,
        separate_z_anisotropy_threshold,
    )
    return resample_data_or_seg(data, new_shape, is_seg, axis, order,
                                do_separate_z, order_z=order_z)


def resample_data_or_seg_to_spacing(
    data: np.ndarray,
    current_spacing,
    new_spacing,
    is_seg: bool = False,
    order: int = 3,
    order_z: int = 0,
    force_separate_z: Union[bool, None] = False,
    separate_z_anisotropy_threshold: float = ANISO_THRESHOLD,
) -> np.ndarray:
    do_separate_z, axis = _determine_separate_z_and_axis(
        current_spacing, new_spacing, force_separate_z,
        separate_z_anisotropy_threshold,
    )
    shape = np.array(data[0].shape)
    new_shape = compute_new_shape(shape, current_spacing, new_spacing)
    return resample_data_or_seg(data, new_shape, is_seg, axis, order,
                                do_separate_z, order_z=order_z)
