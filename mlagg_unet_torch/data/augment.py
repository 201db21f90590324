"""Training-time data augmentation — NumPy ports of the batchgenerators
transforms the reference composes (nnUNetTrainer.get_training_transforms,
nnUNetTrainer.py:643-733), with matching parameters and probabilities:

SpatialTransform (rot/scale, order-3 data / order-1 seg, constant border,
seg cval -1), GaussianNoise p.1, GaussianBlur p.2 sigma (.5,1), brightness
multiplicative (.75,1.25) p.15, contrast (.75,1.25, preserve range) p.15,
SimulateLowRes (zoom .5-1, down order0/up order3) p.25, Gamma (.7,1.5)
inverted p.1 / plain p.3 (retain stats), mirror, MaskTransform,
RemoveLabel(-1 -> 0).

The dataloader samples an inflated patch (compute_initial_patch_size.py:4)
so rotation/scaling never sees padding; the spatial transform center-crops
to the final patch size.

These run on host worker threads. Copied from ``mlagg_unet_tpu/data/augment.py``
with the imports rewritten; the on-device augmentation of ``MLAGG_DEVICE_AUG``
is ``data/device_augment.py``.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter, map_coordinates, zoom


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range
                   ) -> np.ndarray:
    """Inflate the sampled patch so post-rotation/scale crops have no padding
    artefacts (reference compute_initial_patch_size.py:4-24)."""
    if isinstance(rot_x, (tuple, list)):
        rot_x = max(np.abs(rot_x))
    if isinstance(rot_y, (tuple, list)):
        rot_y = max(np.abs(rot_y))
    if isinstance(rot_z, (tuple, list)):
        rot_z = max(np.abs(rot_z))
    rot_x = min(np.pi / 2, rot_x)
    rot_y = min(np.pi / 2, rot_y)
    rot_z = min(np.pi / 2, rot_z)

    coords = np.array(final_patch_size)
    final_shape = np.copy(coords)
    if len(coords) == 3:
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, rot_x, 0, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, 0, rot_y, 0)), final_shape)), 0)
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_3d(coords, 0, 0, rot_z)), final_shape)), 0)
    elif len(coords) == 2:
        final_shape = np.max(np.vstack(
            (np.abs(_rotate_coords_2d(coords, rot_x)), final_shape)), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)


def _rot_matrix_2d(angle: float) -> np.ndarray:
    return np.array([[np.cos(angle), -np.sin(angle)],
                     [np.sin(angle), np.cos(angle)]])


def _rot_matrix_3d(ax: float, ay: float, az: float) -> np.ndarray:
    rx = np.array([[1, 0, 0],
                   [0, np.cos(ax), -np.sin(ax)],
                   [0, np.sin(ax), np.cos(ax)]])
    ry = np.array([[np.cos(ay), 0, np.sin(ay)],
                   [0, 1, 0],
                   [-np.sin(ay), 0, np.cos(ay)]])
    rz = np.array([[np.cos(az), -np.sin(az), 0],
                   [np.sin(az), np.cos(az), 0],
                   [0, 0, 1]])
    # batchgenerators builds dot(dot(dot(I, rx), ry), rz) ...
    return rx @ ry @ rz


def _rotate_coords_2d(coords, angle):
    # ... and applies it as coords_new^T = coords^T @ M, i.e. M^T @ coords
    # (rotate_coords_2d/3d in batchgenerators.augmentations.utils)
    return _rot_matrix_2d(angle).T @ np.asarray(coords, dtype=float)


def _rotate_coords_3d(coords, ax, ay, az):
    return _rot_matrix_3d(ax, ay, az).T @ np.asarray(coords, dtype=float)


def spatial_augment(
    data: np.ndarray,
    seg: Optional[np.ndarray],
    final_patch_size: Sequence[int],
    rotation_for_da: dict,
    scale_range: Tuple[float, float] = (0.7, 1.4),
    p_rot: float = 0.2,
    p_scale: float = 0.2,
    order_data: int = 3,
    order_seg: int = 1,
    border_val_seg: float = -1,
    rng: np.random.RandomState = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """data/seg: (c, *inflated_patch). Returns (c, *final_patch_size).
    Rotation+scale applied around the patch center in one resampling pass
    (batchgenerators augment_spatial semantics, random_crop=False)."""
    rng = rng or np.random.RandomState()
    dim = len(final_patch_size)
    final_patch_size = np.asarray(final_patch_size)

    do_rot = rng.uniform() < p_rot
    do_scale = rng.uniform() < p_scale

    if not do_rot and not do_scale:
        # plain center crop
        return (_center_crop(data, final_patch_size),
                None if seg is None else _center_crop(seg, final_patch_size))

    # zero-centered mesh of the OUTPUT patch
    grids = np.meshgrid(
        *[np.arange(s, dtype=float) - (s - 1) / 2 for s in final_patch_size],
        indexing="ij",
    )
    coords = np.stack([g.ravel() for g in grids])  # (dim, prod(patch))

    if do_rot:
        if dim == 2:
            a = rng.uniform(*rotation_for_da["x"])
            coords = _rotate_coords_2d(coords, a)
        else:
            ax = rng.uniform(*rotation_for_da["x"])
            ay = rng.uniform(*rotation_for_da["y"])
            az = rng.uniform(*rotation_for_da["z"])
            coords = _rotate_coords_3d(coords, ax, ay, az)
    if do_scale:
        # batchgenerators: zoom-out-biased sampling
        if rng.uniform() < 0.5 and scale_range[0] < 1:
            sc = rng.uniform(scale_range[0], 1.0)
        else:
            sc = rng.uniform(max(scale_range[0], 1.0), scale_range[1])
        coords = coords * sc

    # shift to input center
    ctr = np.array([(s - 1) / 2 for s in data.shape[1:]])
    coords = coords + ctr[:, None]

    # crop the input to the sampled bbox before interpolating: the
    # order-3 spline prefilter is an IIR whose influence decays by
    # |z1|~0.268 per voxel, so a 20-voxel margin reproduces the
    # uncropped result to ~1e-12 while skipping the prefilter work for
    # the inflated-patch worst case this draw didn't use
    margin = 20
    lo = np.floor(coords.min(axis=1)).astype(np.int64) - margin
    hi = np.ceil(coords.max(axis=1)).astype(np.int64) + margin + 1
    lo = np.maximum(lo, 0)
    hi = np.minimum(hi, data.shape[1:])
    crop = tuple(slice(int(l), int(h)) for l, h in zip(lo, hi))
    coords = coords - lo[:, None].astype(float)
    coords = coords.reshape(dim, *final_patch_size)

    out_data = np.stack([
        map_coordinates(np.ascontiguousarray(data[(c, *crop)], dtype=float),
                        coords, order=order_data,
                        mode="constant", cval=0.0)
        for c in range(data.shape[0])
    ]).astype(np.float32)
    out_seg = None
    if seg is not None:
        # same crop is exact for seg too: the >= margin border guarantees
        # every interpolation cell lies inside the crop except where the
        # crop was clamped to the true volume edge — where the original
        # cval behavior applies unchanged
        out_seg = np.stack([
            _interpolate_seg(np.ascontiguousarray(seg[(c, *crop)]), coords,
                             order_seg, border_val_seg)
            for c in range(seg.shape[0])
        ]).astype(seg.dtype if seg.dtype != np.float16 else np.float32)
    return out_data, out_seg


def _interpolate_seg(seg: np.ndarray, coords: np.ndarray, order: int,
                     cval: float) -> np.ndarray:
    """batchgenerators interpolate_img(..., is_seg=True): with order > 0 each
    label is interpolated as a one-hot channel and thresholded at 0.5 (labels
    iterated in sorted order, later ones overwrite). Interpolating label
    VALUES would invent phantom intermediate labels at boundaries (e.g. a
    0|2 edge yielding 1s) — the one-hot form never does.

    order == 1 (the reference's order_seg default) takes an exact fast path:
    voxels whose 2^dim interpolation corners all share one label resolve to
    that label for any weights (the one-hot score is the weight sum == 1);
    only label-boundary voxels run the per-label scoring, computed directly
    from the corner weights."""
    if order == 0:
        return map_coordinates(seg.astype(float), coords, order=0,
                               mode="constant", cval=cval).astype(seg.dtype)
    if order == 1:
        return _interpolate_seg_linear(seg, coords, cval)
    result = np.zeros(coords.shape[1:], dtype=seg.dtype)
    for c in np.unique(seg):
        res = map_coordinates((seg == c).astype(float), coords, order=order,
                              mode="constant", cval=cval)
        result[res >= 0.5] = c
    return result


def _interpolate_seg_linear(seg: np.ndarray, coords: np.ndarray,
                            cval: float) -> np.ndarray:
    """Exact equivalent of per-label map_coordinates(order=1,
    mode='constant', cval=cval) + (>= 0.5)-threshold overwrite: out-of-range
    corners contribute cval to every label's one-hot score (scipy's
    padded-array model), matching batchgenerators bit-for-bit.

    Interior points (all 2^dim corners in bounds — virtually everything)
    take a flat-gather fast path: corner addresses differ from the base
    corner by constant raveled offsets, so label lookup is 2^dim flat
    gathers with no per-corner bounds/clip work; uniform-corner voxels
    (the bulk of a real segmentation) resolve immediately, and only
    label-boundary voxels run the per-label scoring. Border points fall
    back to the generic clipped path. Scoring arithmetic (float32 weights,
    ascending-label overwrite at >= 0.5) is identical in both paths."""
    dim = coords.shape[0]
    pts = coords.reshape(dim, -1)
    npts = pts.shape[1]
    f64 = np.floor(pts)
    # int32 index math: volumes are < 2^31 voxels, and 32-bit gathers and
    # stride arithmetic halve the index-traffic of this hot path
    f = f64.astype(np.int32)
    frac = (pts - f64).astype(np.float32)
    shape = np.array(seg.shape, np.int32)
    n_corners = 1 << dim
    offsets = [np.array([(k >> a) & 1 for a in range(dim)], np.int32)
               for k in range(n_corners)]

    interior = (f[0] >= 0) & (f[0] <= shape[0] - 2)
    for a in range(1, dim):
        interior &= (f[a] >= 0) & (f[a] <= shape[a] - 2)

    result = np.zeros(npts, dtype=seg.dtype)

    if interior.any():
        segr = seg.reshape(-1)
        strides = np.array(
            [int(np.prod(shape[a + 1:], dtype=np.int64))
             for a in range(dim)], np.int32)
        fi = f[:, interior]
        frac_i = frac[:, interior]
        base = fi[0] * strides[0]
        for a in range(1, dim):
            base = base + fi[a] * strides[a]
        labs = [segr[base + int(np.dot(off, strides))] for off in offsets]
        uniform = labs[1] == labs[0]
        for k in range(2, n_corners):
            uniform &= labs[k] == labs[0]
        res_i = np.zeros(base.shape[0], dtype=seg.dtype)
        res_i[uniform] = labs[0][uniform]
        mixed = ~uniform
        if mixed.any():
            fracm = frac_i[:, mixed]
            labs_m = [l[mixed] for l in labs]
            ws_m = []
            for k in range(n_corners):
                w = np.ones(fracm.shape[1], np.float32)
                for a in range(dim):
                    w *= fracm[a] if offsets[k][a] else (1.0 - fracm[a])
                ws_m.append(w)
            res_m = np.zeros(fracm.shape[1], dtype=seg.dtype)
            # only labels present among the corners can score >= 0.5
            for c in np.unique(np.stack(labs_m)):
                score = np.zeros(fracm.shape[1], np.float32)
                for k in range(n_corners):
                    score += ws_m[k] * (labs_m[k] == c).astype(np.float32)
                res_m[score >= 0.5] = c
            res_i[mixed] = res_m
        result[interior] = res_i

    border = ~interior
    if border.any():
        result[border] = _interpolate_seg_linear_border(
            seg, f[:, border], frac[:, border], cval, offsets, n_corners)
    return result.reshape(coords.shape[1:])


def _interpolate_seg_linear_border(seg, fm, fracm, cval, offsets,
                                   n_corners):
    """Generic clipped/validity path for points whose interpolation cell
    touches the volume border (scipy's constant-mode model: invalid
    corners contribute cval to every label's score)."""
    dim = fm.shape[0]
    shape = np.array(seg.shape).reshape(dim, 1)
    labs_m, ws_m, valids_m = [], [], []
    for k in range(n_corners):
        idx = fm + offsets[k][:, None]
        valid = np.all((idx >= 0) & (idx < shape), axis=0)
        ci = np.clip(idx, 0, shape - 1)
        labs_m.append(seg[tuple(ci)])
        w = np.ones(fm.shape[1], np.float32)
        for a in range(dim):
            w *= fracm[a] if offsets[k][a] else (1.0 - fracm[a])
        ws_m.append(w)
        valids_m.append(valid)
    res_m = np.zeros(fm.shape[1], dtype=seg.dtype)
    for c in np.unique(seg):
        score = np.zeros(fm.shape[1], np.float32)
        for k in range(n_corners):
            v = np.where(valids_m[k],
                         (labs_m[k] == c).astype(np.float32),
                         np.float32(cval))
            score += ws_m[k] * v
        res_m[score >= 0.5] = c
    return res_m


def _center_crop(x: np.ndarray, patch_size) -> np.ndarray:
    slicer = [slice(None)]
    for s, p in zip(x.shape[1:], patch_size):
        lo = (s - p) // 2
        slicer.append(slice(lo, lo + p))
    return np.ascontiguousarray(x[tuple(slicer)])


def gaussian_noise(data, rng, p=0.1, noise_variance=(0, 0.1)):
    """batchgenerators augment_gaussian_noise passes the sampled
    "variance" directly as the scale (std) of np.random.normal — match
    that, not sqrt(variance)."""
    if rng.uniform() < p:
        variance = rng.uniform(*noise_variance)
        data = data + rng.normal(0.0, variance,
                                 size=data.shape).astype(np.float32)
    return data


def gaussian_blur(data, rng, p=0.2, sigma_range=(0.5, 1.0), p_per_channel=0.5):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                sigma = rng.uniform(*sigma_range)
                data[c] = gaussian_filter(data[c], sigma)
    return data


def brightness_multiplicative(data, rng, p=0.15, mult_range=(0.75, 1.25),
                              per_channel=True):
    """BrightnessMultiplicativeTransform default per_channel=True: an
    independent multiplier per channel."""
    if rng.uniform() < p:
        if per_channel:
            for c in range(data.shape[0]):
                data[c] = data[c] * rng.uniform(*mult_range)
        else:
            data = data * rng.uniform(*mult_range)
    return data


def contrast_augmentation(data, rng, p=0.15, contrast_range=(0.75, 1.25),
                          preserve_range=True):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            factor = rng.uniform(*contrast_range)
            mn = data[c].mean()
            if preserve_range:
                minm, maxm = data[c].min(), data[c].max()
            data[c] = (data[c] - mn) * factor + mn
            if preserve_range:
                data[c] = np.clip(data[c], minm, maxm)
    return data


def _skimage_resize(x: np.ndarray, target_shape, order: int) -> np.ndarray:
    """skimage.transform.resize(..., mode='edge', anti_aliasing=False)
    semantics (what batchgenerators' SimulateLowRes uses): pixel-AREA
    aligned resampling with edge clamping == scipy zoom with
    grid_mode=True, mode='nearest'."""
    target_shape = tuple(int(t) for t in target_shape)
    if x.shape == target_shape:
        return x.astype(np.float32, copy=False)
    factors = np.array(target_shape) / np.array(x.shape)
    out = zoom(x.astype(float), factors, order=order, mode="nearest",
               grid_mode=True)
    assert out.shape == target_shape, (out.shape, target_shape)
    return out.astype(np.float32)


def simulate_low_resolution(data, rng, p=0.25, zoom_range=(0.5, 1.0),
                            p_per_channel=0.5, ignore_axes=None):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                z = rng.uniform(*zoom_range)
                shp = np.array(data[c].shape)
                target = np.round(shp * z).astype(int)
                target = np.maximum(target, 1)
                if ignore_axes is not None:
                    for ax in ignore_axes:
                        target[ax] = shp[ax]
                down = _skimage_resize(data[c], target, order=0)
                data[c] = _skimage_resize(down, shp, order=3)
    return data


def gamma_transform(data, rng, p, gamma_range=(0.7, 1.5), invert_image=False,
                    per_channel=True, retain_stats=True, epsilon=1e-7):
    if rng.uniform() >= p:
        return data
    for c in range(data.shape[0] if per_channel else 1):
        sl = data[c] if per_channel else data
        if invert_image:
            sl = -sl
        if retain_stats:
            mn, sd = sl.mean(), sl.std()
        if rng.uniform() < 0.5 and gamma_range[0] < 1:
            gamma = rng.uniform(gamma_range[0], 1)
        else:
            gamma = rng.uniform(max(gamma_range[0], 1), gamma_range[1])
        minm = sl.min()
        rnge = sl.max() - minm
        sl = np.power((sl - minm) / float(rnge + epsilon), gamma) * rnge + minm
        if retain_stats:
            sl = sl - sl.mean()
            sl = sl / (sl.std() + 1e-8) * sd + mn
        if invert_image:
            sl = -sl
        if per_channel:
            data[c] = sl
        else:
            data = sl
    return data


def mirror(data, seg, rng, mirror_axes: Tuple[int, ...]):
    for ax in mirror_axes:
        if rng.uniform() < 0.5:
            data = np.flip(data, ax + 1)
            if seg is not None:
                seg = np.flip(seg, ax + 1)
    return data, seg


def apply_mask_for_norm(data, seg, use_mask_for_norm: List[bool]):
    """MaskTransform: zero data outside the nonzero mask (seg channel 0 < 0)."""
    mask = seg[0] < 0
    for c, use in enumerate(use_mask_for_norm):
        if use:
            data[c][mask] = 0
    return data


def move_seg_as_one_hot_to_data(data: np.ndarray, seg: np.ndarray,
                                foreground_labels: Sequence[int]
                                ) -> Tuple[np.ndarray, np.ndarray]:
    """MoveSegAsOneHotToData (cascade_transforms.py:10-35): seg channel 1
    (previous stage) becomes len(foreground_labels) one-hot data channels."""
    prev = seg[1]
    onehot = np.stack([(prev == l).astype(data.dtype)
                       for l in foreground_labels])
    return np.concatenate([data, onehot], 0), seg[:1]


def cascade_binary_aug(data: np.ndarray, n_onehot: int,
                       rng: np.random.RandomState,
                       p_binary: float = 0.4, p_remove: float = 0.2
                       ) -> np.ndarray:
    """ApplyRandomBinaryOperatorTransform + RemoveRandomConnectedComponent
    (reference get_training_transforms :706-718): random dilation/erosion/
    open/close of the one-hot prev-stage channels + random component
    removal — teaches the cascade to distrust the previous stage."""
    from scipy.ndimage import (
        binary_closing,
        binary_dilation,
        binary_erosion,
        binary_opening,
        label as cc_label,
    )

    ops = (binary_dilation, binary_erosion, binary_opening, binary_closing)
    for c in range(data.shape[0] - n_onehot, data.shape[0]):
        if rng.uniform() < p_binary:
            op = ops[rng.randint(len(ops))]
            iters = rng.randint(1, 4)
            data[c] = op(data[c] > 0.5, iterations=iters).astype(data.dtype)
        if rng.uniform() < p_remove:
            labeled, n = cc_label(data[c] > 0.5)
            if n > 1:
                sizes = np.bincount(labeled.ravel())
                victim = rng.randint(1, n + 1)
                if sizes[victim] <= 0.15 * (data[c] > 0.5).sum():
                    data[c][labeled == victim] = 0
    return data


class TrainingTransforms:
    """Composition matching get_training_transforms (reference :643-733)."""

    def __init__(
        self,
        patch_size: Sequence[int],
        rotation_for_da: dict,
        mirror_axes: Tuple[int, ...],
        do_dummy_2d_data_aug: bool = False,
        use_mask_for_norm: List[bool] = None,
        order_resampling_data: int = 3,
        order_resampling_seg: int = 1,
        is_cascaded: bool = False,
        foreground_labels: Sequence[int] = None,
    ):
        self.patch_size = list(patch_size)
        self.rotation_for_da = rotation_for_da
        self.mirror_axes = mirror_axes
        self.do_dummy_2d = do_dummy_2d_data_aug
        self.use_mask_for_norm = use_mask_for_norm
        self.order_data = order_resampling_data
        self.order_seg = order_resampling_seg
        self.is_cascaded = is_cascaded
        self.foreground_labels = foreground_labels

    def __call__(self, data: np.ndarray, seg: np.ndarray,
                 rng: np.random.RandomState):
        """data: (c, *inflated); seg: (1, *inflated) with -1 outside mask.
        Returns (data (c, *patch) fp32, seg (1, *patch) int)."""
        dummy2d = self.do_dummy_2d and data.ndim == 4
        if dummy2d:
            # anisotropic 3D: augment in-plane only. merge z into channels
            c, z, y, x = data.shape
            data2 = data.reshape(c * z, y, x)
            seg2 = seg.reshape(seg.shape[0] * z, y, x)
            d, s = spatial_augment(
                data2, seg2, self.patch_size[1:], self.rotation_for_da,
                order_data=self.order_data, order_seg=self.order_seg, rng=rng,
            )
            # crop z to patch (loader already sampled exact z)
            data = d.reshape(c, z, *self.patch_size[1:])
            seg = s.reshape(seg.shape[0], z, *self.patch_size[1:])
            ignore_axes = (0,)
        else:
            data, seg = spatial_augment(
                data, seg, self.patch_size, self.rotation_for_da,
                order_data=self.order_data, order_seg=self.order_seg, rng=rng,
            )
            ignore_axes = None

        data = np.ascontiguousarray(data, dtype=np.float32)
        data = gaussian_noise(data, rng)
        data = gaussian_blur(data, rng)
        data = brightness_multiplicative(data, rng)
        data = contrast_augmentation(data, rng)
        data = simulate_low_resolution(data, rng, ignore_axes=ignore_axes)
        data = gamma_transform(data, rng, p=0.1, invert_image=True)
        data = gamma_transform(data, rng, p=0.3, invert_image=False)
        if self.mirror_axes:
            data, seg = mirror(data, seg, rng, self.mirror_axes)
        if self.use_mask_for_norm is not None and any(self.use_mask_for_norm):
            data = apply_mask_for_norm(data, seg, self.use_mask_for_norm)
        seg = np.where(seg == -1, 0, seg)  # RemoveLabelTransform
        if self.is_cascaded:
            data, seg = move_seg_as_one_hot_to_data(
                data, seg, self.foreground_labels)
            data = cascade_binary_aug(data, len(self.foreground_labels), rng)
        return (np.ascontiguousarray(data),
                np.ascontiguousarray(seg).astype(np.int32))


def additive_brightness(data, rng, p=0.3, mu=0.0, sigma=0.1,
                        p_per_channel=0.5):
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                data[c] = data[c] + rng.normal(mu, sigma)
    return data


def sharpening(data, rng, p=0.2, strength=(0.1, 1.0), p_per_channel=0.5):
    """Unsharp masking (DA5's SharpeningTransform)."""
    if rng.uniform() < p:
        for c in range(data.shape[0]):
            if rng.uniform() < p_per_channel:
                s = rng.uniform(*strength)
                blurred = gaussian_filter(data[c], 1.0)
                data[c] = data[c] + s * (data[c] - blurred)
    return data


class DA5TrainingTransforms(TrainingTransforms):
    """Heavy augmentation (reference variants/data_augmentation/
    nnUNetTrainerDA5.py:35): the standard stack plus wider rotation/scale
    sampling, additive brightness, and sharpening."""

    def __call__(self, data, seg, rng):
        data, seg = super().__call__(data, seg, rng)
        data = np.ascontiguousarray(data, dtype=np.float32)
        data = additive_brightness(data, rng)
        data = sharpening(data, rng)
        return data, seg


class ValidationTransforms:
    """get_validation_transforms equivalent: center crop + remove -1
    (+ cascade one-hot append, no binary aug)."""

    def __init__(self, patch_size: Sequence[int], is_cascaded: bool = False,
                 foreground_labels: Sequence[int] = None):
        self.patch_size = list(patch_size)
        self.is_cascaded = is_cascaded
        self.foreground_labels = foreground_labels

    def __call__(self, data, seg, rng=None):
        data = _center_crop(np.asarray(data, dtype=np.float32), self.patch_size)
        seg = _center_crop(np.asarray(seg), self.patch_size)
        seg = np.where(seg == -1, 0, seg)
        if self.is_cascaded:
            data, seg = move_seg_as_one_hot_to_data(
                data, seg, self.foreground_labels)
        return data, seg.astype(np.int32)
