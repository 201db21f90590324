"""Synthetic dataset generation for integration tests.

The reference derives 4 fixture datasets from Hippocampus for its integration
tests (dataset_conversion/datasets_for_integration_tests/Dataset99{6-9}_*,
prepare_integration_tests.sh). With no dataset downloads available we
generate equivalent synthetic raw datasets: random smooth blobs per class,
nonzero only inside an ellipsoid "body" so crop-to-nonzero has work to do.
Supports plain-label, region, and ignore-label variants.

Copied from ``mlagg_unet_tpu/utils/synthetic_data.py`` with the imports rewritten.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

from mlagg_unet_torch.imageio.nifti_io import write_nifti
from mlagg_unet_torch.utils.helpers import join, maybe_mkdir_p, save_json


def make_case(rng: np.random.RandomState, shape: Tuple[int, int, int],
              num_classes: int, spacing) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (image (x,y,z) float32, seg (x,y,z) uint8)."""
    img = gaussian_filter(rng.randn(*shape).astype(np.float32), 2.0)
    # ellipsoid body mask
    grids = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    body = sum(g ** 2 for g in grids) < (0.75 + 0.2 * rng.rand()) ** 2
    img = (img - img.min() + 0.1) * body

    seg = np.zeros(shape, dtype=np.uint8)
    fields = [
        gaussian_filter(rng.randn(*shape).astype(np.float32), 4.0)
        for _ in range(num_classes - 1)
    ]
    for ci, f in enumerate(fields):
        thresh = np.percentile(f[body], 80)
        seg[(f > thresh) & body] = ci + 1
    # make the task learnable: classes must be visible in the image
    # (class-dependent intensity shift + the noise texture)
    for ci in range(1, num_classes):
        img = img + (0.8 * ci) * (seg == ci)
    return img.astype(np.float32), seg


def generate_synthetic_dataset(
    raw_root: str,
    dataset_name: str = "Dataset999_Synth",
    num_train: int = 8,
    num_test: int = 2,
    shape: Tuple[int, int, int] = (24, 32, 28),
    spacing: Tuple[float, float, float] = (2.0, 1.0, 1.25),
    num_classes: int = 3,
    num_channels: int = 1,
    with_ignore_label: bool = False,
    with_regions: bool = False,
    anisotropic: bool = False,
    seed: int = 0,
) -> str:
    """Writes a raw dataset folder; returns its path."""
    rng = np.random.RandomState(seed)
    if anisotropic:
        spacing = (spacing[0] * 4, spacing[1], spacing[2])

    base = join(raw_root, dataset_name)
    maybe_mkdir_p(join(base, "imagesTr"))
    maybe_mkdir_p(join(base, "labelsTr"))
    maybe_mkdir_p(join(base, "imagesTs"))

    spacing_xyz = tuple(spacing[::-1])  # arrays are (x,y,z) index = reversed

    for i in range(num_train):
        img, seg = make_case(rng, shape, num_classes, spacing)
        if with_ignore_label:
            ignore_mask = rng.rand(*shape) < 0.2
            seg = seg.copy()
            seg[ignore_mask] = num_classes
        for c in range(num_channels):
            write_nifti(
                join(base, "imagesTr", f"case_{i:03d}_{c:04d}.nii.gz"),
                img.transpose(2, 1, 0) * (1.0 + 0.05 * c), spacing_xyz,
            )
        write_nifti(join(base, "labelsTr", f"case_{i:03d}.nii.gz"),
                    seg.transpose(2, 1, 0), spacing_xyz)
    for i in range(num_test):
        img, _ = make_case(rng, shape, num_classes, spacing)
        for c in range(num_channels):
            write_nifti(
                join(base, "imagesTs", f"case_ts_{i:03d}_{c:04d}.nii.gz"),
                img.transpose(2, 1, 0), spacing_xyz,
            )

    if with_regions:
        labels = {
            "background": 0,
            "whole": list(range(1, num_classes)),
            "core": [num_classes - 1],
        }
        regions_class_order = [1, num_classes - 1]
        if with_ignore_label:
            labels["ignore"] = num_classes
    else:
        labels = {"background": 0}
        for ci in range(1, num_classes):
            labels[f"class{ci}"] = ci
        regions_class_order = None
        if with_ignore_label:
            labels["ignore"] = num_classes

    dataset_json = {
        "channel_names": {str(c): "zscore" for c in range(num_channels)},
        "labels": labels,
        "numTraining": num_train,
        "file_ending": ".nii.gz",
    }
    if regions_class_order is not None:
        dataset_json["regions_class_order"] = regions_class_order
    save_json(dataset_json, join(base, "dataset.json"))
    return base
