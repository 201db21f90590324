"""Seg-over-image overlay PNGs for QA
(reference: utilities/overlay_plots.py:52-273).

Copied from ``mlagg_unet_tpu/utils/overlay_plots.py`` with the imports rewritten.
"""
from __future__ import annotations

import multiprocessing
from typing import List, Optional, Tuple, Union

import numpy as np

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
)

color_cycle = (
    "000000", "4363d8", "f58231", "3cb44b", "e6194B", "911eb4", "ffe119",
    "bfef45", "42d4f4", "f032e6", "000075", "9A6324", "808000", "800000",
    "469990",
)


def hex_to_rgb(hex_str: str) -> Tuple[int, int, int]:
    return tuple(int(hex_str[i: i + 2], 16) for i in (0, 2, 4))


def generate_overlay(
    input_image: np.ndarray,
    segmentation: np.ndarray,
    mapping: dict = None,
    color_cycle: Tuple[str, ...] = color_cycle,
    overlay_intensity: float = 0.6,
) -> np.ndarray:
    """input_image/segmentation: 2D (x, y). Returns (x, y, 3) uint8-range
    float image (reference :52-96)."""
    image = np.copy(input_image).astype(np.float64)
    if image.ndim != 2:
        raise RuntimeError("overlays need 2D slices")
    image = np.tile(image[:, :, None], (1, 1, 3))
    image -= image.min()
    image /= max(image.max(), 1e-8)
    image *= 255

    if mapping is None:
        uniques = np.sort(np.unique(segmentation.ravel()))
        mapping = {i: c for c, i in enumerate(uniques)}

    for l, c in mapping.items():
        if l == 0:
            continue
        color = hex_to_rgb(color_cycle[c % len(color_cycle)])
        image[segmentation == l] += overlay_intensity * np.array(color)

    return np.clip(image, 0, 255).astype(np.uint8)


def select_slice(image_4d: np.ndarray, seg_3d: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pick the slice with the most foreground (reference behavior)."""
    fg_per_slice = (seg_3d > 0).sum(axis=(1, 2))
    idx = int(np.argmax(fg_per_slice))
    return image_4d[0, idx], seg_3d[idx]


def plot_overlay(image_files: List[str], seg_file: str, reader_writer,
                 output_file: str, overlay_intensity: float = 0.6):
    from PIL import Image

    image, _ = reader_writer.read_images(image_files)
    seg, _ = reader_writer.read_seg(seg_file)
    sl_img, sl_seg = select_slice(image, seg[0])
    overlay = generate_overlay(sl_img, sl_seg,
                               overlay_intensity=overlay_intensity)
    Image.fromarray(overlay).save(output_file)


def generate_overlays_for_dataset(dataset_name_or_id, output_folder: str,
                                  num_processes: int = 8):
    from mlagg_unet_torch.imageio.reader_writer_registry import (
        determine_reader_writer_from_dataset_json,
    )
    from mlagg_unet_torch.plans.fingerprint import (
        create_lists_from_splitted_dataset_folder,
        get_identifiers_from_splitted_dataset_folder,
    )

    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    folder = join(paths.nnUNet_raw, dataset_name)
    dataset_json = load_json(join(folder, "dataset.json"))
    file_ending = dataset_json["file_ending"]
    identifiers = get_identifiers_from_splitted_dataset_folder(
        join(folder, "imagesTr"), file_ending)
    image_lists = create_lists_from_splitted_dataset_folder(
        join(folder, "imagesTr"), file_ending, identifiers)
    rw = determine_reader_writer_from_dataset_json(
        dataset_json, image_lists[0][0])()
    maybe_mkdir_p(output_folder)
    for ident, images in zip(identifiers, image_lists):
        plot_overlay(images, join(folder, "labelsTr", ident + file_ending),
                     rw, join(output_folder, ident + ".png"))
