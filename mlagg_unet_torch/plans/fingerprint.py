"""Dataset fingerprint extraction
(reference: experiment_planning/dataset_fingerprint/fingerprint_extractor.py:17-177).

Per-case: read, crop-to-nonzero, sample foreground intensities; dataset-level:
spacings, shapes after crop, per-channel fg intensity stats, median relative
size after cropping -> dataset_fingerprint.json (same schema as reference).

Copied from ``mlagg_unet_tpu/plans/fingerprint.py`` with the imports rewritten.
"""
from __future__ import annotations

import os
from typing import List, Type, Union

import numpy as np

from mlagg_unet_torch import paths
from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter
from mlagg_unet_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_dataset_json,
)
from mlagg_unet_torch.preprocessing.cropping import crop_to_nonzero
from mlagg_unet_torch.utils.helpers import (
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
    save_json,
    subfiles,
)


def get_identifiers_from_splitted_dataset_folder(folder: str, file_ending: str
                                                 ) -> List[str]:
    files = subfiles(folder, suffix=file_ending, join_path=False)
    # strip _XXXX channel suffix + ending
    crop = len(file_ending) + 5
    return sorted(np.unique([f[:-crop] for f in files]).tolist())


def create_lists_from_splitted_dataset_folder(folder: str, file_ending: str,
                                              identifiers: List[str] = None
                                              ) -> List[List[str]]:
    if identifiers is None:
        identifiers = get_identifiers_from_splitted_dataset_folder(folder, file_ending)
    files = subfiles(folder, suffix=file_ending, join_path=False)
    list_of_lists = []
    for ident in identifiers:
        list_of_lists.append(
            [join(folder, f) for f in files
             if f.startswith(ident + "_") and
             len(f) == len(ident) + 5 + len(file_ending)]
        )
    return list_of_lists


class DatasetFingerprintExtractor:
    def __init__(self, dataset_name_or_id: Union[str, int],
                 num_processes: int = 8, verbose: bool = False):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.verbose = verbose
        self.input_folder = join(paths.nnUNet_raw, self.dataset_name)
        self.num_processes = num_processes
        self.dataset_json = load_json(join(self.input_folder, "dataset.json"))
        self.num_foreground_voxels_for_intensitystats = 10e7

    @staticmethod
    def collect_foreground_intensities(segmentation: np.ndarray,
                                       images: np.ndarray, seed: int = 1234,
                                       num_samples: int = 10000):
        assert images.ndim == 4 and segmentation.ndim == 4
        assert not np.any(np.isnan(segmentation)), "segmentation contains NaNs"
        assert not np.any(np.isnan(images)), "image contains NaNs"

        rs = np.random.RandomState(seed)
        intensities_per_channel = []
        intensity_statistics_per_channel = []
        foreground_mask = segmentation[0] > 0

        for i in range(len(images)):
            foreground_pixels = images[i][foreground_mask]
            num_fg = len(foreground_pixels)
            intensities_per_channel.append(
                rs.choice(foreground_pixels, num_samples, replace=True)
                if num_fg > 0 else []
            )
            intensity_statistics_per_channel.append({
                "mean": np.mean(foreground_pixels) if num_fg > 0 else np.nan,
                "median": np.median(foreground_pixels) if num_fg > 0 else np.nan,
                "min": np.min(foreground_pixels) if num_fg > 0 else np.nan,
                "max": np.max(foreground_pixels) if num_fg > 0 else np.nan,
                "percentile_99_5": np.percentile(foreground_pixels, 99.5)
                if num_fg > 0 else np.nan,
                "percentile_00_5": np.percentile(foreground_pixels, 0.5)
                if num_fg > 0 else np.nan,
            })
        return intensities_per_channel, intensity_statistics_per_channel

    @staticmethod
    def analyze_case(image_files: List[str], segmentation_file: str,
                     reader_writer_class: Type[BaseReaderWriter],
                     num_samples: int = 10000):
        rw = reader_writer_class()
        images, properties_images = rw.read_images(image_files)
        segmentation, _ = rw.read_seg(segmentation_file)
        data_cropped, seg_cropped, bbox = crop_to_nonzero(images, segmentation)

        fg_int_per_channel, fg_stats_per_channel = (
            DatasetFingerprintExtractor.collect_foreground_intensities(
                seg_cropped, data_cropped, num_samples=num_samples
            )
        )
        spacing = properties_images["spacing"]
        shape_before_crop = images.shape[1:]
        shape_after_crop = data_cropped.shape[1:]
        relative_size = np.prod(shape_after_crop) / np.prod(shape_before_crop)
        return (shape_after_crop, spacing, fg_int_per_channel,
                fg_stats_per_channel, relative_size)

    def run(self, overwrite_existing: bool = False) -> dict:
        preprocessed_output_folder = join(paths.nnUNet_preprocessed, self.dataset_name)
        maybe_mkdir_p(preprocessed_output_folder)
        properties_file = join(preprocessed_output_folder, "dataset_fingerprint.json")

        if isfile(properties_file) and not overwrite_existing:
            return load_json(properties_file)

        file_ending = self.dataset_json["file_ending"]
        training_identifiers = get_identifiers_from_splitted_dataset_folder(
            join(self.input_folder, "imagesTr"), file_ending
        )
        reader_writer_class = determine_reader_writer_from_dataset_json(
            self.dataset_json,
            join(self.input_folder, "imagesTr",
                 training_identifiers[0] + "_0000" + file_ending),
        )
        training_images_per_case = create_lists_from_splitted_dataset_folder(
            join(self.input_folder, "imagesTr"), file_ending, training_identifiers
        )
        training_labels_per_case = [
            join(self.input_folder, "labelsTr", i + file_ending)
            for i in training_identifiers
        ]
        num_fg_samples_per_case = int(
            self.num_foreground_voxels_for_intensitystats
            // len(training_identifiers)
        )

        results = [
            DatasetFingerprintExtractor.analyze_case(
                imgs, lbl, reader_writer_class, num_fg_samples_per_case
            )
            for imgs, lbl in zip(training_images_per_case, training_labels_per_case)
        ]

        shapes_after_crop = [r[0] for r in results]
        spacings = [r[1] for r in results]
        fg_per_channel = [
            np.concatenate([np.asarray(r[2][i]).ravel() for r in results])
            for i in range(len(results[0][2]))
        ]
        median_relative_size = np.median([r[4] for r in results], 0)

        num_channels = len(
            self.dataset_json.get("channel_names",
                                  self.dataset_json.get("modality", {}))
        )
        intensity_statistics_per_channel = {}
        for i in range(num_channels):
            vals = fg_per_channel[i]
            intensity_statistics_per_channel[i] = {
                "mean": float(np.mean(vals)),
                "median": float(np.median(vals)),
                "std": float(np.std(vals)),
                "min": float(np.min(vals)),
                "max": float(np.max(vals)),
                "percentile_99_5": float(np.percentile(vals, 99.5)),
                "percentile_00_5": float(np.percentile(vals, 0.5)),
            }

        fingerprint = {
            "spacings": spacings,
            "shapes_after_crop": shapes_after_crop,
            "foreground_intensity_properties_per_channel":
                intensity_statistics_per_channel,
            "median_relative_size_after_cropping": median_relative_size,
        }
        try:
            save_json(fingerprint, properties_file)
        except Exception:
            if isfile(properties_file):
                os.remove(properties_file)
            raise
        return fingerprint
