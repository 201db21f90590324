"""DefaultPreprocessor: per-case read -> transpose -> crop -> normalize ->
resample -> fg-location sampling -> save (reference:
preprocessing/preprocessors/default_preprocessor.py:38-261).

Artifact layout is identical to the reference (.npz with 'data'/'seg' +
properties .pkl) so preprocessed datasets interoperate.

Copied from ``mlagg_unet_tpu/preprocessing/preprocessor.py`` with the imports
rewritten. The pool of ``run`` spawns its workers with the CUDA card hidden
(``_spawn_worker_init``): a worker imports the package, and with it torch,
but preprocessing is numpy only and must not open a context on the card.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import List, Tuple, Union

import numpy as np

from mlagg_unet_torch import paths
from mlagg_unet_torch.plans.plans_handler import ConfigurationManager, PlansManager
from mlagg_unet_torch.preprocessing.cropping import crop_to_nonzero
from mlagg_unet_torch.preprocessing.normalization import get_normalization_scheme_by_name
from mlagg_unet_torch.preprocessing.resampling import compute_new_shape
from mlagg_unet_torch.utils.helpers import (
    join,
    load_json,
    maybe_mkdir_p,
    subfiles,
    write_pickle,
)


class DefaultPreprocessor:
    def __init__(self, verbose: bool = False):
        self.verbose = verbose

    def run_case_npy(
        self,
        data: np.ndarray,
        seg: Union[np.ndarray, None],
        properties: dict,
        plans_manager: PlansManager,
        configuration_manager: ConfigurationManager,
        dataset_json: dict,
    ) -> Tuple[np.ndarray, np.ndarray, dict]:
        data = np.copy(data)
        if seg is not None:
            seg = np.copy(seg)

        # transpose_forward applies to axes AND spacing
        tf = plans_manager.transpose_forward
        data = data.transpose([0, *[i + 1 for i in tf]])
        if seg is not None:
            seg = seg.transpose([0, *[i + 1 for i in tf]])
        original_spacing = [properties["spacing"][i] for i in tf]

        shape_before_cropping = data.shape[1:]
        properties["shape_before_cropping"] = shape_before_cropping
        data, seg, bbox = crop_to_nonzero(data, seg)
        properties["bbox_used_for_cropping"] = bbox
        properties["shape_after_cropping_and_before_resampling"] = data.shape[1:]

        target_spacing = list(configuration_manager.spacing)
        if len(target_spacing) < len(data.shape[1:]):
            # 2d configs keep the out-of-plane spacing unchanged
            target_spacing = [original_spacing[0]] + target_spacing
        new_shape = compute_new_shape(data.shape[1:], original_spacing, target_spacing)

        # normalize BEFORE resampling (nonzero-mask fit, reference :87-89)
        data = self._normalize(
            data, seg, configuration_manager,
            plans_manager.foreground_intensity_properties_per_channel,
        )

        data = configuration_manager.resampling_fn_data(
            data, new_shape, original_spacing, target_spacing
        )
        seg = configuration_manager.resampling_fn_seg(
            seg, new_shape, original_spacing, target_spacing
        )

        if seg is not None:
            label_manager = plans_manager.get_label_manager(dataset_json)
            collect_for_this = (
                list(label_manager.foreground_regions)
                if label_manager.has_regions
                else list(label_manager.foreground_labels)
            )
            if label_manager.has_ignore_label:
                collect_for_this.append(label_manager.all_labels)
            properties["class_locations"] = self._sample_foreground_locations(
                seg, collect_for_this, verbose=self.verbose
            )
            seg = self.modify_seg_fn(seg, plans_manager, dataset_json,
                                     configuration_manager)
        if seg is not None:
            seg = seg.astype(np.int16 if np.max(seg) > 127 else np.int8)
        return data, seg, properties

    def run_case(
        self,
        image_files: List[str],
        seg_file: Union[str, None],
        plans_manager: PlansManager,
        configuration_manager: ConfigurationManager,
        dataset_json: Union[dict, str],
    ):
        if isinstance(dataset_json, str):
            dataset_json = load_json(dataset_json)
        rw = plans_manager.image_reader_writer_class()
        data, properties = rw.read_images(image_files)
        if seg_file is not None:
            seg, _ = rw.read_seg(seg_file)
        else:
            seg = None
        return self.run_case_npy(data, seg, properties, plans_manager,
                                 configuration_manager, dataset_json)

    def run_case_save(
        self,
        output_filename_truncated: str,
        image_files: List[str],
        seg_file: str,
        plans_manager: PlansManager,
        configuration_manager: ConfigurationManager,
        dataset_json: Union[dict, str],
    ):
        data, seg, properties = self.run_case(
            image_files, seg_file, plans_manager, configuration_manager, dataset_json
        )
        np.savez_compressed(output_filename_truncated + ".npz", data=data, seg=seg)
        write_pickle(properties, output_filename_truncated + ".pkl")

    @staticmethod
    def _sample_foreground_locations(
        seg: np.ndarray, classes_or_regions, seed: int = 1234, verbose: bool = False
    ):
        """10k samples per class/region, >= 1% coverage (reference :134-163)."""
        num_samples = 10000
        min_percent_coverage = 0.01
        rndst = np.random.RandomState(seed)
        class_locs = {}
        for c in classes_or_regions:
            k = tuple(c) if isinstance(c, (tuple, list)) else c
            if isinstance(c, (tuple, list)):
                mask = seg == c[0]
                for cc in c[1:]:
                    mask = mask | (seg == cc)
                all_locs = np.argwhere(mask)
            else:
                all_locs = np.argwhere(seg == c)
            if len(all_locs) == 0:
                class_locs[k] = []
                continue
            target_num_samples = min(num_samples, len(all_locs))
            target_num_samples = max(
                target_num_samples, int(np.ceil(len(all_locs) * min_percent_coverage))
            )
            selected = all_locs[
                rndst.choice(len(all_locs), target_num_samples, replace=False)
            ]
            class_locs[k] = selected
        return class_locs

    def _normalize(self, data, seg, configuration_manager,
                   foreground_intensity_properties_per_channel):
        for c in range(data.shape[0]):
            scheme = configuration_manager.normalization_schemes[c]
            normalizer_class = get_normalization_scheme_by_name(scheme)
            normalizer = normalizer_class(
                use_mask_for_norm=configuration_manager.use_mask_for_norm[c],
                intensityproperties=foreground_intensity_properties_per_channel[str(c)],
            )
            data[c] = normalizer.run(data[c], seg[0] if seg is not None else None)
        return data

    def modify_seg_fn(self, seg, plans_manager, dataset_json,
                      configuration_manager) -> np.ndarray:
        return seg

    def run(self, dataset_name_or_id: Union[int, str], configuration_name: str,
            plans_identifier: str = "nnUNetPlans",
            num_processes: int = 8):
        """Preprocess a whole dataset into nnUNet_preprocessed
        (reference :177-261)."""
        from mlagg_unet_torch.utils.helpers import maybe_convert_to_dataset_name

        dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        plans_file = join(paths.nnUNet_preprocessed, dataset_name,
                          plans_identifier + ".json")
        plans_manager = PlansManager(plans_file)
        configuration_manager = plans_manager.get_configuration(configuration_name)
        dataset_json = load_json(
            join(paths.nnUNet_raw, dataset_name, "dataset.json")
        )

        output_directory = join(
            paths.nnUNet_preprocessed, dataset_name,
            configuration_manager.data_identifier,
        )
        maybe_mkdir_p(output_directory)

        # copy ground-truth segmentations for later evaluation
        # (reference default_preprocessor.py:214-217)
        import shutil

        gt_dir = join(paths.nnUNet_preprocessed, dataset_name,
                      "gt_segmentations")
        maybe_mkdir_p(gt_dir)
        for f in subfiles(join(paths.nnUNet_raw, dataset_name, "labelsTr"),
                          join_path=False):
            if not os.path.isfile(join(gt_dir, f)):
                shutil.copy(
                    join(paths.nnUNet_raw, dataset_name, "labelsTr", f),
                    join(gt_dir, f),
                )

        from mlagg_unet_torch.data.dataset import get_case_identifiers_from_raw

        identifiers = get_case_identifiers_from_raw(
            join(paths.nnUNet_raw, dataset_name), dataset_json
        )
        file_ending = dataset_json["file_ending"]
        jobs = []
        for ident in identifiers:
            image_files = subfiles(
                join(paths.nnUNet_raw, dataset_name, "imagesTr"),
                prefix=ident + "_", suffix=file_ending,
            )
            seg_file = join(paths.nnUNet_raw, dataset_name, "labelsTr",
                            ident + file_ending)
            jobs.append((join(output_directory, ident), image_files, seg_file))

        if num_processes <= 1:
            for out, imgs, seg in jobs:
                self.run_case_save(out, imgs, seg, plans_manager,
                                   configuration_manager, dataset_json)
        else:
            if not os.environ.get("MLAGG_DISABLE_NATIVE"):
                from mlagg_unet_torch import native

                native.build()   # here once, not in every worker at its first resize
            ctx = multiprocessing.get_context("spawn")
            with ctx.Pool(num_processes, initializer=_spawn_worker_init) as pool:
                pool.starmap(
                    _run_case_save_star,
                    [
                        (self, out, imgs, seg, plans_manager.plans,
                         configuration_name, dataset_json)
                        for out, imgs, seg in jobs
                    ],
                )


def _spawn_worker_init() -> None:
    """Hide the CUDA card from a preprocessing worker."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""


def _run_case_save_star(preprocessor, out, imgs, seg, plans_dict,
                        configuration_name, dataset_json):
    pm = PlansManager(plans_dict)
    cm = pm.get_configuration(configuration_name)
    preprocessor.run_case_save(out, imgs, seg, pm, cm, dataset_json)
