"""Rule-based experiment planner
(reference: experiment_planning/experiment_planners/default_experiment_planner.py:22-534).

Faithful port of the self-configuration rules: anisotropy-corrected median
target spacing (:156-197), spacing-sorted transpose (:216), normalization
choice (:199), the iterative patch-size shrink loop against a memory
reference (:229-337), topology via get_pool_and_conv_props, and 2d /
3d_fullres / 3d_lowres / 3d_cascade_fullres plan emission (:371-500).

One deliberate change: the reference's memory proxy instantiates a torch
PlainConvUNet and calls compute_conv_feature_map_size (:86-112). We compute
that same feature-map-element count ANALYTICALLY (the formula is a plain sum
over stages) — no network instantiation, same numbers, so patch/batch sizes
match reference plans. All reference constants are preserved so plans.json
output is drop-in compatible.

Copied from ``mlagg_unet_tpu/plans/experiment_planner.py`` with the imports rewritten.
"""
from __future__ import annotations

import shutil
from copy import deepcopy
from typing import List, Tuple, Union

import numpy as np

from mlagg_unet_torch import paths
from mlagg_unet_torch.configuration import ANISO_THRESHOLD
from mlagg_unet_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_dataset_json,
)
from mlagg_unet_torch.plans.fingerprint import (
    get_identifiers_from_splitted_dataset_folder,
)
from mlagg_unet_torch.plans.network_topology import get_pool_and_conv_props
from mlagg_unet_torch.preprocessing.normalization import get_normalization_scheme
from mlagg_unet_torch.preprocessing.resampling import compute_new_shape
from mlagg_unet_torch.utils.helpers import (
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
    save_json,
)


def compute_unet_feature_map_elements(
    patch_size: Tuple[int, ...],
    n_stages: int,
    strides: Tuple[Tuple[int, ...], ...],
    features_per_stage: Tuple[int, ...],
    blocks_per_stage_encoder: Tuple[int, ...],
    blocks_per_stage_decoder: Tuple[int, ...],
    num_input_channels: int,
    num_classes: int,
) -> int:
    """Analytic equivalent of dynamic_network_architectures'
    PlainConvUNet.compute_conv_feature_map_size: total conv-output elements
    of encoder + decoder (transpconvs + final seg head, no deep supervision,
    matching the reference's estimator instantiation)."""
    # encoder
    size = list(patch_size)
    total = np.int64(0)
    skip_sizes = []
    for s in range(n_stages):
        size = [i // j for i, j in zip(size, strides[s])]
        skip_sizes.append(list(size))
        total += np.int64(blocks_per_stage_encoder[s]) * int(np.prod(size)) \
            * features_per_stage[s]
    # decoder: stage s upsamples to skip of stage n-2-s
    n_dec = n_stages - 1
    for s in range(n_dec):
        target_size = skip_sizes[-(s + 2)]
        target_feats = features_per_stage[-(s + 2)]
        # transpconv output
        total += np.int64(int(np.prod(target_size))) * target_feats
        # stacked conv blocks
        total += np.int64(blocks_per_stage_decoder[s]) * int(np.prod(target_size)) \
            * target_feats
        # seg head only at the last (full-res) stage (deep_supervision=False)
        if s == n_dec - 1:
            total += np.int64(int(np.prod(target_size))) * num_classes
    return int(total)


class ExperimentPlanner:
    def __init__(
        self,
        dataset_name_or_id: Union[str, int],
        gpu_memory_target_in_gb: float = 8,
        preprocessor_name: str = "DefaultPreprocessor",
        plans_name: str = "nnUNetPlans",
        overwrite_target_spacing: Union[List[float], Tuple[float, ...]] = None,
        suppress_transpose: bool = False,
    ):
        self.dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
        self.suppress_transpose = suppress_transpose
        self.raw_dataset_folder = join(paths.nnUNet_raw, self.dataset_name)
        preprocessed_folder = join(paths.nnUNet_preprocessed, self.dataset_name)
        self.dataset_json = load_json(join(self.raw_dataset_folder, "dataset.json"))

        fp_file = join(preprocessed_folder, "dataset_fingerprint.json")
        if not isfile(fp_file):
            raise RuntimeError(
                "Fingerprint missing. Run fingerprint extraction first."
            )
        self.dataset_fingerprint = load_json(fp_file)

        self.anisotropy_threshold = ANISO_THRESHOLD

        # reference constants (:46-67)
        self.UNet_base_num_features = 32
        self.UNet_class_name = "PlainConvUNet"
        self.UNet_reference_val_3d = 560000000
        self.UNet_reference_val_2d = 85000000
        self.UNet_reference_com_nfeatures = 32
        self.UNet_reference_val_corresp_GB = 8
        self.UNet_reference_val_corresp_bs_2d = 12
        self.UNet_reference_val_corresp_bs_3d = 2
        self.UNet_vram_target_GB = gpu_memory_target_in_gb
        self.UNet_featuremap_min_edge_length = 4
        self.UNet_blocks_per_stage_encoder = (2,) * 14
        self.UNet_blocks_per_stage_decoder = (2,) * 13
        self.UNet_min_batch_size = 2
        self.UNet_max_features_2d = 512
        self.UNet_max_features_3d = 320

        self.lowres_creation_threshold = 0.25

        self.preprocessor_name = preprocessor_name
        self.plans_identifier = plans_name
        self.overwrite_target_spacing = overwrite_target_spacing
        self.plans = None

    # ------------------------------------------------------------------
    def determine_reader_writer(self):
        file_ending = self.dataset_json["file_ending"]
        identifiers = get_identifiers_from_splitted_dataset_folder(
            join(self.raw_dataset_folder, "imagesTr"), file_ending
        )
        return determine_reader_writer_from_dataset_json(
            self.dataset_json,
            join(self.raw_dataset_folder, "imagesTr",
                 identifiers[0] + "_0000" + file_ending),
        )

    def determine_fullres_target_spacing(self) -> np.ndarray:
        """Median spacing, anisotropy-corrected (reference :156-197)."""
        if self.overwrite_target_spacing is not None:
            return np.array(self.overwrite_target_spacing)

        spacings = self.dataset_fingerprint["spacings"]
        sizes = self.dataset_fingerprint["shapes_after_crop"]

        target = np.percentile(np.vstack(spacings), 50, 0)
        target_size = np.percentile(np.vstack(sizes), 50, 0)
        worst_spacing_axis = np.argmax(target)
        other_axes = [i for i in range(len(target)) if i != worst_spacing_axis]
        other_spacings = [target[i] for i in other_axes]
        other_sizes = [target_size[i] for i in other_axes]

        has_aniso_spacing = target[worst_spacing_axis] > (
            self.anisotropy_threshold * max(other_spacings)
        )
        has_aniso_voxels = (
            target_size[worst_spacing_axis] * self.anisotropy_threshold
            < min(other_sizes)
        )
        if has_aniso_spacing and has_aniso_voxels:
            spacings_of_that_axis = np.vstack(spacings)[:, worst_spacing_axis]
            target_spacing_of_that_axis = np.percentile(spacings_of_that_axis, 10)
            if target_spacing_of_that_axis < max(other_spacings):
                target_spacing_of_that_axis = (
                    max(max(other_spacings), target_spacing_of_that_axis) + 1e-5
                )
            target[worst_spacing_axis] = target_spacing_of_that_axis
        return target

    def determine_normalization_scheme_and_whether_mask_is_used_for_norm(
        self,
    ) -> Tuple[List[str], List[bool]]:
        modalities = self.dataset_json.get(
            "channel_names", self.dataset_json.get("modality")
        )
        normalization_schemes = [get_normalization_scheme(m)
                                 for m in modalities.values()]
        if (self.dataset_fingerprint["median_relative_size_after_cropping"]
                < 3 / 4.0):
            use_nonzero_mask_for_norm = [
                i.leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true
                for i in normalization_schemes
            ]
        else:
            use_nonzero_mask_for_norm = [False] * len(normalization_schemes)
        return ([i.__name__ for i in normalization_schemes],
                use_nonzero_mask_for_norm)

    def determine_transpose(self) -> Tuple[List[int], List[int]]:
        if self.suppress_transpose:
            return [0, 1, 2], [0, 1, 2]
        target_spacing = self.determine_fullres_target_spacing()
        max_spacing_axis = int(np.argmax(target_spacing))
        remaining_axes = [i for i in range(3) if i != max_spacing_axis]
        transpose_forward = [max_spacing_axis] + remaining_axes
        transpose_backward = [
            int(np.argwhere(np.array(transpose_forward) == i)[0][0])
            for i in range(3)
        ]
        return transpose_forward, transpose_backward

    def determine_resampling(self):
        return (
            "resample_data_or_seg_to_shape",
            {"is_seg": False, "order": 3, "order_z": 0, "force_separate_z": None},
            "resample_data_or_seg_to_shape",
            {"is_seg": True, "order": 1, "order_z": 0, "force_separate_z": None},
        )

    def determine_segmentation_softmax_export_fn(self):
        return (
            "resample_data_or_seg_to_shape",
            {"is_seg": False, "order": 1, "order_z": 0, "force_separate_z": None},
        )

    def _estimate(self, patch_size, pool_op_kernel_sizes) -> int:
        num_stages = len(pool_op_kernel_sizes)
        max_feats = (self.UNet_max_features_2d if len(patch_size) == 2
                     else self.UNet_max_features_3d)
        features = tuple(
            min(max_feats, self.UNet_reference_com_nfeatures * 2 ** i)
            for i in range(num_stages)
        )
        num_channels = len(self.dataset_json.get(
            "channel_names", self.dataset_json.get("modality")))
        return compute_unet_feature_map_elements(
            tuple(patch_size), num_stages,
            tuple(tuple(i) for i in pool_op_kernel_sizes),
            features,
            self.UNet_blocks_per_stage_encoder[:num_stages],
            self.UNet_blocks_per_stage_decoder[: num_stages - 1],
            num_channels,
            len(self.dataset_json["labels"]),
        )

    def get_plans_for_configuration(
        self, spacing, median_shape, data_identifier: str,
        approximate_n_voxels_dataset: float,
    ) -> dict:
        assert all(i > 0 for i in spacing), f"spacing must be > 0: {spacing}"
        tmp = 1 / np.array(spacing)
        if len(spacing) == 3:
            initial_patch_size = [
                round(i) for i in tmp * (256 ** 3 / np.prod(tmp)) ** (1 / 3)
            ]
        elif len(spacing) == 2:
            initial_patch_size = [
                round(i) for i in tmp * (2048 ** 2 / np.prod(tmp)) ** (1 / 2)
            ]
        else:
            raise RuntimeError()

        initial_patch_size = np.array(
            [min(i, j) for i, j in zip(initial_patch_size,
                                       median_shape[: len(spacing)])]
        )

        (network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
         patch_size, shape_must_be_divisible_by) = get_pool_and_conv_props(
            spacing, initial_patch_size,
            self.UNet_featuremap_min_edge_length, 999999,
        )

        estimate = self._estimate(patch_size, pool_op_kernel_sizes)
        reference = (
            self.UNet_reference_val_2d if len(spacing) == 2
            else self.UNet_reference_val_3d
        ) * (self.UNet_vram_target_GB / self.UNet_reference_val_corresp_GB)

        while estimate > reference:
            axis_to_be_reduced = np.argsort(
                np.array(patch_size) / np.array(median_shape[: len(spacing)])
            )[-1]
            tmp_ps = deepcopy(patch_size)
            tmp_ps[axis_to_be_reduced] -= shape_must_be_divisible_by[
                axis_to_be_reduced]
            _, _, _, _, shape_must_be_divisible_by = get_pool_and_conv_props(
                spacing, tmp_ps, self.UNet_featuremap_min_edge_length, 999999,
            )
            patch_size[axis_to_be_reduced] -= shape_must_be_divisible_by[
                axis_to_be_reduced]

            (network_num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes,
             patch_size, shape_must_be_divisible_by) = get_pool_and_conv_props(
                spacing, patch_size, self.UNet_featuremap_min_edge_length, 999999,
            )
            estimate = self._estimate(patch_size, pool_op_kernel_sizes)

        ref_bs = (self.UNet_reference_val_corresp_bs_2d if len(spacing) == 2
                  else self.UNet_reference_val_corresp_bs_3d)
        batch_size = round((reference / estimate) * ref_bs)
        bs_5_percent = round(
            approximate_n_voxels_dataset * 0.05
            / np.prod(patch_size, dtype=np.float64)
        )
        batch_size = max(min(batch_size, bs_5_percent), self.UNet_min_batch_size)

        (resampling_data, resampling_data_kwargs,
         resampling_seg, resampling_seg_kwargs) = self.determine_resampling()
        resampling_softmax, resampling_softmax_kwargs = (
            self.determine_segmentation_softmax_export_fn()
        )
        normalization_schemes, mask_is_used_for_norm = (
            self.determine_normalization_scheme_and_whether_mask_is_used_for_norm()
        )
        num_stages = len(pool_op_kernel_sizes)
        return {
            "data_identifier": data_identifier,
            "preprocessor_name": self.preprocessor_name,
            "batch_size": int(batch_size),
            "patch_size": [int(i) for i in patch_size],
            "median_image_size_in_voxels": [float(i) for i in median_shape],
            "spacing": [float(i) for i in spacing],
            "normalization_schemes": normalization_schemes,
            "use_mask_for_norm": mask_is_used_for_norm,
            "UNet_class_name": self.UNet_class_name,
            "UNet_base_num_features": self.UNet_base_num_features,
            "n_conv_per_stage_encoder":
                list(self.UNet_blocks_per_stage_encoder[:num_stages]),
            "n_conv_per_stage_decoder":
                list(self.UNet_blocks_per_stage_decoder[: num_stages - 1]),
            "num_pool_per_axis": [int(i) for i in network_num_pool_per_axis],
            "pool_op_kernel_sizes": [[int(j) for j in i]
                                     for i in pool_op_kernel_sizes],
            "conv_kernel_sizes": [[int(j) for j in i]
                                  for i in conv_kernel_sizes],
            "unet_max_num_features": (
                self.UNet_max_features_3d if len(spacing) == 3
                else self.UNet_max_features_2d
            ),
            "resampling_fn_data": resampling_data,
            "resampling_fn_seg": resampling_seg,
            "resampling_fn_data_kwargs": resampling_data_kwargs,
            "resampling_fn_seg_kwargs": resampling_seg_kwargs,
            "resampling_fn_probabilities": resampling_softmax,
            "resampling_fn_probabilities_kwargs": resampling_softmax_kwargs,
        }

    def plan_experiment(self) -> dict:
        transpose_forward, transpose_backward = self.determine_transpose()
        fullres_spacing = self.determine_fullres_target_spacing()
        fullres_spacing_transposed = fullres_spacing[transpose_forward]

        new_shapes = [
            compute_new_shape(j, i, fullres_spacing)
            for i, j in zip(self.dataset_fingerprint["spacings"],
                            self.dataset_fingerprint["shapes_after_crop"])
        ]
        new_median_shape = np.median(new_shapes, 0)
        new_median_shape_transposed = new_median_shape[transpose_forward]

        approximate_n_voxels_dataset = float(
            np.prod(new_median_shape_transposed, dtype=np.float64)
            * self.dataset_json["numTraining"]
        )

        if new_median_shape_transposed[0] != 1:
            plan_3d_fullres = self.get_plans_for_configuration(
                fullres_spacing_transposed, new_median_shape_transposed,
                self.generate_data_identifier("3d_fullres"),
                approximate_n_voxels_dataset,
            )
            patch_size_fullres = plan_3d_fullres["patch_size"]
            median_num_voxels = np.prod(new_median_shape_transposed,
                                        dtype=np.float64)
            num_voxels_in_patch = np.prod(patch_size_fullres, dtype=np.float64)

            plan_3d_lowres = None
            lowres_spacing = np.array(deepcopy(plan_3d_fullres["spacing"]))
            spacing_increase_factor = 1.03

            while (num_voxels_in_patch / median_num_voxels
                   < self.lowres_creation_threshold):
                max_spacing = max(lowres_spacing)
                if np.any((max_spacing / lowres_spacing) > 2):
                    lowres_spacing[(max_spacing / lowres_spacing) > 2] \
                        *= spacing_increase_factor
                else:
                    lowres_spacing = lowres_spacing * spacing_increase_factor
                median_num_voxels = np.prod(
                    np.array(plan_3d_fullres["spacing"]) / lowres_spacing
                    * new_median_shape_transposed, dtype=np.float64,
                )
                plan_3d_lowres = self.get_plans_for_configuration(
                    lowres_spacing,
                    [round(i) for i in np.array(plan_3d_fullres["spacing"])
                     / lowres_spacing * new_median_shape_transposed],
                    self.generate_data_identifier("3d_lowres"),
                    float(median_num_voxels * self.dataset_json["numTraining"]),
                )
                num_voxels_in_patch = np.prod(plan_3d_lowres["patch_size"],
                                              dtype=np.int64)
            if plan_3d_lowres is not None:
                plan_3d_lowres["batch_dice"] = False
                plan_3d_fullres["batch_dice"] = True
            else:
                plan_3d_fullres["batch_dice"] = False
        else:
            plan_3d_fullres = None
            plan_3d_lowres = None

        plan_2d = self.get_plans_for_configuration(
            fullres_spacing_transposed[1:], new_median_shape_transposed[1:],
            self.generate_data_identifier("2d"), approximate_n_voxels_dataset,
        )
        plan_2d["batch_dice"] = True

        median_spacing = np.median(
            self.dataset_fingerprint["spacings"], 0)[transpose_forward]
        median_shape = np.median(
            self.dataset_fingerprint["shapes_after_crop"], 0)[transpose_forward]

        maybe_mkdir_p(join(paths.nnUNet_preprocessed, self.dataset_name))
        shutil.copy(
            join(self.raw_dataset_folder, "dataset.json"),
            join(paths.nnUNet_preprocessed, self.dataset_name, "dataset.json"),
        )

        plans = {
            "dataset_name": self.dataset_name,
            "plans_name": self.plans_identifier,
            "original_median_spacing_after_transp":
                [float(i) for i in median_spacing],
            "original_median_shape_after_transp":
                [int(round(i)) for i in median_shape],
            "image_reader_writer": self.determine_reader_writer().__name__,
            "transpose_forward": [int(i) for i in transpose_forward],
            "transpose_backward": [int(i) for i in transpose_backward],
            "configurations": {"2d": plan_2d},
            "experiment_planner_used": self.__class__.__name__,
            "label_manager": "LabelManager",
            "foreground_intensity_properties_per_channel":
                self.dataset_fingerprint[
                    "foreground_intensity_properties_per_channel"],
        }
        if plan_3d_lowres is not None:
            plans["configurations"]["3d_lowres"] = plan_3d_lowres
            if plan_3d_fullres is not None:
                plans["configurations"]["3d_lowres"]["next_stage"] = \
                    "3d_cascade_fullres"
        if plan_3d_fullres is not None:
            plans["configurations"]["3d_fullres"] = plan_3d_fullres
            if plan_3d_lowres is not None:
                plans["configurations"]["3d_cascade_fullres"] = {
                    "inherits_from": "3d_fullres",
                    "previous_stage": "3d_lowres",
                }

        self.plans = plans
        self.save_plans(plans)
        return plans

    def save_plans(self, plans: dict) -> None:
        plans_file = join(paths.nnUNet_preprocessed, self.dataset_name,
                          self.plans_identifier + ".json")
        # keep pre-existing custom configurations (reference :505-517)
        if isfile(plans_file):
            old_plans = load_json(plans_file)
            old_configurations = old_plans["configurations"]
            for c in plans["configurations"].keys():
                if c in old_configurations:
                    del old_configurations[c]
            plans["configurations"].update(old_configurations)
        maybe_mkdir_p(join(paths.nnUNet_preprocessed, self.dataset_name))
        save_json(plans, plans_file, sort_keys=False)

    def generate_data_identifier(self, configuration_name: str) -> str:
        return self.plans_identifier + "_" + configuration_name
