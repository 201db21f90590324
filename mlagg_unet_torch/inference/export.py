"""Prediction export: the inverse preprocessing pipeline
(reference: inference/export_prediction.py:11-106): resample logits to the
pre-crop shape -> logits -> segmentation (LabelManager) -> paste into the
pre-crop bbox -> inverse transpose -> write via the reader/writer.
"""
from __future__ import annotations

from typing import Optional, Union

import numpy as np

from mlagg_unet_torch.plans.label_handling import LabelManager
from mlagg_unet_torch.plans.plans_handler import ConfigurationManager, PlansManager


def convert_predicted_logits_to_segmentation_with_correct_shape(
    predicted_logits: np.ndarray,
    plans_manager: PlansManager,
    configuration_manager: ConfigurationManager,
    label_manager: LabelManager,
    properties_dict: dict,
    return_probabilities: bool = False,
):
    """predicted_logits: (c, *resampled_cropped_shape)."""
    # resample to shape-before-resampling
    spacing_transposed = [properties_dict["spacing"][i]
                          for i in plans_manager.transpose_forward]
    current_spacing = configuration_manager.spacing
    if len(current_spacing) < len(predicted_logits.shape[1:]):
        current_spacing = [spacing_transposed[0]] + list(current_spacing)
    target_shape = properties_dict["shape_after_cropping_and_before_resampling"]
    predicted_logits = configuration_manager.resampling_fn_probabilities(
        predicted_logits, target_shape, current_spacing, spacing_transposed
    )

    probabilities = label_manager.apply_inference_nonlin(predicted_logits)
    del predicted_logits
    segmentation = label_manager.convert_probabilities_to_segmentation(
        probabilities)

    # put back into pre-crop canvas
    full_seg = np.zeros(properties_dict["shape_before_cropping"],
                        dtype=segmentation.dtype)
    slicer = tuple(slice(lo, hi)
                   for lo, hi in properties_dict["bbox_used_for_cropping"])
    full_seg[slicer] = segmentation

    # inverse transpose
    full_seg = full_seg.transpose(plans_manager.transpose_backward)

    if return_probabilities:
        probabilities = label_manager.revert_cropping_on_probabilities(
            probabilities, properties_dict["bbox_used_for_cropping"],
            properties_dict["shape_before_cropping"],
        )
        probabilities = probabilities.transpose(
            [0] + [i + 1 for i in plans_manager.transpose_backward]
        )
        return full_seg, probabilities
    return full_seg


def export_prediction_from_logits(
    predicted_logits: np.ndarray,
    properties_dict: dict,
    configuration_manager: ConfigurationManager,
    plans_manager: PlansManager,
    dataset_json: dict,
    output_file_truncated: str,
    save_probabilities: bool = False,
) -> None:
    label_manager = plans_manager.get_label_manager(dataset_json)
    ret = convert_predicted_logits_to_segmentation_with_correct_shape(
        predicted_logits, plans_manager, configuration_manager, label_manager,
        properties_dict, return_probabilities=save_probabilities,
    )
    if save_probabilities:
        segmentation, probabilities = ret
        np.savez_compressed(output_file_truncated + ".npz",
                            probabilities=probabilities)
        import pickle

        with open(output_file_truncated + ".pkl", "wb") as f:
            pickle.dump(properties_dict, f)
    else:
        segmentation = ret

    rw = plans_manager.image_reader_writer_class()
    rw.write_seg(segmentation, output_file_truncated
                 + dataset_json["file_ending"], properties_dict)


def resample_and_save(
    predicted_logits: np.ndarray,
    target_shape,
    output_file: str,
    plans_manager: PlansManager,
    configuration_manager: ConfigurationManager,
    properties_dict: dict,
    dataset_json: dict,
) -> None:
    """Cascade next-stage seg export (reference export_prediction.py:74)."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    spacing_transposed = [properties_dict["spacing"][i]
                          for i in plans_manager.transpose_forward]
    current_spacing = configuration_manager.spacing
    if len(current_spacing) < len(predicted_logits.shape[1:]):
        current_spacing = [spacing_transposed[0]] + list(current_spacing)
    target_spacing = configuration_manager.spacing  # irrelevant for shape-based
    resampled = configuration_manager.resampling_fn_probabilities(
        predicted_logits, target_shape, current_spacing, target_spacing
    )
    seg = label_manager.convert_logits_to_segmentation(resampled)
    np.savez_compressed(output_file, seg=seg[None].astype(np.int8))
