"""dataset.json generation
(reference: dataset_conversion/generate_dataset_json.py:6).

Copied from ``mlagg_unet_tpu/dataset_conversion/generate_dataset_json.py`` with the imports rewritten.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from mlagg_unet_torch.utils.helpers import join, save_json


def generate_dataset_json(
    output_folder: str,
    channel_names: Dict[Union[int, str], str],
    labels: Dict[str, Union[int, Tuple[int, ...], List[int]]],
    num_training_cases: int,
    file_ending: str,
    regions_class_order: Optional[Tuple[int, ...]] = None,
    dataset_name: Optional[str] = None,
    reference: Optional[str] = None,
    release: Optional[str] = None,
    license: Optional[str] = None,
    description: Optional[str] = None,
    overwrite_image_reader_writer: Optional[str] = None,
    **kwargs,
) -> None:
    has_regions = any(
        isinstance(v, (tuple, list)) and len(v) > 1 for v in labels.values()
    )
    if has_regions:
        assert regions_class_order is not None, (
            "region-based labels need regions_class_order"
        )
    dataset_json = {
        "channel_names": {str(k): v for k, v in channel_names.items()},
        "labels": labels,
        "numTraining": num_training_cases,
        "file_ending": file_ending,
    }
    if dataset_name is not None:
        dataset_json["name"] = dataset_name
    if reference is not None:
        dataset_json["reference"] = reference
    if release is not None:
        dataset_json["release"] = release
    if license is not None:
        dataset_json["licence"] = license
    if description is not None:
        dataset_json["description"] = description
    if overwrite_image_reader_writer is not None:
        dataset_json["overwrite_image_reader_writer"] = \
            overwrite_image_reader_writer
    if regions_class_order is not None:
        dataset_json["regions_class_order"] = list(regions_class_order)
    dataset_json.update(kwargs)
    save_json(dataset_json, join(output_folder, "dataset.json"),
              sort_keys=False)
