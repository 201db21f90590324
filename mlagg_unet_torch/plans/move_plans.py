"""Transfer a plans file from one dataset to another (for pretraining →
finetuning workflows).

reference: mlagg/nnunetv2/experiment_planning/plans_for_pretraining/
move_plans_between_datasets.py:11-55. The target dataset reuses the source
dataset's patch sizes/architecture so pretrained weights stay compatible;
only the dataset name, data identifiers, and the reader/writer (re-derived
from the target's raw data) change.

Copied from ``mlagg_unet_tpu/plans/move_plans.py`` with the imports rewritten.
"""
from __future__ import annotations

from typing import Optional, Union

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    isdir,
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    save_json,
    subfiles,
)


def move_plans_between_datasets(
    source_dataset_name_or_id: Union[int, str],
    target_dataset_name_or_id: Union[int, str],
    source_plans_identifier: str,
    target_plans_identifier: Optional[str] = None,
) -> str:
    """Returns the path of the written target plans file."""
    source_name = maybe_convert_to_dataset_name(source_dataset_name_or_id)
    target_name = maybe_convert_to_dataset_name(target_dataset_name_or_id)
    if target_plans_identifier is None:
        target_plans_identifier = source_plans_identifier

    source_folder = join(paths.nnUNet_preprocessed, source_name)
    if not isdir(source_folder):
        raise RuntimeError(
            f"Preprocessed directory of source dataset missing: "
            f"{source_folder}. Run plan_and_preprocess for it first.")
    source_plans_file = join(source_folder, source_plans_identifier + ".json")
    if not isfile(source_plans_file):
        raise RuntimeError(f"Source plans missing: {source_plans_file}")

    plans = load_json(source_plans_file)
    plans["dataset_name"] = target_name

    if target_plans_identifier != source_plans_identifier:
        for cfg in plans["configurations"].values():
            old = cfg.get("data_identifier")
            if old is None:
                continue
            if old.startswith(source_plans_identifier):
                cfg["data_identifier"] = (target_plans_identifier
                                          + old[len(source_plans_identifier):])
            else:
                cfg["data_identifier"] = target_plans_identifier + "_" + old

    # re-derive the reader/writer from the target's raw data
    target_raw = join(paths.nnUNet_raw, target_name)
    target_dsj = load_json(join(target_raw, "dataset.json"))
    from mlagg_unet_torch.imageio.reader_writer_registry import (
        determine_reader_writer_from_dataset_json,
    )

    imgs = subfiles(join(target_raw, "imagesTr"),
                    suffix=target_dsj["file_ending"])
    some_file = imgs[0] if imgs else None
    rw = determine_reader_writer_from_dataset_json(target_dsj, some_file)
    plans["image_reader_writer"] = rw.__name__

    out = join(paths.nnUNet_preprocessed, target_name,
               target_plans_identifier + ".json")
    save_json(plans, out, sort_keys=False)
    return out
