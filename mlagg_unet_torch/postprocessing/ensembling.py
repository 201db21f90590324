"""Probability ensembling (reference: ensembling/ensemble.py:17-206):
average saved probability .npz across model output folders -> segmentation
-> write.

Copied from ``mlagg_unet_tpu/postprocessing/ensembling.py`` with the imports rewritten.
"""
from __future__ import annotations

import pickle
from typing import List

import numpy as np

from mlagg_unet_torch.plans.label_handling import LabelManager
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.utils.helpers import (
    join,
    load_json,
    maybe_mkdir_p,
    subfiles,
)


def average_probabilities(list_of_files: List[str]) -> np.ndarray:
    """reference :17."""
    assert list_of_files
    avg = None
    for f in list_of_files:
        if avg is None:
            avg = np.load(f)["probabilities"].astype(np.float32)
        else:
            avg += np.load(f)["probabilities"]
    return avg / len(list_of_files)


def merge_files(list_of_npz: List[str], output_filename_truncated: str,
                plans_manager: PlansManager, label_manager: LabelManager,
                dataset_json: dict, save_merged_probabilities: bool = False):
    probabilities = average_probabilities(list_of_npz)
    seg = label_manager.convert_probabilities_to_segmentation(probabilities)
    rw = plans_manager.image_reader_writer_class()
    with open(list_of_npz[0][:-4] + ".pkl", "rb") as f:
        properties = pickle.load(f)
    rw.write_seg(seg, output_filename_truncated + dataset_json["file_ending"],
                 properties)
    if save_merged_probabilities:
        np.savez_compressed(output_filename_truncated + ".npz",
                            probabilities=probabilities)
        with open(output_filename_truncated + ".pkl", "wb") as f:
            pickle.dump(properties, f)


def ensemble_folders(list_of_input_folders: List[str], output_folder: str,
                     save_merged_probabilities: bool = False,
                     num_processes: int = 8) -> None:
    """reference :49. Every input folder must contain .npz probabilities
    (predict with --save_probabilities) + dataset.json/plans.json."""
    maybe_mkdir_p(output_folder)
    dataset_json = load_json(join(list_of_input_folders[0], "dataset.json"))
    plans_manager = PlansManager(
        load_json(join(list_of_input_folders[0], "plans.json")))
    label_manager = plans_manager.get_label_manager(dataset_json)

    npz_per_folder = [
        set(subfiles(f, suffix=".npz", join_path=False))
        for f in list_of_input_folders
    ]
    common = sorted(set.intersection(*npz_per_folder))
    assert common, "no common .npz files across input folders"

    for name in common:
        merge_files(
            [join(f, name) for f in list_of_input_folders],
            join(output_folder, name[:-4]),
            plans_manager, label_manager, dataset_json,
            save_merged_probabilities,
        )

    import shutil

    shutil.copy(join(list_of_input_folders[0], "dataset.json"),
                join(output_folder, "dataset.json"))
    shutil.copy(join(list_of_input_folders[0], "plans.json"),
                join(output_folder, "plans.json"))


def ensemble_crossvalidations(
    list_of_trained_model_folders: List[str],
    output_folder: str,
    folds=(0, 1, 2, 3, 4),
    num_processes: int = 8,
) -> None:
    """reference ensemble.py:101-170: merge per-fold validation npz of
    several models into an ensembled folder."""
    maybe_mkdir_p(output_folder)
    dataset_json = load_json(join(list_of_trained_model_folders[0],
                                  "dataset.json"))
    plans_manager = PlansManager(
        load_json(join(list_of_trained_model_folders[0], "plans.json")))
    label_manager = plans_manager.get_label_manager(dataset_json)

    import os

    # case -> one npz per model (whichever fold's validation holds it)
    per_model_cases = []
    for tr in list_of_trained_model_folders:
        cases = {}
        for f in folds:
            val = join(tr, f"fold_{f}", "validation")
            if os.path.isdir(val):
                for npz in subfiles(val, suffix=".npz", join_path=False):
                    cases[npz] = join(val, npz)
        per_model_cases.append(cases)

    common = sorted(set.intersection(*[set(c.keys())
                                       for c in per_model_cases]))
    assert common, "no common validation cases across models"
    for name in common:
        merge_files(
            [c[name] for c in per_model_cases],
            join(output_folder, name[:-4]),
            plans_manager, label_manager, dataset_json, False,
        )
    import shutil

    shutil.copy(join(list_of_trained_model_folders[0], "dataset.json"),
                join(output_folder, "dataset.json"))
    shutil.copy(join(list_of_trained_model_folders[0], "plans.json"),
                join(output_folder, "plans.json"))
