"""Cross-validation accumulation + best-configuration selection
(reference: evaluation/accumulate_cv_results.py:12,
find_best_configuration.py:81-333).

Scores every trained (trainer, plans, configuration) combo and every 2-model
ensemble on the merged 5-fold cross-validation, picks the best by mean
foreground Dice, determines postprocessing, and writes
inference_information.json + human-readable instructions.

Copied from ``mlagg_unet_tpu/postprocessing/find_best_configuration.py`` with the imports
rewritten.
"""
from __future__ import annotations

import os
import shutil
from itertools import combinations
from typing import List, Tuple

from mlagg_unet_torch import paths
from mlagg_unet_torch.evaluation.metrics import compute_metrics_on_folder
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.postprocessing.ensembling import ensemble_crossvalidations
from mlagg_unet_torch.postprocessing.remove_connected_components import (
    determine_postprocessing,
)
from mlagg_unet_torch.utils.helpers import (
    get_output_folder,
    isdir,
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
    maybe_mkdir_p,
    save_json,
    subfiles,
)

default_trained_models = (
    {"plans": "nnUNetPlans", "configuration": "2d", "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_fullres",
     "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_lowres",
     "trainer": "nnUNetTrainer"},
    {"plans": "nnUNetPlans", "configuration": "3d_cascade_fullres",
     "trainer": "nnUNetTrainer"},
)


def dumb_trainer_config_plans_to_trained_models_dict(trainers: List[str],
                                                     configs: List[str],
                                                     plans: List[str]):
    """reference find_best_configuration.py:257."""
    return [
        {"plans": pl, "configuration": c, "trainer": tr}
        for tr in trainers for c in configs for pl in plans
    ]


def accumulate_cv_results(
    trained_model_folder: str,
    merged_output_folder: str,
    folds: Tuple[int, ...] = (0, 1, 2, 3, 4),
    num_processes: int = 8,
    overwrite: bool = True,
) -> None:
    """Merge the folds' validation predictions + re-evaluate
    (reference accumulate_cv_results.py:12)."""
    if overwrite and isdir(merged_output_folder):
        shutil.rmtree(merged_output_folder)
    maybe_mkdir_p(merged_output_folder)

    dataset_json = load_json(join(trained_model_folder, "dataset.json"))
    plans_manager = PlansManager(
        load_json(join(trained_model_folder, "plans.json")))
    file_ending = dataset_json["file_ending"]

    for f in folds:
        val_folder = join(trained_model_folder, f"fold_{f}", "validation")
        assert isdir(val_folder), (
            f"missing validation folder for fold {f}: run training with "
            f"final validation first ({val_folder})"
        )
        for seg in subfiles(val_folder, suffix=file_ending, join_path=False):
            shutil.copy(join(val_folder, seg),
                        join(merged_output_folder, seg))

    shutil.copy(join(trained_model_folder, "dataset.json"),
                join(merged_output_folder, "dataset.json"))
    shutil.copy(join(trained_model_folder, "plans.json"),
                join(merged_output_folder, "plans.json"))

    label_manager = plans_manager.get_label_manager(dataset_json)
    gt_folder = join(paths.nnUNet_preprocessed, plans_manager.dataset_name,
                     "gt_segmentations")
    if not isdir(gt_folder):
        gt_folder = join(paths.nnUNet_raw, plans_manager.dataset_name,
                         "labelsTr")
    rw = plans_manager.image_reader_writer_class()
    compute_metrics_on_folder(
        gt_folder, merged_output_folder,
        join(merged_output_folder, "summary.json"), rw, file_ending,
        label_manager.foreground_regions if label_manager.has_regions
        else label_manager.foreground_labels,
        label_manager.ignore_label, num_processes,
    )


def folds_tuple_to_string(folds) -> str:
    return "_".join(str(f) for f in folds)


def find_best_configuration(
    dataset_name_or_id,
    trained_models=default_trained_models,
    allow_ensembling: bool = True,
    num_processes: int = 8,
    overwrite: bool = True,
    folds: Tuple[int, ...] = (0, 1, 2, 3, 4),
) -> dict:
    """reference find_best_configuration.py:81-255."""
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    all_results = {}

    trained_models = [
        m for m in trained_models
        if isdir(get_output_folder(dataset_name, m["trainer"], m["plans"],
                                   m["configuration"]))
    ]
    assert trained_models, "no trained models found"

    for m in trained_models:
        output_folder = get_output_folder(dataset_name, m["trainer"],
                                          m["plans"], m["configuration"])
        identifier = os.path.basename(output_folder)
        merged_output_folder = join(
            output_folder, f"crossval_results_folds_{folds_tuple_to_string(folds)}"
        )
        if overwrite or not isfile(join(merged_output_folder, "summary.json")):
            accumulate_cv_results(output_folder, merged_output_folder, folds,
                                  num_processes, overwrite)
        summary = load_json(join(merged_output_folder, "summary.json"))
        all_results[identifier] = {
            "source": "crossval", "models": [m],
            "folder": merged_output_folder,
            "mean_fg_dice": summary["foreground_mean"]["Dice"],
        }

    if allow_ensembling and len(trained_models) > 1:
        for m1, m2 in combinations(trained_models, 2):
            f1 = get_output_folder(dataset_name, m1["trainer"], m1["plans"],
                                   m1["configuration"])
            f2 = get_output_folder(dataset_name, m2["trainer"], m2["plans"],
                                   m2["configuration"])
            identifier = ("ensemble___" + os.path.basename(f1) + "___"
                          + os.path.basename(f2) + "___"
                          + folds_tuple_to_string(folds))
            output_folder = join(paths.nnUNet_results, dataset_name,
                                 "ensembles", identifier)
            try:
                ensemble_crossvalidations([f1, f2], output_folder, folds,
                                          num_processes)
            except AssertionError as e:
                # models trained without --npz have no probabilities
                print(f"skipping ensemble {identifier}: {e}")
                continue
            dataset_json = load_json(join(output_folder, "dataset.json"))
            plans_manager = PlansManager(
                load_json(join(output_folder, "plans.json")))
            label_manager = plans_manager.get_label_manager(dataset_json)
            gt_folder = join(paths.nnUNet_preprocessed, dataset_name,
                             "gt_segmentations")
            if not isdir(gt_folder):
                gt_folder = join(paths.nnUNet_raw, dataset_name, "labelsTr")
            rw = plans_manager.image_reader_writer_class()
            summary = compute_metrics_on_folder(
                gt_folder, output_folder,
                join(output_folder, "summary.json"), rw,
                dataset_json["file_ending"],
                label_manager.foreground_regions if label_manager.has_regions
                else label_manager.foreground_labels,
                label_manager.ignore_label, num_processes,
            )
            all_results[identifier] = {
                "source": "ensemble", "models": [m1, m2],
                "folder": output_folder,
                "mean_fg_dice": summary["foreground_mean"]["Dice"],
            }

    best_score = -1e9
    best_key = None
    for k, v in all_results.items():
        if v["mean_fg_dice"] > best_score:
            best_score = v["mean_fg_dice"]
            best_key = k
    best = all_results[best_key]

    print("***All results:***")
    for k, v in all_results.items():
        print(f"{k}: {v['mean_fg_dice']}")
    print(f"\n*Best*: {best_key}: {best_score}")

    # postprocessing on the best
    gt_folder = join(paths.nnUNet_preprocessed, dataset_name,
                     "gt_segmentations")
    if not isdir(gt_folder):
        gt_folder = join(paths.nnUNet_raw, dataset_name, "labelsTr")
    pp_fns, pp_kwargs = determine_postprocessing(
        best["folder"], gt_folder,
        join(best["folder"], "plans.json"),
        join(best["folder"], "dataset.json"),
        num_processes, keep_postprocessed_files=True,
    )

    info = {
        "folds": list(folds),
        "dataset_name_or_id": dataset_name_or_id,
        "considered_models": [dict(m) for m in trained_models],
        "ensembling_allowed": allow_ensembling,
        "all_results": {k: {"mean_fg_dice": v["mean_fg_dice"],
                            "source": v["source"]}
                        for k, v in all_results.items()},
        "best_model_or_ensemble": {
            "identifier": best_key,
            "selected_model_or_models": [dict(m) for m in best["models"]],
            "mean_fg_dice": best["mean_fg_dice"],
            "postprocessing_file": join(best["folder"], "postprocessing.pkl"),
            "some_plans_file": join(best["folder"], "plans.json")
            if isfile(join(best["folder"], "plans.json"))
            else join(paths.nnUNet_preprocessed, dataset_name,
                      "nnUNetPlans.json"),
        },
    }
    save_json(info, join(paths.nnUNet_results, dataset_name,
                         "inference_information.json"))
    return info
