"""Model export/import as zip
(reference: model_sharing/model_export.py:6, model_import.py:6).

Copied from ``mlagg_unet_tpu/postprocessing/model_sharing.py`` with the imports rewritten:
export and install. The download is left out: it needs the network.
"""
from __future__ import annotations

import os
import zipfile
from typing import Sequence

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    get_output_folder,
    isdir,
    isfile,
    join,
    maybe_convert_to_dataset_name,
)


def export_pretrained_model(
    dataset_name_or_id,
    output_file: str,
    configurations: Sequence[str] = ("2d", "3d_fullres"),
    trainer: str = "nnUNetTrainer",
    plans_identifier: str = "nnUNetPlans",
    folds: Sequence = (0, 1, 2, 3, 4),
    checkpoint_names: Sequence[str] = ("checkpoint_final.ckpt",),
    export_crossval_predictions: bool = False,
) -> None:
    dataset_name = maybe_convert_to_dataset_name(dataset_name_or_id)
    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as zf:
        for c in configurations:
            folder = get_output_folder(dataset_name, trainer,
                                       plans_identifier, c)
            if not isdir(folder):
                raise RuntimeError(f"missing trained model: {folder}")
            for root, _, files in os.walk(folder):
                for f in files:
                    full = join(root, f)
                    keep = (
                        f in ("plans.json", "dataset.json", "debug.json",
                              "progress.png", "postprocessing.pkl")
                        or f in checkpoint_names
                        or f.startswith("training_log")
                        or (export_crossval_predictions
                            and ("validation" in root
                                 or "crossval_results" in root))
                    )
                    if keep:
                        zf.write(full, os.path.relpath(
                            full, paths.nnUNet_results))
        info = join(paths.nnUNet_results, dataset_name,
                    "inference_information.json")
        if isfile(info):
            zf.write(info, os.path.relpath(info, paths.nnUNet_results))


def install_model_from_zip_file(zip_file: str) -> None:
    with zipfile.ZipFile(zip_file, "r") as zf:
        zf.extractall(paths.nnUNet_results)

