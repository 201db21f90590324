"""Segmentation metrics + folder evaluation
(reference: evaluation/evaluate_predictions.py:34-264).

Per-case Dice/IoU/TP/FP/FN/TN per label-or-region with ignore-mask support;
folder-level aggregation into summary.json (means + foreground_mean).

Copied from ``mlagg_unet_tpu/evaluation/metrics.py`` with the imports
rewritten.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import List, Tuple, Union

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter
from mlagg_unet_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_file_ending,
)
from mlagg_unet_torch.plans.label_handling import LabelManager
from mlagg_unet_torch.utils.helpers import (
    isfile,
    join,
    load_json,
    save_json,
    subfiles,
)


def label_or_region_to_mask(segmentation: np.ndarray,
                            label_or_region) -> np.ndarray:
    if np.isscalar(label_or_region):
        return segmentation == label_or_region
    mask = np.zeros_like(segmentation, dtype=bool)
    for l in label_or_region:
        mask |= segmentation == l
    return mask


def compute_tp_fp_fn_tn(mask_ref: np.ndarray, mask_pred: np.ndarray,
                        ignore_mask: np.ndarray = None):
    use = ~ignore_mask if ignore_mask is not None else None
    if use is None:
        tp = int(np.sum(mask_ref & mask_pred))
        fp = int(np.sum(~mask_ref & mask_pred))
        fn = int(np.sum(mask_ref & ~mask_pred))
        tn = int(np.sum(~mask_ref & ~mask_pred))
    else:
        tp = int(np.sum(mask_ref & mask_pred & use))
        fp = int(np.sum(~mask_ref & mask_pred & use))
        fn = int(np.sum(mask_ref & ~mask_pred & use))
        tn = int(np.sum(~mask_ref & ~mask_pred & use))
    return tp, fp, fn, tn


def compute_metrics(reference_file: str, prediction_file: str,
                    image_reader_writer: BaseReaderWriter,
                    labels_or_regions, ignore_label: int = None) -> dict:
    seg_ref, _ = image_reader_writer.read_seg(reference_file)
    seg_pred, _ = image_reader_writer.read_seg(prediction_file)

    ignore_mask = (seg_ref == ignore_label) if ignore_label is not None else None

    results = {"reference_file": reference_file,
               "prediction_file": prediction_file, "metrics": {}}
    for r in labels_or_regions:
        key = str(r) if isinstance(r, (tuple, list)) else r
        mask_ref = label_or_region_to_mask(seg_ref, r)
        mask_pred = label_or_region_to_mask(seg_pred, r)
        tp, fp, fn, tn = compute_tp_fp_fn_tn(mask_ref, mask_pred, ignore_mask)
        m = {}
        if tp + fp + fn == 0:
            m["Dice"] = np.nan
            m["IoU"] = np.nan
        else:
            m["Dice"] = 2 * tp / (2 * tp + fp + fn)
            m["IoU"] = tp / (tp + fp + fn)
        m.update({"FP": fp, "TP": tp, "FN": fn, "TN": tn,
                  "n_pred": fp + tp, "n_ref": fn + tp})
        results["metrics"][key] = m
    return results


def compute_metrics_on_folder(
    folder_ref: str,
    folder_pred: str,
    output_file: Union[str, None],
    image_reader_writer: BaseReaderWriter,
    file_ending: str,
    labels_or_regions,
    ignore_label: int = None,
    num_processes: int = 8,
    chill: bool = True,
) -> dict:
    files_pred = subfiles(folder_pred, suffix=file_ending, join_path=False)
    files_ref = subfiles(folder_ref, suffix=file_ending, join_path=False)
    if not chill:
        present = [isfile(join(folder_pred, i)) for i in files_ref]
        assert all(present), "not all reference files have predictions"
    files_ref = [f for f in files_ref if f in files_pred]

    results = [
        compute_metrics(join(folder_ref, f), join(folder_pred, f),
                        image_reader_writer, labels_or_regions, ignore_label)
        for f in files_ref
    ]

    metric_list = list(results[0]["metrics"]
                       [list(results[0]["metrics"].keys())[0]].keys())
    means = {}
    for r in labels_or_regions:
        key = str(r) if isinstance(r, (tuple, list)) else r
        means[key] = {
            m: float(np.nanmean([rr["metrics"][key][m] for rr in results]))
            for m in metric_list
        }
    foreground_mean = {
        m: float(np.mean([means[k][m] for k in means
                          if k != 0 and k != "0"]))
        for m in metric_list
    }

    result = {"metric_per_case": results, "mean": means,
              "foreground_mean": foreground_mean}
    if output_file is not None:
        save_json(result, output_file)
    return result


def compute_metrics_on_folder_simple(
    folder_ref: str, folder_pred: str, labels: List[int],
    output_file: str = None, num_processes: int = 8,
    ignore_label: int = None,
) -> dict:
    example = subfiles(folder_ref, join_path=False)[0]
    file_ending = "." + ".".join(example.split(".")[1:])
    rw = determine_reader_writer_from_file_ending(file_ending)()
    return compute_metrics_on_folder(
        folder_ref, folder_pred, output_file, rw, file_ending,
        [l for l in labels if l != 0], ignore_label, num_processes,
    )
