"""Standalone benchmark evaluation scripts (DSC + NSD -> CSV).

Equivalent of the reference's evaluation suite:
abdomen_DSC_Eval.py (13-organ AbdomenMRI with per-organ NSD tolerances
:48-50), BTCV/ACDC/Endovis variants. One generic implementation
parameterized by label set + tolerances; presets below reproduce each
script.

Usage:
    python -m mlagg_unet_torch.evaluation.benchmark_eval \
        --gt_path <labels> --seg_path <predictions> --preset abdomen_mri

Copied from ``mlagg_unet_tpu/evaluation/benchmark_eval.py`` with the imports rewritten.
"""
from __future__ import annotations

import argparse
import csv
import os
from typing import Dict, List, Optional

import numpy as np

from mlagg_unet_torch.evaluation.surface_dice import (
    ABDOMEN_TOLERANCES_MM,
    compute_dice_coefficient,
    compute_surface_dice_at_tolerance,
    compute_surface_distances,
)
from mlagg_unet_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_file_ending,
)
from mlagg_unet_torch.utils.helpers import join, subfiles

PRESETS = {
    # reference abdomen_DSC_Eval.py / abdomen_NSD_Eval.py
    "abdomen_mri": {
        "labels": list(range(1, 14)),
        "tolerances": ABDOMEN_TOLERANCES_MM,
        "names": ["liver", "right_kidney", "spleen", "pancreas", "aorta",
                  "ivc", "rag", "lag", "gallbladder", "esophagus", "stomach",
                  "duodenum", "left_kidney"],
    },
    # reference BTCV eval: same 13 organs
    "btcv": {
        "labels": list(range(1, 14)),
        "tolerances": {i: 2.0 for i in range(1, 14)},
        "names": None,
    },
    # reference ACDC eval: RV, myocardium, LV
    "acdc": {
        "labels": [1, 2, 3],
        "tolerances": {1: 2.0, 2: 2.0, 3: 2.0},
        "names": ["rv", "myo", "lv"],
    },
    # reference Endovis17 instrument segmentation (binary + parts)
    "endovis": {
        "labels": [1],
        "tolerances": {1: 2.0},
        "names": ["instrument"],
    },
}


def evaluate_folder(gt_path: str, seg_path: str, labels: List[int],
                    tolerances: Optional[Dict[int, float]] = None,
                    csv_out: Optional[str] = None) -> dict:
    files = [f for f in os.listdir(seg_path)
             if not f.startswith(".") and
             os.path.isfile(join(gt_path, f))]
    files.sort()
    assert files, f"no matching files between {gt_path} and {seg_path}"
    file_ending = "." + ".".join(files[0].split(".")[1:])
    rw = determine_reader_writer_from_file_ending(file_ending)()

    rows = []
    for f in files:
        gt, props = rw.read_seg(join(gt_path, f))
        pred, _ = rw.read_seg(join(seg_path, f))
        gt, pred = gt[0], pred[0]
        spacing = props["spacing"]
        row = {"name": f}
        for l in labels:
            m_gt = gt == l
            m_pred = pred == l
            if not m_gt.any() and not m_pred.any():
                row[f"dsc_{l}"] = np.nan
                row[f"nsd_{l}"] = np.nan
                continue
            row[f"dsc_{l}"] = compute_dice_coefficient(m_gt, m_pred)
            if tolerances is not None:
                dist = compute_surface_distances(m_gt, m_pred, spacing)
                row[f"nsd_{l}"] = compute_surface_dice_at_tolerance(
                    dist, tolerances[l])
        rows.append(row)

    summary = {"cases": rows}
    for l in labels:
        summary[f"mean_dsc_{l}"] = float(np.nanmean(
            [r[f"dsc_{l}"] for r in rows]))
        if tolerances is not None:
            summary[f"mean_nsd_{l}"] = float(np.nanmean(
                [r[f"nsd_{l}"] for r in rows]))
    summary["mean_dsc"] = float(np.nanmean(
        [summary[f"mean_dsc_{l}"] for l in labels]))
    if tolerances is not None:
        summary["mean_nsd"] = float(np.nanmean(
            [summary[f"mean_nsd_{l}"] for l in labels]))

    if csv_out:
        with open(csv_out, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return summary


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--gt_path", required=True)
    p.add_argument("--seg_path", required=True)
    p.add_argument("--preset", choices=list(PRESETS), default="abdomen_mri")
    p.add_argument("--save_path", default=None)
    a = p.parse_args()
    preset = PRESETS[a.preset]
    summary = evaluate_folder(a.gt_path, a.seg_path, preset["labels"],
                              preset["tolerances"], a.save_path)
    print(f"mean DSC: {summary['mean_dsc']:.4f}")
    if "mean_nsd" in summary:
        print(f"mean NSD: {summary['mean_nsd']:.4f}")


if __name__ == "__main__":
    main()
