"""Batch-run command generation
(reference: batch_running/ — DKFZ LSF bsub generators + result collectors,
generate_benchmarking_commands.py:1-41, summarize_benchmark_results.py).

Cluster-agnostic equivalent: emits shell command lines (optionally wrapped
in a user-supplied submit template) for dataset x configuration x fold
sweeps, plus a benchmark-result collector that merges the per-run
benchmark_result.json files into one CSV.

Copied from ``mlagg_unet_tpu/utils/batch_running.py`` with the imports rewritten and the
port's ``mlaggtorch_train`` in the commands.
"""
from __future__ import annotations

import csv
import os
from typing import List, Optional, Sequence

from mlagg_unet_torch import paths
from mlagg_unet_torch.utils.helpers import (
    get_output_folder,
    isfile,
    join,
    load_json,
    maybe_convert_to_dataset_name,
)


def generate_train_commands(
    datasets: Sequence,
    configurations: Sequence[str] = ("2d", "3d_fullres"),
    folds: Sequence = (0, 1, 2, 3, 4),
    trainer: str = "nnUNetTrainer",
    plans: str = "nnUNetPlans",
    submit_template: Optional[str] = None,
) -> List[str]:
    """submit_template e.g. 'sbatch --gres=gpu:1 --wrap \"{cmd}\"'."""
    commands = []
    for d in datasets:
        for c in configurations:
            for f in folds:
                cmd = (f"mlaggtorch_train {d} {c} {f} -tr {trainer} -p {plans}")
                if submit_template:
                    cmd = submit_template.format(cmd=cmd)
                commands.append(cmd)
    return commands


def generate_benchmarking_commands(
    datasets: Sequence,
    configurations: Sequence[str] = ("2d", "3d_fullres"),
    fold: int = 0,
    trainers: Sequence[str] = ("nnUNetTrainerBenchmark_5epochs",
                               "nnUNetTrainerBenchmark_5epochs_noDataLoading"),
    submit_template: Optional[str] = None,
) -> List[str]:
    """reference benchmarking/generate_benchmarking_commands.py:1-41."""
    commands = []
    for d in datasets:
        for c in configurations:
            for tr in trainers:
                cmd = f"mlaggtorch_train {d} {c} {fold} -tr {tr}"
                if submit_template:
                    cmd = submit_template.format(cmd=cmd)
                commands.append(cmd)
    return commands


def summarize_benchmark_results(
    datasets: Sequence,
    output_csv: str,
    configurations: Sequence[str] = ("2d", "3d_fullres"),
    trainers: Sequence[str] = ("nnUNetTrainerBenchmark_5epochs",
                               "nnUNetTrainerBenchmark_5epochs_noDataLoading"),
    fold: int = 0,
) -> List[dict]:
    """Collect benchmark_result.json files into one CSV
    (reference benchmarking/summarize_benchmark_results.py)."""
    rows = []
    for d in datasets:
        dataset_name = maybe_convert_to_dataset_name(d)
        for c in configurations:
            for tr in trainers:
                f = join(get_output_folder(dataset_name, tr, "nnUNetPlans",
                                           c, fold),
                         "benchmark_result.json")
                if not isfile(f):
                    continue
                for key, res in load_json(f).items():
                    rows.append({
                        "dataset": dataset_name, "configuration": c,
                        "trainer": tr, "device_key": key,
                        "fastest_epoch_s": res["fastest_epoch"],
                        "num_devices": res.get("num_devices", 1),
                    })
    if rows:
        with open(output_csv, "w", newline="") as fh:
            writer = csv.DictWriter(fh, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    return rows
