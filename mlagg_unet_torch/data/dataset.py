"""Lazy preprocessed-case dataset
(reference: training/dataloading/nnunet_dataset.py:11-146 + utils.py:26-53).

Case registry over the preprocessed folder; load_case prefers unpacked .npy
memmaps over .npz; unpack_dataset decompresses ahead of training. Artifact
layout identical to the reference (.npz: data/seg; .pkl: properties).

Copied from ``mlagg_unet_tpu/data/dataset.py`` with the imports rewritten.
"""
from __future__ import annotations

import multiprocessing
import os
from typing import List, Tuple, Union

import numpy as np

from mlagg_unet_torch.utils.helpers import (
    isfile,
    join,
    load_pickle,
    subfiles,
)


def get_case_identifiers(folder: str) -> List[str]:
    return sorted(
        f[:-4] for f in os.listdir(folder)
        if f.endswith(".npz") and f.find("segFromPrevStage") == -1
    )


def get_case_identifiers_from_raw(raw_dataset_folder: str, dataset_json: dict
                                  ) -> List[str]:
    from mlagg_unet_torch.plans.fingerprint import (
        get_identifiers_from_splitted_dataset_folder,
    )

    return get_identifiers_from_splitted_dataset_folder(
        join(raw_dataset_folder, "imagesTr"), dataset_json["file_ending"]
    )


def _unpack_case(npz_file: str, unpack_segmentation: bool, overwrite: bool):
    a = np.load(npz_file)
    base = npz_file[:-4]
    if overwrite or not isfile(base + ".npy"):
        np.save(base + ".npy", np.ascontiguousarray(a["data"]))
    if unpack_segmentation and (overwrite or not isfile(base + "_seg.npy")):
        np.save(base + "_seg.npy", np.ascontiguousarray(a["seg"]))


def unpack_dataset(folder: str, unpack_segmentation: bool = True,
                   overwrite_existing: bool = False, num_processes: int = 4):
    """Threads, not processes: numpy (de)compression releases the GIL, and
    spawn would re-import user scripts (breaking ones without a
    __main__ guard) while fork after CUDA's initialisation is unsafe."""
    from concurrent.futures import ThreadPoolExecutor

    npz_files = subfiles(folder, suffix=".npz")
    if num_processes <= 1 or len(npz_files) <= 1:
        for f in npz_files:
            _unpack_case(f, unpack_segmentation, overwrite_existing)
        return
    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        list(pool.map(
            lambda f: _unpack_case(f, unpack_segmentation,
                                   overwrite_existing),
            npz_files,
        ))


class nnUNetDataset:
    def __init__(self, folder: str, case_identifiers: List[str] = None,
                 folder_with_segs_from_previous_stage: str = None):
        if case_identifiers is None:
            case_identifiers = get_case_identifiers(folder)
        case_identifiers.sort()
        self.dataset = {}
        for c in case_identifiers:
            self.dataset[c] = {
                "data_file": join(folder, f"{c}.npz"),
                "properties_file": join(folder, f"{c}.pkl"),
            }
            if folder_with_segs_from_previous_stage is not None:
                self.dataset[c]["seg_from_prev_stage_file"] = join(
                    folder_with_segs_from_previous_stage, f"{c}.npz"
                )

    def __getitem__(self, key: str) -> dict:
        entry = dict(self.dataset[key])
        if "properties" not in entry:
            entry["properties"] = load_pickle(entry["properties_file"])
        return entry

    def keys(self):
        return self.dataset.keys()

    def __len__(self):
        return len(self.dataset)

    def items(self):
        return self.dataset.items()

    def load_case(self, key: str) -> Tuple[np.ndarray, np.ndarray, dict]:
        entry = self[key]
        data_npy = entry["data_file"][:-4] + ".npy"
        if isfile(data_npy):
            data = np.load(data_npy, "r")
        else:
            data = np.load(entry["data_file"])["data"]

        seg_npy = entry["data_file"][:-4] + "_seg.npy"
        if isfile(seg_npy):
            seg = np.load(seg_npy, "r")
        else:
            seg = np.load(entry["data_file"])["seg"]

        if "seg_from_prev_stage_file" in entry:
            prev_npy = entry["seg_from_prev_stage_file"][:-4] + ".npy"
            if isfile(prev_npy):
                seg_prev = np.load(prev_npy, "r")
            else:
                seg_prev = np.load(entry["seg_from_prev_stage_file"])["seg"]
            seg = np.vstack((seg[None] if seg.ndim == 3 else seg,
                             seg_prev[None] if seg_prev.ndim == 3 else seg_prev))

        return data, seg, entry["properties"]
