"""Case listing of a folder of split images (``CASE_XXXX.ending``).

Copied from ``mlagg_unet_tpu/plans/fingerprint.py``: the two functions the
predictor calls. The fingerprint extractor waits for the plan/preprocess
verbs.
"""
from __future__ import annotations

from typing import List

import numpy as np

from mlagg_unet_torch.utils.helpers import join, subfiles


def get_identifiers_from_splitted_dataset_folder(folder: str, file_ending: str
                                                 ) -> List[str]:
    files = subfiles(folder, suffix=file_ending, join_path=False)
    # strip _XXXX channel suffix + ending
    crop = len(file_ending) + 5
    return sorted(np.unique([f[:-crop] for f in files]).tolist())


def create_lists_from_splitted_dataset_folder(folder: str, file_ending: str,
                                              identifiers: List[str] = None
                                              ) -> List[List[str]]:
    if identifiers is None:
        identifiers = get_identifiers_from_splitted_dataset_folder(folder, file_ending)
    files = subfiles(folder, suffix=file_ending, join_path=False)
    list_of_lists = []
    for ident in identifiers:
        list_of_lists.append(
            [join(folder, f) for f in files
             if f.startswith(ident + "_") and
             len(f) == len(ident) + 5 + len(file_ending)]
        )
    return list_of_lists
