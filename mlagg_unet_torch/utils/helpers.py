"""Small shared utilities (reference: mlagg/nnunetv2/utilities/helpers.py,
json_export.py, file_path_utilities.py, dataset_name_id_conversion.py).

Copied from ``mlagg_unet_tpu/utils/helpers.py``: the file, JSON, pickle,
dataset-name and output-folder helpers the verbs call."""
from __future__ import annotations

import json
import os
import re
from typing import Any, List, Union

import numpy as np


# ---------------------------------------------------------------------------
# file/folder ops (replaces batchgenerators.utilities.file_and_folder_operations)
# ---------------------------------------------------------------------------

def join(*args: str) -> str:
    return os.path.join(*args)


def isfile(p: str) -> bool:
    return os.path.isfile(p)


def isdir(p: str) -> bool:
    return os.path.isdir(p)


def maybe_mkdir_p(d: str) -> None:
    os.makedirs(d, exist_ok=True)


def subfiles(folder: str, prefix: str = None, suffix: str = None, join_path: bool = True,
             sort: bool = True) -> List[str]:
    res = [
        f for f in os.listdir(folder)
        if os.path.isfile(os.path.join(folder, f))
        and (prefix is None or f.startswith(prefix))
        and (suffix is None or f.endswith(suffix))
    ]
    if sort:
        res.sort()
    if join_path:
        res = [os.path.join(folder, f) for f in res]
    return res


def subdirs(folder: str, prefix: str = None, suffix: str = None, join_path: bool = True,
            sort: bool = True) -> List[str]:
    res = [
        f for f in os.listdir(folder)
        if os.path.isdir(os.path.join(folder, f))
        and (prefix is None or f.startswith(prefix))
        and (suffix is None or f.endswith(suffix))
    ]
    if sort:
        res.sort()
    if join_path:
        res = [os.path.join(folder, f) for f in res]
    return res


def _json_sanitize(obj: Any) -> Any:
    """Recursively convert numpy types to JSON-serializable python types
    (reference: utilities/json_export.py)."""
    if isinstance(obj, dict):
        return {_json_sanitize_key(k): _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_sanitize(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_sanitize(obj.tolist())
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.bool_,)):
        return bool(obj)
    return obj


def _json_sanitize_key(k: Any) -> Any:
    if isinstance(k, (np.integer, int)) and not isinstance(k, bool):
        return int(k)
    if isinstance(k, tuple):
        return str(k)
    return k


def save_json(obj: Any, path: str, sort_keys: bool = True, indent: int = 4) -> None:
    with open(path, "w") as f:
        json.dump(_json_sanitize(obj), f, sort_keys=sort_keys, indent=indent)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def write_pickle(obj: Any, path: str) -> None:
    import pickle
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------------------
# dataset name/id conversion (reference: utilities/dataset_name_id_conversion.py)
# ---------------------------------------------------------------------------

def convert_id_to_dataset_name(dataset_id: Union[int, str]) -> str:
    if isinstance(dataset_id, str) and not dataset_id.isdigit():
        assert dataset_id.startswith("Dataset"), (
            f"dataset name must look like DatasetXXX_Name, got {dataset_id}"
        )
        return dataset_id
    dataset_id = int(dataset_id)
    from mlagg_unet_torch import paths

    candidates = []
    for root in (paths.nnUNet_raw, paths.nnUNet_preprocessed, paths.nnUNet_results):
        if root is not None and isdir(root):
            candidates += subdirs(root, prefix=f"Dataset{dataset_id:03d}", join_path=False)
    candidates = np.unique(candidates)
    if len(candidates) == 0:
        raise RuntimeError(
            f"Could not find dataset with id {dataset_id} in raw/preprocessed/results folders"
        )
    if len(candidates) > 1:
        raise RuntimeError(f"More than one dataset matches id {dataset_id}: {candidates}")
    return str(candidates[0])


def maybe_convert_to_dataset_name(dataset_name_or_id: Union[int, str]) -> str:
    return convert_id_to_dataset_name(dataset_name_or_id)


def extract_dataset_id(dataset_name: str) -> int:
    m = re.match(r"Dataset(\d+)_", dataset_name)
    if m is None:
        raise ValueError(f"not a valid dataset name: {dataset_name}")
    return int(m.group(1))


# ---------------------------------------------------------------------------
# output folder naming (reference: utilities/file_path_utilities.py:19)
# ---------------------------------------------------------------------------

def get_output_folder(dataset_name: str, trainer_name: str, plans_identifier: str,
                      configuration: str, fold: Union[int, str, None] = None) -> str:
    from mlagg_unet_torch import paths

    folder = join(paths.nnUNet_results, dataset_name,
                  f"{trainer_name}__{plans_identifier}__{configuration}")
    if fold is not None:
        folder = join(folder, f"fold_{fold}")
    return folder
