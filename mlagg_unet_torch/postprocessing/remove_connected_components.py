"""Connected-component postprocessing
(reference: postprocessing/remove_connected_components.py:22-362).

Candidate op: remove-all-but-largest-component, tried first on the joined
foreground, then per class/region; kept iff the mean Dice does not drop.
The decision is saved as a pkl of (fn names + kwargs) with an
apply-to-folder entry point — same artifact contract as the reference.

Copied from ``mlagg_unet_tpu/postprocessing/remove_connected_components.py`` with the
imports rewritten. ``postprocessing.pkl`` holds function names, so a file the
JAX package wrote applies here with no JAX import.
"""
from __future__ import annotations

import pickle
import shutil
from typing import Callable, List, Tuple, Union

import numpy as np
from scipy.ndimage import label as cc_label

from mlagg_unet_torch.evaluation.metrics import (
    compute_metrics_on_folder,
    label_or_region_to_mask,
)
from mlagg_unet_torch.plans.plans_handler import PlansManager
from mlagg_unet_torch.utils.helpers import (
    join,
    load_json,
    maybe_mkdir_p,
    save_json,
    subfiles,
)


def remove_all_but_largest_component(binary_mask: np.ndarray) -> np.ndarray:
    labeled, n = cc_label(binary_mask)
    if n <= 1:
        return binary_mask
    sizes = np.bincount(labeled.ravel())
    sizes[0] = 0
    return labeled == np.argmax(sizes)


def remove_all_but_largest_component_from_segmentation(
    segmentation: np.ndarray,
    labels_or_regions: Union[int, Tuple[int, ...],
                             List[Union[int, Tuple[int, ...]]]],
    background_label: int = 0,
) -> np.ndarray:
    """reference :22-37."""
    mask = np.zeros_like(segmentation, dtype=bool)
    if not isinstance(labels_or_regions, list):
        labels_or_regions = [labels_or_regions]
    for l_or_r in labels_or_regions:
        mask |= label_or_region_to_mask(segmentation, l_or_r)
    mask_keep = remove_all_but_largest_component(mask)
    ret = np.copy(segmentation)
    ret[mask & ~mask_keep] = background_label
    return ret


def determine_postprocessing(
    folder_predictions: str,
    folder_ref: str,
    plans_file_or_dict,
    dataset_json_file_or_dict,
    num_processes: int = 8,
    keep_postprocessed_files: bool = True,
) -> Tuple[List[Callable], List[dict]]:
    """reference :53-~300. Returns (fns, kwargs) and writes
    postprocessing.pkl + postprocessed files next to folder_predictions."""
    plans = plans_file_or_dict if isinstance(plans_file_or_dict, dict) \
        else load_json(plans_file_or_dict)
    dataset_json = dataset_json_file_or_dict \
        if isinstance(dataset_json_file_or_dict, dict) \
        else load_json(dataset_json_file_or_dict)

    plans_manager = PlansManager(plans)
    label_manager = plans_manager.get_label_manager(dataset_json)
    rw = plans_manager.image_reader_writer_class()
    file_ending = dataset_json["file_ending"]
    labels_or_regions = (label_manager.foreground_regions
                         if label_manager.has_regions
                         else label_manager.foreground_labels)

    baseline = compute_metrics_on_folder(
        folder_ref, folder_predictions, None, rw, file_ending,
        labels_or_regions, label_manager.ignore_label, num_processes,
    )
    input_metrics = baseline

    pp_fns, pp_fn_kwargs = [], []
    source = folder_predictions
    temp = folder_predictions + "_postprocessed"
    maybe_mkdir_p(temp)

    # candidate 1: largest component over the JOINED foreground
    joined = ([tuple(set(
        l for r in label_manager.foreground_regions for l in
        (r if isinstance(r, (tuple, list)) else (r,))))]
        if label_manager.has_regions
        else [tuple(label_manager.foreground_labels)])

    def apply_to_folder(src, dst, fns, kwargs_list):
        maybe_mkdir_p(dst)
        for f in subfiles(src, suffix=file_ending, join_path=False):
            seg, props = rw.read_seg(join(src, f))
            seg = seg[0]
            for fn, kw in zip(fns, kwargs_list):
                seg = fn(seg, **kw)
            rw.write_seg(seg, join(dst, f), props)

    candidate_kwargs = {"labels_or_regions": joined[0]}
    apply_to_folder(source, temp,
                    [remove_all_but_largest_component_from_segmentation],
                    [candidate_kwargs])
    pp_metrics = compute_metrics_on_folder(
        folder_ref, temp, None, rw, file_ending, labels_or_regions,
        label_manager.ignore_label, num_processes,
    )
    if pp_metrics["foreground_mean"]["Dice"] >= \
            baseline["foreground_mean"]["Dice"]:
        pp_fns.append(remove_all_but_largest_component_from_segmentation)
        pp_fn_kwargs.append(candidate_kwargs)
        baseline = pp_metrics
        source = temp

    # candidate 2: per class/region
    per_class_kwargs = {"labels_or_regions": list(labels_or_regions)}
    temp2 = folder_predictions + "_postprocessed2"
    apply_to_folder(source, temp2,
                    [remove_all_but_largest_component_from_segmentation],
                    [per_class_kwargs])
    pp_metrics2 = compute_metrics_on_folder(
        folder_ref, temp2, None, rw, file_ending, labels_or_regions,
        label_manager.ignore_label, num_processes,
    )
    if pp_metrics2["foreground_mean"]["Dice"] > \
            baseline["foreground_mean"]["Dice"]:
        pp_fns.append(remove_all_but_largest_component_from_segmentation)
        pp_fn_kwargs.append(per_class_kwargs)
        baseline = pp_metrics2
        source = temp2

    with open(join(folder_predictions, "postprocessing.pkl"), "wb") as f:
        pickle.dump({
            "fn_names": [fn.__name__ for fn in pp_fns],
            "kwargs": pp_fn_kwargs,
        }, f)

    # human-readable summary (reference :225-239 postprocessing.json)
    def _jsonable_mean(summary):
        return {str(k): v for k, v in summary["mean"].items()}

    save_json({
        "input_folder": {"foreground_mean": input_metrics["foreground_mean"],
                         "mean": _jsonable_mean(input_metrics)},
        "postprocessed": {"foreground_mean": baseline["foreground_mean"],
                          "mean": _jsonable_mean(baseline)},
        "postprocessing_fns": [fn.__name__ for fn in pp_fns],
        "postprocessing_kwargs": [
            {k: list(v) if isinstance(v, tuple) else v
             for k, v in kw.items()} for kw in pp_fn_kwargs],
    }, join(folder_predictions, "postprocessing.json"), sort_keys=False)

    final = folder_predictions + "_postprocessed"
    if source != final:
        if source == folder_predictions:
            apply_to_folder(source, final, [], [])
        else:
            for f in subfiles(source, join_path=False):
                shutil.copy(join(source, f), join(final, f))
    if not keep_postprocessed_files:
        shutil.rmtree(final, ignore_errors=True)
    shutil.rmtree(folder_predictions + "_postprocessed2", ignore_errors=True)
    return pp_fns, pp_fn_kwargs


_PP_FNS = {
    "remove_all_but_largest_component_from_segmentation":
        remove_all_but_largest_component_from_segmentation,
}


def apply_postprocessing_to_folder(
    input_folder: str,
    output_folder: str,
    pp_pkl_file: str,
    plans_json: str = None,
    dataset_json: str = None,
    num_processes: int = 8,
) -> None:
    """reference :37-52."""
    with open(pp_pkl_file, "rb") as f:
        pp = pickle.load(f)
    fns = [_PP_FNS[n] for n in pp["fn_names"]]
    kwargs_list = pp["kwargs"]

    from mlagg_unet_torch.imageio.reader_writer_registry import (
        determine_reader_writer_from_file_ending,
    )

    files = subfiles(input_folder, join_path=False)
    files = [f for f in files if not f.endswith((".json", ".pkl", ".npz"))]
    assert files, f"no segmentation files in {input_folder}"
    file_ending = "." + ".".join(files[0].split(".")[1:])
    rw = determine_reader_writer_from_file_ending(file_ending)()

    maybe_mkdir_p(output_folder)
    for f in files:
        seg, props = rw.read_seg(join(input_folder, f))
        seg = seg[0]
        for fn, kw in zip(fns, kwargs_list):
            seg = fn(seg, **kw)
        rw.write_seg(seg, join(output_folder, f), props)
