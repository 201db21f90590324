"""Dataset integrity verification
(reference: experiment_planning/verify_dataset_integrity.py): validates
dataset.json <-> files on disk, label values, image/seg geometry agreement.

Copied from ``mlagg_unet_tpu/cli/verify_dataset_integrity.py`` with the imports rewritten.
"""
from __future__ import annotations

import numpy as np

from mlagg_unet_torch.imageio.reader_writer_registry import (
    determine_reader_writer_from_dataset_json,
)
from mlagg_unet_torch.plans.fingerprint import (
    create_lists_from_splitted_dataset_folder,
    get_identifiers_from_splitted_dataset_folder,
)
from mlagg_unet_torch.utils.helpers import isdir, isfile, join, load_json


def verify_dataset_integrity(folder: str, num_processes: int = 8) -> None:
    assert isfile(join(folder, "dataset.json")), (
        f"missing dataset.json in {folder}"
    )
    dataset_json = load_json(join(folder, "dataset.json"))
    assert isdir(join(folder, "imagesTr")), f"missing imagesTr in {folder}"
    assert isdir(join(folder, "labelsTr")), f"missing labelsTr in {folder}"
    for key in ("labels", "numTraining", "file_ending"):
        assert key in dataset_json, f"dataset.json misses key {key}"
    assert "channel_names" in dataset_json or "modality" in dataset_json, (
        "dataset.json needs channel_names"
    )

    file_ending = dataset_json["file_ending"]
    identifiers = get_identifiers_from_splitted_dataset_folder(
        join(folder, "imagesTr"), file_ending)
    assert len(identifiers) == dataset_json["numTraining"], (
        f"numTraining={dataset_json['numTraining']} but found "
        f"{len(identifiers)} training identifiers"
    )

    num_channels = len(dataset_json.get("channel_names",
                                        dataset_json.get("modality")))
    image_lists = create_lists_from_splitted_dataset_folder(
        join(folder, "imagesTr"), file_ending, identifiers)
    labels = []
    for k, v in dataset_json["labels"].items():
        if isinstance(v, (tuple, list)):
            labels += [int(i) for i in v]
        else:
            labels.append(int(v))
    labels = set(labels)

    rw = determine_reader_writer_from_dataset_json(
        dataset_json, image_lists[0][0])()
    for ident, images in zip(identifiers, image_lists):
        assert len(images) == num_channels, (
            f"case {ident}: expected {num_channels} channels, found "
            f"{len(images)}"
        )
        seg_file = join(folder, "labelsTr", ident + file_ending)
        assert isfile(seg_file), f"missing label file for {ident}"
        img, img_props = rw.read_images(images)
        seg, seg_props = rw.read_seg(seg_file)
        assert img.shape[1:] == seg.shape[1:], (
            f"case {ident}: image/seg shape mismatch "
            f"{img.shape[1:]} vs {seg.shape[1:]}"
        )
        assert np.allclose(img_props["spacing"], seg_props["spacing"]), (
            f"case {ident}: image/seg spacing mismatch"
        )
        found = set(np.unique(seg).astype(int).tolist())
        unexpected = found - labels
        assert not unexpected, (
            f"case {ident}: unexpected label values {unexpected}"
        )
        assert not np.any(np.isnan(img)), f"case {ident}: NaNs in image"
    print(f"Dataset {folder} OK ({len(identifiers)} cases)")
