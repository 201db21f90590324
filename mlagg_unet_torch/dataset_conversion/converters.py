"""Dataset-specific raw -> framework-format converters.

Equivalents of the reference's dataset_conversion scripts (Dataset027_ACDC.py
with the official 5-fold split :28-41, MSD converter, ISIC/RoadSeg-style PNG
2D datasets). Each converter reads a user-downloaded raw layout and writes a
DatasetXXX_Name folder with imagesTr/labelsTr/dataset.json.

Copied from ``mlagg_unet_tpu/dataset_conversion/converters.py`` with the imports rewritten.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from mlagg_unet_torch import paths
from mlagg_unet_torch.dataset_conversion.generate_dataset_json import (
    generate_dataset_json,
)
from mlagg_unet_torch.utils.helpers import (
    isdir,
    isfile,
    join,
    load_json,
    maybe_mkdir_p,
    save_json,
    subdirs,
    subfiles,
)


def convert_msd_dataset(source_folder: str,
                        output_dataset_id: Optional[int] = None,
                        overwrite_name: Optional[str] = None) -> str:
    """Medical Segmentation Decathlon folder (imagesTr/labelsTr/dataset.json
    in MSD schema) -> framework format (reference convert_MSD_dataset.py).
    When output_dataset_id is None it is inferred from the TaskXX_Name
    source folder name (reference :96-103)."""
    if output_dataset_id is None:
        base = os.path.basename(source_folder.rstrip("/"))
        if not base.startswith("Task"):
            raise ValueError(
                f"Cannot infer dataset id from folder name {base!r}; pass "
                "output_dataset_id / -overwrite_id")
        output_dataset_id = int(base[4:].split("_")[0])
    msd_json = load_json(join(source_folder, "dataset.json"))
    task_name = overwrite_name or msd_json["name"].replace(" ", "")
    dataset_name = f"Dataset{output_dataset_id:03d}_{task_name}"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))
    maybe_mkdir_p(join(out, "imagesTs"))

    modalities = msd_json.get("modality", {"0": "CT"})
    n_channels = len(modalities)
    file_ending = ".nii.gz"

    n_train = 0
    for entry in msd_json["training"]:
        img = os.path.basename(entry["image"])
        ident = img[: -len(file_ending)]
        src_img = join(source_folder, "imagesTr", img)
        if not isfile(src_img):
            continue
        # MSD images may be 4D (c last); our NIfTI reader handles 3D only,
        # so single-modality datasets copy through; multi-modality needs
        # per-channel splitting by the user upstream
        assert n_channels == 1, (
            "multi-channel MSD tasks need per-channel files; split upstream"
        )
        shutil.copy(src_img, join(out, "imagesTr", f"{ident}_0000{file_ending}"))
        shutil.copy(join(source_folder, "labelsTr", img),
                    join(out, "labelsTr", f"{ident}{file_ending}"))
        n_train += 1
    for entry in msd_json.get("test", []):
        img = os.path.basename(entry if isinstance(entry, str)
                               else entry["image"])
        src = join(source_folder, "imagesTs", img)
        if isfile(src):
            ident = img[: -len(file_ending)]
            shutil.copy(src, join(out, "imagesTs",
                                  f"{ident}_0000{file_ending}"))

    labels = {
        ("background" if str(v).lower() == "background" else str(v)): int(k)
        for k, v in msd_json["labels"].items()
    }
    generate_dataset_json(
        out, {i: m for i, m in enumerate(modalities.values())}, labels,
        n_train, file_ending, dataset_name=dataset_name,
    )
    return out


ACDC_OFFICIAL_SPLIT_SEED_PATIENTS = 100  # patient001..100, 20 per fold


def acdc_official_splits(identifiers: List[str]) -> List[Dict[str, List[str]]]:
    """The official ACDC 5-fold split by patient number
    (reference Dataset027_ACDC.py:28-41): patients partitioned into 5 groups
    of 20 by index."""
    def patient_of(ident: str) -> int:
        import re

        m = re.search(r"patient(\d+)", ident)
        return int(m.group(1)) if m else 0

    splits = []
    for fold in range(5):
        val_patients = set(range(fold * 20 + 1, (fold + 1) * 20 + 1))
        val = [i for i in identifiers if patient_of(i) in val_patients]
        train = [i for i in identifiers if i not in val]
        splits.append({"train": sorted(train), "val": sorted(val)})
    return splits


def convert_acdc(source_folder: str, output_dataset_id: int = 27) -> str:
    """ACDC 'database/training' layout -> Dataset027_ACDC with the official
    split saved as splits_final.json (reference Dataset027_ACDC.py)."""
    dataset_name = f"Dataset{output_dataset_id:03d}_ACDC"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))

    patients = subdirs(source_folder, prefix="patient", join_path=False)
    n = 0
    identifiers = []
    for pat in sorted(patients):
        pdir = join(source_folder, pat)
        frames = [f for f in os.listdir(pdir)
                  if f.endswith(".nii.gz") and "_gt" not in f
                  and "frame" in f and "_4d" not in f]
        for frame in sorted(frames):
            gt = frame.replace(".nii.gz", "_gt.nii.gz")
            if not isfile(join(pdir, gt)):
                continue
            ident = frame[: -len(".nii.gz")]
            identifiers.append(ident)
            shutil.copy(join(pdir, frame),
                        join(out, "imagesTr", f"{ident}_0000.nii.gz"))
            shutil.copy(join(pdir, gt),
                        join(out, "labelsTr", f"{ident}.nii.gz"))
            n += 1

    generate_dataset_json(
        out, {0: "cineMRI"},
        {"background": 0, "RV": 1, "MLV": 2, "LVC": 3},
        n, ".nii.gz", dataset_name=dataset_name,
    )
    # official split goes to preprocessed once planning ran; also stage here
    maybe_mkdir_p(join(paths.nnUNet_preprocessed, dataset_name))
    save_json(acdc_official_splits(identifiers),
              join(paths.nnUNet_preprocessed, dataset_name,
                   "splits_final.json"))
    return out


def convert_png_2d_dataset(
    images_folder: str,
    masks_folder: str,
    output_dataset_id: int,
    task_name: str,
    label_mapping: Dict[int, int] = None,
    is_rgb: bool = True,
) -> str:
    """Natural-image 2D datasets (ISIC2017, RoadSeg style): PNG images +
    binary/label masks -> framework format with NaturalImage2DIO."""
    from PIL import Image

    dataset_name = f"Dataset{output_dataset_id:03d}_{task_name}"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))

    images = subfiles(images_folder, suffix=".png", join_path=False)
    n = 0
    for img in sorted(images):
        mask_file = join(masks_folder, img)
        if not isfile(mask_file):
            continue
        ident = img[:-4]
        shutil.copy(join(images_folder, img),
                    join(out, "imagesTr", f"{ident}_0000.png"))
        mask = np.asarray(Image.open(mask_file))
        if mask.ndim == 3:
            mask = mask[..., 0]
        if label_mapping is not None:
            remapped = np.zeros_like(mask)
            for src, dst in label_mapping.items():
                remapped[mask == src] = dst
            mask = remapped
        else:
            mask = (mask > 127).astype(np.uint8)
        Image.fromarray(mask.astype(np.uint8)).save(
            join(out, "labelsTr", f"{ident}.png"))
        n += 1

    channels = ({0: "rgb_to_0_1", 1: "rgb_to_0_1", 2: "rgb_to_0_1"}
                if is_rgb else {0: "rescale_0_1"})
    generate_dataset_json(
        out, channels, {"background": 0, "foreground": 1}, n, ".png",
        dataset_name=dataset_name,
        overwrite_image_reader_writer="NaturalImage2DIO",
    )
    return out


# ---------------------------------------------------------------------------
# BraTS21 (reference Dataset137_BraTS21.py)
# ---------------------------------------------------------------------------

def _convert_brats_seg(in_file: str, out_file: str) -> None:
    """BraTS labels 0/1/2/4 -> continuous 0/2/1/3 (ref :12-29)."""
    from mlagg_unet_torch.imageio.nifti_io import read_nifti, write_nifti

    data, hdr = read_nifti(in_file)
    arr = np.asarray(data)
    uniques = np.unique(arr)
    if not set(int(u) for u in uniques) <= {0, 1, 2, 4}:
        raise RuntimeError(f"unexpected BraTS label in {in_file}: {uniques}")
    new = np.zeros_like(arr, dtype=np.uint8)
    new[arr == 4] = 3
    new[arr == 2] = 1
    new[arr == 1] = 2
    write_nifti(out_file, new, tuple(hdr["pixdim"][:3]), hdr)


def convert_labels_back_to_brats(seg: np.ndarray) -> np.ndarray:
    """Inverse mapping for submitting predictions (ref :32-37)."""
    new = np.zeros_like(seg)
    new[seg == 1] = 2
    new[seg == 3] = 4
    new[seg == 2] = 1
    return new


def convert_folder_with_preds_back_to_brats(input_folder: str,
                                            output_folder: str) -> None:
    from mlagg_unet_torch.imageio.nifti_io import read_nifti, write_nifti

    maybe_mkdir_p(output_folder)
    for f in subfiles(input_folder, suffix=".nii.gz", join_path=False):
        data, hdr = read_nifti(join(input_folder, f))
        write_nifti(join(output_folder, f),
                    convert_labels_back_to_brats(np.asarray(data)),
                    tuple(hdr["pixdim"][:3]), hdr)


def convert_brats21(source_folder: str, output_dataset_id: int = 137) -> str:
    """BraTS21 TrainingData layout (BraTS*/ case folders with _t1/_t1ce/_t2/
    _flair/_seg niftis) -> Dataset137_BraTS2021 with region labels."""
    dataset_name = f"Dataset{output_dataset_id:03d}_BraTS2021"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))

    case_ids = subdirs(source_folder, prefix="BraTS", join_path=False)
    for c in sorted(case_ids):
        for i, mod in enumerate(["t1", "t1ce", "t2", "flair"]):
            shutil.copy(join(source_folder, c, f"{c}_{mod}.nii.gz"),
                        join(out, "imagesTr", f"{c}_{i:04d}.nii.gz"))
        _convert_brats_seg(join(source_folder, c, f"{c}_seg.nii.gz"),
                           join(out, "labelsTr", f"{c}.nii.gz"))

    generate_dataset_json(
        out, {0: "T1", 1: "T1ce", 2: "T2", 3: "Flair"},
        {"background": 0, "whole tumor": (1, 2, 3), "tumor core": (2, 3),
         "enhancing tumor": (3,)},
        len(case_ids), ".nii.gz", dataset_name=dataset_name,
        regions_class_order=(1, 2, 3),
    )
    return out


# ---------------------------------------------------------------------------
# AMOS 2022 (reference Dataset218/219_Amos2022_task{1,2}.py)
# ---------------------------------------------------------------------------

def convert_amos(source_folder: str, task: int = 1,
                 output_dataset_id: Optional[int] = None) -> str:
    """AMOS2022 post-challenge release. task 1 = CT only (ids <= 410/500),
    task 2 = CT+MRI (everything). Validation images/labels join the train
    set (5-fold CV beats a fixed split, per the reference's comment)."""
    assert task in (1, 2)
    output_dataset_id = output_dataset_id or (218 if task == 1 else 219)
    task_name = f"AMOS2022_postChallenge_task{task}"
    dataset_name = f"Dataset{output_dataset_id:03d}_{task_name}"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "imagesTs"))
    maybe_mkdir_p(join(out, "labelsTr"))

    src_json = load_json(join(source_folder, "dataset.json"))

    def ident(entry):
        return os.path.basename(entry)[: -len(".nii.gz")]

    n_train = 0
    for entry in src_json["training"]:
        tr = ident(entry["image"])
        if task == 2 or int(tr.split("_")[-1]) <= 410:
            n_train += 1
            shutil.copy(join(source_folder, "imagesTr", tr + ".nii.gz"),
                        join(out, "imagesTr", f"{tr}_0000.nii.gz"))
            shutil.copy(join(source_folder, "labelsTr", tr + ".nii.gz"),
                        join(out, "labelsTr", f"{tr}.nii.gz"))
    for entry in src_json.get("test", []):
        ts = ident(entry["image"] if isinstance(entry, dict) else entry)
        if task == 2 or int(ts.split("_")[-1]) <= 500:
            shutil.copy(join(source_folder, "imagesTs", ts + ".nii.gz"),
                        join(out, "imagesTs", f"{ts}_0000.nii.gz"))
    for entry in src_json.get("validation", []):
        vl = ident(entry["image"])
        if task == 2 or int(vl.split("_")[-1]) <= 409:
            n_train += 1
            shutil.copy(join(source_folder, "imagesVa", vl + ".nii.gz"),
                        join(out, "imagesTr", f"{vl}_0000.nii.gz"))
            shutil.copy(join(source_folder, "labelsVa", vl + ".nii.gz"),
                        join(out, "labelsTr", f"{vl}.nii.gz"))

    generate_dataset_json(
        out, {0: "CT" if task == 1 else "either_CT_or_MR"},
        {v: int(k) for k, v in src_json["labels"].items()},
        n_train, ".nii.gz", dataset_name=dataset_name,
        overwrite_image_reader_writer="NibabelIOWithReorient",
    )
    return out


# ---------------------------------------------------------------------------
# KiTS 2023 (reference Dataset220_KiTS2023.py)
# ---------------------------------------------------------------------------

def convert_kits2023(source_folder: str, output_dataset_id: int = 220) -> str:
    """KiTS23 case_XXXXX folders -> region-label dataset."""
    dataset_name = f"Dataset{output_dataset_id:03d}_KiTS2023"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "labelsTr"))

    cases = subdirs(source_folder, prefix="case_", join_path=False)
    for tr in sorted(cases):
        shutil.copy(join(source_folder, tr, "imaging.nii.gz"),
                    join(out, "imagesTr", f"{tr}_0000.nii.gz"))
        shutil.copy(join(source_folder, tr, "segmentation.nii.gz"),
                    join(out, "labelsTr", f"{tr}.nii.gz"))

    generate_dataset_json(
        out, {0: "CT"},
        {"background": 0, "kidney": (1, 2, 3), "masses": (2, 3), "tumor": 2},
        len(cases), ".nii.gz", dataset_name=dataset_name,
        regions_class_order=(1, 3, 2),
        overwrite_image_reader_writer="NibabelIOWithReorient",
    )
    return out


# ---------------------------------------------------------------------------
# BTCV (reference Task017_BeyondCranialVaultAbdominalOrganSegmentation.py)
# ---------------------------------------------------------------------------

BTCV_LABELS = {
    "background": 0, "spleen": 1, "right kidney": 2, "left kidney": 3,
    "gallbladder": 4, "esophagus": 5, "liver": 6, "stomach": 7, "aorta": 8,
    "inferior vena cava": 9, "portal vein and splenic vein": 10,
    "pancreas": 11, "right adrenal gland": 12, "left adrenal gland": 13,
}


def convert_btcv(source_folder: str, output_dataset_id: int = 17) -> str:
    """BTCV RawData layout (Training/img + Training/label + Testing/img,
    files img0001.nii.gz / label0001.nii.gz) -> Dataset017_BTCV."""
    dataset_name = f"Dataset{output_dataset_id:03d}_BTCV"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "imagesTs"))
    maybe_mkdir_p(join(out, "labelsTr"))

    train_folder = join(source_folder, "Training", "img")
    label_folder = join(source_folder, "Training", "label")
    test_folder = join(source_folder, "Testing", "img")
    n = 0
    for p in subfiles(train_folder, suffix="nii.gz", join_path=False):
        serial = int(p[3:7])
        name = f"ABD_{serial:03d}"
        shutil.copy(join(train_folder, p),
                    join(out, "imagesTr", f"{name}_0000.nii.gz"))
        shutil.copy(join(label_folder, f"label{p[3:]}"),
                    join(out, "labelsTr", f"{name}.nii.gz"))
        n += 1
    if isdir(test_folder):
        for p in subfiles(test_folder, suffix=".nii.gz", join_path=False):
            serial = int(p[3:7])
            shutil.copy(join(test_folder, p),
                        join(out, "imagesTs", f"ABD_{serial:03d}_0000.nii.gz"))

    generate_dataset_json(out, {0: "CT"}, BTCV_LABELS, n, ".nii.gz",
                          dataset_name=dataset_name)
    return out


# ---------------------------------------------------------------------------
# ISIC 2017 (reference Dataset717_ISIC2017.py)
# ---------------------------------------------------------------------------

def convert_isic2017(source_folder: str, output_dataset_id: int = 717,
                     height: int = 256, width: int = 256) -> str:
    """ISIC-2017 jpg images + *_segmentation.png masks, both resized to
    256x256 with nearest-neighbour (ref :15-30); train + val go into the
    train set folders like the reference writes them."""
    from PIL import Image

    dataset_name = f"Dataset{output_dataset_id:03d}_ISIC2017"
    out = join(paths.nnUNet_raw, dataset_name)
    for sub in ("imagesTr", "labelsTr", "imagesVal", "labelsVal"):
        maybe_mkdir_p(join(out, sub))

    def convert_split(img_dir, seg_dir, out_img, out_seg):
        count = 0
        for v in subfiles(img_dir, suffix=".jpg", join_path=False):
            ident = v[:-4]
            seg_file = join(seg_dir, ident + "_segmentation.png")
            if not isfile(seg_file):
                continue
            seg = Image.open(seg_file).resize((width, height), Image.NEAREST)
            seg_arr = (np.asarray(seg) > 127).astype(np.uint8)
            Image.fromarray(seg_arr).save(join(out_seg, ident + ".png"))
            img = Image.open(join(img_dir, v)).resize((width, height),
                                                      Image.NEAREST)
            img.save(join(out_img, ident + "_0000.png"))
            count += 1
        return count

    n_train = convert_split(join(source_folder, "ISIC-2017_Training_Data"),
                            join(source_folder,
                                 "ISIC-2017_Training_Part1_GroundTruth"),
                            join(out, "imagesTr"), join(out, "labelsTr"))
    val_dir = join(source_folder, "ISIC-2017_Validation_Data")
    if isdir(val_dir):
        convert_split(val_dir,
                      join(source_folder,
                           "ISIC-2017_Validation_Part1_GroundTruth"),
                      join(out, "imagesVal"), join(out, "labelsVal"))

    generate_dataset_json(out, {0: "R", 1: "G", 2: "B"},
                          {"background": 0, "Melanoma": 1}, n_train, ".png",
                          dataset_name=dataset_name,
                          overwrite_image_reader_writer="NaturalImage2DIO")
    return out


# ---------------------------------------------------------------------------
# Massachusetts Roads (reference Dataset120_RoadSegmentation.py)
# ---------------------------------------------------------------------------

def convert_road_segmentation(source_folder: str,
                              output_dataset_id: int = 120,
                              min_component_size: int = 50) -> str:
    """road_segmentation_ideal layout: training/testing x input/output.
    White (255,255,255) no-data regions larger than min_component_size get
    their road label removed (ref :15-28)."""
    from PIL import Image
    from scipy import ndimage

    dataset_name = f"Dataset{output_dataset_id:03d}_RoadSegmentation"
    out = join(paths.nnUNet_raw, dataset_name)
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs"):
        maybe_mkdir_p(join(out, sub))

    def convert_case(img_file, seg_file, out_img, out_seg):
        seg = np.asarray(Image.open(seg_file)).copy()
        if seg.ndim == 3:
            seg = seg[..., 0].copy()
        seg[seg == 255] = 1
        image = np.asarray(Image.open(img_file)).astype(np.int64)
        mask = image.sum(2) == 3 * 255
        labeled, n = ndimage.label(mask)
        keep = np.zeros_like(mask)
        for comp in range(1, n + 1):
            comp_mask = labeled == comp
            if comp_mask.sum() > min_component_size:
                keep |= comp_mask
        keep = ndimage.binary_fill_holes(keep)
        seg[keep] = 0
        Image.fromarray(seg.astype(np.uint8)).save(out_seg)
        shutil.copy(img_file, out_img)

    n_train = 0
    for split, img_out, seg_out in (
        ("training", "imagesTr", "labelsTr"),
        ("testing", "imagesTs", "labelsTs"),
    ):
        out_dir = join(source_folder, split, "output")
        if not isdir(out_dir):
            continue
        for v in subfiles(out_dir, suffix=".png", join_path=False):
            convert_case(join(source_folder, split, "input", v),
                         join(out_dir, v),
                         join(out, img_out, v[:-4] + "_0000.png"),
                         join(out, seg_out, v))
            if split == "training":
                n_train += 1

    generate_dataset_json(out, {0: "R", 1: "G", 2: "B"},
                          {"background": 0, "road": 1}, n_train, ".png",
                          dataset_name=dataset_name,
                          overwrite_image_reader_writer="NaturalImage2DIO")
    return out


# ---------------------------------------------------------------------------
# Fluo-C3DH-A549-SIM cell tracking (reference Dataset073_Fluo_C3DH_A549_SIM.py)
# ---------------------------------------------------------------------------

def convert_fluo_c3dh(train_source: str, test_source: Optional[str] = None,
                      output_dataset_id: int = 73) -> str:
    """Cell-tracking-challenge tif layout (01/, 01_GT/SEG, 02/, 02_GT/SEG)
    -> 3D tif dataset with per-case spacing sidecars (spacing 1 x .126 x
    .126, ref :36)."""
    dataset_name = f"Dataset{output_dataset_id:03d}_Fluo_C3DH_A549_SIM"
    out = join(paths.nnUNet_raw, dataset_name)
    maybe_mkdir_p(join(out, "imagesTr"))
    maybe_mkdir_p(join(out, "imagesTs"))
    maybe_mkdir_p(join(out, "labelsTr"))

    spacing = (1, 0.126, 0.126)
    n = 0
    for seq in ("01", "02"):
        images_dir = join(train_source, seq)
        seg_dir = join(train_source, seq + "_GT", "SEG")
        if not isdir(images_dir):
            continue
        images = sorted(subfiles(images_dir, suffix=".tif", join_path=False))
        segs = sorted(subfiles(seg_dir, suffix=".tif", join_path=False))
        for i, (im, se) in enumerate(zip(images, segs)):
            name = f"{seq}_image_{i:03d}"
            shutil.copy(join(images_dir, im),
                        join(out, "imagesTr", name + "_0000.tif"))
            save_json({"spacing": spacing},
                      join(out, "imagesTr", name + ".json"))
            shutil.copy(join(seg_dir, se),
                        join(out, "labelsTr", name + ".tif"))
            save_json({"spacing": spacing},
                      join(out, "labelsTr", name + ".json"))
            n += 1
    if test_source is not None:
        for seq in ("01", "02"):
            images_dir = join(test_source, seq)
            if not isdir(images_dir):
                continue
            images = sorted(subfiles(images_dir, suffix=".tif",
                                     join_path=False))
            for i, im in enumerate(images):
                name = f"{seq}_image_{i:03d}"
                shutil.copy(join(images_dir, im),
                            join(out, "imagesTs", name + "_0000.tif"))
                save_json({"spacing": spacing},
                          join(out, "imagesTs", name + ".json"))

    generate_dataset_json(out, {0: "fluorescence_microscopy"},
                          {"background": 0, "cell": 1}, n, ".tif",
                          dataset_name=dataset_name,
                          overwrite_image_reader_writer="Tiff3DIO")
    return out


def convert_old_nnunet_dataset(source_folder: str,
                               target_dataset_name: str) -> str:
    """Convert an nnU-Net v1 raw Task folder (TaskXXX_YYY) into the v2
    DatasetXXX_YYY layout (reference dataset_conversion/
    convert_raw_dataset_from_old_nnunet_format.py:8-40): copy the image/
    label trees, then rewrite dataset.json — drop the v1-only keys
    (tensorImageSize, numTest, training, test), rename modality ->
    channel_names, and invert the labels dict from {name: id} to
    {id: name}-free v2 form {name: int(id)} with file_ending .nii.gz."""
    out = join(paths.nnUNet_raw, target_dataset_name)
    if isdir(out):
        raise RuntimeError(
            f"Target dataset {out} already exists; delete it manually first")
    maybe_mkdir_p(out)
    for sub in ("imagesTr", "labelsTr", "imagesTs", "labelsTs",
                "imagesVal", "labelsVal"):
        src = join(source_folder, sub)
        if isdir(src):
            shutil.copytree(src, join(out, sub))
    dsj = load_json(join(source_folder, "dataset.json"))
    for key in ("tensorImageSize", "numTest", "training", "test"):
        dsj.pop(key, None)
    if "modality" in dsj:
        dsj["channel_names"] = dsj.pop("modality")
    dsj["labels"] = {name: int(i) for i, name in dsj["labels"].items()}
    dsj["file_ending"] = ".nii.gz"
    save_json(dsj, join(out, "dataset.json"), sort_keys=False)
    return out
