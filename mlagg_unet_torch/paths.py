"""Dataset/result path management.

The reference pins paths to a repo-relative ``Data/`` root
(mlagg/nnunetv2/paths.py:22-27). We restore upstream nnU-Net's env-var
behavior (friendlier for TPU pods where data lives on mounted disks) while
keeping the same three-root layout and the repo-relative default.

Copied from ``mlagg_unet_tpu/paths.py`` (the three roots).

Roots:
  MLAGG_raw          raw datasets (DatasetXXX_Name/imagesTr, labelsTr, dataset.json)
  MLAGG_preprocessed fingerprints, plans, preprocessed arrays
  MLAGG_results      trained models, logs, checkpoints, validation outputs
"""
from __future__ import annotations

import os

_DEFAULT_ROOT = os.environ.get(
    "MLAGG_data_root", os.path.join(os.path.dirname(os.path.dirname(__file__)), "Data")
)

nnUNet_raw = os.environ.get("MLAGG_raw", os.path.join(_DEFAULT_ROOT, "nnUNet_raw"))
nnUNet_preprocessed = os.environ.get(
    "MLAGG_preprocessed", os.path.join(_DEFAULT_ROOT, "nnUNet_preprocessed")
)
nnUNet_results = os.environ.get(
    "MLAGG_results", os.path.join(_DEFAULT_ROOT, "nnUNet_results")
)
