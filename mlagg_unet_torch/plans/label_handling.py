"""Label / region / ignore-label management.

Numpy-first port of the reference semantics
(mlagg/nnunetv2/utilities/label_handling/label_handling.py:21,128,179):
plain labels vs. overlapping *regions* (sigmoid heads) vs. an *ignore label*
(must be max(all_labels)+1). Device-side helpers operate on channel-LAST
arrays (c last), matching this framework's NHWC layout; host-side helpers use
channel-first (c, x, y(, z)) to stay artifact-compatible with the reference.
"""
from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np


def softmax_np(x: np.ndarray, axis: int = 0) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def sigmoid_np(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class LabelManager:
    def __init__(
        self,
        label_dict: dict,
        regions_class_order: Union[List[int], None],
        force_use_labels: bool = False,
        inference_nonlin=None,
    ):
        self._sanity_check(label_dict)
        self.label_dict = label_dict
        self.regions_class_order = regions_class_order
        self._force_use_labels = force_use_labels

        if force_use_labels:
            self._has_regions = False
        else:
            self._has_regions = any(
                isinstance(i, (tuple, list)) and len(i) > 1
                for i in self.label_dict.values()
            )

        self._ignore_label = self._determine_ignore_label()
        self._all_labels = self._get_all_labels()
        self._regions = self._get_regions()

        if self.has_ignore_label:
            assert self.ignore_label == max(self.all_labels) + 1, (
                "the ignore label must have the highest label value"
            )

        if inference_nonlin is None:
            self.inference_nonlin = (
                sigmoid_np if self.has_regions else lambda x: softmax_np(x, axis=0)
            )
        else:
            self.inference_nonlin = inference_nonlin

    @staticmethod
    def _sanity_check(label_dict: dict):
        if "background" not in label_dict:
            raise RuntimeError("Background label not declared (should be label 0)")
        bg_label = label_dict["background"]
        if isinstance(bg_label, (tuple, list)):
            raise RuntimeError(f"Background label must be 0, got {bg_label}")
        assert int(bg_label) == 0, f"Background label must be 0, got {bg_label}"

    def _get_all_labels(self) -> List[int]:
        all_labels = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if isinstance(r, (tuple, list)):
                all_labels += [int(ri) for ri in r]
            else:
                all_labels.append(int(r))
        return sorted(np.unique(all_labels).tolist())

    def _get_regions(self) -> Union[None, List[Union[int, Tuple[int, ...]]]]:
        if not self._has_regions or self._force_use_labels:
            return None
        assert self.regions_class_order is not None, (
            "region-based training requires regions_class_order"
        )
        regions = []
        for k, r in self.label_dict.items():
            if k == "ignore":
                continue
            if (np.isscalar(r) and r == 0) or (
                isinstance(r, (tuple, list))
                and len(np.unique(r)) == 1
                and np.unique(r)[0] == 0
            ):
                continue
            if isinstance(r, list):
                r = tuple(r)
            regions.append(r)
        assert len(self.regions_class_order) == len(regions)
        return regions

    def _determine_ignore_label(self) -> Union[None, int]:
        ignore_label = self.label_dict.get("ignore")
        if ignore_label is not None:
            assert isinstance(ignore_label, int), (
                f"Ignore label must be an int, got {type(ignore_label)}"
            )
        return ignore_label

    @property
    def has_regions(self) -> bool:
        return self._has_regions

    @property
    def has_ignore_label(self) -> bool:
        return self.ignore_label is not None

    @property
    def all_regions(self):
        return self._regions

    @property
    def all_labels(self) -> List[int]:
        return self._all_labels

    @property
    def ignore_label(self) -> Union[None, int]:
        return self._ignore_label

    @property
    def foreground_labels(self) -> List[int]:
        return [i for i in self.all_labels if i != 0]

    @property
    def foreground_regions(self):
        return list(self.all_regions) if self.all_regions is not None else None

    @property
    def num_segmentation_heads(self) -> int:
        if self.has_regions:
            return len(self.all_regions)
        return len(self.all_labels)

    # ---------------------------------------------------------------
    # host-side conversion (channel-first, artifact-compatible)
    # ---------------------------------------------------------------

    def apply_inference_nonlin(self, logits: np.ndarray) -> np.ndarray:
        """logits: (c, x, y(, z)) -> probabilities of the same shape."""
        return self.inference_nonlin(np.asarray(logits, dtype=np.float32))

    def convert_probabilities_to_segmentation(self, probs: np.ndarray) -> np.ndarray:
        """probs: (c, x, y(, z)) -> segmentation (x, y(, z)).

        Regions: thresholded painting in regions_class_order
        (reference label_handling.py:146-177); labels: argmax over c.
        """
        assert probs.shape[0] == self.num_segmentation_heads, (
            f"expected {self.num_segmentation_heads} channels, got {probs.shape[0]}"
        )
        if self.has_regions:
            segmentation = np.zeros(probs.shape[1:], dtype=np.uint8)
            for i, c in enumerate(self.regions_class_order):
                segmentation[probs[i] > 0.5] = c
            return segmentation
        seg = probs.argmax(0)
        # map channel index -> actual label value (labels may be non-contiguous)
        labels = np.asarray(self.all_labels)
        if not np.array_equal(labels, np.arange(len(labels))):
            seg = labels[seg]
        return seg.astype(np.uint8 if max(self.all_labels) < 256 else np.uint16)

    def convert_logits_to_segmentation(self, logits: np.ndarray) -> np.ndarray:
        return self.convert_probabilities_to_segmentation(
            self.apply_inference_nonlin(logits)
        )

    def revert_cropping_on_probabilities(
        self, probs: np.ndarray, bbox: List[List[int]], original_shape
    ) -> np.ndarray:
        """Paste (c, ...) probabilities back into the pre-crop canvas; padded
        area gets background prob 1 (labels) / 0 (regions)."""
        out = np.zeros((probs.shape[0], *original_shape), dtype=probs.dtype)
        if not self.has_regions:
            out[0] = 1.0
        slicer = tuple([slice(None)] + [slice(lo, hi) for lo, hi in bbox])
        out[slicer] = probs
        return out


def convert_labelmap_to_one_hot(
    segmentation: np.ndarray, all_labels: List[int], output_dtype=np.uint8
) -> np.ndarray:
    """(x, y(, z)) labelmap -> (len(all_labels), x, y(, z)) one-hot
    (reference label_handling.py:128). Used by the cascade to stack the
    previous stage's segmentation onto the input channels."""
    result = np.zeros((len(all_labels), *segmentation.shape), dtype=output_dtype)
    for i, l in enumerate(all_labels):
        result[i] = segmentation == l
    return result


def determine_num_input_channels(
    plans_manager, configuration_manager, dataset_json: dict
) -> int:
    """(reference label_handling.py:276-293) cascade configs get
    len(foreground_labels) extra one-hot channels from the previous stage."""
    label_manager = plans_manager.get_label_manager(dataset_json)
    if "channel_names" in dataset_json:
        num_modalities = len(dataset_json["channel_names"])
    else:
        num_modalities = len(dataset_json["modality"])
    if configuration_manager.previous_stage_name is not None:
        num_input_channels = num_modalities + len(label_manager.foreground_labels)
    else:
        num_input_channels = num_modalities
    return num_input_channels
