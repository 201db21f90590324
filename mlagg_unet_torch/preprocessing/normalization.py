"""Intensity normalization schemes
(reference: preprocessing/normalization/default_normalization_schemes.py:8-95).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional, Type

import numpy as np


class ImageNormalization(ABC):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true: Optional[bool] = None

    def __init__(self, use_mask_for_norm: bool = None,
                 intensityproperties: dict = None,
                 target_dtype=np.float32):
        assert use_mask_for_norm is None or isinstance(use_mask_for_norm, bool)
        self.use_mask_for_norm = use_mask_for_norm
        self.intensityproperties = intensityproperties or {}
        self.target_dtype = target_dtype

    @abstractmethod
    def run(self, image: np.ndarray, seg: np.ndarray = None) -> np.ndarray:
        """image/seg: one channel (x, y(, z)). seg<0 marks outside-mask."""


class ZScoreNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = True

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype)
        if self.use_mask_for_norm is not None and self.use_mask_for_norm:
            mask = seg >= 0
            mean = image[mask].mean()
            std = image[mask].std()
            image[mask] = (image[mask] - mean) / (max(std, 1e-8))
        else:
            mean = image.mean()
            std = image.std()
            image = (image - mean) / (max(std, 1e-8))
        return image


class CTNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert self.intensityproperties, "CTNormalization requires intensity properties"
        image = image.astype(self.target_dtype)
        mean_intensity = self.intensityproperties["mean"]
        std_intensity = self.intensityproperties["std"]
        lower_bound = self.intensityproperties["percentile_00_5"]
        upper_bound = self.intensityproperties["percentile_99_5"]
        image = np.clip(image, lower_bound, upper_bound)
        image = (image - mean_intensity) / max(std_intensity, 1e-8)
        return image


class NoNormalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        return image.astype(self.target_dtype)


class RescaleTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        image = image.astype(self.target_dtype)
        image = image - image.min()
        return image / np.clip(image.max(), a_min=1e-8, a_max=None)


class RGBTo01Normalization(ImageNormalization):
    leaves_pixels_outside_mask_at_zero_if_use_mask_for_norm_is_true = False

    def run(self, image, seg=None):
        assert image.min() >= 0 and image.max() <= 255, (
            "RGB images must be uint8 range [0, 255]"
        )
        return image.astype(self.target_dtype) / 255.0


channel_name_to_normalization_mapping = {
    "CT": CTNormalization,
    "noNorm": NoNormalization,
    "zscore": ZScoreNormalization,
    "rescale_0_1": RescaleTo01Normalization,
    "rgb_to_0_1": RGBTo01Normalization,
}


def get_normalization_scheme(channel_name: str) -> Type[ImageNormalization]:
    norm_scheme = channel_name_to_normalization_mapping.get(channel_name)
    if norm_scheme is None:
        norm_scheme = ZScoreNormalization
    return norm_scheme


_SCHEMES_BY_CLASS_NAME = {
    cls.__name__: cls
    for cls in (ZScoreNormalization, CTNormalization, NoNormalization,
                RescaleTo01Normalization, RGBTo01Normalization)
}


def get_normalization_scheme_by_name(name: str) -> Type[ImageNormalization]:
    return _SCHEMES_BY_CLASS_NAME[name]
