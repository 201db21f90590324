"""Reader/writer contract (reference: mlagg/nnunetv2/imageio/base_reader_writer.py:21-80).

Images are returned as 4D float32 arrays (c, x, y, z) with a properties dict
containing at least {'spacing': (sx, sy, sz)} — the exact contract the
reference establishes so the whole pipeline is layout-stable.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import List, Tuple, Union

import numpy as np


class BaseReaderWriter(ABC):
    supported_file_endings: List[str] = []

    @staticmethod
    def _check_all_same(input_list) -> bool:
        return all(i == input_list[0] for i in input_list[1:])

    @staticmethod
    def _check_all_same_array(input_list) -> bool:
        return all(
            i.shape == input_list[0].shape and np.allclose(i, input_list[0])
            for i in input_list[1:]
        )

    @abstractmethod
    def read_images(self, image_fnames: Union[List[str], Tuple[str, ...]]
                    ) -> Tuple[np.ndarray, dict]:
        """Read a stack of images (one file per channel) -> ((c,x,y,z) fp32,
        props dict with 'spacing')."""

    @abstractmethod
    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        """Read a segmentation -> ((1,x,y,z), props)."""

    @abstractmethod
    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict
                  ) -> None:
        """Write a (x,y,z) segmentation using the stored properties."""
