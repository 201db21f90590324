"""Raw .npy/.npz reader/writer with a .json spacing sidecar.

Not in the reference (which has Tiff3DIO with the same sidecar idea,
tif_reader_writer.py) — this gives the test-suite and converters a
dependency-free 3D format.
"""
from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter


class NumpyIO(BaseReaderWriter):
    supported_file_endings = [".npy"]

    @staticmethod
    def _sidecar(fname: str) -> str:
        return fname[: -len(".npy")] + ".json"

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings = [], []
        for f in image_fnames:
            arr = np.load(f)
            if arr.ndim == 2:
                arr = arr[None, None]
            elif arr.ndim == 3:
                arr = arr[None]
            assert arr.ndim == 4, f"expected (c,x,y,z)-compatible array in {f}"
            images.append(arr.astype(np.float32))
            sidecar = self._sidecar(f)
            if os.path.isfile(sidecar):
                with open(sidecar) as fh:
                    spacings.append(tuple(json.load(fh)["spacing"]))
            else:
                spacings.append((1.0,) * (arr.ndim - 1))
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"spacings differ: {image_fnames}")
        return np.vstack(images), {"spacing": spacings[0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg, output_fname: str, properties: dict) -> None:
        np.save(output_fname, np.asarray(seg))
        with open(self._sidecar(output_fname), "w") as fh:
            json.dump({"spacing": list(properties["spacing"])}, fh)
