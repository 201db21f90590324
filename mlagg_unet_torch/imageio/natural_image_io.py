"""2D natural image IO via PIL (reference: natural_image_reager_writer.py).

Convention parity: 2D images get shape (c, 1, H, W) and spacing (999, 1, 1)
(the huge first-axis spacing makes the planner treat them as 2D)."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter


class NaturalImage2DIO(BaseReaderWriter):
    supported_file_endings = [".png", ".bmp", ".tif", ".jpg", ".jpeg"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        from PIL import Image

        images = []
        for f in image_fnames:
            npy = np.asarray(Image.open(f))
            if npy.ndim == 3:  # (H, W, C) rgb -> (C, 1, H, W)
                npy = npy.transpose((2, 0, 1))[:, None]
            elif npy.ndim == 2:
                npy = npy[None, None]
            else:
                raise RuntimeError(f"unexpected image dims in {f}: {npy.shape}")
            images.append(npy.astype(np.float32))
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        return np.vstack(images), {"spacing": (999, 1, 1)}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        from PIL import Image

        npy = np.asarray(Image.open(seg_fname))
        assert npy.ndim == 2, "segmentation PNGs must be single channel"
        return npy[None, None].astype(np.float32), {"spacing": (999, 1, 1)}

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict
                  ) -> None:
        from PIL import Image

        seg = np.asarray(seg)
        if seg.ndim == 3:
            assert seg.shape[0] == 1
            seg = seg[0]
        Image.fromarray(seg.astype(np.uint8)).save(output_fname)
