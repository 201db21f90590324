"""3D TIFF IO with a pure-NumPy baseline-TIFF codec.

Reference contract (imageio/tif_reader_writer.py): images/segs are 3D
multi-page .tif files; because TIFF has no reliable spacing convention, every
case REQUIRES an ``{identifier}.json`` sidecar next to it carrying
``{"spacing": (a, b, c)}``, written again by ``write_seg``.

The environment has no ``tifffile`` wheel, so this module implements the
subset of TIFF 6.0 the cell-tracking-style datasets use: classic (4-byte
offset) little/big-endian files, grayscale (1 sample/pixel), uncompressed,
strip-organized, uint8/16/32, int8/16/32 or float32/64 samples, one IFD per
z-slice. Writing emits uncompressed multi-page grayscale TIFF.
"""
from __future__ import annotations

import json
import os
import struct
from typing import List, Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter

# TIFF tag ids
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_STRIP_BYTE_COUNTS = 279
_SAMPLE_FORMAT = 339

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d", 16: "Q", 17: "q"}


def _read_ifd_entries(buf: bytes, off: int, bo: str):
    (count,) = struct.unpack_from(bo + "H", buf, off)
    entries = {}
    for i in range(count):
        tag, typ, n = struct.unpack_from(bo + "HHI", buf, off + 2 + 12 * i)
        voff = off + 2 + 12 * i + 8
        size = _TYPE_SIZES.get(typ, 1) * n
        if size > 4:
            (ptr,) = struct.unpack_from(bo + "I", buf, voff)
            voff = ptr
        if typ in _TYPE_FMT:
            vals = struct.unpack_from(bo + str(n) + _TYPE_FMT[typ], buf, voff)
        else:
            vals = ()
        entries[tag] = vals
    (next_off,) = struct.unpack_from(bo + "I", buf, off + 2 + 12 * count)
    return entries, next_off


def read_tiff(fname: str) -> np.ndarray:
    """Multi-page grayscale TIFF -> (D, H, W) array."""
    with open(fname, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        bo = "<"
    elif buf[:2] == b"MM":
        bo = ">"
    else:
        raise RuntimeError(f"{fname}: not a TIFF file")
    (magic,) = struct.unpack_from(bo + "H", buf, 2)
    if magic == 43:
        raise RuntimeError(f"{fname}: BigTIFF is not supported")
    if magic != 42:
        raise RuntimeError(f"{fname}: bad TIFF magic {magic}")
    (ifd_off,) = struct.unpack_from(bo + "I", buf, 4)

    pages: List[np.ndarray] = []
    while ifd_off:
        e, ifd_off = _read_ifd_entries(buf, ifd_off, bo)
        width = e[_IMAGE_WIDTH][0]
        height = e[_IMAGE_LENGTH][0]
        bits = e.get(_BITS_PER_SAMPLE, (1,))[0]
        comp = e.get(_COMPRESSION, (1,))[0]
        spp = e.get(_SAMPLES_PER_PIXEL, (1,))[0]
        sfmt = e.get(_SAMPLE_FORMAT, (1,))[0]
        if comp != 1:
            raise RuntimeError(
                f"{fname}: compression {comp} unsupported (uncompressed only;"
                " re-save the dataset or convert to .nii.gz/.npy)")
        if spp != 1:
            raise RuntimeError(f"{fname}: only grayscale TIFF is supported")
        kind = {1: "u", 2: "i", 3: "f"}.get(sfmt)
        if kind is None:
            raise RuntimeError(f"{fname}: sample format {sfmt} unsupported")
        dtype = np.dtype(f"{bo}{kind}{bits // 8}")
        raw = b"".join(
            buf[o: o + n] for o, n in
            zip(e[_STRIP_OFFSETS], e[_STRIP_BYTE_COUNTS]))
        pages.append(np.frombuffer(raw, dtype=dtype,
                                   count=width * height).reshape(
                                       height, width))
    return np.stack(pages, axis=0)


def write_tiff(fname: str, arr: np.ndarray) -> None:
    """(D, H, W) array -> multi-page uncompressed grayscale TIFF."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[None]
    assert arr.ndim == 3, f"write_tiff wants 3D, got {arr.shape}"
    kind = {"u": 1, "i": 2, "f": 3}[arr.dtype.kind]
    bits = arr.dtype.itemsize * 8
    D, H, W = arr.shape
    page_bytes = H * W * arr.dtype.itemsize

    header = struct.pack("<2sHI", b"II", 42, 8)
    chunks = [header]
    off = 8
    n_tags = 10
    ifd_size = 2 + n_tags * 12 + 4
    for z in range(D):
        data_off = off + ifd_size
        next_ifd = data_off + page_bytes if z < D - 1 else 0

        def tag(tid, typ, n, val):
            return struct.pack("<HHII", tid, typ, n, val)

        ifd = struct.pack("<H", n_tags)
        ifd += tag(_IMAGE_WIDTH, 4, 1, W)
        ifd += tag(_IMAGE_LENGTH, 4, 1, H)
        ifd += tag(_BITS_PER_SAMPLE, 3, 1, bits)
        ifd += tag(_COMPRESSION, 3, 1, 1)
        ifd += tag(_PHOTOMETRIC, 3, 1, 1)
        ifd += tag(_STRIP_OFFSETS, 4, 1, data_off)
        ifd += tag(_SAMPLES_PER_PIXEL, 3, 1, 1)
        ifd += tag(_ROWS_PER_STRIP, 4, 1, H)
        ifd += tag(_STRIP_BYTE_COUNTS, 4, 1, page_bytes)
        ifd += tag(_SAMPLE_FORMAT, 3, 1, kind)
        ifd += struct.pack("<I", next_ifd)
        chunks.append(ifd)
        chunks.append(arr[z].astype(f"<{arr.dtype.kind}{arr.dtype.itemsize}",
                                    copy=False).tobytes())
        off = data_off + page_bytes
    with open(fname, "wb") as f:
        f.write(b"".join(chunks))


def _sidecar_path(fname: str) -> str:
    base = fname
    for ending in (".tif", ".tiff"):
        if fname.endswith(ending):
            base = fname[: -len(ending)]
            break
    return base + ".json"


class Tiff3DIO(BaseReaderWriter):
    """Reference Tiff3DIO (tif_reader_writer.py): 3D tif + spacing sidecar."""

    supported_file_endings = [".tif", ".tiff"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images = []
        spacings = []
        for f in image_fnames:
            images.append(read_tiff(f)[None].astype(np.float32))
            sidecar = _sidecar_path(f)
            if not os.path.isfile(sidecar):
                raise RuntimeError(
                    f"Tiff3DIO requires a spacing sidecar {sidecar}")
            with open(sidecar) as fh:
                spacings.append(tuple(json.load(fh)["spacing"]))
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"spacings differ: {image_fnames}")
        return np.vstack(images), {"spacing": spacings[0]}

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str,
                  properties: dict) -> None:
        write_tiff(output_fname, seg.astype(
            np.uint8 if seg.max() < 255 else np.uint16, copy=False))
        with open(_sidecar_path(output_fname), "w") as fh:
            json.dump({"spacing": [float(s) for s in properties["spacing"]]},
                      fh)
