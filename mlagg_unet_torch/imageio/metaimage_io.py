"""Pure-NumPy MetaImage (.mha / .mhd) reader/writer.

The reference reads these through SimpleITK
(mlagg/nnunetv2/imageio/simpleitk_reader_writer.py, supported_file_endings
:23-27 lists .mha alongside .nii.gz/.nrrd); SimpleITK is not in this
environment, and MetaIO is a simple format: an ASCII "Key = Value" header
terminated by ``ElementDataFile``, followed by raw (optionally
zlib-compressed) x-fastest binary. BTCV/AMOS distributions ship as .mha.

Data contract matches the package's NIfTI reader: images come back
(c, z, y, x) float32 — MetaIO stores x-fastest so the on-disk C-order IS
(z, y, x) — with spacing ordered (z, y, x). The original header keys are
kept in the properties so write_seg round-trips geometry.
"""
from __future__ import annotations

import os
import zlib
from typing import List, Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter

_MET_TYPES = {
    "MET_CHAR": np.int8,
    "MET_UCHAR": np.uint8,
    "MET_SHORT": np.int16,
    "MET_USHORT": np.uint16,
    "MET_INT": np.int32,
    "MET_UINT": np.uint32,
    "MET_LONG": np.int64,
    "MET_ULONG": np.uint64,
    "MET_LONG_LONG": np.int64,
    "MET_ULONG_LONG": np.uint64,
    "MET_FLOAT": np.float32,
    "MET_DOUBLE": np.float64,
}
_MET_NAMES = {np.dtype(v): k for k, v in _MET_TYPES.items()}


def read_metaimage(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (array in (z, y, x) C-order [channels last if >1], header)."""
    with open(fname, "rb") as f:
        header: dict = {}
        data_file = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"unterminated MetaImage header: {fname}")
            key, _, value = line.decode("latin-1").partition("=")
            key, value = key.strip(), value.strip()
            header[key] = value
            if key == "ElementDataFile":
                data_file = value
                break
        if data_file == "LOCAL":
            payload = f.read()
        else:
            ext = os.path.join(os.path.dirname(fname), data_file)
            with open(ext, "rb") as g:
                payload = g.read()

    ndims = int(header.get("NDims", 3))
    dim_size = [int(v) for v in header["DimSize"].split()]
    assert len(dim_size) == ndims
    dtype = np.dtype(_MET_TYPES[header.get("ElementType", "MET_UCHAR")])
    if header.get("BinaryDataByteOrderMSB", "False").lower() == "true" or \
            header.get("ElementByteOrderMSB", "False").lower() == "true":
        dtype = dtype.newbyteorder(">")
    nch = int(header.get("ElementNumberOfChannels", 1))
    if header.get("CompressedData", "False").lower() == "true":
        payload = zlib.decompress(payload)
    count = int(np.prod(dim_size)) * nch
    arr = np.frombuffer(payload, dtype=dtype, count=count)
    # MetaIO is x-fastest: C-order shape is (..., z, y, x)[, channels]
    shape = dim_size[::-1] + ([nch] if nch > 1 else [])
    if nch > 1:
        arr = arr.reshape(-1, nch).reshape(shape)
    else:
        arr = arr.reshape(shape)
    return arr, header


def write_metaimage(fname: str, data: np.ndarray, spacing_xyz,
                    extra_header: dict = None, compressed: bool = True
                    ) -> None:
    """data in (z, y, x) C-order; spacing_xyz in on-disk (x, y, z) order."""
    ndims = data.ndim
    dim_size = list(data.shape[::-1])
    extra = dict(extra_header or {})
    hdr = [
        ("ObjectType", "Image"),
        ("NDims", str(ndims)),
        ("BinaryData", "True"),
        ("BinaryDataByteOrderMSB", "False"),
        ("CompressedData", "True" if compressed else "False"),
        ("TransformMatrix", extra.get(
            "TransformMatrix",
            " ".join(str(float(v)) for v in np.eye(ndims).ravel()))),
        ("Offset", extra.get("Offset", " ".join(["0"] * ndims))),
        ("CenterOfRotation", extra.get("CenterOfRotation",
                                       " ".join(["0"] * ndims))),
        ("ElementSpacing", " ".join(str(float(s)) for s in spacing_xyz)),
        ("DimSize", " ".join(str(d) for d in dim_size)),
        ("ElementType", _MET_NAMES[np.dtype(data.dtype)]),
    ]
    if "AnatomicalOrientation" in extra:
        hdr.insert(-3, ("AnatomicalOrientation",
                        extra["AnatomicalOrientation"]))
    payload = np.ascontiguousarray(data).tobytes()
    if compressed:
        payload = zlib.compress(payload)
        hdr.append(("CompressedDataSize", str(len(payload))))
    hdr.append(("ElementDataFile", "LOCAL"))
    with open(fname, "wb") as f:
        f.write("".join(f"{k} = {v}\n" for k, v in hdr).encode("latin-1"))
        f.write(payload)


class MetaImageIO(BaseReaderWriter):
    supported_file_endings = [".mha", ".mhd"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, headers = [], [], []
        for f in image_fnames:
            data, hdr = read_metaimage(f)
            if data.ndim == 2:
                data = data[None]
            assert data.ndim == 3, (
                f"only 2d/3d supported, got {data.shape} in {f}")
            images.append(data[None].astype(np.float32))
            sp = [float(v) for v in hdr.get(
                "ElementSpacing", " ".join(["1"] * 3)).split()]
            while len(sp) < 3:
                sp.append(1.0)
            spacings.append(tuple(sp[::-1]))  # (x,y,z) -> (z,y,x)
            headers.append(hdr)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image spacings differ: {image_fnames}")
        props = {"spacing": spacings[0], "metaimage_header": headers[0]}
        return np.vstack(images), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict
                  ) -> None:
        assert seg.ndim == 3
        spacing_xyz = tuple(properties["spacing"][::-1])
        keep = {}
        src = properties.get("metaimage_header")
        if src:
            for k in ("TransformMatrix", "Offset", "CenterOfRotation",
                      "AnatomicalOrientation"):
                if k in src:
                    keep[k] = src[k]
        write_metaimage(output_fname, seg.astype(np.uint8, copy=False),
                        spacing_xyz, keep)
