"""Pure-NumPy NRRD reader/writer.

The reference reads .nrrd through SimpleITK
(mlagg/nnunetv2/imageio/simpleitk_reader_writer.py:23-27); NRRD is an ASCII
"field: value" header (magic NRRD000N) followed by raw or gzip data,
x-fastest. Covers the fields medical segmentation archives actually use
(type/dimension/sizes/encoding/endian/space directions/space origin/
spacings); per-axis data contract identical to MetaImageIO: (c, z, y, x)
float32 with (z, y, x) spacing.
"""
from __future__ import annotations

import gzip
import io
from typing import Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter

_NRRD_TYPES = {
    "signed char": np.int8, "int8": np.int8, "int8_t": np.int8,
    "uchar": np.uint8, "unsigned char": np.uint8, "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16, "signed short": np.int16, "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16, "unsigned short": np.uint16, "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32, "signed int": np.int32, "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32, "unsigned int": np.uint32, "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64, "long long": np.int64, "int64": np.int64,
    "int64_t": np.int64,
    "ulonglong": np.uint64, "unsigned long long": np.uint64,
    "uint64": np.uint64, "uint64_t": np.uint64,
    "float": np.float32, "double": np.float64,
}
_NRRD_NAMES = {np.uint8: "uint8", np.int8: "int8", np.int16: "int16",
               np.uint16: "uint16", np.int32: "int32", np.uint32: "uint32",
               np.int64: "int64", np.uint64: "uint64",
               np.float32: "float", np.float64: "double"}


def _parse_vector_list(value: str):
    """'(a,b,c) (d,e,f) none' -> list of float-lists / None entries."""
    out = []
    for tok in value.replace(") (", ")|(").replace(") none", ")|none"
                                                   ).split("|"):
        tok = tok.strip()
        if tok == "none":
            out.append(None)
        else:
            out.append([float(v) for v in tok.strip("()").split(",")])
    return out


def read_nrrd(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (array in (z, y, x) C-order, header dict)."""
    with open(fname, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"not a NRRD file: {fname}")
        header: dict = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("latin-1").rstrip("\r\n")
            if text.startswith("#"):
                continue
            if ":=" in text:
                k, v = text.split(":=", 1)
            else:
                k, v = text.split(":", 1)
            header[k.strip().lower()] = v.strip()
        payload = f.read()

    if "data file" in header or "datafile" in header:
        raise NotImplementedError("detached NRRD data files not supported")
    dtype = np.dtype(_NRRD_TYPES[header["type"]])
    if dtype.itemsize > 1:
        endian = header.get("endian", "little")
        dtype = dtype.newbyteorder("<" if endian == "little" else ">")
    sizes = [int(v) for v in header["sizes"].split()]
    enc = header.get("encoding", "raw").lower()
    if enc in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif enc != "raw":
        raise NotImplementedError(f"NRRD encoding {enc!r} not supported")
    arr = np.frombuffer(payload, dtype=dtype, count=int(np.prod(sizes)))
    return arr.reshape(sizes[::-1]), header  # x-fastest -> (z, y, x)


def _spacing_xyz_from_header(header: dict, ndim: int):
    if "space directions" in header:
        dirs = _parse_vector_list(header["space directions"])
        sp = [float(np.linalg.norm(d)) for d in dirs if d is not None]
        if len(sp) == ndim:
            return sp
    if "spacings" in header:
        return [float(v) for v in header["spacings"].split()][:ndim]
    return [1.0] * ndim


def write_nrrd(fname: str, data: np.ndarray, spacing_xyz,
               extra_header: dict = None, compressed: bool = True) -> None:
    """data in (z, y, x) C-order; spacing_xyz in on-disk (x, y, z) order."""
    ndim = data.ndim
    extra = dict(extra_header or {})
    space = extra.get("space", "left-posterior-superior")
    dirs = extra.get("space directions")
    if dirs is None:
        dirs = " ".join(
            "(" + ",".join(str(float(s) if i == j else 0.0)
                           for i in range(ndim)) + ")"
            for j, s in enumerate(spacing_xyz))
    lines = [
        "NRRD0004",
        "# written by mlagg_unet_torch",
        f"type: {_NRRD_NAMES[data.dtype.type]}",
        f"dimension: {ndim}",
        f"space: {space}",
        f"sizes: {' '.join(str(s) for s in data.shape[::-1])}",
        f"space directions: {dirs}",
        "kinds: " + " ".join(["domain"] * ndim),
        "endian: little",
        f"encoding: {'gzip' if compressed else 'raw'}",
        f"space origin: {extra.get('space origin', '(0,' * (ndim - 1) + '0)')}",
    ]
    payload = np.ascontiguousarray(
        data.astype(data.dtype.newbyteorder("<"), copy=False)).tobytes()
    if compressed:
        buf = io.BytesIO()
        with gzip.GzipFile(fileobj=buf, mode="wb", mtime=0) as g:
            g.write(payload)
        payload = buf.getvalue()
    with open(fname, "wb") as f:
        f.write(("\n".join(lines) + "\n\n").encode("latin-1"))
        f.write(payload)


class NrrdIO(BaseReaderWriter):
    supported_file_endings = [".nrrd"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, headers = [], [], []
        for f in image_fnames:
            data, hdr = read_nrrd(f)
            if data.ndim == 2:
                data = data[None]
            assert data.ndim == 3, (
                f"only 2d/3d supported, got {data.shape} in {f}")
            images.append(data[None].astype(np.float32))
            sp = _spacing_xyz_from_header(hdr, data.ndim)
            while len(sp) < 3:
                sp.append(1.0)
            spacings.append(tuple(sp[::-1]))
            headers.append(hdr)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image spacings differ: {image_fnames}")
        props = {"spacing": spacings[0], "nrrd_header": headers[0]}
        return np.vstack(images), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict
                  ) -> None:
        assert seg.ndim == 3
        spacing_xyz = tuple(properties["spacing"][::-1])
        keep = {}
        src = properties.get("nrrd_header")
        if src:
            for k in ("space", "space directions", "space origin"):
                if k in src:
                    keep[k] = src[k]
        write_nrrd(output_fname, seg.astype(np.uint8, copy=False),
                   spacing_xyz, keep)
