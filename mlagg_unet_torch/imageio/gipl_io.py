"""Pure-NumPy GIPL (Guys Image Processing Lab) reader/writer.

The reference reads .gipl through SimpleITK
(mlagg/nnunetv2/imageio/simpleitk_reader_writer.py:23-27, file-ending list
in the registry). GIPL is a fixed 256-byte big-endian header followed by
raw big-endian voxel data, x-fastest (layout per ITK's itkGIPLImageIO):

  offset size  field
  0      8     uint16 dims[4]        (x, y, z, t)
  8      2     uint16 image_type
  10     16    float32 pixdim[4]     (voxel size x, y, z, t)
  26     80    char line1[80]
  106    80    float32 matrix[20]
  186    1     uint8 flag1
  187    1     uint8 flag2
  188    8     float64 min
  196    8     float64 max
  204    32    float64 origin[4]
  236    4     float32 pixval_offset
  240    4     float32 pixval_cal
  244    4     float32 interslicegap
  248    4     float32 user_def2
  252    4     uint32 magic = 0xEFFFE9B0

Per-axis data contract identical to MetaImageIO/NrrdIO: (c, z, y, x)
float32 with (z, y, x) spacing.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

from mlagg_unet_torch.imageio.base_reader_writer import BaseReaderWriter

_GIPL_MAGIC = 0xEFFFE9B0
# some historic writers used this alternate magic
_GIPL_MAGIC_EXT = 0x2AE389B8

_GIPL_TYPES = {
    1: np.uint8,      # binary (bit-per-voxel never used in practice; ITK
                      # reads it as uchar 0/1)
    7: np.int8,
    8: np.uint8,
    15: np.int16,
    16: np.uint16,
    31: np.uint32,
    32: np.int32,
    64: np.float32,
    65: np.float64,
}
_GIPL_CODES = {np.dtype(v).str[1:]: k for k, v in _GIPL_TYPES.items()
               if k != 1}


def read_gipl(fname: str) -> Tuple[np.ndarray, dict]:
    """Returns (array in (z, y, x) C-order (t folded out), header dict)."""
    with open(fname, "rb") as f:
        hdr = f.read(256)
        if len(hdr) < 256:
            raise ValueError(f"truncated GIPL header: {fname}")
        magic = struct.unpack(">I", hdr[252:256])[0]
        if magic not in (_GIPL_MAGIC, _GIPL_MAGIC_EXT):
            raise ValueError(f"not a GIPL file (bad magic): {fname}")
        dims = struct.unpack(">4H", hdr[0:8])
        image_type = struct.unpack(">H", hdr[8:10])[0]
        pixdim = struct.unpack(">4f", hdr[10:26])
        origin = struct.unpack(">4d", hdr[204:236])
        if image_type not in _GIPL_TYPES:
            raise NotImplementedError(
                f"GIPL image type {image_type} not supported")
        dtype = np.dtype(_GIPL_TYPES[image_type]).newbyteorder(">")
        nx, ny, nz, nt = [max(1, d) for d in dims]
        count = nx * ny * nz * nt
        arr = np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                            count=count)
    # x-fastest on disk -> numpy (t, z, y, x); fold a singleton t away
    arr = arr.reshape((nt, nz, ny, nx))
    if nt == 1:
        arr = arr[0]
    header = {
        "dims": dims,
        "image_type": image_type,
        "pixdim": pixdim,          # (x, y, z, t) voxel sizes
        "origin": origin,
    }
    return arr, header


def write_gipl(fname: str, data: np.ndarray, spacing_xyz,
               origin_xyz=None) -> None:
    """data in (z, y, x) C-order; spacing_xyz in on-disk (x, y, z) order."""
    assert data.ndim == 3, f"GIPL writer expects 3d, got {data.shape}"
    code = _GIPL_CODES.get(data.dtype.str[1:])
    if code is None:
        raise NotImplementedError(f"GIPL cannot store dtype {data.dtype}")
    nz, ny, nx = data.shape
    sx, sy, sz = [float(s) for s in spacing_xyz]
    ox, oy, oz = [float(o) for o in (origin_xyz or (0.0, 0.0, 0.0))]
    hdr = bytearray(256)
    struct.pack_into(">4H", hdr, 0, nx, ny, nz, 1)
    struct.pack_into(">H", hdr, 8, code)
    struct.pack_into(">4f", hdr, 10, sx, sy, sz, 1.0)
    struct.pack_into(">80s", hdr, 26, b"written by mlagg_unet_torch")
    # matrix[20] left zero; flags zero
    struct.pack_into(">d", hdr, 188, float(data.min()))
    struct.pack_into(">d", hdr, 196, float(data.max()))
    struct.pack_into(">4d", hdr, 204, ox, oy, oz, 0.0)
    struct.pack_into(">f", hdr, 240, 1.0)  # pixval_cal
    struct.pack_into(">I", hdr, 252, _GIPL_MAGIC)
    with open(fname, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(
            data.astype(data.dtype.newbyteorder(">"), copy=False)).tobytes())


class GiplIO(BaseReaderWriter):
    supported_file_endings = [".gipl"]

    def read_images(self, image_fnames) -> Tuple[np.ndarray, dict]:
        images, spacings, headers = [], [], []
        for f in image_fnames:
            data, hdr = read_gipl(f)
            if data.ndim == 2:
                data = data[None]
            assert data.ndim == 3, (
                f"only 2d/3d supported, got {data.shape} in {f}")
            images.append(data[None].astype(np.float32))
            sp = [float(v) if v else 1.0 for v in hdr["pixdim"][:3]]
            spacings.append((sp[2], sp[1], sp[0]))  # (x,y,z) -> (z,y,x)
            headers.append(hdr)
        if not self._check_all_same([i.shape for i in images]):
            raise RuntimeError(f"image shapes differ: {image_fnames}")
        if not self._check_all_same(spacings):
            raise RuntimeError(f"image spacings differ: {image_fnames}")
        props = {"spacing": spacings[0], "gipl_header": headers[0]}
        return np.vstack(images), props

    def read_seg(self, seg_fname: str) -> Tuple[np.ndarray, dict]:
        return self.read_images([seg_fname])

    def write_seg(self, seg: np.ndarray, output_fname: str, properties: dict
                  ) -> None:
        assert seg.ndim == 3
        spacing_xyz = tuple(properties["spacing"][::-1])
        origin = None
        src = properties.get("gipl_header")
        if src:
            origin = src["origin"][:3]
        write_gipl(output_fname, seg.astype(np.uint8, copy=False),
                   spacing_xyz, origin)
