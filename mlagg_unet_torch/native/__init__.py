"""The host's native resampler (``csrc/resample.cpp``, OpenMP C++).

Copied from ``mlagg_unet_tpu/native/__init__.py``: the spline resize that
preprocessing and prediction export run through ``_resize``, with scipy's
``map_coordinates`` as the ground truth and the path taken when
``MLAGG_DISABLE_NATIVE`` is set or the request is one the library does not
cover (an order outside {0, 1, 3}, an array that is not 2D or 3D).

The port's ``resample.cpp`` gives the JAX package's results bit for bit
with less work in the order-3 prefilter (see its header). Two differences
from the JAX loader:

- the library is built at first use into ``mlagg_unet_torch/_build/``
  (listed in ``.gitignore``) under a name that carries a hash of the source,
  the flags and the host's CPU (``-march=native``), compiled to a temporary
  name and moved into place with ``os.replace``, so processes that build at
  once never load a half-written file and nothing is written under ``csrc/``;
- a build or load that fails raises, with the compiler's stderr, instead of
  falling back to scipy quietly.

``MLAGG_DISABLE_NATIVE`` is read at each call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = PKG_DIR / "csrc" / "resample.cpp"
BUILD_DIR = PKG_DIR / "_build"
CXX = "g++"
# the JAX loader's flags; without OpenMP if the first set fails
FLAG_SETS = (["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-fopenmp"],
             ["-O3", "-ffp-contract=off", "-shared", "-fPIC"])

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _host_cpu() -> bytes:
    """The CPU's model and flags, which ``-march=native`` compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags", "Features"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        import platform

        return platform.processor().encode()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr((CXX, FLAG_SETS)).encode())
    h.update(_host_cpu())
    return BUILD_DIR / f"resample-{h.hexdigest()[:12]}.so"


def build() -> Path:
    """The library's path, compiled first unless it exists. Raises with each
    attempt's stderr when the compiler fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    errors: List[str] = []
    for flags in FLAG_SETS:
        cmd = [CXX, *flags, str(SOURCE), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            errors.append(f"$ {' '.join(cmd)}\n{e}")
            continue
        if proc.returncode == 0:
            os.replace(tmp, so)
            return so
        errors.append(f"$ {' '.join(cmd)}\n{proc.stderr}")
    if tmp.exists():
        tmp.unlink()
    raise RuntimeError("building the native resampler failed:\n" + "\n".join(errors))


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.resample3d.restype = ctypes.c_int
            lib.resample3d.argtypes = [
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int,
            ]
            _lib = lib
        return _lib


def native_resize(data: np.ndarray, new_shape, order: int) -> Optional[np.ndarray]:
    """2D/3D resize with the pixel-center mapping. Returns None when
    ``MLAGG_DISABLE_NATIVE`` is set or the request is unsupported (the
    caller then takes scipy)."""
    if order not in (0, 1, 3) or os.environ.get("MLAGG_DISABLE_NATIVE"):
        return None
    src = np.ascontiguousarray(data, dtype=np.float64)
    if src.ndim == 2:
        src3 = src[None]
        out_shape3 = (1, *new_shape)
    elif src.ndim == 3:
        src3 = src
        out_shape3 = tuple(new_shape)
    else:
        return None
    lib = get_lib()
    out = np.empty(out_shape3, np.float64)
    rc = lib.resample3d(
        src3.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        src3.shape[0], src3.shape[1], src3.shape[2],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.shape[0], out.shape[1], out.shape[2],
        int(order),
    )
    if rc != 0:
        raise RuntimeError(f"resample3d returned {rc}")
    return out[0] if data.ndim == 2 else out
