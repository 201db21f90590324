"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), at first use,
into ``mlagg_unet_torch/_build/`` (listed in ``.gitignore``). The library's
file name carries a hash of its sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``build_all`` starts one nvcc
per source, all at once, and waits for them.

Every C launcher returns ``cudaGetLastError()`` after its launch; ``Kernel``
raises on a non-zero code and counts the launches it made.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

F32, BF16 = 0, 1  # dtype codes of the C launchers


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(set CUDA_HOME or put nvcc on PATH)")


class KernelLib:
    """One CUDA source built into its own shared library."""

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC_DIR / source
        self.functions = functions  # C symbol -> ctypes argtypes
        self._lib: Optional[ctypes.CDLL] = None

    def _so_path(self) -> Path:
        h = hashlib.sha256()
        for f in [self.source, *sorted(CSRC_DIR.glob("*.cuh"))]:
            h.update(f.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:12]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; returns the
        process (or None when there is nothing to build)."""
        so = self._so_path()
        if so.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        proc.mlagg_tmp, proc.mlagg_so = tmp, so
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name}:\n{out}")
        os.replace(proc.mlagg_tmp, proc.mlagg_so)

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self._so_path()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.mlagg_error_string.argtypes = [ctypes.c_int]
            lib.mlagg_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib


class Kernel:
    """A launcher of a KernelLib, with the count of its launches."""

    def __init__(self, name: str, lib: KernelLib, symbol: str):
        self.name = name
        self.lib = lib
        self.symbol = symbol
        self.launches = 0
        ALL_KERNELS.append(self)

    def launch(self, *args) -> None:
        lib = self.lib.load()
        rc = getattr(lib, self.symbol)(*args)
        if rc != 0:
            msg = lib.mlagg_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: launch failed, CUDA error {rc} ({msg})")
        self.launches += 1


ALL_KERNELS: List[Kernel] = []


def build_all() -> float:
    """Build every kernel library, one nvcc per source started together, and
    load them. Returns the wall seconds taken."""
    t0 = time.perf_counter()
    libs = list({id(k.lib): k.lib for k in ALL_KERNELS}.values())
    procs = [lib.start_build() for lib in libs]
    try:
        for lib, proc in zip(libs, procs):
            lib.finish_build(proc)
    finally:  # a failed build leaves no other nvcc running
        for proc in procs:
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
    for lib in libs:
        lib.load()
    return time.perf_counter() - t0


def reset_launch_counts() -> None:
    for k in ALL_KERNELS:
        k.launches = 0


def use_plain(t) -> bool:
    """True for a CPU tensor (the wrapper runs its plain twin), False for a
    CUDA tensor (it launches the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"the port's kernels take CPU or CUDA tensors, got {t.device}")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor for a ctypes c_void_p (None for None)."""
    return None if t is None else t.data_ptr()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


VP = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32_ARG = ctypes.c_float
