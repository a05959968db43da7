"""Build the CUDA kernels with nvcc into a shared library and load it with ctypes.

The library has a plain C interface (no PyTorch headers), so one nvcc call
takes seconds. It lands in ``build/kernels/<sha256 of source and flags>/``
under the repository root: a changed source or flag builds a new library,
an unchanged one is reused. nvcc writes to a temporary name that is then
``os.replace``d into place, so a crashed build leaves no half library and
no lock. The build runs at first use, from the launching wrapper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "warp.cu"
LIB_NAME = "libfvc_warp.so"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
NVCC_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # nvcc wall time of this process's build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile warp.cu unless the library for this source and flags exists."""
    global last_build_seconds
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
            check=True, timeout=NVCC_TIMEOUT_S, capture_output=True, text=True,
        )
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{e.stdout}\n{e.stderr}") from e
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)
    last_build_seconds = time.perf_counter() - t0
    return path


def load() -> ctypes.CDLL:
    """Build if needed, then load the library and declare its functions."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    args = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # img, flow, out
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, C, H, W
        ctypes.c_float, ctypes.c_float,  # norm_x, norm_y
        ctypes.c_int,  # dtype
        ctypes.c_void_p,  # stream
    ]
    for fn in (lib.fvc_flow_warp, lib.fvc_flow_warp_s2d):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    pixel = args[:7]  # img, flow, out, B, C, H (or Hs), W (or Ws)
    lib.fvc_pixel_warp.argtypes = [*pixel, ctypes.c_int, ctypes.c_void_p]  # dtype, stream
    lib.fvc_pixel_warp_s2d.argtypes = [
        *pixel, ctypes.c_int, ctypes.c_int, ctypes.c_void_p  # phase_flow, dtype, stream
    ]
    for fn in (lib.fvc_pixel_warp, lib.fvc_pixel_warp_s2d):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
