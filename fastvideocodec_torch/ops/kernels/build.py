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
    "-Xptxas", "-v",  # each kernel's registers, shared memory and spills, into LOG_NAME
)
LOG_NAME = "nvcc.log"
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


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build_log(source: Path = SOURCE) -> str:
    """What nvcc printed when it built source's library (ptxas's report of
    each kernel), or "" before the build."""
    log = library_path(source).with_name(LOG_NAME)
    return log.read_text() if log.exists() else ""


def build(source: Path = SOURCE) -> Path:
    """Compile source (warp.cu, or another version of it with the same C
    interface) unless the library for this source and flags exists."""
    global last_build_seconds
    path = library_path(source)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{LIB_NAME}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        done = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
            check=True, timeout=NVCC_TIMEOUT_S, capture_output=True, text=True,
        )
        path.with_name(LOG_NAME).write_text(done.stdout + done.stderr)
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
    """Build warp.cu if needed, then load the library and declare its functions."""
    global _lib
    if _lib is None:
        _lib = open_library(build())
    return _lib


def open_library(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its functions."""
    lib = ctypes.CDLL(str(path))
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
    for fn in (lib.fvc_pixel_warp, lib.fvc_pixel_warp_small):
        fn.argtypes = [*pixel, ctypes.c_int, ctypes.c_void_p]  # dtype, stream
    lib.fvc_pixel_warp_s2d.argtypes = [
        *pixel, ctypes.c_int, ctypes.c_int, ctypes.c_void_p  # phase_flow, dtype, stream
    ]
    for fn in (lib.fvc_pixel_warp, lib.fvc_pixel_warp_small, lib.fvc_pixel_warp_s2d):
        fn.restype = ctypes.c_int
    lib.fvc_flow_warp_backward.argtypes = [
        *args[:2], ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # grad, grad_img, grad_flow
        *args[3:9], ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # B..norm_y, s2d, dtype, stream
    ]
    lib.fvc_flow_warp_backward.restype = ctypes.c_int
    # absent from the sources before the pixel warps' backward: warp_ab.py
    # opens older versions too
    pixel_backward = getattr(lib, "fvc_pixel_warp_backward", None)
    if pixel_backward is not None:
        pixel_backward.argtypes = [
            *args[:2], ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # grad, grads out
            *args[3:7], ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # B..W, layout, dtype, stream
        ]
        pixel_backward.restype = ctypes.c_int
    floor = getattr(lib, "fvc_backward_floor", None)  # absent before the backward plan
    if floor is not None:
        floor.argtypes = [*args[3:7], ctypes.c_int, ctypes.c_void_p]  # B, C, H, W, s2d, stream
        floor.restype = ctypes.c_int
    return lib
