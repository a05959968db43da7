"""Host-side bitstream coding of the port, from fastvideocodec_tpu/coder:
a ctypes binding of the first-party C++ range coder (``range_coder.cc``, a
verbatim copy of the JAX package's), the net-vs-AC time split, and a small
thread pool that codes on the host while the card computes.

The card computes quantized symbols and per-symbol table indexes;
everything here is numpy on host threads, one coder call per tensor. The
library is built at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``build/coder/<sha256 of source and flags>/librangecoder.so`` under the
repository root: a changed source builds a new library. g++ writes to a
temporary name that is ``os.replace``d into place under a timeout, so a
crashed build leaves no half library; the lock is a thread lock of this
process, which nothing can leave behind. A failed build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "range_coder.cc"
LIB_NAME = "librangecoder.so"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "coder"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_TIMEOUT_S = 120

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None  # g++ wall time of this process's build


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_ROOT / digest.hexdigest()[:16] / LIB_NAME


def build(source: Path = SOURCE) -> Path:
    """Compile the range coder unless the library for this source exists."""
    global last_build_seconds
    path = library_path(source)
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(source), "-o", str(tmp)], check=True,
                       timeout=GXX_TIMEOUT_S, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed:\n{e.stdout}\n{e.stderr}") from e
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, path)
    last_build_seconds = time.perf_counter() - t0
    return path


def get_lib() -> ctypes.CDLL:
    """Build the range coder if needed, then load it and declare its functions."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p, u32p, u8p = (ctypes.POINTER(t) for t in
                               (ctypes.c_int32, ctypes.c_uint32, ctypes.c_uint8))
            lib.rc_encode_with_indexes.restype = ctypes.c_long
            lib.rc_encode_with_indexes.argtypes = [
                i32p, i32p, ctypes.c_long, u32p, ctypes.c_long, i32p, i32p, u8p, ctypes.c_long,
            ]
            lib.rc_decode_with_indexes.restype = ctypes.c_long
            lib.rc_decode_with_indexes.argtypes = [
                u8p, ctypes.c_long, i32p, ctypes.c_long, u32p, ctypes.c_long, i32p, i32p, i32p,
            ]
            _lib = lib
    return _lib


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _tables(cdfs, cdf_lengths, offsets):
    """The tables as the coder reads them, checked: cdfs [R, stride] uint32,
    lengths and offsets [R] int32."""
    cdfs = np.ascontiguousarray(cdfs, dtype=np.uint32)
    cdf_lengths, offsets = _i32(cdf_lengths), _i32(offsets)
    rows = cdfs.shape[0]
    if cdfs.ndim != 2 or cdf_lengths.shape != (rows,) or offsets.shape != (rows,):
        raise ValueError(f"tables of {cdfs.shape}, {cdf_lengths.shape}, {offsets.shape}")
    if rows and (cdf_lengths.min() < 3 or cdf_lengths.max() > cdfs.shape[1]):
        raise ValueError("cdf lengths outside [3, stride]")
    return cdfs, cdf_lengths, offsets


def _check_indexes(indexes: np.ndarray, rows: int) -> None:
    if indexes.size and (indexes.min() < 0 or indexes.max() >= rows):
        raise ValueError(f"table indexes outside [0, {rows})")


# --- AC-time accounting ------------------------------------------------------
# Every range-coder call adds its wall time to the active measure_ac_time()
# scope, so a compress/decompress path reports host coding apart from the
# rest (reference compress_slow/decompress_slow, entropy_models.py:97-148).
# The accumulator is process-global, not thread-local: AsyncCoder codes on
# pool threads, and their time lands in the scope of the dispatching thread.

_AC_ACC: dict = {"acc": None}
_ac_lock = threading.Lock()


@contextlib.contextmanager
def measure_ac_time():
    """Context manager yielding a dict whose 'seconds' accumulates the time
    spent inside the C++ range coder while the scope is active (including
    on AsyncCoder worker threads)."""
    acc = {"seconds": 0.0}
    prev = _AC_ACC["acc"]
    _AC_ACC["acc"] = acc
    try:
        yield acc
    finally:
        _AC_ACC["acc"] = prev


def _ac_tick(dt: float) -> None:
    acc = _AC_ACC["acc"]
    if acc is not None:
        with _ac_lock:
            acc["seconds"] += dt


def encode_with_indexes(symbols: np.ndarray, indexes: np.ndarray, cdfs: np.ndarray,
                        cdf_lengths: np.ndarray, offsets: np.ndarray) -> bytes:
    """symbols/indexes: int arrays of equal size, coded in their C order;
    cdfs [R, stride] uint32 cumulative tables (summing to 2^16); returns
    the bitstream."""
    lib = get_lib()
    symbols = _i32(np.ravel(symbols))
    indexes = _i32(np.ravel(indexes))
    if symbols.shape != indexes.shape:
        raise ValueError(f"{symbols.size} symbols but {indexes.size} indexes")
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    _check_indexes(indexes, cdfs.shape[0])
    n = symbols.size
    cap = max(n * 6 + 1024, 4096)
    out = np.empty(cap, dtype=np.uint8)
    t0 = time.perf_counter()
    written = lib.rc_encode_with_indexes(
        _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32), n,
        _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1], _ptr(cdf_lengths, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), _ptr(out, ctypes.c_uint8), cap,
    )
    _ac_tick(time.perf_counter() - t0)
    if written < 0:
        raise RuntimeError("range coder output buffer too small")
    return out[:written].tobytes()


def decode_with_indexes(data: bytes, indexes: np.ndarray, cdfs: np.ndarray,
                        cdf_lengths: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Inverse of encode_with_indexes; returns int32 symbols shaped like
    ``indexes``."""
    lib = get_lib()
    shape = np.shape(indexes)
    indexes = _i32(np.ravel(indexes))
    cdfs, cdf_lengths, offsets = _tables(cdfs, cdf_lengths, offsets)
    _check_indexes(indexes, cdfs.shape[0])
    n = indexes.size
    out = np.empty(n, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    t0 = time.perf_counter()
    lib.rc_decode_with_indexes(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(indexes, ctypes.c_int32), n,
        _ptr(cdfs, ctypes.c_uint32), cdfs.shape[1], _ptr(cdf_lengths, ctypes.c_int32),
        _ptr(offsets, ctypes.c_int32), _ptr(out, ctypes.c_int32),
    )
    _ac_tick(time.perf_counter() - t0)
    return out.reshape(shape)


class AsyncCoder:
    """A small host thread pool so that entropy coding overlaps the card's
    work. The coder releases the interpreter lock inside its C calls, so
    the workers code in parallel. Read every future's result: a worker's
    exception is raised there."""

    def __init__(self, workers: int = 2):
        self.pool = ThreadPoolExecutor(max_workers=workers)

    def submit(self, fn, *args, **kwargs):
        """Run any host-side codec call (e.g. LaplaceCodec.compress) off the
        dispatching thread."""
        return self.pool.submit(fn, *args, **kwargs)

    def shutdown(self):
        self.pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
