"""ctypes bindings for the native store runtime (C++, host code).

Host copy of ``densephrases_tpu/native/__init__.py``: the port never
imports the JAX package, whose ``__init__`` imports jax. Keep the two in
step. Two changes: the library is built into ``densephrases_tpu_torch/
_build/`` (git-ignored, beside the CUDA kernels' libraries) under the hash
of its source and flags, not next to its source; and it is built without
``-march=native``, because a ``_build/`` directory may be copied to
another machine with the checkout.

It builds ``libdpstore`` from ``src/store_native.cpp`` on first use (g++
-O3, zlib, pthreads) and exposes:

- ``gather_rows(matrix, indices)`` — threaded row gather (HDF5-read role)
- ``compress_batch / decompress_batch`` — parallel zlib over many buffers
  (blosc role, ref: compress_metadata.py:45-53 / index.py:106-122)
- ``write_bytes / read_bytes`` — chunked sequential file IO

Every entry point has a plain numpy/zlib route for a machine with no
compiler; a failed build is logged at warning level and ``available()``
reports which route is active.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
import zlib
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "src" / "store_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
GXX_LIBS = ("-lz", "-pthread")
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_load_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(
        GXX_FLAGS + GXX_LIBS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdpstore-{digest}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp), *GXX_LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        err = getattr(e, "stderr", b"") or b""
        logger.warning("native build failed (%s %s); using the numpy/zlib "
                       "route", e, err.decode(errors="replace")[-500:])
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)  # concurrent builds each publish a whole file
    return True


def _load() -> Optional[ctypes.CDLL]:
    with _load_lock:  # one build a process: threads share its temp name
        return _load_locked()


def _load_locked() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    path = library_path()
    if not path.exists() and not _build(path):
        _build_failed = True
        return None
    lib = ctypes.CDLL(str(path))
    lib.dp_gather_rows.restype = ctypes.c_int
    lib.dp_gather_rows.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.dp_zlib_compress_batch.restype = ctypes.c_int
    lib.dp_zlib_compress_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.dp_zlib_decompress_batch.restype = ctypes.c_int
    lib.dp_zlib_decompress_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.dp_write_file.restype = ctypes.c_int64
    lib.dp_write_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    lib.dp_read_file.restype = ctypes.c_int64
    lib.dp_read_file.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int64]
    lib.dp_num_threads.restype = ctypes.c_int
    lib.dp_num_threads.argtypes = []
    _lib = lib
    logger.info("native store runtime loaded (%d threads)",
                lib.dp_num_threads())
    return _lib


def available() -> bool:
    return _load() is not None


def gather_rows(matrix: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Gather rows (int8 matrix) into a fresh contiguous array."""
    assert matrix.dtype == np.int8 and matrix.ndim == 2
    idx = np.ascontiguousarray(indices.reshape(-1), np.int64)
    out_shape = indices.shape + (matrix.shape[1],)
    lib = _load()
    if lib is None:
        return matrix[np.clip(idx, 0, matrix.shape[0] - 1)].reshape(out_shape)
    out = np.empty((idx.size, matrix.shape[1]), np.int8)
    lib.dp_gather_rows(
        matrix.ctypes.data_as(ctypes.c_void_p), matrix.shape[0],
        matrix.shape[1], idx.ctypes.data_as(ctypes.c_void_p), idx.size,
        out.ctypes.data_as(ctypes.c_void_p))
    return out.reshape(out_shape)


def compress_batch(buffers: List[bytes], level: int = 6) -> List[bytes]:
    lib = _load()
    if lib is None or not buffers:
        return [zlib.compress(b, level) for b in buffers]
    concat = np.frombuffer(b"".join(buffers), np.uint8)
    offsets = np.zeros(len(buffers) + 1, np.int64)
    np.cumsum([len(b) for b in buffers], out=offsets[1:])
    max_in = int(max(len(b) for b in buffers))
    out_cap = max_in + max_in // 1000 + 64  # zlib worst case bound
    out = np.empty(len(buffers) * out_cap, np.uint8)
    sizes = np.empty(len(buffers), np.int64)
    rc = lib.dp_zlib_compress_batch(
        concat.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p), len(buffers),
        out.ctypes.data_as(ctypes.c_void_p), out_cap,
        sizes.ctypes.data_as(ctypes.c_void_p), level)
    if rc != 0:
        return [zlib.compress(b, level) for b in buffers]
    return [out[i * out_cap: i * out_cap + int(sizes[i])].tobytes()
            for i in range(len(buffers))]


def decompress_batch(buffers: List[bytes], out_sizes: List[int]) -> List[bytes]:
    """Decompress buffers whose original sizes are known."""
    lib = _load()
    if lib is None or not buffers:
        return [zlib.decompress(b) for b in buffers]
    concat = np.frombuffer(b"".join(buffers), np.uint8)
    in_off = np.zeros(len(buffers) + 1, np.int64)
    np.cumsum([len(b) for b in buffers], out=in_off[1:])
    out_off = np.zeros(len(buffers) + 1, np.int64)
    np.cumsum(out_sizes, out=out_off[1:])
    out = np.empty(int(out_off[-1]), np.uint8)
    rc = lib.dp_zlib_decompress_batch(
        concat.ctypes.data_as(ctypes.c_void_p),
        in_off.ctypes.data_as(ctypes.c_void_p), len(buffers),
        out.ctypes.data_as(ctypes.c_void_p),
        out_off.ctypes.data_as(ctypes.c_void_p))
    if rc != 0:
        return [zlib.decompress(b) for b in buffers]
    return [out[int(out_off[i]):int(out_off[i + 1])].tobytes()
            for i in range(len(buffers))]


def write_bytes(path: str, data: np.ndarray) -> int:
    lib = _load()
    data = np.ascontiguousarray(data).view(np.uint8).reshape(-1)
    if lib is None:
        with open(path, "wb") as f:
            f.write(data.tobytes())
        return data.size
    return int(lib.dp_write_file(path.encode(), data.ctypes.data_as(
        ctypes.c_void_p), data.size))


def read_bytes(path: str, n: int) -> np.ndarray:
    lib = _load()
    out = np.empty(n, np.uint8)
    if lib is None:
        with open(path, "rb") as f:
            return np.frombuffer(f.read(n), np.uint8).copy()
    got = int(lib.dp_read_file(path.encode(),
                               out.ctypes.data_as(ctypes.c_void_p), n))
    return out[:got]
