"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` file with a plain C interface. At its
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared
library and loaded with ctypes. Libraries are cached in
``densephrases_tpu_torch/_build/`` under the hash of their source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.
Nothing is compiled when a module is imported; a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build "
                           "the port's kernels)")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


class CudaKernel:
    """One kernel's shared library, built on first use, plus its launch count.

    ``launches`` counts the launches that went through ``launch``; callers
    may reset it to 0 to count the launches of one run."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds: Optional[float] = None  # None: loaded from cache
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        headers = b"".join(h.read_bytes()
                           for h in sorted(CSRC_DIR.glob("*.cuh")))
        digest = hashlib.sha256(
            self.source.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{digest}.so"

    def build(self) -> Path:
        """Compile the source unless a library of the same hash exists."""
        out = self.library_path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.build_seconds = time.perf_counter() - t0
        self.build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed to build {self.source.name} "
                f"(exit {proc.returncode}):\n{self.build_log}")
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        return out

    def function(self):
        """The kernel's C entry point, building the library first if needed."""
        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; it returns ``cudaGetLastError()``."""
        err = self.function()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed with CUDA "
                               f"error {err}")
        self.launches += 1
