"""Builds a kernel's CUDA source with ``nvcc`` and loads it with ``ctypes``.

Each kernel of the port is one ``.cu`` file with a plain C entry point.  At
first use it is compiled for ``sm_90a`` into a shared library under
``build/<name>/<hash>`` at the repository root, keyed by a hash of the
source, and loaded with ``ctypes``.  Nothing is built when a module is
imported.  :func:`build_all` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.core import errors

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    errors.fail(
        errors.ErrorClass.ERR_UNSUPPORTED_OPERATION,
        "nvcc not found (set CUDA_HOME): the CUDA kernels are built from source "
        "at first use",
    )


class Library:
    """The shared library built from one source, and its C entry point
    ``symbol`` declared with ``argtypes`` and an ``int`` (cudaError_t)
    result."""

    def __init__(self, source: Path, name: str, symbol: str, argtypes):
        self.source, self.name, self.symbol = source, name, symbol
        self.argtypes = list(argtypes)
        #: ``nvcc``'s output of the build this process made (``-Xptxas -v``).
        self.log = ""
        self._fn = None

    def build(self) -> Path:
        """Compile unless this source's build exists; returns the library's
        path."""

        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        out_dir = BUILD_ROOT / self.name / digest
        lib = out_dir / f"lib{self.symbol}.so"
        if lib.exists():
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{self.symbol}.{os.getpid()}.so"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            errors.fail(
                errors.ErrorClass.ERR_OTHER,
                f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n{self.log}",
            )
        os.replace(tmp, lib)  # atomic: another process never loads half a file
        return lib

    def entry(self):
        """The C entry point, built and loaded at the first call."""

        if self._fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def build_all(libraries) -> None:
    """Build every library, one ``nvcc`` process each, all started together."""

    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for future in [pool.submit(lib.build) for lib in libraries]:
            future.result()
