"""Builds a kernel's CUDA source with ``nvcc`` and loads it with ``ctypes``.

Each kernel of the port is one ``.cu`` file with plain C entry points.  At
first use it is compiled for ``sm_90a`` into a shared library under
``build/<name>/<hash>`` at the repository root, keyed by a hash of the
source, of every header it includes from the repository, and of
:data:`NVCC_FLAGS`, and loaded with ``ctypes``.  Nothing is
built when a module is imported.  :func:`build_all` starts one ``nvcc`` per
source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from repro_torch.core import errors

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build"
# nvcc's default floating point: IEEE division and square root, denormals
# kept.  The quant kernel's bit-exactness against its plain version rests on
# that: no --use_fast_math, -prec-div=false or -ftz=true here.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


def included_files(source: Path) -> list[Path]:
    """``source`` and every file it ``#include "..."``s, directly or
    through another, resolved beside the including file as ``nvcc`` does;
    names that resolve to no file there are the toolkit's and are left out."""

    found: list[Path] = []
    todo = [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        for name in _INCLUDE.findall(path.read_text()):
            inc = (path.parent / name).resolve()
            if inc.is_file():
                todo.append(inc)
    return found


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


def toolkit_binary(name: str) -> Path:
    """A program of the CUDA toolkit that ``nvcc`` belongs to (``cuobjdump``)."""

    return Path(_nvcc()).parent / name


class Library:
    """The shared library built from one source, and its C entry points:
    ``entries`` maps each symbol to its ``argtypes``; every entry returns an
    ``int`` (cudaError_t)."""

    def __init__(self, source: Path, name: str, entries: dict[str, list]):
        self.source, self.name = source, name
        self.entries = {symbol: list(argtypes) for symbol, argtypes in entries.items()}
        #: ``nvcc``'s output of the build this process made (``-Xptxas -v``).
        self.log = ""
        self._fns: dict = {}

    def out_dir(self) -> Path:
        """``build/<name>/<hash>``: the hash covers the source, the headers
        it includes (:func:`included_files`) and the flags, so a change of
        any of them builds anew."""

        h = hashlib.sha256()
        for path in included_files(self.source):
            h.update(path.read_bytes())
        h.update("\0".join(NVCC_FLAGS).encode())
        return BUILD_ROOT / self.name / h.hexdigest()[:16]

    def build(self, force: bool = False) -> Path:
        """Compile unless this source's build exists (or ``force``); returns
        the library's path."""

        out_dir = self.out_dir()
        lib = out_dir / f"lib{self.name}.so"
        if lib.exists() and not force:
            return lib
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".lib{self.name}.{os.getpid()}.so"
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

    def entry(self, symbol: str):
        """The C entry point ``symbol``, built and loaded at the first call."""

        fn = self._fns.get(symbol)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(self.build())), symbol)
            fn.argtypes = self.entries[symbol]
            fn.restype = ctypes.c_int
            self._fns[symbol] = fn
        return fn


def build_all(libraries, force: bool = False) -> None:
    """Build every library, one ``nvcc`` process each, all started together."""

    libraries = list(libraries)
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        for future in [pool.submit(lib.build, force) for lib in libraries]:
            future.result()
