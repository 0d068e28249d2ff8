"""Build the package's CUDA sources into one shared library, at first use.

``csrc/*.cu`` are compiled with ``nvcc`` for ``sm_90a`` into a library with
a plain C interface, loaded with ``ctypes``.  The build is cached in
``_build/`` under a hash of the sources and flags, so only the first CUDA
call after a change compiles.  Nothing is fetched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib: ctypes.CDLL | None = None
build_info: dict = {}  # path, ptxas report (and nvcc seconds when built here)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    nvcc = cand if cand and os.path.exists(cand) else shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ip = ctypes.POINTER(ctypes.c_int)
    lib.awt_fastgen_bf16.argtypes = [p] * 15 + [ip, ip] + [i] * 11 + [f, i, p]
    lib.awt_fastgen_bf16.restype = i
    lib.awt_cuda_error_string.argtypes = [i]
    lib.awt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The compiled kernel library (builds it if the cache is stale)."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    out = BUILD_DIR / f"libawt_kernels_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp,
                            *map(str, sources)], capture_output=True, text=True)
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
        build_info["seconds"] = time.perf_counter() - t0
        out.with_suffix(".ptxas.txt").write_text(r.stderr)
        os.replace(tmp, out)  # atomic: concurrent builders agree on the file
    build_info["path"] = str(out)
    build_info["ptxas"] = out.with_suffix(".ptxas.txt").read_text()
    _lib = _declare(ctypes.CDLL(str(out)))
    return _lib
