"""ctypes bridge to the host window gather (``csrc/window_gather.c``).

Counterpart of ``ae_wavenet_tpu.data.native``.  The library is built with
the system C compiler (``$CC``, else ``cc``) at first use into
``ae_wavenet_tpu_torch/_build/``, cached under a hash of the source and the
flags.  A failed build raises: there is no quiet numpy fallback (the numpy
slice, :func:`gather_windows_numpy`, is the plain version the tests hold
the library to).  ctypes releases the GIL during the C call, so the
loader's producer thread overlaps the device's work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "window_gather.c"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: ctypes.CDLL | None = None


def _cc() -> str:
    cc = os.environ.get("CC") or shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        raise RuntimeError("no C compiler found for csrc/window_gather.c (set CC or "
                           "put cc on PATH)")
    return cc


def load() -> ctypes.CDLL:
    """The compiled library (built if the cache is stale)."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(CC_FLAGS).encode() + SOURCE.read_bytes())
    out = BUILD_DIR / f"libwindow_gather_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        r = subprocess.run([_cc(), *CC_FLAGS, "-o", tmp, str(SOURCE), "-lm"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {SOURCE.name} failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builders agree on the file
    lib = ctypes.CDLL(str(out))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.gather_windows_i16.argtypes = [p, p, i64, i64, p]
    lib.gather_windows_i16.restype = None
    lib.mu_encode_i16.argtypes = [p, i64, p]
    lib.mu_encode_i16.restype = None
    _lib = lib
    return _lib


def _check(data: np.ndarray, offsets: np.ndarray, w: int) -> None:
    if data.dtype != np.dtype("<i2") or data.ndim != 1:
        raise TypeError(f"packed data must be 1-D int16, got {data.dtype} "
                        f"{data.shape}")
    if len(offsets) and (offsets.min() < 0 or offsets.max() + w > data.size):
        raise IndexError("window offsets out of bounds for packed data")


def gather_windows(data: np.ndarray, offsets: np.ndarray, w: int) -> np.ndarray:
    """data: packed int16 (a memmap is fine); offsets: [n] int -> [n, w]
    int16, row i = data[offsets[i] : offsets[i] + w]."""
    offs = np.ascontiguousarray(offsets, np.int64)
    _check(data, offs, w)
    out = np.empty((len(offs), w), np.int16)
    if len(offs):
        load().gather_windows_i16(np.ascontiguousarray(data).ctypes.data,
                                  offs.ctypes.data, len(offs), w, out.ctypes.data)
    return out


def gather_windows_numpy(data: np.ndarray, offsets: np.ndarray, w: int) -> np.ndarray:
    """The plain version of :func:`gather_windows`: one numpy slice a row."""
    offs = np.asarray(offsets, np.int64)
    _check(data, offs, w)
    out = np.empty((len(offs), w), np.int16)
    for i, o in enumerate(offs):
        out[i] = data[o : o + w]
    return out


def mu_encode_host(x: np.ndarray) -> np.ndarray:
    """int16 PCM -> uint8 mu-law ids (256 classes) on the host."""
    x = np.ascontiguousarray(x, np.int16)
    out = np.empty(x.shape, np.uint8)
    load().mu_encode_i16(x.ctypes.data, x.size, out.ctypes.data)
    return out
