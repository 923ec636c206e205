"""ctypes bindings for the native C++ frame loader (csrc/frame_loader.cc).

The shared library is compiled with g++ and libpng on first use, into
``build/`` at the repository root, keyed by a hash of the source and the
flags (as ops/cuda_lib.py builds the kernels). ``get_lib()`` returns None
only when g++ or libpng's header is absent; then
``TumRgbdDataset.prefetch`` iterates the plain reader (dataio/png.py). A
build that was attempted and failed raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops.cuda_lib import BUILD_DIR

_LOCK = threading.Lock()
_LIB = None
_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "frame_loader.cc")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lpng", "-lpthread")


def toolchain() -> str | None:
    """The path of g++ when it and libpng's header are there, else None."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                           input="#include <png.h>\n", capture_output=True,
                           text=True, timeout=120)
    return gxx if probe.returncode == 0 else None


def build(gxx: str) -> str:
    """Compile the loader unless an up-to-date build exists; returns the
    shared library's path. Raises if g++ fails."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS + LIBS).encode())
    out = os.path.join(BUILD_DIR,
                       f"libframe_loader-{digest.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([gxx, *CXX_FLAGS, _SRC, "-o", tmp, *LIBS],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib():
    """Load (building if needed) the native library; None when g++ or
    libpng's header is absent."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB or None
        gxx = toolchain()
        if gxx is None:
            _LIB = False
            return None
        lib = ctypes.CDLL(build(gxx))
        lib.fl_create.restype = ctypes.c_void_p
        lib.fl_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float]
        lib.fl_next.restype = ctypes.c_int
        lib.fl_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_float)]
        lib.fl_destroy.restype = None
        lib.fl_destroy.argtypes = [ctypes.c_void_p]
        lib.fl_decode_gray.restype = ctypes.c_int
        lib.fl_decode_gray.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_float]
        _LIB = lib
        return lib


class NativeSequenceLoader:
    """In-order threaded prefetch over a list of PNG paths."""

    def __init__(self, paths: list[str], height: int, width: int,
                 n_threads: int = 4, is_depth: bool = False,
                 depth_factor: float = 5000.0):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native loader unavailable: no g++ or no "
                               "libpng header")
        self._lib = lib
        self.height, self.width = height, width
        arr = (ctypes.c_char_p * len(paths))(
            *[p.encode() for p in paths])
        self._paths_keepalive = arr
        self._h = lib.fl_create(arr, len(paths), height, width, n_threads,
                                int(is_depth), float(depth_factor))
        self.n = len(paths)
        self._emitted = 0

    def next(self) -> np.ndarray | None:
        if self._emitted >= self.n:
            return None
        out = np.empty((self.height, self.width), np.float32)
        idx = self._lib.fl_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if idx < 0:
            return None
        self._emitted += 1
        return out

    def close(self):
        if getattr(self, "_h", None):
            self._lib.fl_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def decode_gray(path: str, height: int, width: int, is_depth: bool = False,
                depth_factor: float = 5000.0) -> np.ndarray | None:
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((height, width), np.float32)
    rc = lib.fl_decode_gray(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        height, width, int(is_depth), float(depth_factor))
    return out if rc == 0 else None
