"""ctypes binding for the native C++ IO library (native/revo_io.cpp;
counterpart of revo_tpu/io/native_loader.py).

Provides PNG decode and a threaded prefetch pipeline that replaces the
reference's IO producer thread (iowrapperRGBD.cpp:257-352).  The library is
found or built by ``io._native``; where it is unavailable
(``native_available()`` false, ``why_unavailable()`` says why) ``run``'s
dataset mode decodes with OpenCV instead.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np

from revo_tpu_torch.io import _native


def _load_lib() -> Optional[ctypes.CDLL]:
    lib = _native.load("io")
    if lib is None or getattr(lib, "_revo_bound", False):
        return lib
    lib.revo_png_info.restype = ctypes.c_int
    lib.revo_png_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.revo_load_gray.restype = ctypes.c_int
    lib.revo_load_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_load_depth16.restype = ctypes.c_int
    lib.revo_load_depth16.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_create.restype = ctypes.c_void_p
    lib.revo_prefetch_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_get.restype = ctypes.c_int
    lib.revo_prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.revo_prefetch_destroy.restype = None
    lib.revo_prefetch_destroy.argtypes = [ctypes.c_void_p]
    lib._revo_bound = True
    return lib


def native_available() -> bool:
    return _load_lib() is not None


def why_unavailable() -> Optional[str]:
    """Why the library is unavailable (None when it loaded)."""
    return _native.why_unavailable("io")


def png_info(path: str) -> Tuple[int, int, bool]:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable ({why_unavailable()})")
    w = ctypes.c_int()
    h = ctypes.c_int()
    is16 = ctypes.c_int()
    rc = lib.revo_png_info(path.encode(), w, h, is16)
    if rc != 0:
        raise IOError(f"cannot read PNG {path}")
    return w.value, h.value, bool(is16.value)


def load_gray(path: str) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable ({why_unavailable()})")
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.uint8)
    rc = lib.revo_load_gray(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"gray decode failed ({rc}): {path}")
    return out


def load_depth16(path: str) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native IO library unavailable ({why_unavailable()})")
    w, h, _ = png_info(path)
    out = np.empty((h, w), np.uint16)
    rc = lib.revo_load_depth16(path.encode(), out.ctypes.data, w, h)
    if rc != 0:
        raise IOError(f"depth decode failed ({rc}): {path}")
    return out


class NativePrefetcher:
    """Ordered multi-threaded (gray, depth) frame prefetcher.

    Usage:
        with NativePrefetcher(rgb_paths, depth_paths, (480, 640)) as pf:
            for i in range(len(rgb_paths)):
                gray_u8, depth_u16 = pf.get(i)
    """

    def __init__(
        self,
        rgb_paths: Sequence[str],
        depth_paths: Sequence[str],
        shape_hw: Tuple[int, int],
        n_threads: int = 3,
        window: int = 16,
    ):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native IO library unavailable ({why_unavailable()})")
        self._lib = lib
        self._n = len(rgb_paths)
        self._h, self._w = shape_hw
        rgb_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths]
        )
        dep_arr = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths]
        )
        self._handle = lib.revo_prefetch_create(
            rgb_arr, dep_arr, self._n, n_threads, window
        )
        if not self._handle:
            raise RuntimeError("prefetcher creation failed")

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        gray = np.empty((self._h, self._w), np.uint8)
        depth = np.empty((self._h, self._w), np.uint16)
        rc = self._lib.revo_prefetch_get(
            self._handle, idx, gray.ctypes.data, depth.ctypes.data,
            self._w, self._h,
        )
        if rc != 0:
            raise IOError(f"prefetch_get({idx}) failed ({rc})")
        return gray, depth

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.revo_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
