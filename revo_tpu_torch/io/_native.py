"""Find, build and load the host-side native libraries (``native/*.cpp``).

Three ctypes bindings share this loader: ``native_loader`` (PNG decode and
prefetch, ``librevo_io.so``), ``sensors`` (the V4L2 engine and its replay
shim, ``librevo_sensor.so``) and ``native_oracle`` (the single-core C++
oracle, ``librevo_oracle.so``).  For each library, at first use:

1. load the tracked ``native/lib*.so`` of the repo;
2. if that file is missing or does not load on this machine (it was linked
   against another machine's libpng / libjpeg / OpenCV), compile the one
   ``native/*.cpp`` it comes from with ``g++`` and ``native/Makefile``'s
   flags into ``build/revo_tpu_torch/native/`` and load that;
3. if that fails too the library is unavailable, and ``why_unavailable``
   keeps the reason as a string.

``make`` is never run in ``native/``: that would rewrite tracked files.  A
library that loads and then misbehaves is an error of the caller's, never
"unavailable".
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

_ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE_DIR = _ROOT / "native"  # the *.cpp sources
TRACKED_DIR = _ROOT / "native"  # the lib*.so files the repo tracks
BUILD_DIR = _ROOT / "build" / "revo_tpu_torch" / "native"

_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall")
# Single fast-math flags, not -ffast-math: at link time that pulls in
# crtfastmath.o, whose constructor sets FTZ/DAZ for the whole process.
_FASTMATH = (
    "-fno-math-errno", "-fno-trapping-math", "-fassociative-math",
    "-fno-signed-zeros", "-freciprocal-math",
)


def _opencv_cflags():
    try:
        out = subprocess.run(
            ["pkg-config", "--cflags", "opencv4"], capture_output=True, text=True, timeout=30
        )
    except (OSError, subprocess.TimeoutExpired):
        return ()
    return tuple(out.stdout.split()) if out.returncode == 0 else ()


# name -> (source file, flags before the source, flags after "-o lib")
_LIBRARIES = {
    "io": ("revo_io.cpp", lambda: _CXXFLAGS, ("-shared", "-lpng", "-lpthread")),
    "sensor": ("revo_sensor.cpp", lambda: _CXXFLAGS, ("-shared", "-ljpeg", "-lpthread")),
    "oracle": (
        "revo_oracle.cpp",
        lambda: _CXXFLAGS + ("-march=native",) + _FASTMATH + _opencv_cflags(),
        ("-shared", "-lopencv_imgproc", "-lopencv_core"),
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_reasons: Dict[str, str] = {}


def _build(name: str) -> Path:
    """Compile library ``name`` into BUILD_DIR (named by a hash of its
    source and flags, so an unchanged tree loads the existing build) and
    return its path; raises RuntimeError with the compiler's words."""
    source, pre, post = _LIBRARIES[name]
    src = SOURCE_DIR / source
    if not src.exists():
        raise RuntimeError(f"{src} not found")
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no g++ on PATH")
    flags = pre()
    digest = hashlib.sha256(" ".join(flags + post).encode() + src.read_bytes()).hexdigest()[:16]
    path = BUILD_DIR / f"librevo_{name}_{digest}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *flags, str(src), "-o", str(tmp), *post]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"{cxx} {source}: timed out") from None
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        tail = (proc.stderr or proc.stdout).strip().splitlines()
        raise RuntimeError(f"{cxx} {source} failed: " + " | ".join(tail[:3]))
    os.replace(tmp, path)
    return path


def load(name: str) -> Optional[ctypes.CDLL]:
    """Library ``name`` ("io", "sensor" or "oracle"), or None when it can
    neither be loaded nor built here (``why_unavailable`` says why).  The
    outcome is cached per process."""
    if name in _loaded:
        return _loaded[name]
    if name in _reasons:
        return None
    tracked = TRACKED_DIR / f"librevo_{name}.so"
    try:
        if not tracked.exists():
            raise OSError(f"{tracked.name} not in {TRACKED_DIR}")
        lib = ctypes.CDLL(str(tracked))
    except OSError as tracked_err:
        try:
            lib = ctypes.CDLL(str(_build(name)))
        except (OSError, RuntimeError) as build_err:
            _reasons[name] = f"tracked library: {tracked_err}; build: {build_err}"
            return None
    _loaded[name] = lib
    return lib


def why_unavailable(name: str) -> Optional[str]:
    """Why ``load(name)`` gave None, or None when the library loaded."""
    return None if load(name) is not None else _reasons[name]


def loaded_path(name: str) -> Optional[str]:
    """File that ``load(name)`` loaded (None when unavailable)."""
    lib = load(name)
    return None if lib is None else lib._name


def forget(name: Optional[str] = None) -> None:
    """Drop the cached outcome of ``name`` (all when None), so the next
    ``load`` looks again: for tests that move TRACKED_DIR."""
    for cache in (_loaded, _reasons):
        if name is None:
            cache.clear()
        else:
            cache.pop(name, None)
