"""Build and load the port's CUDA kernels (revo_tpu_torch/csrc/*.cu).

On first use ``library()`` compiles every source in ``csrc/`` with ``nvcc``
for ``sm_90a``, one ``nvcc`` a source, all started together, links the
objects into one shared library with a plain C interface and loads it with
``ctypes``.  The library lives in ``build/revo_tpu_torch/`` beside the
package, named by a hash of the sources and flags, so an unchanged tree
loads the existing build.  A missing ``nvcc`` or card raises; nothing falls
back to the CPU.  Nothing is built when this module is imported.

``launch(name, *args)`` calls one exported function on PyTorch's current
stream: tensors pass their data pointer (``None`` a null pointer), ints
and floats pass by value, and the stream is appended.  Each function returns ``cudaGetLastError()``
after its launch; a nonzero status raises.  ``call`` is the same call for
a function that answers a question of the CUDA runtime instead: it returns
the function's int.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "revo_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

# Exported C functions: argument kinds ("p" pointer, "i" int, "f" float);
# every function also takes the stream as its last argument.
SIGNATURES = {
    "revo_canny_nms": "pippiiiffi",
    "revo_canny_nms_blocks": "iiii",
    "revo_canny_nms_tile": "",
    "revo_canny_hysteresis": "pppiiii",
    "revo_canny_hysteresis_global": "ppppiiii",
    "revo_canny_hysteresis_shared_limit": "",
    "revo_canny_fused": "pippppiiiffii",
    "revo_canny_fused_blocks": "iii",
    "revo_canny_fused_dense": "pipppiiiffi",
    "revo_canny_cluster": "pipiiiffii",
    "revo_canny_cluster_ranks": "ii",
    "revo_canny_grid": "pipppiiiffii",
    "revo_canny_grid_blocks": "iii",
    "revo_canny_hysteresis_grid": "ppppppiiiiii",
    "revo_canny_hysteresis_grid_blocks": "iiii",
    "revo_lgsx_reduce": "pppppipp",
    "revo_residual_lgsx": "piipipipipipffffiiffiiippp",
    "revo_solver_step": "p" * 19 + "ipipiiiiiiffffff",
    "revo_init_check": "pipipipipiiiiifffffiifpppp",
    "revo_solve_level": ("pii" + "pipi" * 2 + "ffffii" + "ffi" + "ii" + "p" * 18 + "pi" + "iii"
                         + "ffffff" + "i"),
    "revo_solve_level_clusters": "ii",
    "revo_solve_level_attr": "ii",
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


class KernelLibrary(NamedTuple):
    lib: ctypes.CDLL
    path: Path
    built: bool  # False when an existing build was loaded
    seconds: float  # compile time (0 when loaded)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "revo_tpu_torch kernels need nvcc (CUDA toolkit) to build "
        "csrc/*.cu for sm_90a; none on PATH or in /usr/local/cuda/bin"
    )


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    for hdr in sorted(SRC_DIR.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def library() -> KernelLibrary:
    """Compile (if needed) and load the kernel library; cached per process."""
    if not torch.cuda.is_available():
        raise RuntimeError("revo_tpu_torch kernels need a CUDA device; none found")
    sources = _sources()
    path = BUILD_DIR / f"librevo_kernels_{_digest(sources)}.so"
    built, seconds = False, 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        objs = [path.with_suffix(f".{src.stem}.{os.getpid()}.o") for src in sources]
        t0 = time.perf_counter()
        nvcc = _nvcc()
        try:
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for src, obj in zip(sources, objs)]
            said = [proc.communicate()[0] for proc in procs]  # every one has ended
            for proc, out in zip(procs, said):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{out}")
            link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({link.returncode}):\n{link.stdout}{link.stderr}")
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        seconds = time.perf_counter() - t0
        os.replace(tmp, path)
        built = True
    lib = ctypes.CDLL(str(path))
    for name, kinds in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_CTYPES[k] for k in kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return KernelLibrary(lib, path, built, seconds)


def check_device(device) -> torch.device:
    """``device`` as a torch.device; raises for a CUDA device on a machine
    without one.  Nothing falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    return device


def call(name: str, *args, device=None) -> int:
    """Call exported function ``name`` on the current stream of the device
    its tensor arguments live on (``device`` for a function that takes
    none) and return its int."""
    kinds = SIGNATURES[name]
    if len(args) != len(kinds):
        raise TypeError(f"{name}: {len(kinds)} arguments expected, got {len(args)}")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors:
        device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{name}: tensor arguments on different devices")
    cargs = []
    for kind, a in zip(kinds, args):
        if kind == "p":
            cargs.append(ctypes.c_void_p(None if a is None else a.data_ptr()))
        elif kind == "i":
            cargs.append(ctypes.c_int(int(a)))
        else:
            cargs.append(ctypes.c_float(float(a)))
    fn = getattr(library().lib, name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return fn(*cargs, ctypes.c_void_p(stream))


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` through ``call``; raise on a nonzero launch
    status."""
    status = call(name, *args)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with status {status}")
