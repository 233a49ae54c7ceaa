"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o <lib> <source>

The library lands in ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the source and the flags, so an edit
rebuilds and an unchanged source loads at once. A build writes a temporary
file and renames it into place: no lock file is ever taken or waited on.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # IEEE division and square root are nvcc's defaults; no
              # contraction into FMA keeps the kernels' rounding equal to
              # the plain PyTorch versions'.
              "-fmad=false", "-Xptxas", "-v"]

# Kernel sources by name; each exports its C entry points.
SOURCES = {"trace_kernel": CSRC_DIR / "trace_kernel.cu"}

_loaded: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}      # nvcc's output (ptxas register counts)
build_seconds: dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset and "
                           "nvcc is not on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCES[name])],
                          capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{build_log[name]}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Build every kernel."""
    return {name: build(name) for name in SOURCES}


_ARGTYPES = {
    "trace_kernel": ("trace_kernel_launch", [
        ctypes.c_void_p, ctypes.c_int,            # scene, n_spheres
        ctypes.c_void_p, ctypes.c_int,            # vpl, n_vpl
        ctypes.c_void_p, ctypes.c_int,            # keys, n_rows
        ctypes.c_int,                             # n_lights
        ctypes.c_void_p, ctypes.c_void_p,         # cam, rays_o
        ctypes.c_void_p,                          # rays_d
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, width, cam_rows
        ctypes.c_int, ctypes.c_int,               # max_depth, n_light_slots
        ctypes.c_int,                             # combine_half
        ctypes.c_uint, ctypes.c_uint,             # lane_offset, lane_total
        ctypes.c_float, ctypes.c_float,           # emission_scale, light_gain
        ctypes.c_void_p, ctypes.c_void_p,         # out, stream
    ]),
}


def load(name: str):
    """The C launch function of kernel ``name`` (built if needed)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    fn_name, argtypes = _ARGTYPES[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
