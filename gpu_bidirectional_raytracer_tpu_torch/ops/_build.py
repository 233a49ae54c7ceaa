"""Build the CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on first use into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -fmad=false -Xptxas -v -o <lib> <source>

The library lands in ``build/kernels/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edit rebuilds and an unchanged source
loads at once. `build_all` starts one nvcc per source, all at once. A
build writes a temporary file and renames it into place: no lock file is
ever taken or waited on. Nothing here runs at import time.
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

# Kernel sources by name; each exports its C entry points (`_ENTRIES`).
SOURCES = {"trace_kernel": CSRC_DIR / "trace_kernel.cu",
           "grad_kernel": CSRC_DIR / "grad_kernel.cu",
           "bounce_kernel": CSRC_DIR / "bounce_kernel.cu",
           "scan_kernel": CSRC_DIR / "scan_kernel.cu"}

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
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for kernel ``name``: ``(out, tmp, process, t0)``, or
    None when its library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                             str(SOURCES[name])], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc, time.perf_counter()


def _finish(name: str, started) -> Path:
    out, tmp, proc, t0 = started
    log, _ = proc.communicate()
    build_seconds[name] = time.perf_counter() - t0
    build_log[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    os.replace(tmp, out)
    return out


def build(name: str) -> Path:
    """Compile kernel ``name`` unless its library is already built."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def build_all() -> dict[str, Path]:
    """Build every kernel: one nvcc per source, all started together."""
    started = {name: _start(name) for name in SOURCES}
    return {name: library_path(name) if st is None else _finish(name, st)
            for name, st in started.items()}


_TABLE_ARGS = [                        # shared by the five eye-path kernels
    ctypes.c_void_p, ctypes.c_int,                # scene, n_spheres
    ctypes.c_void_p, ctypes.c_int,                # vpl, n_vpl
    ctypes.c_void_p, ctypes.c_int,                # keys, n_rows
    ctypes.c_void_p,                              # streamed tape (or null)
    ctypes.c_int,                                 # n_lights
]

_RUN_ARGS = _TABLE_ARGS + [                       # shared by the adjoint
    ctypes.c_void_p, ctypes.c_void_p,             # rays_o, rays_d
    ctypes.c_int,                                 # n
    ctypes.c_int, ctypes.c_int,                   # max_depth, n_light_slots
    ctypes.c_int,                                 # combine_half
    ctypes.c_uint, ctypes.c_uint,                 # lane_offset, lane_total
    ctypes.c_float, ctypes.c_float,               # emission_scale, light_gain
    ctypes.c_float,                               # vis_tau (> 0: carrier)
]

_BOUNCE_ARGS = _TABLE_ARGS + [                    # shared by the bounce pair
    ctypes.c_void_p, ctypes.c_int,                # state [14, n], n
    ctypes.c_int, ctypes.c_int,                   # row0, n_light_slots
    ctypes.c_int, ctypes.c_int,                   # combine_half, direct_only
    ctypes.c_uint, ctypes.c_uint,                 # lane_offset, lane_total
    ctypes.c_float, ctypes.c_float,               # emission_scale, light_gain
    ctypes.c_int,                                 # threads per block
]

# Entry points: name -> (source, C function, argument types).
_ENTRIES = {
    "trace_kernel": ("trace_kernel", "trace_kernel_launch", _TABLE_ARGS + [
        ctypes.c_void_p, ctypes.c_void_p,         # cam, rays_o
        ctypes.c_void_p,                          # rays_d
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # n, width, cam_rows
        ctypes.c_int, ctypes.c_int,               # max_depth, n_light_slots
        ctypes.c_int,                             # combine_half
        ctypes.c_uint, ctypes.c_uint,             # lane_offset, lane_total
        ctypes.c_float, ctypes.c_float,           # emission_scale, light_gain
        ctypes.c_void_p, ctypes.c_void_p,         # out, stream
    ]),
    "grad_kernel": ("grad_kernel", "grad_kernel_launch", _RUN_ARGS + [
        ctypes.c_void_p,                          # cotangent [n, 3]
        ctypes.c_void_p, ctypes.c_void_p,         # dscene, dvpl partials
        ctypes.c_void_p, ctypes.c_void_p,         # d rays_o, d rays_d
        ctypes.c_void_p,                          # stream
    ]),
    "fused_kernel": ("grad_kernel", "fused_kernel_launch", _RUN_ARGS + [
        ctypes.c_void_p,                          # target [n, 3]
        ctypes.c_int, ctypes.c_float,             # loss_kind, 1 / (3n)
        ctypes.c_void_p, ctypes.c_void_p,         # dscene, dvpl partials
        ctypes.c_void_p,                          # loss partials
        ctypes.c_void_p,                          # radiance out (or null)
        ctypes.c_void_p,                          # stream
    ]),
    "bounce_kernel": ("bounce_kernel", "bounce_kernel_launch",
                      _BOUNCE_ARGS + [ctypes.c_void_p]),   # stream
    "aux_kernel": ("bounce_kernel", "aux_kernel_launch", _BOUNCE_ARGS + [
        ctypes.c_void_p,                          # hit ids [n] int32
        ctypes.c_void_p, ctypes.c_void_p,         # occlusion [L, n], [V, n]
        ctypes.c_void_p,                          # stream
    ]),
    "nearest_kernel": ("scan_kernel", "nearest_kernel_launch", [
        ctypes.c_void_p, ctypes.c_int,            # scene, n_spheres
        ctypes.c_void_p, ctypes.c_void_p,         # o, d [n, 3]
        ctypes.c_void_p, ctypes.c_int,            # alive [n] bool, n
        ctypes.c_void_p, ctypes.c_void_p,         # t [n], hit id [n]
        ctypes.c_void_p, ctypes.c_void_p,         # p, e, c [9, n], refl [n]
        ctypes.c_int, ctypes.c_void_p,            # threads per block, stream
    ]),
    "anyhit_kernel": ("scan_kernel", "anyhit_kernel_launch", [
        ctypes.c_void_p, ctypes.c_int,            # scene, n_spheres
        ctypes.c_void_p, ctypes.c_void_p,         # o, d [n, 3]
        ctypes.c_void_p, ctypes.c_void_p,         # maxt [n], active [n] bool
        ctypes.c_int, ctypes.c_int,               # n, vacuum
        ctypes.c_void_p,                          # occluded [n] bool
        ctypes.c_int, ctypes.c_void_p,            # threads per block, stream
    ]),
}


def load(entry: str):
    """The C launch function of entry point ``entry`` (its source built if
    needed)."""
    source, fn_name, argtypes = _ENTRIES[entry]
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        _loaded[source] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
