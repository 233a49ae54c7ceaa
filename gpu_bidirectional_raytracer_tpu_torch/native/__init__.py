"""The native (C++) scene parser and PPM encoder, loaded with ctypes.

Port of ``gpu_bidirectional_raytracer_tpu/native/__init__.py`` over this
package's own copy of ``scn_io.cpp``. The source is compiled with ``g++``
at first use into ``build/native/`` at the root of the checkout (listed
in ``.gitignore``), named by a hash of the source and the flags; a build
writes a temporary file and renames it into place, so concurrent builds
never take a lock. Nothing runs at import time.

Every entry point has a pure-Python counterpart, and without a compiler
the callers use it (`scene.parser.load_scene`, `render.film.write_ppm`):
this is host-side IO, which touches neither the card nor a kernel.
`available()` says whether the native library loaded, which is to say
which parser and encoder ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "scn_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_ERRORS = {
    -1: "expected 'camera' line", -2: "camera needs 6 floats",
    -3: "expected 'size' line", -4: "size needs an integer",
    -5: "sphere count out of range", -6: "out of memory",
    -7: "expected 'sphere' line", -8: "sphere needs 11 fields",
    -9: "material must be 0..3",
}

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"scn_io-{h.hexdigest()[:16]}.so"


def build(force: bool = False) -> bool:
    """Compile the shared library unless it is built; True on success,
    False when there is no ``g++`` or it fails."""
    out = library_path()
    if out.exists() and not force:
        return True
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        done = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        tmp.unlink(missing_ok=True)
        return False
    if done.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not build():
            return None
        lib = ctypes.CDLL(str(library_path()))
        lib.scn_parse.restype = ctypes.c_int
        lib.scn_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.scn_free.restype = None
        lib.scn_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        for name in ("ppm_write_p3", "ppm_write_p6"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
                           ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def scn_parse(text: str):
    """Parse scene text natively to ``(cam [6] float32, spheres [N, 11]
    float32)``; ``None`` when the library is unavailable. Malformed input
    raises ValueError with the native error."""
    lib = _load()
    if lib is None:
        return None
    raw = text.encode()
    cam = (ctypes.c_float * 6)()
    spheres_ptr = ctypes.POINTER(ctypes.c_float)()
    count = ctypes.c_int64()
    rc = lib.scn_parse(raw, len(raw), cam, ctypes.byref(spheres_ptr),
                       ctypes.byref(count))
    if rc != 0:
        raise ValueError(
            f"scene parse failed: {_ERRORS.get(rc, f'error {rc}')}")
    try:
        flat = np.ctypeslib.as_array(spheres_ptr,
                                     shape=(count.value, 11)).copy()
    finally:
        lib.scn_free(spheres_ptr)
    return np.asarray(cam, dtype=np.float32).copy(), flat


def ppm_write(path, img_u8: np.ndarray, binary: bool = False) -> bool:
    """Write bottom-up uint8 ``[H, W, 3]`` as P3 (or P6) PPM, top row
    first; False when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected a [H, W, 3] image, got {img.shape}")
    h, w, _ = img.shape
    fn = lib.ppm_write_p6 if binary else lib.ppm_write_p3
    rc = fn(os.fsencode(path), img.ctypes.data_as(
        ctypes.POINTER(ctypes.c_uint8)), w, h)
    if rc < 0:
        raise OSError(f"native ppm write failed: {rc}")
    return True
