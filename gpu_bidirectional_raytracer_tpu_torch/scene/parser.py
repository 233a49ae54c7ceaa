"""``.scn`` scene file parser and writer.

Port of ``gpu_bidirectional_raytracer_tpu/scene/parser.py``. The grammar:

    camera ox oy oz tx ty tz
    size N
    sphere rad px py pz er eg eb cr cg cb mat      (N times)

with mat in {0: DIFF, 1: SPEC, 2: REFR, 3: LITE}; blank lines and ``#``
comments are allowed. Malformed input raises :class:`SceneParseError` with
a line number. Fields are parsed as Python floats and stored as float32.
"""

from __future__ import annotations

import io
import os
from typing import Union

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch.core.types import Scene, resolve_device

_MATERIALS = frozenset((0, 1, 2, 3))


class SceneParseError(ValueError):
    pass


def _tokens(text: str):
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = raw.split("#", 1)[0].strip()
        if line:
            yield lineno, line.split()


def parse_arrays(text: str) -> tuple[np.ndarray, np.ndarray, dict]:
    """Parse scene text to ``(orig[3], target[3], arrays)``, where
    ``arrays`` holds numpy ``rad/p/e/c`` (float32) and ``refl`` (int32)."""
    it = _tokens(text)

    def next_line(expect: str, nfields: int):
        try:
            lineno, toks = next(it)
        except StopIteration:
            raise SceneParseError(
                f"unexpected end of scene (expected '{expect}')") from None
        if toks[0] != expect:
            raise SceneParseError(
                f"line {lineno}: expected '{expect}', got '{toks[0]}'")
        if len(toks) - 1 != nfields:
            raise SceneParseError(
                f"line {lineno}: '{expect}' needs {nfields} fields, "
                f"got {len(toks) - 1}")
        return lineno, toks[1:]

    def floats(lineno, toks, what):
        try:
            return [float(v) for v in toks]
        except ValueError:
            raise SceneParseError(
                f"line {lineno}: non-numeric {what} field") from None

    lineno, cam = next_line("camera", 6)
    cam = np.asarray(floats(lineno, cam, "camera"), dtype=np.float32)

    lineno, (count,) = next_line("size", 1)
    try:
        count = int(count)
    except ValueError:
        raise SceneParseError(
            f"line {lineno}: sphere count must be an integer") from None
    if count <= 0:
        raise SceneParseError(f"line {lineno}: sphere count must be positive")

    rad = np.empty((count,), dtype=np.float32)
    p = np.empty((count, 3), dtype=np.float32)
    e = np.empty((count, 3), dtype=np.float32)
    c = np.empty((count, 3), dtype=np.float32)
    refl = np.empty((count,), dtype=np.int32)
    for i in range(count):
        lineno, f = next_line("sphere", 11)
        vals = floats(lineno, f[:10], f"sphere #{i}")
        try:
            mat = int(f[10])
        except ValueError:
            raise SceneParseError(
                f"line {lineno}: material must be an integer") from None
        if mat not in _MATERIALS:
            raise SceneParseError(
                f"line {lineno}: bad material {mat} for sphere #{i}")
        rad[i] = vals[0]
        p[i] = vals[1:4]
        e[i] = vals[4:7]
        c[i] = vals[7:10]
        refl[i] = mat
    return cam[:3], cam[3:], dict(rad=rad, p=p, e=e, c=c, refl=refl)


def scene_from_arrays(rad, p, e, c, refl,
                      device: str | torch.device = "cuda") -> Scene:
    """A :class:`Scene` on ``device`` from array-likes."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return Scene(rad=f32(rad), p=f32(p), e=f32(e), c=f32(c),
                 refl=torch.tensor(np.asarray(refl, np.int32), device=dev))


def parse_scene(text: str, device: str | torch.device = "cuda"
                ) -> tuple[np.ndarray, np.ndarray, Scene]:
    """Parse scene text to ``(camera_orig[3], camera_target[3], Scene)``."""
    orig, target, arrays = parse_arrays(text)
    return orig, target, scene_from_arrays(**arrays, device=device)


def load_scene(path: Union[str, os.PathLike],
               device: str | torch.device = "cuda",
               prefer_native: bool = True
               ) -> tuple[np.ndarray, np.ndarray, Scene]:
    """Read and parse a ``.scn`` file: with the native parser when
    ``prefer_native`` and it builds (`native.available`), else in
    Python; malformed input raises :class:`SceneParseError` either way."""
    with open(path, "r") as f:
        text = f.read()
    if prefer_native:
        from gpu_bidirectional_raytracer_tpu_torch import native

        try:
            parsed = native.scn_parse(text)
        except ValueError as e:
            raise SceneParseError(str(e)) from e
        if parsed is not None:
            cam, flat = parsed
            return cam[:3], cam[3:], scene_from_arrays(
                flat[:, 0], flat[:, 1:4], flat[:, 4:7], flat[:, 7:10],
                flat[:, 10].astype(np.int32), device=device)
    return parse_scene(text, device=device)


def scale_world(orig, target, scene: Scene, factor: float):
    """Uniformly scale camera orig/target, sphere positions and radii
    (emission and albedo stay as they are)."""
    f = float(factor)
    o = np.asarray(orig, dtype=np.float32) * np.float32(f)
    t = np.asarray(target, dtype=np.float32) * np.float32(f)
    return o, t, scene.replace(rad=scene.rad * f, p=scene.p * f)


def write_scene(orig, target, scene: Scene, path_or_file) -> None:
    """Serialize back to ``.scn`` (round-trips through :func:`parse_scene`)."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        o = np.asarray(orig, dtype=np.float32)
        t = np.asarray(target, dtype=np.float32)
        f.write("camera %.9g %.9g %.9g  %.9g %.9g %.9g\n" % (*o, *t))
        rad = scene.rad.cpu().numpy()
        p = scene.p.cpu().numpy()
        e = scene.e.cpu().numpy()
        c = scene.c.cpu().numpy()
        refl = scene.refl.cpu().numpy()
        f.write("size %d\n" % rad.shape[0])
        for i in range(rad.shape[0]):
            f.write("sphere %.9g  %.9g %.9g %.9g  %.9g %.9g %.9g  "
                    "%.9g %.9g %.9g  %d\n" % (
                        rad[i], p[i, 0], p[i, 1], p[i, 2],
                        e[i, 0], e[i, 1], e[i, 2],
                        c[i, 0], c[i, 1], c[i, 2], refl[i]))
    finally:
        if own:
            f.close()


def dumps_scene(orig, target, scene: Scene) -> str:
    buf = io.StringIO()
    write_scene(orig, target, scene, buf)
    return buf.getvalue()
