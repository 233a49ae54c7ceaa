"""Film: tonemapping and image output (port of
``gpu_bidirectional_raytracer_tpu/render/film.py``). Images are float32
``[H, W, 3]`` with row 0 at the bottom; a file lists the top row first.

P3 PPM is always available: through the native encoder (`native`) when it
builds, else in Python, with the same bytes. PNG needs PIL; without it
`write_image` writes a PPM beside the requested name."""

from __future__ import annotations

import os

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm


def to_bytes(colors) -> np.ndarray:
    """Gamma-2.2 quantize to uint8."""
    return vm.gamma_to_byte(torch.as_tensor(colors)).cpu().numpy()


def write_ppm(colors, path: str | os.PathLike,
              prefer_native: bool = True) -> None:
    """P3 PPM, top row first, each row ``"r g b r g b ... \\n"``; through
    the native encoder when ``prefer_native`` and it is available."""
    img = to_bytes(colors)
    if prefer_native:
        from gpu_bidirectional_raytracer_tpu_torch import native

        if native.ppm_write(path, img):
            return
    h, w, _ = img.shape
    lines = [f"P3\n{w} {h}\n255\n"]
    for y in range(h - 1, -1, -1):
        lines.append(" ".join(map(str, img[y].reshape(-1).tolist())) + " \n")
    with open(path, "w") as f:
        f.write("".join(lines))


def read_ppm(path: str | os.PathLike) -> np.ndarray:
    """Read a P3 PPM back into bottom-up uint8 ``[H, W, 3]``."""
    with open(path) as f:
        toks = f.read().split()
    if toks[0] != "P3":
        raise ValueError(f"{path}: only P3 PPM is supported")
    w, h = int(toks[1]), int(toks[2])
    data = np.asarray(toks[4:4 + w * h * 3], dtype=np.int64)
    return data.reshape(h, w, 3).astype(np.uint8)[::-1]


def write_png(colors, path: str | os.PathLike) -> bool:
    """PNG, top row first; False when PIL is not installed."""
    try:
        from PIL import Image
    except ImportError:
        return False
    Image.fromarray(to_bytes(colors)[::-1]).save(os.fspath(path))
    return True


def write_image(colors, path: str | os.PathLike) -> str:
    """Write by extension: ``.png`` through PIL when it is installed, else
    P3 PPM (a ``.png`` name becomes ``.ppm``). Returns the path written."""
    if str(path).lower().endswith(".png"):
        if write_png(colors, path):
            return str(path)
        path = str(path)[:-4] + ".ppm"
    write_ppm(colors, path)
    return str(path)


def snapshot_name(max_vlp: int, total_time: float, sample: int) -> str:
    """Config, wall time and pass count in the file name, as the
    reference names its snapshots."""
    return f"max{max_vlp}_secondi{total_time:.3f}_exe{sample}.ppm"
