"""Primary ray generation and camera motion.

Port of ``gpu_bidirectional_raytracer_tpu/camera.py``: the reference's
projective camera (film coordinates ``(kx, ky, kz=10)``, homogeneous divide
by ``w = dot(temp, kappa) + 1``, origin displaced by the unnormalized
direction) and the interactive translate/rotate motions. Row 0 of the
image is the bottom row.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import Camera, Rays

FILM_W = 14.0
FILM_H = 10.5
FILM_KZ = 10.0


def reference_dims(width: int, height: int) -> tuple[int, int]:
    """The reference adds one to each axis after parsing its arguments."""
    return width + 1, height + 1


def camera_frame(cam: Camera) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """``(x_hat, y_hat, d_hat, temp)`` with ``temp = -(x_hat, y_hat,
    d_hat) . orig``: the per-frame constants of `primary_rays`, shared with
    the CUDA kernel's camera table so both see the same bits."""
    x_hat = vm.norm(cam.x)
    y_hat = vm.norm(cam.y)
    d_hat = vm.norm(cam.dir)
    temp = torch.stack([vm.dot(-x_hat, cam.orig), vm.dot(-y_hat, cam.orig),
                        vm.dot(-d_hat, cam.orig)])
    return x_hat, y_hat, d_hat, temp


def film_coords(width: int, height: int) -> tuple[float, float, float, float]:
    """``(inv_w, half_w, inv_h, half_h)``: ``k = p * inv - half + j * inv``."""
    inv_w = FILM_W / width
    inv_h = FILM_H / height
    return inv_w, inv_w * width / 2.0, inv_h, inv_h * height / 2.0


def primary_rays(cam: Camera, width: int, height: int,
                 jitter_u: Tensor, jitter_v: Tensor,
                 x: Tensor, y: Tensor) -> Rays:
    """Camera rays for pixel coordinates ``(x, y)`` (flat ``[N]``), with
    per-ray jitter uniforms ``jitter_u/v`` in [0, 1)."""
    inv_w, half_w, inv_h, half_h = film_coords(width, height)
    kx = x.to(torch.float32) * inv_w - half_w + jitter_u * inv_w
    ky = y.to(torch.float32) * inv_h - half_h + jitter_v * inv_h
    kz = torch.full_like(kx, FILM_KZ)

    x_hat, y_hat, d_hat, temp = camera_frame(cam)
    rdir = (kx[:, None] * x_hat + ky[:, None] * y_hat + kz[:, None] * d_hat)
    w = kx * temp[0] + ky * temp[1] + kz * temp[2] + 1.0
    rdir = rdir / w[:, None]
    return Rays(o=cam.orig + rdir, d=vm.norm(rdir))


def pixel_grid(width: int, height: int,
               device: str | torch.device = "cuda") -> tuple[Tensor, Tensor]:
    """Flat pixel coordinates (x varies fastest, row-major over y)."""
    y, x = torch.meshgrid(torch.arange(height, device=device),
                          torch.arange(width, device=device), indexing="ij")
    return x.reshape(-1), y.reshape(-1)


def stratify_jitter(u: Tensor, v: Tensor, sample: int,
                    k: int) -> tuple[Tensor, Tensor]:
    """Map jitter into the sample's cell of a ``k x k`` stratum grid."""
    sx = float(sample % k)
    sy = float((sample // k) % k)
    inv = 1.0 / k
    return (sx + u) * inv, (sy + v) * inv


def translate(cam: Camera, axis: str, amount: float,
              width: int, height: int) -> Camera:
    """Move orig and target along ``'x'``, ``'dir'`` or ``'y_world'``."""
    if axis == "x":
        d = vm.norm(cam.x) * amount
    elif axis == "dir":
        d = cam.dir * amount
    elif axis == "y_world":
        d = torch.tensor([0.0, 1.0, 0.0], device=cam.orig.device) * amount
    else:
        raise ValueError(f"unknown axis {axis!r}")
    return Camera.update(cam.orig + d, cam.target + d, width, height)


def rotate(cam: Camera, axis: str, angle: float,
           width: int, height: int) -> Camera:
    """Rotate target about orig: ``'pitch'`` or ``'yaw'``, using the
    already-updated component as the reference does."""
    t = cam.target - cam.orig
    ang = torch.tensor(angle, dtype=torch.float32, device=t.device)
    c, s = torch.cos(ang), torch.sin(ang)
    if axis == "pitch":
        ty = t[1] * c + t[2] * s
        tz = -ty * s + t[2] * c
        t = torch.stack([t[0], ty, tz])
    elif axis == "yaw":
        tx = t[0] * c - t[2] * s
        tz = tx * s + t[2] * c
        t = torch.stack([tx, t[1], tz])
    else:
        raise ValueError(f"unknown axis {axis!r}")
    return Camera.update(cam.orig, cam.orig + t, width, height)
