"""Batched 3-vector algebra on ``[..., 3]`` tensors.

Port of ``gpu_bidirectional_raytracer_tpu/core/vecmath.py``. Dot and cross
products are written out component by component, so the sum order is
``(x + y) + z`` on every device. The CUDA eye-path kernel
(``csrc/trace_kernel.cu``) evaluates the same expressions in the same
order, which keeps it close to bitwise with the plain version on the card.
"""

from __future__ import annotations

import torch
from torch import Tensor


def dot(a: Tensor, b: Tensor) -> Tensor:
    """Dot product over the trailing xyz axis."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm(v: Tensor, eps: float = 0.0) -> Tensor:
    """Normalize over the trailing axis: ``v * 1 / (|v| + eps)``."""
    return v * torch.reciprocal(torch.sqrt(dot(v, v)) + eps)[..., None]


def length(v: Tensor) -> Tensor:
    """Euclidean length over the trailing axis."""
    return torch.sqrt(dot(v, v))


def cross(a: Tensor, b: Tensor) -> Tensor:
    """Cross product over the trailing axis."""
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def max_component(v: Tensor) -> Tensor:
    """The largest of x, y, z."""
    return torch.amax(v, dim=-1)


def is_zero(v: Tensor) -> Tensor:
    """All components exactly zero."""
    return torch.all(v == 0.0, dim=-1)


def smul(k: Tensor, v: Tensor) -> Tensor:
    """Scalar (batched) times vector."""
    return k[..., None] * v


def reflect(d: Tensor, n: Tensor) -> Tensor:
    """Mirror direction ``d - 2 (n.d) n``."""
    return d - smul(2.0 * dot(n, d), n)


def gamma_to_byte(x: Tensor) -> Tensor:
    """Clamp, gamma 1/2.2, scale to [0, 255] and round down after +0.5."""
    g = torch.pow(torch.clamp(x, 0.0, 1.0), 1.0 / 2.2)
    return (g * 255.0 + 0.5).to(torch.uint8)


def orthonormal_basis(w: Tensor) -> tuple[Tensor, Tensor]:
    """Complete unit normal ``w`` to a right-handed frame ``(u, v)``.

    Helper axis ``a = (0,1,0)`` when ``|w.x| > 0.1`` else ``(1,0,0)``;
    ``u = norm(a x w)``, ``v = w x u``.
    """
    big_x = (torch.abs(w[..., 0]) > 0.1)[..., None]
    ay = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    ax = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    a = torch.where(big_x, ay, ax)
    u = norm(cross(a, w))
    v = cross(w, u)
    return u, v
