"""Uniform-sphere and cosine-hemisphere sampling (port of
``gpu_bidirectional_raytracer_tpu/integrators/sampling.py``)."""

from __future__ import annotations

import math

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm


def uniform_sphere(u1: Tensor, u2: Tensor) -> Tensor:
    """Uniform point on the unit sphere: ``z = 1-2u1``,
    ``r = sqrt(max(0, 1-z^2))``, ``phi = 2 pi u2``."""
    zz = 1.0 - 2.0 * u1
    r = torch.sqrt(torch.clamp(1.0 - zz * zz, min=0.0))
    phi = (2.0 * math.pi) * u2
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), zz], dim=-1)


def cosine_hemisphere(nl: Tensor, u1: Tensor, u2: Tensor) -> Tensor:
    """Cosine-weighted direction about the unit normal ``nl [N,3]``."""
    r1 = (2.0 * math.pi) * u1
    r2s = torch.sqrt(u2)
    u, v = vm.orthonormal_basis(nl)
    return (vm.smul(torch.cos(r1) * r2s, u)
            + vm.smul(torch.sin(r1) * r2s, v)
            + vm.smul(torch.sqrt(1.0 - u2), nl))
