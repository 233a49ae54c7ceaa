"""Material scatter for every lane: diffuse, mirror and Fresnel glass.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/bsdf.py``: every lane
evaluates the three branches and selects by material code.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import DIFF, SPEC
from gpu_bidirectional_raytracer_tpu_torch.integrators.sampling import (
    cosine_hemisphere,
)

_NC = 1.0   # exterior index of refraction
_NT = 1.5   # glass


class Scatter(NamedTuple):
    new_d: Tensor     # [N, 3] continuation direction
    tp_mul: Tensor    # [N, 3] throughput multiplier
    specular: Tensor  # [N] bool: the next segment is specular


def _safe_sqrt(x: Tensor) -> Tensor:
    return torch.where(x > 0.0, torch.sqrt(torch.clamp(x, min=0.0)),
                       torch.zeros_like(x))


def scatter(refl: Tensor, albedo: Tensor, d: Tensor, normal: Tensor,
            nl: Tensor, u_diff1: Tensor, u_diff2: Tensor,
            u_rr: Tensor, with_bits: bool = False):
    """One material interaction per lane. ``normal`` is the geometric
    normal, ``nl`` the one facing the incoming ray. ``with_bits`` also
    returns the glass branch taken, ``[N]`` int32: bit 0 total internal
    reflection, bit 1 the Russian roulette took the reflection."""
    diff_dir = cosine_hemisphere(nl, u_diff1, u_diff2)
    spec_dir = vm.reflect(d, normal)

    into = vm.dot(normal, nl) > 0.0
    nnt = torch.where(into, torch.tensor(_NC / _NT, device=d.device),
                      torch.tensor(_NT / _NC, device=d.device))
    ddn = vm.dot(d, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    sign = torch.where(into, 1.0, -1.0)
    kk = sign * (ddn * nnt + _safe_sqrt(cos2t))
    trans_dir = vm.norm(vm.smul(nnt, d) - vm.smul(kk, normal))

    r0 = ((_NT - _NC) / (_NT + _NC)) ** 2
    c1 = 1.0 - torch.where(into, -ddn, vm.dot(trans_dir, normal))
    c2 = c1 * c1
    re = r0 + (1.0 - r0) * (c1 * (c2 * c2))
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    rp = re / p
    tp = tr / (1.0 - p)

    take_refl = tir | (u_rr < p)
    refr_dir = torch.where(take_refl[:, None], spec_dir, trans_dir)
    rr_w = torch.where(tir, 1.0, torch.where(u_rr < p, rp, tp))

    is_diff = (refl == DIFF)[:, None]
    is_spec = (refl == SPEC)[:, None]
    new_d = torch.where(is_diff, diff_dir,
                        torch.where(is_spec, spec_dir, refr_dir))
    tp_mul = albedo * torch.where(is_diff | is_spec, 1.0, rr_w[:, None])
    sc = Scatter(new_d=new_d, tp_mul=tp_mul, specular=refl != DIFF)
    if with_bits:
        return sc, tir.to(torch.int32) | (take_refl.to(torch.int32) << 1)
    return sc
