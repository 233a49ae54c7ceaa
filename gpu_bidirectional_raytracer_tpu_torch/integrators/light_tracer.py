"""Light-subpath tracer: emits rays from the emitters and deposits VPLs.

Port of ``emit_light_rays`` and ``trace_light_paths`` from
``gpu_bidirectional_raytracer_tpu/integrators/light_tracer.py``. In JAX this
is XLA code, not a kernel, so it stays plain torch here. Each of
``light_points`` lanes walks one subpath from a point on a light sphere
(lanes round-robin over the lights), with a direction cosine-sampled about
the outward normal and throughput ``e / 4``. An escaped lane deposits an
"environment" VPL at its origin (``rad = e/2``, inward normal); a diffuse
hit deposits ``{hit point, throughput * albedo, shading normal}``; mirror
and glass continue without a deposit; an emitter ends the walk. A lane dies
when its largest throughput component falls to ``throughput_tol``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    IntegratorConfig,
    Rays,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import bsdf
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect
from gpu_bidirectional_raytracer_tpu_torch.integrators.sampling import (
    cosine_hemisphere,
    uniform_sphere,
)


def _lanes(cfg: IntegratorConfig, lane_offset, lane_count, lane_total):
    total = cfg.light_points if lane_total is None else lane_total
    n = total if lane_count is None else lane_count
    off = 0 if lane_offset is None else int(lane_offset)
    return n, off


def emit_light_rays(scene: Scene, cfg: IntegratorConfig,
                    light_idx: tuple[int, ...], key: rng.Key, sample: int,
                    lane_offset: int | None = None,
                    lane_count: int | None = None,
                    lane_total: int | None = None
                    ) -> tuple[Rays, Tensor, Tensor]:
    """Emission rays of lanes ``[lane_offset, lane_offset + lane_count)``
    of a ``lane_total``-lane pass (default: all ``light_points`` lanes).
    Returns ``(rays, lane_light_id [N], lane_emission [N,3])``."""
    n, off = _lanes(cfg, lane_offset, lane_count, lane_total)
    dev = scene.device
    li = torch.tensor(light_idx, dtype=torch.int64, device=dev)
    gid = torch.arange(n, device=dev) + off
    lane_light = li[gid % len(light_idx)]
    lp, lrad, le = (scene.p[lane_light], scene.rad[lane_light],
                    scene.e[lane_light])
    u = rng.site_uniforms(key, sample, 0, rng.LIGHT_RAY_UV, 4, n, device=dev,
                          lane_offset=lane_offset, lane_total=lane_total)
    usp = uniform_sphere(u[0], u[1])                         # outward normal
    origin = lp + lrad[:, None] * usp
    direction = cosine_hemisphere(usp, u[2], u[3])
    return Rays(o=origin, d=direction), lane_light, le


def trace_light_paths(scene: Scene, cfg: IntegratorConfig,
                      light_idx: tuple[int, ...], key: rng.Key, sample: int,
                      lane_offset: int | None = None,
                      lane_count: int | None = None,
                      lane_total: int | None = None) -> VplBuffer:
    """Walk the light subpaths and fill a fresh :class:`VplBuffer`."""
    rays, lane_light, le = emit_light_rays(
        scene, cfg, light_idx, key, sample, lane_offset=lane_offset,
        lane_count=lane_count, lane_total=lane_total)
    n, _ = _lanes(cfg, lane_offset, lane_count, lane_total)
    dev = scene.device
    lane_lp = scene.p[lane_light]
    lane_lrad = scene.rad[lane_light]

    o, d = rays.o, rays.d
    throughput = le * 0.25
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    out = VplBuffer.zeros(cfg.vpl_depth, n, device=dev)
    zero3 = torch.zeros_like(o)

    for depth in range(cfg.vpl_depth):
        hit, t, hit_id = isect.intersect(scene, o, d)
        t = torch.where(hit, t, torch.ones_like(t))
        obj_p, obj_e, obj_c, obj_refl = isect.gather_sphere_attrs(scene, hit_id)

        hp = o + vm.smul(t, d)
        normal = vm.norm(hp - obj_p, eps=1e-20)
        dp = vm.dot(normal, d)
        nl = vm.smul(torch.where(dp > 0.0, -1.0, 1.0), normal)

        # Escaped lane: environment VPL at the ray origin.
        env_nl = -(o - lane_lp) / torch.clamp(lane_lrad, min=1e-20)[:, None]
        env_rad = le * 0.5
        env_mask = alive & torch.logical_not(hit)

        is_emitter = torch.logical_not(vm.is_zero(obj_e))
        is_diff = obj_refl == DIFF
        tp_diff = throughput * obj_c
        deposit_mask = alive & hit & torch.logical_not(is_emitter) & is_diff

        env3, dep3 = env_mask[:, None], deposit_mask[:, None]
        out.hp[depth] = torch.where(env3, o, torch.where(dep3, hp, zero3))
        out.rad[depth] = torch.where(env3, env_rad,
                                     torch.where(dep3, tp_diff, zero3))
        out.nl[depth] = torch.where(env3, env_nl,
                                    torch.where(dep3, nl, zero3))
        out.valid[depth] = env_mask | deposit_mask
        out.sid[depth] = torch.where(
            env_mask, lane_light,
            torch.where(deposit_mask, hit_id, torch.zeros_like(hit_id))
        ).to(torch.int32)

        # Continue the walk (only matters when vpl_depth > 1).
        alive = alive & hit & torch.logical_not(is_emitter)
        u = rng.site_uniforms(key, sample, depth, rng.LIGHT_SCATTER, 3, n,
                              device=dev, lane_offset=lane_offset,
                              lane_total=lane_total)
        sc = bsdf.scatter(obj_refl, obj_c, d, normal, nl, u[0], u[1], u[2])
        live = alive[:, None]
        o = torch.where(live, hp, o)
        d = torch.where(live, sc.new_d, d)
        throughput = torch.where(live, throughput * sc.tp_mul, throughput)
        alive = alive & (vm.max_component(throughput) > cfg.throughput_tol)
    return out
