"""Vectorized eye-path tracer.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/path_tracer.py::trace``
(its default route: direct-form sphere scans, no compaction or re-walk). A
batch of N rays advances one bounce per iteration with an ``alive`` mask:
nearest hit, emission on specular chains, next-event estimation with the
VPL gather at diffuse vertices, then diffuse/mirror/glass scatter. All
randomness comes from `rng.site_uniforms` sites addressed by ``(sample,
depth, purpose)``.

This is also the plain version of the CUDA eye-path kernel in ray mode
(`ops.pallas_trace.trace_pallas`): same estimator, same tape.
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
from gpu_bidirectional_raytracer_tpu_torch.integrators import direct as nee
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect


def trace(scene: Scene, cfg: IntegratorConfig, light_idx: tuple[int, ...],
          rays: Rays, key: rng.Key, sample: int,
          vpls: VplBuffer | None = None, vlp_index: int | None = None,
          lane_offset: int | None = None,
          lane_total: int | None = None, with_stats: bool = False):
    """Trace eye rays to radiance ``[N, 3]``.

    ``lane_offset``/``lane_total``: the rays are columns ``[lane_offset,
    lane_offset + N)`` of a ``lane_total``-wide frame, and draw that window
    of the global tape. ``with_stats=True`` also returns the counts of
    useful work over alive lanes, as the CUDA kernel does it:
    ``extension_segments`` (rays scanned for their nearest hit),
    ``hit_segments`` (of those, the ones that hit and are shaded),
    ``diffuse_vertices`` (NEE and diffuse scatter), ``shadow_setups``
    (light samples and valid VPL slots set up), ``shadow_rays`` (those
    that face the vertex and are cast), ``shadow_tests`` (the
    ray-sphere tests of those rays up to their first blocker) and
    ``shadow_lit`` (the cast samples that no sphere blocks).
    """
    n = rays.o.shape[0]
    dev = rays.o.device
    n_lights = max(len(light_idx), 1)

    def draws(depth, purpose, k):
        return rng.site_uniforms(key, sample, depth, purpose, k, n,
                                 device=dev, lane_offset=lane_offset,
                                 lane_total=lane_total)

    o, d = rays.o, rays.d
    rad = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    specular = torch.ones((n,), dtype=torch.bool, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    stats = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in (
        "extension_segments", "hit_segments", "diffuse_vertices",
        "shadow_setups", "shadow_rays", "shadow_tests", "shadow_lit")}

    for depth in range(cfg.max_depth):
        hit, t, hit_id = isect.intersect(scene, o, d)
        if with_stats:
            stats["extension_segments"] += alive.sum()
            stats["hit_segments"] += (alive & hit).sum()
        alive = alive & hit
        t = torch.where(hit, t, torch.ones_like(t))
        obj_p, obj_e, obj_c, obj_refl = isect.gather_sphere_attrs(scene, hit_id)

        hp = o + vm.smul(t, d)
        normal = vm.norm(hp - obj_p, eps=1e-20)
        dp = vm.dot(normal, d)
        nl = vm.smul(torch.where(dp > 0.0, -1.0, 1.0), normal)

        # Emitter hit: emission on specular chains, then the path ends.
        is_emitter = torch.logical_not(vm.is_zero(obj_e))
        emit = vm.smul(cfg.emission_scale * torch.abs(dp), obj_e) * throughput
        add = (alive & is_emitter & specular)[:, None]
        rad = rad + torch.where(add, emit, torch.zeros_like(emit))
        alive = alive & torch.logical_not(is_emitter)

        # NEE at diffuse vertices.
        is_diff = obj_refl == DIFF
        tp_after_diff = throughput * obj_c
        light_u = draws(depth, rng.LIGHT_UV, 2 * n_lights).reshape(
            n_lights, 2, n)
        work = {} if with_stats else None
        ld = nee.sample_lights(scene, cfg, light_idx, hp, nl, light_u,
                               vpls=vpls, vlp_index=vlp_index, work=work)
        use = (alive & is_diff)[:, None]
        nee_rad = tp_after_diff * ld
        rad = rad + torch.where(use, nee_rad, torch.zeros_like(nee_rad))
        if with_stats:
            stats["diffuse_vertices"] += use.sum()
            for k, per_lane in work.items():
                stats[k] += torch.where(use[:, 0], per_lane, 0).sum()

        diff_u = draws(depth, rng.DIFF_UV, 2)
        rr_u = draws(depth, rng.REFR_RR, 1)[0]
        sc = bsdf.scatter(obj_refl, obj_c, d, normal, nl,
                          diff_u[0], diff_u[1], rr_u)
        live = alive[:, None]
        o = torch.where(live, hp, o)
        d = torch.where(live, sc.new_d, d)
        throughput = torch.where(live, throughput * sc.tp_mul, throughput)
        specular = torch.where(alive, sc.specular, specular)

    if with_stats:
        return rad, {k: int(v) for k, v in stats.items()}
    return rad
