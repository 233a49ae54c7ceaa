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

`splat_to_film` projects the deposits onto the film for the light-tracing
integrator (`render.progressive.light_splat_pass`).
"""

from __future__ import annotations

import math

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


def _segment_sums(keys: Tensor, values: Tensor, n_bins: int) -> Tensor:
    """``[n_bins, C]``: the sum of the rows of ``values [K, C]`` whose key
    is each bin, in an order fixed by the keys alone, so every run (and
    the CPU and the card alike) adds the same numbers in the same order:
    a stable sort by key, then a segmented inclusive scan in log2(K)
    elementwise steps (Hillis-Steele), then each segment's last row
    written to its bin. Keys lie in ``[0, n_bins)``. No float atomics and
    no host synchronisation."""
    k = keys.shape[0]
    sk, order = torch.sort(keys, stable=True)
    v = values[order]
    step = 1
    while step < k:
        same = (sk[step:] == sk[:-step])[:, None]
        tail = v[step:] + torch.where(same, v[:-step], torch.zeros_like(
            v[:-step]))
        v = torch.cat([v[:step], tail])
        step *= 2
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    # Rows that do not end a segment go to spare bins past n_bins, one
    # each, so every write has its own address.
    spare = n_bins + torch.arange(k, device=keys.device)
    out = torch.zeros((n_bins + k, values.shape[1]), dtype=values.dtype,
                      device=values.device)
    out[torch.where(last, sk, spare)] = v
    return out[:n_bins]


def splat_to_film(scene: Scene, cam, cfg: IntegratorConfig,
                  vpls: VplBuffer, width: int, height: int,
                  light_idx: tuple[int, ...] = (),
                  lane_offset: int | None = None) -> tuple[Tensor, Tensor]:
    """Light-trace-to-film splatting (JAX's `splat_to_film`, term for
    term): each valid deposit in front of the camera, inside the film and
    visible from the eye adds ``w * rad`` to the pixel its primary ray
    passes through, with the importance weight

        w = light_gain * 16 pi^2 r^2 f^2 cos_s * D / (a_f tz^3)

    (``r`` the originating light's radius, by global lane id
    ``lane_offset + lane`` round-robin over ``light_idx``; ``f`` the film
    distance ``FILM_KZ``; ``a_f`` the film area of a pixel; ``cos_s`` the
    deposit's tilt towards the eye; ``D`` its distance, ``tz`` its depth).
    The projection uses the exact film extents (``camera.FILM_W/H/KZ``),
    the inverse of `camera.primary_rays`. Environment deposits (whose
    host sphere is an emitter) are splatted only from depth 0.

    Returns ``(color_sum [H,W,3] float32, count [H,W] int32)``: the
    weighted sum (the caller divides by the paths per light) and the raw
    splat count. The sum is a fixed-order segment sum (`_segment_sums`):
    two runs give the same bits on the card, where a scatter-add of
    floats would not."""
    from gpu_bidirectional_raytracer_tpu_torch.camera import (
        FILM_H,
        FILM_KZ,
        FILM_W,
    )
    from gpu_bidirectional_raytracer_tpu_torch.core.types import EPSILON

    dev = scene.device
    n_depth, n_lanes = vpls.hp.shape[0], vpls.hp.shape[1]
    hp = vpls.hp.reshape(-1, 3)
    rad = vpls.rad.reshape(-1, 3)
    nl_flat = vpls.nl.reshape(-1, 3)
    valid = vpls.valid.reshape(-1)
    off = 0 if lane_offset is None else int(lane_offset)
    if light_idx:
        li = torch.tensor(light_idx, dtype=torch.int64, device=dev)
        gid = torch.arange(n_lanes, device=dev) + off
        lane_lrad = scene.rad[li[gid % len(light_idx)]]
    else:
        lane_lrad = torch.ones((n_lanes,), dtype=torch.float32, device=dev)
    lrad = lane_lrad.repeat(n_depth)

    x_hat, y_hat, d_hat = vm.norm(cam.x), vm.norm(cam.y), vm.norm(cam.dir)
    v = hp - cam.orig[None, :]
    tx, ty, tz = vm.dot(v, x_hat), vm.dot(v, y_hat), vm.dot(v, d_hat)
    front = tz > 1e-6
    safe_tz = torch.where(front, tz, torch.ones_like(tz))
    kx = FILM_KZ * tx / safe_tz
    ky = FILM_KZ * ty / safe_tz
    fx = (kx + FILM_W * 0.5) * (width / FILM_W)
    fy = (ky + FILM_H * 0.5) * (height / FILM_H)
    pixx = torch.floor(fx).to(torch.int64)
    pixy = torch.floor(fy).to(torch.int64)
    in_bounds = (pixx >= 0) & (pixx < width) & (pixy >= 0) & (pixy < height)

    # Eye visibility: any blocker strictly nearer than the vertex.
    len_sq = torch.sum(v * v, dim=-1)
    pos = len_sq > 0.0
    dist = torch.where(pos, torch.sqrt(torch.where(
        pos, len_sq, torch.ones_like(len_sq))), torch.zeros_like(len_sq))
    dunit = v / torch.clamp(dist, min=1e-20)[:, None]
    orig_b = cam.orig[None, :].expand(v.shape)
    occluded = isect.intersect_p(scene, orig_b, dunit, dist - EPSILON)

    # Env-VPL rule: depth-0 environment deposits paint the emitter disc;
    # deeper ones are gather-only sky filler.
    host_is_emitter = torch.any(scene.e[vpls.sid.reshape(-1).long()] != 0.0,
                                dim=-1)
    depth_row = torch.arange(n_depth, device=dev).repeat_interleave(n_lanes)
    env_ok = torch.logical_not(host_is_emitter) | (depth_row == 0)

    mask = (valid & front & in_bounds & torch.logical_not(occluded)
            & env_ok)
    a_f = (FILM_W / width) * (FILM_H / height)
    cos_s = torch.abs(torch.sum(nl_flat * (-dunit), dim=-1))
    w = (cfg.light_gain * 16.0 * math.pi ** 2 * lrad * lrad
         * FILM_KZ * FILM_KZ * cos_s * dist / (a_f * safe_tz ** 3))
    ld = torch.where(mask[:, None], w[:, None] * rad, torch.zeros_like(rad))
    hw = height * width
    # Masked deposits go to a spare bin past the film.
    pix = torch.where(mask, pixy * width + pixx, torch.full_like(pixx, hw))
    color_sum = _segment_sums(pix, ld, hw + 1)[:hw]
    count = torch.zeros((hw + 1,), dtype=torch.int32, device=dev)
    count.index_add_(0, pix, torch.ones_like(pix, dtype=torch.int32))
    return color_sum.reshape(height, width, 3), count[:hw].reshape(height,
                                                                   width)
