"""Vectorized eye-path tracer.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/path_tracer.py::trace``
(its direct-form sphere scans, without lane compaction). A batch of N rays
advances one bounce per iteration with an ``alive`` mask: nearest hit,
emission on specular chains, next-event estimation with the VPL gather at
diffuse vertices, then diffuse/mirror/glass scatter. All randomness comes
from `rng.site_uniforms` sites addressed by ``(sample, depth, purpose)``.

One bounce is `depth_step` on a :class:`PathState`. The tracer loops it
over the depths, and so does `ops.pallas_bounce.bounce_plain`, the plain
version of the per-depth bounce kernel, so the two agree bit for bit.

This is also the plain version of the CUDA eye-path kernel in ray mode
(`ops.pallas_trace.trace_pallas`): same estimator, same tape. Its two
extra modes serve the many-sphere gradient (`ops.pallas_bounce_grad`):
``collect_aux`` also returns the detached facts of the walk (hit ids,
occlusion), and ``aux`` re-walks from such facts with no sphere scan.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

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

STATS = ("extension_segments", "hit_segments", "diffuse_vertices",
         "shadow_setups", "shadow_rays", "shadow_tests", "shadow_lit")


class PathState(NamedTuple):
    """The eye paths between two depths."""

    o: Tensor           # [N, 3]
    d: Tensor           # [N, 3]
    rad: Tensor         # [N, 3] radiance so far
    throughput: Tensor  # [N, 3]
    specular: Tensor    # [N] bool: the last bounce was not diffuse
    alive: Tensor       # [N] bool


def initial_state(rays: Rays) -> PathState:
    n, dev = rays.o.shape[0], rays.o.device
    return PathState(
        o=rays.o, d=rays.d,
        rad=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        specular=torch.ones((n,), dtype=torch.bool, device=dev),
        alive=torch.ones((n,), dtype=torch.bool, device=dev))


def tape_draws(key: rng.Key, sample: int, n: int, device,
               lane_offset: int | None = None,
               lane_total: int | None = None) -> Callable:
    """``draws(depth, purpose, k)``: the ``[k, n]`` uniforms of one draw
    site for these lanes."""
    def draws(depth, purpose, k):
        return rng.site_uniforms(key, sample, depth, purpose, k, n,
                                 device=device, lane_offset=lane_offset,
                                 lane_total=lane_total)
    return draws


def depth_step(scene: Scene, cfg: IntegratorConfig,
               light_idx: tuple[int, ...], state: PathState, draws: Callable,
               depth: int, vpls: VplBuffer | None = None,
               vlp_index: int | None = None, direct_only: bool = False,
               facts=None, collect: bool = False,
               stats: dict | None = None):
    """One bounce of every lane: ``(state, facts | None)``.

    ``facts = (hit_id [N] int, occ_light [N, L] bool, occ_vpl [N, K] bool
    | None)`` of this depth replace the nearest-hit scan (the hit distance
    is `intersect.sphere_root` of the given sphere) and the shadow scans.
    ``collect`` returns this depth's facts in that form: the hit id where
    a live lane hit, else -1; a slot is occluded (True) unless its sample
    reached a vertex that uses it (a live diffuse vertex), so a slot whose
    shadow ray was never cast reads as blocked. ``stats`` accumulates the
    counts of `trace`'s ``with_stats``.
    """
    o, d, rad, throughput, specular, alive = state
    n, n_lights = o.shape[0], max(len(light_idx), 1)
    if facts is not None:
        given = facts[0].to(torch.int64)
        hit = given >= 0
        hit_id = torch.clamp(given, min=0)
        obj_p, obj_e, obj_c, obj_refl, obj_rad = isect.gather_sphere_attrs(
            scene, hit_id, with_rad=True)
        t = isect.sphere_root(o, d, obj_p, obj_rad)
    else:
        hit, t, hit_id = isect.intersect(scene, o, d)
        obj_p, obj_e, obj_c, obj_refl = isect.gather_sphere_attrs(scene,
                                                                  hit_id)
    if stats is not None:
        stats["extension_segments"] += alive.sum()
        stats["hit_segments"] += (alive & hit).sum()
    live_hit = alive & hit
    alive = live_hit
    t = torch.where(hit, t, torch.ones_like(t))

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
    work = {} if stats is not None else None
    ld = nee.sample_lights(
        scene, cfg, light_idx, hp, nl, light_u, vpls=vpls,
        vlp_index=vlp_index, work=work,
        occ_light=None if facts is None else facts[1],
        occ_vpl=None if facts is None else facts[2], with_occ=collect)
    if collect:
        ld, reached_l, reached_v = ld
    use = (alive & is_diff)[:, None]
    nee_rad = tp_after_diff * ld
    rad = rad + torch.where(use, nee_rad, torch.zeros_like(nee_rad))
    if stats is not None:
        stats["diffuse_vertices"] += use.sum()
        for k, per_lane in work.items():
            stats[k] += torch.where(use[:, 0], per_lane, 0).sum()
    out_facts = None
    if collect:
        out_facts = (
            torch.where(live_hit, hit_id, -1).to(torch.int32),
            torch.logical_not(reached_l & use),
            None if reached_v is None
            else torch.logical_not(reached_v & use))

    if direct_only:
        # A diffuse vertex ends the path after its NEE; specular chains
        # go on (the reference's RadianceDirectLighting).
        alive = alive & torch.logical_not(is_diff)

    diff_u = draws(depth, rng.DIFF_UV, 2)
    rr_u = draws(depth, rng.REFR_RR, 1)[0]
    sc = bsdf.scatter(obj_refl, obj_c, d, normal, nl,
                      diff_u[0], diff_u[1], rr_u)
    live = alive[:, None]
    state = PathState(
        o=torch.where(live, hp, o),
        d=torch.where(live, sc.new_d, d),
        rad=rad,
        throughput=torch.where(live, throughput * sc.tp_mul, throughput),
        specular=torch.where(alive, sc.specular, specular),
        alive=alive)
    return state, out_facts


def trace(scene: Scene, cfg: IntegratorConfig, light_idx: tuple[int, ...],
          rays: Rays, key: rng.Key, sample: int,
          vpls: VplBuffer | None = None, vlp_index: int | None = None,
          direct_only: bool = False, remat: bool = False,
          lane_offset: int | None = None,
          lane_total: int | None = None, with_stats: bool = False,
          aux=None, collect_aux: bool = False):
    """Trace eye rays to radiance ``[N, 3]``.

    ``direct_only``: a diffuse vertex ends its path after next-event
    estimation (the direct-lighting integrator). ``lane_offset``/
    ``lane_total``: the rays are columns ``[lane_offset, lane_offset + N)``
    of a ``lane_total``-wide frame, and draw that window of the global
    tape. ``remat`` is accepted for the JAX signature and ignored: with
    ``aux`` the walk saves no ``[N, S]`` tensor for the backward, so its
    memory stays small without checkpointing.

    ``aux = (hit_id [D, N] int32, occ_light [D, N, L] bool, occ_vpl [D,
    N, K] bool | None)``: detached facts of a prior walk (the CUDA fact
    kernel's, or this tracer's own). The walk then runs no sphere scan;
    hit ids and occlusion are detached in the estimator anyway, so its
    values and gradients are those of the full-scan walk.
    ``collect_aux=True`` returns ``(radiance, aux)``, the facts of this
    walk in that form (`depth_step`).

    ``with_stats=True`` also returns the counts of useful work over alive
    lanes, as the CUDA kernel does it: ``extension_segments`` (rays
    scanned for their nearest hit), ``hit_segments`` (of those, the ones
    that hit and are shaded), ``diffuse_vertices`` (NEE and diffuse
    scatter), ``shadow_setups`` (light samples and valid VPL slots set
    up), ``shadow_rays`` (those that face the vertex and are cast),
    ``shadow_tests`` (the ray-sphere tests of those rays up to their
    first blocker) and ``shadow_lit`` (the cast samples that no sphere
    blocks).
    """
    del remat
    n = rays.o.shape[0]
    dev = rays.o.device
    draws = tape_draws(key, sample, n, dev, lane_offset, lane_total)
    state = initial_state(rays)
    stats = ({k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in STATS} if with_stats else None)
    collected = []
    for depth in range(cfg.max_depth):
        facts = None if aux is None else (
            aux[0][depth], aux[1][depth],
            None if aux[2] is None else aux[2][depth])
        state, got = depth_step(scene, cfg, light_idx, state, draws, depth,
                                vpls, vlp_index, direct_only, facts,
                                collect_aux, stats)
        collected.append(got)

    if with_stats:
        return state.rad, {k: int(v) for k, v in stats.items()}
    if collect_aux:
        occ_v = [f[2] for f in collected]
        return state.rad, (
            torch.stack([f[0] for f in collected]),
            torch.stack([f[1] for f in collected]),
            None if occ_v[0] is None else torch.stack(occ_v))
    return state.rad
