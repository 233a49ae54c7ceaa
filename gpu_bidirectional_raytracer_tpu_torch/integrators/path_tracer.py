"""Vectorized eye-path tracer.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/path_tracer.py::trace``.
A batch of N rays advances one bounce per iteration with an ``alive``
mask: nearest hit, emission on specular chains, next-event estimation with
the VPL gather at diffuse vertices, then diffuse/mirror/glass scatter. All
randomness comes from `rng.site_uniforms` sites addressed by ``(sample,
depth, purpose)``.

One bounce is `depth_step` on a :class:`PathState`. The tracer loops it
over the depths, and so does `ops.pallas_bounce.bounce_plain`, the plain
version of the per-depth bounce kernel, so the two agree bit for bit.

The three sphere scans of a depth (nearest hit, light shadow rays, VPL
shadow rays) take ``scan_backend``: ``"xla"`` the direct all-pairs form,
``"mxu"`` its matmul form (`intersect.sphere_distances`), ``"pallas"`` the
scan kernels of `ops.pallas_scan` (forward only; the nearest kernel also
returns the hit sphere's attributes). With ``"pallas"``, ``scan_compact``
moves the live lanes to the front before each depth, so that whole warps
of dead lanes skip their scans; every per-lane value is unchanged.

This is also the plain version of the CUDA eye-path kernel in ray mode
(`ops.pallas_trace.trace_pallas`): same estimator, same tape. Its two
extra modes serve the many-sphere gradient (`ops.pallas_bounce_grad`):
``collect_aux`` also returns the detached facts of the walk (hit ids,
occlusion) and the decisions a cross-backend census compares, and ``aux``
re-walks from such facts with no sphere scan.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    EPSILON,
    IntegratorConfig,
    Rays,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import bsdf
from gpu_bidirectional_raytracer_tpu_torch.integrators import direct as nee
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect

SCAN_BACKENDS = ("xla", "mxu", "pallas")
STATS = ("extension_segments", "hit_segments", "diffuse_vertices",
         "shadow_setups", "shadow_rays", "shadow_tests", "shadow_lit",
         "carrier_terms")


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
               stats: dict | None = None, scan_backend: str = "xla"):
    """One bounce of every lane: ``(state, facts | None)``.

    ``facts = (hit_id [N] int, occ_light [N, L] bool, occ_vpl [N, K] bool
    | None)`` of this depth replace the nearest-hit scan (the hit distance
    is `intersect.sphere_root` of the given sphere) and the shadow scans.
    ``collect`` returns this depth's facts in that form: the hit id where
    a live lane hit, else -1; a slot is occluded (True) unless its sample
    reached a vertex that uses it (a live diffuse vertex), so a slot whose
    shadow ray was never cast reads as blocked. Three census entries
    follow, as JAX's collector gives them: the light samples that reached
    a live diffuse vertex ``[N, L]``, the glass branch bits of the lanes
    still alive (else -1), and whether a live hit took the near root
    (else -1). ``stats`` accumulates the counts of `trace`'s
    ``with_stats``. ``scan_backend`` as in `trace`.
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
    elif scan_backend == "pallas":
        from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan

        (hit, t, hit_id, obj_p, obj_e, obj_c,
         obj_refl) = pallas_scan.nearest_tiles(scene, o, d, alive)
    else:
        hit, t, hit_id = isect.intersect(
            scene, o, d, method="mxu" if scan_backend == "mxu" else "direct")
        obj_p, obj_e, obj_c, obj_refl, *obj_rad = isect.gather_sphere_attrs(
            scene, hit_id, with_rad=collect)
        obj_rad = obj_rad[0] if collect else None
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
    use = (alive & is_diff)[:, None]
    ld = nee.sample_lights(
        scene, cfg, light_idx, hp, nl, light_u, vpls=vpls,
        vlp_index=vlp_index, work=work,
        occ_light=None if facts is None else facts[1],
        occ_vpl=None if facts is None else facts[2], with_occ=collect,
        scan_backend=scan_backend, active=use[:, 0])
    if collect:
        ld, reached_l, reached_v = ld
    nee_rad = tp_after_diff * ld
    rad = rad + torch.where(use, nee_rad, torch.zeros_like(nee_rad))
    if stats is not None:
        stats["diffuse_vertices"] += use.sum()
        for k, per_lane in work.items():
            stats[k] += torch.where(use[:, 0], per_lane, 0).sum()

    if direct_only:
        # A diffuse vertex ends the path after its NEE; specular chains
        # go on (the reference's RadianceDirectLighting).
        alive = alive & torch.logical_not(is_diff)

    diff_u = draws(depth, rng.DIFF_UV, 2)
    rr_u = draws(depth, rng.REFR_RR, 1)[0]
    sc = bsdf.scatter(obj_refl, obj_c, d, normal, nl,
                      diff_u[0], diff_u[1], rr_u, with_bits=collect)
    out_facts = None
    if collect:
        sc, bits = sc
        out_facts = (
            torch.where(live_hit, hit_id, -1).to(torch.int32),
            torch.logical_not(reached_l & use),
            None if reached_v is None
            else torch.logical_not(reached_v & use),
            reached_l & use,
            torch.where(alive, bits, -1),
            torch.where(live_hit, _near_root(o, d, obj_p, obj_rad), -1))
    live = alive[:, None]
    state = PathState(
        o=torch.where(live, hp, o),
        d=torch.where(live, sc.new_d, d),
        rad=rad,
        throughput=torch.where(live, throughput * sc.tp_mul, throughput),
        specular=torch.where(alive, sc.specular, specular),
        alive=alive)
    return state, out_facts


def _near_root(o: Tensor, d: Tensor, p: Tensor, rad: Tensor) -> Tensor:
    """``[N]`` int32: whether the hit took the near root (``b - sqrt(det)
    > EPSILON``), the census bit of JAX's collector. A flip swaps the
    entry and the exit of the same sphere, which the hit id cannot show
    (the camera sits inside Cornell's wall spheres)."""
    op = p - o
    b = vm.dot(op, d)
    det = b * b - vm.dot(op, op) + rad * rad
    pos = det > 0.0
    sq = torch.where(pos, torch.sqrt(torch.clamp(det, min=1e-6)),
                     torch.zeros_like(det))
    return ((b - sq) > EPSILON).to(torch.int32)


def _partition_live(state: PathState, pix_id: Tensor):
    """The live lanes moved to the front, each part in lane order: sorted
    by the unique key ``(not alive) * n + lane``, so the order is the same
    on every device. Returns the permuted state and pixel ids."""
    n = pix_id.shape[0]
    lane = torch.arange(n, device=pix_id.device)
    perm = torch.argsort(torch.where(state.alive, 0, n) + lane)
    return PathState(*(x[perm] for x in state)), pix_id[perm]


def _checkpointed(step: Callable, state: PathState, stats: dict | None):
    """``step(state, stats=...)`` with its intermediates recomputed in the
    backward instead of kept (`torch.utils.checkpoint`): only the state
    between depths stays alive. The recomputation counts no stats."""
    runs = []

    def run(st):
        counted = None if runs else stats
        runs.append(True)
        return step(st, stats=counted)

    return torch.utils.checkpoint.checkpoint(
        run, state, use_reentrant=False, preserve_rng_state=False)


def trace(scene: Scene, cfg: IntegratorConfig, light_idx: tuple[int, ...],
          rays: Rays, key: rng.Key, sample: int,
          vpls: VplBuffer | None = None, vlp_index: int | None = None,
          direct_only: bool = False, remat: bool = False,
          lane_offset: int | None = None,
          lane_total: int | None = None, with_stats: bool = False,
          scan_backend: str = "xla", scan_compact: bool = False,
          aux=None, collect_aux: bool = False):
    """Trace eye rays to radiance ``[N, 3]``.

    ``direct_only``: a diffuse vertex ends its path after next-event
    estimation (the direct-lighting integrator). ``lane_offset``/
    ``lane_total``: the rays are columns ``[lane_offset, lane_offset + N)``
    of a ``lane_total``-wide frame, and draw that window of the global
    tape. ``remat=True`` checkpoints each depth under autograd: its
    intermediates (the ``[N, S]`` scans) are recomputed in the backward
    and only the state between depths is kept; values and gradients are
    the same bits either way.

    ``scan_backend``: ``"xla"``, ``"mxu"`` or ``"pallas"`` (see the module
    note); ``"pallas"`` is forward only and raises under autograd.
    ``scan_compact=True`` (with ``"pallas"`` only) partitions the live
    lanes to the front before each depth, draws that depth's tape by
    pixel id, and returns the radiance in pixel order: the same bits as
    without it.

    ``aux = (hit_id [D, N] int32, occ_light [D, N, L] bool, occ_vpl [D,
    N, K] bool | None, ...)``: detached facts of a prior walk (the CUDA
    fact kernel's, or this tracer's own). The walk then runs no sphere
    scan, whatever ``scan_backend``; hit ids and occlusion are detached in
    the estimator anyway, so its values and gradients are those of the
    full-scan walk. ``collect_aux=True`` returns ``(radiance, aux)``, the
    facts of this walk in that form followed by the three census entries
    of `depth_step`, each stacked over the depths.

    ``with_stats=True`` also returns the counts of useful work over alive
    lanes, as the CUDA kernel does it: ``extension_segments`` (rays
    scanned for their nearest hit), ``hit_segments`` (of those, the ones
    that hit and are shaded), ``diffuse_vertices`` (NEE and diffuse
    scatter), ``shadow_setups`` (light samples and valid VPL slots set
    up), ``shadow_rays`` (those that face the vertex and are cast),
    ``shadow_tests`` (the ray-sphere tests of those rays up to their
    first blocker), ``shadow_lit`` (the cast samples that no sphere
    blocks) and, with ``cfg.vis_grad_tau > 0``, ``carrier_terms`` (the
    blocker terms of the visibility carrier: two per candidate blocker of
    every cast sample, the soft product and its adjoint; else 0).
    """
    if scan_backend not in SCAN_BACKENDS:
        raise ValueError(f"unknown scan_backend {scan_backend!r}")
    compact = scan_backend == "pallas" and scan_compact
    if collect_aux and scan_backend == "pallas":
        raise ValueError("collect_aux takes scan_backend 'xla' or 'mxu': "
                         "the scan kernels report no root choice")
    if compact and aux is not None:
        raise ValueError("aux facts are in pixel order; scan_compact "
                         "permutes the lanes")
    n = rays.o.shape[0]
    dev = rays.o.device
    draws = tape_draws(key, sample, n, dev, lane_offset, lane_total)
    state = initial_state(rays)
    pix_id = torch.arange(n, device=dev) if compact else None
    stats = ({k: torch.zeros((), dtype=torch.int64, device=dev)
              for k in STATS} if with_stats else None)
    checkpoint = remat and torch.is_grad_enabled() and not collect_aux
    collected = []
    for depth in range(cfg.max_depth):
        facts = None if aux is None else (
            aux[0][depth], aux[1][depth],
            None if aux[2] is None else aux[2][depth])
        depth_draws = draws
        if compact:
            state, pix_id = _partition_live(state, pix_id)
            depth_draws = functools.partial(_draws_at, draws, pix_id)
        step = functools.partial(
            depth_step, scene, cfg, light_idx, draws=depth_draws,
            depth=depth, vpls=vpls, vlp_index=vlp_index,
            direct_only=direct_only, facts=facts, collect=collect_aux,
            scan_backend=scan_backend)
        if checkpoint:
            state, got = _checkpointed(step, state, stats)
        else:
            state, got = step(state, stats=stats)
        collected.append(got)

    rad = state.rad
    if compact:
        rad = torch.empty_like(rad)
        rad[pix_id] = state.rad
    if with_stats:
        return rad, {k: int(v) for k, v in stats.items()}
    if collect_aux:
        return rad, tuple(
            None if collected[0][i] is None
            else torch.stack([f[i] for f in collected])
            for i in range(len(collected[0])))
    return rad


def _draws_at(draws: Callable, pix_id: Tensor, depth: int, purpose: int,
              k: int) -> Tensor:
    """The ``[k, n]`` draws of a site at permuted lanes: row entries
    gathered by pixel id."""
    return draws(depth, purpose, k)[:, pix_id]
