"""Next-event estimation: explicit light sampling and the VPL gather.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/direct.py`` (forward
only). Per light, one uniform sample on the whole sphere surface, rejected
when it faces away, contribution ``e * gain * (4 pi r^2) * wi * wo /
len^2``. The VPL gather reads the window ``vlp_index .. vlp_index +
max_vlp`` (wrapping modulo ``light_points``) of every VPL depth, with
shadow rays that pass through emitters, and averages over the window.
``sample_lights`` combines the two as ``(direct + vpl) / 2``.

The shadow scans take the tracer's ``scan_backend``: ``"xla"`` the direct
all-pairs test, ``"mxu"`` its matmul form, ``"pallas"`` the any-hit scan
kernel (`ops.pallas_scan.anyhit_tiles`, forward only), which may skip the
segments of lanes outside ``active`` (the caller's live diffuse lanes,
whose contributions are the only ones it keeps). Occlusion can also come
from outside (``occ_light``/``occ_vpl``, which take precedence): the
re-walk of the many-sphere gradient reads it off the facts of a prior
pass instead of scanning, and ``with_occ`` returns it, for the collector.

With ``cfg.vis_grad_tau > 0`` both terms add a straight-through
visibility carrier: ``x - x.detach()`` with ``x = stop(contrib) *
intersect.soft_visibility(...)`` over every sample that faces the vertex,
occluded or not. Its value is exactly 0, so images do not change; its
gradient moves occluders, lights and VPLs across shadow edges. It runs
whatever the source of the occlusion, given facts included.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    EPSILON,
    IntegratorConfig,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect
from gpu_bidirectional_raytracer_tpu_torch.integrators.sampling import (
    uniform_sphere,
)

_TINY = 1e-20


def static_light_indices(scene: Scene) -> tuple[int, ...]:
    """Host-side: indices of the emissive spheres, in scan order."""
    e = scene.e.cpu().numpy()
    return tuple(int(i) for i in range(e.shape[0]) if (e[i] != 0.0).any())


def _segments(target: Tensor, hp: Tensor):
    """Unit directions, lengths and shadow ``maxt`` from ``hp [N,3]`` to
    ``target [N,K,3]``."""
    sdir = target - hp[:, None, :]
    len_sq = vm.dot(sdir, sdir)
    length = torch.where(len_sq > 0.0, torch.sqrt(len_sq),
                         torch.zeros_like(len_sq))
    sdir = sdir / torch.clamp(length, min=_TINY)[..., None]
    return sdir, length, length - EPSILON


def _occluded(scene: Scene, hp: Tensor, sdir: Tensor, maxt: Tensor,
              vacuum: bool, scan_backend: str, active: Tensor | None
              ) -> Tensor:
    """Shadow any-hit ``[N, K]`` of the segments from ``hp [N, 3]`` along
    ``sdir [N, K, 3]`` up to ``maxt [N, K]``, flattened lane-major as
    JAX's scans take them."""
    flat_o = hp[:, None, :].expand_as(sdir).reshape(-1, 3)
    flat_d, flat_maxt = sdir.reshape(-1, 3), maxt.reshape(-1)
    if scan_backend == "pallas":
        from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan

        act = (torch.ones_like(hp[:, 0], dtype=torch.bool) if active is None
               else active)
        occ = pallas_scan.anyhit_tiles(
            scene, flat_o, flat_d, flat_maxt,
            act[:, None].expand(maxt.shape).reshape(-1), vacuum=vacuum)
    else:
        test = isect.intersect_p_vacuum if vacuum else isect.intersect_p
        occ = test(scene, flat_o, flat_d, flat_maxt,
                   method="mxu" if scan_backend == "mxu" else "direct")
    return occ.reshape(maxt.shape)


def _count_shadow_work(work: dict, scene: Scene, hp: Tensor, sdir: Tensor,
                       maxt: Tensor, set_up: Tensor, cast: Tensor,
                       lit: Tensor, vacuum: bool,
                       blockers: Tensor | None) -> None:
    """Adds one NEE term's shadow work per lane ``[N]`` to ``work``: the
    samples set up (``set_up [N, K]``), the shadow rays cast (``cast [N,
    K]``), the sphere tests those rays make before their first blocker,
    and the samples that reach the vertex (``lit [N, K]``: the ones the
    adjoint kernel differentiates). With the visibility carrier,
    ``blockers [K]`` are the candidate blockers of each slot's soft
    product, and ``carrier_terms`` counts two blocker terms (the product,
    then its adjoint) per candidate of every cast sample.
    """
    tests = isect.anyhit_tests(
        scene, hp[:, None, :].expand_as(sdir).reshape(-1, 3),
        sdir.reshape(-1, 3), maxt.reshape(-1), vacuum).reshape(cast.shape)
    terms = (torch.zeros_like(cast, dtype=torch.int64) if blockers is None
             else torch.where(cast, 2 * blockers[None, :], 0))
    for name, per_slot in (("shadow_setups", set_up), ("shadow_rays", cast),
                           ("shadow_tests", torch.where(cast, tests, 0)),
                           ("shadow_lit", lit), ("carrier_terms", terms)):
        work[name] = work.get(name, 0) + per_slot.sum(dim=-1)


def _vis_carrier(scene: Scene, cfg: IntegratorConfig, hp: Tensor,
                 sdir: Tensor, maxt: Tensor, contrib: Tensor, cast: Tensor,
                 exclude: Tensor, vacuum: bool) -> Tensor:
    """The zero-primal visibility carrier ``[N, K, 3]`` of samples whose
    segments run from ``hp [N, 3]`` along ``sdir [N, K, 3]`` up to ``maxt
    [N, K]``: ``x - x.detach()`` with ``x = stop(contrib) * soft`` where
    the sample faces the vertex (``cast [N, K]``). ``exclude [K]``: the
    sphere each slot's soft product leaves out."""
    flat_o = hp[:, None, :].expand_as(sdir).reshape(-1, 3)
    soft = isect.soft_visibility(
        scene, flat_o, sdir.reshape(-1, 3), maxt.reshape(-1),
        cfg.vis_grad_tau, vacuum=vacuum,
        exclude_id=exclude[None, :].expand(cast.shape).reshape(-1)
    ).reshape(cast.shape)
    carrier = torch.where(cast[..., None], contrib,
                          torch.zeros_like(contrib)).detach() * soft[..., None]
    return carrier - carrier.detach()


def sample_direct(scene: Scene, cfg: IntegratorConfig,
                  light_idx: tuple[int, ...], hp: Tensor, nl: Tensor,
                  light_u: Tensor, work: dict | None = None,
                  occ_override: Tensor | None = None,
                  with_occ: bool = False, scan_backend: str = "xla",
                  active: Tensor | None = None):
    """Direct light at ``hp [N,3]`` with shading normal ``nl [N,3]``.
    ``light_u [L, 2, N]`` are the uniforms of each light slot. ``work``,
    when given, receives the shadow work per lane (`_count_shadow_work`).
    ``occ_override [N, L]``: the occlusion of each sample, given, in place
    of the shadow scan. ``with_occ`` returns ``(radiance, occluded [N, L],
    reached [N, L])``, where ``reached`` is the gate of the contribution
    (facing, ``wi > 0`` and not occluded). ``scan_backend`` and ``active
    [N]`` choose the shadow scan (see the module note)."""
    n = hp.shape[0]
    out = torch.zeros((n, 3), dtype=hp.dtype, device=hp.device)
    if not light_idx:
        none = torch.zeros((n, 0), dtype=torch.bool, device=hp.device)
        return (out, none, none) if with_occ else out
    li = torch.tensor(light_idx, dtype=torch.int64, device=hp.device)
    lp, lrad, le = scene.p[li], scene.rad[li], scene.e[li]

    usp = uniform_sphere(light_u[:, 0, :].T, light_u[:, 1, :].T)  # [N, L, 3]
    sphere_point = lp[None, :, :] + lrad[None, :, None] * usp
    sdir, length, maxt = _segments(sphere_point, hp)

    wo = vm.dot(sdir, usp)
    facing = wo <= 0.0
    wo = -wo
    wi = vm.dot(sdir, nl[:, None, :])
    occluded = (occ_override if occ_override is not None else _occluded(
        scene, hp, sdir, maxt, False, scan_backend, active))

    scale = ((4.0 * math.pi) * lrad * lrad)[None, :] * wi * wo / torch.clamp(
        length * length, min=_TINY)
    contrib = le[None, :, :] * (cfg.light_gain * scale)[..., None]
    cast = facing & (wi > 0.0)
    mask = cast & torch.logical_not(occluded)
    hard = torch.where(mask[..., None], contrib, torch.zeros_like(contrib))
    vis = cfg.vis_grad_tau > 0.0
    if vis:   # the target light's chord starts at its sample point
        hard = hard + _vis_carrier(scene, cfg, hp, sdir, maxt, contrib,
                                   cast, li, vacuum=False)
    if work is not None:
        blockers = (torch.full_like(li, scene.num_spheres - 1) if vis
                    else None)
        _count_shadow_work(work, scene, hp, sdir, maxt,
                           torch.ones_like(cast), cast, mask, False,
                           blockers)
    for slot in range(len(light_idx)):
        out = out + hard[:, slot]
    return (out, occluded, mask) if with_occ else out


def vpl_window(cfg: IntegratorConfig, vpls: VplBuffer, vlp_index: int):
    """The gathered VPLs ``(hp, rad, nl, valid, sid)``, each ``[K, ...]``
    with ``K = vpl_depth * max_vlp`` (depth-major); ``sid`` is each VPL's
    host sphere, -1 where the buffer records none."""
    raw = torch.arange(cfg.max_vlp, device=vpls.hp.device) + int(vlp_index)
    if cfg.stale_vpl_window:
        # The reference's window slides off the end: slots past it are
        # treated as invalid.
        lanes = torch.clamp(raw, max=cfg.light_points - 1)
        in_range = raw < cfg.light_points
    else:
        lanes = raw % cfg.light_points
        in_range = torch.ones_like(raw, dtype=torch.bool)
    d_ = cfg.vpl_depth
    return (vpls.hp[:d_, lanes].reshape(-1, 3),
            vpls.rad[:d_, lanes].reshape(-1, 3),
            vpls.nl[:d_, lanes].reshape(-1, 3),
            (vpls.valid[:d_, lanes] & in_range[None, :]).reshape(-1),
            torch.full_like(raw[None, :].expand(d_, -1), -1).reshape(-1)
            if vpls.sid is None else vpls.sid[:d_, lanes].reshape(-1))


def gather_vpls(scene: Scene, cfg: IntegratorConfig, vpls: VplBuffer,
                vlp_index: int, hp: Tensor, nl: Tensor,
                work: dict | None = None,
                occ_override: Tensor | None = None, with_occ: bool = False,
                scan_backend: str = "xla", active: Tensor | None = None):
    """The VPL gather at ``hp``, averaged over the window: ``[N, 3]``.
    ``occ_override [N, K]``, ``with_occ``, ``scan_backend`` and ``active``
    as in `sample_direct`; the gate of a slot also needs the slot to be
    valid. Its shadow rays pass through emitters (the vacuum scan), and
    its visibility carrier leaves out each VPL's host sphere."""
    w_hp, w_rad, w_nl, w_valid, w_sid = vpl_window(cfg, vpls, vlp_index)
    k = w_hp.shape[0]
    sdir, length, maxt = _segments(w_hp[None, :, :].expand(
        hp.shape[0], k, 3), hp)
    wo = vm.dot(sdir, w_nl[None, :, :])
    facing = wo <= 0.0
    wo = -wo
    wi = vm.dot(sdir, nl[:, None, :])
    occluded = (occ_override if occ_override is not None else _occluded(
        scene, hp, sdir, maxt, True, scan_backend, active))
    contrib = w_rad[None, :, :] * (wi * wo)[..., None]
    cast = facing & (wi > 0.0) & w_valid[None, :]
    mask = cast & torch.logical_not(occluded)
    hard = torch.where(mask[..., None], contrib, torch.zeros_like(contrib))
    vis = cfg.vis_grad_tau > 0.0
    if vis:
        hard = hard + _vis_carrier(scene, cfg, hp, sdir, maxt, contrib,
                                   cast, w_sid.to(torch.int64), vacuum=True)
    if work is not None:
        blockers = None
        if vis:   # the non-emitters, less a non-emitting host
            solid = torch.logical_not(scene.is_light())
            host = w_sid.to(torch.int64)
            in_scene = (host >= 0) & (host < scene.num_spheres)
            blockers = solid.sum() - (in_scene & solid[
                torch.clamp(host, 0, scene.num_spheres - 1)]).to(torch.int64)
        _count_shadow_work(work, scene, hp, sdir, maxt,
                           w_valid[None, :].expand_as(cast), cast, mask,
                           True, blockers)
    total = hard[:, 0]
    for v in range(1, k):
        total = total + hard[:, v]
    # Times the reciprocal, not divided: PyTorch on the card turns a
    # division by a host scalar into this product anyway, so the plain
    # version rounds alike on every device and like the CUDA kernel.
    total = total * (1.0 / k)
    return (total, occluded, mask) if with_occ else total


def sample_lights(scene: Scene, cfg: IntegratorConfig,
                  light_idx: tuple[int, ...], hp: Tensor, nl: Tensor,
                  light_u: Tensor, vpls: VplBuffer | None = None,
                  vlp_index: int | None = None,
                  work: dict | None = None,
                  occ_light: Tensor | None = None,
                  occ_vpl: Tensor | None = None, with_occ: bool = False,
                  scan_backend: str = "xla", active: Tensor | None = None):
    """Full NEE: direct light plus, with VPLs, the ``(direct + vpl) / 2``
    combine. ``occ_light [N, L]``/``occ_vpl [N, K]``: occlusion given in
    place of the shadow scans. ``with_occ`` returns ``(radiance,
    reached_light [N, L], reached_vpl [N, K] | None)``, the gates of
    `sample_direct` and `gather_vpls`. ``scan_backend`` and ``active``
    choose the shadow scans (see the module note)."""
    direct = sample_direct(scene, cfg, light_idx, hp, nl, light_u, work,
                           occ_light, with_occ, scan_backend, active)
    if with_occ:
        direct, _, reached_l = direct
    if not cfg.use_vpl or vpls is None:
        return (direct, reached_l, None) if with_occ else direct
    vpl = gather_vpls(scene, cfg, vpls, vlp_index, hp, nl, work, occ_vpl,
                      with_occ, scan_backend, active)
    if with_occ:
        vpl, _, reached_v = vpl
    total = direct + vpl
    total = total * 0.5 if cfg.combine_half else total
    return (total, reached_l, reached_v) if with_occ else total
