"""The many-sphere gradient: the fact kernel plus a re-walk under autograd.

Port of ``gpu_bidirectional_raytracer_tpu/ops/pallas_bounce_grad.py``. The
adjoint kernels (`ops.pallas_grad`) take at most 64 spheres, as JAX's do;
above that the gradient splits along what the estimator detaches:

1. ``aux_kernel`` (``csrc/bounce_kernel.cu``, which replaces the TPU
   kernel ``_aux_kernel``) runs the bounce kernel's depths and writes, per
   depth, the discrete facts: the hit sphere and the occlusion of every
   light and VPL sample. These are the only results whose computation
   scans all S spheres, and the estimator stops their gradient anyway.
2. `path_tracer.trace(aux=...)` re-walks the paths under torch autograd
   from those facts, with no sphere scan: the hit distance is the root of
   the given sphere (`intersect.sphere_root`, the scan's own bits) and
   occlusion is read off the facts. Its gradient is the full tracer's.

`trace_bounce_aux` returns the facts; given CPU tensors it loops the plain
version (`ops.pallas_bounce.bounce_plain` with ``collect``). Given CUDA
tensors it launches the kernel or raises. Each launch adds one to
``LAUNCHES["aux_kernel"]``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    IntegratorConfig,
    Rays,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce

FACTS = ("auto", "pallas", "xla")
MAX_FACT_SLOTS = 128    # light + VPL slots of one lane's facts (kLitWords)


def _detached(scene: Scene, rays: Rays, vpls: VplBuffer | None):
    scene = scene.replace(**{k: getattr(scene, k).detach()
                             for k in ("rad", "p", "e", "c")})
    rays = Rays(o=rays.o.detach(), d=rays.d.detach())
    if vpls is not None:
        vpls = VplBuffer(hp=vpls.hp.detach(), rad=vpls.rad.detach(),
                         nl=vpls.nl.detach(), valid=vpls.valid, sid=vpls.sid)
    return scene, rays, vpls


def trace_bounce_aux(scene: Scene, cfg: IntegratorConfig,
                     light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                     sample: int, vpls: VplBuffer | None = None,
                     vlp_index: int | None = None,
                     direct_only: bool = False,
                     lane_offset: int | None = None,
                     lane_total: int | None = None,
                     frame_dims: tuple[int, int] | None = None):
    """The facts of every depth, one ``aux_kernel`` launch per depth:
    ``(aux, rad)`` with ``aux = (hit_id [D, N] int32, occ_light [D, N, L]
    bool, occ_vpl [D, N, V] bool | None)``, what `path_tracer.trace(aux=)`
    consumes, and ``rad [N, 3]`` the kernel's own radiance. A slot reads
    as occluded unless its sample reached a live diffuse vertex
    (`path_tracer.depth_step`). ``frame_dims`` as in
    `ops.pallas_bounce.trace_pallas_bounce`."""
    del frame_dims
    vpls = vpls if cfg.use_vpl else None
    scene, rays, vpls = _detached(scene, rays, vpls)
    n, dev = rays.o.shape[0], scene.device
    planes = pallas_bounce.state_planes(rays)
    if dev.type == "cpu":
        facts = []
        with torch.no_grad():
            for depth in range(cfg.max_depth):
                planes, f = pallas_bounce.bounce_plain(
                    scene, cfg, light_idx, planes, key, sample, depth, vpls,
                    vlp_index, direct_only, lane_offset, lane_total,
                    collect=True)
                facts.append(f)
        occ_v = [f[2] for f in facts]
        aux = (torch.stack([f[0] for f in facts]),
               torch.stack([f[1] for f in facts]),
               None if occ_v[0] is None else torch.stack(occ_v))
        return aux, planes[6:9].T.contiguous()
    call = pallas_bounce.prepare_bounce(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, n, direct_only,
        lane_offset, lane_total, entry="aux_kernel")
    n_vpl = call.tables[1].shape[0]
    if len(light_idx) + n_vpl > MAX_FACT_SLOTS:
        raise ValueError(f"{len(light_idx)} lights + {n_vpl} VPL slots above "
                         f"the fact kernel's {MAX_FACT_SLOTS}")
    d_ = cfg.max_depth
    hit = torch.empty((d_, n), dtype=torch.int32, device=dev)
    occ_l = torch.empty((d_, len(light_idx), n), dtype=torch.bool,
                        device=dev)
    occ_v = torch.empty((d_, n_vpl, n), dtype=torch.bool, device=dev)
    for depth in range(d_):
        call.launch(planes, depth, (
            hit[depth].data_ptr(), occ_l[depth].data_ptr(),
            occ_v[depth].data_ptr() if n_vpl else None))
    aux = (hit, occ_l.permute(0, 2, 1),
           occ_v.permute(0, 2, 1) if n_vpl else None)
    return aux, planes[6:9].T.contiguous()


def trace_bounce_diff(scene: Scene, cfg: IntegratorConfig,
                      light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                      sample: int, vpls: VplBuffer | None = None,
                      vlp_index: int | None = None,
                      direct_only: bool = False,
                      lane_offset: int | None = None,
                      lane_total: int | None = None, facts: str = "auto",
                      frame_dims: tuple[int, int] | None = None) -> Tensor:
    """Radiance ``[N, 3]``, differentiable w.r.t. the scene, the VPL
    buffer and the rays: the drop-in for `path_tracer.trace` above the
    adjoint kernels' 64 spheres.

    ``facts``: where the detached facts come from. ``"pallas"``: the fact
    kernel (`trace_bounce_aux`; its plain version on the CPU); ``"xla"``:
    the plain full-scan walk, `path_tracer.trace(collect_aux=True)`;
    ``"auto"``: the kernel on the card, the plain walk on the CPU. Either
    pass sees detached inputs; the returned radiance is the re-walk's."""
    if facts not in FACTS:
        raise ValueError(f"unknown fact source {facts!r}")
    if facts == "auto":
        facts = "pallas" if scene.device.type == "cuda" else "xla"
    if facts == "pallas":
        aux, _ = trace_bounce_aux(scene, cfg, light_idx, rays, key, sample,
                                  vpls, vlp_index, direct_only, lane_offset,
                                  lane_total, frame_dims)
    else:
        sc, ry, vp = _detached(scene, rays, vpls)
        with torch.no_grad():
            _, aux = path_tracer.trace(
                sc, cfg, light_idx, ry, key, sample, vpls=vp,
                vlp_index=vlp_index, direct_only=direct_only,
                lane_offset=lane_offset, lane_total=lane_total,
                collect_aux=True)
    return path_tracer.trace(scene, cfg, light_idx, rays, key, sample,
                             vpls=vpls, vlp_index=vlp_index,
                             direct_only=direct_only,
                             lane_offset=lane_offset, lane_total=lane_total,
                             aux=aux)
