"""Differentiable rendering: gradients of images w.r.t. scene parameters.

Port of ``gpu_bidirectional_raytracer_tpu/diff/gradients.py`` on torch
autograd, with its two straight-through carriers, whose values are
exactly zero and whose gradients carry what the detached estimator
misses:

- ``cfg.vis_grad_tau > 0``: cast shadows. Every NEE and VPL term adds
  ``stop(contrib) * d soft_visibility`` (`integrators.direct`); inside the
  tracer, so the plain tracer, the re-walk and the adjoint kernels carry
  it.
- ``cfg.sil_grad_tau > 0``: the coverage of the sphere a ray hits first,
  on the primary ray and along specular chains up to
  ``cfg.sil_spec_depth`` bounces (`_silhouette_carrier`); outside the
  tracer, after whichever route produced the radiance.

Differentiation policy (the JAX package's): discrete structure is stopped
(hit ids, material and emitter masks, facing tests, occlusion, the Fresnel
branch), hit distances are differentiable through the quadratic root of
the hit sphere, and every sqrt and division on maskable data is guarded.
In the plain torch tracer these follow from the code: booleans carry no
gradient and `torch.where` routes it to the taken branch only.

Backends: ``"auto"`` takes the CUDA kernels for a scene on the card and
the plain torch tracer on the CPU; ``"pallas"`` the kernels (whose
wrappers run the plain versions on CPU tensors); ``"xla"`` the plain torch
tracer on any device and at any sphere count; ``"mxu"`` the same tracer
with every sphere scan in its matmul form (`intersect.sphere_distances`).
The plain tracer checkpoints each depth (``remat=True``), as JAX's does,
so the backward keeps no depth's ``[N, S]`` scans alive.
With the kernels, a scene of at most 64 spheres takes the adjoint kernels
(`ops.pallas_grad`) and a larger one the fact kernel and the re-walk
(`ops.pallas_bounce_grad.trace_bounce_diff`), as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    DIFF,
    REFR,
    SPEC,
    Camera,
    IntegratorConfig,
    Scene,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import direct as nee
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators.bsdf import _NC, _NT
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_bounce_grad import (
    trace_bounce_diff,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_grad import (  # noqa: F401
    LOSSES as _LOSSES,
    PARAMS as _PARAMS,
    l2_loss,    # the JAX module's losses, defined beside the fused kernel
    log_loss,
)

_BACKENDS = ("auto", "pallas", "xla", "mxu")


def _silhouette_carrier(scene: Scene, cfg: IntegratorConfig,
                        light_idx: tuple[int, ...], o: Tensor, d: Tensor,
                        rad: Tensor, key: rng.Key, sample: int,
                        lane_offset: int | None = None,
                        lane_total: int | None = None) -> Tensor:
    """Zero-primal silhouette carrier ``[N, 3]`` of the rays ``(o, d)``
    whose traced radiance is ``rad`` (JAX's `_silhouette_carrier`).

    Per leg, the pixel's coverage by the sphere its ray hits first is
    relaxed to ``sigmoid(det / max(tau r, 1e-6))`` (``det`` the ray's
    discriminant of that sphere, differentiable; the width stopped), and
    the carrier is ``x - x.detach()`` with ``x = 2 stop(L_fg - L_bg) *
    cov``: ``L_fg`` the leg's radiance, ``L_bg`` a value-only estimate of
    what the ray would see without the sphere (emission plus one NEE at
    the second-nearest hit, on the depth's ``LIGHT_UV`` tape, without the
    visibility carrier); the 2 makes up for the band's outer half, which
    no lane hits.

    The primary leg takes ``L_fg = rad``. The walk then follows specular
    chains up to ``cfg.sil_spec_depth`` bounces: a mirror reflects, glass
    refracts on the transmission branch with the stopped Fresnel weight
    ``1 - Re`` (total internal reflection mirrors), each leg shading its
    own first hit value-only for ``L_fg``. At a primary glass hit a second
    chain follows the Fresnel reflection with the weight ``Re``. Hit ids,
    materials, the branch and the weights are stopped; the chain's
    geometry (the root, normal and directions of each hit sphere) is
    differentiable, so a mirror's or a lens's own motion moves what it
    shows.
    """
    n = o.shape[0]
    scene0 = scene.replace(**{k: getattr(scene, k).detach()
                              for k in ("rad", "p", "e", "c")})
    no_vis = dataclasses.replace(cfg, vis_grad_tau=0.0)
    n_slots = max(len(light_idx), 1)

    def shade_value_only(hp_s, t_hit, hid_s, d_l, depth):
        """Emission plus NEE at a diffuse hit, value only: the L_fg/L_bg
        estimate (indirect light there is left out)."""
        p_s, e_s, c_s, refl_s = isect.gather_sphere_attrs(scene0, hid_s)
        normal_s = vm.norm(hp_s - p_s, eps=1e-20)
        dp_s = vm.dot(normal_s, d_l)
        nl_s = vm.smul(torch.where(dp_s > 0.0, -1.0, 1.0), normal_s)
        emit_s = cfg.emission_scale * torch.abs(dp_s)[:, None] * e_s
        if light_idx:
            light_u = rng.site_uniforms(
                key, sample, depth, rng.LIGHT_UV, 2 * n_slots, n,
                device=o.device, lane_offset=lane_offset,
                lane_total=lane_total).reshape(n_slots, 2, n)
            ld_s = nee.sample_direct(scene0, no_vis, light_idx, hp_s, nl_s,
                                     light_u)
        else:
            ld_s = torch.zeros_like(hp_s)
        lit = emit_s + torch.where((refl_s == DIFF)[:, None], c_s * ld_s,
                                   torch.zeros_like(ld_s))
        return torch.where((t_hit < isect._BIG)[:, None], lit,
                           torch.zeros_like(lit))

    def leg(o_l, d_l, active, tint, depth, use_rad):
        """One coverage leg along ``(o_l, d_l)``: ``active [N]`` the lanes
        it applies to, ``tint [N, 3]`` the stopped throughput from the
        camera, ``depth`` the tape row of its NEE."""
        with torch.no_grad():
            ts = isect.sphere_distances(scene0, o_l, d_l)
            hit, t1, hid = isect.nearest_of(ts)
            others = torch.where(
                torch.arange(ts.shape[1], device=ts.device)[None, :]
                == hid[:, None], torch.zeros_like(ts), ts)
            _, t2, hid2 = isect.nearest_of(others)
            hp2 = o_l + torch.where(t2 < isect._BIG, t2, 1.0)[:, None] * d_l
            l_bg = shade_value_only(hp2, t2, hid2, d_l, depth) * tint
            if use_rad:
                l_fg = rad.detach()
            else:
                hp1 = o_l + torch.where(hit, t1, 1.0)[:, None] * d_l
                l_fg = shade_value_only(hp1, t1, hid, d_l, depth) * tint
            delta = l_fg - l_bg
        p_h, _, _, _, r_h = isect.gather_sphere_attrs(scene, hid,
                                                      with_rad=True)
        op = p_h - o_l
        b = vm.dot(op, d_l)
        det = b * b - vm.dot(op, op) + r_h * r_h
        width = torch.clamp(cfg.sil_grad_tau * r_h, min=1e-6).detach()
        cov = torch.sigmoid(det / width)
        carrier = 2.0 * delta * (cov * hit.to(cov.dtype) * active)[:, None]
        return carrier - carrier.detach()

    def advance(o_l, d_l):
        """One specular continuation: the hit point, the next direction,
        the mirror direction, whether the chain goes on, the stopped tint
        factor, whether a Fresnel reflection spawns here, its weight and
        the albedo."""
        with torch.no_grad():
            hit_k, _, hid_k = isect.intersect(scene0, o_l, d_l)
        p_k, _, c_k, refl_k, r_sph = isect.gather_sphere_attrs(
            scene, hid_k, with_rad=True)
        c_k = c_k.detach()
        t_k = isect.sphere_root(o_l, d_l, p_k, r_sph)
        hp_k = o_l + torch.where(hit_k, t_k, 1.0)[:, None] * d_l
        n_k = vm.norm(hp_k - p_k, eps=1e-20)
        r_k = d_l - (2.0 * vm.dot(n_k, d_l))[:, None] * n_k
        into = vm.dot(n_k, d_l) < 0.0
        sign = torch.where(into, 1.0, -1.0)
        nl_k = vm.smul(sign, n_k)
        nnt = torch.where(into, _NC / _NT, _NT / _NC)
        ddn = vm.dot(d_l, nl_k)
        cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
        tir = cos2t < 0.0
        safe_cos = torch.where(tir, 1.0, torch.clamp(cos2t, min=1e-12))
        kk = sign * (ddn * nnt + torch.where(tir, 0.0, torch.sqrt(safe_cos)))
        t_dir = vm.norm(nnt[:, None] * d_l - kk[:, None] * n_k, eps=1e-20)
        r0 = ((_NT - _NC) / (_NT + _NC)) ** 2
        c1 = 1.0 - torch.where(into, -ddn, vm.dot(t_dir, n_k))
        re = (r0 + (1.0 - r0) * c1 ** 5).detach()
        is_spec, is_refr = refl_k == SPEC, refl_k == REFR
        take_refl = is_spec | (is_refr & tir)
        next_d = torch.where(take_refl[:, None], r_k, t_dir)
        trans_w = torch.where(is_refr & torch.logical_not(tir), 1.0 - re,
                              1.0)
        return dict(
            hp=hp_k, next_d=next_d, r_k=r_k,
            cont=(hit_k & (is_spec | is_refr)).to(o.dtype),
            tint_mul=c_k * trans_w[:, None],
            refl_spawn=(hit_k & is_refr
                        & torch.logical_not(tir)).to(o.dtype),
            re=re, c_k=c_k)

    o_l, d_l = o, d
    active = torch.ones((n,), dtype=o.dtype, device=o.device)
    tint = torch.ones((n, 3), dtype=o.dtype, device=o.device)
    out = torch.zeros((n, 3), dtype=o.dtype, device=o.device)
    depth_cap = min(max(int(cfg.sil_spec_depth), 0), cfg.max_depth - 1)
    reflected = None
    for k in range(depth_cap + 1):
        out = out + leg(o_l, d_l, active, tint, k, use_rad=k == 0)
        if k == depth_cap:
            break
        adv = advance(o_l, d_l)
        if k == 0:   # the Fresnel reflection of a primary glass hit
            reflected = (adv["hp"], adv["r_k"], active * adv["refl_spawn"],
                         tint * adv["c_k"] * adv["re"][:, None])
        active = active * adv["cont"]
        tint = tint * adv["tint_mul"]
        o_l, d_l = adv["hp"], adv["next_d"]
    if reflected is not None:
        o_l, d_l, active, tint = reflected
        for k in range(1, depth_cap + 1):
            out = out + leg(o_l, d_l, active, tint, k, use_rad=False)
            if k == depth_cap:
                break
            adv = advance(o_l, d_l)
            active = active * adv["cont"]
            tint = tint * adv["tint_mul"]
            o_l, d_l = adv["hp"], adv["next_d"]
    return out


def _resolve_backend(device_type: str, backend: str) -> str:
    """``"auto"``: the kernels (``"pallas"``) on the card, the plain
    tracer (``"xla"``) on the CPU."""
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return "pallas" if device_type == "cuda" else "xla"
    return backend


def radiance_route(device_type: str, num_spheres: int, backend: str) -> str:
    """The tracer of `render_radiance_lanes`: ``"plain"``
    (`path_tracer.trace`, any sphere count; ``"xla"`` and ``"mxu"``),
    ``"adjoint"``
    (`ops.pallas_grad.trace_pallas_diff`, at most 64 spheres) or
    ``"bounce"`` (`trace_bounce_diff`, more)."""
    if _resolve_backend(device_type, backend) != "pallas":
        return "plain"
    return "adjoint" if num_spheres <= pallas_grad.SPHERE_LIMIT else "bounce"


def fitter_backend(device_type: str, num_spheres: int,
                   backend: str = "auto") -> str:
    """`InverseRenderer`'s backend, JAX's rule: ``"auto"`` is the kernels
    on the card up to 64 spheres and the plain tracer above that and on
    the CPU."""
    if backend == "auto":
        return ("pallas" if device_type == "cuda"
                and num_spheres <= pallas_grad.SPHERE_LIMIT else "xla")
    return _resolve_backend(device_type, backend)


def render_radiance_lanes(scene: Scene, cam: Camera, key: rng.Key,
                          cfg: IntegratorConfig, width: int, height: int,
                          light_idx: tuple[int, ...], spp: int = 1,
                          backend: str = "auto",
                          lane_offset: int | None = None,
                          lane_count: int | None = None,
                          lane_total: int | None = None) -> Tensor:
    """Mean radiance ``[lane_count, 3]`` of global lanes ``[lane_offset,
    lane_offset + lane_count)`` of a ``lane_total``-lane frame (default:
    the whole frame). Every draw is a window of the global tape, so a
    banded render equals the whole one. With VPLs the light subpaths are
    re-traced inside the graph each sample, and the gather window is the
    fresh ``[0, max_vlp)`` block. With the kernels, more than 64 spheres
    take `trace_bounce_diff`. With ``cfg.sil_grad_tau > 0`` each sample
    adds `_silhouette_carrier` to its radiance, in the same lane window."""
    route = radiance_route(scene.device.type, scene.num_spheres, backend)
    tracer = {"plain": functools.partial(
                  path_tracer.trace, remat=True,
                  scan_backend="mxu" if backend == "mxu" else "xla"),
              "adjoint": pallas_grad.trace_pallas_diff,
              "bounce": trace_bounce_diff}[route]
    dev = scene.device
    if lane_count is None:
        lane_offset, lane_count, lane_total = None, width * height, None
    n = lane_count
    if lane_offset is None:
        px, py = cam_mod.pixel_grid(width, height, device=dev)
    else:
        ids = torch.arange(n, device=dev) + int(lane_offset)
        px, py = ids % width, ids // width
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for s in range(spp):
        jit_uv = rng.site_uniforms(key, s, 0, rng.CAM_JITTER, 2, n,
                                   device=dev, lane_offset=lane_offset,
                                   lane_total=lane_total)
        rays = cam_mod.primary_rays(cam, width, height, jit_uv[0],
                                    jit_uv[1], px, py)
        if cfg.use_vpl and light_idx:
            # Light subpaths are addressed by subpath id, not pixel lane:
            # every band traces the same VPL set.
            vpls = light_tracer.trace_light_paths(scene, cfg, light_idx,
                                                  key, s)
            vlp_index = 0
        else:
            vpls, vlp_index = None, None
        rad = tracer(scene, cfg, light_idx, rays, key, s, vpls=vpls,
                     vlp_index=vlp_index, lane_offset=lane_offset,
                     lane_total=lane_total)
        if cfg.sil_grad_tau > 0.0:
            rad = rad + _silhouette_carrier(
                scene, cfg, light_idx, rays.o, rays.d, rad, key, s,
                lane_offset=lane_offset, lane_total=lane_total)
        acc = acc + rad
    return acc / spp


def render_radiance(scene: Scene, cam: Camera, key: rng.Key,
                    cfg: IntegratorConfig, width: int, height: int,
                    light_idx: tuple[int, ...], spp: int = 1,
                    backend: str = "auto") -> Tensor:
    """Differentiable forward: mean radiance image ``[H, W, 3]``."""
    rad = render_radiance_lanes(scene, cam, key, cfg, width, height,
                                light_idx, spp, backend)
    return rad.reshape(height, width, 3)


def render_loss_grad(scene: Scene, cam: Camera, key: rng.Key,
                     target: Tensor, cfg: IntegratorConfig, width: int,
                     height: int, light_idx: tuple[int, ...], spp: int = 1,
                     loss: str = "l2", backend: str = "auto"):
    """``(loss, d loss / d scene)`` for an image loss; the gradients come
    back as a :class:`Scene` with ``refl`` zeros.

    ``loss``: ``'l2_unbiased'``, the product loss ``mean((A - t)(B - t))``
    of two independent renders (the second on ``rng.fold_in(key,
    0x5EED)``), or the single-render ``'l2'`` and ``'log'``. With the
    kernels, l2/log at one sample per pixel run the fused step: one
    kernel for the loss and the direct gradients."""
    resolved = _resolve_backend(scene.device.type, backend)
    if (loss in ("l2", "log") and resolved == "pallas" and spp == 1
            and cfg.sil_grad_tau == 0.0
            and scene.num_spheres <= pallas_grad.SPHERE_LIMIT):
        return _render_loss_grad_fused(scene, cam, key, target, cfg, width,
                                       height, light_idx, loss)
    if loss != "l2_unbiased" and loss not in _LOSSES:
        raise ValueError(f"unknown loss {loss!r}")
    with torch.enable_grad():
        sc, _, leaves, _ = pallas_grad.param_leaves(scene)

        def render(k):
            return render_radiance(sc, cam, k, cfg, width, height,
                                   light_idx, spp, resolved)

        if loss == "l2_unbiased":
            a = render(key)
            b = render(rng.fold_in(key, 0x5EED))
            value = torch.mean((a - target) * (b - target))
        else:
            value = _LOSSES[loss](render(key), target)
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), pallas_grad.scene_grads(scene, grads)


def _render_loss_grad_fused(scene: Scene, cam: Camera, key: rng.Key,
                            target: Tensor, cfg: IntegratorConfig,
                            width: int, height: int,
                            light_idx: tuple[int, ...], loss: str = "l2"):
    """The fused l2/log step: one kernel for the loss and the direct
    gradients (`ops.pallas_grad.trace_pallas_loss_grad`), with the VPL
    buffer's cotangent pulled through `trace_light_paths` by autograd, so
    the light-subpath chain contributes as in the unfused path."""
    n = width * height
    dev = scene.device
    jit_uv = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device=dev)
    px, py = cam_mod.pixel_grid(width, height, device=dev)
    rays = cam_mod.primary_rays(cam, width, height, jit_uv[0], jit_uv[1],
                                px, py)
    tgt = target.reshape(n, 3)
    if not (cfg.use_vpl and light_idx):
        value, g, _ = pallas_grad.trace_pallas_loss_grad(
            scene, cfg, light_idx, rays, key, 0, tgt, loss=loss)
        return value, g
    with torch.enable_grad():
        sc, _, leaves, _ = pallas_grad.param_leaves(scene)
        vpls = light_tracer.trace_light_paths(sc, cfg, light_idx, key, 0)
    value, g, dvpl = pallas_grad.trace_pallas_loss_grad(
        scene, cfg, light_idx, rays, key, 0, tgt,
        vpls=dataclasses.replace(vpls, hp=vpls.hp.detach(),
                                 rad=vpls.rad.detach(), nl=vpls.nl.detach()),
        vlp_index=0, loss=loss)
    pulled = torch.autograd.grad([vpls.hp, vpls.rad, vpls.nl], leaves,
                                 list(dvpl), allow_unused=True)
    g = g.replace(**{k: getattr(g, k) + v for k, v in zip(_PARAMS, pulled)
                     if v is not None})
    return value, g


def pixel_grad_fd(scene: Scene, render_fn: Callable[[Scene], Tensor],
                  param: str, index, eps: float = 1e-2) -> np.ndarray:
    """Central finite difference of ``render_fn`` w.r.t. one scalar scene
    entry (float64 numpy)."""
    arr = getattr(scene, param)
    up, dn = arr.clone(), arr.clone()
    up[index] += eps
    dn[index] -= eps
    with torch.no_grad():
        hi = render_fn(scene.replace(**{param: up}))
        lo = render_fn(scene.replace(**{param: dn}))
    return ((hi.cpu().numpy().astype(np.float64)
             - lo.cpu().numpy().astype(np.float64)) / (2 * eps))


class _Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8), in optax's order
    of operations, on a dict of tensors."""

    def __init__(self, lr: float, params: dict[str, Tensor],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, grads: dict[str, Tensor],
             params: dict[str, Tensor]) -> dict[str, Tensor]:
        b1, b2 = self.b1, self.b2
        self.count += 1
        # Bias corrections in float32, as optax takes decay**count.
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** self.count
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** self.count
        out = {}
        for k, g in grads.items():
            self.mu[k] = (1.0 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1.0 - b2) * (g * g) + b2 * self.nu[k]
            mu_hat = self.mu[k] / c1.to(g.device)
            nu_hat = self.nu[k] / c2.to(g.device)
            update = -self.lr * (mu_hat / (torch.sqrt(nu_hat) + self.eps))
            out[k] = params[k] + update
        return out


@dataclasses.dataclass
class InverseRenderer:
    """Gradient-descent scene fitting against a target image.

    Each `step` moves every optimised scene parameter down the loss
    gradient with Adam (optax's update, written out), then projects: radii
    stay at or above ``min_radius``, albedo in [0, 1], emission at or
    above 0.

    Keys: a step draws ``rng.make_key(seed, "threefry")``, folded with
    the step number when ``resample``: the key of JAX's fitter
    (``jax.random.key(seed)``), so from the same seed the two fitters
    draw the same tapes and take the same steps. The kernels read a
    threefry tape streamed from the card (`ops.pallas_trace.Tape`).

    ``backend="auto"`` follows JAX's rule (`fitter_backend`): the kernels
    on the card up to 64 spheres, the plain tracer above that.

    Carrier-tau annealing: the carriers' bias scales with their sigmoid
    width, so a fit can shrink ``sil_grad_tau`` and ``vis_grad_tau`` by
    ``tau_anneal`` (final over initial) over ``anneal_steps`` steps, in
    ``anneal_stages`` discrete stages (`_step_cfg`).
    """

    scene: Scene
    cam: Camera
    target: Tensor
    cfg: IntegratorConfig
    width: int
    height: int
    lr: float = 0.05
    spp: int = 4
    optimize: tuple[str, ...] = ("p", "rad")
    seed: int = 0
    resample: bool = True  # fresh tape per step vs one fixed tape
    min_radius: float = 0.1
    # Per-parameter gradient gate: {param: [S]-or-broadcastable
    # multiplier}; 0 freezes a sphere's entry.
    grad_mask: dict | None = None
    loss: str | None = None  # default: 'l2_unbiased' when resampling,
                             # 'l2' on a fixed tape
    backend: str = "auto"    # 'auto': `fitter_backend`
    tau_anneal: float = 1.0     # 1.0 = off
    anneal_steps: int = 0
    anneal_stages: int = 4
    # Plateau early stopping: after `patience` steps with less than
    # `min_improve` relative improvement on the best loss, `should_stop`.
    patience: int = 0           # 0 = off
    min_improve: float = 1e-3
    _opt_state: object = None
    _step: int = 0

    def __post_init__(self):
        if self.loss is None:
            self.loss = "l2_unbiased" if self.resample else "l2"
        self.backend = fitter_backend(self.scene.device.type,
                                      self.scene.num_spheres, self.backend)
        self.light_idx = static_light_indices(self.scene)
        self._opt_state = _Adam(self.lr, self._params())
        self.best_loss = float("inf")
        self.best_scene = self.scene
        self._stall = 0

    def _params(self) -> dict[str, Tensor]:
        return {k: getattr(self.scene, k) for k in self.optimize}

    def _step_cfg(self) -> IntegratorConfig:
        """This step's config under the staged tau annealing."""
        if self.tau_anneal == 1.0 or self.anneal_steps <= 0:
            return self.cfg
        frac = min(self._step / self.anneal_steps, 1.0)
        stages = max(self.anneal_stages - 1, 1)
        scale = self.tau_anneal ** (round(frac * stages) / stages)
        return dataclasses.replace(
            self.cfg, sil_grad_tau=self.cfg.sil_grad_tau * scale,
            vis_grad_tau=self.cfg.vis_grad_tau * scale)

    @property
    def should_stop(self) -> bool:
        """Plateau detector (see `patience`)."""
        return self.patience > 0 and self._stall >= self.patience

    def step(self) -> float:
        key = rng.make_key(self.seed, "threefry")
        if self.resample:
            key = rng.fold_in(key, self._step)
        loss, grads = render_loss_grad(
            self.scene, self.cam, key, self.target, self._step_cfg(),
            self.width, self.height, self.light_idx, self.spp, self.loss,
            self.backend)
        g = {k: getattr(grads, k) for k in self.optimize}
        if self.grad_mask:
            g = {k: (v * torch.as_tensor(
                self.grad_mask[k], dtype=v.dtype, device=v.device).reshape(
                (-1,) + (1,) * (v.dim() - 1)) if k in self.grad_mask else v)
                for k, v in g.items()}
        params = self._opt_state.step(g, self._params())
        # Projection keeps geometry physical: a radius driven through zero
        # turns the sphere inside out.
        if "rad" in params:
            params["rad"] = torch.clamp(params["rad"], min=self.min_radius)
        if "c" in params:
            params["c"] = torch.clamp(params["c"], 0.0, 1.0)
        if "e" in params:
            params["e"] = torch.clamp(params["e"], min=0.0)
        prev_scene = self.scene          # the scene `loss` was measured at
        self.scene = self.scene.replace(**params)
        self._step += 1
        lf = float(loss)
        if lf < self.best_loss * (1.0 - self.min_improve):
            self.best_loss = lf
            self.best_scene = prev_scene
            self._stall = 0
        else:
            self.best_loss = min(self.best_loss, lf)
            self._stall += 1
        return lf
