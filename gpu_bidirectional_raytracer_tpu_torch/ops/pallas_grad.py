"""The adjoint of the eye-path kernel: wrappers of ``csrc/grad_kernel.cu``.

Port of ``gpu_bidirectional_raytracer_tpu/ops/pallas_grad.py``, whose
Pallas kernels recompute the eye path of a tile of rays and run a manual
reverse sweep in the same kernel. Here they are one CUDA source with two
entry points (see the note at the top of the source for the design):

- `trace_pallas_diff`: the drop-in for `path_tracer.trace` with a
  gradient. On CUDA tensors it is a `torch.autograd.Function` over the
  scene table, the VPL table and the rays; its forward is `trace_kernel`
  in ray mode and its backward launches ``grad_kernel`` (which replaces
  the TPU kernel ``_bwd_kernel``).
- `trace_pallas_loss_grad`: the l2 or log loss and its gradients from one
  ``fused_kernel`` launch (which replaces ``_fused_kernel``): the kernel's
  own forward sweep gives the radiance and the cotangent forms in it.

The estimator's gradient policy is autograd's on the plain tracer: hit
ids, material and emitter masks, facing tests, occlusion and the Fresnel
branch are detached; hit distances are differentiable through the root of
the hit sphere. With ``cfg.vis_grad_tau > 0`` both kernels also carry the
visibility carrier of `integrators.direct` (the adjoint of
`intersect.soft_visibility` into the blockers and the shadow segments);
the forward does not change. The kernels differentiate the port's own
expressions, so on the card they are held against `trace_diff_plain` and
`loss_grad_plain` (autograd through `path_tracer.trace`, which carries
the carrier itself). The silhouette carrier (``sil_grad_tau``) lies
outside the tracer, in `diff.gradients`.

Both take their random tape as `ops.pallas_trace.Tape`: mix32 site keys,
or a streamed ``[K, n]`` tape for a threefry key (the fitter's).

A wrapper given CPU tensors runs the plain version. Given CUDA tensors it
launches its kernel or raises; it never falls back. Each launch adds one
to ``LAUNCHES["grad_kernel"]`` or ``LAUNCHES["fused_kernel"]`` (in
`ops.pallas_trace`, beside ``trace_kernel``'s count), where `_run` makes
it; a launch with the visibility carrier to ``"grad_kernel_vis"`` or
``"fused_kernel_vis"`` instead.
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.autograd.function import once_differentiable

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    IntegratorConfig,
    Rays,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import LAUNCHES

BLOCK = 128             # threads per block of both entry points
MAX_DEPTH = 16          # depths of saved state per thread (kMaxDepth)
MAX_SHADOW_SLOTS = 128  # light + VPL slots of saved occlusion bits
SPHERE_LIMIT = 64       # the kernels' route; more spheres take the
#                         fact kernel and the re-walk (ops.pallas_bounce_grad)
LOSS_KINDS = {"l2": 0, "log": 1}
PARAMS = ("p", "rad", "e", "c")   # the scene's differentiable fields


def _check_sphere_limit(scene: Scene) -> None:
    """The adjoint kernels take scenes of at most `SPHERE_LIMIT` spheres,
    as JAX's do; larger ones go to `ops.pallas_bounce_grad`."""
    if scene.num_spheres > SPHERE_LIMIT:
        raise ValueError(
            f"{scene.num_spheres} spheres: the adjoint kernels take at most "
            f"{SPHERE_LIMIT}; larger scenes take the fact kernel and the "
            f"re-walk (ops.pallas_bounce_grad.trace_bounce_diff)")


def _check_launch(cfg: IntegratorConfig, n_lights: int, n_vpl: int) -> None:
    # The kernels take tau as a float32 and pick the carrier instantiation
    # by its sign there; a tau that rounds to 0 would drop the carrier
    # that the plain tracer and `LAUNCHES` keep, so taus below float32's
    # smallest normal are refused.
    if 0.0 < cfg.vis_grad_tau < torch.finfo(torch.float32).tiny:
        raise ValueError(f"vis_grad_tau {cfg.vis_grad_tau} is below "
                         f"float32's smallest normal")
    if cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"max_depth {cfg.max_depth} above the adjoint "
                         f"kernel's {MAX_DEPTH}")
    if n_lights + n_vpl > MAX_SHADOW_SLOTS:
        raise ValueError(f"{n_lights} lights + {n_vpl} VPL slots above the "
                         f"adjoint kernel's {MAX_SHADOW_SLOTS}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _fn(entry: str):
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    return _build.load(entry)


def _run(entry: str, args: tuple, cfg: IntegratorConfig) -> None:
    rc = _fn(entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {rc}")
    LAUNCHES[entry + ("_vis" if cfg.vis_grad_tau > 0.0 else "")] += 1


def _grad_outputs(scene_tab: Tensor, vpl_tab: Tensor, n: int):
    n_blocks = (n + BLOCK - 1) // BLOCK
    dev = scene_tab.device
    dtab = torch.empty((n_blocks, scene_tab.shape[0], 16),
                       dtype=torch.float32, device=dev)
    dvpl = torch.empty((n_blocks, max(vpl_tab.shape[0], 1), 16),
                       dtype=torch.float32, device=dev)
    return n_blocks, dtab, dvpl


def _reduce_partials(dtab_part: Tensor, dvpl_part: Tensor,
                     vpl_tab: Tensor) -> tuple[Tensor, Tensor]:
    """Sum the per-block partials; ``refl`` (column 10) and the padding of
    the scene table, and columns 9 and up of the VPL table, carry no
    gradient."""
    dtab = dtab_part.sum(dim=0)
    dtab[:, 10:] = 0.0
    if vpl_tab.shape[0] == 0:
        return dtab, torch.zeros_like(vpl_tab)
    dvpl = dvpl_part.sum(dim=0)
    dvpl[:, 9:] = 0.0
    return dtab, dvpl


def _common_args(scene_tab, vpl_tab, tape, n_lights, o, d, n,
                 cfg: IntegratorConfig, lane_offset, lane_total) -> tuple:
    pallas_trace.check_tape(tape, n, scene_tab.device)
    return (scene_tab.data_ptr(), scene_tab.shape[0],
            vpl_tab.data_ptr(), vpl_tab.shape[0],
            tape.keys.data_ptr(), tape.n_rows,
            None if tape.stream is None else tape.stream.data_ptr(),
            n_lights,
            o.data_ptr(), d.data_ptr(), n,
            cfg.max_depth, max(n_lights, 1), int(cfg.combine_half),
            lane_offset, lane_total, cfg.emission_scale, cfg.light_gain,
            cfg.vis_grad_tau)


def grad_launch(scene_tab: Tensor, vpl_tab: Tensor,
                tape: pallas_trace.Tape, cfg: IntegratorConfig,
                light_idx: tuple[int, ...], rays: Rays, cot: Tensor,
                lane_offset: int = 0, lane_total: int | None = None):
    """One ``grad_kernel`` launch: ``(dscene_tab [S,16], dvpl_tab [V,16],
    d rays.o [N,3], d rays.d [N,3])`` for the radiance cotangent ``cot``."""
    n = rays.o.shape[0]
    dev = scene_tab.device
    _check_launch(cfg, len(light_idx), vpl_tab.shape[0])
    pallas_trace.check_rays(rays.o, rays.d, n, dev)
    cot = cot.detach().to(torch.float32).contiguous()
    if cot.shape != (n, 3) or cot.device != dev:
        raise ValueError(f"cotangent must be a [N, 3] tensor on {dev}")
    scene_tab, vpl_tab = scene_tab.detach(), vpl_tab.detach()
    _, dtab_part, dvpl_part = _grad_outputs(scene_tab, vpl_tab, n)
    d_o = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_d = torch.empty((n, 3), dtype=torch.float32, device=dev)
    _run("grad_kernel", _common_args(
        scene_tab, vpl_tab, tape, len(light_idx), rays.o.detach(),
        rays.d.detach(), n, cfg, lane_offset,
        n if lane_total is None else lane_total) + (
        cot.data_ptr(), dtab_part.data_ptr(), dvpl_part.data_ptr(),
        d_o.data_ptr(), d_d.data_ptr(), _stream(dev)), cfg)
    dtab, dvpl = _reduce_partials(dtab_part, dvpl_part, vpl_tab)
    return dtab, dvpl, d_o, d_d


def fused_launch(scene_tab: Tensor, vpl_tab: Tensor,
                 tape: pallas_trace.Tape, cfg: IntegratorConfig,
                 light_idx: tuple[int, ...], rays: Rays, target: Tensor,
                 loss: str = "l2", radiance_out: Tensor | None = None):
    """One ``fused_kernel`` launch: ``(loss, dscene_tab, dvpl_tab)``.
    ``target [N,3]`` is radiance for ``l2`` and ``log1p`` of it for
    ``log``. ``radiance_out``, when given, receives the kernel's radiance
    (the comparison with `trace_kernel`)."""
    n = rays.o.shape[0]
    dev = scene_tab.device
    _check_launch(cfg, len(light_idx), vpl_tab.shape[0])
    pallas_trace.check_rays(rays.o, rays.d, n, dev)
    if n == 0:
        raise ValueError("the fused step needs at least one ray")
    target = target.detach().to(torch.float32).contiguous()
    if target.shape != (n, 3) or target.device != dev:
        raise ValueError(f"target must be a [N, 3] tensor on {dev}")
    scene_tab, vpl_tab = scene_tab.detach(), vpl_tab.detach()
    n_blocks, dtab_part, dvpl_part = _grad_outputs(scene_tab, vpl_tab, n)
    loss_part = torch.empty((n_blocks,), dtype=torch.float32, device=dev)
    if radiance_out is not None and (
            radiance_out.shape != (n, 3) or radiance_out.device != dev
            or radiance_out.dtype != torch.float32
            or not radiance_out.is_contiguous()):
        raise ValueError(f"radiance_out must be a contiguous float32 [N, 3] "
                         f"tensor on {dev}")
    _run("fused_kernel", _common_args(
        scene_tab, vpl_tab, tape, len(light_idx),
        rays.o.detach(), rays.d.detach(), n, cfg, 0, n) + (
        target.data_ptr(), LOSS_KINDS[loss], 1.0 / (3.0 * n),
        dtab_part.data_ptr(), dvpl_part.data_ptr(), loss_part.data_ptr(),
        None if radiance_out is None else radiance_out.data_ptr(),
        _stream(dev)), cfg)
    dtab, dvpl = _reduce_partials(dtab_part, dvpl_part, vpl_tab)
    return loss_part.sum() / (3.0 * n), dtab, dvpl


class _TraceDiff(torch.autograd.Function):
    """Radiance of the rays through `trace_kernel`; backward through
    ``grad_kernel``. Inputs: scene table, VPL table, rays.o, rays.d."""

    @staticmethod
    def forward(ctx, scene_tab, vpl_tab, ro, rd, tape, cfg, light_idx,
                lane_offset, lane_total):
        n = ro.shape[0]
        call = pallas_trace.make_launch(
            scene_tab, vpl_tab, tape, cfg, light_idx, n,
            rays=Rays(o=ro, d=rd), lane_offset=lane_offset,
            lane_total=lane_total)
        out = call()
        ctx.save_for_backward(scene_tab, vpl_tab, ro, rd)
        ctx.meta = (tape, cfg, light_idx, lane_offset, lane_total)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        scene_tab, vpl_tab, ro, rd = ctx.saved_tensors
        tape, cfg, light_idx, lane_offset, lane_total = ctx.meta
        dtab, dvpl, d_o, d_d = grad_launch(
            scene_tab, vpl_tab, tape, cfg, light_idx, Rays(o=ro, d=rd), cot,
            lane_offset, lane_total)
        return dtab, dvpl, d_o, d_d, None, None, None, None, None


def trace_diff_plain(scene: Scene, cfg: IntegratorConfig,
                     light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                     sample: int, vpls: VplBuffer | None = None,
                     vlp_index: int | None = None,
                     lane_offset: int | None = None,
                     lane_total: int | None = None) -> Tensor:
    """Plain version of `trace_pallas_diff`: `path_tracer.trace`, whose
    gradient autograd carries."""
    return path_tracer.trace(scene, cfg, light_idx, rays, key, sample,
                             vpls=vpls, vlp_index=vlp_index,
                             lane_offset=lane_offset, lane_total=lane_total)


def trace_pallas_diff(scene: Scene, cfg: IntegratorConfig,
                      light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                      sample: int, vpls: VplBuffer | None = None,
                      vlp_index: int | None = None,
                      lane_offset: int | None = None,
                      lane_total: int | None = None) -> Tensor:
    """Radiance ``[N, 3]`` of the rays, differentiable w.r.t. the scene's
    ``p/rad/e/c``, the VPL buffer's ``hp/rad/nl`` and the rays."""
    if scene.device.type == "cpu":
        return trace_diff_plain(scene, cfg, light_idx, rays, key, sample,
                                vpls, vlp_index, lane_offset, lane_total)
    _check_sphere_limit(scene)
    n = rays.o.shape[0]
    scene_tab, vpl_tab, tape = pallas_trace.launch_tables(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, n,
        lane_offset=lane_offset, lane_total=lane_total)
    return _TraceDiff.apply(scene_tab, vpl_tab, rays.o.contiguous(),
                            rays.d.contiguous(), tape, cfg,
                            tuple(light_idx), lane_offset or 0,
                            n if lane_total is None else lane_total)


def param_leaves(scene: Scene, vpls: VplBuffer | None = None):
    """``(scene', vpls', scene_leaves, vpl_leaves)``: detached copies of
    the differentiable fields (the scene's `PARAMS`; the VPL buffer's
    ``hp/rad/nl``) that require grad, and the scene and buffer rebuilt
    from them."""
    sl = [getattr(scene, k).detach().requires_grad_() for k in PARAMS]
    sc = scene.replace(**dict(zip(PARAMS, sl)))
    if vpls is None:
        return sc, None, sl, []
    vl = [t.detach().requires_grad_() for t in (vpls.hp, vpls.rad,
                                                 vpls.nl)]
    vb = VplBuffer(hp=vl[0], rad=vl[1], nl=vl[2], valid=vpls.valid,
                   sid=vpls.sid)
    return sc, vb, sl, vl


def scene_grads(scene: Scene, grads) -> Scene:
    """The gradients of `PARAMS` (None: zero) as a :class:`Scene`, with
    ``refl`` zeros."""
    g = {k: torch.zeros_like(getattr(scene, k)) if v is None else v
         for k, v in zip(PARAMS, grads)}
    return Scene(refl=torch.zeros_like(scene.refl), **g)


def l2_loss(img: Tensor, target: Tensor) -> Tensor:
    return torch.mean((img - target) ** 2)


def log_loss(img: Tensor, target: Tensor) -> Tensor:
    """L2 in log(1 + radiance)."""
    return torch.mean((torch.log1p(img) - torch.log1p(target)) ** 2)


LOSSES = {"l2": l2_loss, "log": log_loss}


def loss_grad_plain(scene: Scene, cfg: IntegratorConfig,
                    light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                    sample: int, target: Tensor,
                    vpls: VplBuffer | None = None,
                    vlp_index: int | None = None, loss: str = "l2"):
    """Plain version of `trace_pallas_loss_grad`: the loss of
    `path_tracer.trace`, differentiated by autograd."""
    if loss not in LOSS_KINDS:
        raise ValueError(f"fused step supports loss 'l2'/'log', got {loss!r}")
    bidir = cfg.use_vpl and vpls is not None
    n = rays.o.shape[0]
    with torch.enable_grad():
        sc, vb, sl, vl = param_leaves(scene, vpls if bidir else None)
        rad = path_tracer.trace(sc, cfg, light_idx, rays, key, sample,
                                vpls=vb, vlp_index=vlp_index)
        value = LOSSES[loss](rad, target.reshape(n, 3))
        grads = torch.autograd.grad(value, sl + vl, allow_unused=True)
    return (value.detach(), scene_grads(scene, grads[:4]),
            tuple(grads[4:]) if bidir else None)


def trace_pallas_loss_grad(scene: Scene, cfg: IntegratorConfig,
                           light_idx: tuple[int, ...], rays: Rays,
                           key: rng.Key, sample: int, target: Tensor,
                           vpls: VplBuffer | None = None,
                           vlp_index: int | None = None, loss: str = "l2"):
    """The fused training step: ``(loss, dscene, dvpl_float)``.

    ``target [N, 3]`` is radiance. ``dscene`` is a :class:`Scene` of
    gradients (``refl`` zeros) of the direct dependence (scene table and
    the VPL window gather); ``dvpl_float = (dhp, drad, dnl)`` is the VPL
    buffer's, for the caller to pull through `trace_light_paths`, or None
    without VPLs."""
    if loss not in LOSS_KINDS:
        raise ValueError(f"fused step supports loss 'l2'/'log', got {loss!r}")
    if scene.device.type == "cpu":
        return loss_grad_plain(scene, cfg, light_idx, rays, key, sample,
                               target, vpls, vlp_index, loss)
    _check_sphere_limit(scene)
    bidir = cfg.use_vpl and vpls is not None
    n = rays.o.shape[0]
    tgt = target.reshape(n, 3)
    if loss == "log":
        tgt = torch.log1p(tgt)   # the kernel compares log1p(radiance)
    with torch.enable_grad():
        sc, vb, sl, vl = param_leaves(scene, vpls if bidir else None)
        scene_tab, vpl_tab, tape = pallas_trace.launch_tables(
            sc, cfg, light_idx, key, sample, vb, vlp_index, n)
    value, dtab, dvpl = fused_launch(
        scene_tab, vpl_tab, tape, cfg, tuple(light_idx),
        Rays(o=rays.o.contiguous(), d=rays.d.contiguous()), tgt, loss)
    outs, cots = [scene_tab], [dtab]
    if bidir:
        outs.append(vpl_tab)
        cots.append(dvpl)
    grads = torch.autograd.grad(outs, sl + vl, cots, allow_unused=True)
    return (value, scene_grads(scene, grads[:4]),
            tuple(grads[4:]) if bidir else None)
