"""Sharded rendering: the work of one rank of a process group.

Port of ``gpu_bidirectional_raytracer_tpu/parallel/mesh.py`` on
``torch.distributed``. In JAX a 1-D mesh over the chips with axis
``"rays"``, ``shard_map`` and GSPMD split the work and emit the ``psum``s.
Here each rank is a process (`parallel.distributed`) holding one device,
and each function below is what one rank runs: it takes the global
inputs, works on its window, and combines with the other ranks through
``all_reduce`` and ``broadcast`` only.

- Image rows (`RenderState` ``colors``/``counter``) and lanes (rays, light
  subpaths, pixels of the training step) are split into ``size`` equal
  windows, rank ``r`` taking window ``r``. Everything else (scene, camera,
  VPL buffer, key, sample) is replicated: every rank holds the same
  values and runs the same VPL schedule.
- Every random draw is addressed by its global lane (`rng.site_uniforms`
  ``lane_offset``/``lane_total``), so a rank's window has the bits of the
  same lanes of a one-rank run: the trace, the bounce trace, a render
  pass's rows and the light subpaths. The scene gradients and the splat
  films are sums over the ranks (``all_reduce``), which differ from the
  one-rank sums only in their order.
- A rank runs the one-process kernels on its lane window:
  ``trace_kernel`` (up to 64 spheres) or ``bounce_kernel`` in the trace
  and the render; ``trace_kernel`` and ``grad_kernel``, or ``aux_kernel``
  and the re-walk above 64 spheres, in the training step.

A mesh without a process group is one rank (`make_mesh`), and every
function then runs the one-process program.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
    Rays,
    RenderState,
    Scene,
)
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_bounce import (
    trace_pallas_bounce,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import (
    trace_pallas,
)
from gpu_bidirectional_raytracer_tpu_torch.parallel.distributed import (
    rank_device,
)
from gpu_bidirectional_raytracer_tpu_torch.render import progressive

RAYS_AXIS = "rays"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a 1-D mesh: its process ``group`` (None: one
    rank, no group), the number of ranks ``size``, this one's ``rank`` and
    ``device``."""

    group: dist.ProcessGroup | None
    size: int
    rank: int
    device: torch.device
    axis: str = RAYS_AXIS

    @property
    def axis_names(self) -> tuple[str]:
        return (self.axis,)


def make_mesh(group: dist.ProcessGroup | None = None,
              device: str | torch.device | None = None) -> Mesh:
    """The mesh of ``group`` (default: the initialised world group) on
    ``device`` (default: `distributed.rank_device`'s). Without a process
    group it is one rank; if ``WORLD_SIZE`` says more than one but no
    group is initialised, it raises rather than run one rank of many."""
    dev = rank_device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise RuntimeError(
                f"WORLD_SIZE is {world} but no process group is "
                f"initialised; call parallel.distributed.initialize_cluster "
                f"first")
        return Mesh(group=None, size=1, rank=0, device=dev)
    group = group or dist.group.WORLD
    return Mesh(group=group, size=dist.get_world_size(group),
                rank=dist.get_rank(group), device=dev)


def pad_height_to(mesh: Mesh, height: int) -> int:
    """Smallest height >= ``height`` divisible by the mesh size."""
    n = mesh.size
    return ((height + n - 1) // n) * n


def _window(n: int, mesh: Mesh, what: str) -> tuple[int, int]:
    """``(offset, count)`` of this rank's window of ``n`` items; raises
    JAX's ValueError on a ragged split."""
    if n % mesh.size:
        raise ValueError(f"{what} {n} not divisible by mesh size "
                         f"{mesh.size}; pad the frame")
    count = n // mesh.size
    return mesh.rank * count, count


def _check_device(mesh: Mesh, *tensors: Tensor) -> None:
    for t in tensors:
        if t.device != mesh.device:
            raise ValueError(f"a tensor is on {t.device}, the mesh's rank "
                             f"on {mesh.device}")


def _all_reduce(t: Tensor, mesh: Mesh) -> Tensor:
    """The sum of ``t`` over the ranks, in place (one rank: ``t``)."""
    if mesh.group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def shard_state(state: RenderState, mesh: Mesh | None = None
                ) -> RenderState:
    """This rank's rows ``[rank*H/size, (rank+1)*H/size)`` of ``colors``
    and ``counter``; the VPL buffer, key, sample and ``vlp_index`` as they
    are (replicated). The height must divide by the mesh size
    (`pad_height_to`)."""
    mesh = mesh or make_mesh()
    y0, rows = _window(state.colors.shape[0], mesh, "image height")
    return state.replace(colors=state.colors[y0:y0 + rows].clone(),
                         counter=state.counter[y0:y0 + rows].clone())


def gather_rows(shard: Tensor, mesh: Mesh | None = None) -> Tensor:
    """The whole array on every rank: the ranks' equal shards (rows or
    lanes, the first axis) in rank order, each rank's bits unchanged (one
    ``broadcast`` from each rank)."""
    mesh = mesh or make_mesh()
    if mesh.group is None:
        return shard
    rows = shard.shape[0]
    out = shard.new_empty((rows * mesh.size, *shard.shape[1:]))
    for r in range(mesh.size):
        part = out[r * rows:(r + 1) * rows]
        if r == mesh.rank:
            part.copy_(shard)
        dist.broadcast(part, src=dist.get_global_rank(mesh.group, r),
                       group=mesh.group)
    return out


def render_pass_sharded(scene: Scene, cam: Camera, state_shard: RenderState,
                        cfg: IntegratorConfig, width: int, height: int,
                        light_idx: tuple[int, ...], mesh: Mesh | None = None,
                        backend: str = "pallas",
                        direct_only: bool = False) -> RenderState:
    """One progressive pass on this rank's rows (the state from
    `shard_state`): what JAX's ``Renderer.step`` does on a sharded state.
    The VPL schedule runs on every rank alike; the eye pass makes and
    traces rows ``[y0, y0 + H/size)`` only (`progressive.tiled_pass` on
    that window: lanes ``[y0*W, (y0 + H/size)*W)`` of the frame's tape,
    the eye-path kernel in ray mode up to 64 spheres, the bounce kernel
    above), then folds them into the shard. The bits of
    ``Renderer(tile_rows=H/size)``'s rows. Nothing is read back to the
    host."""
    mesh = mesh or make_mesh()
    _check_device(mesh, scene.rad, state_shard.colors)
    y0, rows = _window(height, mesh, "image height")
    if state_shard.colors.shape[0] != rows:
        raise ValueError(f"the state shard has {state_shard.colors.shape[0]}"
                         f" rows, this rank's band {rows}")
    return progressive.tiled_pass(scene, cam, state_shard, cfg, width,
                                  height, light_idx, None, backend,
                                  direct_only, y0=y0)

def trace_pallas_sharded(scene: Scene, cfg: IntegratorConfig,
                         light_idx: tuple[int, ...], rays: Rays,
                         key: rng.Key, sample: int, mesh: Mesh | None = None,
                         vpls=None, vlp_index: int | None = None) -> Tensor:
    """This rank's shard ``[N/size, 3]`` of `ops.pallas_trace.trace_pallas`
    over the global ``rays`` ``[N]``: the eye-path kernel on lanes
    ``[rank*N/size, (rank+1)*N/size)``, drawing their columns of the
    ``N``-lane tape, so the gathered shards are the one-rank trace's bits.
    No collective."""
    mesh = mesh or make_mesh()
    _check_device(mesh, scene.rad, rays.o)
    off, cnt = _window(rays.o.shape[0], mesh, "ray count")
    return trace_pallas(scene, cfg, light_idx,
                        Rays(o=rays.o[off:off + cnt], d=rays.d[off:off + cnt]),
                        key, sample, vpls=vpls, vlp_index=vlp_index,
                        lane_offset=off, lane_total=rays.o.shape[0])


def trace_pallas_bounce_sharded(scene: Scene, cfg: IntegratorConfig,
                                light_idx: tuple[int, ...], rays: Rays,
                                key: rng.Key, sample: int,
                                mesh: Mesh | None = None, vpls=None,
                                vlp_index: int | None = None) -> Tensor:
    """`trace_pallas_sharded`'s contract for the per-depth bounce kernel
    (`ops.pallas_bounce.trace_pallas_bounce`, any sphere count): this
    rank's shard, the one-rank trace's bits once gathered."""
    mesh = mesh or make_mesh()
    _check_device(mesh, scene.rad, rays.o)
    off, cnt = _window(rays.o.shape[0], mesh, "ray count")
    return trace_pallas_bounce(
        scene, cfg, light_idx,
        Rays(o=rays.o[off:off + cnt], d=rays.d[off:off + cnt]), key, sample,
        vpls=vpls, vlp_index=vlp_index, lane_offset=off,
        lane_total=rays.o.shape[0])


def light_splat_sharded(scene: Scene, cam: Camera, cfg: IntegratorConfig,
                        light_idx: tuple[int, ...], key: rng.Key,
                        sample: int, width: int, height: int,
                        mesh: Mesh | None = None) -> tuple[Tensor, Tensor]:
    """The light-tracing splat over the ranks: this rank walks light
    subpaths ``[rank*L/size, (rank+1)*L/size)`` of the ``L =
    cfg.light_points`` lanes (their columns of the global tape, so its
    VPLs are the one-rank pass's bits), splats them
    (`light_tracer.splat_to_film`), and one ``all_reduce`` each sums the
    colour and count films. Returns ``(color_sum [H,W,3], count [H,W])``
    on every rank: the count exactly the one-rank film's, the colours up
    to the order of the sum."""
    mesh = mesh or make_mesh()
    _check_device(mesh, scene.rad)
    off, cnt = _window(cfg.light_points, mesh, "light_points")
    vpls = light_tracer.trace_light_paths(scene, cfg, light_idx, key, sample,
                                          lane_offset=off, lane_count=cnt,
                                          lane_total=cfg.light_points)
    color, count = light_tracer.splat_to_film(scene, cam, cfg, vpls, width,
                                              height, light_idx,
                                              lane_offset=off)
    return _all_reduce(color, mesh), _all_reduce(count, mesh)


def render_loss_grad_sharded(scene: Scene, cam: Camera, key: rng.Key,
                             target: Tensor, cfg: IntegratorConfig,
                             width: int, height: int,
                             light_idx: tuple[int, ...], spp: int = 1,
                             mesh: Mesh | None = None, loss: str = "l2",
                             backend: str = "pallas"):
    """The training step over the ranks: this rank renders its pixels
    ``[rank*n/size, (rank+1)*n/size)`` differentiably
    (`diff.gradients.render_radiance_lanes` on that window of the global
    tape; with ``"pallas"`` the eye-path kernel and its adjoint up to 64
    spheres, the fact kernel and the re-walk above; never the fused
    step), takes the l2 or log loss of its shard against its rows of
    ``target`` and its gradients by autograd, and one ``all_reduce`` sums
    the loss and the gradients of ``p, rad, e, c``, divided by the mesh
    size: the mean of equal shards' means, as JAX's ``psum(...) / size``.

    Returns ``(loss, grads)`` on every rank, the gradients as a
    :class:`Scene` with ``refl`` zeros, as `diff.gradients.render_loss_grad`
    for ``loss='l2'``/``'log'``."""
    mesh = mesh or make_mesh()
    _check_device(mesh, scene.rad, target)
    n = width * height
    off, cnt = _window(n, mesh, "pixel count")
    loss_f = {"l2": G.l2_loss, "log": G.log_loss}[loss]
    with torch.enable_grad():
        sc, _, leaves, _ = pallas_grad.param_leaves(scene)
        rad = G.render_radiance_lanes(sc, cam, key, cfg, width, height,
                                      light_idx, spp, backend,
                                      lane_offset=off, lane_count=cnt,
                                      lane_total=n)
        value = loss_f(rad, target.reshape(n, 3)[off:off + cnt])
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    g = pallas_grad.scene_grads(scene, grads)
    parts = [value.detach().reshape(1)] + [getattr(g, k).reshape(-1)
                                           for k in pallas_grad.PARAMS]
    flat = _all_reduce(torch.cat(parts), mesh) / mesh.size
    pieces = torch.split(flat, [p.numel() for p in parts])
    out = {k: p.reshape(getattr(g, k).shape)
           for k, p in zip(pallas_grad.PARAMS, pieces[1:])}
    return pieces[0].reshape(()), g.replace(**out)
