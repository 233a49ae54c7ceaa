"""Progressive bidirectional render schedule.

Port of ``gpu_bidirectional_raytracer_tpu/render/progressive.py``. Every
``max_iter - 1`` eye passes the light pass refreshes the VPL buffer and
the gather window advances by ``max_vlp``, wrapping modulo
``light_points`` (or sliding off the end with ``stale_vpl_window``). One
pass traces one jittered sample per pixel and folds it into the per-pixel
running mean, frozen at ``max_samples`` samples.

Two routes, as in the JAX package (`Renderer`):
- ``backend="pallas"``, untiled: `render_pass` → `eye_accumulate_pass`,
  which routes by scene: up to 64 spheres and not direct-only, the
  eye-path kernel (`ops.pallas_trace.trace_pallas_camera`); otherwise
  the frame's rays through the per-depth bounce kernel
  (`ops.pallas_bounce.trace_pallas_bounce`).
- ``backend="xla"``, or any ``tile_rows``: `tiled_pass`, the banded
  program. The frame's rays (`frame_rays`) are traced in bands of
  ``tile_rows`` rows (`eye_band_pass`), each drawing its window of the
  global tape, so any band height gives the same bits. With "xla" a band
  runs the plain torch tracer; with "pallas" the kernels by the same rule.

`render_chunk` (``Renderer.step_n``, ``Renderer.render(chunk=)``) runs
several passes per call; its loop body is exactly `Renderer.step`'s pass,
so a chunk gives the bits of as many steps. The schedule's values
(``sample``, ``vlp_index``) are host integers, so no pass waits on the
card. `light_splat_pass` and `light_splat_chunk` (``Renderer.step_light``)
are the light-tracing integrator: fresh light subpaths each pass,
splatted onto the film (`light_tracer.splat_to_film`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
    Rays,
    RenderState,
    Scene,
    VplBuffer,
    resolve_device,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import (
    light_tracer,
    path_tracer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_bounce import (
    trace_pallas_bounce,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import (
    trace_pallas,
    trace_pallas_camera,
)

# Sphere count up to which the eye-path kernel serves a pass; larger
# scenes take the per-depth bounce kernel.
_PALLAS_SPHERE_LIMIT = 64
# Sphere count up to which `Renderer`'s "auto" takes the kernels on the
# card (JAX's rule; the plain banded program above it).
_AUTO_SPHERE_LIMIT = 1024
BACKENDS = ("auto", "pallas", "xla")


def resolve_backend(device_type: str, num_spheres: int, backend: str) -> str:
    """``"auto"``: the kernels (``"pallas"``) for a scene on the card of
    at most 1024 spheres, else the plain program (``"xla"``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "auto":
        return ("pallas" if device_type == "cuda"
                and num_spheres <= _AUTO_SPHERE_LIMIT else "xla")
    return backend


def init_state(width: int, height: int, cfg: IntegratorConfig,
               seed: int = 0, device: str | torch.device = "cuda",
               rng_impl: str | None = None) -> RenderState:
    """Fresh accumulation state with the key of ``seed`` (``rng_impl``:
    None or "mix32", the default tape, or "threefry")."""
    dev = resolve_device(device)
    return RenderState(
        colors=torch.zeros((height, width, 3), dtype=torch.float32,
                           device=dev),
        counter=torch.zeros((height, width), dtype=torch.int32, device=dev),
        vpls=VplBuffer.zeros(cfg.vpl_depth, cfg.light_points, device=dev),
        vlp_index=0,
        sample=0,
        key=rng.make_key(seed, rng_impl),
    )


def vpl_update(scene: Scene, state: RenderState, cfg: IntegratorConfig,
               light_idx: tuple[int, ...]) -> tuple[VplBuffer, int]:
    """The bidirectional schedule step: ``(vpls, vlp_index)`` for this pass."""
    period = max(cfg.max_iter - 1, 1)
    if state.sample % period != 0:
        return state.vpls, state.vlp_index
    vpls = light_tracer.trace_light_paths(scene, cfg, light_idx, state.key,
                                          state.sample)
    nxt = state.vlp_index + cfg.max_vlp
    if not cfg.stale_vpl_window:
        nxt = nxt % cfg.light_points
    return vpls, 0 if state.sample == 0 else nxt


def _accumulate(colors: Tensor, counter: Tensor, radiance: Tensor,
                max_samples: int) -> tuple[Tensor, Tensor]:
    """Running-mean update, frozen for pixels at the sample cap."""
    live = counter < max_samples
    k1 = counter.to(torch.float32)[..., None]
    updated = (colors * k1 + radiance) / (k1 + 1.0)
    colors = torch.where(live[..., None], updated, colors)
    counter = torch.where(live, counter + 1, counter)
    return colors, counter


def frame_rays(cam: Camera, cfg: IntegratorConfig, width: int,
               height: int, key: rng.Key, sample: int, y0: int = 0,
               rows: int | None = None) -> Rays:
    """Jittered primary rays of rows ``[y0, y0 + rows)`` of the frame (by
    default all of it), made once per pass and sliced into bands: lanes
    ``[y0 * width, (y0 + rows) * width)`` of the frame's, the same bits."""
    rows = height - y0 if rows is None else rows
    lo, n = y0 * width, rows * width
    dev = cam.orig.device
    px, py = cam_mod.pixel_grid(width, height, device=dev)
    px, py = px[lo:lo + n], py[lo:lo + n]
    jit_uv = rng.site_uniforms(key, sample, 0, rng.CAM_JITTER, 2, n,
                               device=dev, lane_offset=lo,
                               lane_total=width * height)
    ju, jv = jit_uv[0], jit_uv[1]
    if cfg.stratify > 0:
        ju, jv = cam_mod.stratify_jitter(ju, jv, sample, cfg.stratify)
    return cam_mod.primary_rays(cam, width, height, ju, jv, px, py)


def eye_accumulate_pass(scene: Scene, cam: Camera, state: RenderState,
                        vpls: VplBuffer, vlp_index: int,
                        cfg: IntegratorConfig, width: int, height: int,
                        light_idx: tuple[int, ...],
                        direct_only: bool = False,
                        backend: str = "pallas") -> RenderState:
    """One eye sample per pixel, then the running mean. ``"pallas"``: the
    eye-path kernel up to 64 spheres and not direct-only, else the bounce
    kernel on the frame's rays; ``"xla"``: the plain tracer."""
    gather = vpls if cfg.use_vpl else None
    if (backend == "pallas" and not direct_only
            and scene.num_spheres <= _PALLAS_SPHERE_LIMIT):
        radiance = trace_pallas_camera(
            scene, cfg, light_idx, cam, width, height, state.key,
            state.sample, vpls=gather, vlp_index=vlp_index)
    else:
        rays = frame_rays(cam, cfg, width, height, state.key, state.sample)
        tracer = (trace_pallas_bounce if backend == "pallas"
                  else path_tracer.trace)
        extra = {"frame_dims": (width, height)} if backend == "pallas" else {}
        radiance = tracer(scene, cfg, light_idx, rays, state.key,
                          state.sample, vpls=gather, vlp_index=vlp_index,
                          direct_only=direct_only, **extra)
    return _fold(state, radiance.reshape(height, width, 3), vpls, vlp_index,
                 cfg)


def _fold(state: RenderState, radiance: Tensor, vpls: VplBuffer,
          vlp_index: int, cfg: IntegratorConfig) -> RenderState:
    colors, counter = _accumulate(state.colors, state.counter, radiance,
                                  cfg.max_samples)
    return state.replace(colors=colors, counter=counter, vpls=vpls,
                         vlp_index=vlp_index, sample=state.sample + 1)


def _schedule(scene: Scene, state: RenderState, cfg: IntegratorConfig,
              light_idx: tuple[int, ...]) -> tuple[VplBuffer, int]:
    if cfg.use_vpl and light_idx:
        return vpl_update(scene, state, cfg, light_idx)
    return state.vpls, state.vlp_index


def render_pass(scene: Scene, cam: Camera, state: RenderState,
                cfg: IntegratorConfig, width: int, height: int,
                light_idx: tuple[int, ...], direct_only: bool = False,
                backend: str = "pallas") -> RenderState:
    """One progressive pass: the VPL schedule, then the eye pass."""
    vpls, vlp_index = _schedule(scene, state, cfg, light_idx)
    return eye_accumulate_pass(scene, cam, state, vpls, vlp_index, cfg,
                               width, height, light_idx, direct_only,
                               backend)


def eye_band_pass(scene: Scene, rays: Rays, cfg: IntegratorConfig,
                  width: int, height: int, y0: int, band_h: int,
                  light_idx: tuple[int, ...], key: rng.Key, sample: int,
                  vpls: VplBuffer, vlp_index: int, backend: str = "xla",
                  direct_only: bool = False) -> Tensor:
    """Radiance ``[band_h, width, 3]`` of rows ``[y0, y0 + band_h)``;
    ``rays`` are the band's slice of `frame_rays`. The band draws columns
    ``[y0 * width, (y0 + band_h) * width)`` of the frame's tape."""
    kw = dict(vpls=vpls if cfg.use_vpl else None, vlp_index=vlp_index,
              lane_offset=y0 * width, lane_total=width * height)
    if (backend == "pallas" and not direct_only
            and scene.num_spheres <= _PALLAS_SPHERE_LIMIT):
        rad = trace_pallas(scene, cfg, light_idx, rays, key, sample, **kw)
    else:
        tracer = (trace_pallas_bounce if backend == "pallas"
                  else path_tracer.trace)
        rad = tracer(scene, cfg, light_idx, rays, key, sample,
                     direct_only=direct_only, **kw)
    return rad.reshape(band_h, width, 3)


def tiled_pass(scene: Scene, cam: Camera, state: RenderState,
               cfg: IntegratorConfig, width: int, height: int,
               light_idx: tuple[int, ...], tile_rows: int | None,
               backend: str = "xla", direct_only: bool = False,
               y0: int = 0) -> RenderState:
    """One progressive pass through the banded program (one band when
    ``tile_rows`` is None): any ``tile_rows`` gives the same bits.
    ``state`` holds rows ``[y0, y0 + its height)`` of the frame (by
    default all of them); only those rows' rays are made and traced."""
    vpls, vlp_index = _schedule(scene, state, cfg, light_idx)
    window = state.colors.shape[0]
    rays = frame_rays(cam, cfg, width, height, state.key, state.sample, y0,
                      window)
    rows = tile_rows or window
    bands = []
    for b0 in range(0, window, rows):
        bh = min(rows, window - b0)
        lo, hi = b0 * width, (b0 + bh) * width
        band = Rays(o=rays.o[lo:hi], d=rays.d[lo:hi])
        bands.append(eye_band_pass(scene, band, cfg, width, height, y0 + b0,
                                   bh, light_idx, state.key, state.sample,
                                   vpls, vlp_index, backend, direct_only))
    return _fold(state, torch.cat(bands, dim=0), vpls, vlp_index, cfg)


def render_chunk(scene: Scene, cam: Camera, state: RenderState,
                 n_passes: int, cfg: IntegratorConfig, width: int,
                 height: int, light_idx: tuple[int, ...],
                 tile_rows: int | None = None, backend: str = "xla",
                 direct_only: bool = False) -> RenderState:
    """``n_passes`` progressive passes in one call. The loop body is
    `Renderer.step`'s pass: `render_pass` for the untiled ``"pallas"``
    backend, `tiled_pass` otherwise, so a chunk equals as many steps bit
    for bit; the VPL refresh every ``max_iter - 1`` passes happens inside
    the chunk. Nothing in the loop reads the card back."""
    for _ in range(n_passes):
        if backend == "pallas" and not tile_rows:
            state = render_pass(scene, cam, state, cfg, width, height,
                                light_idx, direct_only, backend)
        else:
            state = tiled_pass(scene, cam, state, cfg, width, height,
                               light_idx, tile_rows, backend, direct_only)
    return state


def light_splat_pass(scene: Scene, cam: Camera, state: RenderState,
                     cfg: IntegratorConfig, width: int, height: int,
                     light_idx: tuple[int, ...]) -> RenderState:
    """One light-tracing pass: ``light_points`` fresh light subpaths
    splatted onto the film. The pass's estimate is the splat sum divided
    by the lanes per light, folded into a running mean per pass (every
    pixel counts every pass; no ``max_samples`` cap); the pass's VPLs are
    kept in the state."""
    vpls = light_tracer.trace_light_paths(scene, cfg, light_idx, state.key,
                                          state.sample)
    add_c, _ = light_tracer.splat_to_film(scene, cam, cfg, vpls, width,
                                          height, light_idx)
    n_per_light = cfg.light_points // max(len(light_idx), 1)
    frame = add_c / float(max(n_per_light, 1))
    k = state.counter.to(torch.float32)[..., None]
    colors = (state.colors * k + frame) / (k + 1.0)
    return state.replace(colors=colors, counter=state.counter + 1,
                         vpls=vpls, sample=state.sample + 1)


def light_splat_chunk(scene: Scene, cam: Camera, state: RenderState,
                      n_passes: int, cfg: IntegratorConfig, width: int,
                      height: int,
                      light_idx: tuple[int, ...]) -> RenderState:
    """``n_passes`` `light_splat_pass` passes in one call."""
    for _ in range(n_passes):
        state = light_splat_pass(scene, cam, state, cfg, width, height,
                                 light_idx)
    return state


class Renderer:
    """Scene + camera + config + state: `step` is one progressive pass;
    the camera and scene edits restart the accumulation.

    ``backend``: ``"auto"`` (`resolve_backend`: the kernels on the card up
    to 1024 spheres, the plain program otherwise), ``"pallas"`` or
    ``"xla"``. ``tile_rows``: trace each pass in bands of that many rows
    (the banded program; bounded memory for large frames and scenes).
    ``rng_impl``: the tape, None or ``"mix32"`` (default),
    ``"threefry"`` or ``"rbg"``."""

    def __init__(self, scene: Scene, cam_orig: Sequence[float],
                 cam_target: Sequence[float], width: int, height: int,
                 cfg: IntegratorConfig | None = None, seed: int = 0,
                 reference_dims: bool = False,
                 device: str | torch.device = "cuda", backend: str = "auto",
                 tile_rows: int | None = None, rng_impl: str | None = None):
        self.device = resolve_device(device)
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, renderer on "
                             f"{self.device}")
        if reference_dims:
            width, height = cam_mod.reference_dims(width, height)
        self.backend = resolve_backend(scene.device.type, scene.num_spheres,
                                       backend)
        self.tile_rows = tile_rows
        self.rng_impl = rng_impl
        self.seed = seed
        self.cfg = cfg or IntegratorConfig()
        self.width, self.height = width, height
        self.scene = scene
        self.camera = Camera.make(cam_orig, cam_target, width, height,
                                  self.cfg.fov_deg, device=self.device)
        self.light_idx = static_light_indices(scene)
        self.state = init_state(width, height, self.cfg, seed, self.device,
                                rng_impl)

    def step(self, direct_only: bool = False) -> RenderState:
        """One pass. The plain backend and every banded render go through
        the banded program; the untiled kernels through `render_pass`."""
        if self.tile_rows or self.backend != "pallas":
            self.state = tiled_pass(self.scene, self.camera, self.state,
                                    self.cfg, self.width, self.height,
                                    self.light_idx, self.tile_rows,
                                    self.backend, direct_only)
        else:
            self.state = render_pass(self.scene, self.camera, self.state,
                                     self.cfg, self.width, self.height,
                                     self.light_idx, direct_only,
                                     self.backend)
        return self.state

    def step_n(self, n_passes: int, direct_only: bool = False
               ) -> RenderState:
        """``n_passes`` passes through `render_chunk`: the bits of as
        many `step` calls."""
        self.state = render_chunk(self.scene, self.camera, self.state,
                                  n_passes, self.cfg, self.width,
                                  self.height, self.light_idx,
                                  self.tile_rows, self.backend, direct_only)
        return self.state

    def step_light(self, n_passes: int = 1) -> RenderState:
        """``n_passes`` light-tracing passes splatted onto the film
        (`light_splat_chunk`; the CLI's ``--mode light``)."""
        self.state = light_splat_chunk(self.scene, self.camera, self.state,
                                       n_passes, self.cfg, self.width,
                                       self.height, self.light_idx)
        return self.state

    def render(self, spp: int, direct_only: bool = False,
               chunk: int = 1) -> np.ndarray:
        """Accumulate ``spp`` passes, in chunks of ``chunk`` passes
        (`step_n`; the same image); the running mean as float32
        ``[H, W, 3]`` (row 0 = bottom)."""
        chunk = max(chunk, 1)
        for done in range(0, spp, chunk):
            self.step_n(min(chunk, spp - done), direct_only)
        return self.state.colors.cpu().numpy()

    def reset(self) -> None:
        """Restart accumulation, keep scene and camera."""
        self.state = init_state(self.width, self.height, self.cfg,
                                self.seed, self.device, self.rng_impl)

    def move_camera(self, axis: str, amount: float) -> None:
        self.camera = cam_mod.translate(self.camera, axis, amount,
                                        self.width, self.height)
        self.reset()

    def rotate_camera(self, axis: str, angle: float) -> None:
        self.camera = cam_mod.rotate(self.camera, axis, angle,
                                     self.width, self.height)
        self.reset()

    def edit_sphere(self, index: int, dp) -> None:
        """Move sphere ``index`` by ``dp`` and restart."""
        p = self.scene.p.clone()
        p[index] += torch.as_tensor(dp, dtype=torch.float32,
                                    device=self.device)
        self.scene = self.scene.replace(p=p)
        self.light_idx = static_light_indices(self.scene)
        self.reset()


def render_image(scene: Scene, cam_orig, cam_target, width: int, height: int,
                 spp: int, cfg: IntegratorConfig | None = None,
                 seed: int = 0, reference_dims: bool = False,
                 device: str | torch.device = "cuda") -> np.ndarray:
    """One-call render to float32 ``[H, W, 3]`` (row 0 = bottom)."""
    return Renderer(scene, cam_orig, cam_target, width, height, cfg, seed,
                    reference_dims, device).render(spp)
