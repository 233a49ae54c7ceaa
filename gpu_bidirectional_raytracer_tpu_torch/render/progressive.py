"""Progressive bidirectional render schedule.

Port of ``gpu_bidirectional_raytracer_tpu/render/progressive.py`` (the
untiled forward route). Every ``max_iter - 1`` eye passes the light pass
refreshes the VPL buffer and the gather window advances by ``max_vlp``,
wrapping modulo ``light_points`` (or sliding off the end with
``stale_vpl_window``). One :func:`render_pass` traces one jittered sample
per pixel through the eye-path kernel (`ops.pallas_trace.
trace_pallas_camera`) and folds it into the per-pixel running mean, frozen
at ``max_samples`` samples.

Out of this module so far: the banded route (``tiled_pass``), chunked
passes (``render_chunk``), light splatting, and scenes of more than 64
spheres on the card.
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
    RenderState,
    Scene,
    VplBuffer,
    resolve_device,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import (
    trace_pallas_camera,
)

# Sphere count up to which the eye-path kernel serves the card; the JAX
# package routes larger scenes to its per-bounce kernels, which are not
# ported yet.
_PALLAS_SPHERE_LIMIT = 64


def _check_sphere_limit(scene: Scene) -> None:
    if scene.device.type == "cuda" and scene.num_spheres > _PALLAS_SPHERE_LIMIT:
        raise NotImplementedError(
            f"{scene.num_spheres} spheres: the route for scenes of more than "
            f"{_PALLAS_SPHERE_LIMIT} spheres on the card is not ported yet")


def init_state(width: int, height: int, cfg: IntegratorConfig,
               seed: int = 0, device: str | torch.device = "cuda"
               ) -> RenderState:
    """Fresh accumulation state with the mix32 key of ``seed``."""
    dev = resolve_device(device)
    return RenderState(
        colors=torch.zeros((height, width, 3), dtype=torch.float32,
                           device=dev),
        counter=torch.zeros((height, width), dtype=torch.int32, device=dev),
        vpls=VplBuffer.zeros(cfg.vpl_depth, cfg.light_points, device=dev),
        vlp_index=0,
        sample=0,
        key=rng.make_key(seed),
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


def eye_accumulate_pass(scene: Scene, cam: Camera, state: RenderState,
                        vpls: VplBuffer, vlp_index: int,
                        cfg: IntegratorConfig, width: int, height: int,
                        light_idx: tuple[int, ...]) -> RenderState:
    """One eye sample per pixel through the kernel, then the running mean."""
    _check_sphere_limit(scene)
    radiance = trace_pallas_camera(
        scene, cfg, light_idx, cam, width, height, state.key, state.sample,
        vpls=vpls if cfg.use_vpl else None,
        vlp_index=vlp_index).reshape(height, width, 3)
    colors, counter = _accumulate(state.colors, state.counter, radiance,
                                  cfg.max_samples)
    return state.replace(colors=colors, counter=counter, vpls=vpls,
                         vlp_index=vlp_index, sample=state.sample + 1)


def render_pass(scene: Scene, cam: Camera, state: RenderState,
                cfg: IntegratorConfig, width: int, height: int,
                light_idx: tuple[int, ...]) -> RenderState:
    """One progressive pass: the VPL schedule, then the eye pass."""
    if cfg.use_vpl and light_idx:
        vpls, vlp_index = vpl_update(scene, state, cfg, light_idx)
    else:
        vpls, vlp_index = state.vpls, state.vlp_index
    return eye_accumulate_pass(scene, cam, state, vpls, vlp_index, cfg,
                               width, height, light_idx)


class Renderer:
    """Scene + camera + config + state: `step` is one progressive pass;
    the camera and scene edits restart the accumulation."""

    def __init__(self, scene: Scene, cam_orig: Sequence[float],
                 cam_target: Sequence[float], width: int, height: int,
                 cfg: IntegratorConfig | None = None, seed: int = 0,
                 reference_dims: bool = False,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        if scene.device != self.device:
            raise ValueError(f"scene is on {scene.device}, renderer on "
                             f"{self.device}")
        if reference_dims:
            width, height = cam_mod.reference_dims(width, height)
        _check_sphere_limit(scene)
        self.seed = seed
        self.cfg = cfg or IntegratorConfig()
        self.width, self.height = width, height
        self.scene = scene
        self.camera = Camera.make(cam_orig, cam_target, width, height,
                                  self.cfg.fov_deg, device=self.device)
        self.light_idx = static_light_indices(scene)
        self.state = init_state(width, height, self.cfg, seed, self.device)

    def step(self) -> RenderState:
        self.state = render_pass(self.scene, self.camera, self.state,
                                 self.cfg, self.width, self.height,
                                 self.light_idx)
        return self.state

    def render(self, spp: int) -> np.ndarray:
        """Accumulate ``spp`` passes; the running mean as float32
        ``[H, W, 3]`` (row 0 = bottom)."""
        for _ in range(spp):
            self.step()
        return self.state.colors.cpu().numpy()

    def reset(self) -> None:
        """Restart accumulation, keep scene and camera."""
        self.state = init_state(self.width, self.height, self.cfg,
                                self.seed, self.device)

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
