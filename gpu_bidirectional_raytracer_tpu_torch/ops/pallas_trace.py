"""The eye-path megakernel: wrappers of ``csrc/trace_kernel.cu``.

Port of ``gpu_bidirectional_raytracer_tpu/ops/pallas_trace.py``, whose
Pallas kernel ``_kernel`` runs the whole eye path of a tile of rays in one
TPU kernel. Here it is a CUDA kernel for Hopper, one thread per pixel over
packed scan tables (see the note at the top of the source for its design
and bound):

- `trace_pallas_camera` (camera mode): primary rays are made in the
  kernel from the pixel id and the jitter rows of the tape;
- `trace_pallas` (ray mode): the caller's rays, for a window
  ``[lane_offset, lane_offset + N)`` of a ``lane_total``-wide frame.

The random tape of a mix32 key is regenerated in the kernel from per-row
site keys (`rng.site_key_rows`), bit for bit `rng.site_uniforms`; for any
other key (threefry) `tape_table` builds the ``[K, n]`` tape on the card
(`rng.rows_uniforms`: `rng.site_uniforms`' values, every row in one
pass), in the same row order, and the kernel reads it (`Tape`). All five
eye-path kernels take their tape this way.

A wrapper given CPU tensors runs its plain PyTorch version
(`trace_camera_plain`, or `path_tracer.trace` in ray mode). Given CUDA
tensors it launches the kernel or raises; it never falls back. Each launch
adds one to ``LAUNCHES["trace_kernel"]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
from gpu_bidirectional_raytracer_tpu_torch import rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
    Rays,
    Scene,
    VplBuffer,
)
from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import vpl_window

# Launches of each CUDA kernel, counted where the kernel is launched
# (`ops.pallas_grad`, `ops.pallas_bounce`, `ops.pallas_bounce_grad` and
# `ops.pallas_scan` count theirs here too). The adjoint kernels' launches
# with the visibility carrier count under their own "_vis" names.
LAUNCHES = {"trace_kernel": 0, "grad_kernel": 0, "fused_kernel": 0,
            "grad_kernel_vis": 0, "fused_kernel_vis": 0,
            "bounce_kernel": 0, "aux_kernel": 0, "nearest_kernel": 0,
            "anyhit_kernel": 0}

_CAM_ROWS = 2                 # tape rows of the camera jitter
_SMEM_LIMIT = 232448          # shared memory of one block (H100: 227 KB)
# Threads per block of `trace_kernel`; chip_smoke.py times 128, 256 and
# 512 (on one H100, Cornell at 512x512: 512 about 4% ahead of 128 and 3%
# of 256).
BLOCK = 512


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def current_stream(dev) -> int:
    """The handle of PyTorch's current stream on ``dev``, which the bounce
    and scan kernels launch on."""
    return torch.cuda.current_stream(dev).cuda_stream


def _to_device(values: list, dtype: torch.dtype, device) -> Tensor:
    """A small host table copied without blocking the host (pinned)."""
    host = torch.tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def _scene_table(scene: Scene) -> Tensor:
    """``[S, 16]``: rad, p(3), e(3), c(3), refl, pad."""
    s = scene.num_spheres
    return torch.cat([scene.rad[:, None], scene.p, scene.e, scene.c,
                      scene.refl.to(torch.float32)[:, None],
                      torch.zeros((s, 5), dtype=torch.float32,
                                  device=scene.device)], dim=1).contiguous()


def _vpl_table(cfg: IntegratorConfig, vpls: VplBuffer | None,
               vlp_index: int | None, device) -> Tensor:
    """The gather window ``[V, 16]``: hp(3), rad(3), nl(3), valid, the
    host sphere id (the visibility carrier leaves it out of the VPL's
    shadow ray), pad; ``V = 0`` when there is no VPL gather."""
    if not (cfg.use_vpl and vpls is not None):
        return torch.zeros((0, 16), dtype=torch.float32, device=device)
    hp, rad, nl, valid, sid = vpl_window(cfg, vpls, vlp_index)
    v = hp.shape[0]
    return torch.cat([hp, rad, nl, valid.to(torch.float32)[:, None],
                      sid.to(torch.float32)[:, None],
                      torch.zeros((v, 5), dtype=torch.float32,
                                  device=device)], dim=1).contiguous()


class Tape(NamedTuple):
    """The random tape of one launch, in the kernels' row order
    (`tape_sites`): mix32 site keys regenerated in the kernel, or a
    streamed buffer."""

    keys: Tensor               # int32 words: [n_rows, 4] site keys (k0,
    #                            k1, block row, 0), then the light ids
    n_rows: int                # site-key rows; 0 for a streamed tape
    stream: Tensor | None      # [rows, n] float32 streamed tape, or None


def tape_sites(cfg: IntegratorConfig, n_slots: int, cam_jitter: bool
               ) -> list[tuple[int, int, list[int]]]:
    """``(depth, purpose, block rows)`` of every draw site in the kernels'
    order: the camera jitter's two rows (camera mode), then per depth the
    LIGHT_UV site's u1 rows of every light slot, its u2 rows, DIFF_UV
    rows 0-1 and REFR_RR row 0."""
    sites = [(0, rng.CAM_JITTER, [0, 1])] if cam_jitter else []
    for depth in range(cfg.max_depth):
        sites.append((depth, rng.LIGHT_UV,
                      list(range(0, 2 * n_slots, 2))
                      + list(range(1, 2 * n_slots, 2))))
        sites.append((depth, rng.DIFF_UV, [0, 1]))
        sites.append((depth, rng.REFR_RR, [0]))
    return sites


def tape_table(cfg: IntegratorConfig, light_idx: tuple[int, ...],
               key: rng.Key, sample: int, cam_jitter: bool, n: int,
               device, lane_offset: int | None = None,
               lane_total: int | None = None) -> Tape:
    """The tape of a launch over ``n`` lanes (the window ``[lane_offset,
    lane_offset + n)`` of a ``lane_total``-lane frame). A mix32 key ships
    one ``(k0, k1, row)`` per row; any other key a ``[rows, n]`` tape made
    on ``device`` by `rng.rows_uniforms`, the values of
    `rng.site_uniforms`."""
    sites = tape_sites(cfg, max(len(light_idx), 1), cam_jitter)
    rows = [r for depth, purpose, block in sites
            for r in rng.site_key_rows(key, sample, depth, purpose, block)]
    words: list[int] = []
    stream = None
    if rng.key_impl(key) == "mix32":
        words = [w for k0, k1, r in rows for w in (k0, k1, r, 0)]
        n_rows = len(rows)
    else:
        stream = rng.rows_uniforms(
            rng.key_impl(key), rows, n, device=device,
            lane_offset=lane_offset if lane_total is not None else None,
            lane_total=lane_total)
        n_rows = 0
    words += list(light_idx)
    # uint32 bits in int32 storage: the kernel reads them as uint32_t.
    words = [w - (1 << 32) if w >= (1 << 31) else w for w in words]
    return Tape(_to_device(words, torch.int32, device), n_rows, stream)


def _camera_table(cam: Camera, cfg: IntegratorConfig, width: int,
                  height: int, sample: int) -> Tensor:
    """``[32]`` camera constants: x_hat, y_hat, d_hat, orig, temp (0:15),
    film ``inv_w, half_w, inv_h, half_h`` (15:19), stratified jitter
    ``sx, sy, 1/k, on`` (20:24)."""
    x_hat, y_hat, d_hat, temp = cam_mod.camera_frame(cam)
    k = cfg.stratify
    host = [*cam_mod.film_coords(width, height), 0.0]
    host += ([float(sample % k), float((sample // k) % k), 1.0 / k, 1.0]
             if k > 0 else [0.0, 0.0, 0.0, 0.0])
    host += [0.0] * 8
    return torch.cat([x_hat, y_hat, d_hat, cam.orig, temp,
                      _to_device(host, torch.float32, cam.orig.device)])


class TraceLaunch:
    """One prepared launch of the kernel: its tables on the card, its
    output and its C arguments. Calling it launches the kernel and adds
    one to ``LAUNCHES["trace_kernel"]``."""

    def __init__(self, tables: list[Tensor], out: Tensor, args: tuple):
        self.tables = tables    # keeps every pointer in `args` alive
        self.out = out
        self.args = args

    def __call__(self) -> Tensor:
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        rc = _build.load("trace_kernel")(*self.args)
        if rc != 0:
            raise RuntimeError(f"trace_kernel launch failed: CUDA error {rc}")
        LAUNCHES["trace_kernel"] += 1
        return self.out


def launch_tables(scene: Scene, cfg: IntegratorConfig,
                  light_idx: tuple[int, ...], key: rng.Key, sample: int,
                  vpls: VplBuffer | None, vlp_index: int | None, n: int,
                  cam_jitter: bool = False, lane_offset: int | None = None,
                  lane_total: int | None = None):
    """``(scene_tab, vpl_tab, tape)`` of one launch over ``n`` lanes on
    the card. The two float tables are differentiable functions of the
    scene and the VPL buffer (`ops.pallas_grad` pulls gradients back
    through them)."""
    dev = scene.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernels run on a CUDA device, got {dev}")
    if any(not 0 <= i < scene.num_spheres for i in light_idx):
        raise ValueError(f"light indices {light_idx} out of range for "
                         f"{scene.num_spheres} spheres")
    tape = tape_table(cfg, light_idx, key, sample, cam_jitter, n, dev,
                      lane_offset, lane_total)
    return (_scene_table(scene), _vpl_table(cfg, vpls, vlp_index, dev),
            tape)


def check_rays(o: Tensor, d: Tensor, n: int, dev) -> None:
    for t in (o, d):
        if (t.device != dev or t.dtype != torch.float32
                or t.shape != (n, 3) or not t.is_contiguous()):
            raise ValueError("rays must be contiguous float32 [N, 3] "
                             f"tensors on {dev}")


def check_tape(tape: Tape, n: int, dev) -> None:
    if tape.stream is not None and (
            tape.stream.device != dev or tape.stream.dtype != torch.float32
            or tape.stream.dim() != 2 or tape.stream.shape[1] != n
            or not tape.stream.is_contiguous()):
        raise ValueError(f"a streamed tape must be a contiguous float32 "
                         f"[rows, {n}] tensor on {dev}")


def smem_bytes(scene_tab: Tensor, vpl_tab: Tensor, tape: Tape) -> int:
    """Shared memory of a `trace_kernel` launch: the packed scan tables
    (two float4 a sphere), the scene and VPL tables, the tape keys and
    light ids, and the table loader's scratch words."""
    s = scene_tab.shape[0]
    return (32 * s + 4 * (scene_tab.numel() + vpl_tab.numel()
                          + tape.keys.numel()) + 8 * ((s + 31) // 32))


def make_launch(scene_tab: Tensor, vpl_tab: Tensor, tape: Tape,
                cfg: IntegratorConfig, light_idx: tuple[int, ...], n: int, *,
                cam_tab: Tensor | None = None, width: int = 0,
                rays: Rays | None = None, lane_offset: int = 0,
                lane_total: int | None = None,
                block: int = BLOCK) -> TraceLaunch:
    """The launch of `trace_kernel` on tables already on the card, in
    blocks of ``block`` threads."""
    dev = scene_tab.device
    keys = tape.keys
    smem = smem_bytes(scene_tab, vpl_tab, tape)
    if block not in (32, 64, 128, 256, 512, 1024):
        raise ValueError(f"trace_kernel launch of {block} threads")
    if smem > _SMEM_LIMIT:
        raise ValueError(f"trace_kernel tables need {smem} bytes of shared "
                         f"memory, above {_SMEM_LIMIT}")
    check_tape(tape, n, dev)
    scene_tab, vpl_tab = scene_tab.detach(), vpl_tab.detach()
    tables = [scene_tab, vpl_tab, keys, tape.stream]
    if cam_tab is not None:
        tables.append(cam_tab)
    if rays is not None:
        check_rays(rays.o, rays.d, n, dev)
        tables += [rays.o, rays.d]
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    args = (scene_tab.data_ptr(), scene_tab.shape[0],
            vpl_tab.data_ptr(), vpl_tab.shape[0],
            keys.data_ptr(), tape.n_rows,
            None if tape.stream is None else tape.stream.data_ptr(),
            len(light_idx),
            None if cam_tab is None else cam_tab.data_ptr(),
            None if rays is None else rays.o.data_ptr(),
            None if rays is None else rays.d.data_ptr(),
            n, width, _CAM_ROWS if cam_tab is not None else 0,
            cfg.max_depth, max(len(light_idx), 1),
            int(cfg.combine_half),
            lane_offset, n if lane_total is None else lane_total,
            cfg.emission_scale, cfg.light_gain,
            out.data_ptr(), block, current_stream(dev))
    return TraceLaunch(tables, out, args)


def trace_resources(scene_tab: Tensor, vpl_tab: Tensor, tape: Tape,
                    n_lights: int, block: int = BLOCK) -> dict:
    """``{"smem_bytes", "blocks_per_sm"}`` of a `trace_kernel` launch on
    these tables: its dynamic shared memory and resident blocks per SM
    (CUDA's occupancy calculator). Needs a card."""
    import ctypes

    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _build.load("trace_kernel_resources")(
        scene_tab.shape[0], vpl_tab.shape[0], tape.n_rows, n_lights, block,
        ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"trace_kernel_resources: CUDA error {rc}")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def prepare_launch(scene: Scene, cfg: IntegratorConfig,
                   light_idx: tuple[int, ...], key: rng.Key, sample: int,
                   vpls: VplBuffer | None, vlp_index: int | None, n: int, *,
                   cam_tab: Tensor | None = None, width: int = 0,
                   rays: Rays | None = None, lane_offset: int = 0,
                   lane_total: int | None = None,
                   block: int = BLOCK) -> TraceLaunch:
    """Check the inputs and build the tables of one kernel launch."""
    scene_tab, vpl_tab, tape = launch_tables(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, n,
        cam_jitter=cam_tab is not None, lane_offset=lane_offset,
        lane_total=lane_total)
    return make_launch(scene_tab, vpl_tab, tape, cfg, light_idx, n,
                       cam_tab=cam_tab, width=width, rays=rays,
                       lane_offset=lane_offset, lane_total=lane_total,
                       block=block)


def prepare_camera_launch(scene: Scene, cfg: IntegratorConfig,
                          light_idx: tuple[int, ...], cam: Camera,
                          width: int, height: int, key: rng.Key,
                          sample: int, vpls: VplBuffer | None = None,
                          vlp_index: int | None = None,
                          block: int = BLOCK) -> TraceLaunch:
    """The launch that `trace_pallas_camera` makes for CUDA tensors."""
    return prepare_launch(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, width * height,
        cam_tab=_camera_table(cam, cfg, width, height, sample), width=width,
        block=block)


def trace_camera_plain(scene: Scene, cfg: IntegratorConfig,
                       light_idx: tuple[int, ...], cam: Camera, width: int,
                       height: int, key: rng.Key, sample: int,
                       vpls: VplBuffer | None = None,
                       vlp_index: int | None = None) -> Tensor:
    """Plain camera-mode version: `camera.primary_rays` on the jitter
    rows, then `path_tracer.trace` on the same tape. ``[H*W, 3]``."""
    n = width * height
    dev = scene.device
    px, py = cam_mod.pixel_grid(width, height, device=dev)
    jit_uv = rng.site_uniforms(key, sample, 0, rng.CAM_JITTER, 2, n,
                               device=dev)
    ju, jv = jit_uv[0], jit_uv[1]
    if cfg.stratify > 0:
        ju, jv = cam_mod.stratify_jitter(ju, jv, sample, cfg.stratify)
    rays = cam_mod.primary_rays(cam, width, height, ju, jv, px, py)
    return path_tracer.trace(scene, cfg, light_idx, rays, key, sample,
                             vpls=vpls, vlp_index=vlp_index)


def trace_pallas_camera(scene: Scene, cfg: IntegratorConfig,
                        light_idx: tuple[int, ...], cam: Camera, width: int,
                        height: int, key: rng.Key, sample: int,
                        vpls: VplBuffer | None = None,
                        vlp_index: int | None = None) -> Tensor:
    """Radiance ``[H*W, 3]`` of one jittered sample per pixel, primary rays
    made in the kernel."""
    if scene.device.type == "cpu":
        return trace_camera_plain(scene, cfg, light_idx, cam, width, height,
                                  key, sample, vpls, vlp_index)
    return prepare_camera_launch(scene, cfg, light_idx, cam, width, height,
                                 key, sample, vpls, vlp_index)()


def trace_pallas(scene: Scene, cfg: IntegratorConfig,
                 light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                 sample: int, vpls: VplBuffer | None = None,
                 vlp_index: int | None = None,
                 lane_offset: int | None = None,
                 lane_total: int | None = None) -> Tensor:
    """Radiance ``[N, 3]`` of the given rays (ray mode); the drop-in for
    `path_tracer.trace`."""
    if scene.device.type == "cpu":
        return path_tracer.trace(scene, cfg, light_idx, rays, key, sample,
                                 vpls=vpls, vlp_index=vlp_index,
                                 lane_offset=lane_offset,
                                 lane_total=lane_total)
    n = rays.o.shape[0]
    return prepare_launch(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, n, rays=rays,
        lane_offset=lane_offset or 0,
        lane_total=n if lane_total is None else lane_total)()
