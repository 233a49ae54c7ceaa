"""The per-depth bounce kernel: wrappers of ``csrc/bounce_kernel.cu``.

Port of ``gpu_bidirectional_raytracer_tpu/ops/pallas_bounce.py``, whose
Pallas kernel ``_bounce_kernel`` runs one depth of the eye path on carried
state planes, once per depth, for scenes too large for the eye-path
megakernel (more than 64 spheres; complex.scn has 783) and for
direct-only rendering. Here it is ``bounce_kernel``, a CUDA kernel for
Hopper launched once per depth on a ``[14, N]`` float state (origin,
direction, radiance, throughput, specular, alive; `state_planes`), which it
updates in place, with a group of lanes of a warp per ray (`PER_LANE`).
Its depth is the eye-path kernel's own code (``csrc/tracer.cuh``) with
the sphere scans split over the group, so a bounce render equals a
`trace_kernel` render of the same rays bit for bit.

`trace_pallas_bounce` is the drop-in for `path_tracer.trace`. Given CPU
tensors it loops `bounce_plain`, the plain version of one depth on the
same state (`path_tracer.depth_step`), so on the CPU it equals
`path_tracer.trace` bit for bit. Given CUDA tensors it launches the
kernel or raises; it never falls back. Each launch adds one to
``LAUNCHES["bounce_kernel"]``.
"""

from __future__ import annotations

import ctypes

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
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan, pallas_trace
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import LAUNCHES

# Threads per block. ptxas gives the kernel 72-80 registers, so three
# blocks of 256 share an SM; held to 64 (four blocks) it spilled and its
# deep launches lost 20-40%. chip_smoke.py times 128, 256 and 512.
BLOCK = 256
# Spheres each lane of a ray's group keeps at least (`pallas_scan.
# group_size`): on complex.scn (783) the group is 16 lanes, on Cornell (9)
# one. chip_smoke.py times every G at every depth.
PER_LANE = 48
SMEM_LIMIT = 232448     # dynamic shared memory a block can opt in to
N_PLANES = 14           # o(3), d(3), rad(3), tp(3), specular, alive


def state_planes(rays: Rays) -> Tensor:
    """The initial ``[14, N]`` state of the rays: radiance 0, throughput
    1, specular and alive."""
    n, dev = rays.o.shape[0], rays.o.device
    planes = torch.empty((N_PLANES, n), dtype=torch.float32, device=dev)
    planes[0:3] = rays.o.detach().T
    planes[3:6] = rays.d.detach().T
    planes[6:9] = 0.0
    planes[9:14] = 1.0
    return planes


def planes_to_state(planes: Tensor) -> path_tracer.PathState:
    return path_tracer.PathState(
        o=planes[0:3].T, d=planes[3:6].T, rad=planes[6:9].T,
        throughput=planes[9:12].T, specular=planes[12] > 0.5,
        alive=planes[13] > 0.5)


def state_to_planes(state: path_tracer.PathState) -> Tensor:
    return torch.cat([state.o.T, state.d.T, state.rad.T, state.throughput.T,
                      state.specular.to(torch.float32)[None],
                      state.alive.to(torch.float32)[None]])


def bounce_plain(scene: Scene, cfg: IntegratorConfig,
                 light_idx: tuple[int, ...], planes: Tensor, key: rng.Key,
                 sample: int, depth: int, vpls: VplBuffer | None = None,
                 vlp_index: int | None = None, direct_only: bool = False,
                 lane_offset: int | None = None,
                 lane_total: int | None = None, collect: bool = False):
    """Plain version of one ``bounce_kernel`` launch: depth ``depth`` of
    every lane of the ``[14, N]`` state, returned as new planes. With
    ``collect`` (the plain version of ``aux_kernel``) it returns
    ``(planes, facts)``, the facts of `path_tracer.depth_step`."""
    n = planes.shape[1]
    draws = path_tracer.tape_draws(key, sample, n, planes.device,
                                   lane_offset, lane_total)
    state, facts = path_tracer.depth_step(
        scene, cfg, light_idx, planes_to_state(planes), draws, depth,
        vpls, vlp_index, direct_only, collect=collect)
    out = state_to_planes(state)
    return (out, facts) if collect else out


class BounceLaunch:
    """The prepared launches of one trace: tables on the card and the C
    arguments. ``launch(planes, depth)`` runs depth ``depth`` on the
    state in place, ``group`` lanes a ray, and adds one to
    ``LAUNCHES[entry]``."""

    def __init__(self, entry: str, tables: list, args: tuple, per_depth: int,
                 n: int, block: int, group: int):
        self.entry = entry
        self.tables = tables    # keeps every pointer in `args` alive
        self.args = args
        self.per_depth = per_depth
        self.n = n
        self.block = block
        self.group = group

    def launch(self, planes: Tensor, depth: int, facts: tuple = ()) -> None:
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        if (planes.shape != (N_PLANES, self.n) or planes.device
                != self.tables[0].device or planes.dtype != torch.float32
                or not planes.is_contiguous()):
            raise ValueError(f"the state must be a contiguous float32 "
                             f"[{N_PLANES}, {self.n}] tensor on the card")
        a = self.args
        args = (a[:8] + (planes.data_ptr(), self.n, depth * self.per_depth)
                + a[8:] + (self.block, self.group) + facts
                + (pallas_trace.current_stream(planes.device),))
        rc = _build.load(self.entry)(*args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {rc}")
        LAUNCHES[self.entry] += 1

    def resources(self) -> dict:
        """``{"smem_bytes", "blocks_per_sm"}`` of these launches: their
        dynamic shared memory and resident blocks per SM (CUDA's occupancy
        calculator). Needs a card."""
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        smem, blocks = ctypes.c_int(), ctypes.c_int()
        a = self.args
        rc = _build.load("bounce_kernel_resources")(
            int(self.entry == "aux_kernel"), self.group, a[1], a[3], a[5],
            a[7], self.block, ctypes.byref(smem), ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"bounce_kernel_resources: CUDA error {rc}")
        return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def prepare_bounce(scene: Scene, cfg: IntegratorConfig,
                   light_idx: tuple[int, ...], key: rng.Key, sample: int,
                   vpls: VplBuffer | None, vlp_index: int | None, n: int,
                   direct_only: bool = False, lane_offset: int | None = None,
                   lane_total: int | None = None, entry: str = "bounce_kernel",
                   block: int = BLOCK,
                   group: int | None = None) -> BounceLaunch:
    """Check the inputs and build the tables of one trace's launches
    (the tape of every depth at once); ``group``: the lanes a ray (by
    default `pallas_scan.group_size` with `PER_LANE`)."""
    if group is None:
        group = pallas_scan.group_size(scene.num_spheres, PER_LANE)
    scene_tab, vpl_tab, tape = pallas_trace.launch_tables(
        scene, cfg, light_idx, key, sample, vpls, vlp_index, n,
        lane_offset=lane_offset, lane_total=lane_total)
    scene_tab, vpl_tab = scene_tab.detach(), vpl_tab.detach()
    s = scene_tab.shape[0]
    # The kernel's shared memory: two packed tables of 4 floats a sphere,
    # the VPL window, the tape keys and light ids, 2 words per 32 spheres,
    # and the block's list of live rays (csrc/tracer.cuh's
    # live_list_rounds rounds of `block` rays, and 32 counts).
    smem = 4 * (8 * s + vpl_tab.numel() + tape.keys.numel()
                + 2 * ((s + 31) // 32) + max(block, 1024) + 32)
    if smem > SMEM_LIMIT:
        raise ValueError(f"{entry}: the tables need {smem} bytes of shared "
                         f"memory, above the {SMEM_LIMIT} a block can have")
    if block not in (32, 64, 128, 256, 512, 1024):
        raise ValueError(f"block of {block} threads")
    if group not in pallas_scan.GROUP_SIZES:
        raise ValueError(f"G = {group}: one of {pallas_scan.GROUP_SIZES}")
    pallas_trace.check_tape(tape, n, scene_tab.device)
    args = (scene_tab.data_ptr(), scene_tab.shape[0],
            vpl_tab.data_ptr(), vpl_tab.shape[0],
            tape.keys.data_ptr(), tape.n_rows,
            None if tape.stream is None else tape.stream.data_ptr(),
            len(light_idx),
            max(len(light_idx), 1), int(cfg.combine_half), int(direct_only),
            lane_offset or 0, n if lane_total is None else lane_total,
            cfg.emission_scale, cfg.light_gain)
    return BounceLaunch(entry, [scene_tab, vpl_tab, tape.keys, tape.stream],
                        args, 2 * max(len(light_idx), 1) + 3, n, block,
                        group)


def trace_pallas_bounce(scene: Scene, cfg: IntegratorConfig,
                        light_idx: tuple[int, ...], rays: Rays, key: rng.Key,
                        sample: int, vpls: VplBuffer | None = None,
                        vlp_index: int | None = None,
                        direct_only: bool = False,
                        lane_offset: int | None = None,
                        lane_total: int | None = None,
                        frame_dims: tuple[int, int] | None = None
                        ) -> Tensor:
    """Radiance ``[N, 3]`` of the rays, one kernel launch per depth; the
    drop-in for `path_tracer.trace` (forward only).

    ``frame_dims=(width, height)`` is accepted for the JAX signature: the
    TPU kernel reorders lanes into image blocks so that its dead-tile
    skip finds whole tiles dead, and here a dead ray costs its group one
    flag whatever its neighbours do, so the lanes keep their order."""
    del frame_dims
    vpls = vpls if cfg.use_vpl else None
    n = rays.o.shape[0]
    planes = state_planes(rays)
    if scene.device.type == "cpu":
        for depth in range(cfg.max_depth):
            planes = bounce_plain(scene, cfg, light_idx, planes, key, sample,
                                  depth, vpls, vlp_index, direct_only,
                                  lane_offset, lane_total)
        return planes[6:9].T.contiguous()
    pallas_trace.check_rays(rays.o.contiguous(), rays.d.contiguous(), n,
                            scene.device)
    call = prepare_bounce(scene, cfg, light_idx, key, sample, vpls,
                          vlp_index, n, direct_only, lane_offset, lane_total)
    for depth in range(cfg.max_depth):
        call.launch(planes, depth)
    return planes[6:9].T.contiguous()
