"""The per-bounce sphere-scan kernels: wrappers of ``csrc/scan_kernel.cu``.

Port of ``gpu_bidirectional_raytracer_tpu/ops/pallas_scan.py``, whose two
Pallas kernels carry the scan route of `path_tracer.trace`
(``scan_backend="pallas"``): the tracer keeps the bounce loop, and each
depth runs its three sphere scans as kernels, the nearest hit with a fused
gather of the hit sphere's attributes (`nearest_tiles`) and the any-hit of
the light and VPL shadow segments (`anyhit_tiles`, the VPL one in vacuum
mode, where emitters do not block). Here they are ``nearest_kernel`` and
``anyhit_kernel``, CUDA kernels for Hopper with a group of lanes of a warp
per ray (`group_size`).

Both skip a whole tile of lanes when none of them is alive (nearest) or
active (any-hit); a skipped lane reports a miss or no occlusion. The TPU
tile is 1024 lanes; the kernels' is one lane (`TILE`, `ANYHIT_TILE`): a
lane that is not alive reports a miss, one that is not active
unoccluded. The plain versions (`nearest_plain`, `anyhit_plain`) apply
the same rule to the full all-pairs scan of `integrators.intersect` for
any ``tile``, so on the card a kernel and its plain version with its tile
give the same bits on every lane, and with ``tile=1024`` the plain
version gives JAX's. Outputs on live or active lanes do not depend on the
tile, and every caller masks with them.

Forward only, as in JAX: a wrapper raises when an input requires grad
under autograd. Given CPU tensors it runs the plain version; given CUDA
tensors it launches the kernel or raises; it never falls back. Each launch
adds one to ``LAUNCHES["nearest_kernel"]`` or ``LAUNCHES["anyhit_kernel"]``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core.types import Scene
from gpu_bidirectional_raytracer_tpu_torch.integrators import intersect as isect
from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import LAUNCHES

TILE = 1                # lanes the nearest kernel skips together: one
ANYHIT_TILE = 1         # the any-hit kernel's: each lane alone
# Threads per block of the persistent blocks: each loads the packed table
# once and lists 1,024 rays a round, so blocks of 1,024 load it for the
# most rays and list them with the fewest barriers (on one H100, complex.scn
# at 512x384: the nearest kernel's mean launch 0.047 ms in blocks of 1,024
# against 0.059 in blocks of 256; PERF.md).
BLOCK = 1024
ANYHIT_BLOCK = 1024
GROUP_SIZES = (1, 4, 8, 16, 32)   # the lanes a ray the kernels take
# Spheres each lane of a group keeps at least: on complex.scn (783) the
# nearest kernel's group is 16 lanes and the any-hit kernel's 32, on
# Cornell (9) one for both.
PER_LANE = 48
ANYHIT_PER_LANE = 16
_BIG = 1e20             # miss marker of the nearest scan


def group_size(n_spheres: int, per_lane: int) -> int:
    """Lanes of a warp per ray for a scan of ``n_spheres`` spheres: the
    largest power of two up to 32 that leaves each lane at least
    ``per_lane`` spheres (a lone lane runs no collective)."""
    g = 1
    while g < 32 and n_spheres >= 2 * g * per_lane:
        g *= 2
    return g


def _forward_only(scene: Scene, *tensors: Tensor) -> None:
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (scene.rad, scene.p, scene.e, scene.c,
                                      *tensors)):
        raise RuntimeError("the scan kernels are forward only (as in the JAX "
                           "package): differentiate with scan_backend 'xla' "
                           "or 'mxu'")


def tile_live(flag: Tensor, tile: int) -> Tensor:
    """``[N]`` bool: whether the tile of ``tile`` lanes holding each lane
    has a set ``flag``."""
    n = flag.shape[0]
    pad = torch.zeros(((-n) % tile,), dtype=torch.bool, device=flag.device)
    live = torch.cat([flag.to(torch.bool), pad]).reshape(-1, tile).any(dim=1)
    return live.repeat_interleave(tile)[:n]


def nearest_plain(scene: Scene, o: Tensor, d: Tensor, alive: Tensor,
                  tile: int = TILE):
    """Plain version of `nearest_tiles`: the all-pairs scan, with the
    lanes of tiles that hold no live lane reported as misses."""
    hit, t, hit_id = isect.intersect(scene, o, d)
    hit = hit & tile_live(alive, tile)
    t = torch.where(hit, t, _BIG)
    hit_id = torch.where(hit, hit_id, 0)
    table = torch.cat([scene.p, scene.e, scene.c], dim=1)[hit_id]
    attrs = torch.where(hit[:, None], table, 0.0)
    refl = torch.where(hit, scene.refl[hit_id], 0).to(torch.int32)
    return (hit, t, hit_id.to(torch.int32), attrs[:, 0:3], attrs[:, 3:6],
            attrs[:, 6:9], refl)


def anyhit_plain(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                 active: Tensor, vacuum: bool = False,
                 tile: int = ANYHIT_TILE) -> Tensor:
    """Plain version of `anyhit_tiles`: the all-pairs any-hit, with the
    lanes of tiles that hold no active lane reported unoccluded."""
    test = isect.intersect_p_vacuum if vacuum else isect.intersect_p
    return test(scene, o, d, maxt) & tile_live(active, tile)


def _lanes(n: int, dev, *tensors: Tensor) -> list[Tensor]:
    """The inputs, contiguous, checked for the kernel: ``[n, 3]`` or
    ``[n]`` float32 and ``[n]`` bool on the card."""
    out = []
    for t in tensors:
        t = t.contiguous()
        ok = t.device == dev and t.shape[0] == n and (
            (t.dtype == torch.float32 and t.shape[1:] in ((3,), ()))
            or (t.dtype == torch.bool and t.dim() == 1))
        if not ok:
            raise ValueError(f"scan kernel input {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}: wants [{n}, 3] or [{n}] "
                             f"float32, or [{n}] bool, on {dev}")
        out.append(t)
    return out


class ScanLaunch:
    """One prepared launch of a scan kernel: its inputs and outputs on
    the card and its C arguments. Calling it launches the kernel, adds
    one to ``LAUNCHES[entry]`` and returns the outputs."""

    def __init__(self, entry: str, tensors: list[Tensor], outs: tuple,
                 args: tuple):
        self.entry = entry
        self.tensors = tensors  # keeps every pointer in `args` alive
        self.outs = outs
        self.args = args

    def __call__(self) -> tuple:
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        rc = _build.load(self.entry)(*self.args)
        if rc != 0:
            raise RuntimeError(f"{self.entry} launch failed: CUDA error {rc}")
        LAUNCHES[self.entry] += 1
        return self.outs


def _check_launch(block: int, group: int) -> None:
    if group not in GROUP_SIZES or block not in (32, 64, 128, 256, 512,
                                                 1024):
        raise ValueError(f"scan launch of {block} threads, G = {group}")


def prepare_nearest(scene: Scene, o: Tensor, d: Tensor, alive: Tensor,
                    block: int = BLOCK,
                    group: int | None = None) -> ScanLaunch:
    """The launch of ``nearest_kernel`` on these lanes, ``group`` lanes a
    ray (by default `group_size` with `PER_LANE`); its outputs are ``(t
    [N], hit_id [N] int32, attrs [9, N] (p, e, c), refl [N] int32)``."""
    if group is None:
        group = group_size(scene.num_spheres, PER_LANE)
    _check_launch(block, group)
    n, dev = o.shape[0], scene.device
    o, d, alive = _lanes(n, dev, o, d, alive)
    table = pallas_trace._scene_table(scene)
    outs = (torch.empty((n,), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev),
            torch.empty((9, n), dtype=torch.float32, device=dev),
            torch.empty((n,), dtype=torch.int32, device=dev))
    return ScanLaunch("nearest_kernel", [table, o, d, alive], outs, (
        table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
        alive.data_ptr(), n, *(x.data_ptr() for x in outs), block, group,
        pallas_trace.current_stream(dev)))


def prepare_anyhit(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                   active: Tensor, vacuum: bool = False,
                   block: int = ANYHIT_BLOCK,
                   group: int | None = None) -> ScanLaunch:
    """The launch of ``anyhit_kernel`` on these segments, ``group`` lanes
    a segment (by default `group_size` with `ANYHIT_PER_LANE`); its output
    is ``(occluded [N] bool,)``."""
    if group is None:
        group = group_size(scene.num_spheres, ANYHIT_PER_LANE)
    _check_launch(block, group)
    n, dev = o.shape[0], scene.device
    o, d, maxt, active = _lanes(n, dev, o, d, maxt, active)
    table = pallas_trace._scene_table(scene)
    occ = torch.empty((n,), dtype=torch.bool, device=dev)
    return ScanLaunch("anyhit_kernel", [table, o, d, maxt, active], (occ,), (
        table.data_ptr(), table.shape[0], o.data_ptr(), d.data_ptr(),
        maxt.data_ptr(), active.data_ptr(), n, int(vacuum), occ.data_ptr(),
        block, group, pallas_trace.current_stream(dev)))


def _resources(entry: str, *args) -> dict:
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    smem, blocks = ctypes.c_int(), ctypes.c_int()
    rc = _build.load(entry)(*args, ctypes.byref(smem), ctypes.byref(blocks))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")
    return {"smem_bytes": smem.value, "blocks_per_sm": blocks.value}


def anyhit_resources(scene: Scene, vacuum: bool, block: int = ANYHIT_BLOCK,
                     group: int | None = None) -> dict:
    """``{"smem_bytes", "blocks_per_sm"}`` of an ``anyhit_kernel`` launch
    on this scene: its dynamic shared memory and resident blocks per SM
    (CUDA's occupancy calculator). Needs a card."""
    if group is None:
        group = group_size(scene.num_spheres, ANYHIT_PER_LANE)
    return _resources("anyhit_kernel_resources", group, scene.num_spheres,
                      int(vacuum), block)


def nearest_resources(scene: Scene, block: int = BLOCK,
                      group: int | None = None) -> dict:
    """The same for a ``nearest_kernel`` launch on this scene."""
    if group is None:
        group = group_size(scene.num_spheres, PER_LANE)
    return _resources("nearest_kernel_resources", group, scene.num_spheres,
                      block)


def nearest_tiles(scene: Scene, o: Tensor, d: Tensor, alive: Tensor):
    """Nearest hit and the hit sphere's attributes of the rays ``o, d [N,
    3]``: ``(hit [N] bool, t [N], hit_id [N] int32, p, e, c [N, 3], refl
    [N] int32)``, as `intersect.intersect` plus
    `intersect.gather_sphere_attrs`. Lanes that are not ``alive`` report
    a miss (t = 1e20, id 0, zero attributes); callers mask on ``alive &
    hit`` as they do for the all-pairs scan."""
    _forward_only(scene, o, d)
    if scene.device.type == "cpu":
        return nearest_plain(scene, o, d, alive)
    t, hit_id, attrs, refl = prepare_nearest(scene, o, d, alive)()
    return (t < _BIG, t, hit_id, attrs[0:3].T, attrs[3:6].T, attrs[6:9].T,
            refl)


def anyhit_tiles(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                 active: Tensor, vacuum: bool = False) -> Tensor:
    """Whether a sphere blocks each shadow segment ``o + t d``, ``0 < t <
    maxt``: ``[N]`` bool; with ``vacuum``, emitters do not block. Lanes
    that are not ``active`` report unoccluded; callers mask them out, as
    they do for the all-pairs scan."""
    _forward_only(scene, o, d, maxt)
    if scene.device.type == "cpu":
        return anyhit_plain(scene, o, d, maxt, active, vacuum)
    return prepare_anyhit(scene, o, d, maxt, active, vacuum)()[0]
