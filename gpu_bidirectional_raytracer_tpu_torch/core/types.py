"""Scene, camera, rays, VPLs, render state and integrator config.

Port of ``gpu_bidirectional_raytracer_tpu/core/types.py``: the same fields
and defaults, held as torch tensors in small dataclasses. Constructors that
create tensors take an explicit ``device``; it defaults to ``"cuda"`` and
raises when no card is present (see :func:`resolve_device`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm

# Material codes — the .scn integer encoding.
DIFF, SPEC, REFR, LITE = 0, 1, 2, 3

# Reference constants (same values as the JAX package).
EPSILON = 0.01
LIGHT_POINTS = 4096
VPL_DEPTH = 1
MAX_VLP = 1
MAX_ITER = 3
MAX_EYE_DEPTH = 7  # bounce loop runs depths 0..6
TOL = 1e-4


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point will use; raises if it is a missing card.

    The port never falls back to the CPU on its own: the CPU is used only
    when the caller asks for it.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but "
                f"torch.cuda.is_available() is False; pass device='cpu' to "
                f"run on the CPU")
        if dev.index is None:   # "cuda" names the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclasses.dataclass(frozen=True)
class Scene:
    """Spheres as a structure of arrays: ``rad [S]``, ``p/e/c [S,3]``,
    ``refl [S] int32``."""

    rad: Tensor
    p: Tensor
    e: Tensor
    c: Tensor
    refl: Tensor

    @property
    def num_spheres(self) -> int:
        return self.rad.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rad.device

    def is_light(self) -> Tensor:
        """Emitter mask: any nonzero emission channel."""
        return torch.any(self.e != 0.0, dim=-1)

    @staticmethod
    def from_lists(spheres: list[tuple], device: str | torch.device = "cuda"
                   ) -> "Scene":
        """Build from ``[(rad, p, e, c, refl), ...]`` python tuples."""
        dev = resolve_device(device)

        def f32(vals):
            return torch.tensor(vals, dtype=torch.float32, device=dev)

        return Scene(rad=f32([s[0] for s in spheres]),
                     p=f32([s[1] for s in spheres]),
                     e=f32([s[2] for s in spheres]),
                     c=f32([s[3] for s in spheres]),
                     refl=torch.tensor([s[4] for s in spheres],
                                       dtype=torch.int32, device=dev))

    def replace(self, **kw: Any) -> "Scene":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera with derived basis: ``dir = norm(target - orig)``,
    ``x = norm(dir x up) * (width*fov/height)``, ``y = norm(x x dir) * fov``
    with ``fov`` 45 degrees in radians and ``up = +Y``."""

    orig: Tensor
    target: Tensor
    dir: Tensor
    x: Tensor
    y: Tensor

    @staticmethod
    def make(orig, target, width: int, height: int, fov_deg: float = 45.0,
             device: str | torch.device = "cuda") -> "Camera":
        dev = resolve_device(device)
        orig = torch.as_tensor(orig, dtype=torch.float32, device=dev)
        target = torch.as_tensor(target, dtype=torch.float32, device=dev)
        return Camera.update(orig, target, width, height, fov_deg)

    @staticmethod
    def update(orig: Tensor, target: Tensor, width: int, height: int,
               fov_deg: float = 45.0) -> "Camera":
        """Recompute the derived basis from ``orig`` and ``target``."""
        f32 = dict(dtype=torch.float32, device=orig.device)
        fov = (torch.tensor(math.pi / 180.0, **f32)
               * torch.tensor(fov_deg, **f32))
        d = vm.norm(target - orig)
        up = torch.tensor([0.0, 1.0, 0.0], **f32)
        x = vm.norm(vm.cross(d, up)) * (width * fov / height)
        y = vm.norm(vm.cross(x, d)) * fov
        return Camera(orig=orig, target=target, dir=d, x=x, y=y)

    def replace(self, **kw: Any) -> "Camera":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Rays:
    """Batched rays: origin ``o [N,3]``, unit direction ``d [N,3]``."""

    o: Tensor
    d: Tensor


@dataclasses.dataclass(frozen=True)
class VplBuffer:
    """Virtual point lights ``[vpl_depth, light_points, 3]`` with a validity
    mask and the host sphere id of each deposit."""

    hp: Tensor
    rad: Tensor
    nl: Tensor
    valid: Tensor  # [D, N] bool
    sid: Tensor    # [D, N] int32

    @staticmethod
    def zeros(depth: int = VPL_DEPTH, n: int = LIGHT_POINTS,
              device: str | torch.device = "cuda") -> "VplBuffer":
        dev = resolve_device(device)
        return VplBuffer(
            hp=torch.zeros((depth, n, 3), dtype=torch.float32, device=dev),
            rad=torch.zeros((depth, n, 3), dtype=torch.float32, device=dev),
            nl=torch.zeros((depth, n, 3), dtype=torch.float32, device=dev),
            valid=torch.zeros((depth, n), dtype=torch.bool, device=dev),
            sid=torch.zeros((depth, n), dtype=torch.int32, device=dev))


@dataclasses.dataclass(frozen=True)
class RenderState:
    """Progressive accumulation state.

    ``colors``/``counter`` stay on the device. ``vlp_index`` and ``sample``
    are host integers (the schedule branches on them), and ``key`` holds
    the 32-bit words of the render key (`rng.make_key`: mix32, a
    `rng.ThreefryKey` or a `rng.RbgKey`).
    """

    colors: Tensor      # [H, W, 3] running mean radiance
    counter: Tensor     # [H, W] int32 samples per pixel
    vpls: VplBuffer
    vlp_index: int      # VPL gather window start
    sample: int         # progressive pass index
    key: tuple[int, ...]

    def replace(self, **kw: Any) -> "RenderState":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class IntegratorConfig:
    """Static integrator configuration; the JAX package's fields and
    defaults, field for field.

    ``emission_scale``/``light_gain``: emitter-hit and direct-light scale
    (CPU golden 10, GPU 1). ``use_vpl`` + ``combine_half``: gather VPLs and
    average ``(direct + vpl) / 2``. ``max_samples``: per-pixel sample cap.
    ``stale_vpl_window``: emulate the reference's non-wrapping VPL window.
    The gradient fields (``vis_grad_tau``, ``sil_grad_tau``,
    ``sil_spec_depth``) turn on and shape the straight-through gradient
    carriers (`integrators.direct`, `diff.gradients`), whose values are 0:
    they never change an image.
    """

    max_depth: int = MAX_EYE_DEPTH
    emission_scale: float = 1.0
    light_gain: float = 1.0
    use_vpl: bool = True
    combine_half: bool = True
    vpl_depth: int = VPL_DEPTH
    max_vlp: int = MAX_VLP
    light_points: int = LIGHT_POINTS
    max_iter: int = MAX_ITER
    throughput_tol: float = TOL
    fov_deg: float = 45.0
    max_samples: int = 30000
    stratify: int = 0
    vis_grad_tau: float = 0.0
    sil_grad_tau: float = 0.0
    sil_spec_depth: int = 2
    stale_vpl_window: bool = False

    @staticmethod
    def cpu_golden() -> "IntegratorConfig":
        """The CPU reference path: emission and light gain 10, no VPLs."""
        return IntegratorConfig(emission_scale=10.0, light_gain=10.0,
                                use_vpl=False, combine_half=False)

    @staticmethod
    def gpu() -> "IntegratorConfig":
        """The GPU eye kernel's intent: the defaults."""
        return IntegratorConfig()
