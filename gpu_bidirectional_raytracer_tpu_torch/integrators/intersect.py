"""Vectorized ray-sphere intersection.

Port of ``gpu_bidirectional_raytracer_tpu/integrators/intersect.py``:
all-pairs ``[N rays, S spheres]`` quadratic roots with the reference's
root choice (the smaller root if > EPSILON, else the larger if > EPSILON,
else miss), the 1e-6 tangency clamp on the discriminant, a nearest-hit
scan that keeps the lowest index on ties, and the any-hit tests for shadow
rays (the vacuum variant lets emitters through). ``method="direct"``
evaluates ``op = p - o`` as the reference does; ``method="mxu"`` expands
the two dot products so that their cross terms are ``[N, 3] @ [3, S]``
matrix products, whose backward is matrix products too (the roots agree
with the direct form to about 1e-3 at Cornell scale). `sphere_root` is the
direct root for one given sphere per lane: what the re-walk of the
many-sphere gradient uses instead of the scan. `soft_visibility` is the
relaxed shadow test whose linearization the visibility carrier
(``IntegratorConfig.vis_grad_tau``) adds to the gradient.
"""

from __future__ import annotations

import torch
from torch import Tensor

from gpu_bidirectional_raytracer_tpu_torch.core import vecmath as vm
from gpu_bidirectional_raytracer_tpu_torch.core.types import EPSILON, Scene

_BIG = 1e20  # miss sentinel of the nearest-hit scan

# Width of `soft_visibility`'s far-endpoint sigmoid, as a fraction of tau,
# in scene units (the JAX package's constant; csrc/grad_kernel.cu's
# kEndpointFrac): the endpoint crossing is sampled densely by the light
# tape, so a narrow band costs no variance and removes the bias of a wide
# one.
ENDPOINT_TAU_FRACTION = 0.25


def _tf32_matmuls() -> bool:
    """Whether float32 matrix products on the card may round to TF32."""
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)
    return matmul.allow_tf32 if precision is None else precision == "tf32"


def _cross(a: Tensor, p: Tensor) -> Tensor:
    """``a @ p.T`` (``[N, 3] @ [3, S]``) in full float32. TF32 would move
    the roots by far more than the expanded form's 1e-3, so on the card
    this raises while TF32 matrix products are on, rather than change a
    setting that belongs to the caller."""
    if a.device.type == "cuda" and _tf32_matmuls():
        raise ValueError(
            "the mxu sphere scan needs full float32 matrix products: turn "
            "TF32 off (torch.backends.cuda.matmul.fp32_precision = 'ieee')")
    return torch.matmul(a, p.T)


def sphere_distances(scene: Scene, o: Tensor, d: Tensor,
                     eps: float = EPSILON, method: str = "direct") -> Tensor:
    """All-pairs hit distances ``[N, S]``; 0 where there is no hit.
    ``method``: ``"direct"`` or ``"mxu"`` (see the module note)."""
    if method == "mxu":
        b = _cross(d, scene.p) - vm.dot(o, d)[:, None]
        opop = (vm.dot(scene.p, scene.p)[None, :] - 2.0 * _cross(o, scene.p)
                + vm.dot(o, o)[:, None])
    elif method == "direct":
        op = scene.p[None, :, :] - o[:, None, :]                 # [N, S, 3]
        b = vm.dot(op, d[:, None, :])
        opop = vm.dot(op, op)
    else:
        raise ValueError(f"unknown method {method!r}")
    det = b * b - opop + (scene.rad * scene.rad)[None, :]
    hit = det >= 0.0
    sq = torch.sqrt(torch.clamp(torch.where(hit, det, 1.0), min=1e-6))
    t1 = b - sq
    t2 = b + sq
    zero = torch.zeros_like(t1)
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, zero))
    return torch.where(hit, t, zero)


def intersect(scene: Scene, o: Tensor, d: Tensor, method: str = "direct"
              ) -> tuple[Tensor, Tensor, Tensor]:
    """Nearest hit: ``(hit [N] bool, t [N], id [N] int64)``."""
    return nearest_of(sphere_distances(scene, o, d, method=method))


def nearest_of(ts: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """``(hit, t, id)`` of the nearest positive entry of hit distances
    ``ts [N, S]``; ``t`` is ``_BIG`` where there is none."""
    masked = torch.where(ts > 0.0, ts, torch.full_like(ts, _BIG))
    t, idx = torch.min(masked, dim=-1)
    # torch.min's index on ties is not specified: take the lowest index.
    idx = torch.argmax((masked == t[:, None]).to(torch.uint8), dim=-1)
    return t < _BIG, t, idx


def intersect_p(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                method: str = "direct") -> Tensor:
    """Any hit with ``0 < t < maxt`` (``maxt [N]``)."""
    ts = sphere_distances(scene, o, d, method=method)
    return torch.any((ts > 0.0) & (ts < maxt[:, None]), dim=-1)


def intersect_p_vacuum(scene: Scene, o: Tensor, d: Tensor,
                       maxt: Tensor, method: str = "direct") -> Tensor:
    """Any hit within ``maxt`` by a non-emissive sphere."""
    ts = sphere_distances(scene, o, d, method=method)
    blocker = torch.logical_not(scene.is_light())[None, :]
    return torch.any((ts > 0.0) & (ts < maxt[:, None]) & blocker, dim=-1)


def anyhit_tests(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                 vacuum: bool = False) -> Tensor:
    """Sphere tests ``[N]`` that an any-hit scan stopping at its first
    blocker makes per ray (the CUDA kernel's ``occluded``); the vacuum scan
    skips emitters untested. A count of work, not part of the estimator."""
    ts = sphere_distances(scene, o, d)
    tested = torch.ones_like(ts, dtype=torch.bool)
    if vacuum:
        tested = tested & torch.logical_not(scene.is_light())[None, :]
    block = ((ts > 0.0) & (ts < maxt[:, None]) & tested).to(torch.int64)
    # Sphere s is tested when no blocker comes before it.
    clear_before = (torch.cumsum(block, dim=-1) - block) == 0
    return (tested & clear_before).sum(dim=-1)


_GATHER_CHUNK = 1 << 15   # lanes per one-hot block of the gather's backward


class _RowGather(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's cotangents as a
    one-hot product, ``one_hot(idx)^T @ grad``, in blocks of lanes (the
    JAX package's gather, `integrators/intersect.py:116`). The backward of
    plain indexing walks the lanes of a repeated index one after another
    on the card; here 196,608 lanes hit a few of 783 spheres, and a sum
    by matrix product takes milliseconds instead of a second. The values
    of the forward are the indexing's; the sums are deterministic."""

    @staticmethod
    def forward(ctx, table: Tensor, idx: Tensor) -> Tensor:
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad: Tensor):
        (idx,) = ctx.saved_tensors
        out = torch.zeros((ctx.rows, grad.shape[1]), dtype=grad.dtype,
                          device=grad.device)
        for lo in range(0, idx.shape[0], _GATHER_CHUNK):
            part = idx[lo:lo + _GATHER_CHUNK]
            hot = torch.zeros((part.shape[0], ctx.rows), dtype=grad.dtype,
                              device=grad.device)
            hot.scatter_(1, part[:, None], 1.0)
            out = out + hot.T @ grad[lo:lo + _GATHER_CHUNK]
        return out, None


def gather_sphere_attrs(scene: Scene, hit_id: Tensor, with_rad: bool = False):
    """Per-lane ``(p, e, c, refl)`` of the spheres ``hit_id [N]``, and
    their radius last with ``with_rad``: one gather of the float columns
    (`_RowGather`) and one of the material codes."""
    table = torch.cat([scene.p, scene.e, scene.c, scene.rad[:, None]], dim=1)
    rows = _RowGather.apply(table, hit_id)
    attrs = (rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], scene.refl[hit_id])
    return attrs + (rows[:, 9],) if with_rad else attrs


def sphere_root(o: Tensor, d: Tensor, p: Tensor, rad: Tensor,
                eps: float = EPSILON) -> Tensor:
    """Hit distance ``[N]`` of one sphere per lane (``o, d, p [N, 3]``,
    ``rad [N]``); 0 where it is missed. The expressions of
    `sphere_distances` in its order, so for the winning sphere of a
    nearest-hit scan it is the scan's ``t`` bit for bit."""
    op = p - o
    b = vm.dot(op, d)
    opop = vm.dot(op, op)
    det = b * b - opop + rad * rad
    hit = det >= 0.0
    sq = torch.sqrt(torch.clamp(torch.where(hit, det, 1.0), min=1e-6))
    t1 = b - sq
    t2 = b + sq
    zero = torch.zeros_like(t1)
    t = torch.where(t1 > eps, t1, torch.where(t2 > eps, t2, zero))
    return torch.where(hit, t, zero)


def soft_visibility(scene: Scene, o: Tensor, d: Tensor, maxt: Tensor,
                    tau: float, vacuum: bool = False,
                    exclude_id: Tensor | None = None) -> Tensor:
    """Relaxed visibility ``[N]`` of the shadow segments ``(o, d, maxt)``:
    ``prod_s (1 - blocked_s)`` over the spheres, in ``[0, 1]``.

    Each blocker relaxes two edges: its silhouette, ``sigmoid(det / max(tau
    r, 1e-6))`` with ``det`` the ray's discriminant and the width stopped;
    and the segment's far end, ``sigmoid((maxt - t1) / max(0.25 tau,
    1e-6))`` with ``t1 = b - sqrt(max(det, 1e-6))`` the chord's entry. The
    near end stays hard and stopped (``b > EPSILON``): relaxing it would
    let a vertex's own sphere shadow it. ``vacuum``: emitters never block.
    ``exclude_id [N]``: one sphere left out per segment (the target light
    of a light sample, whose chord starts at the sample point; the host
    sphere of a VPL). Callers use only its linearization, through a
    zero-primal carrier, so images never see its value.
    """
    op = scene.p[None, :, :] - o[:, None, :]                     # [N, S, 3]
    b = vm.dot(op, d[:, None, :])
    opop = vm.dot(op, op)
    det = b * b - opop + (scene.rad * scene.rad)[None, :]
    width = torch.clamp(tau * scene.rad, min=1e-6).detach()[None, :]
    edge = torch.sigmoid(det / width)
    t1 = b - torch.sqrt(torch.clamp(det, min=1e-6))
    endpoint = torch.sigmoid((maxt[:, None] - t1)
                             / max(ENDPOINT_TAU_FRACTION * tau, 1e-6))
    gate = (b > EPSILON).to(o.dtype)
    blocked = edge * endpoint * gate
    if exclude_id is not None:
        spheres = torch.arange(scene.num_spheres, device=o.device)
        blocked = blocked * (spheres[None, :]
                             != exclude_id[:, None]).to(o.dtype)
    if vacuum:
        blocked = blocked * torch.logical_not(
            scene.is_light())[None, :].to(o.dtype)
    return torch.prod(1.0 - blocked, dim=-1)
