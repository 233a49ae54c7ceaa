"""Rank functions of tests/test_torch_parallel.py.

They run in processes that `parallel._local_ranks.spawn_ranks` starts, so
this module imports only torch and the port (a spawned rank imports it by
name). `sharded_cases` runs every sharded function of `parallel.mesh` on
its rank and returns what the tests compare; `one_rank_cases` and
`one_rank_render` compute the same on one process through the
one-process functions (the monolithic traces, the full light pass,
`render_loss_grad`, the banded renderer), which is what the ranks must
reproduce.

The inputs (`Spec`) are numpy arrays and the port's configs, made by the
test from numpy seeds and shared with the JAX side.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gpu_bidirectional_raytracer_tpu_torch import convert, rng
from gpu_bidirectional_raytracer_tpu_torch.core.types import (
    Camera,
    IntegratorConfig,
)
from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
    static_light_indices,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_bounce import (
    trace_pallas_bounce,
)
from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import (
    trace_pallas,
)
from gpu_bidirectional_raytracer_tpu_torch.parallel import mesh as pmesh
from gpu_bidirectional_raytracer_tpu_torch.parallel._local_ranks import (
    step_grads,
)
from gpu_bidirectional_raytracer_tpu_torch.render import progressive

W, H = 16, 16
RENDER_PASSES = 4          # across the VPL refresh at sample 2
SPLAT_W, SPLAT_H = 24, 16


@dataclasses.dataclass(frozen=True)
class Case:
    """One sharded call: its scene (a key of `Spec.scenes`), config and
    key words with their tape."""

    scene: str
    cfg: IntegratorConfig
    key: tuple[int, ...]
    impl: str = "mix32"
    seed: int = 0          # the renderer's seed (render cases)
    passes: int = RENDER_PASSES
    loss: str = "l2"

    def port_key(self) -> rng.Key:
        return rng.make_typed_key(self.key, self.impl)


@dataclasses.dataclass(frozen=True)
class Spec:
    """The inputs of every case: scenes as ``(rad, p, e, c, refl)`` numpy
    arrays, the camera's origin and target, one VPL floating in the box
    (``(hp, rad, nl, valid, sid)``), the training target, and the cases
    by function."""

    scenes: dict
    orig: np.ndarray
    target: np.ndarray
    vpl: tuple
    step_target: dict
    trace: dict
    bounce: dict
    render: dict
    splat: Case
    step: dict


def _inputs(spec: Spec, case: Case, dev, w=W, h=H):
    scene = convert.scene_from_numpy(*spec.scenes[case.scene], device=dev)
    cam = Camera.make(spec.orig, spec.target, w, h, case.cfg.fov_deg,
                      device=dev)
    return scene, cam, static_light_indices(scene)


def _vpl(spec: Spec, cfg: IntegratorConfig, dev):
    return (convert.vpls_from_numpy(*spec.vpl, device=dev) if cfg.use_vpl
            else None)


def sharded_cases(mesh: pmesh.Mesh, spec: Spec) -> dict:
    """Every sharded function on this rank: the trace and bounce traces
    and the render passes gathered (`gather_rows`), this rank's light
    subpath window, the splat films and the training steps as every
    rank holds them, and the seconds of each."""
    dev = mesh.device
    out, seconds = {}, {}
    t = time.perf_counter()
    for table, fn in (("trace", pmesh.trace_pallas_sharded),
                      ("bounce", pmesh.trace_pallas_bounce_sharded)):
        for name, case in getattr(spec, table).items():
            scene, cam, li = _inputs(spec, case, dev)
            key = case.port_key()
            rays = progressive.frame_rays(cam, case.cfg, W, H, key, 0)
            shard = fn(scene, case.cfg, li, rays, key, 0, mesh,
                       vpls=_vpl(spec, case.cfg, dev), vlp_index=0)
            out[f"{table}/{name}"] = pmesh.gather_rows(shard, mesh)
    seconds["trace"] = time.perf_counter() - t

    t = time.perf_counter()
    for name, case in spec.render.items():
        scene, cam, li = _inputs(spec, case, dev)
        state = progressive.init_state(W, H, case.cfg, case.seed, dev)
        shard = pmesh.shard_state(state, mesh)
        frames = []
        for _ in range(case.passes):
            shard = pmesh.render_pass_sharded(scene, cam, shard, case.cfg,
                                              W, H, li, mesh)
            frames.append((pmesh.gather_rows(shard.colors, mesh),
                           pmesh.gather_rows(shard.counter, mesh),
                           shard.sample, shard.vlp_index))
        out[f"render/{name}"] = frames
    seconds["render"] = time.perf_counter() - t

    t = time.perf_counter()
    case = spec.splat
    scene, cam, li = _inputs(spec, case, dev, SPLAT_W, SPLAT_H)
    n = case.cfg.light_points
    off, cnt = mesh.rank * n // mesh.size, n // mesh.size
    win = light_tracer.trace_light_paths(scene, case.cfg, li,
                                         case.port_key(), 0, lane_offset=off,
                                         lane_count=cnt, lane_total=n)
    out["light_window"] = {f: getattr(win, f) for f in
                           ("hp", "rad", "nl", "valid", "sid")}
    out["splat"] = pmesh.light_splat_sharded(
        scene, cam, case.cfg, li, case.port_key(), 0, SPLAT_W, SPLAT_H, mesh)
    seconds["splat"] = time.perf_counter() - t

    for name, case in spec.step.items():
        t = time.perf_counter()
        scene, cam, li = _inputs(spec, case, dev)
        target = torch.tensor(spec.step_target[name], device=dev)
        out[f"step/{name}"] = step_grads(*pmesh.render_loss_grad_sharded(
            scene, cam, case.port_key(), target, case.cfg, W, H, li, 1,
            mesh, loss=case.loss, backend="pallas"))
        seconds[f"step/{name}"] = time.perf_counter() - t
    out["seconds"] = seconds
    return out


def one_rank_cases(spec: Spec, dev="cpu") -> dict:
    """`sharded_cases`' results but the renders, from the one-process
    functions: the monolithic traces, the full light pass and its splat,
    and `render_loss_grad` (whose l2 step at one sample on at most 64
    spheres is the fused one)."""
    out = {}
    for table, fn in (("trace", trace_pallas),
                      ("bounce", trace_pallas_bounce)):
        for name, case in getattr(spec, table).items():
            scene, cam, li = _inputs(spec, case, dev)
            key = case.port_key()
            rays = progressive.frame_rays(cam, case.cfg, W, H, key, 0)
            out[f"{table}/{name}"] = fn(scene, case.cfg, li, rays, key, 0,
                                        vpls=_vpl(spec, case.cfg, dev),
                                        vlp_index=0)
    case = spec.splat
    scene, cam, li = _inputs(spec, case, dev, SPLAT_W, SPLAT_H)
    full = light_tracer.trace_light_paths(scene, case.cfg, li,
                                          case.port_key(), 0)
    out["light_full"] = full
    out["splat"] = light_tracer.splat_to_film(scene, cam, case.cfg, full,
                                              SPLAT_W, SPLAT_H, li)
    for name, case in spec.step.items():
        scene, cam, li = _inputs(spec, case, dev)
        target = torch.tensor(spec.step_target[name], device=dev)
        out[f"step/{name}"] = step_grads(*G.render_loss_grad(
            scene, cam, case.port_key(), target, case.cfg, W, H, li, 1,
            loss=case.loss, backend="pallas"))
    return out


def one_rank_render(spec: Spec, name: str, tile_rows: int | None,
                    dev="cpu") -> list:
    """The frames of ``Renderer(backend="pallas", tile_rows=tile_rows)``
    over the passes of render case ``name`` (untiled: the eye-path
    kernel's camera mode, or its plain version on the CPU)."""
    case = spec.render[name]
    scene, _, _ = _inputs(spec, case, dev)
    r = progressive.Renderer(scene, spec.orig, spec.target, W, H,
                             cfg=case.cfg, seed=case.seed, device=dev,
                             backend="pallas", tile_rows=tile_rows)
    frames = []
    for _ in range(case.passes):
        s = r.step()
        frames.append((s.colors, s.counter, s.sample, s.vlp_index))
    return frames


def failing_rank(mesh: pmesh.Mesh, rank_that_fails: int) -> int:
    """Raises on one rank; the others wait in a collective."""
    if mesh.rank == rank_that_fails:
        raise ValueError(f"rank {mesh.rank} fails on purpose")
    t = torch.ones(1)
    torch.distributed.all_reduce(t)
    return mesh.rank


def hanging_rank(mesh: pmesh.Mesh, seconds: float) -> int:
    """Sleeps past any timeout the test gives."""
    time.sleep(seconds)
    return mesh.rank
