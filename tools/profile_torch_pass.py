"""Where a progressive pass or a training step of the PyTorch port spends
its time on the card.

    python3 tools/profile_torch_pass.py [--scene cornell|complex]
        [--size 512] [--height H] [--passes 20] [--train [--vis-tau T]
        [--sil-tau T] | --scan [--compact]]

Without ``--train`` or ``--scan``: renders the scene
(``assets/scenes/<scene>.scn``) with the port's `Renderer` on the card.
With ``--train``: runs the training step the JAX package's bench times,
`render_loss_grad` (l2, spp 1, ``IntegratorConfig()``, the default
backend) against a black target, on a fresh mix32 key each step: the
fused kernel on cornell.scn, the fact kernel and the re-walk on
complex.scn (783 spheres; the JAX bench runs it at ``--size 512 --height
384``); ``--vis-tau`` and ``--sil-tau`` turn the gradient carriers on
(a silhouette carrier takes the unfused route). With ``--scan``: traces
samples through the per-bounce scan route,
`path_tracer.trace(scan_backend="pallas")`, as tools/bench_complex.py
does (sample ``s``: jittered camera rays and the light subpaths of that
sample, mix32 key 0), with ``--compact`` its lane compaction. Either way it
warms up, times ``--passes`` passes, steps or samples with CUDA events, then traces
as many again with ``torch.profiler`` (CPU and CUDA activities) and prints
one JSON line: the time per pass without and with the profiler, the
device time per pass summed over kernels, copies and sets, the device's
idle share (against the unprofiled time, since the profiler slows the
host), the number of device operations per pass, and the ten that take
the most time. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _passes(scene, orig, target, width, height):
    """``run(k)``: k progressive passes of the `Renderer`."""
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import Renderer

    r = Renderer(scene, orig, target, width, height)
    return r.render


def _train_steps(scene, orig, target, width, height, vis_tau=0.0,
                 sil_tau=0.0):
    """``run(k)``: k training steps of `render_loss_grad`, each on a fresh
    key, against a black target (the JAX bench's step), with the carriers'
    taus."""
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff.gradients import (
        render_loss_grad,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )

    cfg = IntegratorConfig(vis_grad_tau=vis_tau, sil_grad_tau=sil_tau)
    cam = Camera.make(orig, target, width, height)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    black = torch.zeros((height, width, 3), device=scene.device)
    count = [0]

    def run(k):
        for _ in range(k):
            count[0] += 1
            render_loss_grad(scene, cam, rng.fold_in(key, count[0]), black,
                             cfg, width, height, li, spp=1, loss="l2")
    return run


def _scan_samples(scene, orig, target, width, height, compact=False):
    """``run(k)``: k samples of the scan route, as tools/bench_complex.py
    runs it."""
    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators import (
        light_tracer,
        path_tracer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )

    cfg = IntegratorConfig()
    cam = Camera.make(orig, target, width, height)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    n = width * height
    px, py = cam_mod.pixel_grid(width, height, device=scene.device)
    count = [0]

    def run(k):
        for _ in range(k):
            s = count[0]
            count[0] += 1
            u = rng.site_uniforms(key, s, 0, rng.CAM_JITTER, 2, n,
                                  device=scene.device)
            rays = cam_mod.primary_rays(cam, width, height, u[0], u[1], px,
                                        py)
            vpls = light_tracer.trace_light_paths(scene, cfg, li, key, s)
            path_tracer.trace(scene, cfg, li, rays, key, s, vpls=vpls,
                              vlp_index=0, scan_backend="pallas",
                              scan_compact=compact)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "complex"),
                    default="cornell")
    ap.add_argument("--size", type=int, default=512, help="width")
    ap.add_argument("--height", type=int, default=None,
                    help="height (default: the width)")
    ap.add_argument("--passes", type=int, default=20)
    what = ap.add_mutually_exclusive_group()
    what.add_argument("--train", action="store_true",
                      help="profile the training step, not a pass")
    what.add_argument("--scan", action="store_true",
                      help="profile samples of the per-bounce scan route")
    ap.add_argument("--compact", action="store_true",
                    help="with --scan: compact the live lanes each depth")
    ap.add_argument("--vis-tau", type=float, default=0.0,
                    help="with --train: vis_grad_tau")
    ap.add_argument("--sil-tau", type=float, default=0.0,
                    help="with --train: sil_grad_tau")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pass: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    orig, target, scene = load_scene(
        os.path.join(REPO, "assets", "scenes", f"{args.scene}.scn"))
    height = args.height or args.size
    if args.scan:
        run = _scan_samples(scene, orig, target, args.size, height,
                            args.compact)
    elif args.train:
        run = _train_steps(scene, orig, target, args.size, height,
                           args.vis_tau, args.sil_tau)
    else:
        run = _passes(scene, orig, target, args.size, height)
    run(6)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run(args.passes)
    stop.record()
    torch.cuda.synchronize()
    ms_per_pass = start.elapsed_time(stop) / args.passes
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        run(args.passes)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    # Device-side records only (kernels, copies, sets): a host operator's
    # own entry also carries the time of the kernels it launched.
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    device_ops = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:10]
    wall_ms = wall / args.passes * 1e3
    device_ms = device_us / args.passes / 1e3
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "what": ("train_step" if args.train else
                 ("scan_sample_compact" if args.compact else "scan_sample")
                 if args.scan else "render_pass"),
        "scene": args.scene, "width": args.size, "height": height,
        "vis_grad_tau": args.vis_tau, "sil_grad_tau": args.sil_tau,
        "passes": args.passes,
        "ms_per_pass": ms_per_pass,
        "profiled_wall_ms_per_pass": wall_ms,
        "device_ms_per_pass": device_ms if events else "not measured",
        "device_idle_share": (1.0 - device_ms / ms_per_pass) if events
        else "not measured",
        "device_ops_per_pass": device_ops / args.passes,
        "top": [{"name": e.key[:80],
                 "ms_per_pass": e.self_device_time_total / args.passes / 1e3,
                 "calls_per_pass": e.count / args.passes} for e in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
