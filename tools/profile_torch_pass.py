"""Where a progressive pass or a training step of the PyTorch port spends
its time on the card.

    python3 tools/profile_torch_pass.py [--scene cornell|complex]
        [--size 512] [--height H] [--passes 20] [--train]

Without ``--train``: renders the scene (``assets/scenes/<scene>.scn``)
with the port's `Renderer` on the card. With ``--train``: runs the
training step the JAX package's bench times, `render_loss_grad` (l2, spp
1, ``IntegratorConfig()``, the default backend) against a black target,
on a fresh mix32 key each step: the fused kernel on cornell.scn, the fact
kernel and the re-walk on complex.scn (783 spheres; the JAX bench runs it
at ``--size 512 --height 384``). Either way it
warms up, times ``--passes`` passes or steps with CUDA events, then traces
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


def _train_steps(scene, orig, target, width, height):
    """``run(k)``: k fused training steps of `render_loss_grad`, each on a
    fresh key, against a black target (the JAX bench's step)."""
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

    cfg = IntegratorConfig()
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "complex"),
                    default="cornell")
    ap.add_argument("--size", type=int, default=512, help="width")
    ap.add_argument("--height", type=int, default=None,
                    help="height (default: the width)")
    ap.add_argument("--passes", type=int, default=20)
    ap.add_argument("--train", action="store_true",
                    help="profile the fused training step, not a pass")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pass: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    orig, target, scene = load_scene(
        os.path.join(REPO, "assets", "scenes", f"{args.scene}.scn"))
    height = args.height or args.size
    run = (_train_steps if args.train else _passes)(scene, orig, target,
                                                    args.size, height)
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
        "what": "train_step" if args.train else "render_pass",
        "scene": args.scene, "width": args.size, "height": height,
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
