"""Where a progressive pass of the PyTorch port spends its time on the card.

    python3 tools/profile_torch_pass.py [--size 512] [--passes 20]

Renders the Cornell box with the port's `Renderer` on the card, warms up,
times ``--passes`` passes with CUDA events, then traces as many again with
``torch.profiler`` (CPU and CUDA activities) and prints one JSON line: the
time per pass without and with the profiler, the device time per pass
summed over kernels, copies and sets, the device's idle share (against the
unprofiled time, since the profiler slows the host), the number of device
operations per pass, and the ten that take the most time. Needs a card;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--passes", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_pass: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import Renderer
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    orig, target, scene = load_scene(
        os.path.join(REPO, "assets", "scenes", "cornell.scn"))
    r = Renderer(scene, orig, target, args.size, args.size)
    r.render(6)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    r.render(args.passes)
    stop.record()
    torch.cuda.synchronize()
    ms_per_pass = start.elapsed_time(stop) / args.passes
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        r.render(args.passes)
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
        "size": args.size, "passes": args.passes,
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
