"""The adjoint kernels of this checkout against another checkout's, on one
card: the same bits, and each side's time.

    python3 tools/ab_grad_kernel.py --other DIR [--size 512] [--reps 20]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``). Each side runs in a process of its
own with its checkout first on ``sys.path``: it builds its kernels from its
own sources, makes its inputs with its own package (cornell.scn at
``--size``², the default ``IntegratorConfig()``, sample 0 of the mix32 key
of seed 0 with its VPLs, a seeded cotangent and a black target) and
launches through its own public wrappers, ``ops.pallas_grad.grad_launch``
and ``fused_launch`` (l2), so no side's argument layout is assumed here.
The sides run in turns: other, this, this, other. Prints one JSON line:
whether every output of each wrapper is the same bits on both sides (their
first runs), and each run's ms per launch (CUDA events). Exits 1 if the
bits differ. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = ("grad_kernel", "fused_kernel")


def _ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def side(root: str, size: int, reps: int, out: str) -> int:
    """One side: the checkout at ``root`` launches both wrappers on its own
    inputs and saves their outputs and times to ``out``."""
    sys.path.insert(0, root)
    import torch

    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    dev = torch.device("cuda", 0)
    orig, target, scene = load_scene(
        os.path.join(root, "assets", "scenes", "cornell.scn"), device=dev)
    cfg = IntegratorConfig()
    n = size * size
    cam = Camera.make(orig, target, size, size, device=dev)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device=dev)
    px, py = cam_mod.pixel_grid(size, size, device=dev)
    rays = cam_mod.primary_rays(cam, size, size, ju[0], ju[1], px, py)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    tabs = ops.launch_tables(scene, cfg, li, key, 0, vpls, 0, n)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    cot = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
    black = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    launch = {
        "grad_kernel": lambda: pg.grad_launch(*tabs, cfg, li, rays, cot),
        "fused_kernel": lambda: pg.fused_launch(*tabs, cfg, li, rays, black,
                                                "l2"),
    }
    outputs = {k: [t.cpu() for t in fn()] for k, fn in launch.items()}
    ms = {k: _ms(torch, fn, reps) for k, fn in launch.items()}
    torch.save({"outputs": outputs, "ms": ms}, out)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--side", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        return side(args.side, args.size, args.reps, args.out)

    import torch

    if not torch.cuda.is_available():
        print("ab_grad_kernel: no CUDA device", file=sys.stderr)
        return 1
    roots = {"this": REPO, "other": os.path.abspath(args.other)}
    runs = {"this": [], "other": []}
    with tempfile.TemporaryDirectory() as tmp:
        for i, name in enumerate(("other", "this", "this", "other")):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--other",
                 args.other, "--side", roots[name], "--size",
                 str(args.size), "--reps", str(args.reps), "--out", out],
                check=True)
            runs[name].append(torch.load(out))
    this, other = runs["this"][0]["outputs"], runs["other"][0]["outputs"]
    result = {"size": [args.size, args.size], "nvidia_smi": subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip()}
    for k in WRAPPERS:
        result[k] = {
            "same_bits": len(this[k]) == len(other[k]) and all(
                torch.equal(a, b) for a, b in zip(this[k], other[k])),
            "ms": {name: [r["ms"][k] for r in runs[name]]
                   for name in ("other", "this")}}
    print(json.dumps(result), flush=True)
    return 0 if all(result[k]["same_bits"] for k in WRAPPERS) else 1


if __name__ == "__main__":
    sys.exit(main())
