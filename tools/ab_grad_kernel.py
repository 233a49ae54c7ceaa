"""The adjoint kernels of this checkout against another checkout's, on one
card: radiance and loss the same bits, gradients within the gates of
``chip_smoke.py``'s ``grad_vs_plain``, and each side's time.

    python3 tools/ab_grad_kernel.py --other DIR [--size 512] [--reps 20]

``DIR`` holds another checkout of the repository (for example the parent
commit, unpacked with ``git archive``). Each side runs in a process of its
own with its checkout first on ``sys.path``: it builds its kernels from its
own sources, makes its inputs with its own package and launches through
its own public wrappers, ``ops.pallas_grad.grad_launch`` and
``fused_launch`` (l2, with its radiance out), so no side's argument layout
is assumed here. Cases, each at ``--size``², ``IntegratorConfig()``,
sample 0 of the mix32 key of seed 0 with its VPLs, a seeded cotangent and
a black target:

- ``cornell``: cornell.scn, the carrier-off instantiations
  (``grad_kernel``, ``fused_kernel``);
- ``occluder_vis``: tests/test_pallas_grad.py's occluder scene (simple.scn
  plus a sphere of radius 6 at (0, 40, 0)) with ``vis_grad_tau`` 2, where
  the carrier fires: ``grad_kernel_vis``, ``fused_kernel_vis``;
- ``cornell_vis``: cornell.scn with ``vis_grad_tau`` 2, where the carrier
  is 0 (the walls hold every segment) but its blockers are evaluated, as
  in ``chip_smoke.py``'s ``vis_ms``.

The sides run in turns: other, this, this, other. Prints one JSON line:
per case and wrapper, whether each output is the same bits on both sides
(``same_bits``, their first runs), the gates of each gradient array
against the other side's (within ``2e-3 |other| + 2e-3 max|other|`` and a
``_max_rel`` of at most 1e-3), and each run's ms per launch (CUDA events)
with the ratio other / this of their means. Exits 1 unless the fused
kernel's radiance and loss are the same bits on both sides and every
gradient is within the gates. Needs a card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = ("cornell", "occluder_vis", "cornell_vis")
WRAPPERS = ("grad_kernel", "fused_kernel")
GRAD_RTOL, GRAD_ATOL_REL, GRAD_MAX_REL = 2e-3, 2e-3, 1e-3
# Outputs of each wrapper: grad_launch's, then fused_launch's with the
# radiance it writes.
OUTPUTS = {"grad_kernel": ("dscene", "dvpl", "drays_o", "drays_d"),
           "fused_kernel": ("loss", "dscene", "dvpl", "radiance")}
SAME_BITS_REQUIRED = ("loss", "radiance")


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
    inputs for every case and saves their outputs and times to ``out``."""
    sys.path.insert(0, root)
    import dataclasses

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
    scenes = os.path.join(root, "assets", "scenes")
    n = size * size
    key = rng.make_key(0)
    outputs, ms = {}, {}
    for case in CASES:
        name = "simple" if case.startswith("occluder") else "cornell"
        orig, target, scene = load_scene(
            os.path.join(scenes, f"{name}.scn"), device=dev)
        if name == "simple":   # tests/test_pallas_grad.py's occluder
            def cat(a, row):
                return torch.cat([a, torch.tensor([row], dtype=a.dtype,
                                                  device=dev)])

            scene = scene.replace(
                rad=cat(scene.rad, 6.0), p=cat(scene.p, [0.0, 40.0, 0.0]),
                e=cat(scene.e, [0.0, 0.0, 0.0]),
                c=cat(scene.c, [0.5, 0.5, 0.5]), refl=cat(scene.refl, 0))
        cfg = IntegratorConfig()
        if case.endswith("_vis"):
            cfg = dataclasses.replace(cfg, vis_grad_tau=2.0)
        cam = Camera.make(orig, target, size, size, device=dev)
        li = static_light_indices(scene)
        ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device=dev)
        px, py = cam_mod.pixel_grid(size, size, device=dev)
        rays = cam_mod.primary_rays(cam, size, size, ju[0], ju[1], px, py)
        vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
        tabs = ops.launch_tables(scene, cfg, li, key, 0, vpls, 0, n)
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        cot = torch.rand((n, 3), generator=gen, device=dev) * 2.0 - 1.0
        black = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        rad = torch.empty((n, 3), dtype=torch.float32, device=dev)

        def fused(tabs=tabs, cfg=cfg, li=li, rays=rays, black=black,
                  rad=rad):
            return pg.fused_launch(*tabs, cfg, li, rays, black, "l2",
                                   radiance_out=rad) + (rad,)

        launch = {
            "grad_kernel": lambda tabs=tabs, cfg=cfg, li=li, rays=rays,
            cot=cot: pg.grad_launch(*tabs, cfg, li, rays, cot),
            "fused_kernel": fused,
        }
        for k, fn in launch.items():
            outputs[f"{case}/{k}"] = [t.cpu().clone() for t in fn()]
            ms[f"{case}/{k}"] = _ms(torch, fn, reps)
    torch.save({"outputs": outputs, "ms": ms}, out)
    return 0


def _gate(torch, got, ref) -> dict:
    """``chip_smoke.grad_check`` of ``got`` against ``ref``."""
    got, ref = got.double(), ref.double()
    err = (got - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    big = ref.abs() > 1e-3 * max(scale, 1e-9)
    rel = (err / ref.abs().clamp(min=1e-6))[big]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= GRAD_RTOL * ref.abs() + GRAD_ATOL_REL * scale).all()) and (
        max_rel <= GRAD_MAX_REL)
    return {"ok": ok, "max_rel": max_rel}


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
    ok = True
    for case in CASES:
        for k in WRAPPERS:
            key = f"{case}/{k}"
            same, gates = {}, {}
            for name, a, b in zip(OUTPUTS[k], this[key], other[key]):
                same[name] = torch.equal(a, b)
                if name in SAME_BITS_REQUIRED:
                    ok = ok and same[name]
                else:
                    gates[name] = _gate(torch, a, b)
                    ok = ok and gates[name]["ok"]
            ms = {name: [r["ms"][key] for r in runs[name]]
                  for name in ("other", "this")}
            result[key] = {
                "same_bits": same, "gates": gates, "ms": ms,
                "ratio": (sum(ms["other"]) / sum(ms["this"]))}
    result["ok"] = ok
    print(json.dumps(result), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
