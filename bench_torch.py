#!/usr/bin/env python
"""Benchmark of the PyTorch + CUDA port: rays/s on cornell.scn (BASELINE.md
metric), on one card.

Port of bench.py: the same legs, in the same order, under the same keys.
On cornell.scn at 512x512 with ``IntegratorConfig()`` (VPLs) on the mix32
tape of seed 0:
- the sustained progressive pass through the kernels (``render_chunk``,
  one ``trace_kernel`` launch a pass);
- the headline training step: ``render_loss_grad`` (l2 against black,
  spp 1), one ``fused_kernel`` launch a step;
- complex.scn (783 spheres) at 512x384: its pass (seven ``bounce_kernel``
  launches) and its step (seven ``aux_kernel`` launches and the re-walk);
- the plain tracer's pass (``backend="xla"``);
- the threefry and rbg tapes' passes through the kernels;
- the plain tracer's training step;
- the work census of one pass (`path_tracer.trace(with_stats=True)`).

Each leg runs a chain of passes or steps (steps on keys from
``rng.fold_in``), once to warm up, then ``REPS`` (3) times between CUDA
events; it reports the median ms per pass or step, and every rep. Each
leg must launch exactly its kernels, and no other: a leg that fails, or
takes another route, stops the run with a non-zero exit, and no key is
filled from another backend.

    python3 bench_torch.py [--device cpu] [--width W --height H]

Prints one JSON line: bench.py's keys, the card's name and power limit
(``nvidia-smi``), and ``fp32_util_lower_bound_pct_fwd``, the sphere tests'
FP32 operations of a pass over the kernels' pass time, against the card's
FP32 peak (SMs x 128 FP32 lanes x 2 x ``clocks.max.sm``). It imports no
JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# Chain lengths (bench.py's long trip counts): Cornell passes, headline
# steps, complex.scn passes and steps, the plain tracer's passes and steps;
# the units of the warm-up run and the timed runs of each leg.
PASSES, STEPS = 200, 66
COMPLEX_PASSES, COMPLEX_STEPS = 12, 8
XLA_PASSES, XLA_STEPS = 40, 16
WARMUP, REPS = 2, 3
# complex.scn's frame (bench.py's complex leg).
COMPLEX_W, COMPLEX_H = 512, 384
# FP32 operations of one ray-sphere test (bench.py's model): only the
# quadratic is counted, so the utilization is a lower bound.
FLOPS_PER_SPHERE_TEST = 26.0
FP32_LANES_PER_SM = 128


class LegFailure(RuntimeError):
    pass


def _median(xs: list[float]) -> float:
    xs = sorted(xs)
    m = len(xs) // 2
    return xs[m] if len(xs) % 2 else 0.5 * (xs[m - 1] + xs[m])


def _smi(query: str) -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", f"--query-gpu={query}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() if out.returncode == 0 else None


def fp32_peak_flops(device: torch.device) -> tuple[float | None, dict]:
    """The card's FP32 peak outside the tensor cores: SMs x 128 lanes x 2
    (a fused multiply-add) x ``clocks.max.sm``; None off the card."""
    if device.type != "cuda":
        return None, {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock = _smi("clocks.max.sm")
    if clock is None:
        return None, {"sm_count": sms}
    mhz = float(clock.split()[0])
    return (sms * FP32_LANES_PER_SM * 2 * mhz * 1e6,
            {"sm_count": sms, "clocks_max_sm_mhz": mhz})


class Bench:
    """The legs' shared state: device, repetitions, launch gate."""

    def __init__(self, device: torch.device, reps: int):
        self.device = device
        self.reps = reps
        self.reps_ms: dict[str, list[float]] = {}
        self.launches: dict[str, dict] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def time(self, leg: str, chain, n: int, expect: dict) -> float:
        """Median seconds per unit of ``chain(n)``, which runs ``n``
        chained units (passes or steps), over ``reps`` runs after a
        warm-up run of ``WARMUP`` units. On the card each run is timed
        with CUDA events, and the launches of every run must be ``n``
        times ``expect`` (kernel -> launches a unit) and nothing else."""
        from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace

        chain(WARMUP)
        self._sync()
        per_unit = []
        for _ in range(self.reps):
            pallas_trace.reset_launches()
            if self.device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                chain(n)
                stop.record()
                self._sync()
                per_unit.append(start.elapsed_time(stop) / 1e3 / n)
            else:
                t0 = time.perf_counter()
                chain(n)
                per_unit.append((time.perf_counter() - t0) / n)
            got = {k: v for k, v in pallas_trace.LAUNCHES.items() if v}
            want = ({k: v * n for k, v in expect.items()}
                    if self.device.type == "cuda" else {})
            if got != want:
                raise LegFailure(f"leg {leg}: launched {got}, expected "
                                 f"{want}")
        self.reps_ms[leg] = [1e3 * t for t in per_unit]
        self.launches[leg] = got     # of the last run
        return _median(per_unit)


def census(scene, cam, cfg, width: int, height: int, light_idx, key
           ) -> dict:
    """bench.py's work census of one pass: the plain tracer's
    ``with_stats`` counts of sample 0 (alive lanes only), the shadow rays
    they imply (each diffuse vertex casts one per light and, with VPLs,
    one per slot of the gather window), and the sphere tests of all
    segments."""
    from gpu_bidirectional_raytracer_tpu_torch.integrators import (
        path_tracer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        frame_rays,
    )

    rays = frame_rays(cam, cfg, width, height, key, 0)
    _, stats = path_tracer.trace(scene, cfg, light_idx, rays, key, 0,
                                 with_stats=True)
    n_ext = int(stats["extension_segments"])
    n_dv = int(stats["diffuse_vertices"])
    window = cfg.vpl_depth * cfg.max_vlp if cfg.use_vpl else 0
    shadow = n_dv * (max(len(light_idx), 1) + window)
    segments = n_ext + shadow
    tests = segments * scene.num_spheres
    return {"extension_segments": n_ext, "diffuse_vertices": n_dv,
            "shadow_rays": shadow, "segments_per_pass": segments,
            "sphere_tests_per_pass": tests,
            "model_flops_per_pass": tests * FLOPS_PER_SPHERE_TEST}


def run(device: torch.device, width: int, height: int) -> dict:
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        init_state,
        render_chunk,
    )
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        load_scene,
    )

    bench = Bench(device, REPS)
    complex_width, complex_height = COMPLEX_W, COMPLEX_H
    scenes = os.path.join(REPO, "assets", "scenes")
    cfg = IntegratorConfig()
    key = rng.make_key(0)
    build_s = None
    if device.type == "cuda":
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        t0 = time.perf_counter()
        _build.build_all()
        build_s = time.perf_counter() - t0

    def rig(name, w, h):
        orig, target, scene = load_scene(os.path.join(scenes, name),
                                         device=device)
        cam = Camera.make(orig, target, w, h, cfg.fov_deg, device=device)
        return scene, cam, static_light_indices(scene)

    def passes(scene, cam, w, h, li, backend, rng_impl=None):
        state = [init_state(w, h, cfg, 0, device, rng_impl)]

        def chain(n):
            state[0] = render_chunk(scene, cam, state[0], n, cfg, w, h, li,
                                    None, backend)
            return state[0].colors
        return chain

    salt = [0]

    def steps(scene, cam, w, h, li, backend):
        tgt = torch.zeros((h, w, 3), dtype=torch.float32, device=device)

        def chain(n):
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for _ in range(n):
                salt[0] += 1
                loss, g = G.render_loss_grad(scene, cam,
                                             rng.fold_in(key, salt[0]), tgt,
                                             cfg, w, h, li, 1, "l2", backend)
                acc = acc + loss + g.p.sum()
            return acc
        return chain

    n_rays = width * height
    scene, cam, li = rig("cornell.scn", width, height)
    t_fwd_pl = bench.time("fwd_pallas", passes(scene, cam, width, height, li,
                                               "pallas"), PASSES,
                          {"trace_kernel": 1})
    t_fb = bench.time("fwd_bwd_pallas", steps(scene, cam, width, height, li,
                                              "pallas"), STEPS,
                      {"fused_kernel": 1})

    cscene, ccam, cli = rig("complex.scn", complex_width, complex_height)
    t_cfwd = bench.time("complex_fwd", passes(
        cscene, ccam, complex_width, complex_height, cli, "pallas"),
        COMPLEX_PASSES, {"bounce_kernel": cfg.max_depth})
    t_cfb = bench.time("complex_fwd_bwd", steps(
        cscene, ccam, complex_width, complex_height, cli, "pallas"),
        COMPLEX_STEPS, {"aux_kernel": cfg.max_depth})

    t_xla = bench.time("sustained_xla", passes(scene, cam, width, height, li,
                                               "xla"), XLA_PASSES, {})
    rng_extra = {}
    for impl, label in (("threefry", "threefry"), ("rbg", "fast_rng")):
        t_i = bench.time(f"sustained_{label}", passes(
            scene, cam, width, height, li, "pallas", impl), PASSES,
            {"trace_kernel": 1})
        rng_extra[f"pass_ms_sustained_{label}"] = 1e3 * t_i
        rng_extra[f"rays_per_sec_sustained_{label}"] = n_rays / t_i
    t_fb_xla = bench.time("fwd_bwd_xla", steps(scene, cam, width, height, li,
                                               "xla"), XLA_STEPS, {})
    work = census(scene, cam, cfg, width, height, li, key)

    peak, peak_info = fp32_peak_flops(device)
    is_card = device.type == "cuda"
    return {
        "metric": "rays_per_sec_per_chip_fwd_bwd_cornell",
        "value": n_rays / t_fb,
        "unit": "rays/s",
        "vs_baseline": 1.0,
        "extra": {
            "bwd_backend": "pallas",
            "fwd_bwd_fused": is_card,
            "estimator": "bidirectional_vpl",
            "rays_per_sec_fwd": n_rays / t_xla,
            "rays_per_sec_fwd_pallas": n_rays / t_fwd_pl,
            "pass_ms_fwd": 1e3 * t_xla,
            "pass_ms_fwd_pallas": 1e3 * t_fwd_pl,
            "rays_per_sec_sustained": n_rays / t_fwd_pl,
            "pass_ms_sustained": 1e3 * t_fwd_pl,
            "pass_ms_sustained_xla": 1e3 * t_xla,
            "rng_impl_default": "mix32",
            **rng_extra,
            "pass_ms_fwd_bwd_sustained": 1e3 * t_fb,
            "rays_per_sec_fwd_bwd_sustained": n_rays / t_fb,
            "pass_ms_fwd_bwd_xla": 1e3 * t_fb_xla,
            "segments_per_pass": work["segments_per_pass"],
            "extension_segments": work["extension_segments"],
            "shadow_rays": work["shadow_rays"],
            "segments_per_sec_fwd": work["segments_per_pass"] / t_fwd_pl,
            "segments_per_sec_fwd_bwd": work["segments_per_pass"] / t_fb,
            "sphere_tests_per_pass": work["sphere_tests_per_pass"],
            "model_gflops_per_pass": work["model_flops_per_pass"] / 1e9,
            "fp32_util_lower_bound_pct_fwd": (
                100.0 * work["model_flops_per_pass"] / t_fwd_pl / peak
                if peak else None),
            "fp32_peak_flops": peak,
            **peak_info,
            "resolution": f"{width}x{height}",
            "device": (torch.cuda.get_device_name(device) if is_card
                       else "cpu"),
            "platform": "gpu" if is_card else "cpu",
            "card": _smi("name,power.limit") if is_card else None,
            "complex_ms_fwd": 1e3 * t_cfwd,
            "complex_ms_fwd_bwd": 1e3 * t_cfb,
            "complex_bwd_backend": "pallas_hybrid",
            "complex_resolution": f"{complex_width}x{complex_height}",
            "build_s": build_s,
            "reps": REPS,
            "reps_ms": bench.reps_ms,
            "launches": bench.launches,
        },
    }


def main(argv: list[str] | None = None) -> int:
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        resolve_device,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    try:
        out = run(device, args.width, args.height)
    except LegFailure as err:
        print(f"bench_torch: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
