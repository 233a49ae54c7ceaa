"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main forward path — the progressive Cornell render at
512x512 through the hand-written CUDA eye-path kernel — and holds the
kernel against its plain PyTorch version. It prints one line per phase,
each with the seconds since the start:

1. ``device``: the card, and ``nvidia-smi``'s name and power limit;
2. ``build``: nvcc builds every kernel into ``build/kernels/``; stale
   ``lock`` files there are removed;
3. ``kernel_vs_plain``: at 64x48 on cornell.scn, camera and ray mode,
   samples 0 and 1, with the default config (VPLs on) and with the CPU
   golden gains and stratified jitter: kernel and plain version on the same
   inputs,
   under the radiance protocol (a pixel is bad if any channel differs by
   more than 2e-3 + 2e-3*|ref|; at most 3.5% bad pixels);
4. ``main_path``: ``Renderer(cornell.scn, 512x512, IntegratorConfig(),
   seed=0, device="cuda")`` for 32 passes with the launch counts set to 0
   just before and read just after (one launch per pass); image checks
   (finite, mean > 0, left wall red, right wall blue); the same 32 passes
   through the plain version on the card under the protocol; ms per pass
   with CUDA events after a warm-up; the PPM written to a temporary
   directory;
5. ``kernels``: one JSON line per the port's kernels, with launches on the
   main path, ms per launch, the plain version's ms, and the bound.

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before it. Without a card, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

T0 = time.perf_counter()

# Radiance protocol of the JAX suite (tests/test_pallas.py).
ATOL, RTOL, MAX_BAD_FRAC = 2e-3, 2e-3, 0.035
SMOKE_W, SMOKE_H = 64, 48
MAIN_W, MAIN_H, MAIN_PASSES = 512, 512, 32
SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                     "scenes", "cornell.scn")

# H100 SXM peaks (NVIDIA data sheet, 700 W): FP32 outside the tensor cores
# and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 operations counted per unit of the kernel's work (see PERF.md):
# one ray-sphere root (op 3, b 5, |op|^2 5, det 4, sqrt 1, two roots 2);
# hit shading of a segment (hit point 6, normal 14, dp 5, facing 3);
# one shadow sample's set-up (sample point or VPL, segment, cosines);
# the scatter at a diffuse vertex (basis, cosine lobe). The scatter at a
# mirror or glass vertex and the tape's integer hashing are not counted.
OPS_ROOT = 20
OPS_SEGMENT = 28
OPS_SHADOW_SETUP = 30
OPS_SCATTER = 45


class SmokeFailure(RuntimeError):
    pass


def phase(label: str, /, **fields) -> None:
    fields = {"phase": label, "t_s": round(time.perf_counter() - T0, 3),
              **fields}
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def protocol(got, ref) -> dict:
    """Bad-pixel fraction and max error of radiance ``[..., 3]``."""
    got, ref = got.reshape(-1, 3), ref.reshape(-1, 3)
    err = (got - ref).abs()
    bad = (err > ATOL + RTOL * ref.abs()).any(dim=-1)
    return {"bad_frac": float(bad.float().mean()),
            "max_abs_err": float(err.max()),
            "exact_frac": float((got == ref).all(dim=-1).float().mean()),
            "finite": bool(torch.isfinite(got).all())}


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` runs, timed with CUDA events."""
    for _ in range(warmup):
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


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_build() -> None:
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    removed = []
    if _build.BUILD_DIR.is_dir():
        for lock in _build.BUILD_DIR.rglob("lock"):
            lock.unlink()
            removed.append(str(lock))
    t = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    phase("build", seconds=round(time.perf_counter() - t, 3),
          nvcc_seconds={k: round(v, 3)
                        for k, v in _build.build_seconds.items()},
          libraries=[p.name for p in libs.values()], stale_locks=removed,
          ptxas=ptxas)


def _cornell(device="cuda"):
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    return load_scene(SCENE, device=device)


def phase_kernel_vs_plain(device) -> float:
    """Kernel against plain at 64x48, camera and ray mode; max |err|.

    Two configs: the default (VPLs, gains 1, (direct + vpl) / 2), and the
    CPU-golden gains (10, no VPLs) with 3x3 stratified jitter, so every
    parameter the kernel takes is exercised."""
    import dataclasses

    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    orig, target, scene = _cornell(device)
    w, h, n = SMOKE_W, SMOKE_H, SMOKE_W * SMOKE_H
    cam = Camera.make(orig, target, w, h, device=device)
    li = static_light_indices(scene)
    px, py = cam_mod.pixel_grid(w, h, device=device)
    configs = {
        "default": IntegratorConfig(),
        "golden_stratified": dataclasses.replace(
            IntegratorConfig.cpu_golden(), stratify=3),
    }
    results, worst = {}, 0.0
    for cname, cfg in configs.items():
        state = progressive.init_state(w, h, cfg, seed=0, device=device)
        for sample in (0, 1):
            state = state.replace(sample=sample)
            vpls, vi = progressive.vpl_update(scene, state, cfg, li)
            state = state.replace(vpls=vpls, vlp_index=vi)
            vpls = vpls if cfg.use_vpl else None
            got = ops.trace_pallas_camera(scene, cfg, li, cam, w, h,
                                          state.key, sample, vpls=vpls,
                                          vlp_index=vi)
            ref = ops.trace_camera_plain(scene, cfg, li, cam, w, h,
                                         state.key, sample, vpls=vpls,
                                         vlp_index=vi)
            torch.cuda.synchronize()
            results[f"{cname}_camera_s{sample}"] = protocol(got, ref)
            ju = rng.site_uniforms(state.key, sample, 0, rng.CAM_JITTER, 2,
                                   n, device=device)
            rays = cam_mod.primary_rays(cam, w, h, ju[0], ju[1], px, py)
            got = ops.trace_pallas(scene, cfg, li, rays, state.key, sample,
                                   vpls=vpls, vlp_index=vi)
            ref = path_tracer.trace(scene, cfg, li, rays, state.key, sample,
                                    vpls=vpls, vlp_index=vi)
            torch.cuda.synchronize()
            results[f"{cname}_ray_s{sample}"] = protocol(got, ref)
    phase("kernel_vs_plain", width=w, height=h, results=results)
    for name, r in results.items():
        check(r["finite"], f"kernel_vs_plain {name}: non-finite radiance")
        check(r["bad_frac"] <= MAX_BAD_FRAC,
              f"kernel_vs_plain {name}: {r['bad_frac']:.3%} bad pixels")
        worst = max(worst, r["max_abs_err"])
    return worst


def phase_main_path() -> dict:
    from gpu_bidirectional_raytracer_tpu_torch.core.types import IntegratorConfig
    from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import film, progressive

    # The entry points as a user calls them: the default device is the card.
    orig, target, scene = _cornell()
    cfg = IntegratorConfig()
    w, h = MAIN_W, MAIN_H
    renderer = progressive.Renderer(scene, orig, target, w, h, cfg, seed=0)

    ops.reset_launches()
    t = time.perf_counter()
    renderer.render(MAIN_PASSES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    check(launches["trace_kernel"] == MAIN_PASSES,
          f"trace_kernel launched {launches['trace_kernel']} times in "
          f"{MAIN_PASSES} passes")
    img = renderer.state.colors

    # The same passes through the plain version on the card.
    state = progressive.init_state(w, h, cfg, seed=0, device=scene.device)
    li = renderer.light_idx
    for _ in range(MAIN_PASSES):
        vpls, vi = progressive.vpl_update(scene, state, cfg, li)
        rad = ops.trace_camera_plain(scene, cfg, li, renderer.camera, w, h,
                                     state.key, state.sample, vpls=vpls,
                                     vlp_index=vi).reshape(h, w, 3)
        colors, counter = progressive._accumulate(
            state.colors, state.counter, rad, cfg.max_samples)
        state = state.replace(colors=colors, counter=counter, vpls=vpls,
                              vlp_index=vi, sample=state.sample + 1)
    torch.cuda.synchronize()
    vs_plain = protocol(img, state.colors)

    band = w // 8
    left = img[:, :band].mean(dim=(0, 1)).tolist()
    right = img[:, -band:].mean(dim=(0, 1)).tolist()
    nonzero = float((img.amax(dim=-1) > 0).float().mean())
    mean = float(img.mean())

    ms_pass = cuda_ms(renderer.step, reps=20, warmup=4)
    # Where a pass goes: the light pass (run every max_iter - 1 passes),
    # the eye pass (tables, kernel, running mean), and the host time to
    # build one launch's tables.
    st = renderer.state
    light_ms = cuda_ms(lambda: light_tracer.trace_light_paths(
        scene, cfg, li, st.key, st.sample), reps=10)
    eye_ms = cuda_ms(lambda: progressive.eye_accumulate_pass(
        scene, renderer.camera, st, st.vpls, st.vlp_index, cfg, w, h, li),
        reps=20)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(20):
        ops.prepare_camera_launch(scene, cfg, li, renderer.camera, w, h,
                                  st.key, st.sample, st.vpls, st.vlp_index)
    prepare_host_ms = (time.perf_counter() - t) / 20 * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, film.snapshot_name(cfg.max_vlp, wall,
                                                    MAIN_PASSES))
        film.write_ppm(img, path)
        ppm = film.read_ppm(path)
    phase("main_path", width=w, height=h, passes=MAIN_PASSES,
          launches=launches, wall_s=round(wall, 4), mean=mean,
          nonzero_frac=nonzero, left_rgb=left, right_rgb=right,
          vs_plain=vs_plain, ms_per_pass=ms_pass,
          rays_per_s=w * h / (ms_pass / 1e3),
          breakdown_ms={"light_pass": light_ms, "eye_pass": eye_ms,
                        "prepare_launch_host": prepare_host_ms},
          ppm_shape=list(ppm.shape))
    check(vs_plain["finite"], "main path: non-finite pixels")
    check(mean > 0.0, "main path: black image")
    check(nonzero >= 0.4, f"main path: only {nonzero:.1%} pixels lit")
    check(left[0] > left[2], f"main path: left wall not red {left}")
    check(right[2] > right[0], f"main path: right wall not blue {right}")
    check(ppm.shape == (h, w, 3), "main path: PPM has the wrong shape")
    check(vs_plain["bad_frac"] <= MAX_BAD_FRAC,
          f"main path vs plain: {vs_plain['bad_frac']:.3%} bad pixels")
    return {"launches": launches, "renderer": renderer,
            "max_abs_err": vs_plain["max_abs_err"]}


def phase_kernels(main: dict, max_abs_err: float, device) -> None:
    """Per-kernel line: times at the main path's shapes and the bound."""
    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    r = main["renderer"]
    scene, cfg, li = r.scene, r.cfg, r.light_idx
    w, h, n = r.width, r.height, r.width * r.height
    state = r.state
    vpls, vi = progressive.vpl_update(scene, state, cfg, li)
    args = (scene, cfg, li, r.camera, w, h, state.key, state.sample)
    kw = dict(vpls=vpls, vlp_index=vi)
    # The kernel alone: tables built once, launched 50 times.
    ms = cuda_ms(ops.prepare_camera_launch(*args, **kw), reps=50)
    plain_ms = cuda_ms(lambda: ops.trace_camera_plain(*args, **kw), reps=5,
                       warmup=1)

    # This pass's work as the kernel does it, counted by the plain tracer
    # on the same inputs: every sphere tested for the nearest hit, shadow
    # samples set up, and only the shadow rays cast, each up to its first
    # blocker.
    px, py = cam_mod.pixel_grid(w, h, device=device)
    ju = rng.site_uniforms(state.key, state.sample, 0, rng.CAM_JITTER, 2, n,
                           device=device)
    rays = cam_mod.primary_rays(r.camera, w, h, ju[0], ju[1], px, py)
    _, stats = path_tracer.trace(scene, cfg, li, rays, state.key,
                                 state.sample, with_stats=True, **kw)
    s = scene.num_spheres
    n_vpl = cfg.vpl_depth * cfg.max_vlp if cfg.use_vpl else 0
    ops_total = ((stats["extension_segments"] * s + stats["shadow_tests"])
                 * OPS_ROOT
                 + stats["hit_segments"] * OPS_SEGMENT
                 + stats["shadow_setups"] * OPS_SHADOW_SETUP
                 + stats["diffuse_vertices"] * OPS_SCATTER)
    k_rows = 2 + cfg.max_depth * (2 * max(len(li), 1) + 3)
    bytes_total = (4 * 16 * (s + n_vpl) + 16 * k_rows + 4 * len(li)
                   + 4 * 32 + 12 * n)
    t_ops = ops_total / PEAK_FP32_FLOPS * 1e3
    t_bytes = bytes_total / PEAK_BYTES_PER_S * 1e3
    line = {"kernels": [{
        "name": "trace_kernel",
        "route": "cuda",
        "source": "gpu_bidirectional_raytracer_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_trace.py:443",
        "launches": main["launches"]["trace_kernel"],
        "max_abs_err": max(max_abs_err, main["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
        "work": {**stats, "fp32_ops": ops_total, "bytes": bytes_total},
    }]}
    print(json.dumps(line), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import gpu_bidirectional_raytracer_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"chip_smoke: the port is not importable here: {err}",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    smi = smi_line()
    phase("device", name=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi)
    try:
        phase_build()
        max_err = phase_kernel_vs_plain(device)
        main_res = phase_main_path()
        phase_kernels(main_res, max_err, device)
    except SmokeFailure as err:
        print(f"chip_smoke: FAILED: {err}", file=sys.stderr, flush=True)
        return 1
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
