"""Smoke run of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths: the progressive Cornell render at 512x512
through the hand-written CUDA eye-path kernel; the training step and the
inverse fitter through its hand-written adjoint kernels; the many-sphere
route on complex.scn (783 spheres) at 512x384, the render through the
per-depth bounce kernel and the training step through the fact kernel and
the re-walk; the per-bounce scan route there, the tracer's sphere scans
through the nearest-hit and any-hit kernels, and the training step with
the scans in matmul form; and the gradient carriers (``vis_grad_tau``
through the adjoint kernels' carrier instantiations and the re-walk,
``sil_grad_tau`` in PyTorch) in the training step and the fitter. It holds
every kernel against its plain PyTorch version and prints one line per
phase, each with the seconds since the start. The launch counts a phase
reads are set to 0 just before it drives its path.

1. ``device``: the card, and ``nvidia-smi``'s name and power limit;
2. ``build``: nvcc builds every kernel source into ``build/kernels/``,
   one process per source, all at once; ptxas's registers, spills and
   stack (local memory) per entry point; stale ``lock`` files there are
   removed;
3. ``kernel_vs_plain``: at 64x48 on cornell.scn, camera and ray mode,
   samples 0 and 1, with the default config (VPLs on) and with the CPU
   golden gains and stratified jitter: kernel and plain version on the
   same inputs, under the radiance protocol (a pixel is bad if any channel
   differs by more than 2e-3 + 2e-3*|ref|; at most 3.5% bad pixels);
4. ``grad_vs_plain``: at 64x48 on cornell.scn, ``max_depth`` 7, four
   cases (default config; VPLs off; fused l2; fused log): kernel and plain
   version (autograd on the card) on the same inputs; the loss to 1e-5
   relative; every gradient (p, rad, e, c, the VPL buffer, the rays) per
   array within ``2e-3 |plain| + 2e-3 max|plain|``, and its largest
   relative difference over the entries above 1e-3 of its largest
   (``_max_rel``) at most 1e-3; the fused kernel's radiance against
   ``trace_kernel``'s on the same rays (``exact_frac``, under the radiance
   protocol); two launches on the same inputs give the same bits;
5. ``carrier_vs_plain``: the adjoint kernels with the visibility carrier
   (``vis_grad_tau`` 2) against autograd of the plain tracer, which
   carries it: ``grad_kernel`` at 64x48, depth 7, on simple.scn with an
   occluder (without and with VPLs) and on Cornell with VPLs, and
   ``fused_kernel`` at 512x512 on Cornell and on the occluder scene with
   VPLs; the gates of 4, the radiance bit for bit against the plain
   tracer's, which is bit for bit the same with the carrier off, and on
   the occluder scene the occluder's and the VPL table's gradients moved
   by the carrier, the occluder's by more than the gates let pass (on
   Cornell the wall spheres hold every shadow segment, so the carrier
   adds nothing); ptxas's registers, spills and stack of the four
   instantiations of the adjoint template: no spills, and each at the
   registers and stack bytes of the redesign (``ADJOINT_RESOURCES``);
6. ``tape_vs_plain``: a threefry key (the fitter's), whose tape the
   kernels read streamed from the card, at 64x48 on cornell.scn:
   ``trace_kernel`` in camera and ray mode under the radiance protocol,
   ``grad_kernel`` and ``fused_kernel`` against autograd of the plain
   tracer under the gradient protocol of 4; and the tape built on the
   card against the same tape built on the CPU, bit for bit;
7. ``bounce_vs_plain``: at 64x48, depth 7, on complex.scn (mix32 and
   threefry keys) and on cornell.scn with ``direct_only``: each depth's
   ``bounce_kernel`` launch against ``bounce_plain`` on the same state
   (``depth_exact_frac``), and on a ragged prefix of the lanes (3,059, not
   a multiple of G x block) in the full frame's tape, equal to the full
   launch's lanes bit for bit (``ragged_exact_frac``); both kernels with
   every G (lanes per ray) the bits of G = 1 in the state and the facts
   (``groups_same_bits``); the whole trace against the full-scan plain
   tracer under the radiance protocol; two traces with the same bits; the
   ``aux_kernel`` facts against the plain collector (the hit-id mismatch,
   and the occlusion mismatch over the entries either side reached, each
   at most 3.5%); on complex.scn the re-walk's gradients from the
   kernel's facts against autograd of the plain tracer, under 4's
   gradient protocol;
8. ``scan_vs_plain``: at 64x48, depth 7, on complex.scn (mix32 and
   threefry keys) and on cornell.scn, with VPLs: every scan of a plain
   trace of the scan route, with the dead lanes and dead warps of its
   depths, through ``nearest_kernel`` and ``anyhit_kernel`` (both modes;
   each kernel at every G) and their plain versions (both with their tile
   of one lane), equal bit for bit on every lane and on a ragged prefix;
   two launches with the same bits; the whole trace
   through the kernels against the full-scan plain tracer under the
   protocol, and equal to the plain route bit for bit; compaction equal
   bit for bit;
9. ``main_path``: ``Renderer(cornell.scn, 512x512, IntegratorConfig(),
   seed=0)`` for 32 passes (one ``trace_kernel`` launch per pass); image
   checks (finite, mean > 0, left wall red, right wall blue); the same
   passes through the plain version on the card under the protocol; ms
   per pass with CUDA events after a warm-up; the PPM written to a
   temporary directory;
10. ``train_path``: at 512x512 on cornell.scn with ``IntegratorConfig()``:
   (a) the bench's training step, ``render_loss_grad(spp=1, loss="l2",
   backend="auto")`` against a black target on mix32 keys, 20 steps (one
   ``fused_kernel`` launch per step, nothing else), ms per step, its
   breakdown, and loss and gradients against the plain versions on the
   card; (b) ``InverseRenderer`` (threefry keys) fitting the left wall's
   albedo for 8 steps (``l2``, fixed tape, spp 4: four ``trace_kernel``
   and four ``grad_kernel`` launches per step; the loss falls), then one
   step with every default (``l2_unbiased``, spp 4: eight of each); the
   first step of each fitter against its plain autograd route at 512x512;
11. ``complex_path``: ``Renderer(complex.scn, 512x384, IntegratorConfig(),
   backend="auto")`` for 8 passes: 7 ``bounce_kernel`` launches per pass
   and nothing else; image checks; the same 8 passes in 96-row bands
   (``tile_rows=96``) equal to the untiled ones bit for bit; one pass
   against one pass of the plain banded program (``backend="xla"``) under
   the protocol; ms per pass with CUDA events;
12. ``complex_train``: ``render_loss_grad(backend="pallas")`` on
   complex.scn at 512x384, l2 against black, spp 1, 3 steps: 7
   ``aux_kernel`` launches per step and nothing else; ms per step, peak
   GiB; the step against ``backend="xla"`` (plain full-scan autograd) at
   128x96, and at 512x384 the re-walk from the kernel's facts against the
   re-walk from the plain collector's, under 4's gradient protocol;
13. ``carrier_train``: at 512x512 on cornell.scn, (a) the fused step with
   the visibility carrier (one ``fused_kernel_vis`` launch a step and
   nothing else) beside the carrier-off step, 20 steps each, ms per step
   and peak GiB; (b) the step with the silhouette carrier (``sil_grad_tau``
   1, spp 1, l2: ``trace_kernel`` and ``grad_kernel`` and the carrier in
   PyTorch), 5 steps; (c) ``InverseRenderer`` with both carriers and tau
   annealing (0.25 over 8 steps), 8 steps at spp 4 (four ``trace_kernel``
   and four ``grad_kernel_vis`` launches a step; the loss falls), s per
   step, its first step against its plain autograd route under 4's
   gates; (d) complex.scn's step through the fact kernel and the re-walk
   with the visibility carrier at 128x96 (plain soft visibility keeps
   ``[N * slots, S, 3]`` per depth for the backward) against plain
   full-scan autograd under 4's gates, peak GiB;
14. ``scan_path``: `path_tracer.trace(scan_backend="pallas")` on
   complex.scn at 512x384 with ``IntegratorConfig()``, 8 samples as
   tools/bench_complex.py makes them, without and with ``scan_compact``:
   7 ``nearest_kernel`` and 14 ``anyhit_kernel`` launches a sample and
   nothing else; ms per sample, and the bounce route's on the same
   samples; image checks; compaction equal bit for bit; sample 0 against
   the bounce route and the plain tracer under the protocol; the
   ``scan_backend="mxu"`` forward against ``"xla"`` under
   tests/test_mxu.py's bounds (mean within 2%, under 5% of pixels off);
15. ``mxu_train``: ``render_loss_grad(backend="mxu")`` on complex.scn at
   512x384, l2 against black, spp 1, 2 steps, ms per step and peak GiB,
   and the same with ``backend="xla"``; at 128x96 the two against each
   other under tests/test_mxu.py's bounds (loss within 2e-2, gradient
   cosines above 0.98) on that file's 80-sphere scene, and on complex.scn
   for the loss and the e and c gradients;
16. ``kernels``: one JSON line with a row per kernel (seven): launches on
   its path, ms per launch, the plain version's ms, and the bound; the
   eye-path and bounce kernels' rows also time 128, 256 and 512 threads
   per block (``block_ms``; the eye-path row with its resident blocks per
   SM at each); the
   bounce and fact kernels' rows give each depth's time alone on the state
   the pass brings it (``ms_per_depth``), the live share per depth and
   each depth's time at every G (``group_ms``); the scan kernels' rows
   give each depth's time, without and with compaction, each launch's
   time at every G (``group_ms``), a launch with no live lane
   (``idle_ms``) and the resources (dynamic shared memory, resident blocks
   per SM); the kernels of the main paths are timed by their device time
   in ``torch.profiler``'s trace (``device_ms``), the adjoint kernels by
   CUDA events; the adjoint kernels'
   rows their carrier
   instantiations' ``vis_ms``, ``vis_launches``, ``vis_bound_ms`` (the
   carrier's blocker terms counted by ``with_stats``) and
   ``vis_max_abs_err`` (from 5's occluder cases, where the carrier
   moves the gradient), and each instantiation's dynamic shared memory
   on the training path's tables and resident blocks per SM
   (``smem_bytes``, ``blocks_per_sm``, ``vis_*``; the bytes gated to
   ``ADJOINT_RESOURCES``).

The last line is ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before it. Without a card, or without the package beside it, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# The adjoint kernels do the eye-path kernel's work in their forward sweep,
# then per unit of work in the reverse sweep (csrc/grad_kernel.cu, counted
# in PERF.md): a hit segment's root and shading recomputed and their
# adjoints (normal, hit point, root); a diffuse scatter recomputed and its
# adjoint; and, for each shadow sample that reached the vertex, its set-up
# recomputed and its adjoint. The warp reductions of the table gradients
# are not counted.
OPS_SEGMENT_ADJ = 100
OPS_SCATTER_ADJ = 120
OPS_SHADOW_ADJ = 85
GRAD_W, GRAD_H = 64, 48
TRAIN_W, TRAIN_H, TRAIN_STEPS, FIT_STEPS = 512, 512, 20, 8
# The many-sphere route: complex.scn (783 spheres) at the size of the JAX
# package's bench leg (bench.py:262), 7 depths per pass.
COMPLEX = os.path.join(os.path.dirname(SCENE), "complex.scn")
COMPLEX_W, COMPLEX_H, COMPLEX_PASSES, COMPLEX_TILE = 512, 384, 8, 96
COMPLEX_STEPS = 3
COMPLEX_GRAD_W, COMPLEX_GRAD_H = 128, 96
BOUNCE_BLOCKS = (128, 256, 512)
ANYHIT_BLOCKS = (256, 1024)
TRACE_BLOCKS = (128, 256, 512)
# The per-bounce scan route on complex.scn at 512x384 (tools/
# bench_complex.py), and the matmul form's training step there.
SCAN_SAMPLES, MXU_STEPS = 8, 2
# tests/test_mxu.py's bounds for the matmul form against the direct one:
# the forward's mean within 2% and at most 5% of its pixels off (isclose,
# rtol 1e-3, atol 1e-4); the step's loss within 2e-2 and each gradient's
# cosine above 0.98.
MXU_ENERGY, MXU_FLIPS, MXU_LOSS_RTOL, MXU_COS = 0.02, 0.05, 2e-2, 0.98
# The comparisons of the training path with its plain autograd routes:
# the fused step's two, then the unfused (grad_kernel) steps' two.
TRAIN_COMPARED = ("step", "loss_grad_plain", "fit_step_l2_spp4",
                  "default_step_l2_unbiased_spp4")
# Gradient protocol (the form of tests/test_pallas_grad.py:258), and a
# bound on `_max_rel` (tests/test_pallas_grad.py:50): the absolute term
# scales with an array's largest entry, which is loose for heavy-tailed
# arrays such as the ray gradients; the relative one is not.
GRAD_RTOL, GRAD_ATOL_REL, LOSS_RTOL, GRAD_MAX_REL = 2e-3, 2e-3, 1e-5, 1e-3
# The gradient carriers: the visibility carrier's tau (JAX's test value),
# the silhouette carrier's, the steps of each timed leg, and the fitter's
# annealing. An occluder of radius 6 at (0, 40, 0) between simple.scn's
# light and its floor (tests/test_pallas_grad.py:110-160) makes the
# carrier the bulk of the blocker's gradient.
VIS_TAU, SIL_TAU, SIL_STEPS = 2.0, 1.0, 5
TAU_ANNEAL, ANNEAL_STEPS = 0.25, 8
SIMPLE = os.path.join(os.path.dirname(SCENE), "simple.scn")
OCCLUDER = (6.0, (0.0, 40.0, 0.0))
# FP32 operations of one carrier term as the kernel does it
# (csrc/grad_kernel.cu::blocker plus the product's update): op 3, b 5,
# |op|^2 5, det 4, width 2, the silhouette sigmoid 5, the clamped root 3,
# the endpoint sigmoid 6, the gate 2, the product 2. Each candidate
# blocker of a cast sample is two terms (the product, then the adjoint's
# recompute); the adjoint's own 52 operations on a gated blocker and the
# segment's adjoint are not counted.
OPS_CARRIER_TERM = 37
# The resources of the four instantiations of csrc/grad_kernel.cu's kernel
# template as the redesign left them: ptxas's registers and stack bytes
# (CUDA 12.8, sm_90a), and the dynamic shared memory of a launch on the
# training path's Cornell tables (512x512, IntegratorConfig()). An edit
# that moves any of them must say so here.
ADJOINT_RESOURCES = {
    "grad_kernel": {"registers": 92, "stack": 928, "smem_bytes": 11972},
    "fused_kernel": {"registers": 93, "stack": 928, "smem_bytes": 11972},
    "grad_kernel_vis": {"registers": 95, "stack": 928, "smem_bytes": 25796},
    "fused_kernel_vis": {"registers": 96, "stack": 928, "smem_bytes": 25796},
}


class SmokeFailure(RuntimeError):
    pass


def phase(label: str, /, **fields) -> None:
    fields = {"phase": label, "t_s": round(time.perf_counter() - T0, 3),
              **fields}
    print(json.dumps(fields), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def counts(**launched) -> dict:
    """The launch counts of every kernel: those given, the others 0."""
    from gpu_bidirectional_raytracer_tpu_torch.ops.pallas_trace import (
        LAUNCHES,
    )

    return {name: launched.get(name, 0) for name in LAUNCHES}


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


PROFILER_FALLBACKS = []   # kernels whose trace held no launch: events


def device_ms(fn, reps: int, match: str, reset=lambda: None,
              launches: int = 1) -> float:
    """Mean device ms of one launch of the kernels whose name holds
    ``match``, over ``reps`` runs of ``fn()`` (each after ``reset()``, and
    each making ``launches`` of them), from ``torch.profiler``'s trace of
    the card: the kernel alone, without the host's gaps between launches,
    which CUDA events around a launch shorter than its host call count.
    A trace that misses launches is taken again, twice at most; then the
    runs are timed with a CUDA event pair around each (``reset()`` left
    out) and ``match`` is added to PROFILER_FALLBACKS."""
    reset()
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                reset()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if match in e.key and e.self_device_time_total > 0]
        count = sum(e.count for e in events)
        if count == reps * launches:
            return sum(e.self_device_time_total for e in events) / count / 1e3
    PROFILER_FALLBACKS.append(match)
    pairs = []
    for _ in range(reps):
        reset()
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        fn()
        ev[1].record()
        pairs.append(ev)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / (reps * launches)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_build() -> dict:
    from gpu_bidirectional_raytracer_tpu_torch.ops import _build

    removed = []
    if _build.BUILD_DIR.is_dir():
        for lock in _build.BUILD_DIR.rglob("lock"):
            lock.unlink()
            removed.append(str(lock))
    t = time.perf_counter()
    libs = _build.build_all()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("entry function", "registers",
                                             "spill", "stack frame"))]
             for name, log in _build.build_log.items()}
    phase("build", seconds=round(time.perf_counter() - t, 3),
          nvcc_seconds={k: round(v, 3)
                        for k, v in _build.build_seconds.items()},
          libraries=[p.name for p in libs.values()], stale_locks=removed,
          ptxas=ptxas)
    return {name: _ptxas_entries(log)
            for name, log in _build.build_log.items()}


def _timed_steps(step, n_steps: int) -> dict:
    """ms per step (CUDA events) of ``step(i)``, i = 1..n_steps, after a
    warm-up step, with the launches and peak memory of the timed steps."""
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(n_steps):
        out = step(1 + i)
    stop.record()
    torch.cuda.synchronize()
    loss, g = out
    check(bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(getattr(g, k)).all())
        for k in ("p", "rad", "e", "c")), "carrier step: non-finite")
    return {"ms_per_step": start.elapsed_time(stop) / n_steps,
            "launches": dict(ops.LAUNCHES),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss": float(loss)}


def _ptxas_entries(log: str) -> dict:
    """ptxas's registers, spill bytes and stack bytes per entry function
    of one nvcc log."""
    import re

    out, entry = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '([^']+)'", ln)
        if m:
            entry = m.group(1)
            out[entry] = {}
        elif entry is not None:
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                out[entry]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                out[entry].update(stack=int(m.group(1)),
                                  spill_stores=int(m.group(2)),
                                  spill_loads=int(m.group(3)))
    return out


def _scene_at(path=SCENE, device="cuda"):
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import load_scene

    return load_scene(path, device=device)


def phase_kernel_vs_plain(device) -> float:
    """Kernel against plain at 64x48, camera and ray mode; max |err|.

    Two configs: the default (VPLs, gains 1, (direct + vpl) / 2), and the
    CPU-golden gains (10, no VPLs) with 3x3 stratified jitter, so every
    parameter the kernel takes is exercised."""
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

    orig, target, scene = _scene_at(SCENE, device)
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
    orig, target, scene = _scene_at()
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


def grad_check(got, ref) -> dict:
    """One gradient array against the plain version's: within
    ``2e-3 |plain| + 2e-3 max|plain|`` everywhere, and ``_max_rel`` of
    tests/test_pallas_grad.py (the largest relative difference over the
    entries above 1e-3 of the largest) at most ``GRAD_MAX_REL``."""
    got, ref = got.detach().double(), ref.detach().double()
    err = (got - ref).abs()
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    big = ref.abs() > 1e-3 * max(scale, 1e-9)
    rel = (err / ref.abs().clamp(min=1e-6))[big]
    max_rel = float(rel.max()) if rel.numel() else 0.0
    ok = bool(torch.isfinite(got).all()) and bool(
        (err <= GRAD_RTOL * ref.abs() + GRAD_ATOL_REL * scale).all()) and (
        max_rel <= GRAD_MAX_REL)
    return {"ok": ok, "max_rel": max_rel,
            "max_abs_err": float(err.max()) if err.numel() else 0.0,
            "max_abs": scale}


def _grad_names(vpls) -> list[str]:
    return (["p", "rad", "e", "c"]
            + (["vpl_hp", "vpl_rad", "vpl_nl"] if vpls is not None else []))


def _diff_vs_plain(tracer, scene, cfg, li, rays, key, vpls, vi, cot) -> dict:
    """Radiance and gradients (scene, VPL buffer, rays) of ``tracer``
    under autograd against the plain tracer's, for ``sum(rad * cot)``."""
    from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg

    def run(fn):
        with torch.enable_grad():
            sc, vb, sl, vl = pg.param_leaves(scene, vpls)
            o = rays.o.detach().clone().requires_grad_()
            d = rays.d.detach().clone().requires_grad_()
            rad = fn(sc, cfg, li, Rays(o=o, d=d), key, 0, vpls=vb,
                     vlp_index=vi)
            value = (rad * cot).sum()
            grads = torch.autograd.grad(value, sl + vl + [o, d])
        return rad.detach(), value.detach(), grads

    rad_k, value_k, g_k = run(tracer)
    rad_p, value_p, g_p = run(path_tracer.trace)
    names = _grad_names(vpls) + ["ray_o", "ray_d"]
    return {"radiance": protocol(rad_k, rad_p),
            "loss_rel": abs(float(value_k) - float(value_p))
            / max(abs(float(value_p)), 1e-30),
            "grads": {k: grad_check(a, b)
                      for k, a, b in zip(names, g_k, g_p)}}


def _fused_vs_plain(scene, cfg, li, rays, key, tgt, vpls, vi,
                    loss: str = "l2") -> dict:
    """`trace_pallas_loss_grad` (``fused_kernel``) against
    `loss_grad_plain`: the loss and the scene's and VPL buffer's
    gradients."""
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg

    out = []
    for fn in (pg.trace_pallas_loss_grad, pg.loss_grad_plain):
        value, gs, gv = fn(scene, cfg, li, rays, key, 0, tgt, vpls=vpls,
                           vlp_index=vi, loss=loss)
        out.append((value, [getattr(gs, k) for k in ("p", "rad", "e", "c")]
                    + list(gv or [])))
    (value_k, g_k), (value_p, g_p) = out
    return {"loss_rel": abs(float(value_k) - float(value_p))
            / max(abs(float(value_p)), 1e-30),
            "grads": {k: grad_check(a, b)
                      for k, a, b in zip(_grad_names(vpls), g_k, g_p)}}


def _check_diff(label: str, r: dict) -> float:
    check(r["loss_rel"] <= LOSS_RTOL,
          f"{label}: loss off by {r['loss_rel']:.2e}")
    check(r["radiance"]["finite"]
          and r["radiance"]["bad_frac"] <= MAX_BAD_FRAC,
          f"{label}: radiance {r['radiance']}")
    for k, g in r["grads"].items():
        check(g["ok"], f"{label}: d{k} outside the tolerance ({g})")
    return max(g["max_abs_err"] for g in r["grads"].values())


def phase_grad_vs_plain(device) -> float:
    """The adjoint kernels against autograd of the plain tracer at 64x48;
    the largest |kernel - plain| over every gradient array."""
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

    orig, target, scene = _scene_at(SCENE, device)
    w, h, n = GRAD_W, GRAD_H, GRAD_W * GRAD_H
    cam = Camera.make(orig, target, w, h, device=device)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n, device=device)
    px, py = cam_mod.pixel_grid(w, h, device=device)
    rays = cam_mod.primary_rays(cam, w, h, ju[0], ju[1], px, py)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cot = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
    tgt = torch.rand((n, 3), generator=gen, device=device) * 0.5
    cases = {"default": (IntegratorConfig(), None),
             "no_vpl": (IntegratorConfig(use_vpl=False, combine_half=False),
                        None),
             "vpl12": (IntegratorConfig(max_vlp=12), None),
             "fused_l2": (IntegratorConfig(), "l2"),
             "fused_log": (IntegratorConfig(), "log")}
    results, worst = {}, 0.0
    for name, (cfg, loss) in cases.items():
        vpls = (light_tracer.trace_light_paths(scene, cfg, li, key, 0)
                if cfg.use_vpl else None)
        vi = 0 if vpls is not None else None
        scene_tab, vpl_tab, tape = ops.launch_tables(
            scene, cfg, li, key, 0, vpls, vi, n)
        if loss is None:
            r = _diff_vs_plain(pg.trace_pallas_diff, scene, cfg, li, rays,
                               key, vpls, vi, cot)
            launch = lambda: pg.grad_launch(scene_tab, vpl_tab, tape, cfg,
                                            li, rays, cot)
        else:
            r = _fused_vs_plain(scene, cfg, li, rays, key, tgt, vpls, vi,
                                loss)
            tk = torch.log1p(tgt) if loss == "log" else tgt
            rad_fused = torch.empty((n, 3), dtype=torch.float32,
                                    device=device)
            pg.fused_launch(scene_tab, vpl_tab, tape, cfg, li, rays, tk,
                            loss, radiance_out=rad_fused)
            rad_trace = ops.trace_pallas(scene, cfg, li, rays, key, 0,
                                         vpls=vpls, vlp_index=vi)
            launch = lambda: pg.fused_launch(scene_tab, vpl_tab, tape, cfg,
                                             li, rays, tk, loss)
            r["radiance"] = protocol(rad_fused, rad_trace)
        first, second = launch(), launch()
        torch.cuda.synchronize()
        r["two_launches_same_bits"] = all(
            torch.equal(a, b) for a, b in zip(first, second))
        results[name] = r
    phase("grad_vs_plain", width=w, height=h, max_depth=7, results=results)
    for name, r in results.items():
        check(r["two_launches_same_bits"],
              f"grad_vs_plain {name}: two launches differ")
        worst = max(worst, _check_diff(f"grad_vs_plain {name}", r))
    return worst


def _occluder_scene(device):
    """simple.scn with `OCCLUDER`, a diffuse sphere between its light and
    its floor."""
    orig, target, base = _scene_at(SIMPLE, device)
    r, p = OCCLUDER

    def cat(a, row):
        return torch.cat([a, torch.tensor([row], dtype=a.dtype,
                                          device=a.device)])

    return orig, target, base.replace(
        rad=torch.cat([base.rad, torch.tensor([r], device=device)]),
        p=cat(base.p, list(p)), e=cat(base.e, [0.0, 0.0, 0.0]),
        c=cat(base.c, [0.5, 0.5, 0.5]), refl=cat(base.refl, 0))


def _grad_instantiations(ptxas: dict) -> dict:
    """ptxas's numbers of the four instantiations of csrc/grad_kernel.cu's
    kernel template, by ``(fused, vis)``."""
    out = {}
    for entry, v in ptxas.get("grad_kernel", {}).items():
        if "grad_kernel" in entry and "ILb" in entry:
            flags = entry.split("ILb", 1)[1]
            fused, vis = flags[0] == "1", flags.split("ELb", 1)[1][0] == "1"
            out[f"{'fused' if fused else 'grad'}_kernel"
                f"{'_vis' if vis else ''}"] = v
    return out


def phase_carrier_vs_plain(device, ptxas: dict) -> dict:
    """The adjoint kernels with the visibility carrier against autograd of
    the plain tracer, which carries it: ``grad_kernel`` at 64x48, depth 7,
    on the occluder scene without and with VPLs and on Cornell with VPLs,
    and ``fused_kernel`` at 512x512 on Cornell and on the occluder scene.
    Gates of `grad_vs_plain`, and: the radiance bit for bit against the
    plain tracer, whose radiance is bit for bit the same with the carrier
    off; on the occluder scene the gradients differ from the carrier-off
    ones. Returns the largest |kernel - plain| of each kernel over the
    occluder cases."""
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
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    key = rng.make_key(0)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    results, worst = {}, {"grad": 0.0, "fused": 0.0}
    occ_cfg = IntegratorConfig(use_vpl=False, combine_half=False,
                               vis_grad_tau=VIS_TAU)
    vpl_cfg = IntegratorConfig(vis_grad_tau=VIS_TAU)
    for name, path, cfg, w, h, fused in (
            ("occluder", SIMPLE, occ_cfg, GRAD_W, GRAD_H, False),
            ("occluder_vpl", SIMPLE, vpl_cfg, GRAD_W, GRAD_H, False),
            ("cornell_vpl", SCENE, vpl_cfg, GRAD_W, GRAD_H, False),
            ("fused_l2_512", SCENE, vpl_cfg, TRAIN_W, TRAIN_H, True),
            ("occluder_fused_l2_512", SIMPLE, vpl_cfg, TRAIN_W, TRAIN_H,
             True)):
        orig, target, scene = (_occluder_scene(device) if path == SIMPLE
                               else _scene_at(path, device))
        n = w * h
        cam = Camera.make(orig, target, w, h, device=device)
        li = static_light_indices(scene)
        ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n,
                               device=device)
        px, py = cam_mod.pixel_grid(w, h, device=device)
        rays = cam_mod.primary_rays(cam, w, h, ju[0], ju[1], px, py)
        vpls = (light_tracer.trace_light_paths(scene, cfg, li, key, 0)
                if cfg.use_vpl else None)
        vi = 0 if vpls is not None else None
        cfg0 = dataclasses.replace(cfg, vis_grad_tau=0.0)
        scene_tab, vpl_tab, tape = ops.launch_tables(
            scene, cfg, li, key, 0, vpls, vi, n)
        with torch.no_grad():
            plain = path_tracer.trace(scene, cfg, li, rays, key, 0,
                                      vpls=vpls, vlp_index=vi)
            plain_off = path_tracer.trace(scene, cfg0, li, rays, key, 0,
                                          vpls=vpls, vlp_index=vi)
        if not fused:
            cot = torch.rand((n, 3), generator=gen, device=device) * 2 - 1
            r = _diff_vs_plain(pg.trace_pallas_diff, scene, cfg, li, rays,
                               key, vpls, vi, cot)
            launch = lambda c: pg.grad_launch(scene_tab, vpl_tab, tape, c,
                                              li, rays, cot)
            rad_k = pg.trace_pallas_diff(scene, cfg, li, rays, key, 0,
                                         vpls=vpls, vlp_index=vi)
        else:
            tgt = torch.rand((n, 3), generator=gen, device=device) * 0.5
            r = _fused_vs_plain(scene, cfg, li, rays, key, tgt, vpls, vi)
            rad_k = torch.empty((n, 3), dtype=torch.float32, device=device)
            pg.fused_launch(scene_tab, vpl_tab, tape, cfg, li, rays, tgt,
                            "l2", radiance_out=rad_k)
            launch = lambda c: pg.fused_launch(scene_tab, vpl_tab, tape, c,
                                               li, rays, tgt, "l2")
        r["radiance"] = protocol(rad_k, plain)
        r["plain_same_bits_carrier_off"] = torch.equal(plain, plain_off)
        first, second = launch(cfg), launch(cfg)
        off = launch(cfg0)
        torch.cuda.synchronize()
        r["two_launches_same_bits"] = all(
            torch.equal(a, b) for a, b in zip(first, second))
        # The scene table's gradient (on the occluder scene the
        # occluder's p, its last row) and the VPL table's.
        (dtab, dvpl), (dtab_off, dvpl_off) = (
            (out[1], out[2]) if fused else (out[0], out[1])
            for out in (first, off))
        if path == SIMPLE:
            dtab, dtab_off = dtab[-1, 1:4], dtab_off[-1, 1:4]
            r["occluder_dp"] = {"vis": dtab.tolist(),
                                "off": dtab_off.tolist()}
            # The carrier's share of the occluder's p gradient: above
            # GRAD_MAX_REL, a kernel that dropped the carrier would fail
            # the gates.
            r["carrier_share"] = float(((dtab - dtab_off).abs()
                                        / dtab.abs().clamp(min=1e-30))
                                       .max())
        r["carrier_moves_gradient"] = not torch.equal(dtab, dtab_off)
        if path == SIMPLE and cfg.use_vpl:
            r["carrier_moves_vpl_gradient"] = not torch.equal(dvpl,
                                                              dvpl_off)
        r["fused"] = fused
        results[name] = r
    inst = _grad_instantiations(ptxas)
    phase("carrier_vs_plain", max_depth=7, vis_grad_tau=VIS_TAU,
          results=results, ptxas=inst)
    for name, r in results.items():
        label = f"carrier_vs_plain {name}"
        check(r["two_launches_same_bits"], f"{label}: two launches differ")
        check(r["plain_same_bits_carrier_off"],
              f"{label}: the carrier moved the plain radiance")
        check(r["radiance"]["exact_frac"] == 1.0,
              f"{label}: radiance not bit for bit {r['radiance']}")
        err = _check_diff(label, r)
        # Cornell's walls are spheres that hold every shadow segment, so
        # soft visibility is 0 there and the carrier adds nothing (as in
        # the JAX package); the occluder scene holds no segment. The
        # error reported for a carrier kernel is the occluder cases', where
        # a wrong carrier would show.
        if name.startswith("occluder"):
            check(r["carrier_moves_gradient"]
                  and r.get("carrier_moves_vpl_gradient", True)
                  and r["carrier_share"] > GRAD_MAX_REL,
                  f"{label}: the carrier left the gradient as it was "
                  f"(share {r['carrier_share']:.2e})")
            kind = "fused" if r["fused"] else "grad"
            worst[kind] = max(worst[kind], err)
    check(set(inst) == set(ADJOINT_RESOURCES)
          and all(v.get("spill_stores", 1) == 0
                  and v.get("spill_loads", 1) == 0 for v in inst.values())
          and all(inst[k].get(f) == want[f]
                  for k, want in ADJOINT_RESOURCES.items()
                  for f in ("registers", "stack")),
          f"grad_kernel instantiations {inst}: want no spills, and the "
          f"registers and stack of {ADJOINT_RESOURCES}")
    return worst


def phase_carrier_train(train: dict, ctrain: dict) -> dict:
    """The carriers on the training paths, through the entry points a user
    calls: (a) the fused step at Cornell 512x512 with the visibility
    carrier, 20 steps, beside the carrier-off step; (b) the step with the
    silhouette carrier (spp 1, l2: `trace_kernel` and `grad_kernel` and
    the carrier in PyTorch), 5 steps; (c) `InverseRenderer` with both
    carriers and tau annealing, 8 steps at spp 4 (the loss falls); (d)
    complex.scn's re-walk with the visibility carrier at 128x96 against
    plain full-scan autograd."""
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import Camera
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    scene, cam, cfg, li, key = (train["scene"], train["cam"], train["cfg"],
                                train["li"], train["key"])
    w, h = TRAIN_W, TRAIN_H
    black = torch.zeros((h, w, 3), dtype=torch.float32, device=scene.device)
    vis_cfg = dataclasses.replace(cfg, vis_grad_tau=VIS_TAU)
    sil_cfg = dataclasses.replace(cfg, sil_grad_tau=SIL_TAU)

    def stepper(c):
        return lambda i: G.render_loss_grad(
            scene, cam, rng.fold_in(key, i), black, c, w, h, li, spp=1,
            loss="l2", backend="auto")

    legs = {"fused_off": _timed_steps(stepper(cfg), TRAIN_STEPS),
            "fused_vis": _timed_steps(stepper(vis_cfg), TRAIN_STEPS),
            "sil": _timed_steps(stepper(sil_cfg), SIL_STEPS)}

    # (c) The fitter: the left wall's albedo, as train_path's, with both
    # carriers annealed.
    target_img = G.render_radiance(scene, cam, key, cfg, w, h, li, spp=4)
    c = scene.c.clone()
    c[0] = torch.tensor([0.5, 0.5, 0.5], device=c.device)
    fit_cfg = dataclasses.replace(cfg, vis_grad_tau=VIS_TAU,
                                  sil_grad_tau=SIL_TAU)
    inv = G.InverseRenderer(scene=scene.replace(c=c), cam=cam,
                            target=target_img, cfg=fit_cfg, width=w,
                            height=h, lr=0.05, spp=4, optimize=("c",),
                            resample=False, loss="l2",
                            tau_anneal=TAU_ANNEAL,
                            anneal_steps=ANNEAL_STEPS)
    # Its first step (threefry key, both carriers at their first taus)
    # through the kernels against its plain autograd route, at 512x512.
    first_cfg = inv._step_cfg()

    def first_step(route):
        return G.render_loss_grad(
            inv.scene, inv.cam, rng.make_key(inv.seed, "threefry"),
            inv.target, first_cfg, inv.width, inv.height, inv.light_idx,
            inv.spp, inv.loss, route)

    ops.reset_launches()
    lk, gk = first_step(inv.backend)
    torch.cuda.synchronize()
    first_launches = dict(ops.LAUNCHES)
    lp, gp = first_step("xla")
    torch.cuda.synchronize()
    params = ("p", "rad", "e", "c")
    fit_vs_plain = {
        "launches": first_launches,
        "loss_rel": abs(float(lk) - float(lp)) / abs(float(lp)),
        "grads": {k: grad_check(getattr(gk, k), getattr(gp, k))
                  for k in params}}
    del gk, gp
    torch.cuda.empty_cache()
    taus = [first_cfg.vis_grad_tau]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    losses = []
    for _ in range(FIT_STEPS):
        losses.append(inv.step())
        taus.append(inv._step_cfg().vis_grad_tau)
    torch.cuda.synchronize()
    fit = {"steps": FIT_STEPS, "losses": losses,
           "s_per_step": (time.perf_counter() - t) / FIT_STEPS,
           "launches": dict(ops.LAUNCHES), "vis_tau_by_step": taus,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "first_step_vs_plain": fit_vs_plain}

    # (d) complex.scn: the re-walk carries the carrier through NEE with
    # given occlusion; plain soft_visibility builds [N * slots, S, 3] per
    # depth, so this runs at 128x96 (the re-walk keeps every depth).
    cscene, ccfg, cli = ctrain["scene"], ctrain["cfg"], ctrain["li"]
    ccfg = dataclasses.replace(ccfg, vis_grad_tau=VIS_TAU)
    gw, gh = COMPLEX_GRAD_W, COMPLEX_GRAD_H
    orig, target, _ = _scene_at(COMPLEX)
    gcam = Camera.make(orig, target, gw, gh)
    gblack = torch.zeros((gh, gw, 3), dtype=torch.float32,
                         device=cscene.device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t = time.perf_counter()
    lk, gk = G.render_loss_grad(cscene, gcam, key, gblack, ccfg, gw, gh,
                                cli, 1, "l2", "pallas")
    torch.cuda.synchronize()
    rewalk_s = time.perf_counter() - t
    rewalk_launches = dict(ops.LAUNCHES)
    rewalk_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    lp, gp = G.render_loss_grad(cscene, gcam, key, gblack, ccfg, gw, gh,
                                cli, 1, "l2", "xla")
    torch.cuda.synchronize()
    complex_vis = {
        "width": gw, "height": gh, "launches": rewalk_launches,
        "s_step": rewalk_s, "peak_gib": rewalk_peak,
        "plain_peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "loss_rel": abs(float(lk) - float(lp)) / abs(float(lp)),
        "grads": {k: grad_check(getattr(gk, k), getattr(gp, k))
                  for k in params}}
    del gk, gp
    torch.cuda.empty_cache()

    phase("carrier_train", width=w, height=h, vis_grad_tau=VIS_TAU,
          sil_grad_tau=SIL_TAU, legs=legs, fit=fit, complex_vis=complex_vis)
    check(legs["fused_off"]["launches"] == counts(fused_kernel=TRAIN_STEPS),
          f"carrier-off step launches {legs['fused_off']['launches']}")
    check(legs["fused_vis"]["launches"]
          == counts(fused_kernel_vis=TRAIN_STEPS),
          f"carrier step launches {legs['fused_vis']['launches']}")
    check(legs["sil"]["launches"]
          == counts(trace_kernel=SIL_STEPS, grad_kernel=SIL_STEPS),
          f"silhouette step launches {legs['sil']['launches']}")
    per_step = 4 * FIT_STEPS
    check(fit["launches"] == counts(trace_kernel=per_step,
                                    grad_kernel_vis=per_step),
          f"carrier fitter launches {fit['launches']}")
    check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
          f"carrier fitter loss did not fall: {losses}")
    check(taus[0] == VIS_TAU and taus[-1] == VIS_TAU * TAU_ANNEAL,
          f"carrier fitter taus {taus}")
    check(fit_vs_plain["launches"] == counts(trace_kernel=4,
                                             grad_kernel_vis=4),
          f"carrier fitter's first step launches {fit_vs_plain['launches']}")
    check(fit_vs_plain["loss_rel"] <= LOSS_RTOL,
          f"carrier fitter's first step vs plain: loss off by "
          f"{fit_vs_plain['loss_rel']:.2e}")
    for k, gr in fit_vs_plain["grads"].items():
        check(gr["ok"], f"carrier fitter's first step vs plain: d{k} "
                        f"outside the tolerance ({gr})")
    check(rewalk_launches == counts(aux_kernel=ccfg.max_depth),
          f"complex carrier step launches {rewalk_launches}")
    check(complex_vis["loss_rel"] <= LOSS_RTOL,
          f"complex carrier step: loss off by {complex_vis['loss_rel']:.2e}")
    for k, gr in complex_vis["grads"].items():
        check(gr["ok"], f"complex carrier step: d{k} outside the tolerance "
                        f"({gr})")
    return {"step_launches": legs["fused_vis"]["launches"],
            "fit_launches": fit["launches"]}


def phase_train_path() -> dict:
    """The training step and the fitter at 512x512, through the entry
    points as a user calls them (the default device is the card)."""
    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    orig, target, scene = _scene_at()
    cfg = IntegratorConfig()
    w, h, n = TRAIN_W, TRAIN_H, TRAIN_W * TRAIN_H
    cam = Camera.make(orig, target, w, h)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    black = torch.zeros((h, w, 3), dtype=torch.float32, device=scene.device)

    # (a) The bench's step: l2 against a black target, spp 1, fresh key.
    def step(i):
        return G.render_loss_grad(scene, cam, rng.fold_in(key, i), black,
                                  cfg, w, h, li, spp=1, loss="l2",
                                  backend="auto")

    step(0)
    torch.cuda.synchronize()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    t = time.perf_counter()
    start.record()
    for i in range(TRAIN_STEPS):
        loss_v, g = step(1 + i)
    stop.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    step_launches = dict(ops.LAUNCHES)
    ms_step = start.elapsed_time(stop) / TRAIN_STEPS
    check(step_launches == counts(fused_kernel=TRAIN_STEPS),
          f"training step launches {step_launches} in {TRAIN_STEPS} steps")
    check(bool(torch.isfinite(loss_v)) and all(
        bool(torch.isfinite(getattr(g, k)).all())
        for k in ("p", "rad", "e", "c")), "training step: non-finite")

    # Where a step goes: the light subpaths (forward under autograd and
    # the pull of the VPL cotangent), the tables, the fused kernel.
    ju = rng.site_uniforms(key, 0, 0, rng.CAM_JITTER, 2, n,
                           device=scene.device)
    px, py = cam_mod.pixel_grid(w, h, device=scene.device)
    rays = cam_mod.primary_rays(cam, w, h, ju[0], ju[1], px, py)

    def light_fwd():
        with torch.enable_grad():
            sc, _, sl, _ = pg.param_leaves(scene)
            return light_tracer.trace_light_paths(sc, cfg, li, key, 0), sl

    def light_fwd_pull():
        v, sl = light_fwd()
        return torch.autograd.grad(
            [v.hp, v.rad, v.nl], sl,
            [torch.ones_like(v.hp), torch.ones_like(v.rad),
             torch.ones_like(v.nl)], allow_unused=True)

    vpls, _ = light_fwd()
    vpls = vpls.__class__(hp=vpls.hp.detach(), rad=vpls.rad.detach(),
                          nl=vpls.nl.detach(), valid=vpls.valid,
                          sid=vpls.sid)

    def tables():
        with torch.enable_grad():
            sc, vb, _, _ = pg.param_leaves(scene, vpls)
            return ops.launch_tables(sc, cfg, li, key, 0, vb, 0, n)

    scene_tab, vpl_tab, tape = tables()
    tgt = black.reshape(n, 3)
    light_ms = cuda_ms(light_fwd, reps=10)
    breakdown = {
        "light_forward": light_ms,
        "light_pullback": cuda_ms(light_fwd_pull, reps=10) - light_ms,
        "tables": cuda_ms(tables, reps=10),
        # The tape of one fitter launch (threefry: built on the card).
        "threefry_tape": cuda_ms(lambda: ops.tape_table(
            cfg, li, rng.make_key(0, "threefry"), 0, False, n,
            scene.device), reps=5),
        "fused_kernel": cuda_ms(lambda: pg.fused_launch(
            scene_tab, vpl_tab, tape, cfg, li, rays, tgt, "l2"),
            reps=20),
    }

    # Loss and gradients against the plain versions on the card: the whole
    # step against its plain autograd route, and the fused kernel's wrapper
    # against `loss_grad_plain` on the step's rays and VPLs (the direct
    # gradients and the VPL buffer's cotangent).
    def compare(value_k, grads_k, value_p, grads_p, names):
        return {"loss_rel": abs(float(value_k) - float(value_p))
                / abs(float(value_p)),
                "grads": {k: grad_check(a, b)
                          for k, a, b in zip(names, grads_k, grads_p)}}

    params = ("p", "rad", "e", "c")

    def step_vs_plain(sc, k, tgt_img, spp, loss):
        """`render_loss_grad` through the kernels against its plain
        autograd route, at 512x512 on the same key."""
        lk, gk = G.render_loss_grad(sc, cam, k, tgt_img, cfg, w, h, li,
                                    spp, loss, "auto")
        lp, gp = G.render_loss_grad(sc, cam, k, tgt_img, cfg, w, h, li,
                                    spp, loss, "xla")
        torch.cuda.synchronize()
        return compare(lk, [getattr(gk, p) for p in params], lp,
                       [getattr(gp, p) for p in params], params)

    torch.cuda.reset_peak_memory_stats()
    fk = pg.trace_pallas_loss_grad(scene, cfg, li, rays, key, 0, tgt,
                                   vpls=vpls, vlp_index=0)
    fp = pg.loss_grad_plain(scene, cfg, li, rays, key, 0, tgt, vpls=vpls,
                            vlp_index=0)
    vs_plain = {
        # the bench's step (fused_kernel)
        "step": step_vs_plain(scene, key, black, 1, "l2"),
        "loss_grad_plain": compare(
            fk[0], [getattr(fk[1], p) for p in params] + list(fk[2]),
            fp[0], [getattr(fp[1], p) for p in params] + list(fp[2]),
            _grad_names(vpls))}
    del fk, fp

    # (b) The fitter: the left wall's albedo from a target of the true
    # scene (same key, spp 4), fixed tape, l2: the unfused route. Its
    # first step, and the first step of the default fitter (l2_unbiased,
    # resampled), against their plain autograd routes (grad_kernel).
    target_img = G.render_radiance(scene, cam, key, cfg, w, h, li, spp=4)
    c = scene.c.clone()
    c[0] = torch.tensor([0.5, 0.5, 0.5], device=c.device)
    wrong = scene.replace(c=c)
    # The fitter's key: threefry, the tape streamed to the kernels.
    vs_plain["fit_step_l2_spp4"] = step_vs_plain(
        wrong, rng.make_key(0, "threefry"), target_img, 4, "l2")
    vs_plain["default_step_l2_unbiased_spp4"] = step_vs_plain(
        scene, rng.fold_in(rng.make_key(0, "threefry"), 0), target_img, 4,
        "l2_unbiased")
    vs_plain["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()

    inv = G.InverseRenderer(scene=wrong, cam=cam, target=target_img,
                            cfg=cfg, width=w, height=h, lr=0.05, spp=4,
                            optimize=("c",), resample=False, loss="l2")
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    losses = [inv.step() for _ in range(FIT_STEPS)]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    fit_launches = dict(ops.LAUNCHES)
    inv_d = G.InverseRenderer(scene=scene, cam=cam, target=target_img,
                              cfg=cfg, width=w, height=h)
    ops.reset_launches()
    default_loss = inv_d.step()
    torch.cuda.synchronize()
    default_launches = dict(ops.LAUNCHES)

    phase("train_path", width=w, height=h, steps=TRAIN_STEPS,
          launches=step_launches, ms_per_step=ms_step,
          rays_per_s=n / (ms_step / 1e3), wall_s=round(wall, 4),
          loss=float(loss_v), breakdown_ms=breakdown, vs_plain=vs_plain,
          fit={"steps": FIT_STEPS, "losses": losses,
               "launches": fit_launches, "s_per_step": fit_s / FIT_STEPS,
               "left_wall_c": inv.scene.c[0].tolist()},
          fit_default={"loss": default_loss, "launches": default_launches,
                       "loss_kind": inv_d.loss})
    for what in TRAIN_COMPARED:
        r = vs_plain[what]
        check(r["loss_rel"] <= LOSS_RTOL,
              f"training {what} vs plain: loss off by {r['loss_rel']:.2e}")
        for k, g in r["grads"].items():
            check(g["ok"], f"training {what} vs plain: d{k} outside the "
                           f"tolerance ({g})")
    per_step = 4 * FIT_STEPS
    check(fit_launches == counts(trace_kernel=per_step, grad_kernel=per_step),
          f"fitter launches {fit_launches} in {FIT_STEPS} steps")
    check(all(math.isfinite(x) for x in losses), f"fitter losses {losses}")
    check(losses[-1] < losses[0], f"fitter loss did not fall: {losses}")
    check(default_launches == counts(trace_kernel=8, grad_kernel=8),
          f"default fitter step launches {default_launches}")
    check(math.isfinite(default_loss), "default fitter step: loss")

    def worst(whats):
        return max(g["max_abs_err"] for what in whats
                   for g in vs_plain[what]["grads"].values())

    return {"step_launches": step_launches, "fit_launches": fit_launches,
            "fused_err": worst(TRAIN_COMPARED[:2]),
            "grad_err": worst(TRAIN_COMPARED[2:]),
            "scene": scene, "cam": cam, "cfg": cfg, "li": li, "key": key,
            "rays": rays, "vpls": vpls, "tables": (scene_tab, vpl_tab, tape)}


def phase_tape_vs_plain(device) -> dict:
    """A threefry key (the fitter's) through the three eye-path kernels,
    which read its tape streamed from the card, against their plain
    versions at 64x48 on cornell.scn; and the tape made on the card
    against the same tape made on the CPU, bit for bit."""
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
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    orig, target, scene = _scene_at(SCENE, device)
    w, h, n = GRAD_W, GRAD_H, GRAD_W * GRAD_H
    cam = Camera.make(orig, target, w, h, device=device)
    li = static_light_indices(scene)
    cfg = IntegratorConfig()
    key = rng.make_key(0, "threefry")
    tapes = {}
    for name, args in {"camera": (0, True, n, None, None),
                       "window": (1, False, n // 2, n // 4, n)}.items():
        sample, cam_jitter, m, lo, total = args
        on_card = ops.tape_table(cfg, li, key, sample, cam_jitter, m,
                                 device, lo, total)
        on_cpu = ops.tape_table(cfg, li, key, sample, cam_jitter, m, "cpu",
                                lo, total)
        tapes[name] = {"rows": on_card.stream.shape[0],
                       "same_bits": bool(torch.equal(on_card.stream.cpu(),
                                                     on_cpu.stream))}
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
    rays = progressive.frame_rays(cam, cfg, w, h, key, 0)
    results = {
        "camera": protocol(
            ops.trace_pallas_camera(scene, cfg, li, cam, w, h, key, 0,
                                    vpls=vpls, vlp_index=0),
            ops.trace_camera_plain(scene, cfg, li, cam, w, h, key, 0,
                                   vpls=vpls, vlp_index=0)),
        "ray": protocol(
            ops.trace_pallas(scene, cfg, li, rays, key, 0, vpls=vpls,
                             vlp_index=0),
            path_tracer.trace(scene, cfg, li, rays, key, 0, vpls=vpls,
                              vlp_index=0))}
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    cot = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
    tgt = torch.rand((n, 3), generator=gen, device=device) * 0.5
    grad = _diff_vs_plain(pg.trace_pallas_diff, scene, cfg, li, rays, key,
                          vpls, 0, cot)
    fused = _fused_vs_plain(scene, cfg, li, rays, key, tgt, vpls, 0)
    phase("tape_vs_plain", width=w, height=h, key="threefry seed 0",
          tapes=tapes, results=results, grad_kernel=grad,
          fused_kernel=fused)
    for name, t in tapes.items():
        check(t["same_bits"], f"tape_vs_plain: {name} tape differs between "
                              f"the card and the CPU")
    for name, r in results.items():
        check(r["finite"] and r["bad_frac"] <= MAX_BAD_FRAC,
              f"tape_vs_plain {name}: {r}")
    grad_err = _check_diff("tape_vs_plain grad_kernel", grad)
    check(fused["loss_rel"] <= LOSS_RTOL,
          f"tape_vs_plain fused_kernel: loss off by {fused['loss_rel']:.2e}")
    for k, g in fused["grads"].items():
        check(g["ok"], f"tape_vs_plain fused_kernel: d{k} ({g})")
    return {"trace_err": max(r["max_abs_err"] for r in results.values()),
            "grad_err": grad_err,
            "fused_err": max(g["max_abs_err"]
                             for g in fused["grads"].values())}


def phase_bounce_vs_plain(device) -> dict:
    """The bounce and fact kernels against their plain versions at 64x48,
    depth 7: complex.scn (mix32 and threefry keys) and cornell.scn with
    ``direct_only``. Per depth, one launch against `bounce_plain` on the
    same state; the whole trace against the full-scan plain tracer; two
    traces with the same bits; the facts against the plain collector; and
    on complex.scn the re-walk's gradients from the kernel's facts against
    autograd of the plain tracer."""
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
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as pb
    from gpu_bidirectional_raytracer_tpu_torch.ops import (
        pallas_bounce_grad as pbg,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    w, h, n = SMOKE_W, SMOKE_H, SMOKE_W * SMOKE_H
    cases = {"complex": (COMPLEX, None, False),
             "complex_threefry": (COMPLEX, "threefry", False),
             "cornell_direct_only": (SCENE, None, True)}
    results, errs = {}, {"bounce": 0.0, "aux": 0.0}
    for name, (path, impl, direct_only) in cases.items():
        orig, target, scene = _scene_at(path, device)
        cam = Camera.make(orig, target, w, h, device=device)
        li = static_light_indices(scene)
        cfg = IntegratorConfig()
        key = rng.make_key(0, impl)
        vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)
        rays = progressive.frame_rays(cam, cfg, w, h, key, 0)
        kw = dict(vpls=vpls, vlp_index=0, direct_only=direct_only)
        call = pb.prepare_bounce(scene, cfg, li, key, 0, vpls, 0, n,
                                 direct_only)
        # Every G, both kernels; and a ragged prefix of the lanes (not a
        # multiple of G x block) in the full frame's tape.
        group_calls = {(entry, g): pb.prepare_bounce(
            scene, cfg, li, key, 0, vpls, 0, n, direct_only, entry=entry,
            group=g) for entry in ("bounce_kernel", "aux_kernel")
            for g in ps.GROUP_SIZES}
        n_ragged = n - 13
        ragged = pb.prepare_bounce(scene, cfg, li, key, 0, vpls, 0, n_ragged,
                                   direct_only, lane_offset=0, lane_total=n)
        n_vpl_tab = call.tables[1].shape[0]
        planes = pb.state_planes(rays)
        per_depth, ragged_frac, groups_same = [], [], []
        for depth in range(cfg.max_depth):
            want = pb.bounce_plain(scene, cfg, li, planes, key, 0, depth,
                                   **kw)
            got = planes.clone()
            call.launch(got, depth)
            per_depth.append(float((got == want).all(dim=0).float().mean()))
            outs = {}
            for (entry, g), c in group_calls.items():
                p_ = planes.clone()
                facts = ()
                if entry == "aux_kernel":
                    facts = (torch.empty((n,), dtype=torch.int32,
                                         device=device),
                             torch.empty((len(li), n), dtype=torch.bool,
                                         device=device),
                             torch.empty((max(n_vpl_tab, 1), n),
                                         dtype=torch.bool, device=device))
                    c.launch(p_, depth, (facts[0].data_ptr(),
                                         facts[1].data_ptr(),
                                         facts[2].data_ptr()
                                         if n_vpl_tab else None))
                else:
                    c.launch(p_, depth)
                outs[entry, g] = (p_,) + facts
            first = {e: outs[e, ps.GROUP_SIZES[0]] for e in
                     ("bounce_kernel", "aux_kernel")}
            groups_same.append(torch.equal(first["aux_kernel"][0], got) and all(
                all(torch.equal(a, b) for a, b in zip(v, first[e]))
                for (e, _), v in outs.items()))
            p_ = planes[:, :n_ragged].contiguous()
            ragged.launch(p_, depth)
            want_r = pb.bounce_plain(scene, cfg, li, planes[:, :n_ragged],
                                     key, 0, depth, lane_offset=0,
                                     lane_total=n, **kw)
            ragged_frac.append(float(
                (p_ == want_r).all(dim=0).double().mean())
                if torch.equal(p_, got[:, :n_ragged]) else 0.0)
            planes = want
        got = pb.trace_pallas_bounce(scene, cfg, li, rays, key, 0, **kw)
        again = pb.trace_pallas_bounce(scene, cfg, li, rays, key, 0, **kw)
        ref = path_tracer.trace(scene, cfg, li, rays, key, 0, **kw)
        (hit_k, ol_k, ov_k), rad_k = pbg.trace_bounce_aux(
            scene, cfg, li, rays, key, 0, **kw)
        rad_p, (hit_p, ol_p, ov_p, *_) = path_tracer.trace(
            scene, cfg, li, rays, key, 0, collect_aux=True, **kw)
        torch.cuda.synchronize()

        def mismatch(a, b):
            used = ~a | ~b               # reached, so consumed, in either
            return {"consumed": int(used.sum()),
                    "mismatch_frac": float((a != b)[used].float().mean())
                    if bool(used.any()) else 0.0}

        r = {"scene_spheres": scene.num_spheres, "key": impl or "mix32",
             "direct_only": direct_only, "depth_exact_frac": per_depth,
             "ragged_lanes": n_ragged, "ragged_exact_frac": ragged_frac,
             "groups_same_bits": groups_same,
             "vs_plain": protocol(got, ref),
             "two_traces_same_bits": bool(torch.equal(got, again)),
             "aux_radiance_vs_plain": protocol(rad_k, rad_p),
             "facts": {"hit_mismatch_frac": float(
                 (hit_k != hit_p).float().mean()),
                 "occ_light": mismatch(ol_k, ol_p),
                 "occ_vpl": mismatch(ov_k, ov_p)}}
        if name == "complex":
            gen = torch.Generator(device=device)
            gen.manual_seed(3)
            cot = torch.rand((n, 3), generator=gen, device=device) * 2 - 1
            r["rewalk_grads"] = _diff_vs_plain(
                lambda *a, **k: pbg.trace_bounce_diff(*a, facts="pallas",
                                                      **k),
                scene, cfg, li, rays, key, vpls, 0, cot)
        results[name] = r
    phase("bounce_vs_plain", width=w, height=h, max_depth=7, results=results)
    for name, r in results.items():
        for what in ("vs_plain", "aux_radiance_vs_plain"):
            check(r[what]["finite"] and r[what]["bad_frac"] <= MAX_BAD_FRAC,
                  f"bounce_vs_plain {name} {what}: {r[what]}")
        check(min(r["depth_exact_frac"] + r["ragged_exact_frac"])
              >= 1.0 - MAX_BAD_FRAC,
              f"bounce_vs_plain {name}: depths {r['depth_exact_frac']}, "
              f"ragged {r['ragged_exact_frac']}")
        check(all(r["groups_same_bits"]),
              f"bounce_vs_plain {name}: the G forms differ "
              f"{r['groups_same_bits']}")
        check(r["two_traces_same_bits"],
              f"bounce_vs_plain {name}: two traces differ")
        f = r["facts"]
        check(max(f["hit_mismatch_frac"], f["occ_light"]["mismatch_frac"],
                  f["occ_vpl"]["mismatch_frac"]) <= MAX_BAD_FRAC,
              f"bounce_vs_plain {name}: facts {f}")
        errs["bounce"] = max(errs["bounce"], r["vs_plain"]["max_abs_err"])
        errs["aux"] = max(errs["aux"],
                          r["aux_radiance_vs_plain"]["max_abs_err"])
        if "rewalk_grads" in r:
            errs["aux"] = max(errs["aux"], _check_diff(
                f"bounce_vs_plain {name} re-walk", r["rewalk_grads"]))
    return errs


def phase_complex_path() -> dict:
    """`Renderer` on complex.scn at 512x384 with the default config and
    backend, as a user calls it: the bounce kernel, 7 launches a pass."""
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators import light_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as pb
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    orig, target, scene = _scene_at(COMPLEX)
    cfg = IntegratorConfig()
    w, h, passes = COMPLEX_W, COMPLEX_H, COMPLEX_PASSES

    def renderer(**kw):
        return progressive.Renderer(scene, orig, target, w, h, cfg, seed=0,
                                    **kw)

    r = renderer()
    check(r.backend == "pallas", f"complex.scn resolved to {r.backend}")
    torch.cuda.synchronize()
    ops.reset_launches()
    t = time.perf_counter()
    r.render(passes)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(ops.LAUNCHES)
    check(launches == counts(bounce_kernel=cfg.max_depth * passes),
          f"complex path launches {launches} in {passes} passes")
    img = r.state.colors

    tiled = renderer(tile_rows=COMPLEX_TILE)
    tiled.render(passes)
    tiled_same = bool(torch.equal(tiled.state.colors, img))
    one = renderer()
    one.step()
    plain = renderer(backend="xla", tile_rows=COMPLEX_TILE)
    plain.step()
    torch.cuda.synchronize()
    vs_plain = protocol(one.state.colors, plain.state.colors)
    del tiled, plain, one

    nonzero = float((img.amax(dim=-1) > 0).float().mean())
    mean = float(img.mean())
    ms_pass = cuda_ms(r.step, reps=10, warmup=2)
    st = r.state
    li = r.light_idx
    vpls, vi = progressive.vpl_update(scene, st, cfg, li)
    rays = progressive.frame_rays(r.camera, cfg, w, h, st.key, st.sample)
    call = pb.prepare_bounce(scene, cfg, li, st.key, st.sample, vpls, vi,
                             w * h)
    planes = pb.state_planes(rays)

    def bounce_pass():
        p = planes.clone()
        for depth in range(cfg.max_depth):
            call.launch(p, depth)

    breakdown = {
        "light_pass": cuda_ms(lambda: light_tracer.trace_light_paths(
            scene, cfg, li, st.key, st.sample), reps=5),
        "frame_rays": cuda_ms(lambda: progressive.frame_rays(
            r.camera, cfg, w, h, st.key, st.sample), reps=10),
        "bounce_kernels_7": cuda_ms(bounce_pass, reps=10),
    }
    phase("complex_path", width=w, height=h, spheres=scene.num_spheres,
          passes=passes, launches=launches, wall_s=round(wall, 4),
          mean=mean, nonzero_frac=nonzero, tiled_96_same_bits=tiled_same,
          vs_plain_one_pass=vs_plain, ms_per_pass=ms_pass,
          rays_per_s=w * h / (ms_pass / 1e3), breakdown_ms=breakdown)
    check(vs_plain["finite"] and bool(torch.isfinite(img).all()),
          "complex path: non-finite pixels")
    check(mean > 0.0, "complex path: black image")
    # complex.scn leaves much of the frame to the background: 40% of a
    # 64x48 frame was lit after 4 plain passes on the CPU.
    check(nonzero >= 0.25, f"complex path: only {nonzero:.1%} pixels lit")
    check(tiled_same, "complex path: 96-row bands differ from one band")
    check(vs_plain["bad_frac"] <= MAX_BAD_FRAC,
          f"complex path vs plain: {vs_plain['bad_frac']:.3%} bad pixels")
    return {"launches": launches, "renderer": r,
            "max_abs_err": vs_plain["max_abs_err"], "ms_per_pass": ms_pass}


def phase_complex_train() -> dict:
    """`render_loss_grad(backend="pallas")` on complex.scn at 512x384,
    l2 against a black target, spp 1: the fact kernel (7 launches a
    step) and the re-walk under autograd. Against plain: the whole step
    against `backend="xla"` (plain full-scan autograd) at 128x96, and at
    512x384 the re-walk from the kernel's facts against the re-walk from
    the plain collector's."""
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.integrators import (
        light_tracer,
        path_tracer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import (
        pallas_bounce_grad as pbg,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    orig, target, scene = _scene_at(COMPLEX)
    cfg = IntegratorConfig()
    w, h, n = COMPLEX_W, COMPLEX_H, COMPLEX_W * COMPLEX_H
    cam = Camera.make(orig, target, w, h)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    black = torch.zeros((h, w, 3), dtype=torch.float32, device=scene.device)

    def step(i):
        return G.render_loss_grad(scene, cam, rng.fold_in(key, i), black,
                                  cfg, w, h, li, spp=1, loss="l2",
                                  backend="pallas")

    step(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(COMPLEX_STEPS):
        loss_v, g = step(1 + i)
    stop.record()
    torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    ms_step = start.elapsed_time(stop) / COMPLEX_STEPS
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(launches == counts(aux_kernel=cfg.max_depth * COMPLEX_STEPS),
          f"complex training launches {launches} in {COMPLEX_STEPS} steps")
    check(bool(torch.isfinite(loss_v)) and all(
        bool(torch.isfinite(getattr(g, k)).all())
        for k in ("p", "rad", "e", "c")), "complex training: non-finite")

    params = ("p", "rad", "e", "c")
    gw, gh = COMPLEX_GRAD_W, COMPLEX_GRAD_H
    gcam = Camera.make(orig, target, gw, gh)
    gblack = torch.zeros((gh, gw, 3), dtype=torch.float32,
                         device=scene.device)
    lk, gk = G.render_loss_grad(scene, gcam, key, gblack, cfg, gw, gh, li,
                                1, "l2", "pallas")
    lp, gp = G.render_loss_grad(scene, gcam, key, gblack, cfg, gw, gh, li,
                                1, "l2", "xla")
    torch.cuda.synchronize()
    vs_plain = {f"step_{gw}x{gh}": {
        "loss_rel": abs(float(lk) - float(lp)) / abs(float(lp)),
        "grads": {k: grad_check(getattr(gk, k), getattr(gp, k))
                  for k in params}}}
    del gk, gp

    rays = progressive.frame_rays(cam, cfg, w, h, key, 0)
    vpls = light_tracer.trace_light_paths(scene, cfg, li, key, 0)

    def rewalk(facts):
        with torch.enable_grad():
            sc, vb, sl, vl = pg.param_leaves(scene, vpls)
            rad = pbg.trace_bounce_diff(sc, cfg, li, rays, key, 0, vpls=vb,
                                        vlp_index=0, facts=facts)
            value = pg.l2_loss(rad, 0.0 * rad.detach())
            return value.detach(), torch.autograd.grad(value, sl + vl)

    vk, rk = rewalk("pallas")
    vp, rp = rewalk("xla")
    torch.cuda.synchronize()
    vs_plain[f"rewalk_{w}x{h}"] = {
        "loss_rel": abs(float(vk) - float(vp)) / abs(float(vp)),
        "grads": {k: grad_check(a, b)
                  for k, a, b in zip(_grad_names(vpls), rk, rp)}}
    vs_plain["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del rk, rp
    torch.cuda.empty_cache()

    def rewalk_fwd_bwd():
        aux, _ = pbg.trace_bounce_aux(scene, cfg, li, rays, key, 0,
                                      vpls=vpls, vlp_index=0)
        torch.cuda.synchronize()
        with torch.enable_grad():
            sc, vb, sl, vl = pg.param_leaves(scene, vpls)
            rad = path_tracer.trace(sc, cfg, li, rays, key, 0, vpls=vb,
                                    vlp_index=0, aux=aux)
            torch.autograd.grad(rad.square().mean(), sl + vl)

    breakdown = {
        "light_forward": cuda_ms(lambda: light_tracer.trace_light_paths(
            scene, cfg, li, key, 0), reps=5),
        "facts_aux_kernels_7": cuda_ms(lambda: pbg.trace_bounce_aux(
            scene, cfg, li, rays, key, 0, vpls=vpls, vlp_index=0), reps=5),
        "facts_then_rewalk_fwd_bwd": cuda_ms(rewalk_fwd_bwd, reps=3),
    }
    phase("complex_train", width=w, height=h, spheres=scene.num_spheres,
          steps=COMPLEX_STEPS, launches=launches, ms_per_step=ms_step,
          rays_per_s=n / (ms_step / 1e3), loss=float(loss_v),
          peak_gib=peak_gib, breakdown_ms=breakdown, vs_plain=vs_plain)
    worst = 0.0
    for what, r in vs_plain.items():
        if what == "peak_gib":
            continue
        check(r["loss_rel"] <= LOSS_RTOL,
              f"complex training {what}: loss off by {r['loss_rel']:.2e}")
        for k, gr in r["grads"].items():
            check(gr["ok"], f"complex training {what}: d{k} outside the "
                            f"tolerance ({gr})")
            worst = max(worst, gr["max_abs_err"])
    return {"launches": launches, "max_abs_err": worst,
            "scene": scene, "cam": cam, "cfg": cfg, "li": li, "key": key,
            "rays": rays, "vpls": vpls}


def _record_scans(fn, plain: bool):
    """``(fn(), calls)``: the inputs of every scan-kernel wrapper call
    that ``fn`` makes, each ``(kind, args, vacuum)``, cloned. The scans
    themselves run through the plain versions (``plain``) or the
    kernels."""
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps

    calls = []
    near, anyhit = ps.nearest_tiles, ps.anyhit_tiles

    def record_near(scene, o, d, alive):
        calls.append(("nearest", (o.clone(), d.clone(), alive.clone()),
                      False))
        return (ps.nearest_plain if plain else near)(scene, o, d, alive)

    def record_anyhit(scene, o, d, maxt, active, vacuum=False):
        calls.append(("anyhit", (o.clone(), d.clone(), maxt.clone(),
                                 active.clone()), vacuum))
        return (ps.anyhit_plain if plain else anyhit)(scene, o, d, maxt,
                                                      active, vacuum)

    ps.nearest_tiles, ps.anyhit_tiles = record_near, record_anyhit
    try:
        out = fn()
    finally:
        ps.nearest_tiles, ps.anyhit_tiles = near, anyhit
    return out, calls


def _scan_pair(scene, kind: str, args: tuple, vacuum: bool,
               lanes: int | None = None):
    """A scan kernel's outputs and its plain version's on one recorded
    call (on its first ``lanes`` lanes)."""
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps

    if lanes is not None:
        args = tuple(a[:lanes] for a in args)
    if kind == "nearest":
        return ps.nearest_tiles(scene, *args), ps.nearest_plain(scene, *args)
    return ((ps.anyhit_tiles(scene, *args, vacuum=vacuum),),
            (ps.anyhit_plain(scene, *args, vacuum),))


def _same_bits(got, want) -> tuple[bool, float]:
    """Whether every output is equal bit for bit, and the largest
    |difference| over them."""
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    err = max(float((a.double() - b.double()).abs().max()) if a.numel()
              else 0.0 for a, b in zip(got, want))
    return same, err


def phase_scan_vs_plain(device) -> dict:
    """The scan kernels against their plain versions at 64x48, depth 7:
    complex.scn (mix32 and threefry keys) and cornell.scn, with VPLs.
    Every scan of a plain trace of the scan route, with the live, dead
    and skipped lanes each depth leaves, goes to the kernel and the plain
    version (all lanes, and a ragged prefix); two launches on the same
    inputs; the whole trace through the kernels against the full-scan
    plain tracer; compaction against none."""
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
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    w, h = SMOKE_W, SMOKE_H
    cases = {"complex": (COMPLEX, None), "complex_threefry": (COMPLEX,
                                                              "threefry"),
             "cornell": (SCENE, None)}
    results, errs = {}, {"nearest": 0.0, "anyhit": 0.0}
    for name, (path, impl) in cases.items():
        orig, target, scene = _scene_at(path, device)
        cam = Camera.make(orig, target, w, h, device=device)
        li = static_light_indices(scene)
        cfg = IntegratorConfig()
        key = rng.make_key(0, impl)
        kw = dict(vpls=light_tracer.trace_light_paths(scene, cfg, li, key, 0),
                  vlp_index=0)
        rays = progressive.frame_rays(cam, cfg, w, h, key, 0)

        def trace(**more):
            return path_tracer.trace(scene, cfg, li, rays, key, 0, **kw,
                                     **more)

        plain_route, calls = _record_scans(
            lambda: trace(scan_backend="pallas"), plain=True)
        per_call = []
        for kind, args, vacuum in calls:
            full = _same_bits(*_scan_pair(scene, kind, args, vacuum))
            ragged = _same_bits(*_scan_pair(scene, kind, args, vacuum,
                                            args[0].shape[0] - 13))
            # Every G against the plain version, on every lane.
            if kind == "anyhit":
                want = ps.anyhit_plain(scene, *args, vacuum)
                groups = all(torch.equal(ps.prepare_anyhit(
                    scene, *args, vacuum, group=g)()[0], want)
                    for g in ps.GROUP_SIZES)
            else:
                want = ps.nearest_plain(scene, *args)
                groups = all(_same_bits((
                    t < 1e20, t, i, a[0:3].T, a[3:6].T, a[6:9].T, r), want)[0]
                    for g in ps.GROUP_SIZES
                    for t, i, a, r in [ps.prepare_nearest(scene, *args,
                                                          group=g)()])
            per_call.append({
                "kind": kind + ("_vacuum" if vacuum else ""),
                "lanes": args[0].shape[0],
                "live_frac": float(args[-1].float().mean()),
                "same_bits": full[0] and ragged[0] and groups,
                "max_abs_err": max(full[1], ragged[1])})
            errs[kind] = max(errs[kind], full[1], ragged[1])
        twice = {}
        for kind, args, vacuum in calls[3:6]:      # depth 1: mixed lanes
            a = _scan_pair(scene, kind, args, vacuum)[0]
            b = _scan_pair(scene, kind, args, vacuum)[0]
            twice[kind + ("_vacuum" if vacuum else "")] = _same_bits(a, b)[0]
        got = trace(scan_backend="pallas")
        compact = trace(scan_backend="pallas", scan_compact=True)
        ref = trace()
        torch.cuda.synchronize()
        results[name] = {
            "scene_spheres": scene.num_spheres, "key": impl or "mix32",
            "scan_calls": len(calls), "calls": per_call,
            "two_launches_same_bits": twice,
            "vs_plain": protocol(got, ref),
            "kernel_route_equals_plain_route": bool(torch.equal(
                got, plain_route)),
            "compact_same_bits": bool(torch.equal(got, compact))}
    phase("scan_vs_plain", width=w, height=h, max_depth=7, results=results)
    for name, r in results.items():
        check(r["scan_calls"] == 21, f"scan_vs_plain {name}: "
                                     f"{r['scan_calls']} scans, not 21")
        bad = [c for c in r["calls"] if not c["same_bits"]]
        check(not bad, f"scan_vs_plain {name}: kernel and plain differ {bad}")
        check(all(r["two_launches_same_bits"].values()),
              f"scan_vs_plain {name}: two launches differ")
        check(r["vs_plain"]["finite"]
              and r["vs_plain"]["bad_frac"] <= MAX_BAD_FRAC,
              f"scan_vs_plain {name}: {r['vs_plain']}")
        check(r["kernel_route_equals_plain_route"],
              f"scan_vs_plain {name}: the kernels' trace differs from the "
              f"plain route's")
        check(r["compact_same_bits"],
              f"scan_vs_plain {name}: compaction changed the radiance")
        for kind in errs:
            errs[kind] = max(errs[kind], r["vs_plain"]["max_abs_err"])
    return errs


def _scan_rig():
    """complex.scn at 512x384 as tools/bench_complex.py runs it:
    ``(scene, cfg, li, key, inputs)``, ``inputs(s)`` the rays and VPLs of
    sample ``s`` (jittered camera rays; the light subpaths of the
    sample)."""
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

    orig, target, scene = _scene_at(COMPLEX)
    cfg = IntegratorConfig()
    w, h, n = COMPLEX_W, COMPLEX_H, COMPLEX_W * COMPLEX_H
    cam = Camera.make(orig, target, w, h, device=scene.device)
    li = static_light_indices(scene)
    key = rng.make_key(0)
    px, py = cam_mod.pixel_grid(w, h, device=scene.device)

    def inputs(s):
        u = rng.site_uniforms(key, s, 0, rng.CAM_JITTER, 2, n,
                              device=scene.device)
        return (cam_mod.primary_rays(cam, w, h, u[0], u[1], px, py),
                light_tracer.trace_light_paths(scene, cfg, li, key, s))

    return scene, cfg, li, key, inputs


def phase_scan_path() -> dict:
    """The per-bounce scan route at complex.scn 512x384 with
    ``IntegratorConfig()``: `path_tracer.trace(scan_backend="pallas")`,
    ``SCAN_SAMPLES`` samples without and with compaction (7
    ``nearest_kernel`` and 14 ``anyhit_kernel`` launches a sample and
    nothing else), ms per sample; sample 0 against the bounce route and
    the plain tracer, and the matmul form against the direct one."""
    from gpu_bidirectional_raytracer_tpu_torch.integrators import (
        light_tracer,
        path_tracer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as pb
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    scene, cfg, li, key, inputs = _scan_rig()
    n = COMPLEX_W * COMPLEX_H

    def render(tracer, **kw):
        acc = torch.zeros((n, 3), dtype=torch.float32, device=scene.device)
        for s in range(SCAN_SAMPLES):
            rays, vpls = inputs(s)
            acc = acc + tracer(scene, cfg, li, rays, key, s, vpls=vpls,
                               vlp_index=0, **kw)
        return acc / SCAN_SAMPLES

    def timed(tracer, **kw):
        torch.cuda.synchronize()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        img = render(tracer, **kw)
        stop.record()
        torch.cuda.synchronize()
        return (img, start.elapsed_time(stop) / SCAN_SAMPLES,
                dict(ops.LAUNCHES))

    rays, vpls = inputs(0)
    kw0 = dict(vpls=vpls, vlp_index=0)
    path_tracer.trace(scene, cfg, li, rays, key, 0, scan_backend="pallas",
                      **kw0)                                    # warm-up
    runs = {c: timed(path_tracer.trace, scan_backend="pallas",
                     scan_compact=c) for c in (False, True)}
    img, ms, launches = runs[False]
    pb.trace_pallas_bounce(scene, cfg, li, rays, key, 0, **kw0)  # warm-up
    _, ms_bounce, _ = timed(pb.trace_pallas_bounce)
    per_sample = {"nearest_kernel": cfg.max_depth * SCAN_SAMPLES,
                  "anyhit_kernel": 2 * cfg.max_depth * SCAN_SAMPLES}

    # Sample 0 through the three routes that share its estimator and tape,
    # and through the matmul form of the plain tracer.
    scan0 = path_tracer.trace(scene, cfg, li, rays, key, 0,
                              scan_backend="pallas", **kw0)
    with torch.no_grad():
        bounce0 = pb.trace_pallas_bounce(scene, cfg, li, rays, key, 0, **kw0)
        plain0 = path_tracer.trace(scene, cfg, li, rays, key, 0, **kw0)
        mxu0 = path_tracer.trace(scene, cfg, li, rays, key, 0,
                                 scan_backend="mxu", **kw0)
    torch.cuda.synchronize()
    flips = float((~torch.isclose(mxu0, plain0, rtol=1e-3, atol=1e-4))
                  .any(dim=-1).float().mean())
    energy = abs(float(mxu0.mean()) - float(plain0.mean())) / float(
        plain0.mean())
    breakdown = {"light_pass": cuda_ms(
        lambda: light_tracer.trace_light_paths(scene, cfg, li, key, 0),
        reps=5)}
    nonzero = float((img.amax(dim=-1) > 0).float().mean())
    out = {"ms_per_sample": ms, "ms_per_sample_compact": runs[True][1],
           "ms_per_sample_bounce_route": ms_bounce,
           "launches": launches, "launches_compact": runs[True][2],
           "mean": float(img.mean()), "nonzero_frac": nonzero,
           "compact_same_bits": bool(torch.equal(runs[True][0], img)),
           "sample0_vs_bounce": protocol(scan0, bounce0),
           "sample0_vs_plain": protocol(scan0, plain0),
           "mxu_vs_xla": {"energy_rel": energy, "flip_frac": flips}}
    phase("scan_path", width=COMPLEX_W, height=COMPLEX_H,
          spheres=scene.num_spheres, samples=SCAN_SAMPLES,
          breakdown_ms=breakdown, **out)
    for what in ("launches", "launches_compact"):
        check(out[what] == counts(**per_sample),
              f"scan path {what} {out[what]} in {SCAN_SAMPLES} samples")
    check(bool(torch.isfinite(img).all()), "scan path: non-finite pixels")
    check(out["mean"] > 0.0, "scan path: black image")
    check(out["compact_same_bits"], "scan path: compaction changed the image")
    for what in ("sample0_vs_bounce", "sample0_vs_plain"):
        check(out[what]["finite"] and out[what]["bad_frac"] <= MAX_BAD_FRAC,
              f"scan path {what}: {out[what]}")
    check(energy <= MXU_ENERGY and flips < MXU_FLIPS,
          f"scan path: mxu against xla {out['mxu_vs_xla']}")
    return {**out, "max_abs_err": max(out["sample0_vs_bounce"]["max_abs_err"],
                                      out["sample0_vs_plain"]["max_abs_err"]),
            "scene": scene, "cfg": cfg, "li": li, "key": key,
            "inputs0": (rays, vpls)}


def _mxu_test_scene(device):
    """tests/test_mxu.py's scene: 80 diffuse spheres placed from numpy
    seed 42, the first an emitter; its camera looks from (0, 10, 120)."""
    import numpy as np

    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        scene_from_arrays,
    )

    r = np.random.default_rng(42)
    rad = r.uniform(1.0, 6.0, 80).astype(np.float32)
    p = r.uniform(-40, 40, (80, 3)).astype(np.float32)
    c = r.uniform(0.1, 0.9, (80, 3)).astype(np.float32)
    e = np.zeros((80, 3), np.float32)
    e[0], c[0] = 15.0, 0.0
    return ((0.0, 10.0, 120.0), (0.0, 0.0, 0.0),
            scene_from_arrays(rad, p, e, c, np.zeros(80, np.int32),
                              device=device))


def _cosines(ga, gb, params) -> dict:
    return {k: float((getattr(ga, k) * getattr(gb, k)).sum()
                     / (getattr(ga, k).norm() * getattr(gb, k).norm()))
            for k in params}


def phase_mxu_train() -> dict:
    """`render_loss_grad(backend="mxu")` at complex.scn 512x384, l2
    against black, spp 1: every sphere scan in matmul form, each depth
    checkpointed. ``MXU_STEPS`` steps, ms per step and peak memory; the
    same with ``backend="xla"`` (the direct form) on the same keys. At
    128x96 the two against each other under tests/test_mxu.py's bounds,
    on that file's 80-sphere scene (every bound) and on complex.scn (the
    loss and the e and c gradients; there the p and rad gradients come
    from a few grazing paths whose roots the two forms round apart, and
    are reported)."""
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops

    scene, cfg, li, key, _ = _scan_rig()
    dev = scene.device
    orig, target, _ = _scene_at(COMPLEX, dev)
    params = ("p", "rad", "e", "c")

    def step(sc, cam_at, w, h, k, backend, config=cfg):
        cam = Camera.make(*cam_at, w, h, device=dev)
        black = torch.zeros((h, w, 3), dtype=torch.float32, device=dev)
        return G.render_loss_grad(sc, cam, k, black, config, w, h,
                                  static_light_indices(sc), spp=1,
                                  loss="l2", backend=backend)

    gw, gh = COMPLEX_GRAD_W, COMPLEX_GRAD_H
    m_orig, m_target, m_scene = _mxu_test_scene(dev)
    small = {}
    for name, sc, cam_at, config in (
            ("complex", scene, (orig, target), cfg),
            ("test_mxu_80", m_scene, (m_orig, m_target),
             IntegratorConfig.cpu_golden())):
        (lm, gm), (lx, gx) = (step(sc, cam_at, gw, gh, key, b, config)
                              for b in ("mxu", "xla"))
        small[name] = {"loss_rel": abs(float(lm) - float(lx))
                       / abs(float(lx)),
                       "cosine": _cosines(gm, gx, params)}
    steps = {}
    for backend in ("mxu", "xla"):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(MXU_STEPS):
            loss_v, g = step(scene, (orig, target), COMPLEX_W, COMPLEX_H,
                             rng.fold_in(key, 1 + i), backend)
        stop.record()
        torch.cuda.synchronize()
        steps[backend] = {
            "ms_per_step": start.elapsed_time(stop) / MXU_STEPS,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "loss": float(loss_v), "launches": dict(ops.LAUNCHES),
            "finite": bool(torch.isfinite(loss_v)) and all(
                bool(torch.isfinite(getattr(g, k)).all()) for k in params),
            "grads": g}
    full = _cosines(steps["mxu"].pop("grads"), steps["xla"].pop("grads"),
                    params)
    torch.cuda.empty_cache()
    phase("mxu_train", width=COMPLEX_W, height=COMPLEX_H,
          spheres=scene.num_spheres, steps=MXU_STEPS, **steps,
          mxu_vs_xla_cosine_full_size=full,
          **{f"mxu_vs_xla_{gw}x{gh}": small})
    for backend, r in steps.items():
        check(r["finite"], f"mxu_train {backend}: non-finite")
        check(r["launches"] == counts(),
              f"mxu_train {backend}: launched {r['launches']}")
    for name, r in small.items():
        gated = params if name == "test_mxu_80" else ("e", "c")
        check(r["loss_rel"] <= MXU_LOSS_RTOL
              and min(r["cosine"][k] for k in gated) > MXU_COS,
              f"mxu_train: mxu against xla on {name} at {gw}x{gh} {r}")
    return steps


def _scan_rows(svp: dict, spath: dict) -> list:
    """The rows of the two scan kernels at complex.scn's 512x384, sample
    0 of the scan path: per launch, at each depth's real inputs, without
    and with compaction. Their work is what the scans must do for live
    lanes: S roots per extension segment, and the roots of each cast
    shadow ray up to its first blocker (`path_tracer.trace` with_stats,
    in bands of 96 rows); their bytes each input read once and each
    output written once."""
    from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps

    scene, cfg, li, key = (spath["scene"], spath["cfg"], spath["li"],
                           spath["key"])
    rays, vpls = spath["inputs0"]
    kw = dict(vpls=vpls, vlp_index=0)
    n, depths = rays.o.shape[0], cfg.max_depth

    def mean(xs):
        return sum(xs) / len(xs)

    calls, ms = {}, {}
    for compact in (False, True):
        _, calls[compact] = _record_scans(lambda: path_tracer.trace(
            scene, cfg, li, rays, key, 0, scan_backend="pallas",
            scan_compact=compact, **kw), plain=False)
        ms[compact] = {"nearest": [], "anyhit": [], "anyhit_vacuum": []}
        for kind, args, vacuum in calls[compact]:
            launch = (ps.prepare_nearest(scene, *args) if kind == "nearest"
                      else ps.prepare_anyhit(scene, *args, vacuum))
            ms[compact][kind + ("_vacuum" if vacuum else "")].append(
                device_ms(launch, 20, kind + "_kernel"))
    live = {"nearest": [], "anyhit": [], "anyhit_vacuum": []}
    plain_ms = {"nearest": [], "anyhit": []}
    group_ms = {g: {"shadow": [], "vacuum": []} for g in ps.GROUP_SIZES}
    near_group_ms = {g: [] for g in ps.GROUP_SIZES}
    near_event_ms = []
    idle_ms = {}     # a launch with no active segment, each mode
    block_ms = {b: [] for b in ANYHIT_BLOCKS}
    for kind, args, vacuum in calls[False]:
        if kind == "nearest":
            for g in ps.GROUP_SIZES:
                near_group_ms[g].append(device_ms(ps.prepare_nearest(
                    scene, *args, group=g), 5, "nearest_kernel"))
            near_event_ms.append(cuda_ms(ps.prepare_nearest(scene, *args),
                                         reps=20))
            if "nearest" not in idle_ms:   # no live lane
                idle_ms["nearest"] = device_ms(ps.prepare_nearest(
                    scene, *args[:2], torch.zeros_like(args[2])), 20,
                    "nearest_kernel")
        if kind == "anyhit":
            for b in ANYHIT_BLOCKS:
                block_ms[b].append(device_ms(ps.prepare_anyhit(
                    scene, *args, vacuum, block=b), 20, "anyhit_kernel"))
        if kind == "anyhit" and vacuum not in idle_ms:
            idle = args[:3] + (torch.zeros_like(args[3]),)
            idle_ms[vacuum] = device_ms(
                ps.prepare_anyhit(scene, *idle, vacuum), 20, "anyhit_kernel")
        if kind == "anyhit":
            for g in ps.GROUP_SIZES:
                group_ms[g]["vacuum" if vacuum else "shadow"].append(
                    device_ms(ps.prepare_anyhit(scene, *args, vacuum,
                                                group=g), 20,
                              "anyhit_kernel"))
        live[kind + ("_vacuum" if vacuum else "")].append(
            float(args[-1].float().mean()))
        plain_ms[kind].append(cuda_ms(
            lambda: ps.nearest_plain(scene, *args) if kind == "nearest"
            else ps.anyhit_plain(scene, *args, vacuum), reps=1, warmup=1))
    stats = {}
    band = COMPLEX_TILE * COMPLEX_W
    for lo in range(0, n, band):
        _, s_ = path_tracer.trace(
            scene, cfg, li, Rays(o=rays.o[lo:lo + band],
                                 d=rays.d[lo:lo + band]),
            key, 0, lane_offset=lo, lane_total=n, with_stats=True, **kw)
        stats = {k: stats.get(k, 0) + v for k, v in s_.items()}
    s = scene.num_spheres
    n_vpl = cfg.vpl_depth * cfg.max_vlp if cfg.use_vpl else 0
    near_ops = stats["extension_segments"] * s * OPS_ROOT // depths
    near_bytes = (25 + 48) * n
    any_ops = stats["shadow_tests"] * OPS_ROOT // (2 * depths)
    any_bytes = 30 * n * (len(li) + n_vpl) // 2
    src = "gpu_bidirectional_raytracer_tpu_torch/csrc/scan_kernel.cu"
    any_ms = {c: ms[c]["anyhit"] + ms[c]["anyhit_vacuum"] for c in ms}
    near_res = ps.nearest_resources(scene)
    return [{
        "name": "nearest_kernel",
        "route": "cuda",
        "source": src,
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_scan.py:67",
        "launches": spath["launches"]["nearest_kernel"],
        "max_abs_err": max(svp["nearest"], spath["max_abs_err"]),
        "ms": mean(ms[False]["nearest"]),
        "plain_ms": mean(plain_ms["nearest"]),
        **_bound(near_ops, near_bytes),
        "library_ms": None,
        "ms_per_depth": ms[False]["nearest"],
        "ms_compacted": mean(ms[True]["nearest"]),
        "ms_compacted_per_depth": ms[True]["nearest"],
        "event_ms": mean(near_event_ms),
        "live_frac_per_depth": live["nearest"],
        "group": ps.group_size(scene.num_spheres, ps.PER_LANE),
        "group_ms": near_group_ms,
        "idle_ms": idle_ms["nearest"],
        "resources": near_res,
        "blocks_per_sm": near_res["blocks_per_sm"],
        "work": {"extension_segments": stats["extension_segments"],
                 "spheres": s, "fp32_ops_per_launch": near_ops,
                 "bytes": near_bytes,
                 "per_launch": "the mean of the 7 depths of a sample"},
    }, {
        "name": "anyhit_kernel",
        "route": "cuda",
        "source": src,
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_scan.py:109",
        "launches": spath["launches"]["anyhit_kernel"],
        "max_abs_err": max(svp["anyhit"], spath["max_abs_err"]),
        "ms": mean(any_ms[False]),
        "plain_ms": mean(plain_ms["anyhit"]),
        **_bound(any_ops, any_bytes),
        "library_ms": None,
        "ms_per_depth": {"shadow": ms[False]["anyhit"],
                         "vacuum": ms[False]["anyhit_vacuum"]},
        "ms_compacted": mean(any_ms[True]),
        "ms_compacted_per_depth": {"shadow": ms[True]["anyhit"],
                                   "vacuum": ms[True]["anyhit_vacuum"]},
        "group": ps.group_size(scene.num_spheres, ps.ANYHIT_PER_LANE),
        "block_ms": block_ms,
        "group_ms": group_ms,
        "idle_ms": {"shadow": idle_ms[False], "vacuum": idle_ms[True]},
        "resources": {mode: ps.anyhit_resources(scene, vac)
                      for mode, vac in (("shadow", False),
                                        ("vacuum", True))},
        "active_frac_per_depth": {"shadow": live["anyhit"],
                                  "vacuum": live["anyhit_vacuum"]},
        "work": {"shadow_tests": stats["shadow_tests"],
                 "shadow_rays": stats["shadow_rays"],
                 "fp32_ops_per_launch": any_ops, "bytes": any_bytes,
                 "per_launch": "the mean of the 14 launches of a sample"},
    }]



def _forward_ops(stats: dict, s: int) -> int:
    """FP32 operations of the eye-path work in ``stats`` (path_tracer.trace
    with_stats=True), as the eye-path kernel does it."""
    return ((stats["extension_segments"] * s + stats["shadow_tests"])
            * OPS_ROOT
            + stats["hit_segments"] * OPS_SEGMENT
            + stats["shadow_setups"] * OPS_SHADOW_SETUP
            + stats["diffuse_vertices"] * OPS_SCATTER)


def _bound(ops_total: int, bytes_total: int) -> dict:
    t_ops = ops_total / PEAK_FP32_FLOPS * 1e3
    t_bytes = bytes_total / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def phase_kernels(main: dict, train: dict, max_abs_err: float,
                  grad_err: float, device, tape_res: dict, bounce: dict,
                  cpath: dict, ctrain: dict, scan: dict,
                  spath: dict, carrier_err: dict, carrier: dict) -> None:
    """Per-kernel line: times at the main paths' shapes and the bounds."""
    from gpu_bidirectional_raytracer_tpu_torch import camera as cam_mod
    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_grad as pg
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace as ops
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    r = main["renderer"]
    scene, cfg, li = r.scene, r.cfg, r.light_idx
    w, h, n = r.width, r.height, r.width * r.height
    state = r.state
    vpls, vi = progressive.vpl_update(scene, state, cfg, li)
    args = (scene, cfg, li, r.camera, w, h, state.key, state.sample)
    kw = dict(vpls=vpls, vlp_index=vi)
    # The kernel alone: tables built once, launched 30 times (device time,
    # and CUDA events around the launches), and at each block size with
    # its resident blocks per SM.
    ms = device_ms(ops.prepare_camera_launch(*args, **kw), 30, "trace_kernel")
    event_ms = cuda_ms(ops.prepare_camera_launch(*args, **kw), reps=30)
    block_ms = {b: device_ms(ops.prepare_camera_launch(*args, **kw, block=b),
                             10, "trace_kernel") for b in TRACE_BLOCKS}
    tabs = ops.launch_tables(scene, cfg, li, state.key, state.sample, vpls,
                             vi, n, cam_jitter=True)
    trace_res = {b: ops.trace_resources(*tabs, len(li), b)
                 for b in TRACE_BLOCKS}
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
    ops_total = _forward_ops(stats, s)
    k_rows = 2 + cfg.max_depth * (2 * max(len(li), 1) + 3)
    tables_bytes = 4 * 16 * (s + n_vpl) + 4 * len(li)
    bytes_total = tables_bytes + 16 * k_rows + 4 * 32 + 12 * n
    rows = [{
        "name": "trace_kernel",
        "route": "cuda",
        "source": "gpu_bidirectional_raytracer_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_trace.py:443",
        "launches": main["launches"]["trace_kernel"],
        "max_abs_err": max(max_abs_err, main["max_abs_err"],
                           tape_res["trace_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        **_bound(ops_total, bytes_total),
        "library_ms": None,
        "event_ms": event_ms,
        "block": ops.BLOCK,
        "block_ms": block_ms,
        "blocks_per_sm": trace_res[ops.BLOCK]["blocks_per_sm"],
        "resources": trace_res,
        "work": {**stats, "fp32_ops": ops_total, "bytes": bytes_total},
    }]

    # The adjoint kernels at the training path's shapes: 512x512, sample 0
    # of the mix32 seed-0 key, the VPLs of that sample.
    t = train
    scene, cfg, li, key, rays_t = (t["scene"], t["cfg"], t["li"], t["key"],
                                   t["rays"])
    vpls_t = t["vpls"]
    scene_tab, vpl_tab, tape = t["tables"]
    n = rays_t.o.shape[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    cot = torch.rand((n, 3), generator=gen, device=device) * 2.0 - 1.0
    black = torch.zeros((n, 3), dtype=torch.float32, device=device)
    grad_ms = cuda_ms(lambda: pg.grad_launch(scene_tab, vpl_tab, tape, cfg,
                                             li, rays_t, cot),
                      reps=20)
    fused_ms = cuda_ms(lambda: pg.fused_launch(scene_tab, vpl_tab, tape,
                                               cfg, li, rays_t,
                                               black, "l2"), reps=20)

    def grad_plain():
        with torch.enable_grad():
            sc, vb, sl, vl = pg.param_leaves(scene, vpls_t)
            rad = pg.trace_diff_plain(sc, cfg, li, rays_t, key, 0, vpls=vb,
                                      vlp_index=0)
            return torch.autograd.grad((rad * cot).sum(), sl + vl)

    # With the visibility carrier: the kVis instantiations on the same
    # tables, their work counted by the plain tracer with the carrier on.
    vis_cfg = dataclasses.replace(cfg, vis_grad_tau=VIS_TAU)
    vis_grad_ms = cuda_ms(lambda: pg.grad_launch(
        scene_tab, vpl_tab, tape, vis_cfg, li, rays_t, cot), reps=10)
    vis_fused_ms = cuda_ms(lambda: pg.fused_launch(
        scene_tab, vpl_tab, tape, vis_cfg, li, rays_t, black, "l2"),
        reps=10)
    _, st_vis = path_tracer.trace(scene, vis_cfg, li, rays_t, key, 0,
                                  vpls=vpls_t, vlp_index=0, with_stats=True)
    grad_plain_ms = cuda_ms(grad_plain, reps=3, warmup=1)
    fused_plain_ms = cuda_ms(lambda: pg.loss_grad_plain(
        scene, cfg, li, rays_t, key, 0, black, vpls=vpls_t, vlp_index=0),
        reps=3, warmup=1)
    _, st = path_tracer.trace(scene, cfg, li, rays_t, key, 0, vpls=vpls_t,
                              vlp_index=0, with_stats=True)
    adj_ops = (_forward_ops(st, s) + st["hit_segments"] * OPS_SEGMENT_ADJ
               + st["diffuse_vertices"] * OPS_SCATTER_ADJ
               + st["shadow_lit"] * OPS_SHADOW_ADJ)
    n_blocks = (n + pg.BLOCK - 1) // pg.BLOCK
    k_rows = cfg.max_depth * (2 * max(len(li), 1) + 3)
    partial_bytes = 4 * 16 * n_blocks * (s + max(n_vpl, 1))
    common_bytes = tables_bytes + 16 * k_rows + 24 * n + partial_bytes
    grad_bytes = common_bytes + 12 * n + 24 * n      # cotangent, ray grads
    fused_bytes = common_bytes + 12 * n + 4 * n_blocks   # targets, loss
    work = {**st, "fp32_ops": adj_ops}
    vis_ops = (_forward_ops(st_vis, s)
               + st_vis["hit_segments"] * OPS_SEGMENT_ADJ
               + st_vis["diffuse_vertices"] * OPS_SCATTER_ADJ
               + st_vis["shadow_lit"] * OPS_SHADOW_ADJ
               + st_vis["carrier_terms"] * OPS_CARRIER_TERM)
    vis_work = {"carrier_terms": st_vis["carrier_terms"],
                "fp32_ops": vis_ops, "vis_grad_tau": VIS_TAU}
    res = {k: pg.kernel_resources(k, scene_tab, vpl_tab, tape, len(li))
           for k in ADJOINT_RESOURCES}
    check(all(res[k]["smem_bytes"] == want["smem_bytes"]
              and res[k]["blocks_per_sm"] > 0
              for k, want in ADJOINT_RESOURCES.items()),
          f"adjoint kernels' shared memory {res}: want the bytes of "
          f"{ADJOINT_RESOURCES}")
    grad_src = "gpu_bidirectional_raytracer_tpu_torch/csrc/grad_kernel.cu"
    rows += [{
        "name": "grad_kernel",
        "route": "cuda",
        "source": grad_src,
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_grad.py:158",
        "launches": t["fit_launches"]["grad_kernel"],
        "max_abs_err": max(grad_err, t["grad_err"], tape_res["grad_err"]),
        "ms": grad_ms,
        "plain_ms": grad_plain_ms,
        **_bound(adj_ops, grad_bytes),
        "library_ms": None,
        "work": {**work, "bytes": grad_bytes},
        "vis_ms": vis_grad_ms,
        "vis_launches": carrier["fit_launches"]["grad_kernel_vis"],
        "vis_bound_ms": _bound(vis_ops, grad_bytes)["bound_ms"],
        "vis_max_abs_err": carrier_err["grad"],
        "vis_work": vis_work,
        **res["grad_kernel"],
        "vis_smem_bytes": res["grad_kernel_vis"]["smem_bytes"],
        "vis_blocks_per_sm": res["grad_kernel_vis"]["blocks_per_sm"],
    }, {
        "name": "fused_kernel",
        "route": "cuda",
        "source": grad_src,
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_grad.py:1215",
        "launches": t["step_launches"]["fused_kernel"],
        "max_abs_err": max(grad_err, t["fused_err"], tape_res["fused_err"]),
        "ms": fused_ms,
        "plain_ms": fused_plain_ms,
        **_bound(adj_ops, fused_bytes),
        "library_ms": None,
        "work": {**work, "bytes": fused_bytes},
        "vis_ms": vis_fused_ms,
        "vis_launches": carrier["step_launches"]["fused_kernel_vis"],
        "vis_bound_ms": _bound(vis_ops, fused_bytes)["bound_ms"],
        "vis_max_abs_err": carrier_err["fused"],
        "vis_work": vis_work,
        **res["fused_kernel"],
        "vis_smem_bytes": res["fused_kernel_vis"]["smem_bytes"],
        "vis_blocks_per_sm": res["fused_kernel_vis"]["blocks_per_sm"],
    }]
    rows += _bounce_rows(bounce, cpath, ctrain, device)
    rows += _scan_rows(scan, spath)
    phase("timing", profiler_fallbacks=PROFILER_FALLBACKS)
    print(json.dumps({"kernels": rows}), flush=True)


def _bounce_rows(bounce: dict, cpath: dict, ctrain: dict, device) -> list:
    """The rows of the bounce and fact kernels at complex.scn's 512x384,
    per launch (one depth). Their work over a pass is what the eye-path
    kernel would do for the same rays (`path_tracer.trace` with_stats,
    counted in bands of 96 rows to bound its memory), spread over the 7
    launches; their bytes are the state planes read and written once per
    launch, the tables, and for the fact kernel its facts."""
    from gpu_bidirectional_raytracer_tpu_torch.core.types import Rays
    from gpu_bidirectional_raytracer_tpu_torch.integrators import path_tracer
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_bounce as pb
    from gpu_bidirectional_raytracer_tpu_torch.ops import (
        pallas_bounce_grad as pbg,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_scan as ps
    from gpu_bidirectional_raytracer_tpu_torch.render import progressive

    r = cpath["renderer"]
    scene, cfg, li = r.scene, r.cfg, r.light_idx
    w, h, n = r.width, r.height, r.width * r.height
    depths = cfg.max_depth
    st = r.state
    vpls, vi = progressive.vpl_update(scene, st, cfg, li)
    rays = progressive.frame_rays(r.camera, cfg, w, h, st.key, st.sample)
    planes = pb.state_planes(rays)
    kw = dict(vpls=vpls, vlp_index=vi)

    def bounce_pass(call):
        p = planes.clone()
        for depth in range(depths):
            call.launch(p, depth)

    block_ms, event_ms = {}, {}
    for block in BOUNCE_BLOCKS:
        call = pb.prepare_bounce(scene, cfg, li, st.key, st.sample, vpls, vi,
                                 n, block=block)
        block_ms[block] = device_ms(lambda: bounce_pass(call), 10,
                                    "bounce_kernel", launches=depths)
        event_ms[block] = cuda_ms(lambda: bounce_pass(call),
                                  reps=10) / depths
    ms = block_ms[pb.BLOCK]
    # Each depth alone, on the state the pass brings it, with every G.
    call = pb.prepare_bounce(scene, cfg, li, st.key, st.sample, vpls, vi, n)
    states, p = [], planes.clone()
    for depth in range(depths):
        states.append(p.clone())
        call.launch(p, depth)
    live = [float((x[13] > 0.5).float().mean()) for x in states]
    n_vpl_tab = call.tables[1].shape[0]
    facts = [torch.empty((n,), dtype=torch.int32, device=device),
             torch.empty((len(li), n), dtype=torch.bool, device=device),
             torch.empty((max(n_vpl_tab, 1), n), dtype=torch.bool,
                         device=device)]
    fact_ptrs = (facts[0].data_ptr(), facts[1].data_ptr(),
                 facts[2].data_ptr() if n_vpl_tab else None)

    def per_depth(entry, group):
        call = pb.prepare_bounce(scene, cfg, li, st.key, st.sample, vpls, vi,
                                 n, entry=entry, group=group)
        return [device_ms(lambda d=d: call.launch(
            work, d, fact_ptrs if entry == "aux_kernel" else ()), 10,
            "bounce_kernel", lambda d=d: work.copy_(states[d]))
            for d in range(depths)]

    work = planes.clone()
    group_ms = {entry: {g: per_depth(entry, g) for g in ps.GROUP_SIZES}
                for entry in ("bounce_kernel", "aux_kernel")}
    # A launch with no live ray: the table loads and the flag reads.
    idle = states[0].clone()
    idle[13] = 0.0
    idle_ms = device_ms(lambda: call.launch(work, depths - 1), 10,
                        "bounce_kernel", lambda: work.copy_(idle))
    group = ps.group_size(scene.num_spheres, pb.PER_LANE)
    ms_per_depth = {entry: per_depth(entry, group)
                    for entry in ("bounce_kernel", "aux_kernel")}
    res = {entry: pb.prepare_bounce(scene, cfg, li, st.key, st.sample, vpls,
                                    vi, n, entry=entry).resources()
           for entry in ("bounce_kernel", "aux_kernel")}

    def plain_pass(collect):
        p = planes
        for depth in range(depths):
            p = pb.bounce_plain(scene, cfg, li, p, st.key, st.sample, depth,
                                collect=collect, **kw)
            if collect:
                p = p[0]

    plain_ms = cuda_ms(lambda: plain_pass(False), reps=1, warmup=1) / depths
    stats = {}
    band = COMPLEX_TILE * w
    for lo in range(0, n, band):
        _, s_ = path_tracer.trace(
            scene, cfg, li, Rays(o=rays.o[lo:lo + band],
                                 d=rays.d[lo:lo + band]),
            st.key, st.sample, lane_offset=lo, lane_total=n,
            with_stats=True, **kw)
        stats = {k: stats.get(k, 0) + v for k, v in s_.items()}
    s = scene.num_spheres
    n_vpl = cfg.vpl_depth * cfg.max_vlp if cfg.use_vpl else 0
    ops_launch = _forward_ops(stats, s) // depths
    k_rows = depths * (2 * max(len(li), 1) + 3)
    tables = 4 * 16 * (s + n_vpl) + 16 * k_rows + 4 * len(li)
    bounce_bytes = tables + 2 * 4 * pb.N_PLANES * n
    aux_bytes = bounce_bytes + (4 + len(li) + n_vpl) * n
    src = "gpu_bidirectional_raytracer_tpu_torch/csrc/bounce_kernel.cu"
    aux_ms = device_ms(lambda: pbg.trace_bounce_aux(
        scene, cfg, li, rays, st.key, st.sample, **kw), 10, "bounce_kernel",
        launches=depths)
    aux_plain_ms = cuda_ms(lambda: plain_pass(True), reps=1,
                           warmup=1) / depths
    work = {**stats, "fp32_ops_per_launch": ops_launch,
            "per_launch": "one depth; the pass's work over its 7 launches"}
    return [{
        "name": "bounce_kernel",
        "route": "cuda",
        "source": src,
        "replaces": "gpu_bidirectional_raytracer_tpu/ops/pallas_bounce.py:48",
        "launches": cpath["launches"]["bounce_kernel"],
        "max_abs_err": max(bounce["bounce"], cpath["max_abs_err"]),
        "ms": ms,
        "plain_ms": plain_ms,
        **_bound(ops_launch, bounce_bytes),
        "library_ms": None,
        "block_ms": block_ms,
        "event_ms": event_ms[pb.BLOCK],
        "group": group,
        "ms_per_depth": ms_per_depth["bounce_kernel"],
        "live_frac_per_depth": live,
        "group_ms": group_ms["bounce_kernel"],
        "idle_ms": idle_ms,
        **res["bounce_kernel"],
        "work": {**work, "bytes": bounce_bytes},
    }, {
        "name": "aux_kernel",
        "route": "cuda",
        "source": src,
        "replaces":
            "gpu_bidirectional_raytracer_tpu/ops/pallas_bounce_grad.py:61",
        "launches": ctrain["launches"]["aux_kernel"],
        "max_abs_err": max(bounce["aux"], ctrain["max_abs_err"]),
        "ms": aux_ms,
        "plain_ms": aux_plain_ms,
        **_bound(ops_launch, aux_bytes),
        "library_ms": None,
        "group": group,
        "ms_per_depth": ms_per_depth["aux_kernel"],
        "live_frac_per_depth": live,
        "group_ms": group_ms["aux_kernel"],
        **res["aux_kernel"],
        "work": {**work, "bytes": aux_bytes},
    }]


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
        ptxas = phase_build()
        max_err = phase_kernel_vs_plain(device)
        grad_err = phase_grad_vs_plain(device)
        carrier_err = phase_carrier_vs_plain(device, ptxas)
        tape_res = phase_tape_vs_plain(device)
        bounce_res = phase_bounce_vs_plain(device)
        scan_res = phase_scan_vs_plain(device)
        main_res = phase_main_path()
        train_res = phase_train_path()
        cpath_res = phase_complex_path()
        ctrain_res = phase_complex_train()
        carrier_res = phase_carrier_train(train_res, ctrain_res)
        spath_res = phase_scan_path()
        phase_mxu_train()
        phase_kernels(main_res, train_res, max_err, grad_err, device,
                      tape_res, bounce_res, cpath_res, ctrain_res, scan_res,
                      spath_res, carrier_err, carrier_res)
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
