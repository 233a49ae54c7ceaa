#!/usr/bin/env python
"""The BASELINE config ladder's quality gates for the PyTorch + CUDA port.

Port of tools/ladder.py: the same rungs, tape prefix, gates and inverse
rung, on the port. Each rung renders its full config on the card through
the kernels (`Renderer(backend="auto")`: ``trace_kernel`` up to 64
spheres) as its image, and gates on same-tape parity: the first
``ref_spp`` passes are rendered again on the card through the kernels,
and on the CPU through the port's plain tracer (``backend="xla"``), on
the same counter-addressed tape. The two heads compute one estimate with
two programs, so they must agree to float parity (cell NCC about 1,
sub-percent cell means; knife-edge decision flips only). The inverse
rung fits a seeded 10-sphere scene with `InverseRenderer` (on the card
``trace_kernel`` and the adjoint kernel, with the visibility carrier:
``grad_kernel_vis``), gated on the recovered parameters and the loss.

Rungs (BASELINE.json "configs"):
  simple.scn        256x256 @ 16 spp
  cornell.scn       512x512 @ 256 spp
  cornell_mirror    512x512 @ 1024 spp
  cornell_glass     512x512 @ 1024 spp
  caustic.scn       512x384 @ 4096 spp
  inverse           10-sphere recovery (position, radius, albedo)

    python3 tools/torch_ladder.py [--rung NAME] [--scale N]
        [--out-dir DIR] [--device cpu]

``--scale N`` divides every spp and the inverse rung's steps by N (the
same gates). Writes ``<out-dir>/TORCH_LADDER.json`` (default
``artifacts/``; rungs run before are kept) and ``torch_ladder_<rung>.png``
beside it, prints one JSON line per rung, and exits 1 when a rung fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

RUNGS = {
    "simple": ("simple.scn", 256, 256, 16),
    "cornell": ("cornell.scn", 512, 512, 256),
    "mirror": ("cornell_mirror.scn", 512, 512, 1024),
    "glass": ("cornell_glass.scn", 512, 512, 1024),
    "caustic": ("caustic.scn", 512, 384, 4096),
}
# The parity heads' spp: a prefix of the rung's tape long enough to run
# the whole pipeline (VPL refreshes, the window's slide, every material).
REF_DIV = 8
REF_MIN, REF_MAX = 8, 64
CELL = 16
# Passes per `Renderer.step_n` call (tools/ladder.py renders in chunks of 32).
CHUNK = 32
# Kernels whose launches each leg reports (the inverse rung's carriers
# launch the adjoint as `grad_kernel_vis`).
COUNTED = ("trace_kernel", "grad_kernel", "grad_kernel_vis")


def _cells(img: np.ndarray) -> np.ndarray:
    h, w, _ = img.shape
    return img[: h // CELL * CELL, : w // CELL * CELL].reshape(
        h // CELL, CELL, w // CELL, CELL, 3).mean(axis=(1, 3))


def evaluate_rung(full: np.ndarray, head: np.ndarray,
                  ref: np.ndarray) -> tuple[dict, bool]:
    """A rung's gate, tools/ladder.py's ``evaluate_rung`` unchanged: the
    same-tape parity of the heads (``head`` against ``ref``, 16x16 cell
    means: NCC >= 0.999, mean relative cell error <= 1%, its p95 <= 3%,
    global means within 1%) and a finite full render."""
    ca, cb = _cells(head), _cells(ref)
    ncc = float(np.corrcoef(ca.ravel(), cb.ravel())[0, 1])
    scale_ref = max(float(cb.mean()), 1e-6)
    cell_rel = np.abs(ca - cb).mean(axis=-1) / scale_ref
    res = {
        "mean": float(full.mean()),
        "head_mean": float(head.mean()), "ref_mean": float(ref.mean()),
        "ncc_cells": ncc,
        "mean_rel_cell_err": float(cell_rel.mean()),
        "p95_rel_cell_err": float(np.quantile(cell_rel, 0.95)),
        "finite": bool(np.isfinite(full).all()),
    }
    checks = {
        "finite": res["finite"],
        "ncc>=0.999": ncc >= 0.999,
        "mean_rel<=1%": res["mean_rel_cell_err"] <= 0.01,
        "p95_rel<=3%": res["p95_rel_cell_err"] <= 0.03,
        "global_mean<=1%": abs(res["head_mean"] - res["ref_mean"])
        <= 0.01 * max(res["ref_mean"], 1e-6),
    }
    res["checks"] = checks
    return res, all(checks.values())


def _launches() -> dict:
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace

    return {k: pallas_trace.LAUNCHES[k] for k in COUNTED}


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def render_leg(scn: str, width: int, height: int, spp: int, device: str,
               backend: str) -> tuple[np.ndarray, dict]:
    """``spp`` passes of ``IntegratorConfig()`` (mix32, seed 0) on ``scn``:
    ``(image, {spp, seconds, backend, launches})``."""
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        Renderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        load_scene,
    )

    orig, target, scene = load_scene(
        os.path.join(REPO, "assets", "scenes", scn), device=device)
    r = Renderer(scene, orig, target, width, height, cfg=IntegratorConfig(),
                 device=device, backend=backend)
    pallas_trace.reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    img = r.render(spp, chunk=CHUNK)
    return img, {"spp": spp, "seconds": time.perf_counter() - t0,
                 "backend": r.backend, "launches": _launches()}


def run_rung(name: str, scale: int, device: str = "cuda") -> tuple[dict,
                                                                  np.ndarray]:
    """The rung's three legs and gate: ``(result, full image)``."""
    scn, w, h, spp = RUNGS[name]
    spp = max(spp // scale, 4)
    ref_spp = min(max(spp // REF_DIV, REF_MIN), REF_MAX, spp)
    full, full_info = render_leg(scn, w, h, spp, device, "auto")
    head, head_info = render_leg(scn, w, h, ref_spp, device, "auto")
    ref, ref_info = render_leg(scn, w, h, ref_spp, "cpu", "xla")
    res, passed = evaluate_rung(full, head, ref)
    res = {
        "scene": scn, "dims": f"{w}x{h}", "device": device,
        "spp": spp, "ref_spp": ref_spp,
        "seconds": full_info["seconds"],
        "head_seconds": head_info["seconds"],
        "ref_seconds": ref_info["seconds"],
        "backend": full_info["backend"],
        "launches": full_info["launches"],
        "head_launches": head_info["launches"],
        **res,
        "passed": passed,
    }
    return res, full


# ---- the inverse-rendering rung (BASELINE.md:25's final rung) -------------

# Perturbations applied to the true scene; recovery must walk them back.
_INV_POS_OFF = (4.0, 0.0, 3.0)   # ball A position offset (scene units)
_INV_RAD_OFF = 2.5               # ball B radius offset
_INV_ALB_OFF = (-0.3, 0.2, 0.1)  # ball C albedo offset
_INV_A, _INV_B, _INV_C = 3, 4, 5


def inverse_scene(device: str = "cuda"):
    """tools/ladder.py's seeded 10-sphere diffuse scene: floor, back wall,
    light and seven balls."""
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        scene_from_arrays,
    )

    rng_ = np.random.default_rng(11)
    balls_p = np.array([[-22.0, 8.0, -8.0], [0.0, 10.0, -20.0],
                        [20.0, 7.0, -4.0], [-8.0, 6.0, 12.0],
                        [10.0, 5.0, 14.0], [26.0, 12.0, -24.0],
                        [-28.0, 14.0, -26.0]])
    balls_r = np.array([8.0, 10.0, 7.0, 6.0, 5.0, 9.0, 9.0])
    balls_c = 0.25 + 0.65 * rng_.random((7, 3))
    p = np.concatenate([
        np.array([[0.0, -1e4, 0.0],         # floor plane (top at y=0)
                  [0.0, 0.0, -1e4 - 44.0],  # back wall (front at z=-44)
                  [0.0, 70.0, 30.0]]),      # light
        balls_p])
    rad = np.concatenate([[1e4, 1e4, 12.0], balls_r])
    e = np.zeros((10, 3))
    e[2] = (22.0, 22.0, 22.0)
    c = np.concatenate([
        np.array([[0.75, 0.75, 0.75], [0.6, 0.65, 0.75], [0.0, 0.0, 0.0]]),
        balls_c])
    return scene_from_arrays(rad, p, e, c, np.zeros(10, np.int32),
                             device=device)


def evaluate_inverse_rung(res: dict) -> tuple[dict, bool]:
    """The inverse rung's gate, tools/ladder.py's unchanged: the loss at
    most 0.6 of its start, position error <= 1.2, radius error <= 0.6,
    albedo error <= 0.10, a finite loss."""
    checks = {
        "loss_reduced": res["loss_final"] <= 0.6 * res["loss_start"],
        "pos_err<=1.2": res["pos_err_final"] <= 1.2,
        "rad_err<=0.6": res["rad_err_final"] <= 0.6,
        "albedo_err<=0.10": res["albedo_err_final"] <= 0.10,
        "finite": bool(np.isfinite(res["loss_final"])),
    }
    return {**res, "checks": checks}, all(checks.values())


def run_inverse_rung(scale: int, device: str = "cuda",
                     out_dir: str = ART) -> dict:
    """tools/ladder.py's ``run_inverse_rung`` on the port: the target at
    4 spp with the CPU-golden config on the threefry key of seed 0, the
    three perturbed balls fitted with both carriers (tau 2, annealed to
    0.05 of it over 5/8 of the steps in 8 stages), Adam at lr 0.12, the
    room's gradients masked."""
    import torch

    from gpu_bidirectional_raytracer_tpu_torch import rng
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        Camera,
        IntegratorConfig,
    )
    from gpu_bidirectional_raytracer_tpu_torch.diff import gradients as G
    from gpu_bidirectional_raytracer_tpu_torch.integrators.direct import (
        static_light_indices,
    )
    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
    from gpu_bidirectional_raytracer_tpu_torch.render import film

    w, h = 96, 72
    steps = max(240 // scale, 40)
    truth = inverse_scene(device)
    dev = truth.device
    cam = Camera.make((0.0, 26.0, 70.0), (0.0, 8.0, -6.0), w, h, device=dev)
    li = static_light_indices(truth)
    key = rng.make_key(0, "threefry")
    cfg0 = IntegratorConfig.cpu_golden()

    def image(sc):
        return G.render_radiance(sc, cam, key, cfg0, w, h, li, 4).cpu()

    target = G.render_radiance(truth, cam, key, cfg0, w, h, li, spp=4)
    film.write_image(target.cpu(),
                     os.path.join(out_dir, "torch_ladder_inverse_target.png"))
    A, B, C = _INV_A, _INV_B, _INV_C
    f32 = dict(dtype=torch.float32, device=dev)
    p, rad, c = truth.p.clone(), truth.rad.clone(), truth.c.clone()
    p[A] += torch.tensor(_INV_POS_OFF, **f32)
    rad[B] += _INV_RAD_OFF
    c[C] += torch.tensor(_INV_ALB_OFF, **f32)
    wrong = truth.replace(p=p, rad=rad, c=c)
    film.write_image(image(wrong),
                     os.path.join(out_dir, "torch_ladder_inverse_start.png"))

    cfg = dataclasses.replace(cfg0, sil_grad_tau=2.0, vis_grad_tau=2.0)
    ball_mask = np.concatenate([np.zeros(3), np.ones(7)]).astype(np.float32)
    inv = G.InverseRenderer(scene=wrong, cam=cam, target=target, cfg=cfg,
                            width=w, height=h, lr=0.12, spp=4,
                            optimize=("p", "rad", "c"), resample=False,
                            loss="l2", backend="auto", tau_anneal=0.05,
                            anneal_steps=max(steps * 5 // 8, 1),
                            anneal_stages=8,
                            grad_mask={k: ball_mask
                                       for k in ("p", "rad", "c")})

    def errs(sc):
        return (float((sc.p[A] - truth.p[A]).abs().max()),
                float((sc.rad[B] - truth.rad[B]).abs()),
                float((sc.c[C] - truth.c[C]).abs().max()))

    # The kernels' gradient against the plain tracer's at the start point
    # (tools/ladder.py records the same distances).
    grad_dist = {}
    if inv.backend == "pallas":
        _, gx = G.render_loss_grad(wrong, cam, key, target, cfg, w, h, li,
                                   4, "l2", "xla")
        _, gp = G.render_loss_grad(wrong, cam, key, target, cfg, w, h, li,
                                   4, "l2", "pallas")
        for f in ("p", "rad", "c"):
            a, b = getattr(gx, f), getattr(gp, f)
            grad_dist[f"grad_dist_{f}"] = float(
                (b - a).abs().max() / max(float(a.abs().max()), 1e-12))

    pallas_trace.reset_launches()
    _sync(dev)
    t0 = time.perf_counter()
    loss0 = loss = inv.step()
    for _ in range(steps - 1):
        loss = inv.step()
    seconds = time.perf_counter() - t0
    launches = _launches()
    p_err, r_err, a_err = errs(inv.scene)
    film.write_image(image(inv.scene), os.path.join(
        out_dir, "torch_ladder_inverse_recovered.png"))
    res = {
        "scene": "10-sphere seeded diffuse (torch_ladder.inverse_scene)",
        "dims": f"{w}x{h}", "device": str(dev), "steps": steps, "spp": 4,
        "seconds": seconds, "s_per_step": seconds / steps,
        "loss_start": loss0, "loss_final": loss,
        "pos_err_start": float(max(abs(x) for x in _INV_POS_OFF)),
        "pos_err_final": p_err,
        "rad_err_start": abs(_INV_RAD_OFF), "rad_err_final": r_err,
        "albedo_err_start": max(abs(x) for x in _INV_ALB_OFF),
        "albedo_err_final": a_err,
        "backend": inv.backend,
        "tau_anneal": "0.05 over 5/8 of descent, 8 stages",
        "launches": launches,
        **grad_dist,
    }
    res, passed = evaluate_inverse_rung(res)
    res["passed"] = passed
    return res


def main(argv: list[str] | None = None) -> int:
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        resolve_device,
    )
    from gpu_bidirectional_raytracer_tpu_torch.render import film

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rung", choices=list(RUNGS) + ["inverse"],
                    default=None)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--out-dir", default=ART)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    os.makedirs(args.out_dir, exist_ok=True)
    names = [args.rung] if args.rung else list(RUNGS) + ["inverse"]
    path = os.path.join(args.out_dir, "TORCH_LADDER.json")
    out, ok = {}, True
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    for name in names:
        if name == "inverse":
            res = run_inverse_rung(args.scale, device, args.out_dir)
        else:
            res, full = run_rung(name, args.scale, device)
            film.write_image(full, os.path.join(
                args.out_dir, f"torch_ladder_{name}.png"))
        out[name] = res
        ok = ok and res["passed"]
        print(json.dumps({name: res}), flush=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    if not ok:
        print("LADDER GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
