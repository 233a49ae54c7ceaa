#!/usr/bin/env python
"""North-star parity run of the PyTorch + CUDA port (BASELINE.md).

Port of tools/northstar.py's render legs, ``evaluate_gate`` and
``compare``. It renders cornell.scn with the port, on the card unless
``--device cpu`` is given, and holds the image to the JAX package's
committed CPU render of the same configuration on the same tape:

- ``--family golden``: ``IntegratorConfig.cpu_golden()`` on the threefry
  tape, 1024x768 at 1024 samples per pixel, against
  ``artifacts/northstar_cpu.npy``;
- ``--family vpl``: ``IntegratorConfig()`` (VPLs, depth 7) on the mix32
  tape, 512x384 at 256 samples per pixel, against
  ``artifacts/northstar_vpl_cpu.npy``.

Both tapes are counter-addressed, so the port draws the randoms the CPU
render drew, and the comparison is per-pixel parity of one estimate
computed by two programs. ``--backend auto`` (the default) takes the
eye-path kernel (``trace_kernel``) on the card; ``--backend xla`` the
port's plain tracer there, the program the JAX legs ran. The gate is
JAX's, with its five checks and bounds (`evaluate_gate`).

    python3 tools/torch_northstar.py --family vpl [--backend xla]
        [--out PATH.npy] [--leg render|compare|all] [--device cpu]
        [--width W --height H --spp N]

``render`` writes the image to ``--out`` (default
``artifacts/torch_northstar_<family>_gpu.npy``, a PNG beside it);
``compare`` reads it back and applies the gate; ``all`` (the default)
does both; the gate takes only the family's full size. One JSON line goes
to standard output; the exit code is 1 when the gate fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts")
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# family -> (config, tape, width, height, spp, the JAX package's CPU render)
FAMILIES = {
    "golden": ("cpu_golden", "threefry", 1024, 768, 1024, "northstar_cpu.npy"),
    "vpl": ("default", "mix32", 512, 384, 256, "northstar_vpl_cpu.npy"),
}
# Passes per `Renderer.step_n` call (one `render_chunk`).
CHUNK = 64


def family_config(family: str):
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        IntegratorConfig,
    )

    return (IntegratorConfig.cpu_golden() if FAMILIES[family][0]
            == "cpu_golden" else IntegratorConfig())


def render(family: str, device: str = "cuda", backend: str = "auto",
           width: int | None = None, height: int | None = None,
           spp: int | None = None, log=None) -> tuple[np.ndarray, dict]:
    """The family's render with the port: ``(image [H, W, 3] float32, info)``;
    ``info`` holds the wall seconds (the card synchronised), the resolved
    backend and the kernels' launches. Sizes default to the family's."""
    import torch

    from gpu_bidirectional_raytracer_tpu_torch.ops import pallas_trace
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        Renderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        load_scene,
    )

    _, tape, w0, h0, spp0, _ = FAMILIES[family]
    width, height, spp = width or w0, height or h0, spp or spp0
    orig, target, scene = load_scene(
        os.path.join(REPO, "assets", "scenes", "cornell.scn"), device=device)
    r = Renderer(scene, orig, target, width, height,
                 cfg=family_config(family), device=device, backend=backend,
                 rng_impl=tape)
    on_card = r.device.type == "cuda"
    if on_card:
        from gpu_bidirectional_raytracer_tpu_torch.ops import _build

        _build.build_all()   # nvcc before the clock starts

    def sync():
        if on_card:
            torch.cuda.synchronize()

    pallas_trace.reset_launches()
    sync()
    t0 = time.perf_counter()
    for done in range(0, spp, CHUNK):
        r.step_n(min(CHUNK, spp - done))
        if log is not None:
            sync()
            log(f"[{family}] pass {min(done + CHUNK, spp)}/{spp} "
                f"({time.perf_counter() - t0:.1f} s)")
    img = r.state.colors.cpu().numpy()
    seconds = time.perf_counter() - t0
    info = {"family": family, "dims": f"{width}x{height}", "spp": spp,
            "tape": tape, "backend": r.backend, "device": str(r.device),
            "seconds": seconds, "ms_per_pass": 1e3 * seconds / spp,
            "launches": {k: v for k, v in pallas_trace.LAUNCHES.items() if v}}
    return img, info


def evaluate_gate(a: np.ndarray, b: np.ndarray) -> tuple[dict, bool]:
    """The north-star acceptance criterion, tools/northstar.py's
    ``evaluate_gate`` unchanged: image ``a`` against the reference ``b``.

    - structure: NCC >= 0.9999 (flipped decisions do not correlate with
      the signal);
    - energy: mean |diff| <= 0.5% of the mean radiance;
    - flip rate: the share of pixels failing allclose (rtol 1e-3, atol
      1e-4) <= 55%; a wrong constant sends it to about 100%;
    - magnitude: p99.9 relative difference <= 5e-2 and max |diff| <= 1.0
      (a flipped pass moves a pixel by one pass's contribution over the
      pass count).

    Returns ``(metrics, ok)``."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    diff = np.abs(a - b)
    scale = np.maximum(np.abs(b), 1e-3)
    rel = diff / scale
    ncc = float(np.corrcoef(a.ravel(), b.ravel())[0, 1])
    offender_frac = float(
        (diff > (1e-4 + 1e-3 * np.abs(b))).any(axis=-1).mean())
    metrics = {
        "max_abs_diff": float(diff.max()),
        "mean_abs_diff": float(diff.mean()),
        "mean_radiance": float(b.mean()),
        "max_rel_diff_at_radiance_gt_1e-3": float(rel.max()),
        "p999_rel_diff": float(np.quantile(rel, 0.999)),
        "ncc": ncc,
        "offender_pixel_fraction": offender_frac,
        "allclose_rtol_1e-3_atol_1e-4": bool(
            np.allclose(a, b, rtol=1e-3, atol=1e-4)),
    }
    checks = {
        "ncc>=0.9999": ncc >= 0.9999,
        "mean_abs<=0.5%_mean": metrics["mean_abs_diff"]
        <= 0.005 * metrics["mean_radiance"],
        "offender_frac<=0.55": offender_frac <= 0.55,
        "p999_rel<=5e-2": metrics["p999_rel_diff"] <= 5e-2,
        "max_abs<=1.0": metrics["max_abs_diff"] <= 1.0,
    }
    metrics["checks"] = checks
    return metrics, all(checks.values())


def reference(family: str) -> np.ndarray:
    """The JAX package's committed CPU render of the family."""
    return np.load(os.path.join(ART, FAMILIES[family][5]))


def compare(img: np.ndarray, family: str) -> tuple[dict, bool]:
    """`evaluate_gate` of ``img`` against the family's CPU render."""
    ref = reference(family)
    if img.shape != ref.shape:
        raise ValueError(f"image {img.shape} against reference {ref.shape}:"
                         f" the gate compares the family's full size")
    return evaluate_gate(img, ref)


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not measured ({type(err).__name__})"
    return out.stdout.strip() or "not measured"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--family", choices=sorted(FAMILIES), required=True)
    ap.add_argument("--leg", choices=["render", "compare", "all"],
                    default="all")
    ap.add_argument("--backend", choices=["auto", "xla"], default="auto")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=None,
                    help="default the family's; the gate takes only that")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="the image's .npy (default artifacts/"
                         "torch_northstar_<family>_gpu.npy)")
    args = ap.parse_args(argv)
    out = args.out or os.path.join(
        ART, f"torch_northstar_{args.family}_gpu.npy")
    result = {"config": f"cornell.scn, family {args.family}"}
    if args.leg in ("render", "all"):
        from gpu_bidirectional_raytracer_tpu_torch.render import film

        img, info = render(
            args.family, args.device, args.backend, args.width, args.height,
            args.spp, log=lambda s: print(s, file=sys.stderr, flush=True))
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        np.save(out, img)
        film.write_image(img, out[:-4] + ".png" if out.endswith(".npy")
                         else out + ".png")
        result.update(info, out=out, mean=float(img.mean()))
        if info["device"].startswith("cuda"):
            result["card"] = _card()
    else:
        img = np.load(out)
    if args.leg in ("compare", "all"):
        metrics, ok = compare(img, args.family)
        result.update(metrics, gate_passed=ok,
                      reference=FAMILIES[args.family][5])
    print(json.dumps(result), flush=True)
    if args.leg != "render" and not result["gate_passed"]:
        print("NORTH-STAR GATE FAILED", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
