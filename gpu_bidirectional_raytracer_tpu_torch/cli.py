"""Command-line interface: ``render``, ``view`` and ``optimize``.

Port of ``gpu_bidirectional_raytracer_tpu/cli.py`` with the same
subcommands and options, but one: JAX's ``--platform`` is ``--device``
here (default ``cuda``; ``cpu`` only when asked; ``cuda`` without a card
raises, as every entry point of the port does).

Usage:
    python -m gpu_bidirectional_raytracer_tpu_torch.cli render [scene.scn]
        [--width 640] [--height 480] [--spp 64] [--out out.ppm]
        [--mode gpu|cpu|light] [--reference-dims] [--snapshot-every N]
        [--checkpoint DIR] [--resume] [--chunk 16] [--rng mix32|threefry|rbg]
    python -m gpu_bidirectional_raytracer_tpu_torch.cli view [scene.scn]
        [--width 128] [--height 96]         # interactive terminal viewer
    python -m gpu_bidirectional_raytracer_tpu_torch.cli optimize target.ppm
        [scene.scn] [--steps 100] [--lr 0.05] [--params p,rad,c,e]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch


def _load(scene_path: str | None, device, camera_scale: float = 1.0):
    from gpu_bidirectional_raytracer_tpu_torch.scene import builtin
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        load_scene,
        scale_world,
    )

    if scene_path:
        orig, target, scene = load_scene(scene_path, device=device)
    else:
        orig, target, scene = (builtin.DEFAULT_CAMERA_ORIG,
                               builtin.DEFAULT_CAMERA_TARGET,
                               builtin.cornell_box(device=device))
    if camera_scale != 1.0:
        orig, target, scene = scale_world(orig, target, scene, camera_scale)
    return orig, target, scene


def _config(mode: str):
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        IntegratorConfig,
    )

    # "light" (the light-tracing splat integrator) takes the GPU config.
    return (IntegratorConfig.cpu_golden() if mode == "cpu"
            else IntegratorConfig.gpu())


# The flag that matches a checkpoint's stored tape.
_RESUME_HINTS = {
    "threefry": "resume with --rng threefry",
    "rbg": "resume with --fast-rng (or --rng rbg)",
    "mix32": "resume without --rng/--fast-rng (mix32 is the default)",
}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_render(args) -> int:
    from gpu_bidirectional_raytracer_tpu_torch.render import film
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        Renderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.utils import checkpoint as ckpt
    from gpu_bidirectional_raytracer_tpu_torch.utils.profiling import (
        ThroughputMeter,
    )

    orig, target, scene = _load(args.scene, args.device, args.camera_scale)
    rng_impl = "rbg" if args.fast_rng else args.rng
    r = Renderer(scene, orig, target, args.width, args.height,
                 cfg=_config(args.mode), seed=args.seed,
                 reference_dims=args.reference_dims, device=args.device,
                 backend=args.backend, tile_rows=args.tile_rows,
                 rng_impl=rng_impl)

    if args.checkpoint and args.resume:
        try:
            restored = ckpt.restore(args.checkpoint, r.state)
        except ckpt.TapeMismatch as e:
            print(f"error: checkpoint at {args.checkpoint} was written "
                  f"under a different --rng/--fast-rng setting (stored "
                  f"tape {e.stored}, requested {e.requested}); "
                  f"{_RESUME_HINTS[e.stored]}", file=sys.stderr)
            return 2
        if restored is not None:
            r.state = restored
            print(f"resumed at sample {r.state.sample}", file=sys.stderr)

    t0 = time.time()
    start = r.state.sample
    # Chunks (render_chunk / light_splat_chunk) end where a snapshot or a
    # checkpoint is due.
    chunk = max(args.chunk, 1)
    s = start
    while s < args.spp:
        k = min(chunk, args.spp - s)
        if args.snapshot_every:
            k = min(k, args.snapshot_every - (s % args.snapshot_every))
        if args.checkpoint:
            cad = max(args.snapshot_every or 16, 1)
            k = min(k, cad - (s % cad))
        if args.mode == "light":
            r.step_light(k)
        else:
            r.step_n(k)
        if s == start:
            _sync(r.device)
        s += k
        if args.snapshot_every and s % args.snapshot_every == 0:
            elapsed = time.time() - t0
            name = film.snapshot_name(r.cfg.max_vlp, elapsed, s)
            film.write_ppm(r.state.colors, name)
            print(f"pass {s}: wrote {name}", file=sys.stderr)
        if args.checkpoint and s % max(args.snapshot_every or 16, 1) == 0:
            ckpt.save(args.checkpoint, r.state)
    _sync(r.device)
    elapsed = time.time() - t0
    meter = ThroughputMeter(pixels_per_pass=r.width * r.height,
                            total_time=elapsed, passes=args.spp - start)
    print(meter.report(), file=sys.stderr)

    written = film.write_image(r.state.colors, args.out)
    print(f"wrote {written}", file=sys.stderr)
    if args.checkpoint:
        ckpt.save(args.checkpoint, r.state)
    return 0


def cmd_view(args) -> int:
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        Renderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.render.viewer import run_viewer

    orig, target, scene = _load(args.scene, args.device, args.camera_scale)
    r = Renderer(scene, orig, target, args.width, args.height,
                 cfg=_config(args.mode), seed=args.seed, device=args.device,
                 backend=args.backend)
    run_viewer(r)
    return 0


def cmd_optimize(args) -> int:
    import dataclasses

    from gpu_bidirectional_raytracer_tpu_torch.core.types import Camera
    from gpu_bidirectional_raytracer_tpu_torch.diff.gradients import (
        InverseRenderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.render import film
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import write_scene

    orig, target_cam, scene = _load(args.scene, args.device)
    target_img = film.read_ppm(args.target).astype(np.float32) / 255.0
    # Invert the gamma quantization to approximate linear radiance.
    target_lin = torch.as_tensor(target_img ** 2.2, device=scene.device)
    h, w, _ = target_img.shape
    cam = Camera.make(orig, target_cam, w, h, device=scene.device)

    cfg = _config(args.mode)
    if args.vis_tau > 0.0:
        cfg = dataclasses.replace(cfg, vis_grad_tau=args.vis_tau)
    if args.sil_tau > 0.0:
        cfg = dataclasses.replace(cfg, sil_grad_tau=args.sil_tau)
    inv = InverseRenderer(scene=scene, cam=cam, target=target_lin,
                          cfg=cfg, width=w, height=h,
                          lr=args.lr, spp=args.spp, loss=args.loss,
                          optimize=tuple(args.params.split(",")),
                          backend=args.backend)
    for i in range(args.steps):
        loss = inv.step()
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i}: loss {loss:.6g}", file=sys.stderr)
    write_scene(orig, target_cam, inv.scene, args.out)
    print(f"wrote optimized scene to {args.out}", file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    """The argument tree: JAX's, with ``--device`` for ``--platform``."""
    ap = argparse.ArgumentParser(prog="gpu_bidirectional_raytracer_tpu_torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda, cuda:N or cpu); "
                         "cuda without a card is an error")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="progressive render to PPM")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--spp", type=int, default=64)
    p.add_argument("--out", default="out.ppm")
    p.add_argument("--mode", choices=("gpu", "cpu", "light"),
                   default="gpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reference-dims", action="store_true",
                   help="apply the reference's +1 to both axes")
    p.add_argument("--snapshot-every", type=int, default=0)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--backend", choices=("auto", "xla", "pallas"),
                   default="auto",
                   help="eye-trace implementation (pallas = the CUDA "
                        "kernels, xla = plain PyTorch; auto = the kernels "
                        "on the card up to 1024 spheres)")
    p.add_argument("--rng", choices=("mix32", "threefry", "rbg"),
                   default=None,
                   help="render-tape PRNG (default mix32: replay-stable "
                        "counter hash, regenerated in the kernels; "
                        "threefry: JAX's threefry tape; rbg: a "
                        "torch.Generator tape, not replay-stable across "
                        "devices)")
    p.add_argument("--fast-rng", dest="fast_rng", action="store_true",
                   help="alias for --rng rbg (on the card a streamed "
                        "tape: not faster than mix32)")
    p.add_argument("--chunk", type=int, default=16,
                   help="progressive passes per render_chunk call; 1 = "
                        "one step per pass")
    p.add_argument("--tile-rows", type=int, default=None,
                   help="trace in horizontal bands of N rows (bounds "
                        "memory for huge frames / many-sphere scenes)")
    p.add_argument("--camera-scale", type=float, default=1.0,
                   help="uniformly scale world geometry (camera, sphere "
                        "positions, radii) before rendering. For "
                        "normalized-coordinate scenes like "
                        "hall_of_mirrors.scn, which are black under the "
                        "reference camera's ~10-unit ray-origin "
                        "displacement; try 100")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("view", help="interactive terminal viewer")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--mode", choices=("gpu", "cpu"), default="gpu")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", choices=("auto", "xla", "pallas"),
                   default="auto")
    p.add_argument("--camera-scale", type=float, default=1.0,
                   help="uniformly scale world geometry (see render)")
    p.set_defaults(fn=cmd_view)

    p = sub.add_parser("optimize", help="inverse rendering against a target")
    p.add_argument("target")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--params", default="p,rad")
    p.add_argument("--mode", choices=("gpu", "cpu"), default="cpu")
    p.add_argument("--vis-tau", dest="vis_tau", type=float, default=0.0,
                   help="straight-through visibility-gradient width in "
                        "scene units (0 = detached-path gradients only; "
                        "~2 for Cornell-scale scenes)")
    p.add_argument("--sil-tau", dest="sil_tau", type=float, default=0.0,
                   help="straight-through primary-silhouette-gradient "
                        "width in scene units (0 = off)")
    p.add_argument("--loss", choices=("l2_unbiased", "l2", "log"),
                   default="l2_unbiased")
    p.add_argument("--backend", choices=("auto", "xla", "pallas", "mxu"),
                   default="auto",
                   help="fwd+bwd implementation (pallas = the CUDA adjoint "
                        "kernels up to 64 spheres; mxu = sphere scans in "
                        "matmul form)")
    p.add_argument("--out", default="optimized.scn")
    p.set_defaults(fn=cmd_optimize)
    return ap


def main(argv=None) -> int:
    from gpu_bidirectional_raytracer_tpu_torch.core.types import (
        resolve_device,
    )

    args = build_parser().parse_args(argv)
    args.device = resolve_device(args.device)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
