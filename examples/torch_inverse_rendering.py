#!/usr/bin/env python
"""Inverse rendering with the PyTorch + CUDA port: recover a corrupted
albedo from one image.

Port of examples/inverse_rendering.py. The fitter (`InverseRenderer`)
uses the unbiased two-render product loss (see diff/gradients.py for why
plain L2 on noisy Monte Carlo renders converges to a darkened scene). On
the card its radiance passes run ``trace_kernel`` and its gradients
``grad_kernel``.

    python3 examples/torch_inverse_rendering.py [--device cpu]

It writes inverse_target.png, inverse_start.png and
inverse_recovered.png to the working directory.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

STEPS = 200


def main(argv=None) -> int:
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
    from gpu_bidirectional_raytracer_tpu_torch.render import film
    from gpu_bidirectional_raytracer_tpu_torch.scene.parser import (
        load_scene,
    )

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    w, h = 96, 72
    orig, tgt, scene_true = load_scene(
        os.path.join(REPO, "assets", "scenes", "simple.scn"),
        device=args.device)
    cam = Camera.make(orig, tgt, w, h, device=scene_true.device)
    cfg = IntegratorConfig.cpu_golden()
    li = static_light_indices(scene_true)
    key = rng.make_key(0, "threefry")   # JAX's jax.random.key(0)

    target = G.render_radiance(scene_true, cam, key, cfg, w, h, li, spp=4)
    film.write_png(target.cpu(), "inverse_target.png")

    c = scene_true.c.clone()
    c[0] = torch.tensor([0.2, 0.3, 0.8], device=c.device)
    wrong = scene_true.replace(c=c)
    film.write_png(G.render_radiance(wrong, cam, key, cfg, w, h, li,
                                     spp=4).cpu(), "inverse_start.png")

    inv = G.InverseRenderer(scene=wrong, cam=cam, target=target, cfg=cfg,
                            width=w, height=h, lr=0.05, spp=2,
                            optimize=("c",))
    t0 = time.time()
    for i in range(STEPS):
        loss = inv.step()
        if i % 40 == 0:
            err = float((inv.scene.c[0] - scene_true.c[0]).abs().max())
            print(f"step {i:3d}  loss {loss:9.6f}  ground-albedo err "
                  f"{err:.3f}")
    print(f"done in {time.time() - t0:.1f}s on {inv.scene.device} "
          f"(backend {inv.backend})")
    print("true ground albedo:", scene_true.c[0].cpu().numpy())
    print("recovered:         ", inv.scene.c[0].cpu().numpy())
    recovered = G.render_radiance(inv.scene, cam, key, cfg, w, h, li, spp=4)
    film.write_png(recovered.cpu(), "inverse_recovered.png")
    return 0


if __name__ == "__main__":
    sys.exit(main())
