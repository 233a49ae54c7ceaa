#!/usr/bin/env python
"""Multi-card rendering with the PyTorch + CUDA port: split the frame's
rows over the ranks of a process group.

Port of examples/multi_chip_render.py. Each rank renders its band of rows
(`parallel.mesh.render_pass_sharded`: ``trace_kernel`` on its window of
the frame's lanes) and rank 0 writes the gathered image. The image is the
one-process render's, bit for bit: every random draw is addressed by its
global lane, not by the split.

One process (one rank):
    python3 examples/torch_multi_chip_render.py [--device cpu]
One rank per card:
    torchrun --nproc-per-node 4 examples/torch_multi_chip_render.py

Rank 0 writes multi_chip.png to the working directory.
"""

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

PASSES = 16


def main(argv=None) -> int:
    import torch.distributed as dist

    from gpu_bidirectional_raytracer_tpu_torch import IntegratorConfig
    from gpu_bidirectional_raytracer_tpu_torch.parallel import distributed
    from gpu_bidirectional_raytracer_tpu_torch.parallel import mesh as pmesh
    from gpu_bidirectional_raytracer_tpu_torch.render import film
    from gpu_bidirectional_raytracer_tpu_torch.render.progressive import (
        Renderer,
    )
    from gpu_bidirectional_raytracer_tpu_torch.scene import builtin

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="this rank's device (default cuda:<LOCAL_RANK>)")
    args = ap.parse_args(argv)

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        distributed.initialize_cluster(device=args.device)
    try:
        mesh = pmesh.make_mesh(device=args.device)
        print(f"rank {mesh.rank} of {mesh.size} on {mesh.device}")
        scene = builtin.cornell_box(device=mesh.device)
        width, height = 512, pmesh.pad_height_to(mesh, 384)
        cfg = IntegratorConfig()
        r = Renderer(scene, builtin.DEFAULT_CAMERA_ORIG,
                     builtin.DEFAULT_CAMERA_TARGET, width, height, cfg=cfg,
                     device=mesh.device)
        shard = pmesh.shard_state(r.state, mesh)
        for _ in range(PASSES):
            shard = pmesh.render_pass_sharded(r.scene, r.camera, shard, cfg,
                                              width, height, r.light_idx,
                                              mesh, backend=r.backend)
        img = pmesh.gather_rows(shard.colors, mesh)
        print(f"rank {mesh.rank}: rows {shard.colors.shape[0]} of {height}")
        if mesh.rank == 0:
            path = film.write_image(img.cpu(), "multi_chip.png")
            print(f"wrote {path}")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
