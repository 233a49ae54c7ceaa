"""Bad-pixel fractions of 8-pass Cornell renders: the port against JAX.

    python tests/torch_render_parity.py WIDTH HEIGHT [--pallas]

For seeds 0-3, renders cornell.scn for 8 passes with JAX's XLA renderer
and the port's plain renderer on the CPU and prints the fraction of pixels
that break the radiance protocol (tests/test_pallas.py). With
``--pallas`` it also renders the same passes through JAX's eye-path kernel
(``trace_pallas_camera`` in interpret mode), a second witness of how far
two of JAX's own paths differ on the same frame.
"""

import argparse
import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpu_bidirectional_raytracer_tpu.ops.pallas_trace import (  # noqa: E402
    trace_pallas_camera,
)
from gpu_bidirectional_raytracer_tpu.render import progressive as jprog  # noqa: E402
from gpu_bidirectional_raytracer_tpu.scene import parser as jparser  # noqa: E402
from gpu_bidirectional_raytracer_tpu_torch.render import progressive as tprog  # noqa: E402
from gpu_bidirectional_raytracer_tpu_torch.scene import parser as tparser  # noqa: E402
from torch_parity import ATOL, RTOL, scn  # noqa: E402

PASSES = 8


def bad_frac(got, ref) -> float:
    got = np.asarray(got).reshape(-1, 3)
    ref = np.asarray(ref).reshape(-1, 3)
    bad = np.any(np.abs(got - ref) > ATOL + RTOL * np.abs(ref), axis=-1)
    return float(bad.mean())


def pallas_render(scene, jr, w, h, seed):
    """JAX's progressive loop with the eye pass through its kernel."""
    st = jprog.init_state(w, h, jr.cfg, seed=seed)
    for _ in range(PASSES):
        vpls, vi = jprog.vpl_update(scene, st, jr.cfg, jr.light_idx)
        rad = trace_pallas_camera(
            scene, jr.cfg, jr.light_idx, jr.camera, w, h, st.key, st.sample,
            vpls=vpls, vlp_index=vi, interpret=True).reshape(h, w, 3)
        colors, counter = jprog._accumulate(st.colors, st.counter, rad,
                                            jr.cfg.max_samples)
        st = dataclasses.replace(st, colors=colors, counter=counter,
                                 vpls=vpls, vlp_index=vi,
                                 sample=st.sample + 1)
    return st.colors


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("width", type=int)
    ap.add_argument("height", type=int)
    ap.add_argument("--pallas", action="store_true")
    args = ap.parse_args()
    torch.set_num_threads(2)
    w, h = args.width, args.height
    o, t, js = jparser.load_scene(scn("cornell.scn"))
    _, _, ts = tparser.load_scene(scn("cornell.scn"), device="cpu")
    for seed in range(4):
        jr = jprog.Renderer(js, o, t, w, h, seed=seed, backend="xla")
        tr = tprog.Renderer(ts, o, t, w, h, seed=seed, device="cpu")
        ref, got = jr.render(PASSES), tr.render(PASSES)
        line = {"size": f"{w}x{h}", "seed": seed,
                "port_vs_xla": bad_frac(got, ref)}
        if args.pallas:
            kern = pallas_render(js, jr, w, h, seed)
            line["jax_kernel_vs_xla"] = bad_frac(kern, ref)
            line["port_vs_jax_kernel"] = bad_frac(got, kern)
        print(line, flush=True)


if __name__ == "__main__":
    main()
